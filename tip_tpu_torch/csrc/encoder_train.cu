// K11 and K12: one post-norm transformer encoder layer for training, its
// forward with the four hash-dropout sites and its backward, f32 or bf16.
//
// Replaces tip_tpu/ops/pallas_encoder.py::encoder_layer_train: K11 its
// forward kernel (_fwd_kernel via _encoder_layer_fwd_call), K12 its
// rematerialising backward (_bwd_kernel via _encoder_layer_bwd_call).
// For x (N = B*T, d):
//
//   qkv = x Wqkv + bqkv;  per sample and head h: P = softmax(q k^T / sqrt(hd)
//   causal), att_h = (P * mask_h) v_h;  a = (att Wo + bo) * mask_100;
//   y1 = LN1(x + a);  f1 = relu(y1 W1 + b1);  f1d = f1 * mask_101;
//   y = LN2(y1 + (f1d W2 + b2) * mask_102)
//
// Masks (ops/hashmask.py) are indexed as tip_tpu's batch tiles index them:
// the batch is cut into tiles of bt samples, tile i seeded seed + i * 104729;
// within a tile the attention mask of head h (site h) is indexed over the
// (bt*T, bt*T) score matrix of the tile, row s*T + i and column s*T + j for
// sample s of the tile, and the (N, d) and (N, ff) sites by the row within
// the tile. The TPU kernel computes attention over that block-diagonal
// matrix (a Mosaic layout choice); per-sample causal attention here gives
// the same values, since exp(-1e30 - m) is exactly 0.
//
// What bounds them on the H100: at B = 256, T = 40, d 256, 16 heads, ff 1024
// the forward is 16.5 GFLOP (0.25 ms at 67 TFLOP/s f32 on the CUDA cores,
// 0.10 ms at 165 TFLOP/s, the tensor cores' TF32 rate over the three
// products of 3xTF32) against ~21 MB of compulsory bytes: operations. The
// backward is 33 GFLOP; K12 recomputes the forward first, as the TPU kernel
// does, 50 GFLOP (0.74 ms f32, 0.30 ms 3xTF32).
//
// Design: each entry point is a sequence of launches. Every product of
// K11 and of K12 (its recomputed forward and its backward) is
// train_mma.cuh's 3xTF32 GEMM on the tensor cores, which keeps about f32
// accuracy, with fused epilogues (bias, ReLU + mask, dReLU + mask,
// residual add); K11 is forward(), the forward K12 recomputes, so the two
// give the same bits. Its copies read 16 bytes at a time: d, ff and the
// head width are multiples of 4. The residual + mask + LayerNorm and its
// backward are one warp per row; attention and its backward one block per
// (sample, head) with q, k, v, the 40x40 probabilities and the masks in
// shared memory. Weight and bias gradients are reductions over all N rows,
// split into partial sums added in a fixed order: no float atomics, two
// calls give the same bits. Activations live in a scratch buffer the
// wrapper allocates (encoder_layer_scratch floats: ~190 MB for the
// forward, ~330 MB with the backward, at the training shape); nothing is
// kept between K11 and K12. No shared-memory attribute is set per call.
//
// K11's bf16 variant (encoder_layer_fwd_bf16_launch: tip_tpu's kernel with
// bf16 x and matmul weights, f32 LayerNorm vectors) is the same sequence
// with bf16 products (train_mma.cuh's kBf16: one m16n8k16 bf16 mma with
// f32 sums, each operand rounded to bf16 as its fragment is formed). x and
// the eight bf16 weights and biases are first widened to their exact f32
// images in the scratch (one launch, 16-byte loads: d, ff and the head
// width multiples of 8); the activations stay f32, the attention rounds q,
// k, v and the masked probabilities to bf16 before its two products, the
// biases, LayerNorm, softmax and residuals are f32, and y is written in
// bf16, where tip_tpu rounds. Its bound is operations at the bf16
// tensor-core rate.
//
// K12's bf16 variant (encoder_layer_bwd_bf16_launch: tip_tpu's backward
// kernel with bf16 x, dy and matmul weights) widens x, the eight weights
// and biases and dy to f32 in the scratch (one launch), recomputes the
// forward exactly as K11's bf16 variant runs it (forward<true>: the same
// activations, bit for bit), and runs every backward product on the bf16
// tiles: the activation gradients (tf3::gemm<..., kBf16>), the weight
// gradients (tf3::wgrad<kBf16>, the splits added in f32 in the same order)
// and the attention backward's four products (attn_bwd_kernel<true>: P M
// and dO for dv, dO and v for dP, dS and k for dq, dS and q for dk rounded
// to bf16, the sums f32). LayerNorm backward, dReLU, masks and the column
// sums stay f32. dx and the eight matmul-weight and bias gradients are
// formed in f32 in the scratch and rounded to bf16 once (narrow_bf16); the
// four LayerNorm gradients are written in f32. Its bound is operations at
// the bf16 tensor-core rate (0.050 ms at the training shape).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hashmask.cuh"
#include "train_gemm.cuh"
#include "train_mma.cuh"

namespace {

constexpr int kSiteAttn = 0;   // heads use sites 0 .. n_heads - 1
constexpr int kSitePostAttn = 100;
constexpr int kSiteFfMid = 101;
constexpr int kSitePostFf = 102;
constexpr int kMaxD = 1024;    // row kernels hold a row in registers
constexpr size_t kMaxSmem = 232448;   // dynamic shared memory of a block

struct Weights {
  const float *wqkv, *bqkv, *wo, *bo, *wf1, *bf1, *wf2, *bf2, *g1, *be1, *g2,
      *be2;
};

struct Dims {
  int N, T, d, ff, nh, tile_rows;
};

struct Fwd {   // forward activations, (N, ·) each
  float *qkv, *att, *pre, *y1, *xhat1, *rs1, *f1, *f1d, *pre2, *xhat2, *rs2;
};

struct Bwd {
  float *y, *dr2, *df2, *dh1, *dy1, *dr1, *da, *datt, *dqkv, *part;
};

// a product's operand: in the bf16 variant rounded to bf16 (its f32 image)
template <bool kBf16>
__device__ __forceinline__ float operand(float v) {
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// y = LN((pre * mask) + res), one warp per row; xhat and rs kept. Out: y's
// storage (f32; bf16 for the bf16 variant's output)
template <class Out>
__global__ void ln_fwd_rows(const float* __restrict__ pre,
                            const float* __restrict__ res,
                            const float* __restrict__ g,
                            const float* __restrict__ b, hm::Drop drop, int N,
                            int d, Out* __restrict__ y,
                            float* __restrict__ xhat, float* __restrict__ rs) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= N) return;
  const size_t base = static_cast<size_t>(row) * d;
  float v[kMaxD / 32];
  float s = 0.0f;
  const int n = (d + 31) / 32;
  for (int i = 0; i < n; ++i) {
    const int c = lane + 32 * i;
    float r = 0.0f;
    if (c < d) {
      float a = pre[base + c];
      a = a * hm::drop_at(drop, row, c, d);
      r = res[base + c] + a;
      s += r;
    }
    v[i] = r;
  }
  const float mu = warp_sum(s) / d;
  float q = 0.0f;
  for (int i = 0; i < n; ++i) {
    const int c = lane + 32 * i;
    if (c < d) q += (v[i] - mu) * (v[i] - mu);
  }
  const float var = warp_sum(q) / d;
  const float r_s = 1.0f / sqrtf(var + 1e-5f);
  for (int i = 0; i < n; ++i) {
    const int c = lane + 32 * i;
    if (c < d) {
      const float xh = (v[i] - mu) * r_s;
      xhat[base + c] = xh;
      put(y + base + c, xh * g[c] + b[c]);
    }
  }
  if (lane == 0) rs[row] = r_s;
}

// dr = LN backward of dy (the LayerNorm's input gradient); dm = dr * mask
__global__ void ln_bwd_rows(const float* __restrict__ dy,
                            const float* __restrict__ xhat,
                            const float* __restrict__ rs,
                            const float* __restrict__ g, hm::Drop drop, int N,
                            int d, float* __restrict__ dr,
                            float* __restrict__ dm) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= N) return;
  const size_t base = static_cast<size_t>(row) * d;
  float dxh[kMaxD / 32], xh[kMaxD / 32];
  float s1 = 0.0f, s2 = 0.0f;
  const int n = (d + 31) / 32;
  for (int i = 0; i < n; ++i) {
    const int c = lane + 32 * i;
    dxh[i] = 0.0f;
    xh[i] = 0.0f;
    if (c < d) {
      dxh[i] = dy[base + c] * g[c];
      xh[i] = xhat[base + c];
      s1 += dxh[i];
      s2 += dxh[i] * xh[i];
    }
  }
  const float m1 = warp_sum(s1) / d;
  const float m2 = warp_sum(s2) / d;
  const float r_s = rs[row];
  for (int i = 0; i < n; ++i) {
    const int c = lane + 32 * i;
    if (c < d) {
      const float v = r_s * (dxh[i] - m1 - xh[i] * m2);
      dr[base + c] = v;
      dm[base + c] = v * hm::drop_at(drop, row, c, d);
    }
  }
}

// Shared memory of one (sample, head): q, k, v, do at stride hd + 1, then
// P, the masks and dS (T, T) each.
inline size_t attn_smem(int T, int hd) {
  return (4 * static_cast<size_t>(T) * (hd + 1) +
          3 * static_cast<size_t>(T) * T) * sizeof(float);
}

// Load q, k, v of (sample b, head h) (as bf16 operands in the bf16
// variant) and compute P = softmax(causal scores) and the keep values M of
// the head's mask. Rows of P past the diagonal are 0.
template <bool kBf16>
__device__ void attn_probs(const float* __restrict__ qkv, int b, int h,
                           const Dims& D, float scale, const hm::Drop& drop,
                           float* q, float* k, float* v, float* P, float* M) {
  const int T = D.T, d = D.d, hd = d / D.nh, ld = hd + 1;
  const size_t d3 = 3 * static_cast<size_t>(d);
  for (int e = threadIdx.x; e < T * hd; e += blockDim.x) {
    const int t = e / hd, c = e % hd;
    const float* src = qkv + (static_cast<size_t>(b) * T + t) * d3 + h * hd + c;
    q[t * ld + c] = operand<kBf16>(src[0]);
    k[t * ld + c] = operand<kBf16>(src[d]);
    v[t * ld + c] = operand<kBf16>(src[2 * d]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < T * T; e += blockDim.x) {
    const int i = e / T, j = e % T;
    float s = 0.0f;
    if (j <= i) {
      for (int c = 0; c < hd; ++c) s = fmaf(q[i * ld + c], k[j * ld + c], s);
      s = s * scale;
    }
    P[e] = s;
    float m = 1.0f;
    if (drop.on) {
      // index over the tile's (tile_rows, tile_rows) score matrix
      const int gi = b * T + i;
      const int tile = gi / drop.tile_rows;
      const int ri = gi - tile * drop.tile_rows;
      const int cj = b * T + j - tile * drop.tile_rows;
      m = hm::keep(hm::tile_seed(drop.seed, tile), drop.site,
                   static_cast<unsigned>(ri) *
                           static_cast<unsigned>(drop.tile_rows) +
                       static_cast<unsigned>(cj),
                   drop.p_keep, drop.inv_keep);
    }
    M[e] = m;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < T; i += blockDim.x / 32) {
    float mx = __int_as_float(0xff800000);   // -inf
    for (int j = lane; j <= i; j += 32) mx = fmaxf(mx, P[i * T + j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.0f;
    for (int j = lane; j < T; j += 32) {
      const float e = j <= i ? expf(P[i * T + j] - mx) : 0.0f;
      P[i * T + j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j <= i; j += 32) P[i * T + j] = P[i * T + j] / sum;
  }
  __syncthreads();
}

template <bool kBf16>
__global__ void attn_fwd_kernel(const float* __restrict__ qkv,
                                float* __restrict__ att, Dims D, float scale,
                                hm::Drop drop) {
  extern __shared__ float sh[];
  const int T = D.T, hd = D.d / D.nh, ld = hd + 1;
  const int b = blockIdx.x / D.nh, h = blockIdx.x % D.nh;
  float* q = sh;
  float* k = q + T * ld;
  float* v = k + T * ld;
  float* P = v + 2 * T * ld;   // (the do slot is unused here)
  float* M = P + T * T;
  drop.site = kSiteAttn + h;
  attn_probs<kBf16>(qkv, b, h, D, scale, drop, q, k, v, P, M);
  for (int e = threadIdx.x; e < T * hd; e += blockDim.x) {
    const int i = e / hd, c = e % hd;
    float o = 0.0f;
    for (int j = 0; j <= i; ++j)
      o = fmaf(operand<kBf16>(P[i * T + j] * M[i * T + j]), v[j * ld + c],
               o);
    att[(static_cast<size_t>(b) * T + i) * D.d + h * hd + c] = o;
  }
}

// Shared memory of K12's attention backward for one (sample, head): q, k,
// v, dO at a row stride of hd + 4 (rows 16-byte aligned; a quarter warp's
// float4 loads of 8 rows hit 32 banks), then P, P * M and dS at T + 1.
__host__ __device__ inline int attn_bwd_ld(int hd) { return hd + 4; }
inline size_t attn_bwd_smem(int T, int hd) {
  return (4 * static_cast<size_t>(T) * attn_bwd_ld(hd) +
          3 * static_cast<size_t>(T) * (T + 1)) * sizeof(float);
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b,
                                      float s) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, s))));
}

__device__ __forceinline__ void axpy4(float w, const float4 x, float4& a) {
  a.x = fmaf(w, x.x, a.x);
  a.y = fmaf(w, x.y, a.y);
  a.z = fmaf(w, x.z, a.z);
  a.w = fmaf(w, x.w, a.w);
}

// K12's attention backward, a block per (sample, head), the sums in the
// order of the forward's attn_probs and of the first version of this
// kernel. A warp per row i recomputes the row's probabilities P and keep
// values M, then dP = (dO v^T) * M and dS = P (dP - rowsum(dP P)), a lane
// per column j: no block barrier falls between the phases of a row. Then a
// thread per 4 columns of one row of dq, dk or dv sums over the other
// axis with float4 reads (4 multiply-adds a scalar read, where a thread
// per column had 1 per 2). kBf16: q, k, v and dO are rounded to bf16 as
// they are staged (the scores then are the bf16 forward's), P M and dS as
// they are stored, so that each of the four products reads bf16 operands;
// P, dP and the row sums stay f32.
template <bool kBf16>
__global__ void attn_bwd_kernel(const float* __restrict__ qkv,
                                const float* __restrict__ datt,
                                float* __restrict__ dqkv, Dims D, float scale,
                                hm::Drop drop) {
  extern __shared__ float4 sh4[];
  const int T = D.T, d = D.d, hd = d / D.nh, ld = attn_bwd_ld(hd);
  const int tp = T + 1, q4 = hd / 4, ld4 = ld / 4;
  const int b = blockIdx.x / D.nh, h = blockIdx.x % D.nh;
  float* sq = reinterpret_cast<float*>(sh4);   // q, k, v, dO: (T, ld) each
  float* P = sq + 4 * T * ld;                   // (T, tp) each
  float* PM = P + T * tp;
  float* dS = PM + T * tp;
  drop.site = kSiteAttn + h;
  const size_t d3 = 3 * static_cast<size_t>(d);
  for (int e = threadIdx.x; e < 4 * T * q4; e += blockDim.x) {
    const int which = e / (T * q4), r = e % (T * q4);
    const int t = r / q4, c = 4 * (r % q4);
    const size_t row = static_cast<size_t>(b) * T + t;
    const float* src = which < 3 ? qkv + row * d3 + which * d + h * hd + c
                                 : datt + row * d + h * hd + c;
    float4 v4 = *reinterpret_cast<const float4*>(src);
    v4 = make_float4(operand<kBf16>(v4.x), operand<kBf16>(v4.y),
                     operand<kBf16>(v4.z), operand<kBf16>(v4.w));
    *reinterpret_cast<float4*>(sq + (which * T + t) * ld + c) = v4;
  }
  __syncthreads();
  const float4* q = reinterpret_cast<const float4*>(sq);
  const float4* k = q + T * ld4;
  const float4* v = k + T * ld4;
  const float4* dO = v + T * ld4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < T; i += blockDim.x / 32) {
    const float4* qi = q + i * ld4;
    const float4* oi = dO + i * ld4;
    float* Pi = P + i * tp;
    float* PMi = PM + i * tp;
    float* dSi = dS + i * tp;
    float mx = __int_as_float(0xff800000);   // -inf
    for (int j = lane; j <= i; j += 32) {
      float s = 0.0f;
      for (int c = 0; c < q4; ++c) s = dot4(qi[c], k[j * ld4 + c], s);
      s = s * scale;
      Pi[j] = s;
      mx = fmaxf(mx, s);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.0f;
    for (int j = lane; j <= i; j += 32) {
      const float e = expf(Pi[j] - mx);
      Pi[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float rs = 0.0f;
    for (int j = lane; j <= i; j += 32) {
      const float p = Pi[j] / sum;
      float m = 1.0f;
      if (drop.on) {
        // index over the tile's (tile_rows, tile_rows) score matrix
        const int gi = b * T + i;
        const int tile = gi / drop.tile_rows;
        const int ri = gi - tile * drop.tile_rows;
        const int cj = b * T + j - tile * drop.tile_rows;
        m = hm::keep(hm::tile_seed(drop.seed, tile), drop.site,
                     static_cast<unsigned>(ri) *
                             static_cast<unsigned>(drop.tile_rows) +
                         static_cast<unsigned>(cj),
                     drop.p_keep, drop.inv_keep);
      }
      float dp = 0.0f;
      for (int c = 0; c < q4; ++c) dp = dot4(oi[c], v[j * ld4 + c], dp);
      dp = dp * m;
      Pi[j] = p;
      PMi[j] = operand<kBf16>(p * m);
      dSi[j] = dp;
      rs += dp * p;
    }
    rs = warp_sum(rs);
    for (int j = lane; j < T; j += 32) {   // each lane its own columns
      dSi[j] = j <= i ? operand<kBf16>(Pi[j] * (dSi[j] - rs)) : 0.0f;
      if (j > i) PMi[j] = 0.0f;
    }
  }
  __syncthreads();
  const int per = T * q4;   // float4s of one of dq, dk, dv
  for (int e = threadIdx.x; e < 3 * per; e += blockDim.x) {
    const int which = e / per, r = e % per;
    const int t = r / q4, c = r % q4;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (which == 0) {          // dq_t = sum over j <= t of dS[t, j] k_j
      for (int j = 0; j <= t; ++j) axpy4(dS[t * tp + j], k[j * ld4 + c], a);
    } else if (which == 1) {   // dk_t = sum over i >= t of dS[i, t] q_i
      for (int i = t; i < T; ++i) axpy4(dS[i * tp + t], q[i * ld4 + c], a);
    } else {                   // dv_t = sum over i >= t of (P M)[i, t] dO_i
      for (int i = t; i < T; ++i) axpy4(PM[i * tp + t], dO[i * ld4 + c], a);
    }
    if (which < 2) {
      a.x *= scale;
      a.y *= scale;
      a.z *= scale;
      a.w *= scale;
    }
    *reinterpret_cast<float4*>(dqkv + (static_cast<size_t>(b) * T + t) * d3 +
                               which * d + h * hd + 4 * c) = a;
  }
}

// The attention kernels' shared memory beyond the 48 KB a launch may take
// without asking: the attribute is set only when a call needs more than
// every call before it (the training shape needs 30 and 33 KB: never)
cudaError_t smem_attr(const void* kernel, size_t smem, size_t* allowed) {
  if (smem <= *allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess) *allowed = smem;
  return e;
}

template <bool kBf16>
cudaError_t attn_fwd_smem_attr(size_t smem) {
  static size_t allowed = 48 * 1024;
  return smem_attr(reinterpret_cast<const void*>(attn_fwd_kernel<kBf16>),
                   smem, &allowed);
}

template <bool kBf16>
cudaError_t attn_bwd_smem_attr(size_t smem) {
  static size_t allowed = 48 * 1024;
  return smem_attr(reinterpret_cast<const void*>(attn_bwd_kernel<kBf16>),
                   smem, &allowed);
}

// n floats rounded up to 16 bytes: every carved array starts aligned, as
// train_mma.cuh's copies need
inline size_t up4(size_t n) { return (n + 3) / 4 * 4; }

size_t fwd_floats(const Dims& D) {
  const size_t N = D.N;
  return N * (9 * static_cast<size_t>(D.d) + 2 * D.ff) + 2 * up4(N);
}

size_t part_floats(const Dims& D) {
  size_t p = 0;
  auto upd = [&p](size_t v) { if (v > p) p = v; };
  upd(tf3::wgrad_scratch(D.ff, D.d, D.N));
  upd(tf3::wgrad_scratch(D.d, D.ff, D.N));
  upd(tf3::wgrad_scratch(D.d, D.d, D.N));
  upd(tf3::wgrad_scratch(D.d, 3 * D.d, D.N));
  upd(tg::colsum_scratch(D.N, 3 * D.d));
  upd(tg::colsum_scratch(D.N, D.ff));
  return p;
}

// The bf16 variants' inputs widened to f32 (widen_bf16): x, then the eight
// matmul weights and biases in the order of the weights, each rounded up
// to 16 bytes; K12's then dy, of x's size
constexpr int kWiden = 9;
constexpr int kWidenBwd = kWiden + 1;

void widen_sizes(const Dims& D, size_t (&n)[kWiden]) {
  const size_t d = D.d, ff = D.ff;
  const size_t sizes[kWiden] = {static_cast<size_t>(D.N) * d, d * 3 * d,
                                3 * d, d * d, d, d * ff, ff, ff * d, d};
  for (int i = 0; i < kWiden; ++i) n[i] = sizes[i];
}

size_t widen_floats(const Dims& D) {
  size_t n[kWiden], t = 0;
  widen_sizes(D, n);
  for (size_t v : n) t += up4(v);
  return t;
}

struct Widen {
  const uint4* src[kWidenBwd];   // 8 bf16 values a load
  float4* dst[kWidenBwd];
  int n8[kWidenBwd];             // values / 8
};

// dst[a] = f32(src[a]), exactly; blockIdx.y picks the array
__global__ void widen_bf16(Widen w) {
  const int a = blockIdx.y;
  const uint4* src = w.src[a];
  float4* dst = w.dst[a];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < w.n8[a];
       i += gridDim.x * blockDim.x) {
    const uint4 u = src[i];
    dst[2 * i] = make_float4(__uint_as_float(u.x << 16),
                             __uint_as_float(u.x & 0xffff0000u),
                             __uint_as_float(u.y << 16),
                             __uint_as_float(u.y & 0xffff0000u));
    dst[2 * i + 1] = make_float4(__uint_as_float(u.z << 16),
                                 __uint_as_float(u.z & 0xffff0000u),
                                 __uint_as_float(u.w << 16),
                                 __uint_as_float(u.w & 0xffff0000u));
  }
}

// src[a] (f32) rounded to bf16 into dst[a], 8 values a store; blockIdx.y
// picks the array (K12's bf16 variant: dx, then the eight matmul-weight and
// bias gradients)
struct Narrow {
  const float4* src[kWiden];
  uint4* dst[kWiden];
  int n8[kWiden];
};

__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<unsigned>(
              __bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

__global__ void narrow_bf16(Narrow w) {
  const int a = blockIdx.y;
  const float4* src = w.src[a];
  uint4* dst = w.dst[a];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < w.n8[a];
       i += gridDim.x * blockDim.x) {
    const float4 u = src[2 * i], v = src[2 * i + 1];
    dst[i] = make_uint4(bf16x2(u.x, u.y), bf16x2(u.z, u.w), bf16x2(v.x, v.y),
                        bf16x2(v.z, v.w));
  }
}

// blocks of 256 threads for n8 loads of the largest array, at most 264
int conv_blocks(size_t most) {
  const size_t b = (most / 8 + 255) / 256;
  return static_cast<int>(b < 264 ? (b < 1 ? 1 : b) : 264);
}

size_t bwd_floats(const Dims& D) {
  const size_t N = D.N;
  return N * (7 * static_cast<size_t>(D.d) + D.ff + 3 * D.d) + part_floats(D);
}

Fwd carve_fwd(float* s, const Dims& D) {
  const size_t N = D.N, d = D.d, ff = D.ff;
  Fwd f;
  f.qkv = s; s += N * 3 * d;
  f.att = s; s += N * d;
  f.pre = s; s += N * d;
  f.y1 = s; s += N * d;
  f.xhat1 = s; s += N * d;
  f.f1 = s; s += N * ff;
  f.f1d = s; s += N * ff;
  f.pre2 = s; s += N * d;
  f.xhat2 = s; s += N * d;
  f.rs1 = s; s += up4(N);
  f.rs2 = s;
  return f;
}

Bwd carve_bwd(float* s, const Dims& D) {
  const size_t N = D.N, d = D.d, ff = D.ff;
  Bwd g;
  g.y = s; s += N * d;
  g.dr2 = s; s += N * d;
  g.df2 = s; s += N * d;
  g.dh1 = s; s += N * ff;
  g.dy1 = s; s += N * d;
  g.dr1 = s; s += N * d;
  g.da = s; s += N * d;
  g.datt = s; s += N * d;
  g.dqkv = s; s += N * 3 * d;
  g.part = s;
  return g;
}

hm::Drop site(const hm::Drop& base, int s) {
  hm::Drop d = base;
  d.site = s;
  return d;
}

// kBf16: bf16 products and attention operands (x and w the f32 images of
// bf16 values), y in bf16 (Out)
template <bool kBf16 = false, class Out = float>
int forward(const float* x, const Weights& w, const Dims& D,
            const hm::Drop& drop, Out* y, const Fwd& f, cudaStream_t st) {
  using tg::EpiArgs;
  using tg::E_BIAS;
  using tg::E_BIAS_RELU_DROP;
  const int N = D.N, d = D.d, ff = D.ff;
  const float scale = 1.0f / sqrtf(static_cast<float>(d / D.nh));
  const int rows_per_block = 8;
  const int row_blocks = (N + rows_per_block - 1) / rows_per_block;
  tf3::gemm<false, false, E_BIAS, kBf16>(
      x, w.wqkv, f.qkv, N, 3 * d, d, d, 3 * d,
      EpiArgs{w.bqkv, nullptr, nullptr, drop}, st);
  TG_CHECK();
  const size_t smem = attn_smem(D.T, d / D.nh);
  const cudaError_t attr = attn_fwd_smem_attr<kBf16>(smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  attn_fwd_kernel<kBf16><<<(N / D.T) * D.nh, 128, smem, st>>>(
      f.qkv, f.att, D, scale, drop);
  TG_CHECK();
  tf3::gemm<false, false, E_BIAS, kBf16>(
      f.att, w.wo, f.pre, N, d, d, d, d,
      EpiArgs{w.bo, nullptr, nullptr, drop}, st);
  TG_CHECK();
  ln_fwd_rows<float><<<row_blocks, 32 * rows_per_block, 0, st>>>(
      f.pre, x, w.g1, w.be1, site(drop, kSitePostAttn), N, d, f.y1, f.xhat1,
      f.rs1);
  TG_CHECK();
  tf3::gemm<false, false, E_BIAS_RELU_DROP, kBf16>(
      f.y1, w.wf1, f.f1, N, ff, d, d, ff,
      EpiArgs{w.bf1, nullptr, f.f1d, site(drop, kSiteFfMid)}, st);
  TG_CHECK();
  tf3::gemm<false, false, E_BIAS, kBf16>(
      f.f1d, w.wf2, f.pre2, N, d, ff, ff, d,
      EpiArgs{w.bf2, nullptr, nullptr, drop}, st);
  TG_CHECK();
  ln_fwd_rows<Out><<<row_blocks, 32 * rows_per_block, 0, st>>>(
      f.pre2, f.y1, w.g2, w.be2, site(drop, kSitePostFf), N, d, y, f.xhat2,
      f.rs2);
  TG_CHECK();
  return 0;
}

Weights weights_of(const void* const* ws) {
  const float* p[12];
  for (int i = 0; i < 12; ++i) p[i] = static_cast<const float*>(ws[i]);
  return Weights{p[0], p[1], p[2], p[3], p[4], p[5],
                 p[6], p[7], p[8], p[9], p[10], p[11]};
}

bool dims_ok(int B, int T, int d, int ff, int nh, int bt) {
  return B > 0 && T > 0 && d > 0 && d <= kMaxD && ff > 0 && nh > 0 &&
         d % nh == 0 && bt > 0 && B % bt == 0 &&
         attn_smem(T, d / nh) <= kMaxSmem;
}

// K11 and K12 read 16 bytes at a time (train_mma.cuh's copies along a
// row, the attention backward's head rows, widen_bf16's loads): d, ff and
// the head width multiples of 4 values (f32), 8 (bf16)
bool mma_dims_ok(int d, int ff, int nh, int per16 = 4) {
  return d % per16 == 0 && ff % per16 == 0 && (d / nh) % per16 == 0;
}

// The backward after the recomputed forward f (x and w as the forward
// read them, dy the f32 image of the output gradient): dx and the twelve
// gradients in f32, in the order of the weights. kBf16: bf16 products
// (the attention backward's too)
template <bool kBf16>
int backward(const float* xf, const float* dy, const Weights& w,
             const Dims& D, const hm::Drop& drop, float* dx,
             float* const* gr, const Fwd& f, const Bwd& g, cudaStream_t st) {
  using tg::colsum;
  using tg::EpiArgs;
  using tg::E_ADD;
  using tg::E_DRELU_DROP;
  using tg::E_STORE;
  using tf3::wgrad;
  const int N = D.N, d = D.d, ff = D.ff, T = D.T, nh = D.nh;
  float *dwqkv = gr[0], *dbqkv = gr[1], *dwo = gr[2], *dbo = gr[3],
        *dwf1 = gr[4], *dbf1 = gr[5], *dwf2 = gr[6], *dbf2 = gr[7],
        *dg1 = gr[8], *dbe1 = gr[9], *dg2 = gr[10], *dbe2 = gr[11];
  const float scale = 1.0f / sqrtf(static_cast<float>(d / nh));
  const int rows_per_block = 8;
  const int row_blocks = (N + rows_per_block - 1) / rows_per_block;

  // LN2, then the post-FF mask
  ln_bwd_rows<<<row_blocks, 32 * rows_per_block, 0, st>>>(
      dy, f.xhat2, f.rs2, w.g2, site(drop, kSitePostFf), N, d, g.dr2, g.df2);
  TG_CHECK();
  colsum(dy, f.xhat2, dg2, N, d, g.part, st);
  colsum(dy, nullptr, dbe2, N, d, g.part, st);
  TG_CHECK();
  // W2
  wgrad<kBf16>(f.f1d, g.df2, dwf2, ff, d, N, g.part, st);
  colsum(g.df2, nullptr, dbf2, N, d, g.part, st);
  TG_CHECK();
  // dh1 = (df2 W2^T) * mask_101 * (f1 > 0)
  tf3::gemm<false, true, E_DRELU_DROP, kBf16>(
      g.df2, w.wf2, g.dh1, N, ff, d, d, d,
      EpiArgs{nullptr, f.f1, nullptr, site(drop, kSiteFfMid)}, st);
  TG_CHECK();
  wgrad<kBf16>(f.y1, g.dh1, dwf1, d, ff, N, g.part, st);
  colsum(g.dh1, nullptr, dbf1, N, ff, g.part, st);
  TG_CHECK();
  // dy1 = dr2 + dh1 W1^T; LN1; the post-attention mask
  tf3::gemm<false, true, E_ADD, kBf16>(
      g.dh1, w.wf1, g.dy1, N, d, ff, ff, ff,
      EpiArgs{nullptr, g.dr2, nullptr, drop}, st);
  TG_CHECK();
  ln_bwd_rows<<<row_blocks, 32 * rows_per_block, 0, st>>>(
      g.dy1, f.xhat1, f.rs1, w.g1, site(drop, kSitePostAttn), N, d, g.dr1,
      g.da);
  TG_CHECK();
  colsum(g.dy1, f.xhat1, dg1, N, d, g.part, st);
  colsum(g.dy1, nullptr, dbe1, N, d, g.part, st);
  TG_CHECK();
  // out projection
  wgrad<kBf16>(f.att, g.da, dwo, d, d, N, g.part, st);
  colsum(g.da, nullptr, dbo, N, d, g.part, st);
  tf3::gemm<false, true, E_STORE, kBf16>(g.da, w.wo, g.datt, N, d, d, d, d,
                                         EpiArgs{}, st);
  TG_CHECK();
  // attention
  const size_t attn_smem_b = attn_bwd_smem(T, d / nh);
  const cudaError_t attr = attn_bwd_smem_attr<kBf16>(attn_smem_b);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  attn_bwd_kernel<kBf16><<<(N / T) * nh, 128, attn_smem_b, st>>>(
      f.qkv, g.datt, g.dqkv, D, scale, drop);
  TG_CHECK();
  // qkv projection; dx = dr1 + dqkv Wqkv^T
  wgrad<kBf16>(xf, g.dqkv, dwqkv, d, 3 * d, N, g.part, st);
  colsum(g.dqkv, nullptr, dbqkv, N, 3 * d, g.part, st);
  tf3::gemm<false, true, E_ADD, kBf16>(
      g.dqkv, w.wqkv, dx, N, d, 3 * d, 3 * d, 3 * d,
      EpiArgs{nullptr, g.dr1, nullptr, drop}, st);
  TG_CHECK();
  return 0;
}

}  // namespace

// the scratch of each entry point (encoder_layer_scratch's kind)
enum { kScratchFwd = 0, kScratchBwd = 1, kScratchFwdBf16 = 2,
       kScratchBwdBf16 = 3 };

// Floats of scratch that encoder_layer_fwd_launch (kind 0),
// encoder_layer_bwd_launch (kind 1), encoder_layer_fwd_bf16_launch (kind
// 2) or encoder_layer_bwd_bf16_launch (kind 3) needs for N = B*T rows.
// Kind 3: kind 1's, then the widened inputs (x, the eight weights and
// biases, dy), then dx and the eight matmul-weight and bias gradients in
// f32 (the sizes of x and the eight)
extern "C" int encoder_layer_scratch(int N, int d, int ff, int kind,
                                     long long* floats) {
  if (kind < kScratchFwd || kind > kScratchBwdBf16)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims D{N, 1, d, ff, 1, 1};
  size_t n = fwd_floats(D);
  if (kind == kScratchBwd || kind == kScratchBwdBf16) n += bwd_floats(D);
  if (kind == kScratchFwdBf16) n += widen_floats(D);
  if (kind == kScratchBwdBf16)
    n += 2 * widen_floats(D) + up4(static_cast<size_t>(N) * d);
  *floats = static_cast<long long>(n);
  return 0;
}

// K11: the forward on train_mma.cuh's products
extern "C" int encoder_layer_fwd_launch(const void* x, const void* const* ws,
                                        void* y, void* scratch, int B, int T,
                                        int d, int ff, int nh, int bt,
                                        int seed, float p_keep,
                                        float inv_keep, int use_drop,
                                        void* stream) {
  if (!dims_ok(B, T, d, ff, nh, bt) || !mma_dims_ok(d, ff, nh))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims D{B * T, T, d, ff, nh, bt * T};
  const hm::Drop drop{use_drop, seed, 0, bt * T, p_keep, inv_keep};
  return forward(static_cast<const float*>(x), weights_of(ws), D, drop,
                 static_cast<float*>(y),
                 carve_fwd(static_cast<float*>(scratch), D),
                 static_cast<cudaStream_t>(stream));
}

// K11's bf16 variant: x, y and ws[0..7] bf16, ws[8..11] (LayerNorm) f32;
// scratch: encoder_layer_scratch(kind 2) floats
extern "C" int encoder_layer_fwd_bf16_launch(const void* x,
                                             const void* const* ws, void* y,
                                             void* scratch, int B, int T,
                                             int d, int ff, int nh, int bt,
                                             int seed, float p_keep,
                                             float inv_keep, int use_drop,
                                             void* stream) {
  if (!dims_ok(B, T, d, ff, nh, bt) || !mma_dims_ok(d, ff, nh, 8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims D{B * T, T, d, ff, nh, bt * T};
  const hm::Drop drop{use_drop, seed, 0, bt * T, p_keep, inv_keep};
  float* s = static_cast<float*>(scratch);
  const Fwd f = carve_fwd(s, D);
  size_t n[kWiden];
  widen_sizes(D, n);
  Widen wd;
  float* img[kWiden];
  float* at = s + fwd_floats(D);
  size_t most = 0;
  for (int i = 0; i < kWiden; ++i) {
    img[i] = at;
    at += up4(n[i]);
    wd.src[i] = static_cast<const uint4*>(i == 0 ? x : ws[i - 1]);
    wd.dst[i] = reinterpret_cast<float4*>(img[i]);
    wd.n8[i] = static_cast<int>(n[i] / 8);
    if (n[i] > most) most = n[i];
  }
  const int blocks = static_cast<int>(
      (most / 8 + 255) / 256 < 264 ? (most / 8 + 255) / 256 : 264);
  widen_bf16<<<dim3(blocks, kWiden), 256, 0, st>>>(wd);
  TG_CHECK();
  const float* ln[4];
  for (int i = 0; i < 4; ++i) ln[i] = static_cast<const float*>(ws[8 + i]);
  const Weights w{img[1], img[2], img[3], img[4], img[5], img[6],
                  img[7], img[8], ln[0], ln[1], ln[2], ln[3]};
  return forward<true>(img[0], w, D, drop, static_cast<__nv_bfloat16*>(y), f,
                       st);
}

// grads: the 12 gradients in the order of the weights, f32
extern "C" int encoder_layer_bwd_launch(const void* x, const void* dy_v,
                                        const void* const* ws, void* dx_v,
                                        void* const* grads, void* scratch,
                                        int B, int T, int d, int ff, int nh,
                                        int bt, int seed, float p_keep,
                                        float inv_keep, int use_drop,
                                        void* stream) {
  if (!dims_ok(B, T, d, ff, nh, bt) || !mma_dims_ok(d, ff, nh) ||
      attn_bwd_smem(T, d / nh) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims D{B * T, T, d, ff, nh, bt * T};
  const hm::Drop drop{use_drop, seed, 0, bt * T, p_keep, inv_keep};
  const Weights w = weights_of(ws);
  float* s = static_cast<float*>(scratch);
  const Fwd f = carve_fwd(s, D);
  const Bwd g = carve_bwd(s + fwd_floats(D), D);
  float* gr[12];
  for (int i = 0; i < 12; ++i) gr[i] = static_cast<float*>(grads[i]);
  const float* xf = static_cast<const float*>(x);
  const int err = forward(xf, w, D, drop, g.y, f, st);
  if (err) return err;
  return backward<false>(xf, static_cast<const float*>(dy_v), w, D, drop,
                         static_cast<float*>(dx_v), gr, f, g, st);
}

// K12's bf16 variant: x, dy, dx, ws[0..7] and grads[0..7] bf16, ws[8..11]
// and grads[8..11] (LayerNorm) f32; scratch: encoder_layer_scratch(kind 3)
// floats
extern "C" int encoder_layer_bwd_bf16_launch(const void* x, const void* dy_v,
                                             const void* const* ws,
                                             void* dx_v, void* const* grads,
                                             void* scratch, int B, int T,
                                             int d, int ff, int nh, int bt,
                                             int seed, float p_keep,
                                             float inv_keep, int use_drop,
                                             void* stream) {
  if (!dims_ok(B, T, d, ff, nh, bt) || !mma_dims_ok(d, ff, nh, 8) ||
      attn_bwd_smem(T, d / nh) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims D{B * T, T, d, ff, nh, bt * T};
  const hm::Drop drop{use_drop, seed, 0, bt * T, p_keep, inv_keep};
  float* s = static_cast<float*>(scratch);
  const Fwd f = carve_fwd(s, D);
  const Bwd g = carve_bwd(s + fwd_floats(D), D);
  // x, the eight weights and biases, dy: their f32 images
  size_t n[kWiden];
  widen_sizes(D, n);
  Widen wd;
  float* img[kWidenBwd];
  float* at = s + fwd_floats(D) + bwd_floats(D);
  size_t most = 0;
  for (int i = 0; i < kWidenBwd; ++i) {
    const size_t ni = n[i < kWiden ? i : 0];
    if (ni > most) most = ni;
    img[i] = at;
    at += up4(ni);
    wd.src[i] = static_cast<const uint4*>(i == 0   ? x
                                          : i < kWiden ? ws[i - 1]
                                                       : dy_v);
    wd.dst[i] = reinterpret_cast<float4*>(img[i]);
    wd.n8[i] = static_cast<int>(ni / 8);
  }
  widen_bf16<<<dim3(conv_blocks(most), kWidenBwd), 256, 0, st>>>(wd);
  TG_CHECK();
  const float* ln[4];
  for (int i = 0; i < 4; ++i) ln[i] = static_cast<const float*>(ws[8 + i]);
  const Weights w{img[1], img[2], img[3], img[4], img[5], img[6],
                  img[7], img[8], ln[0], ln[1], ln[2], ln[3]};
  const int err = forward<true>(img[0], w, D, drop, g.y, f, st);
  if (err) return err;
  // dx and the eight matmul-weight and bias gradients in f32, then rounded
  // once; the LayerNorm gradients straight into their f32 outputs
  float* dx32 = at;
  at += up4(n[0]);
  float* gr[12];
  Narrow nw;
  for (int i = 0; i < kWiden; ++i) {
    float* v = i == 0 ? dx32 : at;
    if (i > 0) {
      gr[i - 1] = v;
      at += up4(n[i]);
    }
    nw.src[i] = reinterpret_cast<const float4*>(v);
    nw.dst[i] = static_cast<uint4*>(i == 0 ? dx_v : grads[i - 1]);
    nw.n8[i] = static_cast<int>(n[i] / 8);
  }
  for (int i = 8; i < 12; ++i) gr[i] = static_cast<float*>(grads[i]);
  const int e2 = backward<true>(img[0], img[kWiden], w, D, drop, dx32, gr, f,
                                g, st);
  if (e2) return e2;
  narrow_bf16<<<dim3(conv_blocks(most), kWiden), 256, 0, st>>>(nw);
  TG_CHECK();
  return 0;
}
