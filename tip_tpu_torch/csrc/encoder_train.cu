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
// calls give the same bits. Activations live in a scratch buffer that the
// wrapper lays out and allocates (ops/encoder_train.py's
// f32_scratch_layout: ~190 MB for the forward, ~330 MB with the backward,
// at the training shape) and whose arrays' addresses it passes; nothing is
// kept between K11 and K12. No shared-memory attribute is set per call.
//
// K11's bf16 variant (encoder_layer_fwd_bf16_launch: tip_tpu's kernel with
// bf16 x and matmul weights, f32 LayerNorm vectors) and K12's
// (encoder_layer_bwd_bf16_launch: with bf16 dy too) read x, dy and the
// eight weights and biases as they are, and every activation that feeds a
// product is written in bf16 by the epilogue that makes it (qkv, att, the
// product copy of y1, f1d; df2, dh1, da, datt, dqkv): exactly the values
// tip_tpu's dot rounds, so the products' operands are tip_tpu's. f32 stays
// where f32 is read: the out-projection's and FF2's sums before their
// LayerNorm, y1 (LN2's residual), the LayerNorm statistics, dr2 and dr1
// (residuals of dy1 and dx), dy1; the ReLU's sign is kept as a byte (a
// bf16 f1d can flush a tiny positive value to 0). The products run on
// bf16_gemm.cuh (wgmma from TMA-staged bf16 tiles, a launch plan from
// ops/encoder_train.py that fills the card at B 1 and 64 where the shapes
// allow it); the attention (attn_fwd_bf16, attn_bwd_bf16) on mma.sync
// m16n8k16, a block two heads of one sample (one where two do not fit;
// their rows staged whole), a warp a head's row tiles of 16 rows, 64 keys
// and 64 head columns a register pass (any T and head width that fit the
// shared memory), softmax and its backward in f32. K12
// recomputes the forward with forward_bf16, K11's own sequence, so its
// activations are K11's bits. The bias gradients' column sums are folded
// into the epilogues that make dh1 (the product's tile epilogue), df2 and
// da (the LayerNorm backward's rows) and dqkv (the attention backward) as
// partial sums by block, added in a fixed order by one last launch
// (colsum_final) that also rounds each bias gradient to bf16 once; a
// split weight gradient is summed and rounded once inside its product's
// cluster. LayerNorm stays a warp-per-row launch: the plan's tiles cover
// 64 or 128 of a row's columns, not the row. Bound on the H100
// (chip_smoke.py's encoder_layer_work): operations at the bf16
// tensor-core rate at B 256 (K11 0.0166 ms, K12 0.0496 ms); bytes at B 1
// (K11 0.48 us: the weights, K12 0.96 us).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16_gemm.cuh"
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// y = LN((pre * mask) + res), one warp per row; xhat and rs kept
__global__ void ln_fwd_rows(const float* __restrict__ pre,
                            const float* __restrict__ res,
                            const float* __restrict__ g,
                            const float* __restrict__ b, hm::Drop drop, int N,
                            int d, float* __restrict__ y,
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
      y[base + c] = xh * g[c] + b[c];
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

// Load q, k, v of (sample b, head h) and compute P = softmax(causal scores) and the keep values M of
// the head's mask. Rows of P past the diagonal are 0.
__device__ void attn_probs(const float* __restrict__ qkv, int b, int h,
                           const Dims& D, float scale, const hm::Drop& drop,
                           float* q, float* k, float* v, float* P, float* M) {
  const int T = D.T, d = D.d, hd = d / D.nh, ld = hd + 1;
  const size_t d3 = 3 * static_cast<size_t>(d);
  for (int e = threadIdx.x; e < T * hd; e += blockDim.x) {
    const int t = e / hd, c = e % hd;
    const float* src = qkv + (static_cast<size_t>(b) * T + t) * d3 + h * hd + c;
    q[t * ld + c] = src[0];
    k[t * ld + c] = src[d];
    v[t * ld + c] = src[2 * d];
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
  attn_probs(qkv, b, h, D, scale, drop, q, k, v, P, M);
  for (int e = threadIdx.x; e < T * hd; e += blockDim.x) {
    const int i = e / hd, c = e % hd;
    float o = 0.0f;
    for (int j = 0; j <= i; ++j)
      o = fmaf(P[i * T + j] * M[i * T + j], v[j * ld + c], o);
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
// per column had 1 per 2).
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
    *reinterpret_cast<float4*>(sq + (which * T + t) * ld + c) =
        *reinterpret_cast<const float4*>(src);
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
      PMi[j] = p * m;
      dSi[j] = dp;
      rs += dp * p;
    }
    rs = warp_sum(rs);
    for (int j = lane; j < T; j += 32) {   // each lane its own columns
      dSi[j] = j <= i ? Pi[j] * (dSi[j] - rs) : 0.0f;
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

cudaError_t attn_fwd_smem_attr(size_t smem) {
  static size_t allowed = 48 * 1024;
  return smem_attr(reinterpret_cast<const void*>(attn_fwd_kernel), smem,
                   &allowed);
}

cudaError_t attn_bwd_smem_attr(size_t smem) {
  static size_t allowed = 48 * 1024;
  return smem_attr(reinterpret_cast<const void*>(attn_bwd_kernel), smem,
                   &allowed);
}

// The f32 entry points' scratch arrays, in the order of
// ops/encoder_train.py's F32_ARRAYS: the wrapper lays them out
// (f32_scratch_layout: each array 16-byte aligned, as train_mma.cuh's
// copies need) and passes their addresses in this order. K11 takes the
// first kF32FwdArrays; K12's last is the weight and bias gradients'
// partial sums, of part_floats floats.
enum {
  kFQkv, kFAtt, kFPre, kFY1, kFXhat1, kFF1, kFF1d, kFPre2, kFXhat2, kFRs1,
  kFRs2, kF32FwdArrays, kFY = kF32FwdArrays, kFDr2, kFDf2, kFDh1, kFDy1,
  kFDr1, kFDa, kFDatt, kFDqkv, kFPart, kF32BwdArrays
};

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

Fwd fwd_arrays(void* const* a) {
  auto at = [a](int i) { return static_cast<float*>(a[i]); };
  Fwd f;
  f.qkv = at(kFQkv);
  f.att = at(kFAtt);
  f.pre = at(kFPre);
  f.y1 = at(kFY1);
  f.xhat1 = at(kFXhat1);
  f.f1 = at(kFF1);
  f.f1d = at(kFF1d);
  f.pre2 = at(kFPre2);
  f.xhat2 = at(kFXhat2);
  f.rs1 = at(kFRs1);
  f.rs2 = at(kFRs2);
  return f;
}

Bwd bwd_arrays(void* const* a) {
  auto at = [a](int i) { return static_cast<float*>(a[i]); };
  Bwd g;
  g.y = at(kFY);
  g.dr2 = at(kFDr2);
  g.df2 = at(kFDf2);
  g.dh1 = at(kFDh1);
  g.dy1 = at(kFDy1);
  g.dr1 = at(kFDr1);
  g.da = at(kFDa);
  g.datt = at(kFDatt);
  g.dqkv = at(kFDqkv);
  g.part = at(kFPart);
  return g;
}

hm::Drop site(const hm::Drop& base, int s) {
  hm::Drop d = base;
  d.site = s;
  return d;
}

int forward(const float* x, const Weights& w, const Dims& D,
            const hm::Drop& drop, float* y, const Fwd& f, cudaStream_t st) {
  using tg::EpiArgs;
  using tg::E_BIAS;
  using tg::E_BIAS_RELU_DROP;
  const int N = D.N, d = D.d, ff = D.ff;
  const float scale = 1.0f / sqrtf(static_cast<float>(d / D.nh));
  const int rows_per_block = 8;
  const int row_blocks = (N + rows_per_block - 1) / rows_per_block;
  tf3::gemm<false, false, E_BIAS>(
      x, w.wqkv, f.qkv, N, 3 * d, d, d, 3 * d,
      EpiArgs{w.bqkv, nullptr, nullptr, drop}, st);
  TG_CHECK();
  const size_t smem = attn_smem(D.T, d / D.nh);
  const cudaError_t attr = attn_fwd_smem_attr(smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  attn_fwd_kernel<<<(N / D.T) * D.nh, 128, smem, st>>>(
      f.qkv, f.att, D, scale, drop);
  TG_CHECK();
  tf3::gemm<false, false, E_BIAS>(
      f.att, w.wo, f.pre, N, d, d, d, d,
      EpiArgs{w.bo, nullptr, nullptr, drop}, st);
  TG_CHECK();
  ln_fwd_rows<<<row_blocks, 32 * rows_per_block, 0, st>>>(
      f.pre, x, w.g1, w.be1, site(drop, kSitePostAttn), N, d, f.y1, f.xhat1,
      f.rs1);
  TG_CHECK();
  tf3::gemm<false, false, E_BIAS_RELU_DROP>(
      f.y1, w.wf1, f.f1, N, ff, d, d, ff,
      EpiArgs{w.bf1, nullptr, f.f1d, site(drop, kSiteFfMid)}, st);
  TG_CHECK();
  tf3::gemm<false, false, E_BIAS>(
      f.f1d, w.wf2, f.pre2, N, d, ff, ff, d,
      EpiArgs{w.bf2, nullptr, nullptr, drop}, st);
  TG_CHECK();
  ln_fwd_rows<<<row_blocks, 32 * rows_per_block, 0, st>>>(
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
// row, the attention backward's head rows): d, ff and the head width
// multiples of 4 values (f32), 8 (bf16: TMA's rows, the attention's loads)
bool mma_dims_ok(int d, int ff, int nh, int per16 = 4) {
  return d % per16 == 0 && ff % per16 == 0 && (d / nh) % per16 == 0;
}

// The backward after the recomputed forward f: dx and the twelve
// gradients in f32, in the order of the weights
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
  wgrad(f.f1d, g.df2, dwf2, ff, d, N, g.part, st);
  colsum(g.df2, nullptr, dbf2, N, d, g.part, st);
  TG_CHECK();
  // dh1 = (df2 W2^T) * mask_101 * (f1 > 0)
  tf3::gemm<false, true, E_DRELU_DROP>(
      g.df2, w.wf2, g.dh1, N, ff, d, d, d,
      EpiArgs{nullptr, f.f1, nullptr, site(drop, kSiteFfMid)}, st);
  TG_CHECK();
  wgrad(f.y1, g.dh1, dwf1, d, ff, N, g.part, st);
  colsum(g.dh1, nullptr, dbf1, N, ff, g.part, st);
  TG_CHECK();
  // dy1 = dr2 + dh1 W1^T; LN1; the post-attention mask
  tf3::gemm<false, true, E_ADD>(
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
  wgrad(f.att, g.da, dwo, d, d, N, g.part, st);
  colsum(g.da, nullptr, dbo, N, d, g.part, st);
  tf3::gemm<false, true, E_STORE>(g.da, w.wo, g.datt, N, d, d, d, d,
                                  EpiArgs{}, st);
  TG_CHECK();
  // attention
  const size_t attn_smem_b = attn_bwd_smem(T, d / nh);
  const cudaError_t attr = attn_bwd_smem_attr(attn_smem_b);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  attn_bwd_kernel<<<(N / T) * nh, 128, attn_smem_b, st>>>(
      f.qkv, g.datt, g.dqkv, D, scale, drop);
  TG_CHECK();
  // qkv projection; dx = dr1 + dqkv Wqkv^T
  wgrad(xf, g.dqkv, dwqkv, d, 3 * d, N, g.part, st);
  colsum(g.dqkv, nullptr, dbqkv, N, 3 * d, g.part, st);
  tf3::gemm<false, true, E_ADD>(
      g.dqkv, w.wqkv, dx, N, d, 3 * d, 3 * d, 3 * d,
      EpiArgs{nullptr, g.dr1, nullptr, drop}, st);
  TG_CHECK();
  return 0;
}

// ---------------------------------------------------------------------------
// The bf16 variants: K11 bf16 (encoder_layer_fwd_bf16_launch) and K12 bf16
// (encoder_layer_bwd_bf16_launch)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// The bf16 variants' scratch arrays, in the order of
// ops/encoder_train.py's BF16_ARRAYS: the wrapper lays them out
// (bf16_scratch_layout) and passes their addresses in this order. K11
// bf16 takes the first kFwdArrays.
enum {
  kQkv, kAtt, kPre, kY1, kY1b, kF1d, kPre2, kFwdArrays,
  kY = kFwdArrays, kXhat1, kRs1, kXhat2, kRs2, kPos, kDr2, kDf2, kDh1, kDy1,
  kDr1, kDa, kDatt, kDqkv, kCpLn2, kCpDh1, kCpLn1, kCpDqkv, kBwdArrays
};

// The layer's products, in the order of ops/encoder_train.py's PRODUCTS;
// the plan gives each (bm, bn, kchunk, splits)
enum {
  kPQkv, kPOut, kPFf1, kPFf2, kPDh1, kPDwF2, kPDy1, kPDwF1, kPDatt, kPDwO,
  kPDx, kPDwQkv, kProducts
};

// (M, N, K) of product i for N = B*T rows
void product_dims(const Dims& D, int i, int* mnk) {
  const int R = D.N, d = D.d, ff = D.ff;
  const int t[kProducts][3] = {
      {R, 3 * d, d}, {R, d, d},   {R, ff, d},     {R, d, ff},
      {R, ff, d},    {ff, d, R},  {R, d, ff},     {d, ff, R},
      {R, d, d},     {d, d, R},   {R, d, 3 * d},  {d, 3 * d, R}};
  for (int j = 0; j < 3; ++j) mnk[j] = t[i][j];
}

struct Bf16Layer {   // one launch's inputs
  const bf16 *x, *wqkv, *bqkv, *wo, *bo, *wf1, *bf1, *wf2, *bf2;
  const float *g1, *be1, *g2, *be2;
  Dims D;
  hm::Drop drop;
  void* const* arr;
  bg::Plan plan[kProducts];
  template <class T>
  T* at(int i) const {
    return static_cast<T*>(arr[i]);
  }
};

#define BG_TRY(expr)                                      \
  do {                                                    \
    const cudaError_t e_ = (expr);                        \
    if (e_ != cudaSuccess) return static_cast<int>(e_);   \
  } while (0)

__device__ __forceinline__ float f32_of(float v) { return v; }
__device__ __forceinline__ float f32_of(bf16 v) { return __bfloat162float(v); }

// y = LN((pre * mask) + res), one warp per row (8 rows a block), NPL
// values a lane: y in f32 (y32) and bf16 (y16), either may be null; xhat
// and rs where K12 keeps them (else null). res: x (bf16) or y1 (f32)
template <class Res, int NPL>
__global__ void __launch_bounds__(256)
    ln_fwd_bf16(const float* __restrict__ pre, const Res* __restrict__ res,
                const float* __restrict__ g, const float* __restrict__ b,
                hm::Drop drop, int N, int d, float* __restrict__ y32,
                bf16* __restrict__ y16, float* __restrict__ xhat,
                float* __restrict__ rs) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= N) return;
  const size_t base = static_cast<size_t>(row) * d;
  float v[NPL];
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int c = lane + 32 * i;
    float r = 0.0f;
    if (c < d) {
      const float a = pre[base + c] * hm::drop_at(drop, row, c, d);
      r = f32_of(res[base + c]) + a;
      s += r;
    }
    v[i] = r;
  }
  const float mu = warp_sum(s) / d;
  float q = 0.0f;
#pragma unroll
  for (int i = 0; i < NPL; ++i)
    if (lane + 32 * i < d) q += (v[i] - mu) * (v[i] - mu);
  const float var = warp_sum(q) / d;
  const float r_s = 1.0f / sqrtf(var + 1e-5f);
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int c = lane + 32 * i;
    if (c >= d) continue;
    const float xh = (v[i] - mu) * r_s;
    const float o = xh * g[c] + b[c];
    if (xhat) xhat[base + c] = xh;
    if (y32) y32[base + c] = o;
    if (y16) y16[base + c] = __float2bfloat16_rn(o);
  }
  if (lane == 0 && rs) rs[row] = r_s;
}

// dr = the LayerNorm backward of dy (f32) and dm = bf16(dr * mask), one
// warp per row. A block takes kLnRows rows (warp w rows 2 w, 2 w + 1) and
// writes the column sums of dy, dy * xhat and dr * mask over them, the
// rows in order, as rows blockIdx.x of colpart (3, gridDim.x, d): partial
// sums of the LayerNorm's two gradients and of the next product's bias
// gradient, f32. dy: K12's bf16 input gradient or dy1 (f32)
constexpr int kLnRows = 16;

template <class Dy, int NPL>
__global__ void __launch_bounds__(256)
    ln_bwd_bf16(const Dy* __restrict__ dy, const float* __restrict__ xhat,
                const float* __restrict__ rs, const float* __restrict__ g,
                hm::Drop drop, int N, int d, float* __restrict__ dr,
                bf16* __restrict__ dm, float* __restrict__ colpart) {
  __shared__ float sh[kLnRows / 2][kMaxD];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float cs[3][NPL];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int i = 0; i < NPL; ++i) cs[a][i] = 0.0f;
  for (int k = 0; k < 2; ++k) {
    const int row = blockIdx.x * kLnRows + warp * 2 + k;
    if (row >= N) break;
    const size_t base = static_cast<size_t>(row) * d;
    float dyv[NPL], dxh[NPL], xh[NPL];
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int c = lane + 32 * i;
      dyv[i] = dxh[i] = xh[i] = 0.0f;
      if (c < d) {
        dyv[i] = f32_of(dy[base + c]);
        dxh[i] = dyv[i] * g[c];
        xh[i] = xhat[base + c];
        s1 += dxh[i];
        s2 += dxh[i] * xh[i];
      }
    }
    const float m1 = warp_sum(s1) / d;
    const float m2 = warp_sum(s2) / d;
    const float r_s = rs[row];
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int c = lane + 32 * i;
      if (c >= d) continue;
      const float v = r_s * (dxh[i] - m1 - xh[i] * m2);
      const float m = v * hm::drop_at(drop, row, c, d);
      dr[base + c] = v;
      dm[base + c] = __float2bfloat16_rn(m);
      cs[0][i] += dyv[i];
      cs[1][i] += dyv[i] * xh[i];
      cs[2][i] += m;
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int i = 0; i < NPL; ++i)
      if (lane + 32 * i < d) sh[warp][lane + 32 * i] = cs[a][i];
    __syncthreads();
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      float s = 0.0f;
      for (int w = 0; w < kLnRows / 2; ++w) s += sh[w][c];
      colpart[(static_cast<size_t>(a) * gridDim.x + blockIdx.x) * d + c] = s;
    }
    __syncthreads();
  }
}

// out[a][c] = the sum over p of part[a][p * cols + c] (f32, or rounded to
// bf16 once): the bias and LayerNorm gradients from their partial sums,
// blockIdx.y = a; a block takes 32 columns, lane y of a column the rows p
// = y, y + 16, ... in order, and the 16 lanes are added in order
struct ColSums {
  const float* part[8];
  int parts[8];
  int cols[8];
  void* out[8];
  int rounded[8];   // out is bf16
};

__global__ void __launch_bounds__(512) colsum_final(ColSums cs) {
  __shared__ float sh[16][33];
  const int a = blockIdx.y, c = blockIdx.x * 32 + threadIdx.x;
  const bool on = c < cs.cols[a];
  float s = 0.0f;
  if (on)
    for (int p = threadIdx.y; p < cs.parts[a]; p += 16)
      s += cs.part[a][static_cast<size_t>(p) * cs.cols[a] + c];
  sh[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || !on) return;
  s = 0.0f;
  for (int y = 0; y < 16; ++y) s += sh[y][threadIdx.x];
  if (cs.rounded[a])
    static_cast<bf16*>(cs.out[a])[c] = __float2bfloat16_rn(s);
  else
    static_cast<float*>(cs.out[a])[c] = s;
}

// The bf16 attention: a block takes S.hb heads of one sample (2 where
// their row tiles fit kAttnWarps warps and the shared memory, else 1);
// their rows of q, k, v (and dO) are staged whole (16-byte loads along a
// row, the block's heads side by side) into tp x ld tiles, tp = T rounded
// up to 16, ld = the head width rounded up to 16 plus 8 (a warp's fragment
// loads then hit 32 banks), zeros past T and the head width. A warp takes
// row tiles of 16 rows of one head (warp w: head w % hb, tiles w / hb,
// w / hb + warps / hb, ...), their scores in registers kKeys keys at a
// time and their outputs kCols head columns at a time: a row tile whose
// causal keys fit one pass (every tile where T <= kKeys) takes its softmax
// from that pass, as the plain version does; a longer one takes the rows'
// max and sum first, over the key passes (online), and recomputes its
// scores pass by pass after. A head wider than kCols recomputes its
// probabilities for each column pass. Every product runs on mma.sync
// m16n8k16 in bf16 with f32 sums.
constexpr int kKeys = 64;       // keys of a register pass
constexpr int kCols = 64;       // head columns of a register pass
constexpr int kAttnWarps = 8;   // warps of a block at most
constexpr int kKt = kKeys / 8;  // 8-wide key tiles of a pass

__host__ __device__ inline int up16(int n) { return (n + 15) / 16 * 16; }

struct AttnShape {
  int T, hd, tp, hdp, ld, ldp, hb;
  __host__ __device__ AttnShape(int T_, int hd_, int hb_)
      : T(T_), hd(hd_), tp(up16(T_)), hdp(up16(hd_)), ld(up16(hd_) + 8),
        ldp(up16(T_) + 8), hb(hb_) {}
  __host__ __device__ int tile() const { return tp * ld; }   // a head's q
  __host__ __device__ int warps() const {
    return min(hb * (tp / 16), kAttnWarps);
  }
  int threads() const { return 32 * warps(); }
  // the kernels' general instantiation: more than one key or column
  // pass, more than one row tile a warp, or one head a block (the
  // straight-line one takes two heads, as attn_shape gives where one pass
  // does)
  __host__ __device__ bool passes() const {
    return tp > kKeys || hd > kCols || hb != 2 || warps() < hb * (tp / 16);
  }
  // the backward's partial column sums of a column pass: (tp / 16, 3, pc)
  // a head
  __host__ __device__ int pc() const { return min(hdp, kCols); }
  // q, k, v of the block's heads; the backward's dO too, then its P M and
  // dS (tp x ldp each a head), then the partial column sums (f32)
  size_t fwd_bytes() const { return 2 * static_cast<size_t>(hb) * 3 * tile(); }
  size_t bwd_bytes() const {
    return 2 * static_cast<size_t>(hb) * (4 * tile() + 2 * tp * ldp) +
           4 * static_cast<size_t>(hb) * (tp / 16) * 3 * pc();
  }
  size_t bytes(bool backward) const {
    return backward ? bwd_bytes() : fwd_bytes();
  }
};

// The attention's shape: two heads a block where they fit, else one
AttnShape attn_shape(int T, int hd, bool backward) {
  const AttnShape two(T, hd, 2);
  if (two.tp / 16 * 2 <= kAttnWarps && two.bytes(backward) <= kMaxSmem)
    return two;
  return AttnShape(T, hd, 1);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Stage sample b's rows for heads h0..: sections q, k, v (columns 0, d, 2d
// of qkv), and dO (datt) when nsec is 4; zeros elsewhere
__device__ __forceinline__ void attn_stage(const bf16* __restrict__ qkv,
                           const bf16* __restrict__ datt, int b, int h0,
                           const Dims& D, const AttnShape& S, bf16* sm,
                           int nsec) {
  const int n16 = nsec * S.hb * S.tile() / 8;
  for (int e = threadIdx.x; e < n16; e += blockDim.x)
    reinterpret_cast<uint4*>(sm)[e] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  const int hd = S.hd, d = D.d, T = D.T;
  const int heads = min(S.hb, D.nh - h0);
  const int cpr = heads * hd / 8;   // 16-byte pieces of a row's section
  const int total = nsec * T * cpr;
  for (int e0 = threadIdx.x; e0 < total; e0 += 4 * blockDim.x) {
    uint4 v[4];   // four loads in flight a thread
    int at[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e >= total) break;
      const int sec = e / (T * cpr), r = e % (T * cpr);
      const int t = r / cpr, c = 8 * (r % cpr);
      const size_t row = static_cast<size_t>(b) * T + t;
      const bf16* src = sec < 3 ? qkv + row * 3 * d + sec * d + h0 * hd + c
                                : datt + row * d + h0 * hd + c;
      v[u] = *reinterpret_cast<const uint4*>(src);
      at[u] = (sec * S.hb + c / hd) * S.tile() + t * S.ld + c % hd;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (e0 + u * blockDim.x >= total) break;
      *reinterpret_cast<uint4*>(sm + at[u]) = v[u];
    }
  }
  __syncthreads();
}

// s = A B^T for rows 16 mt.. of A against rows 8 (nt0 + nt).. of B, nt <
// ntc (A, B: tp x ld tiles): s[nt] the 16 x 8 fragments (rows g, g + 8;
// columns 2 q, 2 q + 1)
__device__ __forceinline__ void scores(const bf16* A, const bf16* B,
                                       const AttnShape& S, int mt, int nt0,
                                       int ntc, float (&s)[kKt][4], int g,
                                       int q) {
#pragma unroll
  for (int nt = 0; nt < kKt; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) s[nt][r] = 0.0f;
  for (int kk = 0; kk < S.hdp; kk += 16) {
    const bf16* a0 = A + (mt * 16 + g) * S.ld + kk + 2 * q;
    const uint32_t a[4] = {ld32(a0), ld32(a0 + 8 * S.ld), ld32(a0 + 8),
                           ld32(a0 + 8 * S.ld + 8)};
#pragma unroll
    for (int nt = 0; nt < kKt; ++nt) {
      if (nt >= ntc) break;
      const bf16* b0 = B + ((nt0 + nt) * 8 + g) * S.ld + kk + 2 * q;
      const uint32_t bb[2] = {ld32(b0), ld32(b0 + 8)};
      tf3::mma_bf16(s[nt], a, bb);
    }
  }
}

// is (i, j) of the fragments' entry r in tile (mt, nt) a causal score
__device__ __forceinline__ bool causal_at(int mt, int nt, int r, int T,
                                          int g, int q, int* i, int* j) {
  *i = mt * 16 + g + 8 * (r >> 1);
  *j = nt * 8 + 2 * q + (r & 1);
  return *j <= *i && *i < T;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the scores s (scaled here) of rows 16 mt.. against all their ntl key
// tiles (ntl <= kKt) to their softmax P, f32, 0 off the causal entries; a
// row's values lie in the four lanes of a quad
__device__ __forceinline__ void softmax_rows(float (&s)[kKt][4], int mt,
                                             int ntl, int T, float scale,
                                             int g, int q) {
  float mx[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)};
  int i, j;
#pragma unroll
  for (int nt = 0; nt < kKt; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (nt < ntl && causal_at(mt, nt, r, T, g, q, &i, &j)) {
        s[nt][r] = s[nt][r] * scale;
        mx[r >> 1] = fmaxf(mx[r >> 1], s[nt][r]);
      }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < 2; ++h) mx[h] = quad_max(mx[h]);
#pragma unroll
  for (int nt = 0; nt < kKt; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const bool on = nt < ntl && causal_at(mt, nt, r, T, g, q, &i, &j);
      s[nt][r] = on ? expf(s[nt][r] - mx[r >> 1]) : 0.0f;
      sum[r >> 1] += s[nt][r];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) sum[h] = quad_sum(sum[h]);
#pragma unroll
  for (int nt = 0; nt < kKt; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (nt < ntl && causal_at(mt, nt, r, T, g, q, &i, &j))
        s[nt][r] = s[nt][r] / sum[r >> 1];
}

// A row tile whose ntl key tiles take more than one pass: its rows' score
// max mx and sum of exp(score - mx) over the passes, the sum rescaled as
// the max grows
__device__ void row_stats(const bf16* sq, const bf16* sk, const AttnShape& S,
                          int mt, int ntl, float scale, int g, int q,
                          float (&mx)[2], float (&sum)[2]) {
  const int T = S.T;
  int i, j;
  for (int h = 0; h < 2; ++h) {
    mx[h] = __int_as_float(0xff800000);
    sum[h] = 0.0f;
  }
  for (int nt0 = 0; nt0 < ntl; nt0 += kKt) {
    const int ntc = min(ntl - nt0, kKt);
    float s[kKt][4];
    scores(sq, sk, S, mt, nt0, ntc, s, g, q);
    float cm[2] = {mx[0], mx[1]};
#pragma unroll
    for (int nt = 0; nt < kKt; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (nt < ntc && causal_at(mt, nt0 + nt, r, T, g, q, &i, &j)) {
          s[nt][r] = s[nt][r] * scale;
          cm[r >> 1] = fmaxf(cm[r >> 1], s[nt][r]);
        }
    float cs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) cm[h] = quad_max(cm[h]);
#pragma unroll
    for (int nt = 0; nt < kKt; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (nt < ntc && causal_at(mt, nt0 + nt, r, T, g, q, &i, &j))
          cs[r >> 1] += expf(s[nt][r] - cm[r >> 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // rows past T have no score: their max stays -inf, their sum 0
      const float f = mx[h] == cm[h] ? 1.0f : expf(mx[h] - cm[h]);
      sum[h] = sum[h] * f + quad_sum(cs[h]);
      mx[h] = cm[h];
    }
  }
}

// P of row tile mt over key tiles nt0 .. nt0 + kKt - 1 of its ntl: one
// pass's softmax where ntl <= kKt (nt0 0; always where !kPasses), else
// from row_stats' mx and sum
template <bool kPasses>
__device__ __forceinline__ void probs(const bf16* sq, const bf16* sk,
                                      const AttnShape& S, int mt, int nt0,
                                      int ntl, float scale,
                                      const float (&mx)[2],
                                      const float (&sum)[2],
                                      float (&s)[kKt][4], int g, int q) {
  const int ntc = min(ntl - nt0, kKt);
  scores(sq, sk, S, mt, nt0, ntc, s, g, q);
  if (!kPasses || ntl <= kKt) {
    softmax_rows(s, mt, ntl, S.T, scale, g, q);
    return;
  }
  int i, j;
#pragma unroll
  for (int nt = 0; nt < kKt; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const bool on =
          nt < ntc && causal_at(mt, nt0 + nt, r, S.T, g, q, &i, &j);
      s[nt][r] = on ? expf(s[nt][r] * scale - mx[r >> 1]) / sum[r >> 1]
                    : 0.0f;
    }
}

// keep value of score (i, j) of sample b: its index over the batch tile's
// (tile_rows, tile_rows) score matrix
__device__ __forceinline__ float attn_keep(const hm::Drop& drop, int b,
                                           int T, int i, int j) {
  if (!drop.on) return 1.0f;
  const int gi = b * T + i;
  const int tile = gi / drop.tile_rows;
  const int ri = gi - tile * drop.tile_rows;
  const int cj = b * T + j - tile * drop.tile_rows;
  return hm::keep(hm::tile_seed(drop.seed, tile), drop.site,
                  static_cast<unsigned>(ri) *
                          static_cast<unsigned>(drop.tile_rows) +
                      static_cast<unsigned>(cj),
                  drop.p_keep, drop.inv_keep);
}

// acc (16 rows of tile mt, head columns c0 .. c0 + kCols - 1) = X Y over
// the tp rows of K, X (16 x tp, row stride ldx) read as it lies, or
// transposed (kTrans: X stored tp x 16-row tiles, row stride ldx); Y (tp x
// hd, row stride ldy)
template <bool kTrans>
__device__ __forceinline__ void rows_product(const bf16* X, int ldx,
                                             const bf16* Y, int ldy,
                                             const AttnShape& S, int mt,
                                             int c0,
                                             float (&acc)[kCols / 8][4],
                                             int g, int q) {
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] = 0.0f;
  for (int k0 = 0; k0 < S.tp; k0 += 16) {
    uint32_t a[4];   // rows g, g + 8; columns 2 q (+8), 2 q + 1
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int r = mt * 16 + g + 8 * (x & 1), k = k0 + 2 * q + 8 * (x >> 1);
      a[x] = kTrans ? pack2(X[k * ldx + r], X[(k + 1) * ldx + r])
                    : ld32(X + r * ldx + k);
    }
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n) {
      if (c0 + n * 8 >= S.hd) break;
      const bf16* y0 = Y + (k0 + 2 * q) * ldy + c0 + n * 8 + g;
      const uint32_t bb[2] = {pack2(y0[0], y0[ldy]),
                              pack2(y0[8 * ldy], y0[9 * ldy])};
      tf3::mma_bf16(acc[n], a, bb);
    }
  }
}

// att = (P M) v per (sample, head), P = softmax(q k^T * scale, causal) in
// f32, P M rounded to bf16 as the product's operand; att in bf16.
// kPasses (S.passes()): the loops over a warp's row tiles, key passes and
// column passes; else each runs once, straight-line code
template <bool kPasses>
__global__ void __launch_bounds__(32 * kAttnWarps, 3)
    attn_fwd_bf16(const bf16* __restrict__ qkv, bf16* __restrict__ att,
                  Dims D, AttnShape shape, float scale, hm::Drop drop) {
  extern __shared__ uint4 sh_fwd[];
  AttnShape S = shape;
  if (!kPasses) S.hb = 2;   // a constant of the straight-line code
  bf16* sm = reinterpret_cast<bf16*>(sh_fwd);
  const int b = blockIdx.x, h0 = blockIdx.y * S.hb;
  attn_stage(qkv, nullptr, b, h0, D, S, sm, 3);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hl = warp % S.hb;
  const int g = lane >> 2, q = lane & 3, h = h0 + hl, T = D.T;
  if (h >= D.nh) return;
  const bf16* sq = sm + hl * S.tile();
  const bf16* sk = sm + (S.hb + hl) * S.tile();
  const bf16* sv = sm + (2 * S.hb + hl) * S.tile();
  drop.site = kSiteAttn + h;
  const int mt0 = warp / S.hb;
  for (int mt = mt0; mt < (kPasses ? S.tp / 16 : mt0 + 1);
       mt += S.warps() / S.hb) {
    const int ntl = min(2 * mt + 2, S.tp / 8);   // even: whole 16-wide steps
    float mx[2] = {0.0f, 0.0f}, sum[2] = {1.0f, 1.0f};
    if (kPasses && ntl > kKt)
      row_stats(sq, sk, S, mt, ntl, scale, g, q, mx, sum);
    for (int c0 = 0; c0 < (kPasses ? S.hd : 1); c0 += kCols) {
      float o[kCols / 8][4];
#pragma unroll
      for (int n = 0; n < kCols / 8; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) o[n][r] = 0.0f;
      for (int nt0 = 0; nt0 < (kPasses ? ntl : 1); nt0 += kKt) {
        float s[kKt][4];
        probs<kPasses>(sq, sk, S, mt, nt0, ntl, scale, mx, sum, s, g, q);
#pragma unroll
        for (int kt = 0; kt < kKt / 2; ++kt) {
          if (nt0 + 2 * kt >= ntl) break;
          uint32_t a[4];   // the fragments of P M over keys 8 nt0 + 16 kt ..
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int nt = 2 * kt + half;
            float pm[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              int i, j;
              pm[r] = causal_at(mt, nt0 + nt, r, T, g, q, &i, &j)
                          ? s[nt][r] * attn_keep(drop, b, T, i, j)
                          : 0.0f;
            }
            a[2 * half] = tf3::pack_bf16(pm[0], pm[1]);
            a[2 * half + 1] = tf3::pack_bf16(pm[2], pm[3]);
          }
#pragma unroll
          for (int n = 0; n < kCols / 8; ++n) {
            if (c0 + n * 8 >= S.hd) break;
            const bf16* v0 =
                sv + (nt0 * 8 + kt * 16 + 2 * q) * S.ld + c0 + n * 8 + g;
            const uint32_t bb[2] = {pack2(v0[0], v0[S.ld]),
                                    pack2(v0[8 * S.ld], v0[9 * S.ld])};
            tf3::mma_bf16(o[n], a, bb);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < kCols / 8; ++n) {
        if (c0 + n * 8 >= S.hd) break;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = mt * 16 + g + 8 * hh;
          if (i < T)
            *reinterpret_cast<uint32_t*>(
                att + (static_cast<size_t>(b) * T + i) * D.d + h * S.hd +
                c0 + n * 8 + 2 * q) =
                tf3::pack_bf16(o[n][2 * hh], o[n][2 * hh + 1]);
        }
      }
    }
  }
}

// a head's tiles in the backward's shared memory
struct Heads {
  const bf16 *q, *k, *v, *dO;
  bf16 *pm, *ds;
};

// Key tiles nt0 .. nt0 + kKt - 1 (of ntl) of row tile mt: p = P, dp = (dO
// v^T) M, pm = P M; with sums, rs (the lanes' rows) += dP M P
template <bool kPasses>
__device__ __forceinline__ void pm_dp(const Heads& H, const AttnShape& S,
                                      const hm::Drop& drop, int b, int mt,
                                      int nt0, int ntl, float scale,
                                      const float (&mx)[2],
                                      const float (&sum)[2],
                                      float (&p)[kKt][4], float (&dp)[kKt][4],
                                      float (&pm)[kKt][4], float (&rs)[2],
                                      bool sums, int g, int q) {
  probs<kPasses>(H.q, H.k, S, mt, nt0, ntl, scale, mx, sum, p, g, q);
  scores(H.dO, H.v, S, mt, nt0, min(ntl - nt0, kKt), dp, g, q);
#pragma unroll
  for (int nt = 0; nt < kKt; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      int i, j;
      const float m =
          nt0 + nt < ntl && causal_at(mt, nt0 + nt, r, S.T, g, q, &i, &j)
              ? attn_keep(drop, b, S.T, i, j)
              : 0.0f;
      dp[nt][r] = dp[nt][r] * m;
      pm[nt][r] = p[nt][r] * m;
      if (sums) rs[r >> 1] += dp[nt][r] * p[nt][r];
    }
}

// P M and dS = P (dP M - rs) of key tiles nt0 .. (those below tp / 8) of
// row tile mt in bf16, 0 off the causal entries
__device__ __forceinline__ void store_pm_ds(const Heads& H,
                                            const AttnShape& S, int mt,
                                            int nt0, int ntl,
                                            const float (&p)[kKt][4],
                                            const float (&dp)[kKt][4],
                                            const float (&pm)[kKt][4],
                                            const float (&rs)[2], int g,
                                            int q) {
#pragma unroll
  for (int nt = 0; nt < kKt; ++nt) {
    if ((nt0 + nt) * 8 >= S.tp) break;
    const bool live = nt0 + nt < ntl;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = mt * 16 + g + 8 * hh, j = (nt0 + nt) * 8 + 2 * q;
      float ds[2], pmv[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        int ii, jj;
        const int r = 2 * hh + c;
        ds[c] = live && causal_at(mt, nt0 + nt, r, S.T, g, q, &ii, &jj)
                    ? p[nt][r] * (dp[nt][r] - rs[hh])
                    : 0.0f;
        pmv[c] = live ? pm[nt][r] : 0.0f;
      }
      *reinterpret_cast<uint32_t*>(H.pm + i * S.ldp + j) =
          tf3::pack_bf16(pmv[0], pmv[1]);
      *reinterpret_cast<uint32_t*>(H.ds + i * S.ldp + j) =
          tf3::pack_bf16(ds[0], ds[1]);
    }
  }
}

// The attention backward per (sample, head), from qkv and datt (bf16):
// P and the keep values M recomputed as the forward forms them, dP =
// (dO v^T) M, dS = P (dP - rowsum(dP P)); P M and dS rounded to bf16 into
// shared memory (the operands of dv = (P M)^T dO, dq = dS k scale, dk =
// dS^T q scale); dqkv in bf16, and the column sums of its f32 values over
// the sample's rows, row tiles in order, as row b of colpart (B, 3 d): the
// partial sums of the qkv bias gradient. A warp takes its row tiles' rows
// of P M and dS, then their rows of dq, dk and dv, kCols columns a pass
// (kPasses as attn_fwd_bf16's).
template <bool kPasses>
__global__ void __launch_bounds__(32 * kAttnWarps, 3)
    attn_bwd_bf16(const bf16* __restrict__ qkv, const bf16* __restrict__ datt,
                  bf16* __restrict__ dqkv, float* __restrict__ colpart,
                  Dims D, AttnShape shape, float scale, hm::Drop drop) {
  extern __shared__ uint4 sh_bwd[];
  AttnShape S = shape;
  if (!kPasses) S.hb = 2;
  bf16* sm = reinterpret_cast<bf16*>(sh_bwd);
  const int b = blockIdx.x, h0 = blockIdx.y * S.hb;
  attn_stage(qkv, datt, b, h0, D, S, sm, 4);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hl = warp % S.hb, mt0 = warp / S.hb, mstep = S.warps() / S.hb;
  const int g = lane >> 2, q = lane & 3, h = h0 + hl, T = D.T, d = D.d;
  const bool on = h < D.nh;   // every warp reaches the block's barriers
  const bf16* sq = sm + hl * S.tile();
  const bf16* sk = sm + (S.hb + hl) * S.tile();
  const bf16* sv = sm + (2 * S.hb + hl) * S.tile();
  const bf16* sdo = sm + (3 * S.hb + hl) * S.tile();
  bf16* pm_s = sm + 4 * S.hb * S.tile() + hl * S.tp * S.ldp;
  bf16* ds_s = sm + 4 * S.hb * S.tile() + (S.hb + hl) * S.tp * S.ldp;
  // (hb, tp / 16, 3, pc): the row tiles' column sums of a column pass
  float* part = reinterpret_cast<float*>(sm + 4 * S.hb * S.tile() +
                                         2 * S.hb * S.tp * S.ldp);
  drop.site = kSiteAttn + h;
  const Heads H{sq, sk, sv, sdo, pm_s, ds_s};
  const int mt1 = kPasses ? S.tp / 16 : mt0 + 1;   // past the warp's tiles
  for (int mt = mt0; on && mt < mt1; mt += mstep) {
    const int ntl = min(2 * mt + 2, S.tp / 8);
    float mx[2] = {0.0f, 0.0f}, sum[2] = {1.0f, 1.0f}, rs[2] = {0.0f, 0.0f};
    if (!kPasses || ntl <= kKt) {   // the row's keys in one pass
      float p[kKt][4], dp[kKt][4], pm[kKt][4];
      pm_dp<false>(H, S, drop, b, mt, 0, ntl, scale, mx, sum, p, dp, pm, rs, true, g,
            q);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) rs[hh] = quad_sum(rs[hh]);
      store_pm_ds(H, S, mt, 0, ntl, p, dp, pm, rs, g, q);
    } else {
      row_stats(sq, sk, S, mt, ntl, scale, g, q, mx, sum);
      for (int nt0 = 0; nt0 < ntl; nt0 += kKt) {
        float p[kKt][4], dp[kKt][4], pm[kKt][4];
        pm_dp<true>(H, S, drop, b, mt, nt0, ntl, scale, mx, sum, p, dp, pm,
                    rs, true, g, q);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) rs[hh] = quad_sum(rs[hh]);
      for (int nt0 = 0; nt0 < ntl; nt0 += kKt) {
        float p[kKt][4], dp[kKt][4], pm[kKt][4];
        pm_dp<true>(H, S, drop, b, mt, nt0, ntl, scale, mx, sum, p, dp, pm,
                    rs, false, g, q);
        store_pm_ds(H, S, mt, nt0, ntl, p, dp, pm, rs, g, q);
      }
    }
    // the key tiles past the last pass: 0
    for (int nt = (ntl + kKt - 1) / kKt * kKt; kPasses && nt < S.tp / 8; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int at = (mt * 16 + g + 8 * hh) * S.ldp + nt * 8 + 2 * q;
        *reinterpret_cast<uint32_t*>(pm_s + at) = 0u;
        *reinterpret_cast<uint32_t*>(ds_s + at) = 0u;
      }
  }
  __syncthreads();   // the heads' every row of P M and dS
  const int heads = min(S.hb, D.nh - h0), pc = S.pc();
  for (int c0 = 0; c0 < (kPasses ? S.hd : 1); c0 += kCols) {
    // dq = dS k scale (rows i), dk = dS^T q scale and dv = (P M)^T dO
    // (rows j) of the warp's row tiles; sec: 0 q, 1 k, 2 v of dqkv's
    // columns; each column's sum over the tile's rows into part
    for (int mt = mt0; on && mt < mt1; mt += mstep) {
#pragma unroll
      for (int sec = 0; sec < 3; ++sec) {
        float acc[kCols / 8][4];
        if (sec == 0)
          rows_product<false>(ds_s, S.ldp, sk, S.ld, S, mt, c0, acc, g, q);
        else if (sec == 1)
          rows_product<true>(ds_s, S.ldp, sq, S.ld, S, mt, c0, acc, g, q);
        else
          rows_product<true>(pm_s, S.ldp, sdo, S.ld, S, mt, c0, acc, g, q);
        const float mul = sec < 2 ? scale : 1.0f;
#pragma unroll
        for (int n = 0; n < kCols / 8; ++n) {
          if (c0 + n * 8 >= S.hd) break;
          float cs[2] = {0.0f, 0.0f};
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int t = mt * 16 + g + 8 * hh;
            if (t >= T) continue;
            const float v0 = acc[n][2 * hh] * mul;
            const float v1 = acc[n][2 * hh + 1] * mul;
            *reinterpret_cast<uint32_t*>(
                dqkv + (static_cast<size_t>(b) * T + t) * 3 * d + sec * d +
                h * S.hd + c0 + n * 8 + 2 * q) = tf3::pack_bf16(v0, v1);
            cs[0] += v0;
            cs[1] += v1;
          }
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float v = cs[c];   // over the lanes of a column, in order
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (g == 0)
              part[((hl * (S.tp / 16) + mt) * 3 + sec) * pc + n * 8 + 2 * q +
                   c] = v;
          }
        }
      }
    }
    __syncthreads();
    // the row tiles' sums in order, a thread per column of the heads
    const int w = min(pc, S.hd - c0);
    for (int e = threadIdx.x; e < heads * 3 * w; e += blockDim.x) {
      const int hh = e / (3 * w), sec = (e / w) % 3, c = e % w;
      const float* ph = part + hh * (S.tp / 16) * 3 * pc;
      float v = 0.0f;
      for (int m = 0; m < S.tp / 16; ++m) v += ph[(m * 3 + sec) * pc + c];
      colpart[static_cast<size_t>(b) * 3 * d + sec * d + (h0 + hh) * S.hd +
              c0 + c] = v;
    }
    if (kPasses && c0 + kCols < S.hd) __syncthreads();   // part is read
  }
}

// The bf16 attention's launches: the instantiation S.passes() asks for, on
// a block per sample and S.hb heads
cudaError_t attn_fwd(const bf16* qkv, bf16* att, const Dims& D, float scale,
                     const hm::Drop& drop, cudaStream_t st) {
  const AttnShape S = attn_shape(D.T, D.d / D.nh, false);
  const bool ps = S.passes();
  static size_t allowed[2] = {48 * 1024, 48 * 1024};
  const cudaError_t e = smem_attr(
      ps ? reinterpret_cast<const void*>(attn_fwd_bf16<true>)
         : reinterpret_cast<const void*>(attn_fwd_bf16<false>),
      S.fwd_bytes(), &allowed[ps]);
  if (e != cudaSuccess) return e;
  const dim3 grid(D.N / D.T, (D.nh + S.hb - 1) / S.hb);
  if (ps)
    attn_fwd_bf16<true><<<grid, S.threads(), S.fwd_bytes(), st>>>(
        qkv, att, D, S, scale, drop);
  else
    attn_fwd_bf16<false><<<grid, S.threads(), S.fwd_bytes(), st>>>(
        qkv, att, D, S, scale, drop);
  return cudaGetLastError();
}

cudaError_t attn_bwd(const bf16* qkv, const bf16* datt, bf16* dqkv,
                     float* colpart, const Dims& D, float scale,
                     const hm::Drop& drop, cudaStream_t st) {
  const AttnShape S = attn_shape(D.T, D.d / D.nh, true);
  const bool ps = S.passes();
  static size_t allowed[2] = {48 * 1024, 48 * 1024};
  const cudaError_t e = smem_attr(
      ps ? reinterpret_cast<const void*>(attn_bwd_bf16<true>)
         : reinterpret_cast<const void*>(attn_bwd_bf16<false>),
      S.bwd_bytes(), &allowed[ps]);
  if (e != cudaSuccess) return e;
  const dim3 grid(D.N / D.T, (D.nh + S.hb - 1) / S.hb);
  if (ps)
    attn_bwd_bf16<true><<<grid, S.threads(), S.bwd_bytes(), st>>>(
        qkv, datt, dqkv, colpart, D, S, scale, drop);
  else
    attn_bwd_bf16<false><<<grid, S.threads(), S.bwd_bytes(), st>>>(
        qkv, datt, dqkv, colpart, D, S, scale, drop);
  return cudaGetLastError();
}

bg::EpiArgs epi(int kind, void* out, bool out_bf16) {
  bg::EpiArgs e{};
  e.kind = kind;
  e.out = out;
  e.out_bf16 = out_bf16 ? 1 : 0;
  return e;
}

template <class Res>
void ln_fwd_launch(const float* pre, const Res* res, const float* g,
                   const float* b, const hm::Drop& drop, int N, int d,
                   float* y32, bf16* y16, float* xhat, float* rs,
                   cudaStream_t st) {
  const int blocks = (N + 7) / 8;
  if (d <= 256)
    ln_fwd_bf16<Res, 8><<<blocks, 256, 0, st>>>(pre, res, g, b, drop, N, d,
                                                y32, y16, xhat, rs);
  else
    ln_fwd_bf16<Res, kMaxD / 32><<<blocks, 256, 0, st>>>(
        pre, res, g, b, drop, N, d, y32, y16, xhat, rs);
}

template <class Dy>
void ln_bwd_launch(const Dy* dy, const float* xhat, const float* rs,
                   const float* g, const hm::Drop& drop, int N, int d,
                   float* dr, bf16* dm, float* colpart, cudaStream_t st) {
  const int blocks = (N + kLnRows - 1) / kLnRows;
  if (d <= 256)
    ln_bwd_bf16<Dy, 8><<<blocks, 256, 0, st>>>(dy, xhat, rs, g, drop, N, d,
                                               dr, dm, colpart);
  else
    ln_bwd_bf16<Dy, kMaxD / 32><<<blocks, 256, 0, st>>>(
        dy, xhat, rs, g, drop, N, d, dr, dm, colpart);
}

// K11 bf16's forward, and the forward K12 bf16 recomputes (keep: xhat1,
// rs1, xhat2, rs2 and the ReLU's signs kept for the backward): y in bf16
int forward_bf16(const Bf16Layer& L, bf16* y, bool keep, cudaStream_t st) {
  const Dims& D = L.D;
  const int N = D.N, d = D.d, ff = D.ff;
  const float scale = 1.0f / sqrtf(static_cast<float>(d / D.nh));
  bf16* qkv = L.at<bf16>(kQkv);
  bf16* att = L.at<bf16>(kAtt);
  float* y1 = L.at<float>(kY1);
  bf16* y1b = L.at<bf16>(kY1b);
  bf16* f1d = L.at<bf16>(kF1d);
  bg::EpiArgs e = epi(tg::E_BIAS, qkv, true);
  e.bias = L.bqkv;
  BG_TRY((bg::product<false, false>(L.plan[kPQkv], L.x, L.wqkv, N, 3 * d, d,
                                    e, st)));
  BG_TRY(attn_fwd(qkv, att, D, scale, L.drop, st));
  e = epi(tg::E_BIAS, L.arr[kPre], false);
  e.bias = L.bo;
  BG_TRY((bg::product<false, false>(L.plan[kPOut], att, L.wo, N, d, d, e,
                                    st)));
  ln_fwd_launch(L.at<const float>(kPre), L.x, L.g1, L.be1,
                site(L.drop, kSitePostAttn), N, d, y1, y1b,
                keep ? L.at<float>(kXhat1) : nullptr,
                keep ? L.at<float>(kRs1) : nullptr, st);
  TG_CHECK();
  e = epi(tg::E_BIAS_RELU_DROP, f1d, true);
  e.bias = L.bf1;
  e.pos_out = keep ? L.at<uint8_t>(kPos) : nullptr;
  e.drop = site(L.drop, kSiteFfMid);
  BG_TRY((bg::product<false, false>(L.plan[kPFf1], y1b, L.wf1, N, ff, d, e,
                                    st)));
  e = epi(tg::E_BIAS, L.arr[kPre2], false);
  e.bias = L.bf2;
  BG_TRY((bg::product<false, false>(L.plan[kPFf2], f1d, L.wf2, N, d, ff, e,
                                    st)));
  ln_fwd_launch(L.at<const float>(kPre2), static_cast<const float*>(y1),
                L.g2, L.be2, site(L.drop, kSitePostFf), N, d, nullptr, y,
                keep ? L.at<float>(kXhat2) : nullptr,
                keep ? L.at<float>(kRs2) : nullptr, st);
  TG_CHECK();
  return 0;
}

// K12 bf16's backward after forward_bf16(keep): dx and the eight
// matmul-weight and bias gradients in bf16, each rounded once from its f32
// value; the four LayerNorm gradients in f32
int backward_bf16(const Bf16Layer& L, const bf16* dy, bf16* dx,
                  void* const* gr, cudaStream_t st) {
  const Dims& D = L.D;
  const int N = D.N, d = D.d, ff = D.ff;
  const int nb = (N + kLnRows - 1) / kLnRows;    // LayerNorm row blocks
  const int mt = (N + bg::WM - 1) / bg::WM;      // dh1's 64-row blocks
  const float scale = 1.0f / sqrtf(static_cast<float>(d / D.nh));
  bf16* df2 = L.at<bf16>(kDf2);
  bf16* dh1 = L.at<bf16>(kDh1);
  bf16* da = L.at<bf16>(kDa);
  bf16* datt = L.at<bf16>(kDatt);
  bf16* dqkv = L.at<bf16>(kDqkv);
  float* cp_ln2 = L.at<float>(kCpLn2);
  float* cp_ln1 = L.at<float>(kCpLn1);
  // LN2, the post-FF mask
  ln_bwd_launch(dy, L.at<const float>(kXhat2), L.at<const float>(kRs2), L.g2,
                site(L.drop, kSitePostFf), N, d, L.at<float>(kDr2), df2,
                cp_ln2, st);
  TG_CHECK();
  // dh1 = (df2 W2^T) * mask_101 * (f1 > 0), its column sums; dW2
  bg::EpiArgs e = epi(tg::E_DRELU_DROP, dh1, true);
  e.pos = L.at<const uint8_t>(kPos);
  e.drop = site(L.drop, kSiteFfMid);
  e.colpart = L.at<float>(kCpDh1);
  BG_TRY((bg::product<false, true>(L.plan[kPDh1], df2, L.wf2, N, ff, d, e,
                                   st)));
  BG_TRY((bg::product<true, false>(L.plan[kPDwF2], L.at<bf16>(kF1d), df2, ff,
                                   d, N, epi(tg::E_STORE, gr[6], true), st)));
  // dy1 = dr2 + dh1 W1^T; dW1
  e = epi(tg::E_ADD, L.arr[kDy1], false);
  e.aux = L.at<const float>(kDr2);
  BG_TRY((bg::product<false, true>(L.plan[kPDy1], dh1, L.wf1, N, d, ff, e,
                                   st)));
  BG_TRY((bg::product<true, false>(L.plan[kPDwF1], L.at<bf16>(kY1b), dh1, d,
                                   ff, N, epi(tg::E_STORE, gr[4], true), st)));
  // LN1, the post-attention mask; the out projection
  ln_bwd_launch(L.at<const float>(kDy1), L.at<const float>(kXhat1),
                L.at<const float>(kRs1), L.g1, site(L.drop, kSitePostAttn), N,
                d, L.at<float>(kDr1), da, cp_ln1, st);
  TG_CHECK();
  BG_TRY((bg::product<false, true>(L.plan[kPDatt], da, L.wo, N, d, d,
                                   epi(tg::E_STORE, datt, true), st)));
  BG_TRY((bg::product<true, false>(L.plan[kPDwO], L.at<bf16>(kAtt), da, d, d,
                                   N, epi(tg::E_STORE, gr[2], true), st)));
  // attention
  BG_TRY(attn_bwd(L.at<bf16>(kQkv), datt, dqkv, L.at<float>(kCpDqkv), D,
                  scale, L.drop, st));
  // dx = dr1 + dqkv Wqkv^T; dWqkv
  e = epi(tg::E_ADD, dx, true);
  e.aux = L.at<const float>(kDr1);
  BG_TRY((bg::product<false, true>(L.plan[kPDx], dqkv, L.wqkv, N, d, 3 * d,
                                   e, st)));
  BG_TRY((bg::product<true, false>(L.plan[kPDwQkv], L.x, dqkv, d, 3 * d, N,
                                   epi(tg::E_STORE, gr[0], true), st)));
  // the bias and LayerNorm gradients from their partial sums
  ColSums cs{};
  const size_t nbd = static_cast<size_t>(nb) * d;
  const struct {
    const float* part;
    int parts, cols, out, rounded;
  } sums[8] = {{cp_ln2, nb, d, 11, 0},              // LN2's beta
               {cp_ln2 + nbd, nb, d, 10, 0},        // LN2's gamma
               {cp_ln2 + 2 * nbd, nb, d, 7, 1},     // FF2's bias
               {L.at<float>(kCpDh1), mt, ff, 5, 1},  // FF1's bias
               {cp_ln1, nb, d, 9, 0},               // LN1's beta
               {cp_ln1 + nbd, nb, d, 8, 0},         // LN1's gamma
               {cp_ln1 + 2 * nbd, nb, d, 3, 1},     // the out projection's
               {L.at<float>(kCpDqkv), N / D.T, 3 * d, 1, 1}};   // qkv's
  int most = 0;
  for (int a = 0; a < 8; ++a) {
    cs.part[a] = sums[a].part;
    cs.parts[a] = sums[a].parts;
    cs.cols[a] = sums[a].cols;
    cs.out[a] = gr[sums[a].out];
    cs.rounded[a] = sums[a].rounded;
    most = sums[a].cols > most ? sums[a].cols : most;
  }
  colsum_final<<<dim3((most + 31) / 32, 8), dim3(32, 16), 0, st>>>(cs);
  TG_CHECK();
  return 0;
}

// Check the bf16 variants' shapes (K12 bf16's when n is kProducts) and
// take the launch's inputs: x and ws[0..7] bf16, ws[8..11] f32; `plan`:
// the first n products' (bm, bn, kchunk, splits)
bool bf16_setup(Bf16Layer* L, const void* x, const void* const* ws,
                void* const* arrays, const int* plan, int n, int B, int T,
                int d, int ff, int nh, int bt, int seed, float p_keep,
                float inv_keep, int use_drop) {
  const bool backward = n == kProducts;
  if (!(B > 0 && T > 0 && d > 0 && d <= kMaxD && ff > 0 && nh > 0 &&
        d % nh == 0 && bt > 0 && B % bt == 0 && mma_dims_ok(d, ff, nh, 8) &&
        attn_shape(T, d / nh, backward).bytes(backward) <= kMaxSmem))
    return false;
  L->D = Dims{B * T, T, d, ff, nh, bt * T};
  L->drop = hm::Drop{use_drop, seed, 0, bt * T, p_keep, inv_keep};
  L->arr = arrays;
  const bf16* w[8];
  for (int i = 0; i < 8; ++i) w[i] = static_cast<const bf16*>(ws[i]);
  L->x = static_cast<const bf16*>(x);
  L->wqkv = w[0];
  L->bqkv = w[1];
  L->wo = w[2];
  L->bo = w[3];
  L->wf1 = w[4];
  L->bf1 = w[5];
  L->wf2 = w[6];
  L->bf2 = w[7];
  L->g1 = static_cast<const float*>(ws[8]);
  L->be1 = static_cast<const float*>(ws[9]);
  L->g2 = static_cast<const float*>(ws[10]);
  L->be2 = static_cast<const float*>(ws[11]);
  for (int i = 0; i < n; ++i) {
    const int* q = plan + 4 * i;
    L->plan[i] = bg::Plan{q[0], q[1], q[2], q[3]};
    int mnk[3];
    product_dims(L->D, i, mnk);
    if (!bg::plan_ok(L->plan[i], mnk[0], mnk[1], mnk[2])) return false;
  }
  return true;
}

}  // namespace

// Floats of the weight and bias gradients' partial sums that
// encoder_layer_bwd_launch takes (its last scratch array) for N = B*T rows
extern "C" int encoder_layer_part_floats(int N, int d, int ff,
                                         long long* floats) {
  const Dims D{N, 1, d, ff, 1, 1};
  *floats = static_cast<long long>(part_floats(D));
  return 0;
}

// K11: the forward on train_mma.cuh's products; arrays: the addresses of
// the first kF32FwdArrays of f32_scratch_layout's arrays
extern "C" int encoder_layer_fwd_launch(const void* x, const void* const* ws,
                                        void* y, void* const* arrays, int B,
                                        int T, int d, int ff, int nh, int bt,
                                        int seed, float p_keep,
                                        float inv_keep, int use_drop,
                                        void* stream) {
  if (!dims_ok(B, T, d, ff, nh, bt) || !mma_dims_ok(d, ff, nh))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims D{B * T, T, d, ff, nh, bt * T};
  const hm::Drop drop{use_drop, seed, 0, bt * T, p_keep, inv_keep};
  return forward(static_cast<const float*>(x), weights_of(ws), D, drop,
                 static_cast<float*>(y), fwd_arrays(arrays),
                 static_cast<cudaStream_t>(stream));
}

// K11's bf16 variant: x, y and ws[0..7] bf16, ws[8..11] (LayerNorm) f32;
// arrays: the addresses of the first kFwdArrays of bf16_scratch_layout's
// arrays; plan: encoder_bf16_plan's ints
extern "C" int encoder_layer_fwd_bf16_launch(
    const void* x, const void* const* ws, void* y, void* const* arrays,
    const int* plan, int B, int T, int d, int ff, int nh, int bt, int seed,
    float p_keep, float inv_keep, int use_drop, void* stream) {
  Bf16Layer L;
  if (!bf16_setup(&L, x, ws, arrays, plan, kPFf2 + 1, B, T, d, ff, nh, bt,
                  seed, p_keep, inv_keep, use_drop))
    return static_cast<int>(cudaErrorInvalidValue);
  return forward_bf16(L, static_cast<bf16*>(y), false,
                      static_cast<cudaStream_t>(stream));
}

// grads: the 12 gradients in the order of the weights, f32; arrays: the
// addresses of all of f32_scratch_layout's arrays
extern "C" int encoder_layer_bwd_launch(const void* x, const void* dy_v,
                                        const void* const* ws, void* dx_v,
                                        void* const* grads,
                                        void* const* arrays,
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
  const Fwd f = fwd_arrays(arrays);
  const Bwd g = bwd_arrays(arrays);
  float* gr[12];
  for (int i = 0; i < 12; ++i) gr[i] = static_cast<float*>(grads[i]);
  const float* xf = static_cast<const float*>(x);
  const int err = forward(xf, w, D, drop, g.y, f, st);
  if (err) return err;
  return backward(xf, static_cast<const float*>(dy_v), w, D, drop,
                  static_cast<float*>(dx_v), gr, f, g, st);
}

// K12's bf16 variant: x, dy, dx, ws[0..7] and grads[0..7] bf16, ws[8..11]
// and grads[8..11] (LayerNorm) f32; arrays: the addresses of all of
// bf16_scratch_layout's arrays; plan: encoder_bf16_plan's ints
extern "C" int encoder_layer_bwd_bf16_launch(
    const void* x, const void* dy, const void* const* ws, void* dx,
    void* const* grads, void* const* arrays, const int* plan, int B, int T,
    int d, int ff, int nh, int bt, int seed, float p_keep, float inv_keep,
    int use_drop, void* stream) {
  Bf16Layer L;
  if (!bf16_setup(&L, x, ws, arrays, plan, kProducts, B, T, d, ff, nh, bt,
                  seed, p_keep, inv_keep, use_drop))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = forward_bf16(L, L.at<bf16>(kY), true, st);
  if (err) return err;
  return backward_bf16(L, static_cast<const bf16*>(dy),
                       static_cast<bf16*>(dx), grads, st);
}
