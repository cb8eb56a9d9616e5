// Device code shared by the whole-model kernels: K4/K5 (fused_forward.cu,
// the windowed forward of one stream), K7 (fused_cached.cu, the cached
// single-token step of one stream) and their pool forms K9
// (fused_recompute_batch.cu) and K8 (fused_cached_batch.cu) over B
// streams. Every function is a phase of one cooperative launch of kThreads
// threads a block: all blocks call it, a block takes the units
// blockIdx.x, blockIdx.x + gridDim.x, ..., and the caller closes the phase
// with grid.sync(). Activations written by other blocks in an earlier phase
// are read with ld.cg (L2), never through the non-coherent path; weights are
// read-only for the whole launch and go through __ldg.
//
// The packing dtype WT (float or __nv_bfloat16) is a template argument:
// weights widen to f32 on load, activations are rounded to WT before a
// product (round_cd) and every sum is f32, so products of two rounded
// values are exact and both types share one code path on the CUDA cores.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;          // rows of a product unit
constexpr int kActNone = 0, kActRelu = 1, kActTanh = 2;
constexpr int kMaxT = 64;
constexpr int kMaxLayers = 8;
constexpr int kMaxHeadDim = 64;
constexpr int kErrShape = -1;
constexpr int kErrSmem = -2;

struct Layer {
  const void *w_qkv, *b_qkv, *w_o, *b_o, *w_f1, *b_f1, *w_f2, *b_f2;
  const float *ln1_s, *ln1_b, *ln2_s, *ln2_b;
};

struct Weights {
  const void *w_in, *b_in;
  Layer layer[kMaxLayers];
  const void *w_ih, *b_r, *w_hh, *w_out, *b_out;
};

// the packed list of ops/fused_forward.py::pack_weights, 2 + 12 * layers +
// 5 device pointers, into the struct the kernels take by value
inline Weights unpack_weights(const void* const* weights, int layers) {
  Weights w;
  int i = 0;
  w.w_in = weights[i++];
  w.b_in = weights[i++];
  for (int l = 0; l < layers; ++l) {
    Layer& L = w.layer[l];
    L.w_qkv = weights[i++];
    L.b_qkv = weights[i++];
    L.w_o = weights[i++];
    L.b_o = weights[i++];
    L.w_f1 = weights[i++];
    L.b_f1 = weights[i++];
    L.w_f2 = weights[i++];
    L.b_f2 = weights[i++];
    L.ln1_s = static_cast<const float*>(weights[i++]);
    L.ln1_b = static_cast<const float*>(weights[i++]);
    L.ln2_s = static_cast<const float*>(weights[i++]);
    L.ln2_b = static_cast<const float*>(weights[i++]);
  }
  w.w_ih = weights[i++];
  w.b_r = weights[i++];
  w.w_hh = weights[i++];
  w.w_out = weights[i++];
  w.b_out = weights[i++];
  return w;
}

__device__ __forceinline__ float wload(const float* p) { return __ldg(p); }
__device__ __forceinline__ float wload(const __nv_bfloat16* p) {
  const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}
__device__ __forceinline__ float wvalue(float v) { return v; }
__device__ __forceinline__ float wvalue(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// an activation another block may have written in this launch: through L2
__device__ __forceinline__ float aload(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float aload(const __nv_bfloat16* p) {
  const unsigned short u = __ldcg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}

// round to the packing dtype (nearest even), keep as f32
template <typename WT>
__device__ __forceinline__ float round_cd(float v);
template <>
__device__ __forceinline__ float round_cd<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_cd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the model input's quirks: NaN -> 0, +-inf -> +-FLT_MAX, columns
// zero0..zero0+2 (the root-velocity history channels) -> 0
__device__ __forceinline__ float input_fix(float v, int k, int zero0) {
  if (isnan(v)) v = 0.0f;
  else if (isinf(v)) v = copysignf(FLT_MAX, v);
  if (k >= zero0 && k < zero0 + 3) v = 0.0f;
  return v;
}

// acc[r] += a[r] * w for the ROWS staged values of one k
template <int ROWS>
__device__ __forceinline__ void fma_rows(float (&acc)[ROWS], const float4* a4,
                                         float w) {
#pragma unroll
  for (int q = 0; q < ROWS / 4; ++q) {
    const float4 a = a4[q];
    acc[4 * q + 0] = fmaf(a.x, w, acc[4 * q + 0]);
    acc[4 * q + 1] = fmaf(a.y, w, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(a.z, w, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(a.w, w, acc[4 * q + 3]);
  }
}

// out (T, N) = act(round?(A (T, K)) W (K, N) + bias [+ res (T, N)]), act one
// of kActNone, kActRelu, kActTanh; bias may be null. zero0 >= 0 marks A as
// the raw model input (input_fix). A (f32 scratch, or a ring in the packing
// dtype), res and out may have been written by other blocks in the phase
// before: read with ld.cg. Row r of out starts at out + r * ldo (ldo = 0:
// N). A unit is ROWS rows (a multiple of 4) x kThreads columns; a row's
// sum runs over k in order whatever ROWS is, so the result does not depend
// on it. sm: ROWS * K floats.
template <typename WT, typename AT, int ROWS = kRows>
__device__ void product_phase(const AT* A, int lda, int T, int K,
                              const WT* __restrict__ W,
                              const WT* __restrict__ bias, int N,
                              const float* res, float* out, int act,
                              bool round_a, int zero0, float* sm,
                              int ldo = 0) {
  static_assert(ROWS % 4 == 0, "rows of a unit: a multiple of 4");
  if (ldo == 0) ldo = N;
  const int n_rg = (T + ROWS - 1) / ROWS;
  const int n_cc = (N + kThreads - 1) / kThreads;
  for (int unit = blockIdx.x; unit < n_rg * n_cc; unit += gridDim.x) {
    const int rg = unit % n_rg, cc = unit / n_rg;
    const int row0 = rg * ROWS;
    for (int idx = threadIdx.x; idx < ROWS * K; idx += kThreads) {
      const int r = idx / K, k = idx - r * K;
      const int row = row0 + r;
      float v = 0.0f;
      if (row < T) {
        v = aload(A + static_cast<size_t>(row) * lda + k);
        if (zero0 >= 0) v = input_fix(v, k, zero0);
        if (round_a) v = round_cd<WT>(v);
      }
      sm[k * ROWS + r] = v;
    }
    __syncthreads();
    const int n = cc * kThreads + threadIdx.x;
    if (n < N) {
      float acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;
      const float4* a4 = reinterpret_cast<const float4*>(sm);
      const WT* wp = W + n;
      if (ROWS == kRows) {
#pragma unroll 8
        for (int k = 0; k < K; ++k)
          fma_rows<ROWS>(acc, a4 + k * (ROWS / 4),
                         wload(wp + static_cast<size_t>(k) * N));
      } else {
        // a taller unit has few warps to hide a weight load behind: eight
        // loads are in flight before their sums, which stay in k's order
        for (int k0 = 0; k0 < K; k0 += 8) {
          float wv[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            wv[j] = k0 + j < K
                        ? wload(wp + static_cast<size_t>(k0 + j) * N)
                        : 0.0f;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (k0 + j < K)
              fma_rows<ROWS>(acc, a4 + (k0 + j) * (ROWS / 4), wv[j]);
        }
      }
      const float b = bias != nullptr ? wload(bias + n) : 0.0f;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int row = row0 + r;
        if (row < T) {
          float v = acc[r] + b;
          if (res != nullptr)
            v = __ldcg(res + static_cast<size_t>(row) * N + n) + v;
          if (act == kActRelu) v = fmaxf(v, 0.0f);
          if (act == kActTanh) v = tanhf(v);
          out[static_cast<size_t>(row) * ldo + n] = v;
        }
      }
    }
    __syncthreads();
  }
}

// att (T, d): per head, softmax(q k^T / sqrt(hd) + causal mask) v, with q,
// k, the softmax weights and v each rounded to the packing dtype before
// their product. Masked keys contribute an exact 0, so they are skipped.
// n_streams windows of T rows each lie one after the other in qkv and att;
// attention never crosses from one to the next.
template <typename WT>
__device__ void attention_phase(const float* qkv, int T, int d, int heads,
                                float* att, float* sm, int n_streams = 1) {
  const int hd = d / heads;
  const int hs = hd | 1;          // odd row stride: no bank conflicts
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qs = sm;                 // [kWarps][hs]
  float* ks = qs + kWarps * hs;   // [T][hs]
  float* vs = ks + T * hs;        // [T][hs]
  float* ps = vs + T * hs;        // [kWarps][kMaxT]
  const int n_rb = (T + kWarps - 1) / kWarps;
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  const float* qkv0 = qkv;
  float* att0 = att;
  for (int unit = blockIdx.x; unit < n_streams * heads * n_rb;
       unit += gridDim.x) {
    const int st = unit / (heads * n_rb), u = unit - st * heads * n_rb;
    qkv = qkv0 + static_cast<size_t>(st) * T * 3 * d;
    att = att0 + static_cast<size_t>(st) * T * d;
    const int hh = u / n_rb, rb = u - hh * n_rb;
    const int i0 = rb * kWarps;
    const int n_keys = min(T, i0 + kWarps);
    for (int idx = threadIdx.x; idx < n_keys * hd; idx += kThreads) {
      const int j = idx / hd, c = idx - j * hd;
      const float* src = qkv + static_cast<size_t>(j) * 3 * d + hh * hd + c;
      ks[j * hs + c] = round_cd<WT>(__ldcg(src + d));
      vs[j * hs + c] = round_cd<WT>(__ldcg(src + 2 * d));
      if (j >= i0) qs[(j - i0) * hs + c] = round_cd<WT>(__ldcg(src));
    }
    __syncthreads();
    const int i = i0 + warp;
    if (i < T) {
      float* p = ps + warp * kMaxT;
      const float* q = qs + warp * hs;
      float mx = -INFINITY;
      for (int j = lane; j <= i; j += 32) {
        float s = 0.0f;
        for (int c = 0; c < hd; ++c) s = fmaf(q[c], ks[j * hs + c], s);
        s *= scale;
        p[j] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      float sum = 0.0f;
      for (int j = lane; j <= i; j += 32) {
        const float e = expf(p[j] - mx);
        p[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int j = lane; j <= i; j += 32) p[j] = round_cd<WT>(p[j] / sum);
      __syncwarp();
      for (int c = lane; c < hd; c += 32) {
        float o = 0.0f;
        for (int j = 0; j <= i; ++j) o = fmaf(p[j], vs[j * hs + c], o);
        att[static_cast<size_t>(i) * d + hh * hd + c] = o;
      }
    }
    __syncthreads();
  }
}

// x = LayerNorm(a) * s + b per row, f32, biased variance, eps 1e-5
__device__ inline void layernorm_phase(const float* a, int T, int d,
                                       const float* __restrict__ s,
                                       const float* __restrict__ b,
                                       float* x) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int row = blockIdx.x * kWarps + warp; row < T;
       row += gridDim.x * kWarps) {
    const float* ar = a + static_cast<size_t>(row) * d;
    float sum = 0.0f;
    for (int c = lane; c < d; c += 32) sum += __ldcg(ar + c);
    const float mu = warp_sum(sum) / static_cast<float>(d);
    float sq = 0.0f;
    for (int c = lane; c < d; c += 32) {
      const float dv = __ldcg(ar + c) - mu;
      sq = fmaf(dv, dv, sq);
    }
    const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(d) + 1e-5f);
    for (int c = lane; c < d; c += 32)
      x[static_cast<size_t>(row) * d + c] =
          (__ldcg(ar + c) - mu) * rstd * __ldg(s + c) + __ldg(b + c);
  }
}

// hs[t] = tanh(xin[row(t)] + round(hs[t-1]) W_hh), hs[-1] = 0, t < T, with
// row(t) = t, or rows[t] when rows is given (a walk over a ring: the same
// list in every block, in shared memory). Block b owns columns b*cpb ..
// b*cpb+cpb-1 of W_hh, resident in shared memory. Every block reaches every
// grid.sync().
template <typename WT>
__device__ void rnn_phase(cg::grid_group& grid, const float* xin,
                          const WT* __restrict__ w_hh, int T, int H, int cpb,
                          float* hs, unsigned char* sm,
                          const int* rows = nullptr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * cpb;
  const int ncols = max(0, min(cpb, H - c0));
  WT* wsl = reinterpret_cast<WT*>(sm);                    // [cpb][H]
  const size_t w_bytes =
      (static_cast<size_t>(cpb) * H * sizeof(WT) + 15) / 16 * 16;
  float* hsm = reinterpret_cast<float*>(sm + w_bytes);    // [H]
  for (int idx = threadIdx.x; idx < ncols * H; idx += kThreads) {
    const int k = idx / ncols, c = idx - k * ncols;
    wsl[c * H + k] = w_hh[static_cast<size_t>(k) * H + c0 + c];
  }
  for (int t = 0; t < T; ++t) {
    if (ncols > 0) {
      if (t > 0)
        for (int k = threadIdx.x; k < H; k += kThreads)
          hsm[k] = round_cd<WT>(
              __ldcg(hs + static_cast<size_t>(t - 1) * H + k));
      __syncthreads();
      const int row = rows != nullptr ? rows[t] : t;
      for (int c = warp; c < ncols; c += kWarps) {
        const size_t at = static_cast<size_t>(t) * H + c0 + c;
        const float xv =
            lane == 0 ? __ldcg(xin + static_cast<size_t>(row) * H + c0 + c)
                      : 0.0f;
        float s = 0.0f;
        if (t > 0) {
          const WT* wc = wsl + c * H;
          for (int k = lane; k < H; k += 32)
            s = fmaf(hsm[k], wvalue(wc[k]), s);
        }
        s = warp_sum(s);
        if (lane == 0) hs[at] = tanhf(xv + s);
      }
    }
    grid.sync();
  }
}

template <typename WT>
__device__ __forceinline__ WT to_ring(float v);
template <>
__device__ __forceinline__ float to_ring<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_ring<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One head of the newest token's attention over a ring, by one warp:
// out[c] = round(sum_w round(softmax_w(q . k_w / sqrt(hd) + mask_w)) v_w[c])
// for c < hd. q, k_own, v_own: the token's own hd values of this head
// (rounded here as the ring stores them). kr, vr: row 0 of the ring at this
// head's columns, rows ld apart. Slot `slot` is the token itself when `own`:
// its k and v come from k_own, v_own, not from the ring, so the ring row
// may be written while this runs. A slot that is not valid gets the
// additive -1e30, and with `evict` so does `slot` when it is not the
// token's: its weight is an exact 0 unless no slot counts at all (uniform
// weights over whatever the ring holds, as the plain versions). pw: kMaxT
// floats of this warp.
template <typename WT>
__device__ void attend_head(const float* q, const float* k_own,
                            const float* v_own, const WT* kr, const WT* vr,
                            int ld, const unsigned char* valid, int W, int hd,
                            int slot, bool own, bool evict, float* pw,
                            float* out) {
  const int lane = threadIdx.x & 31;
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  float mx = -INFINITY;
  for (int w = lane; w < W; w += 32) {
    const bool own_w = own && w == slot;
    float s = 0.0f;
    if (own_w) {
      for (int c = 0; c < hd; ++c)
        s = fmaf(round_cd<WT>(q[c]), round_cd<WT>(k_own[c]), s);
    } else {
      const WT* kw = kr + static_cast<size_t>(w) * ld;
      for (int c = 0; c < hd; ++c)
        s = fmaf(round_cd<WT>(q[c]), wvalue(kw[c]), s);
    }
    const bool counts = own_w || (valid[w] && !(evict && w == slot));
    s = s * scale + (counts ? 0.0f : -1e30f);
    pw[w] = s;
    mx = fmaxf(mx, s);
  }
  mx = warp_max(mx);
  float sum = 0.0f;
  for (int w = lane; w < W; w += 32) {
    const float e = expf(pw[w] - mx);
    pw[w] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  for (int w = lane; w < W; w += 32) pw[w] = round_cd<WT>(pw[w] / sum);
  __syncwarp();
  for (int c = lane; c < hd; c += 32) {
    float o = 0.0f;
    for (int w = 0; w < W; ++w) {
      const float v = (own && w == slot)
                          ? round_cd<WT>(v_own[c])
                          : wvalue(vr[static_cast<size_t>(w) * ld + c]);
      o = fmaf(pw[w], v, o);
    }
    out[c] = round_cd<WT>(o);
  }
  __syncwarp();
}

// the launchers' common end: raise the kernel's dynamic shared memory
// limit, check that one block fits an SM, launch one block per SM
// cooperatively
template <typename Kernel>
int launch_cooperative(Kernel kernel, int grid, size_t smem, void** args,
                       cudaStream_t stream) {
  int per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return kErrSmem;
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(grid), dim3(kThreads), args, smem,
                                    stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
