// K4 fused_forward_last and K5 fused_forward: the whole windowed model of
// one stream in one cooperative launch.
//
// Replaces tip_tpu/ops/fused_forward.py::fused_forward_last (Pallas kernel
// _kernel_last) and tip_tpu/ops/fused_forward.py::fused_forward (Pallas
// kernel _kernel): in-projection (head-interleave permutation folded into
// the packed weight), L post-norm encoder layers (packed QKV, causal
// attention per head, out-projection, LayerNorm, ReLU feed-forward,
// LayerNorm), the tanh RNN over the window and the out-projection, at one
// window index (K4) or at every index (K5).
//
// What bounds it on the H100: at the serving shape (T = 40, d 256, ff 1024,
// 4 layers, H 512) the packed weights are 3.66 M values (7.3 MB in bf16,
// 14.6 MB in f32) read once, and the work is about 0.3 GFLOP, so a few
// microseconds by either measure. What the kernel pays instead is latency:
// a chain of 33 dependent phases before the RNN and T dependent RNN steps,
// each closed by a grid-wide barrier.
//
// Design: one cooperative launch of one block per SM, 256 threads each,
// with grid.sync() between phases; activations (at most T x ff floats) live
// in a global scratch buffer that stays in L2 and is read with ld.cg, never
// through the non-coherent path. A product phase is split into units of
// (4 rows) x (256 output columns): the block stages its rows in shared
// memory, rounding them to the packing dtype once, and each thread owns one
// column, reading the weight row-major so a warp's loads coalesce; every
// sum is sequential in f32 with fmaf. Attention is split into (head, 8
// rows) units with that head's q, k and v staged (and rounded) in shared
// memory, one warp per query row. LayerNorm takes one warp per row. For the
// RNN each block keeps its slice of W_hh's columns resident in shared
// memory for all T steps; a step reads the previous hidden (rounded) from
// the scratch, one warp per column, and ends in a grid barrier. K4 runs
// rows 0..k_last only: later rows cannot reach that output (causal
// attention, a forward RNN).
//
// The packing dtype (f32 or bf16) is a template argument: weights widen to
// f32 on load, products of two rounded values are exact in f32, so both
// types share one code path on the CUDA cores. Tensor cores are later work.

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

struct Dims {
  int T;        // rows to compute
  int Din, d, heads, ff, layers, H, S;
  int zero0;    // first of the three zeroed input columns
  int k_last;   // >= 0: emit that row only; -1: every row
  int cpb;      // W_hh columns per block in the RNN phase
  int rnn_off;  // byte offset of the RNN's shared-memory region
};

struct Scratch {
  float *x, *qkv, *att, *a, *f, *xin, *hs;
};

__device__ __forceinline__ float wload(const float* p) { return __ldg(p); }
__device__ __forceinline__ float wload(const __nv_bfloat16* p) {
  const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}
__device__ __forceinline__ float wvalue(float v) { return v; }
__device__ __forceinline__ float wvalue(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

// out (T, N) = [relu](round?(A (T, K)) W (K, N) + bias [+ res (T, N)]).
// zero0 >= 0 marks A as the raw model input: NaN -> 0, +-inf -> +-FLT_MAX,
// columns zero0..zero0+2 -> 0. A, res and out may be scratch written by
// other blocks in the phase before: read with ld.cg.
template <typename WT>
__device__ void product_phase(const float* A, int lda, int T, int K,
                              const WT* __restrict__ W,
                              const WT* __restrict__ bias, int N,
                              const float* res, float* out, bool relu,
                              bool round_a, int zero0, float* sm) {
  const int n_rg = (T + kRows - 1) / kRows;
  const int n_cc = (N + kThreads - 1) / kThreads;
  for (int unit = blockIdx.x; unit < n_rg * n_cc; unit += gridDim.x) {
    const int rg = unit % n_rg, cc = unit / n_rg;
    const int row0 = rg * kRows;
    for (int idx = threadIdx.x; idx < kRows * K; idx += kThreads) {
      const int r = idx / K, k = idx - r * K;
      const int row = row0 + r;
      float v = 0.0f;
      if (row < T) {
        v = __ldcg(A + static_cast<size_t>(row) * lda + k);
        if (zero0 >= 0) {
          if (isnan(v)) v = 0.0f;
          else if (isinf(v)) v = copysignf(FLT_MAX, v);
          if (k >= zero0 && k < zero0 + 3) v = 0.0f;
        }
        if (round_a) v = round_cd<WT>(v);
      }
      sm[k * kRows + r] = v;
    }
    __syncthreads();
    const int n = cc * kThreads + threadIdx.x;
    if (n < N) {
      float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc3 = 0.0f;
      const float4* a4 = reinterpret_cast<const float4*>(sm);
      const WT* wp = W + n;
#pragma unroll 8
      for (int k = 0; k < K; ++k) {
        const float w = wload(wp + static_cast<size_t>(k) * N);
        const float4 a = a4[k];
        acc0 = fmaf(a.x, w, acc0);
        acc1 = fmaf(a.y, w, acc1);
        acc2 = fmaf(a.z, w, acc2);
        acc3 = fmaf(a.w, w, acc3);
      }
      const float b = wload(bias + n);
      const float acc[kRows] = {acc0, acc1, acc2, acc3};
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int row = row0 + r;
        if (row < T) {
          const size_t at = static_cast<size_t>(row) * N + n;
          float v = acc[r] + b;
          if (res != nullptr) v = __ldcg(res + at) + v;
          if (relu) v = fmaxf(v, 0.0f);
          out[at] = v;
        }
      }
    }
    __syncthreads();
  }
}

// att (T, d): per head, softmax(q k^T / sqrt(hd) + causal mask) v, with q,
// k, the softmax weights and v each rounded to the packing dtype before
// their product. Masked keys contribute an exact 0, so they are skipped.
template <typename WT>
__device__ void attention_phase(const float* qkv, int T, int d, int heads,
                                float* att, float* sm) {
  const int hd = d / heads;
  const int hs = hd | 1;          // odd row stride: no bank conflicts
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qs = sm;                 // [kWarps][hs]
  float* ks = qs + kWarps * hs;   // [T][hs]
  float* vs = ks + T * hs;        // [T][hs]
  float* ps = vs + T * hs;        // [kWarps][kMaxT]
  const int n_rb = (T + kWarps - 1) / kWarps;
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  for (int unit = blockIdx.x; unit < heads * n_rb; unit += gridDim.x) {
    const int hh = unit / n_rb, rb = unit - hh * n_rb;
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
__device__ void layernorm_phase(const float* a, int T, int d,
                                const float* __restrict__ s,
                                const float* __restrict__ b, float* x) {
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

// hs[t] = tanh(xin[t] + round(hs[t-1]) W_hh), hs[-1] = 0, t < T. Block b
// owns columns b*cpb .. b*cpb+cpb-1 of W_hh, resident in shared memory.
// Every block reaches every grid.sync().
template <typename WT>
__device__ void rnn_phase(cg::grid_group& grid, const float* xin,
                          const WT* __restrict__ w_hh, int T, int H, int cpb,
                          float* hs, unsigned char* sm) {
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
      for (int c = warp; c < ncols; c += kWarps) {
        const size_t at = static_cast<size_t>(t) * H + c0 + c;
        const float xv = lane == 0 ? __ldcg(xin + at) : 0.0f;
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
__global__ void __launch_bounds__(kThreads)
fused_forward_kernel(const float* __restrict__ x, Weights w, Dims p,
                     Scratch s, float* __restrict__ out) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char sm_raw[];
  float* sm = reinterpret_cast<float*>(sm_raw);
  const int T = p.T, d = p.d;
  auto W = [](const void* q) { return static_cast<const WT*>(q); };

  product_phase<WT>(x, p.Din, T, p.Din, W(w.w_in), W(w.b_in), d, nullptr, s.x,
                    false, false, p.zero0, sm);
  grid.sync();
  for (int l = 0; l < p.layers; ++l) {
    const Layer& L = w.layer[l];
    product_phase<WT>(s.x, d, T, d, W(L.w_qkv), W(L.b_qkv), 3 * d, nullptr,
                      s.qkv, false, true, -1, sm);
    grid.sync();
    attention_phase<WT>(s.qkv, T, d, p.heads, s.att, sm);
    grid.sync();
    product_phase<WT>(s.att, d, T, d, W(L.w_o), W(L.b_o), d, s.x, s.a, false,
                      true, -1, sm);
    grid.sync();
    layernorm_phase(s.a, T, d, L.ln1_s, L.ln1_b, s.x);
    grid.sync();
    product_phase<WT>(s.x, d, T, d, W(L.w_f1), W(L.b_f1), p.ff, nullptr, s.f,
                      true, true, -1, sm);
    grid.sync();
    product_phase<WT>(s.f, p.ff, T, p.ff, W(L.w_f2), W(L.b_f2), d, s.x, s.a,
                      false, true, -1, sm);
    grid.sync();
    layernorm_phase(s.a, T, d, L.ln2_s, L.ln2_b, s.x);
    grid.sync();
  }
  product_phase<WT>(s.x, d, T, d, W(w.w_ih), W(w.b_r), p.H, nullptr, s.xin,
                    false, true, -1, sm);
  grid.sync();
  rnn_phase<WT>(grid, s.xin, W(w.w_hh), T, p.H, p.cpb, s.hs,
                sm_raw + p.rnn_off);
  if (p.k_last >= 0)
    product_phase<WT>(s.hs + static_cast<size_t>(p.k_last) * p.H, p.H, 1, p.H,
                      W(w.w_out), W(w.b_out), p.S, nullptr, out, false, true,
                      -1, sm);
  else
    product_phase<WT>(s.hs, p.H, T, p.H, W(w.w_out), W(w.b_out), p.S, nullptr,
                      out, false, true, -1, sm);
}

template <typename WT>
int launch(const float* x, const Weights& w, Dims p, const Scratch& s,
           float* out, cudaStream_t stream) {
  int dev = 0, sms = 0, smem_max = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const int grid = sms;           // one block per SM, all co-resident
  p.cpb = (p.H + grid - 1) / grid;
  // shared memory: the phases' staging region, then the RNN's region
  int k_max = p.Din;
  if (p.d > k_max) k_max = p.d;
  if (p.ff > k_max) k_max = p.ff;
  if (p.H > k_max) k_max = p.H;
  const int hs = (p.d / p.heads) | 1;
  size_t stage = static_cast<size_t>(kRows) * k_max;
  const size_t attn =
      static_cast<size_t>(kWarps) * hs + 2 * p.T * hs + kWarps * kMaxT;
  if (attn > stage) stage = attn;
  const size_t stage_bytes = (stage * sizeof(float) + 15) / 16 * 16;
  const size_t rnn_bytes =
      (static_cast<size_t>(p.cpb) * p.H * sizeof(WT) + 15) / 16 * 16 +
      static_cast<size_t>(p.H) * sizeof(float);
  const size_t smem = stage_bytes + rnn_bytes;
  if (smem > static_cast<size_t>(smem_max)) return kErrSmem;
  p.rnn_off = static_cast<int>(stage_bytes);
  err = cudaFuncSetAttribute(fused_forward_kernel<WT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_forward_kernel<WT>, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return kErrSmem;
  Weights w_arg = w;
  Scratch s_arg = s;
  void* args[] = {&x, &w_arg, &p, &s_arg, &out};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(fused_forward_kernel<WT>), dim3(grid),
      dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// weights: the packed list of ops/fused_forward.py::pack_weights, n_w =
// 2 + 12 * layers + 5 device pointers. scratch: T * (6 d + ff + 2 H)
// floats. k_last >= 0 writes out (S,) for that row and computes rows
// 0..k_last only; k_last == -1 writes out (T, S). Returns a CUDA error
// code, or -1 for a shape outside the kernel's limits, -2 when the widths
// need more shared memory than a block has.
extern "C" int fused_forward_launch(const void* x, const void* const* weights,
                                    int n_w, int is_bf16, int T, int Din,
                                    int d, int heads, int ff, int layers,
                                    int H, int S, int zero0, int k_last,
                                    void* scratch, void* out, void* stream) {
  if (T < 1 || T > kMaxT || layers < 1 || layers > kMaxLayers ||
      n_w != 2 + 12 * layers + 5 || heads < 1 || d < 1 || d % heads != 0 ||
      d / heads > kMaxHeadDim || Din < 1 || ff < 1 || H < 1 || S < 1 ||
      k_last < -1 || k_last >= T)
    return kErrShape;
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

  // the scratch is laid out for the caller's T rows
  float* base = static_cast<float*>(scratch);
  Scratch s;
  s.x = base;
  s.qkv = s.x + static_cast<size_t>(T) * d;
  s.att = s.qkv + static_cast<size_t>(T) * 3 * d;
  s.a = s.att + static_cast<size_t>(T) * d;
  s.f = s.a + static_cast<size_t>(T) * d;
  s.xin = s.f + static_cast<size_t>(T) * ff;
  s.hs = s.xin + static_cast<size_t>(T) * H;

  Dims p;
  p.T = k_last >= 0 ? k_last + 1 : T;
  p.Din = Din;
  p.d = d;
  p.heads = heads;
  p.ff = ff;
  p.layers = layers;
  p.H = H;
  p.S = S;
  p.zero0 = zero0;
  p.k_last = k_last;
  p.cpb = 0;
  p.rnn_off = 0;
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(xf, w, p, s, of, st);
  return launch<float>(xf, w, p, s, of, st);
}
