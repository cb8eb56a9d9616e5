// Device code shared by the whole-model kernels: K4/K5 (fused_forward.cu,
// the windowed forward of one stream), K7 (fused_cached.cu, the cached
// single-token step of one stream) and their pool forms K9
// (fused_recompute_batch.cu) and K8 (fused_cached_batch.cu) over B streams,
// which add pool_phases.cuh. Every function is a phase, or a block's part
// of one, of a cooperative launch of kThreads threads a block, one block an
// SM; the caller closes a phase with grid.sync() (the RNN walk needs none).
// Activations written by other blocks in an earlier phase are read through
// L2 (ld.cg), never through the non-coherent path; weights are read-only
// for the whole launch.
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
constexpr int kActNone = 0, kActRelu = 1, kActTanh = 2;
// kMaxT: the rows of a warp's score buffer when a window or ring holds at
// most that many (the default shapes); past it a buffer takes the rows the
// launch has, in dynamic shared memory (score_rows). kMaxHeadDim: the head
// width that the attention of K8 and K9 holds in a lane's registers (two
// channels a lane); wider heads take their own, looped instantiation.
constexpr int kMaxT = 64;
constexpr int kMaxLayers = 8;
constexpr int kMaxHeadDim = 64;

// the floats of a warp's score row for n keys: kMaxT up to kMaxT keys (the
// layout of the narrow shapes), else n rounded up to 4
__host__ __device__ constexpr int score_rows(int n) {
  return n <= kMaxT ? kMaxT : (n + 3) / 4 * 4;
}
constexpr int kErrShape = -1;
constexpr int kErrSmem = -2;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The per-phase clock (optional: a null clk costs nothing). Row r of clk,
// four u64, describes the barrier that closes phase r: block 0's
// %globaltimer just after it, the first and the last block's arrival at it
// (atomicMin / atomicMax; the caller fills column 1 with a large value),
// and the phase's kind (the kernel's own numbering; 0 the start). Row 0 is
// the launch's start. A phase that runs its own barriers (an RNN walk)
// records no arrival. Rows past `cap` are not written.
struct PhaseClock {
  unsigned long long* clk;
  int cap;
  int row;

  __device__ void start() {
    row = 1;
    if (clk != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
      clk[0] = global_ns();
      clk[3] = 0;
    }
  }
  // every block, after its share of the phase
  __device__ void arrive() {
    if (clk == nullptr) return;
    __syncthreads();
    if (threadIdx.x == 0 && row < cap) {
      const unsigned long long t = global_ns();
      atomicMin(clk + 4 * row + 1, t);
      atomicMax(clk + 4 * row + 2, t);
    }
  }
  // every block, after the barrier
  __device__ void closed(int kind) {
    if (clk != nullptr && blockIdx.x == 0 && threadIdx.x == 0 && row < cap) {
      clk[4 * row] = global_ns();
      clk[4 * row + 3] = static_cast<unsigned long long>(kind);
    }
    ++row;
  }
  __device__ void sync(cg::grid_group& grid, int kind) {
    arrive();
    grid.sync();
    closed(kind);
  }
};

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

// att (T, d): per head, softmax(q k^T / sqrt(hd) + causal mask) v, with q,
// k, the softmax weights and v each rounded to the packing dtype before
// their product. Masked keys contribute an exact 0, so they are skipped.
// n_streams windows of T rows each lie one after the other in qkv and att;
// attention never crosses from one to the next.
// kLong: windows of more than kMaxT rows, each warp's score row
// score_rows(T) floats (a separate instantiation; kMaxT otherwise).
template <typename WT, bool kLong = false>
__device__ void attention_phase(const float* qkv, int T, int d, int heads,
                                float* att, float* sm, int n_streams = 1) {
  const int hd = d / heads;
  const int hs = hd | 1;          // odd row stride: no bank conflicts
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qs = sm;                 // [kWarps][hs]
  float* ks = qs + kWarps * hs;   // [T][hs]
  float* vs = ks + T * hs;        // [T][hs]
  float* ps = vs + T * hs;        // [kWarps][pst]
  const int pst = kLong ? score_rows(T) : kMaxT;
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
      float* p = ps + warp * pst;
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

template <typename WT>
__device__ __forceinline__ WT to_ring(float v);
template <>
__device__ __forceinline__ float to_ring<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_ring<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}


// ---------------------------------------------------------------------------
// K4/K5 and K7: products over a tile of rows x columns and the whole depth
// ---------------------------------------------------------------------------

// K4/K5's products (T rows) and K7's replay product (the ring rows) give
// each block at most one tile, a group of rows x a few columns over the
// whole depth K, so that no sum crosses blocks: the rows in up to
// kRowGroups groups, each group's columns in up to kColTiles tiles. Every
// block that takes a tile reads its rows of the input whole, so an
// activation line has at most kColTiles readers (when every SM read the
// same lines, loading them took 2-7 us a phase), and a weight column is
// read by kRowGroups blocks (with 8 groups the weights' traffic held up the
// next phase's loads; an H100 80GB HBM3 at 700 W).
constexpr int kRowGroups = 4;
constexpr int kColTiles = 32;

struct Cut {
  int n_rg, rg;   // groups of rg rows
  int n_ct, nc;   // tiles of nc columns in each group
};

// A block's slice of a (K, N) weight in WT: columns n0 .. n0 + nc - 1,
// every row. nc 0: the block has none.
struct Slice {
  const void* w;
  int K, N, n0, nc;
};

__host__ __device__ inline Slice no_slice() {
  return Slice{nullptr, 0, 1, 0, 0};
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four consecutive weights as f32, from f32 or bf16 in shared memory
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// Where a product's rows come from: a (rows lda apart) in f32 (the scratch,
// or the raw model input when zero0 >= 0: input_fix) or in WT (a ring);
// rounded to WT before the product when `round`; LayerNorm (s, b) applied on
// the way in when ln_s is given, the normalised rows then written unrounded
// to x_out (when given) by the block that takes the group's first tile.
struct Rows {
  const void* a;
  int lda;
  bool ring;
  int zero0;
  bool round;
  const float* ln_s;
  const float* ln_b;
  float* x_out;
};

__host__ __device__ inline Rows rows_of(const void* a, int lda, bool round) {
  return Rows{a, lda, false, -1, round, nullptr, nullptr, nullptr};
}

__host__ __device__ inline int stage_ld(int K) { return (K + 3) / 4 * 4 + 4; }

// rows row0..row0+nr-1 of src into As [nr][lds]: the loads issued eight a
// thread before their stores (a phase waits on one round trip to L2, not on
// one per value), then LayerNorm (a warp a row; layernorm's arithmetic: the
// mean, then the mean square of the deviations, eps 1e-5) and the rounding
constexpr int kLnRegs4 = 8;       // LayerNorm values a lane keeps: d <= 256

template <typename WT>
__device__ void stage_rows(const Rows& src, int row0, int nr, int K,
                           float* As, int lds, bool write_x) {
  constexpr int U = 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // rows that are not normalised are rounded as they are stored
  const bool round_now = src.round && src.ln_s == nullptr;
  // LayerNorm's scales and biases, loaded before the rows so that their
  // latency hides behind the rows'
  const bool ln = src.ln_s != nullptr && K <= 32 * kLnRegs4;
  float ls[kLnRegs4], lb[kLnRegs4];
#pragma unroll
  for (int i = 0; i < kLnRegs4; ++i) {
    const int c = lane + 32 * i;
    ls[i] = ln && c < K ? __ldg(src.ln_s + c) : 0.0f;
    lb[i] = ln && c < K ? __ldg(src.ln_b + c) : 0.0f;
  }
  const bool vec = !src.ring && src.zero0 < 0 && K % 4 == 0 &&
                   src.lda % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(src.a) & 15) == 0;
  if (vec) {
    const int q4 = K / 4, n = nr * q4;
    const float4* a4 = static_cast<const float4*>(src.a);
    for (int e0 = threadIdx.x; e0 < n; e0 += kThreads * U) {
      float4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * kThreads;
        if (e < n) {
          const int r = e / q4, q = e - r * q4;
          v[u] = __ldcg(a4 + (static_cast<size_t>(row0 + r) * src.lda) / 4 +
                        q);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * kThreads;
        if (e < n) {
          const int r = e / q4, q = e - r * q4;
          float4 a = v[u];
          if (round_now) {
            a.x = round_cd<WT>(a.x);
            a.y = round_cd<WT>(a.y);
            a.z = round_cd<WT>(a.z);
            a.w = round_cd<WT>(a.w);
          }
          *reinterpret_cast<float4*>(As + r * lds + 4 * q) = a;
        }
      }
    }
  } else {
    const int n = nr * K;
    for (int e0 = threadIdx.x; e0 < n; e0 += kThreads * U) {
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * kThreads;
        if (e < n) {
          const int r = e / K, k = e - r * K;
          const size_t at = static_cast<size_t>(row0 + r) * src.lda + k;
          v[u] = src.ring ? aload(static_cast<const WT*>(src.a) + at)
                          : __ldcg(static_cast<const float*>(src.a) + at);
          if (src.zero0 >= 0) v[u] = input_fix(v[u], k, src.zero0);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * kThreads;
        if (e < n) {
          const int r = e / K;
          As[r * lds + (e - r * K)] = round_now ? round_cd<WT>(v[u]) : v[u];
        }
      }
    }
  }
  __syncthreads();
  if (src.ln_s != nullptr) {
    for (int r = warp; r < nr; r += kWarps) {
      float* ar = As + r * lds;
      float sum = 0.0f;
      for (int c = lane; c < K; c += 32) sum += ar[c];
      const float mu = warp_sum(sum) / static_cast<float>(K);
      float sq = 0.0f;
      for (int c = lane; c < K; c += 32) {
        const float dv = ar[c] - mu;
        sq = fmaf(dv, dv, sq);
      }
      const float rstd =
          rsqrtf(warp_sum(sq) / static_cast<float>(K) + 1e-5f);
      for (int i = 0, c = lane; c < K; ++i, c += 32) {
        const float s = ln && i < kLnRegs4 ? ls[i] : __ldg(src.ln_s + c);
        const float b = ln && i < kLnRegs4 ? lb[i] : __ldg(src.ln_b + c);
        const float x = (ar[c] - mu) * rstd * s + b;
        if (write_x && src.x_out != nullptr)
          src.x_out[static_cast<size_t>(row0 + r) * K + c] = x;
        ar[c] = src.round ? round_cd<WT>(x) : x;
      }
    }
    __syncthreads();
  }
}

// the epilogue of one output: + bias (WT, may be null), + res, act
template <typename WT>
__device__ __forceinline__ float finish(float v, const WT* bias, int n,
                                        const float* res, size_t at,
                                        int act) {
  v = v + (bias != nullptr ? wload(bias + n) : 0.0f);
  if (res != nullptr) v = __ldcg(res + at) + v;
  if (act == kActRelu) v = fmaxf(v, 0.0f);
  if (act == kActTanh) v = tanhf(v);
  return v;
}

// out[row0 + r][n0 + c] = act(As[r] W[:, c] + bias [+ res]) for r < nr,
// c < ncols: As [nr][lds] staged, W's slice in wc [K][ldw] (f32 or WT, ldw
// a multiple of 4). A lane takes a row x 4 columns, a warp an eighth of the
// depth; the warps' partial sums (red: kWarps nr ldw floats) are added in
// warp order, so an output's bits do not depend on nr, the cut or the grid.
template <typename WT, typename ST>
__device__ void rows_product(const float* As, int lds, int nr, int K,
                             const ST* wc, int ldw, int ncols, int row0,
                             int n0, const WT* bias, int N, const float* res,
                             float* out, int ldo, int act, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kw = ((K + kWarps - 1) / kWarps + 3) / 4 * 4;
  const int k0 = warp * kw, k1 = min(K, k0 + kw);
  const int nq = ldw / 4, n_ob = nr * nq;
  // the epilogue's bias and residual, loaded before the sums
  constexpr int kPre = 4;
  float bp[kPre], rp[kPre];
#pragma unroll
  for (int i = 0; i < kPre; ++i) {
    const int e = threadIdx.x + i * kThreads;
    bp[i] = rp[i] = 0.0f;
    if (e < nr * ncols) {
      const int r = e / ncols, n = n0 + (e - r * ncols);
      if (bias != nullptr) bp[i] = wload(bias + n);
      if (res != nullptr)
        rp[i] = __ldcg(res + static_cast<size_t>(row0 + r) * N + n);
    }
  }
  for (int ob = lane; ob < n_ob; ob += 32) {
    const int r = ob / nq, q = ob - r * nq;
    const float* ar = As + r * lds;
    const ST* wq = wc + 4 * q;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      const float av = ar[k];
      const float4 w4 = load4(wq + k * ldw);
      a0 = fmaf(av, w4.x, a0);
      a1 = fmaf(av, w4.y, a1);
      a2 = fmaf(av, w4.z, a2);
      a3 = fmaf(av, w4.w, a3);
    }
    *reinterpret_cast<float4*>(red + (warp * nr + r) * ldw + 4 * q) =
        make_float4(a0, a1, a2, a3);
  }
  __syncthreads();
  for (int i = 0, e = threadIdx.x; e < nr * ncols; ++i, e += kThreads) {
    const int r = e / ncols, c = e - r * ncols;
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[(w * nr + r) * ldw + c];
    const int row = row0 + r, n = n0 + c;
    const size_t at = static_cast<size_t>(row) * N + n;
    if (i < kPre) {
      v = v + bp[i];
      if (res != nullptr) v = rp[i] + v;
      if (act == kActRelu) v = fmaxf(v, 0.0f);
      if (act == kActTanh) v = tanhf(v);
    } else {
      v = finish<WT>(v, bias, n, res, at, act);
    }
    out[static_cast<size_t>(row) * ldo + n] = v;
  }
  __syncthreads();
}

// The sums v W[:, c] for one row v (shared, K values) and the columns c <
// ncols of W's slice wc [K][ldw] (f32 or WT): a warp an eighth of the
// depth; in a pass of up to 32 columns, L lanes over the columns (L a power
// of two) and 32 / L over the depth, added by a butterfly; the warps' sums
// (red: kWarps ncols floats) added in warp order. Returns with sums[c]
// (shared) set for every thread.
template <typename ST>
__device__ void vec_sums(const float* v, int K, const ST* wc, int ldw,
                         int ncols, float* red, float* sums) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kp = (K + kWarps - 1) / kWarps;
  const int k0 = warp * kp, k1 = min(K, k0 + kp);
  for (int cb = 0; cb < ncols; cb += 32) {
    const int nb = min(32, ncols - cb);
    int L = 1;
    while (L < nb) L <<= 1;
    const int c = lane % L, kk = lane / L;
    float acc = 0.0f;
    if (c < nb)
      for (int k = k0 + kk; k < k1; k += 32 / L)
        acc = fmaf(v[k], wvalue(wc[k * ldw + cb + c]), acc);
    for (int off = L; off < 32; off <<= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (kk == 0 && c < nb) red[warp * ncols + cb + c] = acc;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < ncols; c += kThreads) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * ncols + c];
    sums[c] = s;
  }
  __syncthreads();
}

// red floats of vec_sums for ncols columns
__host__ __device__ inline int vec_red_floats(int ncols) {
  return kWarps * ncols;
}

// The ring of weight slots: job j's slice was copied into slot j & 1 two
// jobs ahead (the launch copies jobs 0 and 1 first). take(j) waits for it
// (and widens it where it was copied by words); release(j), when the
// block is done with it, copies job j + 2 into the freed slot. Every block
// takes and releases every job, in order, and commits one cp.async group a
// job (empty where it has no slice).
// ---------------------------------------------------------------------------
// the RNN walk: the hidden state through L2 as (value, step) pairs
// ---------------------------------------------------------------------------

// polls of one pair before a walk gives up on it (a few hundred
// milliseconds; a walk step waits microseconds): a fault then ends the
// launch with a wrong answer, not a hang
constexpr int kSpin = 1 << 18;

// a pair is one 8-byte word, written and read whole (relaxed, at the GPU's
// scope: through L2, and never hoisted out of a polling loop)
__device__ __forceinline__ void put_pair(unsigned long long* p, float v,
                                         unsigned tag) {
  const unsigned long long w =
      (static_cast<unsigned long long>(tag) << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(w)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_pair(
    const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(w) : "l"(p)
               : "memory");
  return w;
}

// the value of pair p once its tag is `tag`
__device__ __forceinline__ float poll_pair(const unsigned long long* p,
                                           unsigned tag, bool& dead) {
  unsigned long long v = load_pair(p);
  for (int n = 0; static_cast<unsigned>(v >> 32) != tag && !dead; ++n) {
    if (n >= kSpin) dead = true;
    v = load_pair(p);
  }
  return __uint_as_float(static_cast<unsigned>(v));
}

// W_hh's columns of block b in a walk over G blocks, H / G a block
// (rounded up)
__host__ __device__ inline Slice walk_slice(const void* w_hh, int H, int G,
                                            int b) {
  const int cpb = (H + G - 1) / G, c0 = b * cpb;
  const int n = c0 < H ? (cpb < H - c0 ? cpb : H - c0) : 0;
  return n > 0 ? Slice{w_hh, H, H, c0, n} : no_slice();
}

// Zero the pairs of this block's walk columns for steps 0..T-1 (before the
// launch's first barrier: a pair left by the launch before carries a tag
// this launch would take).
__device__ inline void zero_pairs(unsigned long long* hp, int T, int H,
                                  const Slice& s) {
  for (int e = threadIdx.x; e < T * s.nc; e += kThreads) {
    const int t = e / s.nc;
    hp[static_cast<size_t>(t) * H + s.n0 + (e - t * s.nc)] = 0ull;
  }
}

// h_t = tanh(xin[row(t)] + round(h_{t-1}) W_hh), h_{-1} = 0, for t < T,
// row(t) = t or rows[t]: the block owns W_hh's columns s.n0.. (s.nc of
// them, in wc [H][ldw]) and has no barrier: at step t it polls the H pairs
// of step t - 1 (tag t), stages them rounded, sums its columns (vec_sums)
// and writes their pairs of step t (tag t + 1) to hp (T, H). A block with
// no columns returns at once. sm: H + (kWarps + 1) s.nc floats.
template <typename WT, typename ST>
__device__ void walk_phase(const float* xin, const int* rows, int T, int H,
                           const Slice& s, const ST* wc, int ldw,
                           unsigned long long* hp, float* sm) {
  if (s.nc <= 0) return;
  float* hsm = sm;
  float* red = sm + H;
  float* sums = red + vec_red_floats(s.nc);
  bool dead = false;
  for (int t = 0; t < T; ++t) {
    float xv = 0.0f;
    if (threadIdx.x < s.nc)
      xv = __ldcg(xin + static_cast<size_t>(rows != nullptr ? rows[t] : t) *
                            H + s.n0 + threadIdx.x);
    if (t > 0) {
      for (int k = threadIdx.x; k < H; k += kThreads)
        hsm[k] = round_cd<WT>(poll_pair(
            hp + static_cast<size_t>(t - 1) * H + k, t, dead));
      __syncthreads();
      vec_sums(hsm, H, wc, ldw, s.nc, red, sums);
    }
    if (threadIdx.x < s.nc)
      put_pair(hp + static_cast<size_t>(t) * H + s.n0 + threadIdx.x,
               tanhf(xv + (t > 0 ? sums[threadIdx.x] : 0.0f)), t + 1);
  }
}

// rows row0..row0+nr-1 of the walk's hidden states (the pairs of row r,
// tag r + 1), rounded to WT, into As [nr][lds]
template <typename WT>
__device__ void stage_pairs(const unsigned long long* hp, int row0, int nr,
                            int H, float* As, int lds) {
  bool dead = false;
  for (int e = threadIdx.x; e < nr * H; e += kThreads) {
    const int r = e / H, k = e - r * H;
    As[r * lds + k] = round_cd<WT>(poll_pair(
        hp + static_cast<size_t>(row0 + r) * H + k, row0 + r + 1, dead));
  }
  __syncthreads();
}

// the launchers' common end: one block per SM, cooperatively. The kernel's
// dynamic shared memory limit is raised, and the occupancy checked, only
// when a call needs more than every call of that kernel before it
// (*allowed, the caller's own static for each kernel).
template <typename Kernel>
int launch_cooperative(Kernel kernel, int grid, size_t smem, void** args,
                       cudaStream_t stream, size_t* allowed) {
  if (smem > *allowed) {
    int per_sm = 0;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return kErrSmem;
    *allowed = smem;
  }
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(kernel), dim3(grid), dim3(kThreads), args, smem,
      stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// the current device's SMs and the shared memory a block may have, read
// once a device
inline cudaError_t device_limits(int* sms, int* smem_max) {
  constexpr int kDevices = 16;
  static int cached[kDevices][2] = {};
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kDevices || cached[dev][0] == 0) {
    cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    if (dev < kDevices) {
      cached[dev][1] = *smem_max;
      cached[dev][0] = *sms;
    }
    return cudaSuccess;
  }
  *sms = cached[dev][0];
  *smem_max = cached[dev][1];
  return cudaSuccess;
}

}  // namespace
