// K9 fused_recompute_batch: the exact windowed recompute of B streams, one
// output row each, in one cooperative launch.
//
// Replaces tip_tpu/ops/fused_forward.py::fused_recompute_batch (Pallas
// kernels _enc_batch_kernel and _rnn_last_batch_kernel, two pallas_calls
// with a transpose to time-major between them): for every stream the
// in-projection and L post-norm encoder layers over its T window rows with
// causal attention inside the window, the tanh RNN from zero over the
// window, the hidden state at the stream's own last valid row k_last[b],
// and the out-projection of that one row. It is K4 (fused_forward.cu) with
// a stream axis: attention and the RNN never cross from one stream to the
// next. Its products run on the tensor cores and K4's on the CUDA cores, so
// stream b's output equals K4's at k_last[b] to the rounding of a sum
// taken in another order, not bit for bit.
//
// What bounds it on the H100: operations. At B = 64, T = 40 the products
// are 17 GFLOP over 2560 rows against 14.7 MB of f32 weights and 2.3 MB of
// input: 0.10 ms at the tensor cores' TF32 rate over the three products of
// 3xTF32 (f32 packing), 0.017 ms at their bf16 rate (bf16 packing); 0.005
// ms of bytes.
//
// Design: one block per SM, 256 threads, grid.sync() between phases.
//   - The products are tiles of 80 rows x 64 columns (N <= 256) or 64 or
//     80 x 128 (whichever takes fewer rounds of the grid), one tile a
//     block at a time, their slices 32 deep staged in shared memory by
//     cp.async (.cg: activations other blocks wrote come from L2) through
//     3 stages. f32 packing: 3xTF32 mma.sync.m16n8k8 by train_mma.cuh's
//     tile routine (the one K12 runs), each 8-deep step's sums added to
//     the output in f32 (the tensor cores' own adds truncate), about f32's
//     accuracy. bf16 packing: mma.sync.m16n8k16 in bf16 with f32 sums;
//     the activations are rounded to bf16 as the fragments are built (K4's
//     round_cd), so the products are the exact values K4 takes and only
//     the order of the sums differs. The in-projection reads the raw model
//     input (221 columns, rows not 16-byte aligned), fixed on the way in
//     (input_fix) and not rounded: staged with plain loads, K padded with
//     zeros, 3xTF32 in both packings (a bf16 weight is exact in TF32). The
//     out-projection (131 columns) stages with plain loads too, in 16-row
//     tiles, its columns past N masked.
//   - The encoder runs over the streams in passes of up to 2560 rows (64
//     streams at T = 40): its activation scratch (x, qkv, att, the
//     pre-norm sum and the feed-forward hidden: 10 KB a row in f32) is 26
//     MB and stays in L2 whatever B is.
//   - Attention: a warp a (stream, head), its k and v staged in shared
//     memory, a lane a query row (the score and output sums in K4's
//     order). LayerNorm: a warp a row, the row in registers.
//   - The RNN over all B streams after the passes: the grid cut into
//     groups of 16 W_hh columns (in registers, a slice of 32 rows a
//     thread) times groups of streams, one barrier a step; a stream's
//     hidden state freezes after step k_last[b], which selects that row
//     with no second pass. The transpose to time-major of the TPU version
//     has no counterpart: rows are addressed as b * T + t.
// Barriers: (2 + 8 L) per pass, T RNN steps: 34 * ceil(B / 64) + 40 at the
// serving shape. A per-phase clock (PhaseClock) records them when asked.

#include "fused_phases.cuh"
#include "train_mma.cuh"

namespace {

constexpr int kChunkRows = 2560;  // window rows of one encoder pass

struct Dims {
  int B, T;     // streams, window rows
  int Din, d, heads, ff, layers, H, S;
  int zero0;    // first of the three zeroed input columns
  int vec;      // the activations' and weights' rows take 16-byte copies
  int chunk;    // streams of one encoder pass
  int spb;      // streams of a block's group in the RNN phase
};

// global scratch, f32. Per encoder pass (chunk * T rows): x, qkv, att, the
// pre-norm sum a, the feed-forward hidden f. For all streams: the RNN
// inputs xin (B, T, H) and two hidden-state buffers hs (2, B, H)
struct Scratch {
  float *x, *qkv, *att, *a, *f, *xin, *hs;
};

inline int chunk_streams(int B, int T) {
  int c = kChunkRows / T;
  if (c < 1) c = 1;
  return c < B ? c : B;
}

// The per-phase clock (optional: a null clk costs nothing). Row r of clk,
// four u64, describes the barrier that closes phase r: block 0's
// %globaltimer just after it, the first and the last block's arrival at it
// (atomicMin / atomicMax; the caller fills column 1 with a large value),
// and the phase's kind (kPh*). Row 0 is the launch's start. A phase that
// runs its own barriers (the RNN) records no arrival. Rows past `cap` are
// not written.
enum PhaseKind {
  kPhStart = 0, kPhIn = 1, kPhQkv = 2, kPhAttn = 3, kPhAttnOut = 4,
  kPhLn1 = 5, kPhFf1 = 6, kPhFf2 = 7, kPhLn2 = 8, kPhWih = 9, kPhRnn = 10,
  kPhOut = 11
};

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

struct PhaseClock {
  unsigned long long* clk;
  int cap;
  int row;

  __device__ void start() {
    row = 1;
    if (clk != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
      clk[0] = global_ns();
      clk[3] = kPhStart;
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

// ---------------------------------------------------------------------------
// attention and the RNN
// ---------------------------------------------------------------------------

// att (R, d) of n_streams windows of T rows: per head, softmax(q k^T /
// sqrt(hd) + causal mask) v, with q, k, the softmax weights and v rounded
// to WT before their products (attention_phase's function). A warp takes a
// (stream, head): k and v staged in its own part of shared memory (rows
// of HD floats, read by all lanes at once), a lane a query row with q in
// registers, three passes over the keys j <= i (the largest score, the sum
// of the exponentials, then the weights, rounded, times v). The score and
// output sums run in attention_phase's order. hd <= HD. sm: kWarps 2 T HD
// floats.
// q . k over HD values, in c's order
template <int HD>
__device__ __forceinline__ float dot_row(const float (&q)[HD],
                                         const float* k) {
  const float4* k4 = reinterpret_cast<const float4*>(k);
  float s = 0.0f;
#pragma unroll
  for (int c4 = 0; c4 < HD / 4; ++c4) {
    const float4 kv = k4[c4];
    s = fmaf(q[4 * c4], kv.x, s);
    s = fmaf(q[4 * c4 + 1], kv.y, s);
    s = fmaf(q[4 * c4 + 2], kv.z, s);
    s = fmaf(q[4 * c4 + 3], kv.w, s);
  }
  return s;
}

template <typename WT, int HD>
__device__ void attention_lanes_phase(const float* qkv, int T, int d,
                                      int heads, float* att, float* sm,
                                      int n_streams) {
  const int hd = d / heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ks = sm + warp * 2 * T * HD;             // [T][HD]
  float* vs = ks + T * HD;                        // [T][HD]
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  for (int unit = blockIdx.x * kWarps + warp; unit < n_streams * heads;
       unit += gridDim.x * kWarps) {
    const int st = unit / heads, hh = unit - st * heads;
    const float* src0 = qkv + static_cast<size_t>(st) * T * 3 * d + hh * hd;
    float* out = att + static_cast<size_t>(st) * T * d + hh * hd;
    __syncwarp();                 // the unit before is done with ks, vs
#pragma unroll 8
    for (int idx = lane; idx < T * HD; idx += 32) {
      const int j = idx / HD, c = idx - j * HD;
      const float* src = src0 + static_cast<size_t>(j) * 3 * d + c;
      ks[idx] = c < hd ? round_cd<WT>(__ldcg(src + d)) : 0.0f;
      vs[idx] = c < hd ? round_cd<WT>(__ldcg(src + 2 * d)) : 0.0f;
    }
    __syncwarp();
    for (int i = lane; i < T; i += 32) {
      float q[HD];
#pragma unroll
      for (int c = 0; c < HD; ++c)
        q[c] = c < hd ? round_cd<WT>(
                            __ldcg(src0 + static_cast<size_t>(i) * 3 * d + c))
                      : 0.0f;
      float mx = -INFINITY;
      for (int j = 0; j <= i; ++j)
        mx = fmaxf(mx, dot_row<HD>(q, ks + j * HD) * scale);
      float sum = 0.0f;
      for (int j = 0; j <= i; ++j)
        sum += expf(dot_row<HD>(q, ks + j * HD) * scale - mx);
      float o[HD];
#pragma unroll
      for (int c = 0; c < HD; ++c) o[c] = 0.0f;
      for (int j = 0; j <= i; ++j) {
        const float pj = round_cd<WT>(
            expf(dot_row<HD>(q, ks + j * HD) * scale - mx) / sum);
        const float4* v4 = reinterpret_cast<const float4*>(vs + j * HD);
#pragma unroll
        for (int c4 = 0; c4 < HD / 4; ++c4) {
          const float4 vv = v4[c4];
          o[4 * c4] = fmaf(pj, vv.x, o[4 * c4]);
          o[4 * c4 + 1] = fmaf(pj, vv.y, o[4 * c4 + 1]);
          o[4 * c4 + 2] = fmaf(pj, vv.z, o[4 * c4 + 2]);
          o[4 * c4 + 3] = fmaf(pj, vv.w, o[4 * c4 + 3]);
        }
      }
#pragma unroll
      for (int c = 0; c < HD; ++c)
        if (c < hd) out[static_cast<size_t>(i) * d + c] = o[c];
    }
  }
}

// the head width's register row: 16 where it fits, else 64
__host__ __device__ constexpr int attention_hd(int hd) {
  return hd <= 16 ? 16 : kMaxHeadDim;
}

template <typename WT>
__device__ void attention_heads_phase(const float* qkv, int T, int d,
                                      int heads, float* att, float* sm,
                                      int n_streams) {
  if (attention_hd(d / heads) == 16)
    attention_lanes_phase<WT, 16>(qkv, T, d, heads, att, sm, n_streams);
  else
    attention_lanes_phase<WT, kMaxHeadDim>(qkv, T, d, heads, att, sm,
                                           n_streams);
}

// x = LayerNorm(a) * s + b per row, layernorm_phase's arithmetic (the same
// sums in the same order) with the row held in registers: one round of
// loads a row, a warp a row. d <= 32 * kLnRegs.
constexpr int kLnRegs = 32;

__device__ inline void layernorm_regs_phase(const float* a, int R, int d,
                                            const float* __restrict__ s,
                                            const float* __restrict__ b,
                                            float* x) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int row = blockIdx.x * kWarps + warp; row < R;
       row += gridDim.x * kWarps) {
    const float* ar = a + static_cast<size_t>(row) * d;
    float v[kLnRegs];
#pragma unroll
    for (int i = 0; i < kLnRegs; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < d ? __ldcg(ar + c) : 0.0f;
    }
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < kLnRegs; ++i)
      if (lane + 32 * i < d) sum += v[i];
    const float mu = warp_sum(sum) / static_cast<float>(d);
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < kLnRegs; ++i)
      if (lane + 32 * i < d) {
        const float dv = v[i] - mu;
        sq = fmaf(dv, dv, sq);
      }
    const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(d) + 1e-5f);
#pragma unroll
    for (int i = 0; i < kLnRegs; ++i) {
      const int c = lane + 32 * i;
      if (c < d)
        x[static_cast<size_t>(row) * d + c] =
            (v[i] - mu) * rstd * __ldg(s + c) + __ldg(b + c);
    }
  }
}

constexpr int kRnnCols = 16;      // W_hh columns of a block in the RNN
constexpr int kRnnKRegs = 32;     // W_hh rows a thread keeps: H <= 512

// The tanh RNN of B streams over T steps, each frozen after its k_last:
//   h[b] <- t <= k_last[b] ? tanh(xin[b, t] + round(h[b]) W_hh) : h[b],
// h[b] = 0 before step 0. hs: two (B, H) f32 buffers; step t reads
// hs[t & 1] and writes hs[(t + 1) & 1], so the last hidden states are in
// hs + (T & 1) * B * H. The grid is cut into column groups of 16 columns
// of W_hh times stream groups of spb streams. Thread (c, kq) of a block,
// c = tid % 16, keeps column c's rows kq * kc .. kq * kc + kc - 1 (kc =
// H / 16 rounded up) in registers. A step takes the group's streams 16 at
// a time: their xin first, their previous hidden states (rounded to WT)
// staged in shared memory, a partial sum per (stream, kq, c) over the
// thread's rows, then thread (stream, c) adds the 16 partials in kq's
// order. One grid barrier a step; every block reaches every one. sm:
// 16 H + 16 * 16 * 16 floats. H <= 16 kRnnKRegs.
template <typename WT>
__device__ void rnn_groups_phase(cg::grid_group& grid, const float* xin,
                                 const WT* __restrict__ w_hh,
                                 const int* __restrict__ k_last, int B, int T,
                                 int H, int spb, float* hs, float* sm) {
  const int tid = threadIdx.x;
  const int n_cg = (H + kRnnCols - 1) / kRnnCols;
  const int c0 = (blockIdx.x % n_cg) * kRnnCols;
  const int ncols = max(0, min(kRnnCols, H - c0));
  const int b_lo = (blockIdx.x / n_cg) * spb, b_hi = min(B, b_lo + spb);
  const int kc = (H + 15) / 16;
  const int c = tid % 16, kq = tid / 16;
  const int ldh = (H + 3) / 4 * 4;
  float* hsm = sm;                                  // [16][ldh]
  float* red = sm + 16 * ldh;                       // [16 streams][16][16]
  float wr[kRnnKRegs];
#pragma unroll
  for (int j = 0; j < kRnnKRegs; ++j) {
    const int k = kq * kc + j;
    wr[j] = j < kc && k < H && c < ncols
                ? wload(w_hh + static_cast<size_t>(k) * H + c0 + c)
                : 0.0f;
  }
  const bool vec4 = H % 4 == 0 && kc % 4 == 0;
  const int r_out = tid / 16;     // the stream this thread finishes
  const size_t BH = static_cast<size_t>(B) * H;
  // with one pass a step (spb <= 16), each step's xin and the stream's
  // k_last are loaded ahead, before the barrier of the step before
  const bool one_pass = b_hi - b_lo <= 16;
  const bool mine1 = r_out < b_hi - b_lo && c < ncols;
  const int k1 = mine1 ? __ldg(k_last + b_lo + r_out) : 0;
  const float* x1 = xin + static_cast<size_t>(b_lo + r_out) * T * H + c0 + c;
  float x_next = one_pass && mine1 ? __ldcg(x1) : 0.0f;
  for (int t = 0; t < T; ++t) {
    const float* h_prev = hs + (t & 1) * BH;
    float* h_next = hs + ((t + 1) & 1) * BH;
    for (int b0 = b_lo; b0 < b_hi; b0 += 16) {
      const int nb = min(16, b_hi - b0);
      const int b = b0 + r_out;
      const bool mine = r_out < nb && c < ncols;
      const float xv =
          one_pass ? x_next
                   : (mine ? __ldcg(xin + (static_cast<size_t>(b) * T + t) *
                                              H + c0 + c)
                           : 0.0f);
      const int kl = one_pass ? k1 : (mine ? __ldg(k_last + b) : 0);
      __syncthreads();            // the pass before is done with hsm, red
      if (t > 0) {
        const float* src = h_prev + static_cast<size_t>(b0) * H;
        if (H % 4 == 0) {         // rows contiguous in hsm too
          const float4* src4 = reinterpret_cast<const float4*>(src);
          float4* dst4 = reinterpret_cast<float4*>(hsm);
#pragma unroll 8
          for (int idx = tid; idx < nb * H / 4; idx += kThreads) {
            float4 v = __ldcg(src4 + idx);
            v.x = round_cd<WT>(v.x);
            v.y = round_cd<WT>(v.y);
            v.z = round_cd<WT>(v.z);
            v.w = round_cd<WT>(v.w);
            dst4[idx] = v;
          }
        } else {
#pragma unroll 8
          for (int idx = tid; idx < nb * H; idx += kThreads) {
            const int r = idx / H, k = idx - r * H;
            hsm[r * ldh + k] = round_cd<WT>(__ldcg(src + idx));
          }
        }
      }
      __syncthreads();
      // the 16 streams' partial sums side by side, each over k in order
      float part[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) part[r] = 0.0f;
      if (t > 0) {
        const float* hk = hsm + kq * kc;
        if (vec4) {
#pragma unroll
          for (int j = 0; j < kRnnKRegs; j += 4) {
            if (j < kc) {
#pragma unroll
              for (int r = 0; r < 16; ++r) {
                if (r < nb) {
                  const float4 h4 =
                      *reinterpret_cast<const float4*>(hk + r * ldh + j);
                  part[r] = fmaf(h4.x, wr[j], part[r]);
                  part[r] = fmaf(h4.y, wr[j + 1], part[r]);
                  part[r] = fmaf(h4.z, wr[j + 2], part[r]);
                  part[r] = fmaf(h4.w, wr[j + 3], part[r]);
                }
              }
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < kRnnKRegs; ++j) {
            if (j < kc && kq * kc + j < H) {
#pragma unroll
              for (int r = 0; r < 16; ++r)
                if (r < nb) part[r] = fmaf(hk[r * ldh + j], wr[j], part[r]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 16; ++r)
        if (r < nb) red[(r * 16 + kq) * 16 + c] = part[r];
      __syncthreads();
      if (mine) {
        float sum = 0.0f;
        for (int q = 0; q < 16; ++q) sum += red[(r_out * 16 + q) * 16 + c];
        const size_t at = static_cast<size_t>(b) * H + c0 + c;
        h_next[at] = t <= kl ? tanhf(xv + sum)
                             : (t > 0 ? __ldcg(h_prev + at) : 0.0f);
      }
    }
    if (one_pass && mine1 && t + 1 < T)
      x_next = __ldcg(x1 + static_cast<size_t>(t + 1) * H);
    grid.sync();
  }
}

// ---------------------------------------------------------------------------
// the products on the tensor cores
// ---------------------------------------------------------------------------

// 80-row tiles give the 2560 rows of 64 streams 32 row tiles: 128 tiles of
// N = 256 (one round over 132 SMs), 256 of N = 1024 (two rounds)
using NarrowTile = tf3::Tile<64, 1, 8, 80>;   // N <= 256: 80 x 64
using WideTile = tf3::Tile<128, 2, 4, 64>;    // N > 256: 64 x 128 ...
using Wide80Tile = tf3::Tile<128, 1, 8, 80>;  // ... or 80 x 128
using OutTile = tf3::Tile<64, 1, 8, 16>;      // the out-projection: 16 x 64
static_assert(NarrowTile::THREADS == kThreads && WideTile::THREADS ==
              kThreads && Wide80Tile::THREADS == kThreads &&
              OutTile::THREADS == kThreads, "256 threads");

// how a product stages its operands: the raw model input (plain loads,
// input_fix, not rounded: 3xTF32 in both packings), plain loads, or
// cp.async (A's and W's rows take 16-byte copies)
enum ProductMode { kProdIn = 0, kProdPlain = 1, kProdAsync = 2 };

// a bf16 packing's stage: A f32 in tf3's layout, W bf16 (BK, BN + 8)
template <class L>
struct Bf16Stage {
  static constexpr int A_LD = tf3::BK + 4;
  static constexpr int A_FLOATS = L::BM * A_LD;
  static constexpr int B_LD = L::BN + 8;                   // bf16 values
  static constexpr int B_FLOATS = tf3::BK * B_LD / 2;
  static constexpr int FLOATS = A_FLOATS + B_FLOATS;
  static constexpr size_t BYTES = sizeof(float) * tf3::kStages * FLOATS;
};

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two f32 activations rounded to bf16 (round_cd's rounding), lo in the
// low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the products of one staged bf16 slice added to a warp's fragments (the
// layout of tf3::mma_slice; m16n8k16: a pair of k a register)
template <class L>
__device__ __forceinline__ void bf16_slice(const float* As,
                                           const unsigned short* Bs,
                                           float (&acc)[L::MT][L::NT][4],
                                           int wm, int wn, int g, int q) {
  using S = Bf16Stage<L>;
#pragma unroll
  for (int kk = 0; kk < tf3::BK; kk += 16) {
    uint32_t b[L::NT][2];
#pragma unroll
    for (int nt = 0; nt < L::NT; ++nt) {
      const int n = wn * L::TN + nt * 8 + g;
#pragma unroll
      for (int r = 0; r < 2; ++r) {   // k pairs 2q, 2q+8
        const int k = kk + 2 * q + 8 * r;
        b[nt][r] = static_cast<uint32_t>(Bs[k * S::B_LD + n]) |
                   (static_cast<uint32_t>(Bs[(k + 1) * S::B_LD + n]) << 16);
      }
    }
#pragma unroll
    for (int mt = 0; mt < L::MT; ++mt) {
      uint32_t a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {   // rows g, g+8; k pairs 2q, 2q+8
        const int m = wm * L::TM + mt * 16 + g + 8 * (r & 1);
        const int k = kk + 2 * q + 8 * (r >> 1);
        const float2 v =
            *reinterpret_cast<const float2*>(As + m * S::A_LD + k);
        a[r] = pack_bf16(v.x, v.y);
      }
#pragma unroll
      for (int nt = 0; nt < L::NT; ++nt) mma_bf16(acc[mt][nt], a, b[nt]);
    }
  }
}

// stage slice k0 of A (f32, rows lda apart) and W (bf16 (K, N)) by cp.async
template <class L>
__device__ __forceinline__ void load_bf16_stage(
    float* As, unsigned short* Bs, const float* __restrict__ A,
    const __nv_bfloat16* __restrict__ W, int M, int N, int K, int lda,
    int m0, int n0, int k0, int tid) {
  using S = Bf16Stage<L>;
  constexpr int BK = tf3::BK;
  for (int e = tid; e < L::BM * (BK / 4); e += L::THREADS) {
    const int mm = e / (BK / 4), c = e % (BK / 4);
    const int gm = m0 + mm, gk = k0 + 4 * c;
    const bool v = gm < M && gk < K;
    tf3::cp16(As + mm * S::A_LD + 4 * c,
              v ? A + static_cast<size_t>(gm) * lda + gk : A, v);
  }
  for (int e = tid; e < BK * (L::BN / 8); e += L::THREADS) {
    const int kk = e / (L::BN / 8), c = e % (L::BN / 8);
    const int gk = k0 + kk, gn = n0 + 8 * c;
    const bool v = gk < K && gn < N;
    tf3::cp16(reinterpret_cast<float*>(Bs + kk * S::B_LD + 8 * c),
              reinterpret_cast<const float*>(
                  v ? W + static_cast<size_t>(gk) * N + gn : W),
              v);
  }
}

// tf3::mma_tile's pipeline for the bf16 packing
template <class L>
__device__ void bf16_tile(const float* __restrict__ A,
                          const __nv_bfloat16* __restrict__ W, int M, int N,
                          int K, int lda, int m0, int n0, float* sm,
                          float (&acc)[L::MT][L::NT][4], int wm, int wn,
                          int g, int q) {
  using S = Bf16Stage<L>;
  constexpr int BK = tf3::BK, kStages = tf3::kStages;
  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int i = 0; i < L::MT; ++i)
#pragma unroll
    for (int j = 0; j < L::NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      load_bf16_stage<L>(
          sm + s * S::FLOATS,
          reinterpret_cast<unsigned short*>(sm + s * S::FLOATS + S::A_FLOATS),
          A, W, M, N, K, lda, m0, n0, s * BK, threadIdx.x);
    tf3::cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    tf3::cp_wait<kStages - 2>();   // slice kt has landed
    __syncthreads();               // ... for every thread; kt-1 is done
    const int nxt = kt + kStages - 1;
    if (nxt < nk) {
      float* st = sm + (nxt % kStages) * S::FLOATS;
      load_bf16_stage<L>(st,
                         reinterpret_cast<unsigned short*>(st + S::A_FLOATS),
                         A, W, M, N, K, lda, m0, n0, nxt * BK, threadIdx.x);
    }
    tf3::cp_commit();
    const float* As = sm + (kt % kStages) * S::FLOATS;
    bf16_slice<L>(As, reinterpret_cast<const unsigned short*>(As +
                                                              S::A_FLOATS),
                  acc, wm, wn, g, q);
  }
  tf3::cp_wait<0>();
}

// A slice staged with plain loads, zeros past M, N, K: A (f32, rows lda
// apart; zero0 >= 0 marks the raw model input, through input_fix) in tf3's
// layout, W ((K, N) in WT) as f32 (TF32) or as bf16 (the bf16 products)
template <typename WT, bool TF32, class L>
__device__ __forceinline__ void load_plain_stage(
    float* As, float* Bs, const float* A, int lda, const WT* __restrict__ W,
    int M, int N, int K, int m0, int n0, int k0, int zero0) {
  constexpr int BK = tf3::BK;
  constexpr int A_LD = BK + 4;
  for (int e = threadIdx.x; e < L::BM * BK; e += L::THREADS) {
    const int mm = e / BK, kk = e % BK;
    const int gm = m0 + mm, gk = k0 + kk;
    float v = 0.0f;
    if (gm < M && gk < K) {
      v = aload(A + static_cast<size_t>(gm) * lda + gk);
      if (zero0 >= 0) v = input_fix(v, gk, zero0);
    }
    As[mm * A_LD + kk] = v;
  }
  for (int e = threadIdx.x; e < BK * L::BN; e += L::THREADS) {
    const int kk = e / L::BN, nn = e % L::BN;
    const int gk = k0 + kk, gn = n0 + nn;
    const bool v = gk < K && gn < N;
    const size_t o = static_cast<size_t>(gk) * N + gn;
    if (TF32) {
      Bs[kk * tf3::Stage<false, false, L>::B_LD + nn] =
          v ? wload(W + o) : 0.0f;
    } else {
      reinterpret_cast<unsigned short*>(Bs)[kk * Bf16Stage<L>::B_LD + nn] =
          v ? __ldg(reinterpret_cast<const unsigned short*>(W) + o)
            : static_cast<unsigned short>(0);
    }
  }
}

// a tile whose slices are staged with plain loads, one at a time
template <typename WT, bool TF32, class L>
__device__ void plain_tile(const float* A, int lda, const WT* __restrict__ W,
                           int M, int N, int K, int m0, int n0, int zero0,
                           float* sm, float (&acc)[L::MT][L::NT][4], int wm,
                           int wn, int g, int q) {
  constexpr int A_FLOATS = L::BM * (tf3::BK + 4);
#pragma unroll
  for (int i = 0; i < L::MT; ++i)
#pragma unroll
    for (int j = 0; j < L::NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += tf3::BK) {
    __syncthreads();              // the slice before is done with sm
    load_plain_stage<WT, TF32, L>(sm, sm + A_FLOATS, A, lda, W, M, N, K, m0,
                                  n0, k0, zero0);
    __syncthreads();
    if (TF32)
      tf3::mma_slice<false, false, L, true>(sm, sm + A_FLOATS, acc, wm, wn,
                                            g, q);
    else
      bf16_slice<L>(sm, reinterpret_cast<const unsigned short*>(
                            sm + A_FLOATS),
                    acc, wm, wn, g, q);
  }
}

// out (M, N), row r at out + r * ldo (ldo 0: N), = act(A (M, K) W (K, N) +
// bias [+ res (M, N)]) on the tensor cores, tiles of L a block at a time.
// mode: ProductMode. A and res may have been written by other blocks in
// the phase before (read through L2); W and bias are the packed weights.
template <typename WT, class L>
__device__ void tc_product_phase(const float* A, int lda, int M, int K,
                                 const WT* __restrict__ W,
                                 const WT* __restrict__ bias, int N,
                                 const float* res, float* out, int ldo,
                                 int act, int mode, int zero0, float* sm) {
  if (ldo == 0) ldo = N;
  const int n_mt = (M + L::BM - 1) / L::BM, n_nt = (N + L::BN - 1) / L::BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, q = lane & 3;
  const int wm = warp % (L::BM / L::TM), wn = warp / (L::BM / L::TM);
  for (int tile = blockIdx.x; tile < n_mt * n_nt; tile += gridDim.x) {
    const int m0 = (tile % n_mt) * L::BM, n0 = (tile / n_mt) * L::BN;
    float acc[L::MT][L::NT][4];
    if (mode == kProdIn) {
      plain_tile<WT, true, L>(A, lda, W, M, N, K, m0, n0, zero0, sm, acc,
                              wm, wn, g, q);
    } else if constexpr (sizeof(WT) == sizeof(float)) {
      if (mode == kProdAsync)
        tf3::mma_tile<false, false, L, true>(A, W, M, N, lda, N, m0, n0, 0,
                                             K, sm, acc);
      else
        plain_tile<WT, true, L>(A, lda, W, M, N, K, m0, n0, -1, sm, acc, wm,
                                wn, g, q);
    } else {
      if (mode == kProdAsync)
        bf16_tile<L>(A, W, M, N, K, lda, m0, n0, sm, acc, wm, wn, g, q);
      else
        plain_tile<WT, false, L>(A, lda, W, M, N, K, m0, n0, -1, sm, acc,
                                 wm, wn, g, q);
    }
#pragma unroll
    for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {   // rows g, g+8; columns 2q, 2q+1
          const int row = m0 + wm * L::TM + mt * 16 + g + 8 * (r >> 1);
          const int col = n0 + wn * L::TN + nt * 8 + 2 * q + (r & 1);
          if (row < M && col < N) {
            float v = acc[mt][nt][r] +
                      (bias != nullptr ? wload(bias + col) : 0.0f);
            if (res != nullptr)
              v = __ldcg(res + static_cast<size_t>(row) * N + col) + v;
            if (act == kActRelu) v = fmaxf(v, 0.0f);
            out[static_cast<size_t>(row) * ldo + col] = v;
          }
        }
    __syncthreads();              // sm is staged again by the next tile
  }
}

// rounds of tiles of BM x BN rows and columns over the grid, times BM
__device__ __forceinline__ int tile_cost(int M, int N, int BM, int BN) {
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  return (tiles + gridDim.x - 1) / gridDim.x * BM;
}

// the encoder's products: the tile by N, and for N > 256 the row count
// that takes fewer rounds of the grid
template <typename WT>
__device__ void product(const float* A, int lda, int M, int K, const WT* W,
                        const WT* bias, int N, const float* res, float* out,
                        int act, int mode, int zero0, float* sm) {
  if (N <= 256)
    tc_product_phase<WT, NarrowTile>(A, lda, M, K, W, bias, N, res, out, 0,
                                     act, mode, zero0, sm);
  else if (tile_cost(M, N, 64, 128) <= tile_cost(M, N, 80, 128))
    tc_product_phase<WT, WideTile>(A, lda, M, K, W, bias, N, res, out, 0,
                                   act, mode, zero0, sm);
  else
    tc_product_phase<WT, Wide80Tile>(A, lda, M, K, W, bias, N, res, out, 0,
                                     act, mode, zero0, sm);
}

constexpr size_t max_bytes(size_t a, size_t b) { return a > b ? a : b; }

// shared memory of the products' stages, bytes
constexpr size_t product_smem() {
  return max_bytes(
      max_bytes(tf3::Stage<false, false, NarrowTile>::BYTES,
                tf3::Stage<false, false, WideTile>::BYTES),
      max_bytes(tf3::Stage<false, false, Wide80Tile>::BYTES,
                max_bytes(Bf16Stage<Wide80Tile>::BYTES,
                          Bf16Stage<WideTile>::BYTES)));
}

template <typename WT>
__global__ void __launch_bounds__(kThreads)
fused_recompute_batch_kernel(const float* __restrict__ x,
                             const int* __restrict__ k_last, Weights w,
                             Dims p, Scratch s, float* __restrict__ out,
                             PhaseClock clock) {
  cg::grid_group grid = cg::this_grid();
  clock.start();
  extern __shared__ __align__(16) unsigned char sm_raw[];
  float* sm = reinterpret_cast<float*>(sm_raw);
  const int B = p.B, T = p.T, d = p.d, H = p.H;
  auto W = [](const void* q) { return static_cast<const WT*>(q); };

  for (int b0 = 0; b0 < B; b0 += p.chunk) {
    const int nb = min(p.chunk, B - b0);
    const int R = nb * T;         // rows of this pass
    const float* xc = x + static_cast<size_t>(b0) * T * p.Din;
    float* xin_c = s.xin + static_cast<size_t>(b0) * T * H;
    const int mode = p.vec ? kProdAsync : kProdPlain;
    // the model input enters the in-projection as f32, not rounded
    product<WT>(xc, p.Din, R, p.Din, W(w.w_in), W(w.b_in), d, nullptr, s.x,
                kActNone, kProdIn, p.zero0, sm);
    clock.sync(grid, kPhIn);
    for (int l = 0; l < p.layers; ++l) {
      const Layer& L = w.layer[l];
      product<WT>(s.x, d, R, d, W(L.w_qkv), W(L.b_qkv), 3 * d, nullptr,
                  s.qkv, kActNone, mode, -1, sm);
      clock.sync(grid, kPhQkv);
      attention_heads_phase<WT>(s.qkv, T, d, p.heads, s.att, sm, nb);
      clock.sync(grid, kPhAttn);
      product<WT>(s.att, d, R, d, W(L.w_o), W(L.b_o), d, s.x, s.a, kActNone,
                  mode, -1, sm);
      clock.sync(grid, kPhAttnOut);
      layernorm_regs_phase(s.a, R, d, L.ln1_s, L.ln1_b, s.x);
      clock.sync(grid, kPhLn1);
      product<WT>(s.x, d, R, d, W(L.w_f1), W(L.b_f1), p.ff, nullptr, s.f,
                  kActRelu, mode, -1, sm);
      clock.sync(grid, kPhFf1);
      product<WT>(s.f, p.ff, R, p.ff, W(L.w_f2), W(L.b_f2), d, s.x, s.a,
                  kActNone, mode, -1, sm);
      clock.sync(grid, kPhFf2);
      layernorm_regs_phase(s.a, R, d, L.ln2_s, L.ln2_b, s.x);
      clock.sync(grid, kPhLn2);
    }
    product<WT>(s.x, d, R, d, W(w.w_ih), W(w.b_r), H, nullptr, xin_c,
                kActNone, mode, -1, sm);
    clock.sync(grid, kPhWih);
  }

  rnn_groups_phase<WT>(grid, s.xin, W(w.w_hh), k_last, B, T, H, p.spb,
                       s.hs, sm);
  clock.closed(kPhRnn);
  tc_product_phase<WT, OutTile>(s.hs + static_cast<size_t>(T & 1) * B * H,
                                H, B, H, W(w.w_out), W(w.b_out), p.S, nullptr,
                                out, 0, kActNone, kProdPlain, -1, sm);
  if (clock.clk != nullptr) clock.sync(grid, kPhOut);
}

inline size_t scratch_total(int B, int T, int d, int ff, int H) {
  const size_t rows = static_cast<size_t>(chunk_streams(B, T)) * T;
  return rows * (6 * static_cast<size_t>(d) + ff) +
         static_cast<size_t>(B) * T * H + 2 * static_cast<size_t>(B) * H;
}

template <typename WT>
int launch(const float* x, const int* k_last, const Weights& w, Dims p,
           float* scratch, float* out, PhaseClock clock,
           cudaStream_t stream) {
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const int grid = sms;           // one block per SM, all co-resident
  p.chunk = chunk_streams(p.B, p.T);
  const size_t rows = static_cast<size_t>(p.chunk) * p.T;
  Scratch s;
  s.x = scratch;
  s.qkv = s.x + rows * p.d;
  s.att = s.qkv + rows * 3 * p.d;
  s.a = s.att + rows * p.d;
  s.f = s.a + rows * p.d;
  s.xin = s.f + rows * p.ff;
  s.hs = s.xin + static_cast<size_t>(p.B) * p.T * p.H;

  // shared memory, one region the phases take in turn: the products'
  // stages, attention's rows, or the RNN's columns and hidden states
  const size_t attn = kWarps * 2 * static_cast<size_t>(p.T) *
                      attention_hd(p.d / p.heads) * sizeof(float);
  size_t smem = product_smem() > attn ? product_smem() : attn;
  // the RNN: column groups of kRnnCols, the streams split over the groups
  // the grid holds; LayerNorm holds a row in registers
  if (p.H > 16 * kRnnKRegs || p.d > 32 * kLnRegs) return kErrShape;
  const int n_cg = (p.H + kRnnCols - 1) / kRnnCols;
  p.spb = (p.B + grid / n_cg - 1) / (grid / n_cg);
  const size_t rnn =
      (16 * static_cast<size_t>((p.H + 3) / 4 * 4) + 16 * 16 * 16) *
      sizeof(float);
  if (rnn > smem) smem = rnn;
  if (smem > static_cast<size_t>(smem_max)) return kErrSmem;
  Weights w_arg = w;
  void* args[] = {&x, &k_last, &w_arg, &p, &s, &out, &clock};
  return launch_cooperative(fused_recompute_batch_kernel<WT>, grid, smem,
                            args, stream);
}

}  // namespace

// The scratch (in floats) fused_recompute_batch_launch needs, so that the
// caller can allocate it; -1 when it does not fit 31 bits.
extern "C" int fused_recompute_batch_scratch_floats(int B, int T, int d,
                                                    int ff, int H) {
  const size_t total = scratch_total(B, T, d, ff, H);
  return total > 0x7fffffffu ? -1 : static_cast<int>(total);
}

// weights: the packed list of ops/fused_forward.py::pack_weights, n_w =
// 2 + 12 * layers + 5 device pointers. x (B, T, Din) f32, k_last (B,) int32
// with 0 <= k_last[b] < T (the caller checks), out (B, S) f32. scratch:
// fused_recompute_batch_scratch_floats floats. Returns a CUDA error code,
// or -1 for a shape outside the kernel's limits (or a scratch too small),
// -2 when the widths need more shared memory than a block has. clock:
// null, or clock_rows rows of 4 u64 for the per-phase clock (PhaseClock).
extern "C" int fused_recompute_batch_launch(
    const void* x, const void* k_last, const void* const* weights, int n_w,
    int is_bf16, int B, int T, int Din, int d, int heads, int ff, int layers,
    int H, int S, int zero0, void* scratch, long long scratch_floats,
    void* out, void* clock, int clock_rows, void* stream) {
  if (B < 1 || T < 1 || T > kMaxT || layers < 1 || layers > kMaxLayers ||
      n_w != 2 + 12 * layers + 5 || heads < 1 || d < 1 || d % heads != 0 ||
      d / heads > kMaxHeadDim || Din < 1 || ff < 1 || H < 1 || S < 1 ||
      static_cast<long long>(B) * T * (H > Din ? H : Din) > 0x7fffffffLL ||
      scratch_floats < 0 ||
      static_cast<size_t>(scratch_floats) < scratch_total(B, T, d, ff, H))
    return kErrShape;
  const Weights w = unpack_weights(weights, layers);
  Dims p;
  p.B = B;
  p.T = T;
  p.Din = Din;
  p.d = d;
  p.heads = heads;
  p.ff = ff;
  p.layers = layers;
  p.H = H;
  p.S = S;
  p.zero0 = zero0;
  // 16-byte copies along every product's rows: the widths a multiple of 8
  // (bf16 rows of 16 bytes), every matrix aligned
  bool vec = d % 8 == 0 && ff % 8 == 0 && H % 8 == 0;
  for (int i = 0; i < n_w; ++i)
    vec = vec && (reinterpret_cast<uintptr_t>(weights[i]) & 15) == 0;
  p.vec = vec ? 1 : 0;
  p.chunk = 0;
  p.spb = 0;
  const float* xf = static_cast<const float*>(x);
  const int* kf = static_cast<const int*>(k_last);
  float* sf = static_cast<float*>(scratch);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PhaseClock ck{static_cast<unsigned long long*>(clock),
                      clock != nullptr ? clock_rows : 0, 0};
  if (is_bf16) return launch<__nv_bfloat16>(xf, kf, w, p, sf, of, ck, st);
  return launch<float>(xf, kf, w, p, sf, of, ck, st);
}
