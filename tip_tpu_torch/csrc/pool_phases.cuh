// Device code shared by the pool kernels K9 (fused_recompute_batch.cu, the
// windowed recompute of B streams) and K8 (fused_cached_batch.cu, the
// cached step of B streams): LayerNorm with a row in registers, the
// register-resident RNN over B streams, and the products on the tensor
// cores (the per-phase clock is fused_phases.cuh's). Each is a phase of one
// cooperative launch of kThreads threads a block, one block an SM, as
// fused_phases.cuh's are.
//
// The products (tc_product_phase) take tiles of L rows x columns, one tile
// a block at a time, their slices 32 deep staged in shared memory by
// cp.async (.cg: activations other blocks wrote come from L2) through 3
// stages, or with plain loads where rows are not 16-byte aligned. f32
// packing: 3xTF32 mma.sync.m16n8k8 by train_mma.cuh's tile routine, each
// 8-deep step's sums added to the output in f32 (the tensor cores' own adds
// truncate), about f32's accuracy. bf16 packing: mma.sync.m16n8k16 in bf16
// with f32 sums; the activations are rounded to bf16 as the fragments are
// built (round_cd's rounding), so the products are the exact values the
// CUDA-core phases take and only the order of the sums differs.
//
// For a product of few rows (a pool's B tokens: K8's layers), split_product
// cuts the outputs into tiles of 16 rows x 8 NT columns and the depth over
// the block's 8 warps, whose partial sums the block adds in warp order: at
// B = 64 each of the model's products is 68-128 tiles, one round of the
// grid, with every weight read once.

#pragma once

#include <type_traits>

#include "fused_phases.cuh"
#include "train_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// LayerNorm and the RNN
// ---------------------------------------------------------------------------

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

constexpr int kRnnCols = 16;      // W_hh columns of a block's column unit
constexpr int kRnnKRegs = 32;     // W_hh rows a thread keeps: H <= 512
constexpr int kRnnPass = 16;      // streams of a pass

// column groups of rnn_groups_phase with CP columns a thread
__host__ __device__ constexpr int rnn_groups(int H, int CP = 1) {
  return (H + kRnnCols * CP - 1) / (kRnnCols * CP);
}

// shared memory of rnn_groups_phase with CP columns a thread, bytes
__host__ __device__ constexpr size_t rnn_groups_smem(int H, int CP = 1) {
  return (static_cast<size_t>(kRnnPass) * ((H + 3) / 4 * 4) +
          kRnnPass * 16 * kRnnCols * CP) *
         sizeof(float);
}

// The tanh RNN of B streams over T steps, each stream with its own gate:
//   h[b] <- gate(b, t) ? tanh(xin[row_of(b, t)] + round(h[b]) W_hh) : h[b],
// h[b] = 0 before step 0. K9 walks each window from its first row and
// freezes a stream after its k_last; K8 walks each stream's ring from the
// slot after the cursor, gated by the validity bits. hs: two (B, H) f32
// buffers; step t reads hs[t & 1] and writes hs[(t + 1) & 1], so the last
// hidden states are in hs + (T & 1) * B * H. The grid is cut into column
// groups of 16 CP columns of W_hh times stream groups of spb streams.
// Thread (c, kq) of a block, c = tid % 16, keeps columns c + 16 j (j < CP)
// at rows kq * kc .. kq * kc + kc - 1 (kc = H / 16 rounded up) in
// registers. A step takes the group's streams 16 at a time: their xin
// first, their previous hidden states (rounded to WT) staged in shared
// memory, a partial sum per (stream, kq, column) over the thread's rows,
// then thread (stream, c) adds the 16 partials of each of its columns in
// kq's order. CP = 2 halves what the blocks stage from L2 a step and
// doubles the products a staged value feeds; the sums do not depend on CP.
// One grid barrier a step; every block reaches every one. sm:
// rnn_groups_smem(H, CP) bytes. H <= 16 kRnnKRegs.
template <typename WT, int CP = 1, typename RowOf, typename Gate>
__device__ void rnn_groups_phase(cg::grid_group& grid, const float* xin,
                                 const WT* __restrict__ w_hh, int B, int T,
                                 int H, int spb, float* hs, float* sm,
                                 RowOf row_of, Gate gate) {
  constexpr int NC = kRnnCols * CP;   // columns of a block
  const int tid = threadIdx.x;
  const int n_cg = rnn_groups(H, CP);
  const int c0 = (blockIdx.x % n_cg) * NC;
  const int ncols = max(0, min(NC, H - c0));
  const int b_lo = (blockIdx.x / n_cg) * spb, b_hi = min(B, b_lo + spb);
  const int kc = (H + 15) / 16;
  const int c = tid % 16, kq = tid / 16;
  const int ldh = (H + 3) / 4 * 4;
  float* hsm = sm;                                  // [16][ldh]
  float* red = sm + kRnnPass * ldh;                 // [16 streams][16][NC]
  float wr[CP][kRnnKRegs];
#pragma unroll
  for (int j = 0; j < CP; ++j)
#pragma unroll
    for (int i = 0; i < kRnnKRegs; ++i) {
      const int k = kq * kc + i;
      wr[j][i] = i < kc && k < H && c + 16 * j < ncols
                     ? wload(w_hh + static_cast<size_t>(k) * H + c0 + c +
                             16 * j)
                     : 0.0f;
    }
  const bool vec4 = H % 4 == 0 && kc % 4 == 0;
  const int r_out = tid / 16;     // the stream this thread finishes
  const size_t BH = static_cast<size_t>(B) * H;
  // with one pass a step (spb <= 16), each step's xin is loaded ahead,
  // before the barrier of the step before
  const bool one_pass = b_hi - b_lo <= kRnnPass;
  const bool mine1 = r_out < b_hi - b_lo;
  const int b1 = b_lo + r_out;
  auto x_at = [&](int b, int t, int j) {
    return __ldcg(xin + static_cast<size_t>(row_of(b, t)) * H + c0 + c +
                  16 * j);
  };
  float x_next[CP];
#pragma unroll
  for (int j = 0; j < CP; ++j)
    x_next[j] = one_pass && mine1 && c + 16 * j < ncols ? x_at(b1, 0, j)
                                                        : 0.0f;
  for (int t = 0; t < T; ++t) {
    const float* h_prev = hs + (t & 1) * BH;
    float* h_next = hs + ((t + 1) & 1) * BH;
    for (int b0 = b_lo; b0 < b_hi; b0 += kRnnPass) {
      const int nb = min(kRnnPass, b_hi - b0);
      const int b = b0 + r_out;
      bool mine[CP];
      float xv[CP];
#pragma unroll
      for (int j = 0; j < CP; ++j) {
        mine[j] = r_out < nb && c + 16 * j < ncols;
        xv[j] = one_pass ? x_next[j] : (mine[j] ? x_at(b, t, j) : 0.0f);
      }
      const bool open = r_out < nb && gate(b, t);
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
      float part[kRnnPass][CP];
#pragma unroll
      for (int r = 0; r < kRnnPass; ++r)
#pragma unroll
        for (int j = 0; j < CP; ++j) part[r][j] = 0.0f;
      if (t > 0) {
        const float* hk = hsm + kq * kc;
        if (vec4) {
#pragma unroll
          for (int i = 0; i < kRnnKRegs; i += 4) {
            if (i < kc) {
#pragma unroll
              for (int r = 0; r < kRnnPass; ++r) {
                if (r < nb) {
                  const float4 h4 =
                      *reinterpret_cast<const float4*>(hk + r * ldh + i);
#pragma unroll
                  for (int j = 0; j < CP; ++j) {
                    part[r][j] = fmaf(h4.x, wr[j][i], part[r][j]);
                    part[r][j] = fmaf(h4.y, wr[j][i + 1], part[r][j]);
                    part[r][j] = fmaf(h4.z, wr[j][i + 2], part[r][j]);
                    part[r][j] = fmaf(h4.w, wr[j][i + 3], part[r][j]);
                  }
                }
              }
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < kRnnKRegs; ++i) {
            if (i < kc && kq * kc + i < H) {
#pragma unroll
              for (int r = 0; r < kRnnPass; ++r)
                if (r < nb) {
                  const float hv = hk[r * ldh + i];
#pragma unroll
                  for (int j = 0; j < CP; ++j)
                    part[r][j] = fmaf(hv, wr[j][i], part[r][j]);
                }
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRnnPass; ++r)
        if (r < nb)
#pragma unroll
          for (int j = 0; j < CP; ++j)
            red[(r * 16 + kq) * NC + c + 16 * j] = part[r][j];
      __syncthreads();
#pragma unroll
      for (int j = 0; j < CP; ++j) {
        if (!mine[j]) continue;
        float sum = 0.0f;
        for (int q = 0; q < 16; ++q)
          sum += red[(r_out * 16 + q) * NC + c + 16 * j];
        const size_t at = static_cast<size_t>(b) * H + c0 + c + 16 * j;
        h_next[at] = open ? tanhf(xv[j] + sum)
                          : (t > 0 ? __ldcg(h_prev + at) : 0.0f);
      }
    }
    if (one_pass && mine1 && t + 1 < T) {
#pragma unroll
      for (int j = 0; j < CP; ++j)
        if (c + 16 * j < ncols) x_next[j] = x_at(b1, t + 1, j);
    }
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
// input_fix), plain loads, or cp.async (A's and W's rows take 16-byte
// copies)
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

// A slice staged with plain loads, zeros past M, N, K: A (f32 or the
// packing dtype AT, rows lda apart; zero0 >= 0 marks the raw model input,
// through input_fix) in tf3's layout, W ((K, N) in WT) as f32 (TF32) or as
// bf16 (the bf16 products)
template <typename WT, bool TF32, class L, typename AT = float>
__device__ __forceinline__ void load_plain_stage(
    float* As, float* Bs, const AT* A, int lda, const WT* __restrict__ W,
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
template <typename WT, bool TF32, class L, typename AT = float>
__device__ void plain_tile(const AT* A, int lda, const WT* __restrict__ W,
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
    load_plain_stage<WT, TF32, L, AT>(sm, sm + A_FLOATS, A, lda, W, M, N, K,
                                      m0, n0, k0, zero0);
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
// mode: ProductMode (kProdAsync needs an f32 A). A (f32, or a ring in the
// packing dtype AT) and res may have been written by other blocks in the
// phase before (read through L2); W and bias are the packed weights.
template <typename WT, class L, typename AT = float>
__device__ void tc_product_phase(const AT* A, int lda, int M, int K,
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
      plain_tile<WT, true, L, AT>(A, lda, W, M, N, K, m0, n0, zero0, sm, acc,
                                  wm, wn, g, q);
    } else if constexpr (sizeof(WT) == sizeof(float)) {
      if constexpr (std::is_same<AT, float>::value) {
        if (mode == kProdAsync) {
          tf3::mma_tile<false, false, L, true>(A, W, M, N, lda, N, m0, n0, 0,
                                               K, sm, acc);
        } else {
          plain_tile<WT, true, L, AT>(A, lda, W, M, N, K, m0, n0, -1, sm,
                                      acc, wm, wn, g, q);
        }
      } else {
        plain_tile<WT, true, L, AT>(A, lda, W, M, N, K, m0, n0, -1, sm, acc,
                                    wm, wn, g, q);
      }
    } else {
      if constexpr (std::is_same<AT, float>::value) {
        if (mode == kProdAsync) {
          bf16_tile<L>(A, W, M, N, K, lda, m0, n0, sm, acc, wm, wn, g, q);
        } else {
          plain_tile<WT, false, L, AT>(A, lda, W, M, N, K, m0, n0, -1, sm,
                                       acc, wm, wn, g, q);
        }
      } else {
        plain_tile<WT, false, L, AT>(A, lda, W, M, N, K, m0, n0, -1, sm, acc,
                                     wm, wn, g, q);
      }
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
            if (act == kActTanh) v = tanhf(v);
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

// a product of many rows (an encoder pass, a pool's ring rows): the tile
// by N, and for N > 256 the row count that takes fewer rounds of the grid
template <typename WT, typename AT = float>
__device__ void product(const AT* A, int lda, int M, int K, const WT* W,
                        const WT* bias, int N, const float* res, float* out,
                        int act, int mode, int zero0, float* sm,
                        int ldo = 0) {
  if (N <= 256)
    tc_product_phase<WT, NarrowTile, AT>(A, lda, M, K, W, bias, N, res, out,
                                         ldo, act, mode, zero0, sm);
  else if (tile_cost(M, N, 64, 128) <= tile_cost(M, N, 80, 128))
    tc_product_phase<WT, WideTile, AT>(A, lda, M, K, W, bias, N, res, out,
                                       ldo, act, mode, zero0, sm);
  else
    tc_product_phase<WT, Wide80Tile, AT>(A, lda, M, K, W, bias, N, res, out,
                                         ldo, act, mode, zero0, sm);
}

constexpr size_t max_bytes(size_t a, size_t b) { return a > b ? a : b; }

// shared memory of product's stages, bytes
constexpr size_t product_smem() {
  return max_bytes(
      max_bytes(tf3::Stage<false, false, NarrowTile>::BYTES,
                tf3::Stage<false, false, WideTile>::BYTES),
      max_bytes(tf3::Stage<false, false, Wide80Tile>::BYTES,
                max_bytes(Bf16Stage<Wide80Tile>::BYTES,
                          Bf16Stage<WideTile>::BYTES)));
}

// ---------------------------------------------------------------------------
// products of few rows: the depth split over the warps
// ---------------------------------------------------------------------------

constexpr int kSplitRows = 16;                 // rows of a split tile
constexpr int kSplitDepth = kWarps * tf3::BK;  // depth of one stage

// a warp's 16 x 8 NT outputs over one 32-deep slice: tf3's layout
template <int NT>
using SplitWarp = tf3::Tile<8 * NT, 1, 1, kSplitRows>;

// floats of one stage: a 32-deep slice of A (16 rows) and of W (8 NT
// columns) for each of the 8 warps, W in WT
template <typename WT, int NT>
__host__ __device__ constexpr int split_stage_floats() {
  return kWarps * (tf3::Stage<false, false, SplitWarp<NT>>::A_FLOATS +
                   (sizeof(WT) == sizeof(float)
                        ? tf3::Stage<false, false, SplitWarp<NT>>::B_FLOATS
                        : Bf16Stage<SplitWarp<NT>>::B_FLOATS));
}

constexpr int kSplitMaxNT = 8;

// shared memory of split_product, bytes: two stages of the widest tile
template <typename WT>
__host__ __device__ constexpr size_t split_smem() {
  return 2 * sizeof(float) * split_stage_floats<WT, kSplitMaxNT>();
}

// Stage the 8 slices of depth k0 .. k0 + 256 of a split tile: warp w's
// slice k0 + 32 w .. of A's rows m0.. (16) and W's columns n0.. (8 NT),
// zeros past M, N, K. a_async: A's rows by cp.async (f32, 16-byte rows);
// else plain loads (A in f32 or the packing dtype; zero0 >= 0: the raw
// model input, through input_fix). w_async: W's rows by cp.async.
template <typename WT, int NT, typename AT>
__device__ __forceinline__ void split_stage(float* st, const AT* A, int lda,
                                            const WT* __restrict__ W, int M,
                                            int N, int K, int m0, int n0,
                                            int k0, bool a_async,
                                            bool w_async, int zero0) {
  using L = SplitWarp<NT>;
  using S = tf3::Stage<false, false, L>;
  constexpr int BK = tf3::BK, BN = L::BN;
  constexpr bool kF32 = sizeof(WT) == sizeof(float);
  constexpr int B_LD = kF32 ? S::B_LD : Bf16Stage<L>::B_LD;
  constexpr int B_FLOATS = kF32 ? S::B_FLOATS : Bf16Stage<L>::B_FLOATS;
  float* As = st;                                   // [8][16][BK + 4]
  float* Bs = st + kWarps * S::A_FLOATS;            // [8][BK][B_LD]
  if constexpr (std::is_same<AT, float>::value) {
    if (a_async) {
      for (int e = threadIdx.x; e < kWarps * kSplitRows * (BK / 4);
           e += kThreads) {
        const int w = e / (kSplitRows * (BK / 4));
        const int r = (e / (BK / 4)) % kSplitRows, q = e % (BK / 4);
        const int gm = m0 + r, gk = k0 + w * BK + 4 * q;
        const bool v = gm < M && gk < K;
        tf3::cp16(As + w * S::A_FLOATS + r * S::A_LD + 4 * q,
                  v ? A + static_cast<size_t>(gm) * lda + gk : A, v);
      }
    }
  }
  if (!std::is_same<AT, float>::value || !a_async) {
    for (int e = threadIdx.x; e < kWarps * kSplitRows * BK; e += kThreads) {
      const int w = e / (kSplitRows * BK);
      const int r = (e / BK) % kSplitRows, kk = e % BK;
      const int gm = m0 + r, gk = k0 + w * BK + kk;
      float v = 0.0f;
      if (gm < M && gk < K) {
        v = aload(A + static_cast<size_t>(gm) * lda + gk);
        if (zero0 >= 0) v = input_fix(v, gk, zero0);
      }
      As[w * S::A_FLOATS + r * S::A_LD + kk] = v;
    }
  }
  constexpr int per16 = 16 / sizeof(WT);            // W values a copy
  if (w_async && BN % per16 == 0) {
    for (int e = threadIdx.x; e < kSplitDepth * (BN / per16);
         e += kThreads) {
      const int kk = e / (BN / per16), c = e % (BN / per16);
      const int w = kk / BK, gk = k0 + kk, gn = n0 + per16 * c;
      const bool v = gk < K && gn < N;
      WT* dst = reinterpret_cast<WT*>(Bs + w * B_FLOATS) +
                (kk % BK) * B_LD + per16 * c;
      tf3::cp16(reinterpret_cast<float*>(dst),
                reinterpret_cast<const float*>(
                    v ? W + static_cast<size_t>(gk) * N + gn : W),
                v);
    }
  } else {
    for (int e = threadIdx.x; e < kSplitDepth * BN; e += kThreads) {
      const int kk = e / BN, nn = e % BN;
      const int w = kk / BK, gk = k0 + kk, gn = n0 + nn;
      const bool v = gk < K && gn < N;
      const size_t o = static_cast<size_t>(gk) * N + gn;
      if (kF32) {
        Bs[w * B_FLOATS + (kk % BK) * B_LD + nn] = v ? wload(W + o) : 0.0f;
      } else {
        reinterpret_cast<unsigned short*>(Bs + w * B_FLOATS)
            [(kk % BK) * B_LD + nn] =
                v ? __ldg(reinterpret_cast<const unsigned short*>(W) + o)
                  : static_cast<unsigned short>(0);
      }
    }
  }
}

// out (M, N), row r at out + r * ldo (ldo 0: N), = act(A (M, K) W (K, N) +
// bias [+ res (M, N)]) for few rows: tiles of 16 rows x 8 NT columns, a
// block a tile; the depth in stages of 256, warp w the 32-deep slice w of
// each (3xTF32 with the f32 step sums for f32 packing, bf16 mma.sync for
// bf16), double buffered; then the 8 warps' sums added in warp order, the
// same bits whatever the grid. mode: ProductMode (kProdAsync: A f32 with
// 16-byte rows by cp.async; kProdIn or kProdAsync: W by cp.async where its
// rows are 16-byte aligned; kProdPlain: plain loads). zero0 >= 0: A is the
// raw model input, staged through input_fix.
template <typename WT, int NT, typename AT>
__device__ void split_tiles(const AT* A, int lda, int M, int K,
                            const WT* __restrict__ W,
                            const WT* __restrict__ bias, int N,
                            const float* res, float* out, int ldo, int act,
                            int mode, int zero0, float* sm) {
  using L = SplitWarp<NT>;
  constexpr int BN = L::BN;
  constexpr int kStage = split_stage_floats<WT, NT>();
  constexpr bool kF32 = sizeof(WT) == sizeof(float);
  if (ldo == 0) ldo = N;
  const int n_mt = (M + kSplitRows - 1) / kSplitRows;
  const int n_nt = (N + BN - 1) / BN;
  const int ns = (K + kSplitDepth - 1) / kSplitDepth;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, q = lane & 3;
  const bool a_async = mode == kProdAsync && zero0 < 0;
  const bool w_async = mode != kProdPlain &&
                       (N * static_cast<int>(sizeof(WT))) % 16 == 0;
  const int zf = zero0;
  for (int tile = blockIdx.x; tile < n_mt * n_nt; tile += gridDim.x) {
    const int m0 = (tile % n_mt) * kSplitRows, n0 = (tile / n_mt) * BN;
    float acc[1][NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[0][j][r] = 0.0f;
    split_stage<WT, NT, AT>(sm, A, lda, W, M, N, K, m0, n0, 0, a_async,
                            w_async, zf);
    tf3::cp_commit();
    for (int s = 0; s < ns; ++s) {
      if (s + 1 < ns) {
        split_stage<WT, NT, AT>(sm + ((s + 1) & 1) * kStage, A, lda, W, M, N,
                                K, m0, n0, (s + 1) * kSplitDepth, a_async,
                                w_async, zf);
        tf3::cp_commit();
        tf3::cp_wait<1>();
      } else {
        tf3::cp_wait<0>();
      }
      __syncthreads();            // stage s has landed for every thread
      const float* st = sm + (s & 1) * kStage;
      const float* As =
          st + warp * tf3::Stage<false, false, L>::A_FLOATS;
      const float* Bs = st + kWarps * tf3::Stage<false, false, L>::A_FLOATS;
      if constexpr (kF32) {
        tf3::mma_slice<false, false, L, true>(
            As, Bs + warp * tf3::Stage<false, false, L>::B_FLOATS, acc, 0, 0,
            g, q);
      } else {
        bf16_slice<L>(As,
                      reinterpret_cast<const unsigned short*>(
                          Bs + warp * Bf16Stage<L>::B_FLOATS),
                      acc, 0, 0, g, q);
      }
      __syncthreads();            // stage s is free for stage s + 2
    }
    // the warps' sums, then their total in warp order and the epilogue
    float* red = sm;              // [8][16][BN]
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        red[(warp * kSplitRows + g + 8 * (r >> 1)) * BN + nt * 8 + 2 * q +
            (r & 1)] = acc[0][nt][r];
    __syncthreads();
    for (int e = threadIdx.x; e < kSplitRows * BN; e += kThreads) {
      const int row = m0 + e / BN, col = n0 + e % BN;
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += red[w * kSplitRows * BN + e];
      if (row < M && col < N) {
        v = v + (bias != nullptr ? wload(bias + col) : 0.0f);
        if (res != nullptr)
          v = __ldcg(res + static_cast<size_t>(row) * N + col) + v;
        if (act == kActRelu) v = fmaxf(v, 0.0f);
        if (act == kActTanh) v = tanhf(v);
        out[static_cast<size_t>(row) * ldo + col] = v;
      }
    }
    __syncthreads();              // sm is staged again by the next tile
  }
}

// the column count of split_product's tiles: 8 NT, NT the smallest of 1,
// 2, 4, 8 that takes the fewest rounds of the grid (more tiles of less
// work each, as long as they fit in a round)
__device__ __forceinline__ int split_nt(int M, int N) {
  int best = 1, best_rounds = 0x7fffffff;
  for (int nt = 1; nt <= kSplitMaxNT; nt *= 2) {
    const int tiles =
        ((M + kSplitRows - 1) / kSplitRows) * ((N + 8 * nt - 1) / (8 * nt));
    const int rounds = (tiles + gridDim.x - 1) / gridDim.x;
    if (rounds < best_rounds) {
      best = nt;
      best_rounds = rounds;
    }
  }
  return best;
}

template <typename WT, typename AT = float>
__device__ void split_product(const AT* A, int lda, int M, int K,
                              const WT* W, const WT* bias, int N,
                              const float* res, float* out, int ldo, int act,
                              int mode, int zero0, float* sm) {
  switch (split_nt(M, N)) {
    case 1:
      split_tiles<WT, 1, AT>(A, lda, M, K, W, bias, N, res, out, ldo, act,
                             mode, zero0, sm);
      break;
    case 2:
      split_tiles<WT, 2, AT>(A, lda, M, K, W, bias, N, res, out, ldo, act,
                             mode, zero0, sm);
      break;
    case 4:
      split_tiles<WT, 4, AT>(A, lda, M, K, W, bias, N, res, out, ldo, act,
                             mode, zero0, sm);
      break;
    default:
      split_tiles<WT, 8, AT>(A, lda, M, K, W, bias, N, res, out, ldo, act,
                             mode, zero0, sm);
  }
}

}  // namespace
