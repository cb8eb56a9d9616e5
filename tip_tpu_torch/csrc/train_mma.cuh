// Tensor-core f32 products of K12 (encoder_train.cu, the encoder layer's
// backward and the forward it recomputes) at about f32 accuracy: 3xTF32.
//
// gemm: C (M, N) = op(A) op(B) over K, op a transpose or not, with
// train_gemm.cuh's fused epilogues (tg::Epi). Each f32 operand x is split
// in registers into a TF32 high part hi (x with its 13 low mantissa bits
// cleared) and the residual lo = x - hi, exact in f32, of which the tensor
// cores read the TF32 part (they ignore an operand's 13 low bits); C
// accumulates a_lo b_hi + a_hi b_lo + a_hi b_hi in f32 (a_lo b_lo lies
// below f32's rounding). One TF32 product keeps 11 bits of each operand;
// the three keep about f32's 24 less two (a relative error under 2^-20 a
// product). Splitting with cvt.rna.tf32.f32 twice instead keeps a bit more
// and costs 12% of K12's time on the card (the split is done for every
// fragment a warp loads, and the conversions, not the mma, bound the
// loop).
//
// Instruction: mma.sync.aligned.m16n8k8 in TF32. Hopper's wgmma takes TF32
// operands only K-major from shared memory, and K12 needs the NN (its
// forward), NT (the input gradients) and TN (the weight gradients)
// products; mma.sync takes its fragments from registers, so each product
// stages its tiles in the layout it finds in memory and the split is done
// on the fragments.
//
// Tiles: 128 x BN outputs a block, BN 128, or 64 where N <= 256 (so that
// the N = 256 products give the card more blocks), cut among the warps of
// the block (Tile); A and B in slices 32 deep, staged by cp.async through
// a 3-stage pipeline (105 KB of shared memory at most: two blocks an SM).
// The block's part is a __device__ routine (mma_tile, over mma_slice), so
// that a block of another launch can take tiles of its own (K9,
// fused_recompute_batch.cu, with 64-row tiles: Tile's fourth parameter).
// Shared rows are padded so that the fragment loads of a warp hit 32
// banks. Rows and columns past M, N, K are zero-filled by the copies; the
// dimension a copy runs along (and every row stride) must be a multiple
// of 4 floats and the operands 16-byte aligned.
//
// Weight gradients are reductions over the B*T rows: split into chunks of
// rows whose partial products a second pass adds in a fixed order
// (tg::sum_splits_kernel). No atomics: two calls give the same bits.
//
// pack_bf16 and mma_bf16 below are the bf16 fragments and m16n8k16 mma
// that encoder_train.cu's bf16 attention uses. The bf16 encoder layer's
// products (K11 bf16, K12 bf16) and K10 bf16's dW run on wgmma from bf16
// tiles, bf16_gemm.cuh.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "train_gemm.cuh"

namespace tf3 {

constexpr int BM = 128, BK = 32, kStages = 3;
constexpr int kTargetBlocks = 264;   // two blocks per SM of an H100

// a block's BM x BN outputs (BM 128 unless given) cut among WM x WN warps
template <int BN_, int WM, int WN, int BM_ = BM>
struct Tile {
  static constexpr int BM = BM_;
  static constexpr int BN = BN_;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int TM = BM / WM;   // rows of a warp
  static constexpr int TN = BN / WN;   // columns of a warp
  static constexpr int MT = TM / 16, NT = TN / 8;
};
using WideTile = Tile<128, 2, 4>;     // N > 256
using NarrowTile = Tile<64, 4, 2>;    // N <= 256

// one pipeline stage: A then B, each in the layout of its memory
template <bool TA, bool TB, class L>
struct Stage {
  static constexpr int BM = L::BM, BN = L::BN;
  static constexpr int A_LD = TA ? BM + 8 : BK + 4;
  static constexpr int A_FLOATS = TA ? BK * (BM + 8) : BM * (BK + 4);
  static constexpr int B_LD = TB ? BK + 4 : BN + 8;
  static constexpr int B_FLOATS = TB ? BN * (BK + 4) : BK * (BN + 8);
  static constexpr int FLOATS = A_FLOATS + B_FLOATS;
  static constexpr size_t BYTES = sizeof(float) * kStages * FLOATS;
};

__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;   // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// two f32 values rounded to bf16 and packed, lo in the low half (the
// first of a fragment's pair)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t u;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(u) : "f"(hi), "f"(lo));
  return u;
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// stage the slice k0 .. k0 + BK of A's rows m0.. and B's columns n0..
// kShiftA (A stored (K, M)): row k of A is stored row k - 1, and zero
// where k is a multiple of a_period (K10's h_{t-1}, windows of a_period
// rows)
template <bool TA, bool TB, class L, bool kShiftA = false>
__device__ __forceinline__ void load_stage(float* As, float* Bs,
                                           const float* __restrict__ A,
                                           const float* __restrict__ B,
                                           int M, int N, int lda, int ldb,
                                           int m0, int n0, int k0, int k_end,
                                           int tid, int a_period = 0) {
  static_assert(TA || !kShiftA, "a shifted A is stored (K, M)");
  using S = Stage<TA, TB, L>;
  constexpr int BM = L::BM, BN = L::BN, kThreads = L::THREADS;
  if (!TA) {   // A (M, K): BK / 4 copies a row
    for (int e = tid; e < BM * (BK / 4); e += kThreads) {
      const int mm = e / (BK / 4), q = e % (BK / 4);
      const int gm = m0 + mm, gk = k0 + 4 * q;
      const bool v = gm < M && gk < k_end;
      cp16(As + mm * S::A_LD + 4 * q,
           v ? A + static_cast<size_t>(gm) * lda + gk : A, v);
    }
  } else {     // A stored (K, M): BM / 4 copies a row of K
    for (int e = tid; e < BK * (BM / 4); e += kThreads) {
      const int kk = e / (BM / 4), q = e % (BM / 4);
      const int gk = k0 + kk, gm = m0 + 4 * q;
      const bool v = gk < k_end && gm < M && (!kShiftA || gk % a_period);
      const int sk = kShiftA ? gk - 1 : gk;
      cp16(As + kk * S::A_LD + 4 * q,
           v ? A + static_cast<size_t>(sk) * lda + gm : A, v);
    }
  }
  if (!TB) {   // B (K, N): BN / 4 copies a row of K
    for (int e = tid; e < BK * (BN / 4); e += kThreads) {
      const int kk = e / (BN / 4), q = e % (BN / 4);
      const int gk = k0 + kk, gn = n0 + 4 * q;
      const bool v = gk < k_end && gn < N;
      cp16(Bs + kk * S::B_LD + 4 * q,
           v ? B + static_cast<size_t>(gk) * ldb + gn : B, v);
    }
  } else {     // B stored (N, K): BK / 4 copies a row
    for (int e = tid; e < BN * (BK / 4); e += kThreads) {
      const int nn = e / (BK / 4), q = e % (BK / 4);
      const int gn = n0 + nn, gk = k0 + 4 * q;
      const bool v = gn < N && gk < k_end;
      cp16(Bs + nn * S::B_LD + 4 * q,
           v ? B + static_cast<size_t>(gn) * ldb + gk : B, v);
    }
  }
}

// The three products of an 8-deep step summed from 0 and added to acc in
// f32 (mma_slice's kPromote)
template <int NT>
__device__ __forceinline__ void mma3_promoted(float (&acc)[NT][4],
                                              const uint32_t* ah,
                                              const uint32_t* al,
                                              const uint32_t (&bh)[NT][2],
                                              const uint32_t (&bl)[NT][2]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma(t, al, bh[nt]);
    mma(t, ah, bl[nt]);
    mma(t, ah, bh[nt]);
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nt][r] += t[r];
  }
}

// The products of one staged slice, As and Bs, added to a warp's
// fragments acc: the warp (wm, wn) of the block, thread (g, q) of its
// fragments. The tensor cores add a product to the sum they are given
// with a rounding toward zero, an error that grows with the count of
// products a sum takes; kPromote sums each 8-deep step's three products
// from 0 and adds them to acc in f32 (round to nearest), which keeps the
// error of a long K near that of f32 sums (K12 sums straight into acc).
template <bool TA, bool TB, class L, bool kPromote = false>
__device__ __forceinline__ void mma_slice(const float* As, const float* Bs,
                                          float (&acc)[L::MT][L::NT][4],
                                          int wm, int wn, int g, int q) {
  using S = Stage<TA, TB, L>;
  using W = L;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 8) {
    uint32_t bh[W::NT][2], bl[W::NT][2];
#pragma unroll
    for (int nt = 0; nt < W::NT; ++nt) {
      const int n = wn * W::TN + nt * 8 + g;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int k = kk + q + 4 * r;
        split(TB ? Bs[n * S::B_LD + k] : Bs[k * S::B_LD + n], bh[nt][r],
              bl[nt][r]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < W::MT; ++mt) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {   // rows g, g+8; columns q, q+4
        const int m = wm * W::TM + mt * 16 + g + 8 * (r & 1);
        const int k = kk + q + 4 * (r >> 1);
        split(TA ? As[k * S::A_LD + m] : As[m * S::A_LD + k], ah[r], al[r]);
      }
      if (kPromote) {
        mma3_promoted<W::NT>(acc[mt], ah, al, bh, bl);
        continue;
      }
#pragma unroll
      for (int nt = 0; nt < W::NT; ++nt) {
        mma(acc[mt][nt], al, bh[nt]);
        mma(acc[mt][nt], ah, bl[nt]);
        mma(acc[mt][nt], ah, bh[nt]);
      }
    }
  }
}

// One block's BM x BN tile of op(A) op(B) at rows m0.., columns n0.., over
// rows k_begin .. k_end of K (a multiple of BK apart from the operands'
// start): acc gets the sums in the fragments' layout (warp wm = warp %
// (BM / TM), wn = warp / (BM / TM); piece (mt, nt) holds rows g, g+8 and
// columns 2q, 2q+1 of its 16 x 8 outputs). sm: Stage<TA, TB, L>::BYTES.
// Every thread of the block calls it; a caller that stages again into sm
// syncs the block first. kPromote: as mma_slice's.
// A logical (M, K): stored (M, K) with row stride lda, or (K, M) if TA.
// B logical (K, N): stored (K, N) with row stride ldb, or (N, K) if TB.
// kShiftA, a_period: as load_stage's.
template <bool TA, bool TB, class L, bool kPromote = false,
          bool kShiftA = false>
__device__ __forceinline__ void mma_tile(const float* __restrict__ A,
                                         const float* __restrict__ B, int M,
                                         int N, int lda, int ldb, int m0,
                                         int n0, int k_begin, int k_end,
                                         float* sm,
                                         float (&acc)[L::MT][L::NT][4],
                                         int a_period = 0) {
  using S = Stage<TA, TB, L>;
  using W = L;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, q = lane & 3;   // the fragments' group, thread
  const int wm = warp % (L::BM / W::TM), wn = warp / (L::BM / W::TM);
  const int nk = (k_end - k_begin + BK - 1) / BK;

#pragma unroll
  for (int i = 0; i < W::MT; ++i)
#pragma unroll
    for (int j = 0; j < W::NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      load_stage<TA, TB, L, kShiftA>(sm + s * S::FLOATS,
                                      sm + s * S::FLOATS + S::A_FLOATS, A, B,
                                      M, N, lda, ldb, m0, n0,
                                      k_begin + s * BK, k_end, tid,
                                      a_period);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<kStages - 2>();   // slice kt has landed
    __syncthreads();          // ... for every thread; slice kt-1 is done
    const int nxt = kt + kStages - 1;
    if (nxt < nk) {
      float* st = sm + (nxt % kStages) * S::FLOATS;
      load_stage<TA, TB, L, kShiftA>(st, st + S::A_FLOATS, A, B, M, N, lda,
                                      ldb, m0, n0, k_begin + nxt * BK, k_end,
                                      tid, a_period);
    }
    cp_commit();
    const float* As = sm + (kt % kStages) * S::FLOATS;
    mma_slice<TA, TB, L, kPromote>(As, As + S::A_FLOATS, acc, wm, wn, g, q);
  }
  cp_wait<0>();
}

// blockIdx.z takes rows [z * kchunk, (z + 1) * kchunk) of K (kchunk a
// multiple of BK) and writes its partial product to C + z * M * N.
template <bool TA, bool TB, int EPI, class L>
__global__ void __launch_bounds__(L::THREADS, 2)
mma_kernel(const float* __restrict__ A, const float* __restrict__ B,
           float* __restrict__ C, int M, int N, int K, int lda, int ldb,
           int kchunk, tg::EpiArgs ep) {
  using W = L;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, q = lane & 3;
  const int wm = warp % (L::BM / W::TM), wn = warp / (L::BM / W::TM);
  const int m0 = blockIdx.y * L::BM, n0 = blockIdx.x * L::BN;
  const int k_begin = blockIdx.z * kchunk;
  const int k_end = min(K, k_begin + kchunk);
  float acc[W::MT][W::NT][4];
  mma_tile<TA, TB, L>(A, B, M, N, lda, ldb, m0, n0, k_begin, k_end, sm,
                      acc);

  float* Cz = C + static_cast<size_t>(blockIdx.z) * M * N;
#pragma unroll
  for (int mt = 0; mt < W::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < W::NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {   // rows g, g+8; columns 2q, 2q+1
        const int gm = m0 + wm * W::TM + mt * 16 + g + 8 * (r >> 1);
        const int gn = n0 + wn * W::TN + nt * 8 + 2 * q + (r & 1);
        if (gm < M && gn < N)
          tg::epilogue<EPI>(acc[mt][nt][r], gm, gn, N, ep, Cz);
      }
}

template <bool TA, bool TB, int EPI, class L>
inline void launch(const float* A, const float* B, float* C, int M, int N,
                   int K, int lda, int ldb, tg::EpiArgs ep, cudaStream_t st,
                   int kchunk, int splits) {
  constexpr size_t smem = Stage<TA, TB, L>::BYTES;
  // once per process and instantiation; a refusal shows at the launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      mma_kernel<TA, TB, EPI, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  (void)attr;
  dim3 grid((N + L::BN - 1) / L::BN, (M + L::BM - 1) / L::BM, splits);
  mma_kernel<TA, TB, EPI, L><<<grid, L::THREADS, smem, st>>>(
      A, B, C, M, N, K, lda, ldb, kchunk, ep);
}

inline int tile_n(int N) { return N <= 256 ? NarrowTile::BN : WideTile::BN; }

template <bool TA, bool TB, int EPI>
inline void gemm(const float* A, const float* B, float* C, int M, int N,
                 int K, int lda, int ldb, tg::EpiArgs ep, cudaStream_t st,
                 int kchunk = 0, int splits = 1) {
  if (kchunk <= 0) kchunk = K;
  if (N <= 256)
    launch<TA, TB, EPI, NarrowTile>(A, B, C, M, N, K, lda, ldb, ep, st,
                                    kchunk, splits);
  else
    launch<TA, TB, EPI, WideTile>(A, B, C, M, N, K, lda, ldb, ep, st, kchunk,
                                  splits);
}

// How a reduction over K rows into an (M, N) result is split: enough
// chunks of rows (a multiple of BK, at least 256 each) to give the card
// about kTargetBlocks blocks. Depends on the shapes only, so the order of
// the sums does too.
inline tg::Split split_plan(int M, int N, int K) {
  const int bn = tile_n(N);
  const int tiles = ((M + BM - 1) / BM) * ((N + bn - 1) / bn);
  int s = (kTargetBlocks + tiles - 1) / tiles;
  const int most = (K + 255) / 256;
  if (s > most) s = most;
  if (s < 1) s = 1;
  int kchunk = (K + s - 1) / s;
  kchunk = ((kchunk + BK - 1) / BK) * BK;
  return tg::Split{kchunk, (K + kchunk - 1) / kchunk};
}

// Scratch floats of a split reduction into an (M, N) result.
inline size_t wgrad_scratch(int M, int N, int K) {
  const tg::Split p = split_plan(M, N, K);
  return p.splits > 1 ? static_cast<size_t>(p.splits) * M * N : 0;
}

// out (M, N) = A^T B over the K rows of A (K, M) and B (K, N): a weight
// gradient. `part`: wgrad_scratch(M, N, K) floats.
inline void wgrad(const float* A, const float* B, float* out, int M, int N,
                  int K, float* part, cudaStream_t st) {
  const tg::Split p = split_plan(M, N, K);
  if (p.splits == 1) {
    tf3::gemm<true, false, tg::E_STORE>(A, B, out, M, N, K, M, N,
                                        tg::EpiArgs{}, st);
    return;
  }
  tf3::gemm<true, false, tg::E_STORE>(A, B, part, M, N, K, M, N,
                                      tg::EpiArgs{}, st, p.kchunk, p.splits);
  const int n = M * N;
  tg::sum_splits_kernel<<<(n + 255) / 256, 256, 0, st>>>(part, out, n,
                                                          p.splits);
}

}  // namespace tf3
