// Hand-written f32 products and column sums of the training kernels: the
// products of K10 (fused_rnn_bwd.cu, its dW), the epilogues and column
// sums of K11 and K12 (encoder_train.cu, whose products are
// train_mma.cuh's).
//
// gemm: C (M, N) = op(A) op(B) over K, op a transpose or not, with a fused
// epilogue (bias, ReLU + dropout mask, dReLU + mask, residual add). 64x64
// output tiles, 16-deep slices of A and B staged in shared memory, 256
// threads of 4x4 outputs, fmaf sums in K order: the CUDA cores at f32, no
// tensor cores. Reductions over the B*T rows (weight and bias gradients)
// are split over the rows into partial sums that a second pass adds in a
// fixed order: no float atomics, so two calls give the same bits.

#pragma once

#include <cuda_runtime.h>

#include "hashmask.cuh"

namespace tg {

constexpr int BM = 64, BN = 64, BK = 16;
constexpr int kTargetBlocks = 264;   // two blocks per SM of an H100

enum Epi { E_STORE = 0, E_BIAS = 1, E_BIAS_RELU_DROP = 2, E_DRELU_DROP = 3,
           E_ADD = 4 };

struct EpiArgs {
  const float* bias;   // E_BIAS, E_BIAS_RELU_DROP: (N,)
  const float* aux;    // E_DRELU_DROP: the ReLU output; E_ADD: the residual
  float* out2;         // E_BIAS_RELU_DROP: the masked copy
  hm::Drop drop;       // E_BIAS_RELU_DROP, E_DRELU_DROP
};

// Output (gm, gn) of an (M, N) result whose product sum is v, through the
// epilogue EPI, stored to C (the aux and out2 arrays are (M, N) too).
template <int EPI>
__device__ __forceinline__ void epilogue(float v, int gm, int gn, int N,
                                         const EpiArgs& ep, float* C) {
  const size_t o = static_cast<size_t>(gm) * N + gn;
  if (EPI == E_BIAS) {
    v = v + ep.bias[gn];
  } else if (EPI == E_BIAS_RELU_DROP) {
    v = fmaxf(v + ep.bias[gn], 0.0f);
    ep.out2[o] = v * hm::drop_at(ep.drop, gm, gn, N);
  } else if (EPI == E_DRELU_DROP) {
    v = v * hm::drop_at(ep.drop, gm, gn, N);
    v = v * (ep.aux[o] > 0.0f ? 1.0f : 0.0f);
  } else if (EPI == E_ADD) {
    v = ep.aux[o] + v;
  }
  C[o] = v;
}

// A logical (M, K): stored (M, K) with row stride lda, or (K, M) if TA.
// B logical (K, N): stored (K, N) with row stride ldb, or (N, K) if TB.
// blockIdx.z takes rows [z * kchunk, (z + 1) * kchunk) of K and writes its
// partial product to C + z * M * N.
template <bool TA, bool TB, int EPI>
__global__ void __launch_bounds__(256)
gemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
            float* __restrict__ C, int M, int N, int K, int lda, int ldb,
            int kchunk, EpiArgs ep) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * kchunk;
  const int k_end = min(K, k_begin + kchunk);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int e = tid; e < BM * BK; e += 256) {
      int mm, kk;
      if (TA) { kk = e / BM; mm = e % BM; } else { mm = e / BK; kk = e % BK; }
      const int gm = m0 + mm, gk = k0 + kk;
      float v = 0.0f;
      if (gm < M && gk < k_end)
        v = TA ? A[static_cast<size_t>(gk) * lda + gm]
               : A[static_cast<size_t>(gm) * lda + gk];
      As[kk][mm] = v;
    }
    for (int e = tid; e < BN * BK; e += 256) {
      int nn, kk;
      if (TB) { nn = e / BK; kk = e % BK; } else { kk = e / BN; nn = e % BN; }
      const int gn = n0 + nn, gk = k0 + kk;
      float v = 0.0f;
      if (gn < N && gk < k_end)
        v = TB ? B[static_cast<size_t>(gn) * ldb + gk]
               : B[static_cast<size_t>(gk) * ldb + gn];
      Bs[kk][nn] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* Cz = C + static_cast<size_t>(blockIdx.z) * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) epilogue<EPI>(acc[i][j], gm, gn, N, ep, Cz);
    }
  }
}

template <bool TA, bool TB, int EPI>
inline void gemm(const float* A, const float* B, float* C, int M, int N,
                 int K, int lda, int ldb, EpiArgs ep, cudaStream_t st,
                 int kchunk = 0, int splits = 1) {
  if (kchunk <= 0) kchunk = K;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  gemm_kernel<TA, TB, EPI><<<grid, 256, 0, st>>>(A, B, C, M, N, K, lda, ldb,
                                                 kchunk, ep);
}

// How a reduction over K rows into an (M, N) result is split: `splits`
// chunks of `kchunk` rows (a multiple of BK), enough chunks to give the
// card about kTargetBlocks blocks, at least 256 rows each. Depends on the
// shapes only, so the order of the sums does too.
struct Split {
  int kchunk;
  int splits;
};

inline Split split_plan(int M, int N, int K) {
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  int s = (kTargetBlocks + tiles - 1) / tiles;
  const int most = (K + 255) / 256;
  if (s > most) s = most;
  if (s < 1) s = 1;
  int kchunk = (K + s - 1) / s;
  kchunk = ((kchunk + BK - 1) / BK) * BK;
  return Split{kchunk, (K + kchunk - 1) / kchunk};
}

// out[i] = sum over s of part[s * n + i], s in order
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, int n,
                                  int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = 0.0f;
  for (int s = 0; s < splits; ++s) v += part[static_cast<size_t>(s) * n + i];
  out[i] = v;
}

// Scratch floats of a split reduction into an (M, N) result.
inline size_t wgrad_scratch(int M, int N, int K) {
  const Split p = split_plan(M, N, K);
  return p.splits > 1 ? static_cast<size_t>(p.splits) * M * N : 0;
}

// out (M, N) = A^T B over the K rows of A (K, M) and B (K, N): a weight
// gradient. `part`: wgrad_scratch(M, N, K) floats.
inline void wgrad(const float* A, const float* B, float* out, int M, int N,
                  int K, float* part, cudaStream_t st) {
  const Split p = split_plan(M, N, K);
  if (p.splits == 1) {
    gemm<true, false, E_STORE>(A, B, out, M, N, K, M, N, EpiArgs{}, st);
    return;
  }
  gemm<true, false, E_STORE>(A, B, part, M, N, K, M, N, EpiArgs{}, st,
                             p.kchunk, p.splits);
  const int n = M * N;
  sum_splits_kernel<<<(n + 255) / 256, 256, 0, st>>>(part, out, n, p.splits);
}

// part[s * C + c] = sum over rows r of chunk s of A[r, c] (* B[r, c]):
// 32 columns by 8 row lanes a block, rows in order within a lane, the 8
// lanes added in order
__global__ void colsum_kernel(const float* __restrict__ A,
                              const float* __restrict__ B,
                              float* __restrict__ part, int R, int C,
                              int rchunk) {
  __shared__ float sh[8][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int r0 = blockIdx.y * rchunk;
  const int r1 = min(R, r0 + rchunk);
  float v = 0.0f;
  if (c < C) {
    for (int r = r0 + threadIdx.y; r < r1; r += 8) {
      const size_t o = static_cast<size_t>(r) * C + c;
      v += B ? A[o] * B[o] : A[o];
    }
  }
  sh[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float s = 0.0f;
    for (int y = 0; y < 8; ++y) s += sh[y][threadIdx.x];
    part[static_cast<size_t>(blockIdx.y) * C + c] = s;
  }
}

inline int colsum_splits(int R) {
  int s = (R + 255) / 256;
  return s > 64 ? 64 : (s < 1 ? 1 : s);
}

inline size_t colsum_scratch(int R, int C) {
  return static_cast<size_t>(colsum_splits(R)) * C;
}

// out[c] = sum over the R rows of A[r, c] (* B[r, c] when B is given).
// `part`: colsum_scratch(R, C) floats.
inline void colsum(const float* A, const float* B, float* out, int R, int C,
                   float* part, cudaStream_t st) {
  const int s = colsum_splits(R);
  const int rchunk = (R + s - 1) / s;
  colsum_kernel<<<dim3((C + 31) / 32, s), dim3(32, 8), 0, st>>>(A, B, part,
                                                               R, C, rchunk);
  sum_splits_kernel<<<(C + 255) / 256, 256, 0, st>>>(part, out, C, s);
}

}  // namespace tg

#define TG_CHECK()                                   \
  do {                                               \
    cudaError_t e_ = cudaGetLastError();             \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)
