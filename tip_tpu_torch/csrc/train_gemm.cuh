// The shared parts of the training kernels' products: the fused epilogues
// that train_mma.cuh's tensor-core products (K11, K12 in encoder_train.cu)
// end with (bias, ReLU + dropout mask, dReLU + mask, residual add), the
// split of a reduction over the B*T rows and the second pass that adds its
// partial products in a fixed order (no float atomics: two calls give the
// same bits; K10's dW too), and the column sums of K12's bias gradients.

#pragma once

#include <cuda_runtime.h>

#include "hashmask.cuh"

namespace tg {

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

// How a reduction over K rows into an (M, N) result is split: `splits`
// chunks of `kchunk` rows (train_mma.cuh's split_plan)
struct Split {
  int kchunk;
  int splits;
};

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
