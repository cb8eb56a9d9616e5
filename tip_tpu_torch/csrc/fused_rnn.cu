// K1: fused tanh-RNN over time, f32.
//
// Replaces tip_tpu/ops/pallas_kernels.py::fused_rnn (Pallas kernel
// _rnn_kernel): h_t = tanh(xin_t + h_{t-1} W_hh), h_{-1} = 0, for
// xin (B, T, H) with both biases already folded in and W_hh (H, H) stored
// row-major as (in, out).
//
// What bounds it on the H100: at the serving shape (B=1, T=40, H=512) the
// work is 21 MFLOP over about 1.2 MB of compulsory bytes (W_hh once, xin and
// the output once), a few microseconds at the card's rates. What bounds the
// kernel instead is latency: 40 dependent steps, each a 512-long dot per
// hidden unit that reads a W_hh column from L2, with a block-wide barrier
// between steps.
//
// Design: one block per batch row, one thread per hidden unit (a thread
// loops when H > blockDim). The hidden state lives in shared memory, double
// buffered so one barrier per step suffices. Thread j reads column j of
// W_hh, so a warp's loads of one row of W_hh are consecutive addresses and
// coalesce. Four partial sums give the dot product some instruction-level
// parallelism. A design that keeps W_hh resident on chip (1 MB in f32, so
// spread over a thread-block cluster's distributed shared memory) is later
// work.

#include <cuda_runtime.h>

namespace {

__global__ void fused_rnn_kernel(const float* __restrict__ xin,
                                 const float* __restrict__ w,
                                 float* __restrict__ out, int T, int H) {
  extern __shared__ float sh[];
  float* h_cur = sh;
  float* h_nxt = sh + H;
  const size_t row = static_cast<size_t>(blockIdx.x) * T * H;
  const float* x_b = xin + row;
  float* o_b = out + row;

  for (int j = threadIdx.x; j < H; j += blockDim.x) h_cur[j] = 0.0f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
      const float* wj = w + j;
      int i = 0;
#pragma unroll 4
      for (; i + 3 < H; i += 4) {
        a0 = fmaf(h_cur[i], __ldg(wj + static_cast<size_t>(i) * H), a0);
        a1 = fmaf(h_cur[i + 1], __ldg(wj + static_cast<size_t>(i + 1) * H), a1);
        a2 = fmaf(h_cur[i + 2], __ldg(wj + static_cast<size_t>(i + 2) * H), a2);
        a3 = fmaf(h_cur[i + 3], __ldg(wj + static_cast<size_t>(i + 3) * H), a3);
      }
      for (; i < H; ++i)
        a0 = fmaf(h_cur[i], __ldg(wj + static_cast<size_t>(i) * H), a0);
      const size_t at = static_cast<size_t>(t) * H + j;
      const float h = tanhf(x_b[at] + ((a0 + a1) + (a2 + a3)));
      h_nxt[j] = h;
      o_b[at] = h;
    }
    __syncthreads();
    float* tmp = h_cur;
    h_cur = h_nxt;
    h_nxt = tmp;
  }
}

}  // namespace

extern "C" int fused_rnn_launch(const void* xin, const void* w_hh, void* out,
                                int B, int T, int H, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  int threads = ((H + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = 2 * static_cast<size_t>(H) * sizeof(float);
  fused_rnn_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xin), static_cast<const float*>(w_hh),
      static_cast<float*>(out), T, H);
  return static_cast<int>(cudaGetLastError());
}
