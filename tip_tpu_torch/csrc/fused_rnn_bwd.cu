// K10: the backward of the fused tanh-RNN (BPTT), f32.
//
// Replaces tip_tpu/ops/pallas_kernels.py::_rnn_bwd (Pallas kernel
// _rnn_bwd_kernel, the backward of fused_rnn_train). For the hidden states
// hs (B, T, H) of h_t = tanh(xin_t + h_{t-1} W), W (H, H) stored (in, out),
// and the output gradient g (B, T, H):
//
//   dh_t = g_t + da_{t+1} W^T,  da_t = dh_t (1 - h_t^2)  -> dxin_t = da_t
//   dW   = sum over b, t of h_{t-1}^T da_t               (h_{-1} = 0)
//
// Only the hidden states are read: tanh' = 1 - h^2 needs no input.
//
// What bounds it on the H100: at the training shape (256, 40, 512) the work
// is 2 * 2 * B * T * H^2 = 10.7 GFLOP against 64 MB of compulsory bytes, so
// operations (0.16 ms at 67 TFLOP/s f32). What bounds this kernel instead
// is the sequential walk: 40 dependent steps, each a 512-long dot per hidden
// unit whose W column comes from L2.
//
// Design, three launches from one entry point: W^T staged once (so thread j
// reads row i of W^T, consecutive threads on consecutive addresses, as K1
// reads W); the walk as K1 run backwards, one block per batch row, da in
// shared memory, double buffered, one barrier a step, dxin written as it
// goes; then dW as one (H x B*T) (B*T x H) product of the shifted hidden
// states and dxin (train_gemm.cuh), split over the rows into partial sums
// added in a fixed order: no float atomics, two calls give the same bits.

#include <cuda_runtime.h>

#include "train_gemm.cuh"

namespace {

__global__ void transpose_kernel(const float* __restrict__ w,
                                 float* __restrict__ wt, int H) {
  __shared__ float tile[32][33];
  const int x = blockIdx.x * 32 + threadIdx.x;
  const int y0 = blockIdx.y * 32;
  for (int dy = threadIdx.y; dy < 32; dy += blockDim.y) {
    const int y = y0 + dy;
    if (x < H && y < H) tile[dy][threadIdx.x] = w[static_cast<size_t>(y) * H + x];
  }
  __syncthreads();
  const int tx = y0 + threadIdx.x;
  for (int dy = threadIdx.y; dy < 32; dy += blockDim.y) {
    const int ty = blockIdx.x * 32 + dy;
    if (tx < H && ty < H)
      wt[static_cast<size_t>(ty) * H + tx] = tile[threadIdx.x][dy];
  }
}

// hprev[b, t] = hs[b, t - 1], hprev[b, 0] = 0
__global__ void shift_kernel(const float* __restrict__ hs,
                             float* __restrict__ hprev, int T, int H,
                             size_t n) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int t = static_cast<int>((i / H) % T);
  hprev[i] = t > 0 ? hs[i - H] : 0.0f;
}

__global__ void bptt_kernel(const float* __restrict__ hs,
                            const float* __restrict__ wt,
                            const float* __restrict__ g,
                            float* __restrict__ dx, int T, int H) {
  extern __shared__ float sh[];
  float* da_next = sh;
  float* da_cur = sh + H;
  const size_t row = static_cast<size_t>(blockIdx.x) * T * H;

  for (int j = threadIdx.x; j < H; j += blockDim.x) da_next[j] = 0.0f;
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
      const float* wj = wt + j;
      int i = 0;
#pragma unroll 4
      for (; i + 3 < H; i += 4) {
        a0 = fmaf(da_next[i], __ldg(wj + static_cast<size_t>(i) * H), a0);
        a1 = fmaf(da_next[i + 1], __ldg(wj + static_cast<size_t>(i + 1) * H), a1);
        a2 = fmaf(da_next[i + 2], __ldg(wj + static_cast<size_t>(i + 2) * H), a2);
        a3 = fmaf(da_next[i + 3], __ldg(wj + static_cast<size_t>(i + 3) * H), a3);
      }
      for (; i < H; ++i)
        a0 = fmaf(da_next[i], __ldg(wj + static_cast<size_t>(i) * H), a0);
      const size_t at = row + static_cast<size_t>(t) * H + j;
      const float dh = g[at] + ((a0 + a1) + (a2 + a3));
      const float h = hs[at];
      const float da = dh * (1.0f - h * h);
      dx[at] = da;
      da_cur[j] = da;
    }
    __syncthreads();
    float* tmp = da_next;
    da_next = da_cur;
    da_cur = tmp;
  }
}

size_t scratch_floats(int B, int T, int H) {
  const int rows = B * T;
  return static_cast<size_t>(H) * H + static_cast<size_t>(rows) * H +
         tg::wgrad_scratch(H, H, rows);
}

}  // namespace

// Floats of scratch that fused_rnn_bwd_launch needs.
extern "C" int fused_rnn_bwd_scratch(int B, int T, int H, long long* floats) {
  *floats = static_cast<long long>(scratch_floats(B, T, H));
  return 0;
}

extern "C" int fused_rnn_bwd_launch(const void* hs, const void* w_hh,
                                    const void* g, void* dx, void* dw,
                                    void* scratch, int B, int T, int H,
                                    void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wt = static_cast<float*>(scratch);
  float* hprev = wt + static_cast<size_t>(H) * H;
  float* part = hprev + static_cast<size_t>(B) * T * H;
  const float* hs_f = static_cast<const float*>(hs);
  float* dx_f = static_cast<float*>(dx);

  transpose_kernel<<<dim3((H + 31) / 32, (H + 31) / 32), dim3(32, 8), 0,
                     st>>>(static_cast<const float*>(w_hh), wt, H);
  TG_CHECK();
  int threads = ((H + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  bptt_kernel<<<B, threads, 2 * static_cast<size_t>(H) * sizeof(float), st>>>(
      hs_f, wt, static_cast<const float*>(g), dx_f, T, H);
  TG_CHECK();
  const size_t n = static_cast<size_t>(B) * T * H;
  shift_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      hs_f, hprev, T, H, n);
  TG_CHECK();
  tg::wgrad(hprev, dx_f, static_cast<float*>(dw), H, H, B * T, part, st);
  TG_CHECK();
  return 0;
}
