// K10: the backward of the fused tanh-RNN (BPTT), f32 or bf16.
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
// operations (0.16 ms at 67 TFLOP/s f32; 0.065 ms at the tensor cores'
// TF32 rate over the three products of 3xTF32). Half of it is the
// recurrence, 40 dependent steps whose every output needs the whole row
// before; the other half, dW, has no order at all.
//
// Design, two launches (three where dW is split):
//   - the walk: rnn_cluster.cuh's walk, run backwards. W stays in the
//     shared memory of a cluster of 8 blocks, each block H/8 of W's rows
//     transposed as they are staged (no transposed copy of W), da goes to
//     every block of the cluster through distributed shared memory with one
//     cluster barrier a step, and the step's epilogue adds g_t and
//     multiplies by 1 - h_t^2 with both loaded a step ahead, writing dxin;
//   - dW as one (H x B T) (B T x H) product on the tensor cores, 3xTF32
//     (train_mma.cuh's tile routine, each 8-deep step's sums added in f32),
//     reading h_{t-1} as hs shifted by one row in its staging (a zero row
//     where t = 0: no shifted copy of hs). Split over the B T rows into
//     partial products added in a fixed order (tg::sum_splits_kernel): no
//     float atomics, two calls give the same bits.
// The launch plan (the walk's cluster, columns, batch tile, clusters and
// shared bytes; dW's rows a split and splits) comes from
// ops/fused_rnn.py::fused_rnn_bwd_plan and is checked here.
//
// The bf16 variant (fused_rnn_bwd_bf16_launch: tip_tpu's kernel on bf16 hs,
// g and W), two launches:
//   - the walk on the tensor cores (rnn_cluster.cuh's tc_walk_kernel, run
//     backwards: W's rows as the bf16 mma's A fragments in registers, da
//     formed in f32 and rounded to bf16 once; that value is written as
//     dxin, passed on as the next step's row, and written a row up into
//     dW's operand, shifted[b, t-1] = da_t, shifted[b, T-1] = 0);
//   - dW = hs^T shifted over all B T rows as one plain TN product on
//     wgmma from TMA-staged bf16 tiles (bf16_gemm.cuh's bg::product, the
//     plan of ops/encoder_train.py::product_plan): its splits of the rows
//     are one cluster that sums them in rank order through distributed
//     shared memory, and the epilogue rounds the f32 sum to bf16 once,
//     never a split alone.
// No widened copy of hs or dxin: dW reads the bf16 values as they are,
// from a scratch of B T H bf16 (shifted). Its bound is operations at the
// bf16 tensor-core rate (0.0106 ms at the training shape, bytes 0.0097):
// the recurrence's 40 dependent steps, not the rate, are what hold it
// there.

#include "bf16_gemm.cuh"
#include "rnn_cluster.cuh"
#include "train_mma.cuh"

namespace {

// dW's partial product of split blockIdx.z (rows [z kchunk, (z + 1)
// kchunk) of B T): part + z H H, or dw itself when there is one split
// (kPadded: hs and da are the padded copies, rows of ld floats; else rows
// of H)
template <class L, bool kPadded>
__global__ void __launch_bounds__(L::THREADS, 2)
dw_kernel(const float* __restrict__ hs, const float* __restrict__ da,
          float* __restrict__ part, int H, int ld, int rows, int T,
          int kchunk) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, q = lane & 3;
  const int wm = warp % (L::BM / L::TM), wn = warp / (L::BM / L::TM);
  const int m0 = blockIdx.y * L::BM, n0 = blockIdx.x * L::BN;
  const int k_begin = blockIdx.z * kchunk;
  const int k_end = min(rows, k_begin + kchunk);
  float acc[L::MT][L::NT][4];
  // A = h_{t-1} stored (B T, H) as hs a row up; B = da (B T, H)
  if constexpr (kPadded)
    tf3::mma_tile<true, false, L, true, true>(
        hs, da, ld, ld, ld, ld, m0, n0, k_begin, k_end, sm, acc, T);
  else
    tf3::mma_tile<true, false, L, true, true>(
        hs, da, H, H, H, H, m0, n0, k_begin, k_end, sm, acc, T);
  float* out = part + static_cast<size_t>(blockIdx.z) * H * H;
#pragma unroll
  for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {   // rows g, g+8; columns 2q, 2q+1
        const int gm = m0 + wm * L::TM + mt * 16 + g + 8 * (r >> 1);
        const int gn = n0 + wn * L::TN + nt * 8 + 2 * q + (r & 1);
        if (gm < H && gn < H) out[static_cast<size_t>(gm) * H + gn] =
            acc[mt][nt][r];
      }
}

template <class L, bool kPadded>
cudaError_t launch_dw(const float* hs, const float* da, float* part, int H,
                      int ld, int rows, int T, int kchunk, int splits,
                      cudaStream_t st) {
  constexpr size_t smem = tf3::Stage<true, false, L>::BYTES;
  static const cudaError_t attr = cudaFuncSetAttribute(
      dw_kernel<L, kPadded>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  dim3 grid((H + L::BN - 1) / L::BN, (H + L::BM - 1) / L::BM, splits);
  dw_kernel<L, kPadded><<<grid, L::THREADS, smem, st>>>(hs, da, part, H, ld,
                                                       rows, T, kchunk);
  return cudaGetLastError();
}

template <bool kPadded>
cudaError_t dw_product(const float* hs, const float* da, float* out, int H,
                       int ld, int rows, int T, int kchunk, int splits,
                       cudaStream_t st) {
  return H <= 256 ? launch_dw<tf3::NarrowTile, kPadded>(
                        hs, da, out, H, ld, rows, T, kchunk, splits, st)
                  : launch_dw<tf3::WideTile, kPadded>(
                        hs, da, out, H, ld, rows, T, kchunk, splits, st);
}

// dst (H, H) = the first H columns of the first H rows of src (rows of ld)
__global__ void crop_kernel(const __nv_bfloat16* __restrict__ src,
                            __nv_bfloat16* __restrict__ dst, int H, int ld) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < H * H) dst[e] = src[static_cast<size_t>(e / H) * ld + e % H];
}

// The checked launch plan of the f32 entry point: the walk's
// (rnnc::walk_plan_ok) and dW's split
bool bwd_plan_ok(int B, int T, int H, int cluster, int cols, int bt,
                 int clusters, long long smem, int dw_rows, int dw_splits) {
  const long long rows = static_cast<long long>(B) * T;
  return rnnc::walk_plan_ok(B, H, cluster, cols, bt, clusters, smem) &&
         dw_rows > 0 && dw_rows % tf3::BK == 0 && dw_splits > 0 &&
         static_cast<long long>(dw_rows) * dw_splits >= rows &&
         static_cast<long long>(dw_rows) * (dw_splits - 1) < rows &&
         rows * H <= 0x7fffffffLL;
}

}  // namespace

// hs, g, dx (B, T, H), w_hh and dw (H, H), f32. The walk's plan as
// fused_rnn_launch's (rnnc::walk_plan_ok); dW's: `dw_rows` rows a split (a
// multiple of tf3::BK), `dw_splits` splits that cover the B T rows
// exactly, and `part` dw_splits H H floats of scratch where dw_splits > 1
// (unused otherwise); `pad` 2 B T round_up(H, 4) floats of scratch where H
// is not a multiple of 4 (dW's operands with padded rows; unused
// otherwise). Returns a CUDA error code.
extern "C" int fused_rnn_bwd_launch(const void* hs, const void* w_hh,
                                    const void* g, void* dx, void* dw,
                                    void* part, int B, int T, int H,
                                    int cluster, int cols, int bt,
                                    int clusters, long long smem,
                                    int dw_rows, int dw_splits, void* pad,
                                    void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  if (!bwd_plan_ok(B, T, H, cluster, cols, bt, clusters, smem, dw_rows,
                   dw_splits) ||
      (dw_splits > 1 && part == nullptr) || (H % 4 != 0 && pad == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = B * T;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* hs_f = static_cast<const float*>(hs);
  float* dx_f = static_cast<float*>(dx);
  float* dw_f = static_cast<float*>(dw);
  float* pad_f = H % 4 != 0 ? static_cast<float*>(pad) : nullptr;
  cudaError_t err = rnnc::walk<true>(static_cast<const float*>(g), hs_f,
                                     static_cast<const float*>(w_hh), dx_f,
                                     pad_f, B, T, H, cols, bt, clusters, smem,
                                     st);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* out = dw_splits > 1 ? static_cast<float*>(part) : dw_f;
  // dW's operands: hs and dx, or their copies with rows padded to 4
  const int ld = rnnc::round_up(H, 4);
  err = pad_f != nullptr
            ? dw_product<true>(pad_f, pad_f + static_cast<size_t>(rows) * ld,
                               out, H, ld, rows, T, dw_rows, dw_splits, st)
            : dw_product<false>(hs_f, dx_f, out, H, H, rows, T, dw_rows,
                                dw_splits, st);
  if (err != cudaSuccess || dw_splits == 1) return static_cast<int>(err);
  const int n = H * H;
  tg::sum_splits_kernel<<<(n + 255) / 256, 256, 0, st>>>(out, dw_f, n,
                                                         dw_splits);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 variant: hs, w_hh, g, dx and dw bf16. The walk's plan as
// fused_rnn_bf16_launch's (rnnc::tc_plan_ok, backwards); dW's product plan
// (dw_bm x dw_bn tiles, dw_kchunk rows a split, dw_splits splits:
// bg::plan_ok for (Hp, Hp, B T), Hp = round_up(H, 8)); `shifted`: B T Hp
// bf16 of scratch (dW's operand); `pad` where H is not a multiple of 8
// (unused otherwise): B T Hp bf16 (hs with rows padded, dW's other
// operand) then Hp Hp bf16 (dW before its crop to (H, H)); clock: null, or
// 7 u64 for the walk's step clock.
extern "C" int fused_rnn_bwd_bf16_launch(const void* hs, const void* w_hh,
                                         const void* g, void* dx, void* dw,
                                         void* shifted, int B, int T, int H,
                                         int cluster, int cols, int bt,
                                         int clusters, long long smem,
                                         int dw_bm, int dw_bn, int dw_kchunk,
                                         int dw_splits, void* clock,
                                         void* pad, void* stream) {
  using S = __nv_bfloat16;
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  const long long rows = static_cast<long long>(B) * T;
  const bg::Plan dw_plan{dw_bm, dw_bn, dw_kchunk, dw_splits};
  const bool padded = H % 8 != 0;
  const int hp = rnnc::round_up(H, 8);
  if (!rnnc::tc_plan_ok(B, H, cluster, cols, bt, clusters, smem, true) ||
      rows * hp > 0x7fffffffLL ||
      !bg::plan_ok(dw_plan, hp, hp, static_cast<int>(rows)) ||
      shifted == nullptr || (padded && pad == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  S* hs_pad = padded ? static_cast<S*>(pad) : nullptr;
  cudaError_t err = rnnc::tc_walk<true>(
      static_cast<const S*>(g), static_cast<const S*>(hs),
      static_cast<const S*>(w_hh), static_cast<S*>(dx),
      static_cast<S*>(shifted), hs_pad, B, T, H, cols, bt, clusters, smem,
      static_cast<unsigned long long*>(clock), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  bg::EpiArgs ep{};
  ep.kind = tg::E_STORE;
  ep.out_bf16 = 1;
  // dW (H, H) = hs^T shifted: A = hs stored (B T, H), B = shifted (B T, H);
  // where H is not a multiple of 8, the padded copies (rows of hp, the
  // TMA's 16-byte rows) into an (hp, hp) dW, then cropped
  S* dw_pad = padded ? hs_pad + static_cast<size_t>(rows) * hp : nullptr;
  ep.out = padded ? static_cast<void*>(dw_pad) : dw;
  err = bg::product<true, false>(dw_plan, padded ? hs_pad : hs, shifted, hp,
                                 hp, static_cast<int>(rows), ep, st);
  if (err != cudaSuccess || !padded) return static_cast<int>(err);
  const int n = H * H;
  crop_kernel<<<(n + 255) / 256, 256, 0, st>>>(dw_pad, static_cast<S*>(dw),
                                                H, hp);
  return static_cast<int>(cudaGetLastError());
}
