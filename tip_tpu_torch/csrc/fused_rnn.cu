// K1: fused tanh-RNN over time, f32 or bf16.
//
// Replaces tip_tpu/ops/pallas_kernels.py::fused_rnn (Pallas kernel
// _rnn_kernel): h_t = tanh(xin_t + h_{t-1} W_hh), h_{-1} = 0, for
// xin (B, T, H) with both biases already folded in and W_hh (H, H) stored
// row-major as (in, out).
//
// What bounds it on the H100: not bytes (W_hh once, xin and the output
// once: 1.2 MB at B 1, T 40, H 512 in f32, a third of a microsecond; in
// bf16 at B 256, 21 MB, 6.4e-3 ms) and not operations (21 MFLOP at B 1),
// but latency: 40 dependent steps, each a (B, H) x (H, H) product that
// needs the whole h_{t-1}. A design that reads W_hh from L2 in every step
// pays 1 MB through one SM per step at B 1 (the first version of this
// kernel, 23 us a step).
//
// Design: rnn_cluster.cuh's walk, forwards. W_hh stays on chip for the
// whole launch, spread over a thread-block cluster of 8 blocks; block r
// holds columns [r H/8, (r+1) H/8) of W_hh, loaded once with cp.async; a
// cluster owns a tile of batch rows, h_t goes to every block of
// the cluster through distributed shared memory and the cluster waits on
// one barrier a step: nothing reads W_hh from L2 or HBM after the first
// load. f32: the slice in shared memory (128 KB at H 512), the step's
// product with fmaf on the CUDA cores. bf16 (tip_tpu's kernel on bf16
// inputs and weights): the slice in registers as the A fragments of bf16
// mma.sync (64 KB a block), the step's product on the tensor cores with
// f32 sums (16 or 32 mma a warp), the row buffers bf16, and each step
// rounds the sum, the add of xin and the tanh to bf16 as tip_tpu does
// (rnn_cluster.cuh's tc_walk_kernel). What holds a bf16 step is the chain
// of latencies around the product (its partial sums through shared
// memory, tanh, the broadcast and the cluster barrier), which no longer
// grows with the batch tile. The launch plan (cluster, columns a block,
// batch tile, clusters, shared bytes) comes from
// ops/fused_rnn.py::fused_rnn_plan and is checked here. Any H whose slice
// and one row's buffers fit a block runs: a block keeps H / 8 columns
// rounded up to 32 (the columns past H zero), the depth is padded (f32 to
// 8 slices of a multiple of 4; bf16 to 512, or 768 past H 512 by a second,
// deeper instantiation), rows of an H that is not a multiple of 4 (f32) or
// 8 (bf16) move a value at a time, and where the tile's buffers do not fit
// the plan takes fewer rows a cluster.

#include "rnn_cluster.cuh"

// xin, w_hh, out f32: the plan of ops/fused_rnn.py::fused_rnn_plan, checked
// (rnnc::walk_plan_ok): a cluster of 8 blocks of `cols` columns each, `bt`
// batch rows a cluster, `clusters` clusters that cover the B rows exactly,
// `smem` bytes of shared memory.
extern "C" int fused_rnn_launch(const void* xin, const void* w_hh, void* out,
                                int B, int T, int H, int cluster, int cols,
                                int bt, int clusters, long long smem,
                                void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  if (!rnnc::walk_plan_ok(B, H, cluster, cols, bt, clusters, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(rnnc::walk<false>(
      static_cast<const float*>(xin), nullptr,
      static_cast<const float*>(w_hh), static_cast<float*>(out), nullptr, B,
      T, H, cols, bt, clusters, smem, static_cast<cudaStream_t>(stream)));
}

// xin, w_hh, out bf16: the plan of the tensor-core walk
// (rnnc::tc_plan_ok); clock: null, or 7 u64 for the step's clock
// (rnnc::StepClock; up to 64 columns a block)
extern "C" int fused_rnn_bf16_launch(const void* xin, const void* w_hh,
                                     void* out, int B, int T, int H,
                                     int cluster, int cols, int bt,
                                     int clusters, long long smem,
                                     void* clock, void* stream) {
  using S = __nv_bfloat16;
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  if (!rnnc::tc_plan_ok(B, H, cluster, cols, bt, clusters, smem, false))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(rnnc::tc_walk<false>(
      static_cast<const S*>(xin), nullptr, static_cast<const S*>(w_hh),
      static_cast<S*>(out), nullptr, nullptr, B, T, H, cols, bt, clusters,
      smem,
      static_cast<unsigned long long*>(clock),
      static_cast<cudaStream_t>(stream)));
}
