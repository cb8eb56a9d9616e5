// K1: fused tanh-RNN over time, f32 or bf16.
//
// Replaces tip_tpu/ops/pallas_kernels.py::fused_rnn (Pallas kernel
// _rnn_kernel): h_t = tanh(xin_t + h_{t-1} W_hh), h_{-1} = 0, for
// xin (B, T, H) with both biases already folded in and W_hh (H, H) stored
// row-major as (in, out).
//
// What bounds it on the H100: not bytes (W_hh once, xin and the output
// once: 1.2 MB at B 1, T 40, H 512, a third of a microsecond) and not
// operations (21 MFLOP at B 1), but latency: 40 dependent steps, each a
// (B, H) x (H, H) product that needs the whole h_{t-1}. A design that
// reads W_hh from L2 in every step pays 1 MB through one SM per step at
// B 1 (the first version of this kernel, 23 us a step).
//
// Design: rnn_cluster.cuh's walk, forwards. W_hh stays on chip for the
// whole launch, spread over a thread-block cluster of 8 blocks; block r
// holds columns [r H/8, (r+1) H/8) of W_hh in its shared memory (128 KB at
// H 512), loaded once with cp.async; a cluster owns a tile of up to 16
// batch rows, h_t goes to every block of the cluster through distributed
// shared memory and the cluster waits on one barrier a step: nothing reads
// W_hh from L2 or HBM after the first load. The launch plan (cluster,
// columns a block, batch tile, clusters, shared bytes) comes from
// ops/fused_rnn.py::fused_rnn_plan and is checked here.
//
// The bf16 variant (tip_tpu's kernel on bf16 inputs and weights) is the
// same walk on bf16 storage: W's slice is 64 KB a block at H 512, xin is
// read and h written as bf16, the sums stay f32, and each step rounds the
// sum, the add of xin and the tanh to bf16 as tip_tpu does
// (rnn_cluster.cuh's Io<__nv_bfloat16>). Its bound is the same latency:
// halving W's slice changes no step's chain of dependent operations.

#include "rnn_cluster.cuh"

// The plan of ops/fused_rnn.py::fused_rnn_plan, checked
// (rnnc::walk_plan_ok): a cluster of 8 blocks of `cols` columns each,
// `bt` batch rows a cluster, `clusters` clusters that cover the B rows
// exactly, `smem` bytes of shared memory.
template <class S>
static int launch_walk(const void* xin, const void* w_hh, void* out, int B,
                       int T, int H, int cluster, int cols, int bt,
                       int clusters, long long smem, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  if (!rnnc::walk_plan_ok(B, H, cluster, cols, bt, clusters, smem,
                          static_cast<int>(sizeof(S))))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(rnnc::walk<false, S>(
      static_cast<const S*>(xin), nullptr, static_cast<const S*>(w_hh),
      static_cast<S*>(out), B, T, H, cols, bt, clusters, smem,
      static_cast<cudaStream_t>(stream)));
}

// xin, w_hh, out f32
extern "C" int fused_rnn_launch(const void* xin, const void* w_hh, void* out,
                                int B, int T, int H, int cluster, int cols,
                                int bt, int clusters, long long smem,
                                void* stream) {
  return launch_walk<float>(xin, w_hh, out, B, T, H, cluster, cols, bt,
                            clusters, smem, stream);
}

// xin, w_hh, out bf16; `smem` counts W's slice at 2 bytes an entry
extern "C" int fused_rnn_bf16_launch(const void* xin, const void* w_hh,
                                     void* out, int B, int T, int H,
                                     int cluster, int cols, int bt,
                                     int clusters, long long smem,
                                     void* stream) {
  return launch_walk<__nv_bfloat16>(xin, w_hh, out, B, T, H, cluster, cols,
                                    bt, clusters, smem, stream);
}
