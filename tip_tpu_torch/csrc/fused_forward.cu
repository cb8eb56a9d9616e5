// K4 fused_forward_last and K5 fused_forward: the whole windowed model of
// one stream in one cooperative launch.
//
// Replaces tip_tpu/ops/fused_forward.py::fused_forward_last (Pallas kernel
// _kernel_last) and tip_tpu/ops/fused_forward.py::fused_forward (Pallas
// kernel _kernel): in-projection (head-interleave permutation folded into
// the packed weight), L post-norm encoder layers (packed QKV, causal
// attention per head, out-projection, LayerNorm, ReLU feed-forward,
// LayerNorm), the tanh RNN over the window and the out-projection, at one
// window index (K4) or at every index (K5).
//
// What bounds it on the H100: at the serving shape (T = 40, d 256, ff 1024,
// 4 layers, H 512) the packed weights are 3.66 M values (7.3 MB in bf16,
// 14.6 MB in f32) read once, and the work is about 0.3 GFLOP, so a few
// microseconds by either measure. What the kernel pays instead is latency:
// a chain of 33 dependent phases before the RNN and T dependent RNN steps,
// each closed by a grid-wide barrier.
//
// Design: one cooperative launch of one block per SM, 256 threads each,
// with grid.sync() between phases; activations (at most T x ff floats) live
// in a global scratch buffer that stays in L2 and is read with ld.cg, never
// through the non-coherent path. A product phase is split into units of
// (4 rows) x (256 output columns): the block stages its rows in shared
// memory, rounding them to the packing dtype once, and each thread owns one
// column, reading the weight row-major so a warp's loads coalesce; every
// sum is sequential in f32 with fmaf. Attention is split into (head, 8
// rows) units with that head's q, k and v staged (and rounded) in shared
// memory, one warp per query row. LayerNorm takes one warp per row. For the
// RNN each block keeps its slice of W_hh's columns resident in shared
// memory for all T steps; a step reads the previous hidden (rounded) from
// the scratch, one warp per column, and ends in a grid barrier. K4 runs
// rows 0..k_last only: later rows cannot reach that output (causal
// attention, a forward RNN).
//
// The phases (product_phase, attention_phase, layernorm_phase, rnn_phase)
// live in fused_phases.cuh, shared with the cached step's kernel.
//
// The packing dtype (f32 or bf16) is a template argument: weights widen to
// f32 on load, products of two rounded values are exact in f32, so both
// types share one code path on the CUDA cores. Tensor cores are later work.

#include "fused_phases.cuh"

namespace {

struct Dims {
  int T;        // rows to compute
  int Din, d, heads, ff, layers, H, S;
  int zero0;    // first of the three zeroed input columns
  int k_last;   // >= 0: emit that row only; -1: every row
  int cpb;      // W_hh columns per block in the RNN phase
  int rnn_off;  // byte offset of the RNN's shared-memory region
};

struct Scratch {
  float *x, *qkv, *att, *a, *f, *xin, *hs;
};


template <typename WT>
__global__ void __launch_bounds__(kThreads)
fused_forward_kernel(const float* __restrict__ x, Weights w, Dims p,
                     Scratch s, float* __restrict__ out) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char sm_raw[];
  float* sm = reinterpret_cast<float*>(sm_raw);
  const int T = p.T, d = p.d;
  auto W = [](const void* q) { return static_cast<const WT*>(q); };

  product_phase<WT>(x, p.Din, T, p.Din, W(w.w_in), W(w.b_in), d, nullptr, s.x,
                    kActNone, false, p.zero0, sm);
  grid.sync();
  for (int l = 0; l < p.layers; ++l) {
    const Layer& L = w.layer[l];
    product_phase<WT>(s.x, d, T, d, W(L.w_qkv), W(L.b_qkv), 3 * d, nullptr,
                      s.qkv, kActNone, true, -1, sm);
    grid.sync();
    attention_phase<WT>(s.qkv, T, d, p.heads, s.att, sm);
    grid.sync();
    product_phase<WT>(s.att, d, T, d, W(L.w_o), W(L.b_o), d, s.x, s.a,
                      kActNone, true, -1, sm);
    grid.sync();
    layernorm_phase(s.a, T, d, L.ln1_s, L.ln1_b, s.x);
    grid.sync();
    product_phase<WT>(s.x, d, T, d, W(L.w_f1), W(L.b_f1), p.ff, nullptr, s.f,
                      kActRelu, true, -1, sm);
    grid.sync();
    product_phase<WT>(s.f, p.ff, T, p.ff, W(L.w_f2), W(L.b_f2), d, s.x, s.a,
                      kActNone, true, -1, sm);
    grid.sync();
    layernorm_phase(s.a, T, d, L.ln2_s, L.ln2_b, s.x);
    grid.sync();
  }
  product_phase<WT>(s.x, d, T, d, W(w.w_ih), W(w.b_r), p.H, nullptr, s.xin,
                    kActNone, true, -1, sm);
  grid.sync();
  rnn_phase<WT>(grid, s.xin, W(w.w_hh), T, p.H, p.cpb, s.hs,
                sm_raw + p.rnn_off);
  if (p.k_last >= 0)
    product_phase<WT>(s.hs + static_cast<size_t>(p.k_last) * p.H, p.H, 1, p.H,
                      W(w.w_out), W(w.b_out), p.S, nullptr, out, kActNone,
                      true, -1, sm);
  else
    product_phase<WT>(s.hs, p.H, T, p.H, W(w.w_out), W(w.b_out), p.S, nullptr,
                      out, kActNone, true, -1, sm);
}

template <typename WT>
int launch(const float* x, const Weights& w, Dims p, const Scratch& s,
           float* out, cudaStream_t stream) {
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const int grid = sms;           // one block per SM, all co-resident
  p.cpb = (p.H + grid - 1) / grid;
  // shared memory: the phases' staging region, then the RNN's region
  int k_max = p.Din;
  if (p.d > k_max) k_max = p.d;
  if (p.ff > k_max) k_max = p.ff;
  if (p.H > k_max) k_max = p.H;
  const int hs = (p.d / p.heads) | 1;
  size_t stage = static_cast<size_t>(kRows) * k_max;
  const size_t attn =
      static_cast<size_t>(kWarps) * hs + 2 * p.T * hs + kWarps * kMaxT;
  if (attn > stage) stage = attn;
  const size_t stage_bytes = (stage * sizeof(float) + 15) / 16 * 16;
  const size_t rnn_bytes =
      (static_cast<size_t>(p.cpb) * p.H * sizeof(WT) + 15) / 16 * 16 +
      static_cast<size_t>(p.H) * sizeof(float);
  const size_t smem = stage_bytes + rnn_bytes;
  if (smem > static_cast<size_t>(smem_max)) return kErrSmem;
  p.rnn_off = static_cast<int>(stage_bytes);
  Weights w_arg = w;
  Scratch s_arg = s;
  void* args[] = {&x, &w_arg, &p, &s_arg, &out};
  return launch_cooperative(fused_forward_kernel<WT>, grid, smem, args,
                            stream);
}

}  // namespace

// weights: the packed list of ops/fused_forward.py::pack_weights, n_w =
// 2 + 12 * layers + 5 device pointers. scratch: T * (6 d + ff + 2 H)
// floats. k_last >= 0 writes out (S,) for that row and computes rows
// 0..k_last only; k_last == -1 writes out (T, S). Returns a CUDA error
// code, or -1 for a shape outside the kernel's limits, -2 when the widths
// need more shared memory than a block has.
extern "C" int fused_forward_launch(const void* x, const void* const* weights,
                                    int n_w, int is_bf16, int T, int Din,
                                    int d, int heads, int ff, int layers,
                                    int H, int S, int zero0, int k_last,
                                    void* scratch, void* out, void* stream) {
  if (T < 1 || T > kMaxT || layers < 1 || layers > kMaxLayers ||
      n_w != 2 + 12 * layers + 5 || heads < 1 || d < 1 || d % heads != 0 ||
      d / heads > kMaxHeadDim || Din < 1 || ff < 1 || H < 1 || S < 1 ||
      k_last < -1 || k_last >= T)
    return kErrShape;
  const Weights w = unpack_weights(weights, layers);

  // the scratch is laid out for the caller's T rows
  float* base = static_cast<float*>(scratch);
  Scratch s;
  s.x = base;
  s.qkv = s.x + static_cast<size_t>(T) * d;
  s.att = s.qkv + static_cast<size_t>(T) * 3 * d;
  s.a = s.att + static_cast<size_t>(T) * d;
  s.f = s.a + static_cast<size_t>(T) * d;
  s.xin = s.f + static_cast<size_t>(T) * ff;
  s.hs = s.xin + static_cast<size_t>(T) * H;

  Dims p;
  p.T = k_last >= 0 ? k_last + 1 : T;
  p.Din = Din;
  p.d = d;
  p.heads = heads;
  p.ff = ff;
  p.layers = layers;
  p.H = H;
  p.S = S;
  p.zero0 = zero0;
  p.k_last = k_last;
  p.cpb = 0;
  p.rnn_off = 0;
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(xf, w, p, s, of, st);
  return launch<float>(xf, w, p, s, of, st);
}
