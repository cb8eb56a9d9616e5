// K9 fused_recompute_batch: the exact windowed recompute of B streams, one
// output row each, in one cooperative launch.
//
// Replaces tip_tpu/ops/fused_forward.py::fused_recompute_batch (Pallas
// kernels _enc_batch_kernel and _rnn_last_batch_kernel, two pallas_calls
// with a transpose to time-major between them): for every stream the
// in-projection and L post-norm encoder layers over its T window rows with
// causal attention inside the window, the tanh RNN from zero over the
// window, the hidden state at the stream's own last valid row k_last[b],
// and the out-projection of that one row. It is K4 (fused_forward.cu) with
// a stream axis: attention and the RNN never cross from one stream to the
// next, and stream b's output equals K4's at k_last[b] bit for bit (the
// same phases, the same order of every sum).
//
// What bounds it on the H100: operations. At B = 64, T = 40 the products
// are 17 GFLOP over 2560 rows against 14.7 MB of f32 weights and 2.3 MB of
// input: 0.25 ms at the f32 rate of the CUDA cores (0.017 ms at the bf16
// rate of the tensor cores for bf16 packing), 0.005 ms of bytes. The
// kernel's products run on the CUDA cores in f32 for both packings.
//
// Design: one block per SM, 256 threads, grid.sync() between phases. The
// encoder runs over the streams a chunk at a time (about 1280 rows), so
// that the activation scratch (x, qkv, att, the pre-norm sum and the
// feed-forward hidden: 10 KB a row in f32) stays at 13 MB and in L2
// whatever B is; the single-stream kernel's scratch design (14 KB a row
// with the RNN's buffers) would be 37 MB for the 2560 rows of B = 64 and
// 147 MB at B = 256. A chunk's phases are
// K4's, with product units of 16 rows x 256 columns (a weight value read
// once serves 16 rows; K4's 4-row units would read every weight 640 times
// at B = 64) and attention units of (stream, head, 8 rows). Each chunk ends
// with its RNN inputs in a (B, T, H) buffer. Then one batched RNN over all
// B streams (rnn_batch_phase: W_hh's columns split over the grid and
// resident in shared memory, the hidden states of all streams in the
// scratch, one barrier a step); a stream's hidden state freezes after step
// k_last[b], which selects that row with no second pass. The transpose to
// time-major of the TPU version has no counterpart: rows are addressed as
// b * T + t.
//
// Barriers: (1 + 8 L + 1) per chunk, T RNN steps: 34 * ceil(B / 32) + 40
// at the serving shape.

#include "fused_phases.cuh"

namespace {

constexpr int kEncRows = 16;      // rows of an encoder product unit
constexpr int kChunkRows = 1280;  // window rows of one encoder pass

struct Dims {
  int B, T;     // streams, window rows
  int Din, d, heads, ff, layers, H, S;
  int zero0;    // first of the three zeroed input columns
  int chunk;    // streams of one encoder pass
  int cpb;      // W_hh columns per block in the RNN phase
  int rnn_off;  // byte offset of the RNN's shared-memory region
};

// global scratch, f32. Per encoder pass (chunk * T rows): x, qkv, att, the
// pre-norm sum a, the feed-forward hidden f. For all streams: the RNN
// inputs xin (B, T, H) and two hidden-state buffers hs (2, B, H)
struct Scratch {
  float *x, *qkv, *att, *a, *f, *xin, *hs;
};

inline int chunk_streams(int B, int T) {
  int c = kChunkRows / T;
  if (c < 1) c = 1;
  return c < B ? c : B;
}

struct WindowRow {
  int T;
  __device__ int operator()(int b, int t) const { return b * T + t; }
};
// the hidden state of stream b moves through step k_last[b] and then stays
struct WindowGate {
  const int* k_last;
  __device__ bool operator()(int b, int t) const { return t <= k_last[b]; }
};

template <typename WT>
__global__ void __launch_bounds__(kThreads)
fused_recompute_batch_kernel(const float* __restrict__ x,
                             const int* __restrict__ k_last, Weights w,
                             Dims p, Scratch s, float* __restrict__ out) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char sm_raw[];
  float* sm = reinterpret_cast<float*>(sm_raw);
  const int B = p.B, T = p.T, d = p.d, H = p.H;
  auto W = [](const void* q) { return static_cast<const WT*>(q); };

  for (int b0 = 0; b0 < B; b0 += p.chunk) {
    const int nb = min(p.chunk, B - b0);
    const int R = nb * T;         // rows of this pass
    const float* xc = x + static_cast<size_t>(b0) * T * p.Din;
    float* xin_c = s.xin + static_cast<size_t>(b0) * T * H;
    // the model input enters the in-projection as f32, not rounded
    product_phase<WT, float, kEncRows>(xc, p.Din, R, p.Din, W(w.w_in),
                                       W(w.b_in), d, nullptr, s.x, kActNone,
                                       false, p.zero0, sm);
    grid.sync();
    for (int l = 0; l < p.layers; ++l) {
      const Layer& L = w.layer[l];
      product_phase<WT, float, kEncRows>(s.x, d, R, d, W(L.w_qkv),
                                         W(L.b_qkv), 3 * d, nullptr, s.qkv,
                                         kActNone, true, -1, sm);
      grid.sync();
      attention_phase<WT>(s.qkv, T, d, p.heads, s.att, sm, nb);
      grid.sync();
      product_phase<WT, float, kEncRows>(s.att, d, R, d, W(L.w_o), W(L.b_o),
                                         d, s.x, s.a, kActNone, true, -1, sm);
      grid.sync();
      layernorm_phase(s.a, R, d, L.ln1_s, L.ln1_b, s.x);
      grid.sync();
      product_phase<WT, float, kEncRows>(s.x, d, R, d, W(L.w_f1), W(L.b_f1),
                                         p.ff, nullptr, s.f, kActRelu, true,
                                         -1, sm);
      grid.sync();
      product_phase<WT, float, kEncRows>(s.f, p.ff, R, p.ff, W(L.w_f2),
                                         W(L.b_f2), d, s.x, s.a, kActNone,
                                         true, -1, sm);
      grid.sync();
      layernorm_phase(s.a, R, d, L.ln2_s, L.ln2_b, s.x);
      grid.sync();
    }
    product_phase<WT, float, kEncRows>(s.x, d, R, d, W(w.w_ih), W(w.b_r), H,
                                       nullptr, xin_c, kActNone, true, -1,
                                       sm);
    grid.sync();
  }

  rnn_batch_phase<WT>(grid, s.xin, W(w.w_hh), B, T, H, p.cpb, s.hs,
                      sm_raw + p.rnn_off, WindowRow{T}, WindowGate{k_last});
  product_phase<WT>(s.hs + static_cast<size_t>(T & 1) * B * H, H, B, H,
                    W(w.w_out), W(w.b_out), p.S, nullptr, out, kActNone, true,
                    -1, sm);
}

inline size_t scratch_total(int B, int T, int d, int ff, int H) {
  const size_t rows = static_cast<size_t>(chunk_streams(B, T)) * T;
  return rows * (6 * static_cast<size_t>(d) + ff) +
         static_cast<size_t>(B) * T * H + 2 * static_cast<size_t>(B) * H;
}

template <typename WT>
int launch(const float* x, const int* k_last, const Weights& w, Dims p,
           float* scratch, float* out, cudaStream_t stream) {
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const int grid = sms;           // one block per SM, all co-resident
  p.cpb = (p.H + grid - 1) / grid;
  p.chunk = chunk_streams(p.B, p.T);
  const size_t rows = static_cast<size_t>(p.chunk) * p.T;
  Scratch s;
  s.x = scratch;
  s.qkv = s.x + rows * p.d;
  s.att = s.qkv + rows * 3 * p.d;
  s.a = s.att + rows * p.d;
  s.f = s.a + rows * p.d;
  s.xin = s.f + rows * p.ff;
  s.hs = s.xin + static_cast<size_t>(p.B) * p.T * p.H;

  // shared memory: the phases' staging region, then the RNN's region
  int k_max = p.Din;
  if (p.d > k_max) k_max = p.d;
  if (p.ff > k_max) k_max = p.ff;
  if (p.H > k_max) k_max = p.H;
  const int hs = (p.d / p.heads) | 1;
  size_t stage = static_cast<size_t>(kEncRows) * k_max;
  const size_t attn =
      static_cast<size_t>(kWarps) * hs + 2 * p.T * hs + kWarps * kMaxT;
  if (attn > stage) stage = attn;
  const size_t stage_bytes = (stage * sizeof(float) + 15) / 16 * 16;
  const size_t rnn_bytes =
      (static_cast<size_t>(p.cpb) * p.H * sizeof(WT) + 15) / 16 * 16 +
      static_cast<size_t>(kRnnRows) * p.H * sizeof(float);
  const size_t smem = stage_bytes + rnn_bytes;
  if (smem > static_cast<size_t>(smem_max)) return kErrSmem;
  p.rnn_off = static_cast<int>(stage_bytes);
  Weights w_arg = w;
  void* args[] = {&x, &k_last, &w_arg, &p, &s, &out};
  return launch_cooperative(fused_recompute_batch_kernel<WT>, grid, smem,
                            args, stream);
}

}  // namespace

// The scratch (in floats) fused_recompute_batch_launch needs, so that the
// caller can allocate it; -1 when it does not fit 31 bits.
extern "C" int fused_recompute_batch_scratch_floats(int B, int T, int d,
                                                    int ff, int H) {
  const size_t total = scratch_total(B, T, d, ff, H);
  return total > 0x7fffffffu ? -1 : static_cast<int>(total);
}

// weights: the packed list of ops/fused_forward.py::pack_weights, n_w =
// 2 + 12 * layers + 5 device pointers. x (B, T, Din) f32, k_last (B,) int32
// with 0 <= k_last[b] < T (the caller checks), out (B, S) f32. scratch:
// fused_recompute_batch_scratch_floats floats. Returns a CUDA error code,
// or -1 for a shape outside the kernel's limits (or a scratch too small),
// -2 when the widths need more shared memory than a block has.
extern "C" int fused_recompute_batch_launch(
    const void* x, const void* k_last, const void* const* weights, int n_w,
    int is_bf16, int B, int T, int Din, int d, int heads, int ff, int layers,
    int H, int S, int zero0, void* scratch, long long scratch_floats,
    void* out, void* stream) {
  if (B < 1 || T < 1 || T > kMaxT || layers < 1 || layers > kMaxLayers ||
      n_w != 2 + 12 * layers + 5 || heads < 1 || d < 1 || d % heads != 0 ||
      d / heads > kMaxHeadDim || Din < 1 || ff < 1 || H < 1 || S < 1 ||
      static_cast<long long>(B) * T * (H > Din ? H : Din) > 0x7fffffffLL ||
      scratch_floats < 0 ||
      static_cast<size_t>(scratch_floats) < scratch_total(B, T, d, ff, H))
    return kErrShape;
  const Weights w = unpack_weights(weights, layers);
  Dims p;
  p.B = B;
  p.T = T;
  p.Din = Din;
  p.d = d;
  p.heads = heads;
  p.ff = ff;
  p.layers = layers;
  p.H = H;
  p.S = S;
  p.zero0 = zero0;
  p.chunk = 0;
  p.cpb = 0;
  p.rnn_off = 0;
  const float* xf = static_cast<const float*>(x);
  const int* kf = static_cast<const int*>(k_last);
  float* sf = static_cast<float*>(scratch);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(xf, kf, w, p, sf, of, st);
  return launch<float>(xf, kf, w, p, sf, of, st);
}
