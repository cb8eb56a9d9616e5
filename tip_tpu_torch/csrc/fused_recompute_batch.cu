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
// next. Its products run on the tensor cores and K4's on the CUDA cores, so
// stream b's output equals K4's at k_last[b] to the rounding of a sum
// taken in another order, not bit for bit.
//
// What bounds it on the H100: operations. At B = 64, T = 40 the products
// are 17 GFLOP over 2560 rows against 14.7 MB of f32 weights and 2.3 MB of
// input: 0.10 ms at the tensor cores' TF32 rate over the three products of
// 3xTF32 (f32 packing), 0.017 ms at their bf16 rate (bf16 packing); 0.005
// ms of bytes.
//
// Design: one block per SM, 256 threads, grid.sync() between phases. The
// products, LayerNorm, the RNN and the clock are pool_phases.cuh's, shared
// with K8 (fused_cached_batch.cu); attention over the window is K9's own.
//   - The products are tiles of 80 rows x 64 columns (N <= 256) or 64 or
//     80 x 128 (whichever takes fewer rounds of the grid), one tile a
//     block at a time, their slices 32 deep staged in shared memory by
//     cp.async (.cg: activations other blocks wrote come from L2) through
//     3 stages. f32 packing: 3xTF32 mma.sync.m16n8k8 by train_mma.cuh's
//     tile routine (the one K12 runs), each 8-deep step's sums added to
//     the output in f32 (the tensor cores' own adds truncate), about f32's
//     accuracy. bf16 packing: mma.sync.m16n8k16 in bf16 with f32 sums;
//     the activations are rounded to bf16 as the fragments are built (K4's
//     round_cd), so the products are the exact values K4 takes and only
//     the order of the sums differs. The in-projection reads the raw model
//     input (221 columns, rows not 16-byte aligned), fixed on the way in
//     (input_fix) and not rounded: staged with plain loads, K padded with
//     zeros, 3xTF32 in both packings (a bf16 weight is exact in TF32). The
//     out-projection (131 columns) stages with plain loads too, in 16-row
//     tiles, its columns past N masked.
//   - The encoder runs over the streams in passes of up to 2560 rows (64
//     streams at T = 40): its activation scratch (x, qkv, att, the
//     pre-norm sum and the feed-forward hidden: 10 KB a row in f32) is 26
//     MB and stays in L2 whatever B is.
//   - Attention: a warp a (stream, head), its k and v staged in shared
//     memory, a lane a query row (the score and output sums in K4's
//     order). LayerNorm: a warp a row, the row in registers.
//   - The RNN over all B streams after the passes: the grid cut into
//     groups of 16 W_hh columns (in registers, a slice of 32 rows a
//     thread) times groups of streams, one barrier a step; a stream's
//     hidden state freezes after step k_last[b], which selects that row
//     with no second pass. The transpose to time-major of the TPU version
//     has no counterpart: rows are addressed as b * T + t.
// Barriers: (2 + 8 L) per pass, T RNN steps: 34 * ceil(B / 64) + 40 at the
// serving shape. A per-phase clock (PhaseClock) records them when asked.

#include "pool_phases.cuh"

namespace {

constexpr int kChunkRows = 2560;  // window rows of one encoder pass

// the RNN's row of step t of stream b, and its gate: a stream's hidden
// state freezes after its k_last
struct WindowRow {
  int T;
  __device__ int operator()(int b, int t) const { return b * T + t; }
};
struct UpToLast {
  const int* k_last;
  __device__ bool operator()(int b, int t) const {
    return t <= __ldg(k_last + b);
  }
};

struct Dims {
  int B, T;     // streams, window rows
  int Din, d, heads, ff, layers, H, S;
  int zero0;    // first of the three zeroed input columns
  int vec;      // the activations' and weights' rows take 16-byte copies
  int chunk;    // streams of one encoder pass
  int spb;      // streams of a block's group in the RNN phase
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

// The kinds of the phases the per-phase clock (pool_phases.cuh's
// PhaseClock) records, as ops/fused_forward.py::K9_PHASES names them.
enum PhaseKind {
  kPhStart = 0, kPhIn = 1, kPhQkv = 2, kPhAttn = 3, kPhAttnOut = 4,
  kPhLn1 = 5, kPhFf1 = 6, kPhFf2 = 7, kPhLn2 = 8, kPhWih = 9, kPhRnn = 10,
  kPhOut = 11
};

// ---------------------------------------------------------------------------
// attention
// ---------------------------------------------------------------------------

// att (R, d) of n_streams windows of T rows: per head, softmax(q k^T /
// sqrt(hd) + causal mask) v, with q, k, the softmax weights and v rounded
// to WT before their products (attention_phase's function). A warp takes a
// (stream, head): k and v staged in its own part of shared memory (rows
// of HD floats, read by all lanes at once), a lane a query row with q in
// registers, three passes over the keys j <= i (the largest score, the sum
// of the exponentials, then the weights, rounded, times v). The score and
// output sums run in attention_phase's order. hd <= HD. sm: kWarps 2 T HD
// floats.
// q . k over HD values, in c's order
template <int HD>
__device__ __forceinline__ float dot_row(const float (&q)[HD],
                                         const float* k) {
  const float4* k4 = reinterpret_cast<const float4*>(k);
  float s = 0.0f;
#pragma unroll
  for (int c4 = 0; c4 < HD / 4; ++c4) {
    const float4 kv = k4[c4];
    s = fmaf(q[4 * c4], kv.x, s);
    s = fmaf(q[4 * c4 + 1], kv.y, s);
    s = fmaf(q[4 * c4 + 2], kv.z, s);
    s = fmaf(q[4 * c4 + 3], kv.w, s);
  }
  return s;
}

template <typename WT, int HD>
__device__ void attention_lanes_phase(const float* qkv, int T, int d,
                                      int heads, float* att, float* sm,
                                      int n_streams) {
  const int hd = d / heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ks = sm + warp * 2 * T * HD;             // [T][HD]
  float* vs = ks + T * HD;                        // [T][HD]
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  for (int unit = blockIdx.x * kWarps + warp; unit < n_streams * heads;
       unit += gridDim.x * kWarps) {
    const int st = unit / heads, hh = unit - st * heads;
    const float* src0 = qkv + static_cast<size_t>(st) * T * 3 * d + hh * hd;
    float* out = att + static_cast<size_t>(st) * T * d + hh * hd;
    __syncwarp();                 // the unit before is done with ks, vs
#pragma unroll 8
    for (int idx = lane; idx < T * HD; idx += 32) {
      const int j = idx / HD, c = idx - j * HD;
      const float* src = src0 + static_cast<size_t>(j) * 3 * d + c;
      ks[idx] = c < hd ? round_cd<WT>(__ldcg(src + d)) : 0.0f;
      vs[idx] = c < hd ? round_cd<WT>(__ldcg(src + 2 * d)) : 0.0f;
    }
    __syncwarp();
    for (int i = lane; i < T; i += 32) {
      float q[HD];
#pragma unroll
      for (int c = 0; c < HD; ++c)
        q[c] = c < hd ? round_cd<WT>(
                            __ldcg(src0 + static_cast<size_t>(i) * 3 * d + c))
                      : 0.0f;
      float mx = -INFINITY;
      for (int j = 0; j <= i; ++j)
        mx = fmaxf(mx, dot_row<HD>(q, ks + j * HD) * scale);
      float sum = 0.0f;
      for (int j = 0; j <= i; ++j)
        sum += expf(dot_row<HD>(q, ks + j * HD) * scale - mx);
      float o[HD];
#pragma unroll
      for (int c = 0; c < HD; ++c) o[c] = 0.0f;
      for (int j = 0; j <= i; ++j) {
        const float pj = round_cd<WT>(
            expf(dot_row<HD>(q, ks + j * HD) * scale - mx) / sum);
        const float4* v4 = reinterpret_cast<const float4*>(vs + j * HD);
#pragma unroll
        for (int c4 = 0; c4 < HD / 4; ++c4) {
          const float4 vv = v4[c4];
          o[4 * c4] = fmaf(pj, vv.x, o[4 * c4]);
          o[4 * c4 + 1] = fmaf(pj, vv.y, o[4 * c4 + 1]);
          o[4 * c4 + 2] = fmaf(pj, vv.z, o[4 * c4 + 2]);
          o[4 * c4 + 3] = fmaf(pj, vv.w, o[4 * c4 + 3]);
        }
      }
#pragma unroll
      for (int c = 0; c < HD; ++c)
        if (c < hd) out[static_cast<size_t>(i) * d + c] = o[c];
    }
  }
}

// the head width's register row: 16 where it fits, else 64; 0 past a
// window of kMaxT rows or a head of kMaxHeadDim (the loops of
// fused_phases.cuh's attention_phase, K4's attention, take those)
__host__ __device__ constexpr int attention_hd(int T, int hd) {
  return T > kMaxT || hd > kMaxHeadDim ? 0 : hd <= 16 ? 16 : kMaxHeadDim;
}

// the attention's shared memory (floats) for windows of T rows
__host__ __device__ inline size_t attention_floats(int T, int d, int heads) {
  const int hd = d / heads, HD = attention_hd(T, hd);
  if (HD > 0) return kWarps * 2 * static_cast<size_t>(T) * HD;
  const int hs = hd | 1;
  return static_cast<size_t>(kWarps) * hs + 2 * static_cast<size_t>(T) * hs +
         kWarps * static_cast<size_t>(score_rows(T));
}

// kWide: attention_hd 0, K4's attention (a separate instantiation of the
// kernel, so that the default shapes keep their code)
template <typename WT, bool kWide>
__device__ void attention_heads_phase(const float* qkv, int T, int d,
                                      int heads, float* att, float* sm,
                                      int n_streams) {
  if constexpr (kWide) {
    attention_phase<WT, true>(qkv, T, d, heads, att, sm, n_streams);
  } else if (d / heads <= 16) {
    attention_lanes_phase<WT, 16>(qkv, T, d, heads, att, sm, n_streams);
  } else {
    attention_lanes_phase<WT, kMaxHeadDim>(qkv, T, d, heads, att, sm,
                                           n_streams);
  }
}

template <typename WT, bool kWide>
__global__ void __launch_bounds__(kThreads)
fused_recompute_batch_kernel(const float* __restrict__ x,
                             const int* __restrict__ k_last, Weights w,
                             Dims p, Scratch s, float* __restrict__ out,
                             PhaseClock clock) {
  cg::grid_group grid = cg::this_grid();
  clock.start();
  extern __shared__ __align__(16) unsigned char sm_raw[];
  float* sm = reinterpret_cast<float*>(sm_raw);
  const int B = p.B, T = p.T, d = p.d, H = p.H;
  auto W = [](const void* q) { return static_cast<const WT*>(q); };

  for (int b0 = 0; b0 < B; b0 += p.chunk) {
    const int nb = min(p.chunk, B - b0);
    const int R = nb * T;         // rows of this pass
    const float* xc = x + static_cast<size_t>(b0) * T * p.Din;
    float* xin_c = s.xin + static_cast<size_t>(b0) * T * H;
    const int mode = p.vec ? kProdAsync : kProdPlain;
    // the model input enters the in-projection as f32, not rounded
    product<WT>(xc, p.Din, R, p.Din, W(w.w_in), W(w.b_in), d, nullptr, s.x,
                kActNone, kProdIn, p.zero0, sm);
    clock.sync(grid, kPhIn);
    for (int l = 0; l < p.layers; ++l) {
      const Layer& L = w.layer[l];
      product<WT>(s.x, d, R, d, W(L.w_qkv), W(L.b_qkv), 3 * d, nullptr,
                  s.qkv, kActNone, mode, -1, sm);
      clock.sync(grid, kPhQkv);
      attention_heads_phase<WT, kWide>(s.qkv, T, d, p.heads, s.att, sm, nb);
      clock.sync(grid, kPhAttn);
      product<WT>(s.att, d, R, d, W(L.w_o), W(L.b_o), d, s.x, s.a, kActNone,
                  mode, -1, sm);
      clock.sync(grid, kPhAttnOut);
      layernorm_regs_phase(s.a, R, d, L.ln1_s, L.ln1_b, s.x);
      clock.sync(grid, kPhLn1);
      product<WT>(s.x, d, R, d, W(L.w_f1), W(L.b_f1), p.ff, nullptr, s.f,
                  kActRelu, mode, -1, sm);
      clock.sync(grid, kPhFf1);
      product<WT>(s.f, p.ff, R, p.ff, W(L.w_f2), W(L.b_f2), d, s.x, s.a,
                  kActNone, mode, -1, sm);
      clock.sync(grid, kPhFf2);
      layernorm_regs_phase(s.a, R, d, L.ln2_s, L.ln2_b, s.x);
      clock.sync(grid, kPhLn2);
    }
    product<WT>(s.x, d, R, d, W(w.w_ih), W(w.b_r), H, nullptr, xin_c,
                kActNone, mode, -1, sm);
    clock.sync(grid, kPhWih);
  }

  rnn_groups_phase<WT>(grid, s.xin, W(w.w_hh), B, T, H, p.spb, s.hs, sm,
                       WindowRow{T}, UpToLast{k_last});
  clock.closed(kPhRnn);
  tc_product_phase<WT, OutTile>(s.hs + static_cast<size_t>(T & 1) * B * H,
                                H, B, H, W(w.w_out), W(w.b_out), p.S, nullptr,
                                out, 0, kActNone, kProdPlain, -1, sm);
  if (clock.clk != nullptr) clock.sync(grid, kPhOut);
}

inline size_t scratch_total(int B, int T, int d, int ff, int H) {
  const size_t rows = static_cast<size_t>(chunk_streams(B, T)) * T;
  return rows * (6 * static_cast<size_t>(d) + ff) +
         static_cast<size_t>(B) * T * H + 2 * static_cast<size_t>(B) * H;
}

// the RNN: column groups of kRnnCols, the streams split over the groups
// the grid holds; LayerNorm holds a row in registers. False for widths
// outside those limits.
inline bool plan_rnn(Dims* p, int grid) {
  if (p->H > 16 * kRnnKRegs || p->d > 32 * kLnRegs) return false;
  const int n_cg = (p->H + kRnnCols - 1) / kRnnCols;
  p->spb = (p->B + grid / n_cg - 1) / (grid / n_cg);
  return true;
}

// shared memory, one region the phases take in turn: the products'
// stages, attention's rows, or the RNN's columns and hidden states
inline size_t smem_bytes(const Dims& p) {
  const size_t attn = attention_floats(p.T, p.d, p.heads) * sizeof(float);
  size_t smem = product_smem() > attn ? product_smem() : attn;
  if (rnn_groups_smem(p.H) > smem) smem = rnn_groups_smem(p.H);
  return smem;
}

template <typename WT>
int launch(const float* x, const int* k_last, const Weights& w, Dims p,
           float* scratch, float* out, PhaseClock clock,
           cudaStream_t stream) {
  int sms = 0, smem_max = 0;
  const cudaError_t err = device_limits(&sms, &smem_max);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = sms;           // one block per SM, all co-resident
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

  // shared memory, one region the phases take in turn: the products'
  // stages, attention's rows, or the RNN's columns and hidden states
  if (!plan_rnn(&p, grid)) return kErrShape;
  const size_t smem = smem_bytes(p);
  if (smem > static_cast<size_t>(smem_max)) return kErrSmem;
  Weights w_arg = w;
  void* args[] = {&x, &k_last, &w_arg, &p, &s, &out, &clock};
  if (attention_hd(p.T, p.d / p.heads) == 0) {
    static size_t allowed = 0;
    return launch_cooperative(fused_recompute_batch_kernel<WT, true>, grid,
                              smem, args, stream, &allowed);
  }
  static size_t allowed = 0;
  return launch_cooperative(fused_recompute_batch_kernel<WT, false>, grid,
                            smem, args, stream, &allowed);
}

}  // namespace

// The shared memory (bytes) a block of fused_recompute_batch_launch needs
// at these widths on this device, or -1 for a shape outside the kernel's
// limits.
extern "C" long long fused_recompute_batch_smem_bytes(int B, int T, int d,
                                                      int heads, int H) {
  int sms = 0, smem_max = 0;
  if (B < 1 || T < 1 || heads < 1 || d < 1 || d % heads != 0 || H < 1 ||
      device_limits(&sms, &smem_max) != cudaSuccess)
    return -1;
  Dims p{};
  p.B = B;
  p.T = T;
  p.d = d;
  p.heads = heads;
  p.H = H;
  if (!plan_rnn(&p, sms)) return -1;
  return static_cast<long long>(smem_bytes(p));
}

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
// fused_recompute_batch_scratch_floats floats. Any T and head width whose
// tiles fit a block. Returns a CUDA error code, or -1 for a shape outside
// the kernel's limits (or a scratch too small), -2 when the widths need
// more shared memory than a block has (fused_recompute_batch_smem_bytes
// gives the bytes). clock:
// null, or clock_rows rows of 4 u64 for the per-phase clock (PhaseClock).
extern "C" int fused_recompute_batch_launch(
    const void* x, const void* k_last, const void* const* weights, int n_w,
    int is_bf16, int B, int T, int Din, int d, int heads, int ff, int layers,
    int H, int S, int zero0, void* scratch, long long scratch_floats,
    void* out, void* clock, int clock_rows, void* stream) {
  if (B < 1 || T < 1 || layers < 1 || layers > kMaxLayers ||
      n_w != 2 + 12 * layers + 5 || heads < 1 || d < 1 || d % heads != 0 ||
      Din < 1 || ff < 1 || H < 1 || S < 1 ||
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
  // 16-byte copies along every product's rows: the widths a multiple of 8
  // (bf16 rows of 16 bytes), every matrix aligned
  bool vec = d % 8 == 0 && ff % 8 == 0 && H % 8 == 0;
  for (int i = 0; i < n_w; ++i)
    vec = vec && (reinterpret_cast<uintptr_t>(weights[i]) & 15) == 0;
  p.vec = vec ? 1 : 0;
  p.chunk = 0;
  p.spb = 0;
  const float* xf = static_cast<const float*>(x);
  const int* kf = static_cast<const int*>(k_last);
  float* sf = static_cast<float*>(scratch);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PhaseClock ck{static_cast<unsigned long long*>(clock),
                      clock != nullptr ? clock_rows : 0, 0};
  if (is_bf16) return launch<__nv_bfloat16>(xf, kf, w, p, sf, of, ck, st);
  return launch<float>(xf, kf, w, p, sf, of, ck, st);
}
