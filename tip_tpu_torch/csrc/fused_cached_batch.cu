// K8 fused_cached_batch: one streaming token of each of B streams through
// the whole KV-cached model in one cooperative launch, at one ring cursor
// shared by all streams (a pool that ticks together).
//
// Replaces tip_tpu/runtime/streaming_cache.py::fused_cached_batch (Pallas
// kernel _fused_cached_batch_kernel and the XLA ops around it): the
// in-projection of B tokens, L post-norm encoder layers in which each
// (stream, head) attends with one query over its stream's K/V ring plus the
// token itself, the encoder-output ring, the tanh RNN head (one step from
// each stream's carried hidden, or a replay from zero over each stream's
// valid ring slots in chronological order) and the out-projection. The
// token at the cursor is evicted for every stream. A stream whose `commit`
// flag is set gets its rounded rows written into the rings at the cursor,
// in place, its hidden state stored and its validity bit set; a stream
// whose flag is clear keeps its ring rows and hidden state and has its bit
// at the cursor cleared.
//
// What bounds it on the H100: bytes. At B = 64 the K/V rings of the pool are
// 21 MB in f32 (10.5 MB in bf16) and are read once, beside 14.7 MB (7.3 MB)
// of packed weights, about 11 microseconds at the card's memory rate, where
// the products are 0.45 GFLOP (carry) or 3.8 GFLOP (a replay over full
// rings). What the kernel pays instead is the chain of dependent phases,
// each closed by a grid-wide barrier, and CUDA-core products.
//
// Barriers (grid.sync), L layers: in-projection 1, each layer 7 (qkv,
// attention, out-projection, LayerNorm, ff1, ff2, LayerNorm), then
//   rnn_carry:  2 (both RNN products)             = 31 at L = 4
//   replay:     1 (the token's RNN input) + W     = 70 at L = 4, W = 40
//
// Design: one block per SM, 256 threads, activations of the B rows in an
// L2-resident f32 scratch read with ld.cg. With B rows the products are
// real matrix products, so they are the windowed kernels' product_phase (4
// rows x 256 columns a unit, rows staged and rounded once in shared
// memory), not the single-stream step's matrix-vector cut. Attention is a
// warp per (stream, head): a 16-wide dot over the W ring slots with the
// token's own k and v taken from the scratch, so the warp can write its
// head's slice of the ring row at the cursor right after, with no barrier:
// no other warp reads that slice. No 0/1 head-selector products, no
// chronological pre-gather: the replay walks each stream's ring from the
// slot after the cursor with the validity bits as gates
// (rnn_batch_phase: W_hh's columns split over the grid and resident in
// shared memory, the B hidden states in the scratch, a barrier a step). The
// RNN inputs of the old ring rows (B W x d by d x H) are computed in the
// first phase, where they wait for nothing; the token's own replaces its
// slot's after the layers.

#include "fused_phases.cuh"

namespace {

constexpr int kXinRows = 16;      // rows of a unit of the old rows' product

struct Dims {
  int B;        // streams
  int W;        // ring slots
  int Din, d, heads, ff, layers, H, S;
  int zero0;    // first of the three zeroed input columns
  int slot, rnn_carry;
  int cpb;      // W_hh columns per block in the replay
  int rnn_off;  // byte offset of the replay's shared-memory region
};

// global scratch, f32: x (B, d), qkv (B, 3 d), att (B, d), the pre-norm sum
// a (B, d), the feed-forward hidden f (B, ff), the token's RNN input pre
// (B, H), two hidden-state buffers hs (2, B, H) and, for the replay, the
// ring rows' RNN inputs xin (B, W, H)
struct Scratch {
  float *x, *qkv, *att, *a, *f, *pre, *hs, *xin;
};

struct Rings {
  void *k, *v;                    // (B, layers, W, d), packing dtype
  void *enc;                      // (B, W, d)
  void *h;                        // (B, H)
  unsigned char* valid;           // (B, W) bool
  const unsigned char* commit;    // (B,) bool
};

// ring row and gate of replay step t of stream b: the walk starts at the
// slot after the cursor and ends on the cursor, the token itself
struct RingRow {
  int W, slot;
  __device__ int operator()(int b, int t) const {
    return b * W + (slot + 1 + t) % W;
  }
};
struct RingGate {
  const unsigned char* valid;
  const unsigned char* commit;
  int W, slot;
  __device__ bool operator()(int b, int t) const {
    const int idx = (slot + 1 + t) % W;
    return idx == slot ? commit[b] != 0 : valid[b * W + idx] != 0;
  }
};

template <typename WT>
__global__ void __launch_bounds__(kThreads)
fused_cached_batch_kernel(const float* __restrict__ tok, Weights w, Dims p,
                          Scratch s, Rings r, float* __restrict__ y) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char sm_raw[];
  float* sm = reinterpret_cast<float*>(sm_raw);
  const int B = p.B, d = p.d, H = p.H, W = p.W;
  const int hd = d / p.heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto Wt = [](const void* q) { return static_cast<const WT*>(q); };
  WT* k_ring = static_cast<WT*>(r.k);
  WT* v_ring = static_cast<WT*>(r.v);
  WT* enc = static_cast<WT*>(r.enc);
  WT* h_ring = static_cast<WT*>(r.h);

  // ---- the tokens, fixed and rounded; the in-projection --------------------
  product_phase<WT>(tok, p.Din, B, p.Din, Wt(w.w_in), Wt(w.b_in), d, nullptr,
                    s.x, kActNone, true, p.zero0, sm);
  if (!p.rnn_carry)
    // the old ring rows' RNN inputs wait for nothing
    product_phase<WT, WT, kXinRows>(enc, d, B * W, d, Wt(w.w_ih), Wt(w.b_r),
                                    H, nullptr, s.xin, kActNone, false, -1,
                                    sm);
  grid.sync();

  for (int l = 0; l < p.layers; ++l) {
    const Layer& L = w.layer[l];
    product_phase<WT>(s.x, d, B, d, Wt(L.w_qkv), Wt(L.b_qkv), 3 * d, nullptr,
                      s.qkv, kActNone, true, -1, sm);
    grid.sync();
    // ---- attention and the ring write: a warp per (stream, head) -----------
    {
      float* mine = sm + warp * (3 * hd + kMaxT);   // q, k, v, then weights
      for (int unit = blockIdx.x * kWarps + warp; unit < B * p.heads;
           unit += gridDim.x * kWarps) {
        const int b = unit / p.heads, hh = unit - b * p.heads;
        const float* src = s.qkv + static_cast<size_t>(b) * 3 * d + hh * hd;
        for (int c = lane; c < 3 * hd; c += 32) {
          const int part = c / hd;
          mine[c] = __ldcg(src + part * d + (c - part * hd));
        }
        __syncwarp();
        const bool own = r.commit[b] != 0;
        const size_t ring0 =
            (static_cast<size_t>(b) * p.layers + l) * W * d + hh * hd;
        attend_head<WT>(mine, mine + hd, mine + 2 * hd, k_ring + ring0,
                        v_ring + ring0, d, r.valid + b * W, W, hd, p.slot,
                        own, true, mine + 3 * hd,
                        s.att + static_cast<size_t>(b) * d + hh * hd);
        if (own) {
          const size_t at = ring0 + static_cast<size_t>(p.slot) * d;
          for (int c = lane; c < hd; c += 32) {
            k_ring[at + c] = to_ring<WT>(mine[hd + c]);
            v_ring[at + c] = to_ring<WT>(mine[2 * hd + c]);
          }
        }
        __syncwarp();
      }
    }
    grid.sync();
    product_phase<WT>(s.att, d, B, d, Wt(L.w_o), Wt(L.b_o), d, s.x, s.a,
                      kActNone, true, -1, sm);
    grid.sync();
    layernorm_phase(s.a, B, d, L.ln1_s, L.ln1_b, s.x);
    grid.sync();
    product_phase<WT>(s.x, d, B, d, Wt(L.w_f1), Wt(L.b_f1), p.ff, nullptr,
                      s.f, kActRelu, true, -1, sm);
    grid.sync();
    product_phase<WT>(s.f, p.ff, B, p.ff, Wt(L.w_f2), Wt(L.b_f2), d, s.x, s.a,
                      kActNone, true, -1, sm);
    grid.sync();
    layernorm_phase(s.a, B, d, L.ln2_s, L.ln2_b, s.x);
    grid.sync();
  }

  // ---- the encoder ring, in both RNN variants: nobody reads it from here --
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < B * d;
       i += gridDim.x * kThreads) {
    const int b = i / d, c = i - b * d;
    if (r.commit[b])
      enc[(static_cast<size_t>(b) * W + p.slot) * d + c] =
          to_ring<WT>(__ldcg(s.x + i));
  }

  // ---- RNN head: the last hidden states, f32, in h_last ----------------------
  const float* h_last;
  if (p.rnn_carry) {
    // one step from each stream's carried hidden
    product_phase<WT>(s.x, d, B, d, Wt(w.w_ih), Wt(w.b_r), H, nullptr, s.pre,
                      kActNone, true, -1, sm);
    grid.sync();
    product_phase<WT>(h_ring, H, B, H, Wt(w.w_hh),
                      static_cast<const WT*>(nullptr), H, s.pre, s.hs,
                      kActTanh, false, -1, sm);
    grid.sync();
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < B * H;
         i += gridDim.x * kThreads)
      if (r.commit[i / H]) h_ring[i] = to_ring<WT>(__ldcg(s.hs + i));
    h_last = s.hs;
  } else {
    // the token's RNN input takes its slot's place among the ring rows'
    product_phase<WT>(s.x, d, B, d, Wt(w.w_ih), Wt(w.b_r), H, nullptr,
                      s.xin + static_cast<size_t>(p.slot) * H, kActNone, true,
                      -1, sm, W * H);
    grid.sync();
    rnn_batch_phase<WT>(grid, s.xin, Wt(w.w_hh), B, W, H, p.cpb, s.hs,
                        sm_raw + p.rnn_off, RingRow{W, p.slot},
                        RingGate{r.valid, r.commit, W, p.slot});
    h_last = s.hs + static_cast<size_t>(W & 1) * B * H;
  }

  // ---- out-projection; the validity bits at the cursor ----------------------
  product_phase<WT>(h_last, H, B, H, Wt(w.w_out), Wt(w.b_out), p.S, nullptr, y,
                    kActNone, true, -1, sm);
  for (int b = blockIdx.x * kThreads + threadIdx.x; b < B;
       b += gridDim.x * kThreads)
    r.valid[b * W + p.slot] = r.commit[b];
}

// scratch floats by part, in the order of Scratch
inline void scratch_parts(const Dims& p, size_t* n) {
  const size_t B = p.B;
  n[0] = B * p.d;
  n[1] = B * 3 * p.d;
  n[2] = B * p.d;
  n[3] = B * p.d;
  n[4] = B * p.ff;
  n[5] = B * p.H;
  n[6] = 2 * B * p.H;
  n[7] = p.rnn_carry ? 0 : B * p.W * p.H;
}

template <typename WT>
int launch(const float* tok, const Weights& w, Dims p, float* scratch,
           long long scratch_floats, const Rings& r, float* y,
           cudaStream_t stream) {
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const int grid = sms;           // one block per SM, all co-resident
  p.cpb = (p.H + grid - 1) / grid;
  size_t n[8], total = 0;
  scratch_parts(p, n);
  for (int i = 0; i < 8; ++i) total += n[i];
  if (scratch_floats < 0 || static_cast<size_t>(scratch_floats) < total)
    return kErrShape;
  Scratch s;
  float** bufs[] = {&s.x, &s.qkv, &s.att, &s.a, &s.f, &s.pre, &s.hs, &s.xin};
  for (int i = 0; i < 8; ++i) {
    *bufs[i] = scratch;
    scratch += n[i];
  }

  // shared memory: the phases' staging region (a product unit's rows, or
  // the warps' attention vectors), then the replay's region
  int k_max = p.Din;
  if (p.d > k_max) k_max = p.d;
  if (p.ff > k_max) k_max = p.ff;
  if (p.H > k_max) k_max = p.H;
  size_t stage = static_cast<size_t>(kRows) * k_max;
  if (!p.rnn_carry && static_cast<size_t>(kXinRows) * p.d > stage)
    stage = static_cast<size_t>(kXinRows) * p.d;
  const size_t attn =
      static_cast<size_t>(kWarps) * (3 * (p.d / p.heads) + kMaxT);
  if (attn > stage) stage = attn;
  const size_t stage_bytes = (stage * sizeof(float) + 15) / 16 * 16;
  size_t rnn_bytes = 0;
  if (!p.rnn_carry)
    rnn_bytes = (static_cast<size_t>(p.cpb) * p.H * sizeof(WT) + 15) / 16 * 16 +
                static_cast<size_t>(kRnnRows) * p.H * sizeof(float);
  const size_t smem = stage_bytes + rnn_bytes;
  if (smem > static_cast<size_t>(smem_max)) return kErrSmem;
  p.rnn_off = static_cast<int>(stage_bytes);
  Weights w_arg = w;
  Rings r_arg = r;
  void* args[] = {&tok, &w_arg, &p, &s, &r_arg, &y};
  return launch_cooperative(fused_cached_batch_kernel<WT>, grid, smem, args,
                            stream);
}

}  // namespace

// The least scratch (in floats) fused_cached_batch_launch takes, so that
// the caller can allocate it.
extern "C" int fused_cached_batch_scratch_floats(int B, int W, int d, int ff,
                                                 int H, int rnn_carry) {
  Dims p;
  p.B = B;
  p.W = W;
  p.d = d;
  p.ff = ff;
  p.H = H;
  p.rnn_carry = rnn_carry;
  size_t n[8], total = 0;
  scratch_parts(p, n);
  for (int i = 0; i < 8; ++i) total += n[i];
  return total > 0x7fffffffu ? -1 : static_cast<int>(total);
}

// weights: the packed list of ops/fused_forward.py::pack_weights, n_w =
// 2 + 12 * layers + 5 device pointers. tok (B, Din) f32; commit (B,) bytes;
// k, v (B, layers, W, d), enc (B, W, d), h (B, H) in the packing dtype,
// valid (B, W) bytes; y (B, S) f32; scratch: at least
// fused_cached_batch_scratch_floats floats. slot in [0, W). Returns a CUDA
// error code, or -1 for a shape outside the kernel's limits (or a scratch
// too small), -2 when the widths need more shared memory than a block has.
extern "C" int fused_cached_batch_launch(
    const void* tok, const void* const* weights, int n_w, int is_bf16, int B,
    int W, int Din, int d, int heads, int ff, int layers, int H, int S,
    int zero0, int slot, int rnn_carry, const void* commit, void* k, void* v,
    void* enc, void* h, void* valid, void* scratch, long long scratch_floats,
    void* y, void* stream) {
  if (B < 1 || W < 1 || W >= kMaxT || layers < 1 || layers > kMaxLayers ||
      n_w != 2 + 12 * layers + 5 || heads < 1 || d < 1 || d % heads != 0 ||
      d / heads > kMaxHeadDim || Din < 1 || ff < 1 || H < 1 || S < 1 ||
      slot < 0 || slot >= W ||
      static_cast<long long>(B) * W * (H > d ? H : d) > 0x7fffffffLL)
    return kErrShape;
  const Weights w = unpack_weights(weights, layers);
  Dims p;
  p.B = B;
  p.W = W;
  p.Din = Din;
  p.d = d;
  p.heads = heads;
  p.ff = ff;
  p.layers = layers;
  p.H = H;
  p.S = S;
  p.zero0 = zero0;
  p.slot = slot;
  p.rnn_carry = rnn_carry != 0;
  p.cpb = 0;
  p.rnn_off = 0;
  Rings r;
  r.k = k;
  r.v = v;
  r.enc = enc;
  r.h = h;
  r.valid = static_cast<unsigned char*>(valid);
  r.commit = static_cast<const unsigned char*>(commit);
  const float* tf = static_cast<const float*>(tok);
  float* sf = static_cast<float*>(scratch);
  float* yf = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(tf, w, p, sf, scratch_floats, r, yf, st);
  return launch<float>(tf, w, p, sf, scratch_floats, r, yf, st);
}
