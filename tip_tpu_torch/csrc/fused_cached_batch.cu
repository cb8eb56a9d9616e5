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
// rings). What the kernel pays instead is a chain of dependent phases, each
// closed by a grid-wide barrier, and a replay's 40 dependent RNN steps.
//
// Design: one block per SM, 256 threads, activations of the B rows in an
// L2-resident f32 scratch; the phases are pool_phases.cuh's, shared with K9.
//   - The layers' products have M = B rows (64 at the timed shape), too few
//     for K9's 80-row tiles (4 tiles of N 256 for 132 SMs). They run as
//     split_product: tiles of 16 rows x 8 NT columns, the depth over the
//     block's 8 warps, on the tensor cores (3xTF32 with f32 step sums for
//     f32 packing, bf16 mma.sync for bf16). NT is the smallest of 1, 2, 4, 8
//     that takes the fewest rounds of the grid: at B = 64 the products of N
//     256 (in-projection, out-projection, ff2), 512 (the RNN inputs) and
//     1024 (ff1) are 128 tiles and qkv (768) 96, one round each, and every
//     SM reads its own part of the weights once. The other choice, K9's
//     row tiles with the depth split over blocks, needs a second pass (and
//     a barrier) to add the partial sums.
//   - The old ring rows' RNN inputs (B W rows x d by d x H) are K9's
//     product, on 80-row tiles (128 tiles at B 64), in the first phase,
//     where they wait for nothing. The carry's product of the carried hidden
//     with W_hh runs there too, and the token's RNN input adds it in its
//     epilogue before the tanh: a carry has no phase for the RNN.
//   - Attention is a warp per (stream, head) (attend_ring_head): a lane a
//     ring slot for the scores, its 16-wide row of k loaded whole, and for
//     the output a lane a channel of every other slot, so that a unit waits
//     on a few rounds of loads, not on W in series; the token's own k and v
//     come from the scratch, so the warp writes its head's slice of the
//     ring row at the cursor right after, with no barrier: no other warp
//     reads that slice. LayerNorm is a warp a row, the row in registers.
//   - The replay's RNN is K9's register-resident walk (rnn_groups_phase):
//     W_hh's columns in registers over groups of 16 columns x groups of
//     streams, one barrier a step. Where that would give a block more than
//     one pass of 16 streams a step (B > 64), a thread keeps 2 columns
//     (groups of 32): half the hidden states staged from L2 a step, twice
//     the products a staged value feeds (at B 256 the walk takes 0.64 ms
//     instead of 0.84; at B 64 it would take 0.31 instead of 0.25: 8
//     streams a block are too little work; an H100 80GB HBM3 at 700 W).
//     Each stream's ring is walked from the slot after the cursor with the
//     validity bits as gates (the token's own step gated by `commit`). No
//     0/1 head-selector products, no chronological pre-gather.
// Barriers (grid.sync), L layers: in-projection 1, each layer 7 (qkv,
// attention, out-projection, LayerNorm, ff1, ff2, LayerNorm), the token's
// RNN input 1, then a replay's W steps: 30 at L = 4 in a carry, 70 in a
// replay over 40 slots. A per-phase clock (PhaseClock) records them when
// asked.

#include "pool_phases.cuh"

namespace {

// The kinds of the phases the per-phase clock (pool_phases.cuh's
// PhaseClock) records, as runtime/streaming_cache.py::K8_PHASES names them:
// the in-projection (with the old ring rows' RNN inputs in a replay, the
// carried hidden's product in a carry), a layer's seven phases, the token's
// RNN input (a carry's RNN step), a replay's walk and the out-projection
enum PhaseKind {
  kPhIn = 1, kPhQkv = 2, kPhAttn = 3, kPhAttnOut = 4, kPhLn1 = 5, kPhFf1 = 6,
  kPhFf2 = 7, kPhLn2 = 8, kPhRnnIn = 9, kPhRnn = 10, kPhOut = 11
};

struct Dims {
  int B;        // streams
  int W;        // ring slots
  int Din, d, heads, ff, layers, H, S;
  int zero0;    // first of the three zeroed input columns
  int slot, rnn_carry;
  int vec;      // the weights' and activations' rows take 16-byte copies
  int spb;      // streams of a block's group in the replay's RNN
  int rnn_cp;   // W_hh columns a thread keeps there (rnn_groups_phase's CP)
};

// global scratch, f32: x (B, d), qkv (B, 3 d), att (B, d), the pre-norm sum
// a (B, d), the feed-forward hidden f (B, ff), the carried hidden's product
// pre (B, H), two hidden-state buffers hs (2, B, H) and, for the replay, the
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

// One head of the token's attention over its stream's ring, by one warp:
// attend_head's function (fused_phases.cuh: the same roundings, the cursor
// slot evicted unless it is the token's own) with the ring's loads in
// parallel, for W < kMaxT slots and hd <= kMaxHeadDim (the other shapes:
// attend_ring_head_wide). A lane scores slots lane and lane + 32, its row of
// k loaded whole before its dot. For the output, where hd divides 32, the
// lanes split into 32 / hd groups over the slots (a lane one channel of
// every group's slots), the groups' sums added by a butterfly; otherwise
// one group, a lane channels lane and lane + 32 (hd <= kMaxHeadDim). q,
// k_own, v_own: the token's own hd values of this head; kr, vr: row 0 of
// the ring at this head's columns, rows ld apart; pw: kMaxT floats of this
// warp.
template <typename WT>
__device__ void attend_ring_head(const float* q, const float* k_own,
                                 const float* v_own, const WT* kr,
                                 const WT* vr, int ld,
                                 const unsigned char* valid, int W, int hd,
                                 int slot, bool own, float* pw, float* out) {
  const int lane = threadIdx.x & 31;
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  float sc[2];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int w = lane + 32 * i;
    sc[i] = -INFINITY;
    if (w < W) {
      const bool own_w = own && w == slot;
      const WT* kw = kr + static_cast<size_t>(w) * ld;
      float s = 0.0f;
#pragma unroll 16
      for (int c = 0; c < hd; ++c)
        s = fmaf(round_cd<WT>(q[c]),
                 own_w ? round_cd<WT>(k_own[c]) : wvalue(kw[c]), s);
      const bool counts = own_w || (valid[w] && w != slot);
      sc[i] = s * scale + (counts ? 0.0f : -1e30f);
      mx = fmaxf(mx, sc[i]);
    }
  }
  mx = warp_max(mx);
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (lane + 32 * i < W) {
      sc[i] = expf(sc[i] - mx);
      sum += sc[i];
    }
  }
  sum = warp_sum(sum);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (lane + 32 * i < W) pw[lane + 32 * i] = round_cd<WT>(sc[i] / sum);
  __syncwarp();
  // groups > 1: every lane has a channel, so the butterfly has all 32 lanes.
  // One group: lanes hd..31 (h > 0) sum slots they never write; lane + 32
  // is a lane's second channel where hd > 32. (Gating one body per lane, or
  // a loop over a lane's channels, makes the f32 phase 1.5x slower on an
  // H100.)
  const int groups = 32 % hd == 0 ? 32 / hd : 1, c = lane % hd, h = lane / hd;
  float o = 0.0f;
#pragma unroll 8
  for (int w = h; w < W; w += groups) {
    const float v = (own && w == slot)
                        ? round_cd<WT>(v_own[c])
                        : wvalue(vr[static_cast<size_t>(w) * ld + c]);
    o = fmaf(pw[w], v, o);
  }
  for (int off = hd; groups > 1 && off < 32; off *= 2)
    o += __shfl_xor_sync(0xffffffffu, o, off);
  if (h == 0) out[c] = round_cd<WT>(o);
  if (lane + 32 < hd) {
    const int c1 = lane + 32;
    float o1 = 0.0f;
    for (int w = 0; w < W; ++w) {
      const float v = (own && w == slot)
                          ? round_cd<WT>(v_own[c1])
                          : wvalue(vr[static_cast<size_t>(w) * ld + c1]);
      o1 = fmaf(pw[w], v, o1);
    }
    out[c1] = round_cd<WT>(o1);
  }
  __syncwarp();
}

// attend_ring_head's function for the shapes it does not hold (W >= kMaxT
// slots or heads wider than kMaxHeadDim), by one warp in loops: a lane
// scores slots lane, lane + 32, ... into pw (score_rows(W) floats of this
// warp), then takes channels lane, lane + 32, ..., each over every slot in
// order. A separate path, so that the narrow shapes keep their code.
template <typename WT>
__device__ void attend_ring_head_wide(const float* q, const float* k_own,
                                      const float* v_own, const WT* kr,
                                      const WT* vr, int ld,
                                      const unsigned char* valid, int W,
                                      int hd, int slot, bool own, float* pw,
                                      float* out) {
  const int lane = threadIdx.x & 31;
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  float mx = -INFINITY;
  for (int w = lane; w < W; w += 32) {
    const bool own_w = own && w == slot;
    const WT* kw = kr + static_cast<size_t>(w) * ld;
    float s = 0.0f;
    for (int c = 0; c < hd; ++c)
      s = fmaf(round_cd<WT>(q[c]),
               own_w ? round_cd<WT>(k_own[c]) : wvalue(kw[c]), s);
    const bool counts = own_w || (valid[w] && w != slot);
    s = s * scale + (counts ? 0.0f : -1e30f);
    pw[w] = s;
    mx = fmaxf(mx, s);
  }
  mx = warp_max(mx);
  float sum = 0.0f;
  for (int w = lane; w < W; w += 32) {
    const float e = expf(pw[w] - mx);
    pw[w] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  for (int w = lane; w < W; w += 32) pw[w] = round_cd<WT>(pw[w] / sum);
  __syncwarp();
  for (int c = lane; c < hd; c += 32) {
    float o = 0.0f;
    for (int w = 0; w < W; ++w) {
      const float v = (own && w == slot)
                          ? round_cd<WT>(v_own[c])
                          : wvalue(vr[static_cast<size_t>(w) * ld + c]);
      o = fmaf(pw[w], v, o);
    }
    out[c] = round_cd<WT>(o);
  }
  __syncwarp();
}

// a warp's attention floats: q, k, v of its head, then its score row
__host__ __device__ constexpr int warp_attn_floats(int W, int hd) {
  return 3 * hd + score_rows(W);
}

template <typename WT>
__global__ void __launch_bounds__(kThreads)
fused_cached_batch_kernel(const float* __restrict__ tok, Weights w, Dims p,
                          Scratch s, Rings r, float* __restrict__ y,
                          PhaseClock clock) {
  cg::grid_group grid = cg::this_grid();
  clock.start();
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
  // f32 activations take cp.async; a ring in bf16 (and any ragged width)
  // plain loads
  const int mode = p.vec ? kProdAsync : kProdPlain;
  const int ring_mode = sizeof(WT) == sizeof(float) ? mode : kProdPlain;

  // ---- the tokens, fixed; the in-projection; what waits for nothing ------
  split_product<WT>(tok, p.Din, B, p.Din, Wt(w.w_in), Wt(w.b_in), d, nullptr,
                    s.x, 0, kActNone, p.vec ? kProdIn : kProdPlain, p.zero0,
                    sm);
  if (p.rnn_carry)
    // the carried hidden's product with W_hh
    split_product<WT, WT>(h_ring, H, B, H, Wt(w.w_hh), nullptr, H, nullptr,
                          s.pre, 0, kActNone, ring_mode, -1, sm);
  else
    // the old ring rows' RNN inputs
    product<WT, WT>(enc, d, B * W, d, Wt(w.w_ih), Wt(w.b_r), H, nullptr,
                    s.xin, kActNone, ring_mode, -1, sm);
  clock.sync(grid, kPhIn);

  for (int l = 0; l < p.layers; ++l) {
    const Layer& L = w.layer[l];
    split_product<WT>(s.x, d, B, d, Wt(L.w_qkv), Wt(L.b_qkv), 3 * d, nullptr,
                      s.qkv, 0, kActNone, mode, -1, sm);
    clock.sync(grid, kPhQkv);
    // ---- attention and the ring write: a warp per (stream, head) -----------
    {
      // q, k, v, then weights; the loops' path past the registers' shapes
      float* mine = sm + warp * warp_attn_floats(W, hd);
      const bool wide = W >= kMaxT || hd > kMaxHeadDim;
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
        float* att = s.att + static_cast<size_t>(b) * d + hh * hd;
        if (wide)
          attend_ring_head_wide<WT>(mine, mine + hd, mine + 2 * hd,
                                    k_ring + ring0, v_ring + ring0, d,
                                    r.valid + b * W, W, hd, p.slot, own,
                                    mine + 3 * hd, att);
        else
          attend_ring_head<WT>(mine, mine + hd, mine + 2 * hd,
                               k_ring + ring0, v_ring + ring0, d,
                               r.valid + b * W, W, hd, p.slot, own,
                               mine + 3 * hd, att);
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
    clock.sync(grid, kPhAttn);
    split_product<WT>(s.att, d, B, d, Wt(L.w_o), Wt(L.b_o), d, s.x, s.a, 0,
                      kActNone, mode, -1, sm);
    clock.sync(grid, kPhAttnOut);
    layernorm_regs_phase(s.a, B, d, L.ln1_s, L.ln1_b, s.x);
    clock.sync(grid, kPhLn1);
    split_product<WT>(s.x, d, B, d, Wt(L.w_f1), Wt(L.b_f1), p.ff, nullptr,
                      s.f, 0, kActRelu, mode, -1, sm);
    clock.sync(grid, kPhFf1);
    split_product<WT>(s.f, p.ff, B, p.ff, Wt(L.w_f2), Wt(L.b_f2), d, s.x,
                      s.a, 0, kActNone, mode, -1, sm);
    clock.sync(grid, kPhFf2);
    layernorm_regs_phase(s.a, B, d, L.ln2_s, L.ln2_b, s.x);
    clock.sync(grid, kPhLn2);
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
    // one step from each stream's carried hidden: tanh(x W_ih + b + h W_hh)
    split_product<WT>(s.x, d, B, d, Wt(w.w_ih), Wt(w.b_r), H, s.pre, s.hs, 0,
                      kActTanh, mode, -1, sm);
    clock.sync(grid, kPhRnnIn);
    h_last = s.hs;
  } else {
    // the token's RNN input takes its slot's place among the ring rows'
    split_product<WT>(s.x, d, B, d, Wt(w.w_ih), Wt(w.b_r), H, nullptr,
                      s.xin + static_cast<size_t>(p.slot) * H, W * H,
                      kActNone, mode, -1, sm);
    clock.sync(grid, kPhRnnIn);
    const RingRow row{W, p.slot};
    const RingGate gate{r.valid, r.commit, W, p.slot};
    if (p.rnn_cp == 2)
      rnn_groups_phase<WT, 2>(grid, s.xin, Wt(w.w_hh), B, W, H, p.spb, s.hs,
                              sm, row, gate);
    else
      rnn_groups_phase<WT, 1>(grid, s.xin, Wt(w.w_hh), B, W, H, p.spb, s.hs,
                              sm, row, gate);
    clock.closed(kPhRnn);
    h_last = s.hs + static_cast<size_t>(W & 1) * B * H;
  }

  // ---- out-projection; the carried hidden; the validity bits at the cursor
  split_product<WT>(h_last, H, B, H, Wt(w.w_out), Wt(w.b_out), p.S, nullptr,
                    y, 0, kActNone, mode, -1, sm);
  if (p.rnn_carry)   // h_ring was last read in the first phase
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < B * H;
         i += gridDim.x * kThreads)
      if (r.commit[i / H]) h_ring[i] = to_ring<WT>(__ldcg(s.hs + i));
  for (int b = blockIdx.x * kThreads + threadIdx.x; b < B;
       b += gridDim.x * kThreads)
    r.valid[b * W + p.slot] = r.commit[b];
  if (clock.clk != nullptr) clock.sync(grid, kPhOut);
}

// scratch floats by part, in the order of Scratch
inline void scratch_parts(const Dims& p, size_t* n) {
  const size_t B = p.B;
  n[0] = B * p.d;
  n[1] = B * 3 * p.d;
  n[2] = B * p.d;
  n[3] = B * p.d;
  n[4] = B * p.ff;
  n[5] = p.rnn_carry ? B * p.H : 0;
  n[6] = 2 * B * p.H;
  n[7] = p.rnn_carry ? 0 : B * p.W * p.H;
}

// the replay's RNN: column groups of 16 columns (32 where 16 would give a
// block more than one pass of streams a step), the streams split over the
// groups the grid holds; LayerNorm holds a row in registers. False for
// widths outside those limits.
inline bool plan_rnn(Dims* p, int grid) {
  if (p->H > 16 * kRnnKRegs || p->d > 32 * kLnRegs) return false;
  if (grid < rnn_groups(p->H, 1)) return false;
  auto group_streams = [&](int cp) {
    const int groups = grid / rnn_groups(p->H, cp);
    return (p->B + groups - 1) / groups;
  };
  p->rnn_cp = group_streams(1) > kRnnPass ? 2 : 1;
  p->spb = group_streams(p->rnn_cp);
  return true;
}

// shared memory, one region the phases take in turn: the products'
// stages, the warps' attention vectors, or the RNN's hidden states
template <typename WT>
size_t smem_bytes(const Dims& p) {
  size_t smem = split_smem<WT>();
  if (!p.rnn_carry) {
    smem = max_bytes(smem, product_smem());
    smem = max_bytes(smem, rnn_groups_smem(p.H, p.rnn_cp));
  }
  const size_t attn = static_cast<size_t>(kWarps) *
                      warp_attn_floats(p.W, p.d / p.heads) * sizeof(float);
  return max_bytes(smem, attn);
}

template <typename WT>
int launch(const float* tok, const Weights& w, Dims p, float* scratch,
           long long scratch_floats, const Rings& r, float* y,
           PhaseClock clock, cudaStream_t stream) {
  int sms = 0, smem_max = 0;
  const cudaError_t err = device_limits(&sms, &smem_max);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = sms;           // one block per SM, all co-resident
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
  if (!plan_rnn(&p, grid)) return kErrShape;
  const size_t smem = smem_bytes<WT>(p);
  if (smem > static_cast<size_t>(smem_max)) return kErrSmem;
  Weights w_arg = w;
  Rings r_arg = r;
  void* args[] = {&tok, &w_arg, &p, &s, &r_arg, &y, &clock};
  static size_t allowed = 0;
  return launch_cooperative(fused_cached_batch_kernel<WT>, grid, smem, args,
                            stream, &allowed);
}

}  // namespace

// The shared memory (bytes) a block of fused_cached_batch_launch needs at
// these widths on this device, or -1 for a shape outside the kernel's
// limits.
extern "C" long long fused_cached_batch_smem_bytes(int is_bf16, int B, int W,
                                                   int d, int heads, int H,
                                                   int rnn_carry) {
  int sms = 0, smem_max = 0;
  if (B < 1 || W < 1 || heads < 1 || d < 1 || d % heads != 0 || H < 1 ||
      device_limits(&sms, &smem_max) != cudaSuccess)
    return -1;
  Dims p{};
  p.B = B;
  p.W = W;
  p.d = d;
  p.heads = heads;
  p.H = H;
  p.rnn_carry = rnn_carry != 0;
  if (!plan_rnn(&p, sms)) return -1;
  return static_cast<long long>(is_bf16 ? smem_bytes<__nv_bfloat16>(p)
                                        : smem_bytes<float>(p));
}

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
// fused_cached_batch_scratch_floats floats. slot in [0, W): any W and head
// width whose tiles fit a block. Returns a CUDA error code, or -1 for a
// shape outside the kernel's limits (or a scratch too small), -2 when the
// widths need more shared memory than a block has
// (fused_cached_batch_smem_bytes gives the bytes).
// clock: null, or clock_rows rows of 4 u64 for the per-phase clock
// (PhaseClock).
extern "C" int fused_cached_batch_launch(
    const void* tok, const void* const* weights, int n_w, int is_bf16, int B,
    int W, int Din, int d, int heads, int ff, int layers, int H, int S,
    int zero0, int slot, int rnn_carry, const void* commit, void* k, void* v,
    void* enc, void* h, void* valid, void* scratch, long long scratch_floats,
    void* y, void* clock, int clock_rows, void* stream) {
  if (B < 1 || W < 1 || layers < 1 || layers > kMaxLayers ||
      n_w != 2 + 12 * layers + 5 || heads < 1 || d < 1 || d % heads != 0 ||
      Din < 1 || ff < 1 || H < 1 || S < 1 ||
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
  p.spb = 0;
  p.rnn_cp = 1;
  // 16-byte copies along every product's rows: the widths a multiple of 8
  // (bf16 rows of 16 bytes), every matrix and ring aligned
  bool vec = d % 8 == 0 && ff % 8 == 0 && H % 8 == 0;
  for (int i = 0; i < n_w; ++i)
    vec = vec && (reinterpret_cast<uintptr_t>(weights[i]) & 15) == 0;
  const void* rings[] = {k, v, enc, h};
  for (const void* q : rings)
    vec = vec && (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  p.vec = vec ? 1 : 0;
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
  const PhaseClock ck{static_cast<unsigned long long*>(clock),
                      clock != nullptr ? clock_rows : 0, 0};
  if (is_bf16)
    return launch<__nv_bfloat16>(tf, w, p, sf, scratch_floats, r, yf, ck, st);
  return launch<float>(tf, w, p, sf, scratch_floats, r, yf, ck, st);
}
