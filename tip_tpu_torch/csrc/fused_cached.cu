// K7 fused_cached_forward_step: one streaming token through the whole
// KV-cached model in one cooperative launch.
//
// Replaces tip_tpu/runtime/streaming_cache.py::fused_cached_forward_step
// (wrapper _fused_cached_step_slot, Pallas kernel _fused_cached_kernel):
// in-projection of the newest token, L post-norm encoder layers that attend
// over per-layer K/V rings (W slots, the token's own rounded row written at
// `slot` first), the encoder-output ring, the tanh RNN head (one step from
// the carried hidden, or a replay from zero over the ring's valid slots in
// chronological order) and the out-projection. The rings, the hidden and
// the validity bits are updated in place when `commit` is set and are left
// bit-identical when it is not.
//
// What bounds it on the H100: bytes. Every packed weight is read once: 3.66
// M values, 7.3 MB in bf16 and 14.7 MB in f32, against rings of 0.16 / 0.33
// MB and about 7 MFLOP (carry) or 38 MFLOP (replay over a full ring): 2-4
// microseconds at the card's memory rate. What the kernel pays instead is
// latency: a chain of dependent matrix-vector products, each closed by a
// grid-wide barrier.
//
// Barriers (grid.sync), L layers: in-projection 1, each layer 4 (after qkv,
// after the out-projection, after ff1, after ff2), the RNN input product 1,
// the out-projection 1: 19 at L = 4 in both variants; a replay's walk has
// none.
//
// Design: one block per SM, 256 threads. One row has no rows to hand out,
// so a product is split over the grid by output columns AND by slices of K:
// a unit is 32 columns x one K-slice, a warp per row of the slice (a
// coalesced 32-wide weight load), lanes over the columns, the 8 warps'
// sums added in shared memory, and the unit's partial sum stored to an
// L2-resident scratch. The slices are sized so that every product has about
// as many units as the grid has blocks (ff2, 1024 x 256, becomes 128 units
// of 64 x 32 instead of one block streaming 1 MB). The consumer of a
// product is every block: after the barrier it adds the partial sums in a
// fixed order (their loads issued together), the bias and the residual, and
// runs LayerNorm or ReLU on the one row in its own shared memory, so the
// vector work costs no phase and no barrier. Attention rides in the
// out-projection's units: a unit needs only the heads of its K-slice,
// computes them from the rings (attend_heads: the heads side by side, each
// on its share of the warps; the token's own row comes from shared memory,
// so the ring write needs no barrier before the read) and multiplies on. Block 0 does the in-place writes.
//
// What the per-phase clock of the first version showed, carry f32 at slot 7
// of full rings, 0.104 ms (an H100 80GB HBM3 at 700 W): attention with the
// out-projection 8 us a layer (the output's W slots in series on one warp),
// the other products 3.4-4 us each, barriers 0.85 us each; a replay's walk,
// a grid barrier a step, 2.15 us a step. The column tiles over the whole
// depth that K4/K5 take were slower here (5-12 us a phase: every block
// reads the one input row), and a unit's weights loaded into registers
// before the barrier gained nothing (a grid barrier waits for a block's
// outstanding loads). So the split-K units stay, their partial sums'
// loads are issued together, attention's output is spread over the warps,
// and a replay computes the old ring rows' RNN inputs (W x d by d x H, a
// tile of rows x columns a block, fused_phases.cuh's rows_product over a
// slice copied into shared memory at launch) in the first phase, where they
// wait for nothing, replaces the new token's row after the layers, and
// walks the valid slots with walk_phase: W_hh's columns over the blocks
// (copied at launch too), the hidden state through L2 as (value, step)
// pairs, no barrier. Ring rows other than `slot` are never written in a
// launch; `slot` is written by block 0 and read by nobody.

#include "fused_phases.cuh"

namespace {

constexpr int kTile = 32;         // columns of a matrix-vector unit
constexpr int kMaxGrid = 256;     // blocks the partial-sum buffers allow

// The kinds of the phases the per-phase clock (PhaseClock) records, as
// runtime/streaming_cache.py::K7_PHASES names them: the in-projection (with
// a replay's old ring rows' RNN inputs), qkv, attention with the
// out-projection, the feed-forward's two products, the RNN inputs (a
// carry's whole step), a replay's walk and the out-projection
enum PhaseKind {
  kPhIn = 1, kPhQkv = 2, kPhAttnOut = 3, kPhFf1 = 4, kPhFf2 = 5,
  kPhRnnIn = 6, kPhRnn = 7, kPhOut = 8
};

struct Dims {
  int W;        // ring slots
  int Din, d, heads, ff, layers, H, S;
  int zero0;    // first of the three zeroed input columns
  int slot, commit, rnn_carry;
  int cap;      // floats of one partial-sum buffer
  int stage;    // floats of a replay's staged ring rows and their sums
};

// global scratch, f32: partial sums of each product, and the replay's RNN
// inputs (W, H) and its walk's (value, step) pairs (W, H)
struct Scratch {
  float *p_in, *p_qkv, *p_o, *p_f1, *p_f2, *p_ih, *p_hh, *p_out, *xin;
  unsigned long long* hp;
};

struct Rings {
  void *k, *v, *enc, *h;          // packing dtype
  unsigned char* valid;           // (W,) bool
};

// how a (K, N) product is cut: n_ct column tiles x n_ks slices of ks rows
struct Split {
  int n_ct, n_ks, ks;
};

__host__ __device__ inline Split split_of(int K, int N, int grid) {
  Split c;
  c.n_ct = (N + kTile - 1) / kTile;
  int n_ks = grid / c.n_ct;
  const int most = (K + kTile - 1) / kTile;      // slices of >= 32 rows
  if (n_ks > most) n_ks = most;
  if (n_ks < 1) n_ks = 1;
  c.ks = ((K + n_ks - 1) / n_ks + kWarps - 1) / kWarps * kWarps;
  c.n_ks = (K + c.ks - 1) / c.ks;
  return c;
}

// part[ks][n] = sum over the slice's rows k of vin[k] W[k][n]: one unit.
// vin (shared memory) holds the rounded input. red: [kWarps][kTile].
template <typename WT>
__device__ void matvec_unit(const float* vin, const WT* __restrict__ W, int K,
                            int N, const Split& c, int unit, float* part,
                            float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ct = unit % c.n_ct, ks = unit / c.n_ct;
  const int n = ct * kTile + lane;
  const int k0 = ks * c.ks, k1 = min(K, k0 + c.ks);
  float acc = 0.0f;
  if (n < N) {
    const WT* wp = W + n;
#pragma unroll 4
    for (int k = k0 + warp; k < k1; k += kWarps)
      acc = fmaf(vin[k], wload(wp + static_cast<size_t>(k) * N), acc);
  }
  red[warp * kTile + lane] = acc;
  __syncthreads();
  if (warp == 0 && n < N) {
    float s = red[lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w * kTile + lane];
    part[static_cast<size_t>(ks) * N + n] = s;
  }
  __syncthreads();
}

template <typename WT>
__device__ void matvec_phase(const float* vin, const WT* __restrict__ W,
                             int K, int N, float* part, float* red) {
  const Split c = split_of(K, N, gridDim.x);
  for (int unit = blockIdx.x; unit < c.n_ct * c.n_ks; unit += gridDim.x)
    matvec_unit<WT>(vin, W, K, N, c, unit, part, red);
}

// element i of a product whose partial sums another phase stored, added in
// slice order; their loads issued together, eight at a time
__device__ __forceinline__ float gather(const float* part, int n_ks, int N,
                                        int i) {
  float s = 0.0f;
  for (int k0 = 0; k0 < n_ks; k0 += 8) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = k0 + j < n_ks
                 ? __ldcg(part + static_cast<size_t>(k0 + j) * N + i)
                 : 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (k0 + j < n_ks) s = k0 + j == 0 ? v[j] : s + v[j];
  }
  return s;
}

// v (shared, d floats) <- LayerNorm(v) * s + b, f32, biased variance, eps
// 1e-5. Every warp computes the statistics for itself (no exchange), then
// the block writes. Ends synchronised.
__device__ inline void layernorm_row(float* v, int d,
                                     const float* __restrict__ s,
                                     const float* __restrict__ b) {
  const int lane = threadIdx.x & 31;
  __syncthreads();
  float sum = 0.0f;
  for (int c = lane; c < d; c += 32) sum += v[c];
  const float mu = warp_sum(sum) / static_cast<float>(d);
  float sq = 0.0f;
  for (int c = lane; c < d; c += 32) {
    const float dv = v[c] - mu;
    sq = fmaf(dv, dv, sq);
  }
  const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(d) + 1e-5f);
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += kThreads)
    v[c] = (v[c] - mu) * rstd * __ldg(s + c) + __ldg(b + c);
  __syncthreads();
}

// Attention of the newest token for heads h_lo..h_hi over layer ring rows
// kr, vr (W, d), by the block: out[c] = round(sum_w round(softmax_w(q . k_w
// / sqrt(hd) + mask_w)) v_w[c]) for each head, q, k, the weights and v
// rounded to WT. The heads run side by side, kWarps / (their count) warps
// each: the group's first warp scores the slots (a lane a slot) and takes
// the softmax, then warp i of the group adds the slots i, i + (its
// warps), ... for every channel (a lane a channel) and the group's partial
// sums are added in warp order (the first version ran each head's W slots
// in series on one warp: 4.5 us of a layer's 8, an H100 80GB HBM3 at 700
// W). Slot `slot` is the token itself when committed: its k and v come
// from qkv (shared memory), not from the ring, so the ring row may be
// written while this runs. A slot that is not valid gets the additive
// -1e30: its weight is an exact 0 unless no slot counts at all (uniform
// weights over whatever the ring holds, as the plain versions). A lane
// takes slots lane, lane + 32, ... and channels lane, lane + 32, ..., so
// any W and head width run. ps: attend_floats(W, hd) floats (a group's
// score row of score_rows(W), then a warp's hd partial sums).
__host__ __device__ constexpr int attend_floats(int W, int hd) {
  return kWarps * (score_rows(W) + (hd > kMaxHeadDim ? hd : kMaxHeadDim));
}

template <typename WT>
__device__ void attend_heads(const float* qkv, const WT* kr, const WT* vr,
                             const unsigned char* valid, const Dims& p,
                             int h_lo, int h_hi, float* att, float* ps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = p.d, hd = p.d / p.heads, W = p.W, slot = p.slot;
  const bool own = p.commit != 0;
  const int nh = h_hi - h_lo + 1;
  const int wph = nh >= kWarps ? 1 : kWarps / nh;    // warps of a head
  const int groups = kWarps / wph, g = warp / wph, part = warp % wph;
  const int pst = score_rows(W);
  float* pw = ps + g * pst;                           // [groups][pst]
  float* red = ps + kWarps * pst;                     // [kWarps][hd]
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  for (int h0 = h_lo; h0 <= h_hi; h0 += groups) {
    const int hh = h0 + g;
    const bool mine = g < groups && hh <= h_hi;
    const float* q = qkv + hh * hd;
    const float* k_own = q + d;
    const float* v_own = q + 2 * d;
    const WT* kh = kr + hh * hd;
    const WT* vh = vr + hh * hd;
    if (mine && part == 0) {
      float mx = -INFINITY;
      for (int w = lane; w < W; w += 32) {
        const bool own_w = own && w == slot;
        float s = 0.0f;
        if (own_w) {
          for (int c = 0; c < hd; ++c)
            s = fmaf(round_cd<WT>(q[c]), round_cd<WT>(k_own[c]), s);
        } else {
          const WT* kw = kh + static_cast<size_t>(w) * d;
          for (int c = 0; c < hd; ++c)
            s = fmaf(round_cd<WT>(q[c]), wvalue(kw[c]), s);
        }
        s = s * scale + (own_w || valid[w] ? 0.0f : -1e30f);
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
    }
    __syncthreads();
    if (mine)
      for (int c = lane; c < hd; c += 32) {
        float o = 0.0f;
        for (int w = part; w < W; w += wph) {
          const float v = (own && w == slot)
                              ? round_cd<WT>(v_own[c])
                              : wvalue(vh[static_cast<size_t>(w) * d + c]);
          o = fmaf(pw[w], v, o);
        }
        red[warp * hd + c] = o;
      }
    __syncthreads();
    for (int e = threadIdx.x; e < groups * hd; e += kThreads) {
      const int gi = e / hd, c = e - gi * hd;
      if (h0 + gi <= h_hi) {
        float o = 0.0f;
        for (int i = 0; i < wph; ++i) o += red[(gi * wph + i) * hd + c];
        att[(h0 + gi) * hd + c] = round_cd<WT>(o);
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// a replay's two weight slices in shared memory
// ---------------------------------------------------------------------------

// The ring rows' RNN inputs are a tile product (fused_phases.cuh's
// rows_product): the W rows in up to kRowGroups groups, each group's H
// columns in up to kColTiles tiles, a tile's columns a multiple of q.
__host__ __device__ inline Cut cut_of(int R, int N, int G, int q) {
  Cut c;
  const int n_rg = R < kRowGroups ? R : kRowGroups;
  c.rg = (R + n_rg - 1) / n_rg;
  c.n_rg = (R + c.rg - 1) / c.rg;
  const int per = G / c.n_rg < kColTiles ? G / c.n_rg : kColTiles;
  c.nc = ((N + per - 1) / per + q - 1) / q * q;
  c.n_ct = (N + c.nc - 1) / c.nc;
  return c;
}

// q: 16 bytes of WT where rows of N values stay 16-byte aligned, else 1
template <typename WT>
__host__ __device__ inline Cut cut_for(int R, int N, int G) {
  const int z = sizeof(WT);
  return cut_of(R, N, G, (N * z) % 16 == 0 ? 16 / z : 1);
}

// block b's tile of cut_for(R, N, G) as a slice of a (K, N) weight, or none
template <typename WT>
__host__ __device__ inline Slice tile_slice(const void* w, int R, int K,
                                            int N, int G, int b) {
  const Cut c = cut_for<WT>(R, N, G);
  if (b >= c.n_rg * c.n_ct) return no_slice();
  const int n0 = (b % c.n_ct) * c.nc;
  return Slice{w, K, N, n0, c.nc < N - n0 ? c.nc : N - n0};
}

// A slice whose rows are whole 16-byte chunks is copied into shared memory
// as it lies, [K][nc] in WT; another is read value by value and widened to
// f32 [K][ldw] (ldw: nc rounded up to 4).
template <typename WT>
__host__ __device__ inline bool slice_vec(const Slice& s) {
  const int z = sizeof(WT);
  return (reinterpret_cast<uintptr_t>(s.w) & 15) == 0 &&
         (s.N * z) % 16 == 0 && (s.n0 * z) % 16 == 0 && (s.nc * z) % 16 == 0;
}

__host__ __device__ inline int slice_ldw(const Slice& s) {
  return (s.nc + 3) / 4 * 4;
}

// floats of a slice in shared memory, in the form it lies in there
template <typename WT>
__host__ __device__ inline int slice_floats(const Slice& s) {
  return slice_vec<WT>(s)
             ? s.K * s.nc * static_cast<int>(sizeof(WT)) / 4
             : s.K * slice_ldw(s);
}

// a slice into shared memory: by cp.async as it lies (the caller commits
// and waits), or widened to f32 by plain loads where it is not slice_vec
template <typename WT>
__device__ void copy_slice(const Slice& s, float* dst) {
  if (s.nc <= 0) return;
  const int z = sizeof(WT);
  if (slice_vec<WT>(s)) {
    const int q = s.nc * z / 16;
    const char* src = static_cast<const char*>(s.w) + s.n0 * z;
    for (int e = threadIdx.x; e < s.K * q; e += kThreads) {
      const int k = e / q, c = e - k * q;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_addr(reinterpret_cast<char*>(dst) +
                                 static_cast<size_t>(k) * s.nc * z + 16 * c)),
                   "l"(src + static_cast<long long>(k) * s.N * z + 16 * c));
    }
  } else {
    const int ldw = slice_ldw(s);
    const WT* w = static_cast<const WT*>(s.w);
    for (int e = threadIdx.x; e < s.K * ldw; e += kThreads) {
      const int k = e / ldw, c = e - k * ldw;
      dst[e] = c < s.nc ? wload(w + static_cast<size_t>(k) * s.N + s.n0 + c)
                        : 0.0f;
    }
  }
}

// a replay's shared memory beyond the head: the old ring rows' slice of
// W_ih ([d][nc] as it lies, or widened), their staged rows and partial
// sums, the walk's slice of W_hh and its hidden state and sums
template <typename WT>
struct ReplayPlan {
  Slice ih, hh;
  int rg, n_rows;                 // rows of the block's group, its first row
  int ih_floats, hh_floats;       // floats of the two slices in shared memory
  int rows_floats, red_floats;    // staged rows, their partial sums
  int walk_floats;
};

template <typename WT>
__host__ __device__ inline ReplayPlan<WT> replay_plan(const Weights& w,
                                                      const Dims& p, int G,
                                                      int b) {
  ReplayPlan<WT> q;
  q.ih = tile_slice<WT>(w.w_ih, p.W, p.d, p.H, G, b);
  q.hh = walk_slice(w.w_hh, p.H, G, b);
  const Cut c = cut_for<WT>(p.W, p.H, G);
  q.rg = c.rg;
  q.n_rows = c.n_ct > 0 ? (b / c.n_ct) * c.rg : 0;
  q.ih_floats = (slice_floats<WT>(q.ih) + 3) / 4 * 4;
  q.hh_floats = (slice_floats<WT>(q.hh) + 3) / 4 * 4;
  q.rows_floats = c.rg * stage_ld(p.d);
  q.red_floats = kWarps * c.rg * ((c.nc + 3) / 4 * 4);
  q.walk_floats = p.H + vec_red_floats(q.hh.nc) + q.hh.nc;
  return q;
}

// the largest replay region over the blocks (block 0's slices are the
// widest), floats
template <typename WT>
__host__ __device__ inline int replay_floats(const Weights& w, const Dims& p,
                                             int G) {
  const ReplayPlan<WT> q = replay_plan<WT>(w, p, G, 0);
  const int rows = q.rows_floats + q.red_floats;
  return q.ih_floats + q.hh_floats + (rows > q.walk_floats ? rows
                                                            : q.walk_floats);
}

template <typename WT>
__global__ void __launch_bounds__(kThreads, 1)
fused_cached_kernel(const float* __restrict__ tok, Weights w, Dims p,
                    Scratch s, Rings r, float* __restrict__ y,
                    PhaseClock clock) {
  cg::grid_group grid = cg::this_grid();
  clock.start();
  extern __shared__ __align__(16) unsigned char sm_raw[];
  const int d = p.d, H = p.H, W = p.W, G = gridDim.x;
  const int hd = d / p.heads;
  // widest product input, a multiple of 4 floats (16-byte regions after it)
  const int k_max = (max(max(p.Din, d), max(p.ff, H)) + 3) / 4 * 4;
  // shared memory: the rounded input of the next product, the residual
  // row, qkv, the warps' partial sums, the softmax weights, the replay's
  // step list and its step count, then a replay's region
  float* vin = reinterpret_cast<float*>(sm_raw);          // [k_max]
  float* xres = vin + k_max;                              // [d]
  float* qkv = xres + d;                                  // [3 d]
  float* red = qkv + 3 * d;                               // [kWarps][kTile]
  float* ps = red + kWarps * kTile;                 // [attend_floats(W, hd)]
  int* rows = reinterpret_cast<int*>(ps + attend_floats(W, hd));
  int* n_steps = rows + score_rows(W);                    // [4]
  float* rep = reinterpret_cast<float*>(n_steps + 4);
  auto Wt = [](const void* q) { return static_cast<const WT*>(q); };
  const bool writer = blockIdx.x == 0 && p.commit;
  WT* k_ring = static_cast<WT*>(r.k);
  WT* v_ring = static_cast<WT*>(r.v);
  WT* enc = static_cast<WT*>(r.enc);
  WT* h_ring = static_cast<WT*>(r.h);

  // ---- a replay's slices, copied at once; its walk pairs, zeroed --------
  ReplayPlan<WT> rp{};
  float *w_ih_s = nullptr, *w_hh_s = nullptr, *rows_s = nullptr;
  if (!p.rnn_carry) {
    rp = replay_plan<WT>(w, p, G, blockIdx.x);
    w_ih_s = rep;
    w_hh_s = w_ih_s + rp.ih_floats;
    rows_s = w_hh_s + rp.hh_floats;
    copy_slice<WT>(rp.ih, w_ih_s);
    copy_slice<WT>(rp.hh, w_hh_s);
    asm volatile("cp.async.commit_group;\n" ::);
    zero_pairs(s.hp, W, H, rp.hh);
  }

  // ---- the token, fixed and rounded; the in-projection ---------------------
  for (int k = threadIdx.x; k < p.Din; k += kThreads)
    vin[k] = round_cd<WT>(input_fix(tok[k], k, p.zero0));
  __syncthreads();
  matvec_phase<WT>(vin, Wt(w.w_in), p.Din, d, s.p_in, red);
  if (!p.rnn_carry && rp.ih.nc > 0) {
    // the old ring rows' RNN inputs wait for nothing; row `slot` is
    // replaced after the layers when the token is committed
    const int nr = min(rp.rg, W - rp.n_rows);
    stage_rows<WT>(Rows{enc, d, true, -1, false, nullptr, nullptr, nullptr},
                   rp.n_rows, nr, d, rows_s, stage_ld(d), false);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    auto sums = [&](const auto* wc, int ldw) {
      rows_product<WT>(rows_s, stage_ld(d), nr, d, wc, ldw, rp.ih.nc,
                       rp.n_rows, rp.ih.n0, Wt(w.b_r), H, nullptr, s.xin, H,
                       kActNone, rows_s + rp.rg * stage_ld(d));
    };
    if (slice_vec<WT>(rp.ih))
      sums(reinterpret_cast<const WT*>(w_ih_s), rp.ih.nc);
    else
      sums(static_cast<const float*>(w_ih_s), slice_ldw(rp.ih));
  }
  clock.sync(grid, kPhIn);
  {
    const Split c = split_of(p.Din, d, G);
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float v = gather(s.p_in, c.n_ks, d, i) + wload(Wt(w.b_in) + i);
      xres[i] = v;
      vin[i] = round_cd<WT>(v);
    }
    __syncthreads();
  }

  for (int l = 0; l < p.layers; ++l) {
    const Layer& L = w.layer[l];
    const WT* kr = k_ring + static_cast<size_t>(l) * W * d;
    const WT* vr = v_ring + static_cast<size_t>(l) * W * d;
    // ---- qkv ---------------------------------------------------------------
    matvec_phase<WT>(vin, Wt(L.w_qkv), d, 3 * d, s.p_qkv, red);
    clock.sync(grid, kPhQkv);
    {
      const Split c = split_of(d, 3 * d, G);
      for (int i = threadIdx.x; i < 3 * d; i += kThreads)
        qkv[i] = gather(s.p_qkv, c.n_ks, 3 * d, i) + wload(Wt(L.b_qkv) + i);
      __syncthreads();
      if (writer)
        for (int i = threadIdx.x; i < d; i += kThreads) {
          const size_t at = (static_cast<size_t>(l) * W + p.slot) * d + i;
          k_ring[at] = to_ring<WT>(qkv[d + i]);
          v_ring[at] = to_ring<WT>(qkv[2 * d + i]);
        }
    }
    // ---- attention inside the out-projection's units -----------------------
    {
      const Split c = split_of(d, d, G);
      for (int unit = blockIdx.x; unit < c.n_ct * c.n_ks; unit += G) {
        const int ks = unit / c.n_ct;
        const int k0 = ks * c.ks, k1 = min(d, k0 + c.ks);
        attend_heads<WT>(qkv, kr, vr, r.valid, p, k0 / hd, (k1 - 1) / hd,
                         vin, ps);
        __syncthreads();
        matvec_unit<WT>(vin, Wt(L.w_o), d, d, c, unit, s.p_o, red);
      }
    }
    clock.sync(grid, kPhAttnOut);
    {
      const Split c = split_of(d, d, G);
      for (int i = threadIdx.x; i < d; i += kThreads)
        xres[i] = xres[i] +
                  (gather(s.p_o, c.n_ks, d, i) + wload(Wt(L.b_o) + i));
      layernorm_row(xres, d, L.ln1_s, L.ln1_b);
      for (int i = threadIdx.x; i < d; i += kThreads)
        vin[i] = round_cd<WT>(xres[i]);
      __syncthreads();
    }
    // ---- feed-forward ------------------------------------------------------
    matvec_phase<WT>(vin, Wt(L.w_f1), d, p.ff, s.p_f1, red);
    clock.sync(grid, kPhFf1);
    {
      const Split c = split_of(d, p.ff, G);
      for (int i = threadIdx.x; i < p.ff; i += kThreads)
        vin[i] = round_cd<WT>(fmaxf(
            gather(s.p_f1, c.n_ks, p.ff, i) + wload(Wt(L.b_f1) + i), 0.0f));
      __syncthreads();
    }
    matvec_phase<WT>(vin, Wt(L.w_f2), p.ff, d, s.p_f2, red);
    clock.sync(grid, kPhFf2);
    {
      const Split c = split_of(p.ff, d, G);
      for (int i = threadIdx.x; i < d; i += kThreads)
        xres[i] = xres[i] +
                  (gather(s.p_f2, c.n_ks, d, i) + wload(Wt(L.b_f2) + i));
      layernorm_row(xres, d, L.ln2_s, L.ln2_b);
      for (int i = threadIdx.x; i < d; i += kThreads)
        vin[i] = round_cd<WT>(xres[i]);
      __syncthreads();
    }
  }

  // ---- the encoder ring, in both RNN variants -------------------------------
  if (writer) {
    for (int i = threadIdx.x; i < d; i += kThreads)
      enc[static_cast<size_t>(p.slot) * d + i] = to_ring<WT>(xres[i]);
    if (threadIdx.x == 0) r.valid[p.slot] = 1;
  }

  // ---- RNN head: vin <- round(h_t) -----------------------------------------
  matvec_phase<WT>(vin, Wt(w.w_ih), d, H, s.p_ih, red);
  const Split c_ih = split_of(d, H, G);
  if (p.rnn_carry) {
    // one step from the carried hidden; both products in one phase
    for (int k = threadIdx.x; k < H; k += kThreads)
      vin[k] = wvalue(h_ring[k]);
    __syncthreads();
    matvec_phase<WT>(vin, Wt(w.w_hh), H, H, s.p_hh, red);
    clock.sync(grid, kPhRnnIn);
    const Split c_hh = split_of(H, H, G);
    for (int i = threadIdx.x; i < H; i += kThreads) {
      const float pre_i =
          gather(s.p_ih, c_ih.n_ks, H, i) + wload(Wt(w.b_r) + i);
      const float ht = tanhf(pre_i + gather(s.p_hh, c_hh.n_ks, H, i));
      if (writer) h_ring[i] = to_ring<WT>(ht);
      vin[i] = round_cd<WT>(ht);
    }
    __syncthreads();
  } else {
    clock.sync(grid, kPhRnnIn);
    // the valid slots, oldest first: the walk starts after the cursor
    if (threadIdx.x == 0) {
      int n = 0;
      for (int t = 0; t < W; ++t) {
        const int idx = (p.slot + 1 + t) % W;
        if (r.valid[idx] || (p.commit && idx == p.slot)) rows[n++] = idx;
      }
      *n_steps = n;
    }
    // the committed token's RNN input replaces its ring row's, each block
    // for the walk columns it owns
    if (p.commit)
      for (int c = threadIdx.x; c < rp.hh.nc; c += kThreads) {
        const int i = rp.hh.n0 + c;
        s.xin[static_cast<size_t>(p.slot) * H + i] =
            gather(s.p_ih, c_ih.n_ks, H, i) + wload(Wt(w.b_r) + i);
      }
    asm volatile("cp.async.wait_group 0;\n" ::);   // the walk's slice
    __syncthreads();
    const int steps = *n_steps;
    float* walk_sm = rows_s;
    if (slice_vec<WT>(rp.hh))
      walk_phase<WT>(s.xin, rows, steps, H, rp.hh,
                     reinterpret_cast<const WT*>(w_hh_s), rp.hh.nc, s.hp,
                     walk_sm);
    else
      walk_phase<WT>(s.xin, rows, steps, H, rp.hh,
                     static_cast<const float*>(w_hh_s), slice_ldw(rp.hh),
                     s.hp, walk_sm);
    clock.closed(kPhRnn);
    if (steps > 0) {
      stage_pairs<WT>(s.hp, steps - 1, 1, H, vin, H);
    } else {
      for (int k = threadIdx.x; k < H; k += kThreads) vin[k] = 0.0f;
      __syncthreads();
    }
  }

  // ---- out-projection -------------------------------------------------------
  matvec_phase<WT>(vin, Wt(w.w_out), H, p.S, s.p_out, red);
  clock.sync(grid, kPhOut);
  if (blockIdx.x == 0) {
    const Split c = split_of(H, p.S, G);
    for (int i = threadIdx.x; i < p.S; i += kThreads)
      y[i] = gather(s.p_out, c.n_ks, p.S, i) + wload(Wt(w.b_out) + i);
  }
}

// scratch floats by part, in the order of Scratch (the pairs last, 8
// bytes each)
inline void scratch_parts(int W, int d, int ff, int H, size_t* n) {
  int n_max = 3 * d;
  if (ff > n_max) n_max = ff;
  if (H > n_max) n_max = H;
  const size_t cap = kTile * kMaxGrid > n_max ? kTile * kMaxGrid : n_max;
  for (int i = 0; i < 8; ++i) n[i] = cap;
  n[8] = static_cast<size_t>(W) * H;
  n[9] = 2 * n[8];
}

// the launch's shared memory: the head region of fused_cached_kernel (the
// product input, the residual row, qkv, the partial sums, the attention's
// scores and sums, the step list and count) and p.stage floats of a
// replay's region
inline size_t smem_bytes(const Dims& p) {
  int k_max = p.Din;
  if (p.d > k_max) k_max = p.d;
  if (p.ff > k_max) k_max = p.ff;
  if (p.H > k_max) k_max = p.H;
  k_max = (k_max + 3) / 4 * 4;
  const size_t head_floats = static_cast<size_t>(k_max) + 4 * p.d +
                             kWarps * kTile +
                             attend_floats(p.W, p.d / p.heads) +
                             score_rows(p.W) + 4;
  const size_t head_bytes = (head_floats * sizeof(float) + 15) / 16 * 16;
  return head_bytes + sizeof(float) * p.stage;
}

template <typename WT>
int launch(const float* tok, const Weights& w, Dims p, float* scratch,
           const Rings& r, float* y, PhaseClock clock, cudaStream_t stream) {
  int sms = 0, smem_max = 0;
  const cudaError_t err = device_limits(&sms, &smem_max);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = sms;           // one block per SM, all co-resident
  if (grid > kMaxGrid || grid < 8) return kErrShape;
  size_t n[10];
  scratch_parts(p.W, p.d, p.ff, p.H, n);
  p.cap = static_cast<int>(n[0]);
  if (p.S > p.cap) return kErrShape;   // the out-projection's partial sums
  Scratch s;
  float** bufs[] = {&s.p_in, &s.p_qkv, &s.p_o,  &s.p_f1, &s.p_f2,
                    &s.p_ih, &s.p_hh,  &s.p_out, &s.xin};
  float* at = scratch;
  for (int i = 0; i < 9; ++i) {
    *bufs[i] = at;
    at += n[i];
  }
  s.hp = reinterpret_cast<unsigned long long*>(at);

  p.stage = p.rnn_carry ? 0 : replay_floats<WT>(w, p, grid);
  const size_t smem = smem_bytes(p);
  if (smem > static_cast<size_t>(smem_max)) return kErrSmem;
  Weights w_arg = w;
  Rings r_arg = r;
  void* args[] = {&tok, &w_arg, &p, &s, &r_arg, &y, &clock};
  static size_t allowed = 0;
  return launch_cooperative(fused_cached_kernel<WT>, grid, smem, args,
                            stream, &allowed);
}

}  // namespace

// The shared memory (bytes) a block of fused_cached_launch needs at these
// widths on this device, or -1 for a shape outside the kernel's limits.
extern "C" long long fused_cached_smem_bytes(int is_bf16, int W, int Din,
                                             int d, int heads, int ff,
                                             int layers, int H, int S,
                                             int rnn_carry) {
  int sms = 0, smem_max = 0;
  if (W < 1 || layers < 1 || layers > kMaxLayers || heads < 1 || d < 1 ||
      d % heads != 0 || device_limits(&sms, &smem_max) != cudaSuccess)
    return -1;
  const Weights w{};
  Dims p{};
  p.W = W;
  p.Din = Din;
  p.d = d;
  p.heads = heads;
  p.ff = ff;
  p.layers = layers;
  p.H = H;
  p.S = S;
  p.rnn_carry = rnn_carry != 0;
  p.stage = p.rnn_carry ? 0
            : is_bf16  ? replay_floats<__nv_bfloat16>(w, p, sms)
                       : replay_floats<float>(w, p, sms);
  return static_cast<long long>(smem_bytes(p));
}

// The scratch (in floats) fused_cached_launch takes, so that the caller
// can allocate it.
extern "C" int fused_cached_scratch_floats(int W, int d, int ff, int H) {
  size_t n[10], total = 0;
  scratch_parts(W, d, ff, H, n);
  for (int i = 0; i < 10; ++i) total += n[i];
  return total > 0x7fffffffu ? -1 : static_cast<int>(total);
}

// weights: the packed list of ops/fused_forward.py::pack_weights, n_w =
// 2 + 12 * layers + 5 device pointers. tok (Din,) f32; k, v (layers, W, d),
// enc (W, d), h (H,) in the packing dtype, valid (W,) bytes; y (S,) f32;
// scratch: fused_cached_scratch_floats floats, 16-byte aligned. slot in
// [0, W). Any W and head width whose tiles fit a block. Returns a CUDA
// error code, or -1 for a shape outside the kernel's limits (or a scratch
// too small), -2 when the widths need more shared memory than a block has
// (fused_cached_smem_bytes gives the bytes). clock: null, or clock_rows rows of 4 u64
// for the per-phase clock (PhaseClock).
extern "C" int fused_cached_launch(
    const void* tok, const void* const* weights, int n_w, int is_bf16, int W,
    int Din, int d, int heads, int ff, int layers, int H, int S, int zero0,
    int slot, int commit, int rnn_carry, void* k, void* v, void* enc, void* h,
    void* valid, void* scratch, int scratch_floats, void* y, void* clock,
    int clock_rows, void* stream) {
  if (W < 1 || layers < 1 || layers > kMaxLayers ||
      n_w != 2 + 12 * layers + 5 || heads < 1 || d < 1 || d % heads != 0 ||
      Din < 1 || ff < 1 || H < 1 || S < 1 ||
      slot < 0 || slot >= W ||
      (reinterpret_cast<uintptr_t>(scratch) & 15) != 0 ||
      scratch_floats < fused_cached_scratch_floats(W, d, ff, H))
    return kErrShape;
  const Weights w = unpack_weights(weights, layers);
  Dims p;
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
  p.commit = commit != 0;
  p.rnn_carry = rnn_carry != 0;
  p.cap = 0;
  p.stage = 0;
  Rings r;
  r.k = k;
  r.v = v;
  r.enc = enc;
  r.h = h;
  r.valid = static_cast<unsigned char*>(valid);
  const float* tf = static_cast<const float*>(tok);
  float* sf = static_cast<float*>(scratch);
  float* yf = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PhaseClock ck{static_cast<unsigned long long*>(clock),
                      clock != nullptr ? clock_rows : 0, 0};
  if (is_bf16) return launch<__nv_bfloat16>(tf, w, p, sf, r, yf, ck, st);
  return launch<float>(tf, w, p, sf, r, yf, ck, st);
}
