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
// a chain of dependent phases and T dependent RNN steps.
//
// Design, from what the per-phase clock of the first version showed (0.44
// ms in bf16: its products, units of 4 rows x 256 columns on 10-40 SMs each
// streaming its weight columns, 0.30, ff2 alone 0.15; the RNN, a grid
// barrier a step, 0.078; LayerNorm 0.021 in 8 phases of its own; barriers
// 0.031; an H100 80GB HBM3 at 700 W):
//   - One block per SM, 256 threads; activations (at most T x ff floats)
//     in a global scratch that stays in L2.
//   - Every product gives each block at most one tile: a group of rows
//     (up to kRowGroups groups) x a few columns (up to kColTiles tiles)
//     over the whole depth, so every product uses about every SM and no sum
//     crosses blocks. The weights are read from their tile-major copy, made
//     once per packed list (fused_forward_tiles: a tile's K x ldw values
//     together, widened to f32), so that a block's weights of a phase are
//     one bulk copy; one thread starts it two jobs ahead into a ring of
//     three shared-memory slots (WeightRing), and a phase waits on the
//     slot's mbarrier, not on memory.
//   - A block stages its rows of the input once (the loads issued eight a
//     thread ahead of their stores), LayerNorm applied on the way in where
//     the product reads a normalised row, its scales, and the epilogue's
//     bias and residual, loaded before the rows: LayerNorm has no phase of
//     its own, and a layer closes 5 barriers (qkv, attention,
//     out-projection, ff1, ff2).
//   - A tile's sums: a lane a row x 4 columns, a warp an eighth of the
//     depth, the warps' sums added in warp order, f32 fmaf throughout: an
//     output's bits do not depend on the cut, so K4's row equals K5's.
//   - Attention: units of (head, 8 rows), that head's q, k and v staged
//     (and rounded) in shared memory, a warp a query row.
//   - The RNN walk (walk_phase): W_hh's columns spread over the blocks (4 a
//     block), each step's hidden state exchanged through L2 as (value, step)
//     pairs that a block polls for, with no grid barrier; the
//     out-projection reads the last step's pairs the same way.
// K4 runs rows 0..k_last only: later rows cannot reach that output (causal
// attention, a forward RNN). Barriers: 2 + 5 L (22 at L = 4), none in the
// walk. A per-phase clock (PhaseClock) records them when asked.
//
// The packing dtype (f32 or bf16) is a template argument: activations are
// rounded to it before a product, weights are its values widened to f32,
// products of two rounded values are exact in f32, and both types share one
// code path on the CUDA cores.

#include "fused_phases.cuh"

namespace {

// The kinds of the phases the per-phase clock (PhaseClock) records, as
// ops/fused_forward.py::K4_PHASES names them (kPhLn1 and kPhLn2 were the
// first version's LayerNorm phases: LayerNorm now rides in ff1's, qkv's and
// w_ih's staging)
enum PhaseKind {
  kPhIn = 1, kPhQkv = 2, kPhAttn = 3, kPhAttnOut = 4, kPhLn1 = 5, kPhFf1 = 6,
  kPhFf2 = 7, kPhLn2 = 8, kPhWih = 9, kPhRnn = 10, kPhOut = 11
};

struct Dims {
  int T;        // rows to compute
  int Din, d, heads, ff, layers, H, S;
  int zero0;    // first of the three zeroed input columns
  int k_last;   // >= 0: emit that row only; -1: every row
  int chunk;    // rows of a tile staged at a time (all of them: T)
  int raw;      // floats of one weight slot
  int stage;    // floats of the row stage (and attention's, the walk's)
  int red;      // floats of the partial sums
};

// activations, f32; hp: the walk's (value, step) pairs, (T, H)
struct Scratch {
  float *x, *qkv, *att, *a, *f, *xin;
  unsigned long long* hp;
};

// the mbarriers and bulk copies (the tensor memory accelerator's 1-D
// copies) of WeightRing
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// n bytes (a multiple of 16, both ends 16-byte aligned) from global src to
// shared dst, counted on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned n,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(n), "r"(smem_addr(bar))
      : "memory");
}

// The ring of weight slots (K4, K5): job j's tile lies in slot j % kSlots,
// copied there two jobs ahead by one thread of the block's last warp (fill:
// one bulk copy of the tile, contiguous in the weights' tile-major copy,
// counted on the slot's mbarrier) while the block works on the jobs before.
// take(j) waits on the slot's mbarrier (its phase flips with each copy into
// the slot: `phases`, the same in every thread). Every block takes every
// job, in order, and fills job j + 2 after it takes job j: the slot it
// fills held job j - 1, which the phase before finished.
constexpr int kSlots = 3;
constexpr int kBarFloats = 8;     // the slots' mbarriers, 16-byte aligned

struct WeightRing {
  unsigned* slot[kSlots];
  unsigned long long* bar;        // kSlots mbarriers, shared memory
  unsigned phases;                // bit s: the parity slot s waits on next

  // every thread, before the block's first fill
  __device__ void init() {
    phases = 0;
    if (threadIdx.x == 0) {
      for (int s = 0; s < kSlots; ++s) mbar_init(bar + s);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }
  // job j's tile (bytes from src, 16-byte aligned; 0: none) into its slot
  __device__ void fill(const void* src, unsigned bytes, int j) {
    if (bytes == 0 || threadIdx.x != kThreads - 32) return;
    unsigned long long* b = bar + j % kSlots;
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_expect(b, bytes);
    bulk_copy(slot[j % kSlots], src, bytes, b);
  }
  __device__ void take(unsigned bytes, int j) {
    if (bytes == 0) return;
    const int t = j % kSlots;
    mbar_wait(bar + t, (phases >> t) & 1u);
    phases ^= 1u << t;
  }
};

// The launch's weights in order (job j): the in-projection; per layer qkv,
// out-projection, ff1, ff2; the RNN inputs; W_hh's walk columns; the
// out-projection. Each is cut into n_ct tiles of nc columns (a product:
// nc = N / kColTiles rounded up; the walk: N / G, a block's columns), and
// the tiles lie one after another in the weights' tile-major copy (made
// once per packed list by fused_forward_tiles), each K x ldw values widened
// to f32 (ldw: nc rounded up to 4, zeros past N): a block's weights of a
// phase are one bulk copy, and the sums read f32 in both packings (sums
// over bf16 in shared memory made the walk 1.4x and ff2 1.35x slower; an
// H100 80GB HBM3 at 700 W).
struct JobTiles {
  const void* w;                  // the packed weight (K, N)
  int K, N, nc, ldw, n_ct;
  long long bytes;                // of one tile
};

__host__ __device__ inline int n_jobs(int layers) { return 4 * layers + 4; }

__host__ __device__ inline JobTiles job_tiles(const Weights& w,
                                              const Dims& p, int j, int G) {
  const int d = p.d, L = p.layers;
  JobTiles t{nullptr, 0, 1, 1, 4, 0, 0};
  int per = kColTiles;
  if (j == 0) {
    t.w = w.w_in, t.K = p.Din, t.N = d;
  } else if (j <= 4 * L) {
    const Layer& Ly = w.layer[(j - 1) / 4];
    switch ((j - 1) % 4) {
      case 0: t.w = Ly.w_qkv, t.K = d, t.N = 3 * d; break;
      case 1: t.w = Ly.w_o, t.K = d, t.N = d; break;
      case 2: t.w = Ly.w_f1, t.K = d, t.N = p.ff; break;
      default: t.w = Ly.w_f2, t.K = p.ff, t.N = d;
    }
  } else if (j == 4 * L + 1) {
    t.w = w.w_ih, t.K = d, t.N = p.H;
  } else if (j == 4 * L + 2) {
    t.w = w.w_hh, t.K = p.H, t.N = p.H, per = G;
  } else if (j == 4 * L + 3) {
    t.w = w.w_out, t.K = p.H, t.N = p.S;
  } else {
    return t;
  }
  t.nc = (t.N + per - 1) / per;
  t.n_ct = (t.N + t.nc - 1) / t.nc;
  t.ldw = (t.nc + 3) / 4 * 4;
  t.bytes = static_cast<long long>(t.K) * t.ldw * sizeof(float);
  return t;
}

// byte offset of job j's first tile in the tile-major copy
__host__ __device__ inline long long job_base(const Weights& w, const Dims& p,
                                              int j, int G) {
  long long at = 0;
  for (int i = 0; i < j; ++i) {
    const JobTiles t = job_tiles(w, p, i, G);
    at += t.n_ct * t.bytes;
  }
  return at;
}

// the rows of a product of R rows over G blocks whose columns are n_ct
// tiles: up to kRowGroups groups, as many as the grid holds
__host__ __device__ inline Cut rows_cut(int R, int n_ct, int G) {
  Cut c;
  int n_rg = R < kRowGroups ? R : kRowGroups;
  if (n_rg > G / n_ct) n_rg = G / n_ct > 0 ? G / n_ct : 1;
  c.rg = (R + n_rg - 1) / n_rg;
  c.n_rg = (R + c.rg - 1) / c.rg;
  c.n_ct = n_ct;
  c.nc = 0;
  return c;
}

// block b's part of job j over R rows: its tile (bytes 0: none), its rows
// and columns
struct Part {
  const char* src;
  unsigned bytes;
  int row0, nr, n0, nc, ldw;
};

constexpr int kMaxJobs = 4 * kMaxLayers + 4;

// the launch's jobs (job_tiles) and the byte offset of each one's first
// tile, made by the launcher
struct JobTable {
  JobTiles job[kMaxJobs];
  long long base[kMaxJobs];
  int n;
};

// block b's part of job j over R rows
__device__ Part job_part(const char* tiles, const JobTable& jt, int j,
                         int R) {
  Part q{nullptr, 0, 0, 0, 0, 0, 4};
  if (j >= jt.n) return q;
  const int G = gridDim.x, b = blockIdx.x;
  const JobTiles& t = jt.job[j];
  const Cut c = rows_cut(R, t.n_ct, G);
  if (b >= c.n_rg * t.n_ct) return q;
  const int ct = b % t.n_ct, grp = b / t.n_ct;
  q.src = tiles + jt.base[j] + ct * t.bytes;
  q.bytes = static_cast<unsigned>(t.bytes);
  q.row0 = grp * c.rg;
  q.nr = min(c.rg, R - q.row0);
  q.n0 = ct * t.nc;
  q.nc = min(t.nc, t.N - q.n0);
  q.ldw = t.ldw;
  return q;
}

// kWide: windows of more than kMaxT rows or tiles whose rows are staged
// in chunks (a separate instantiation: the default shapes keep their code)
template <typename WT, bool kWide>
__global__ void __launch_bounds__(kThreads, 1)
fused_forward_kernel(const float* __restrict__ x, Weights w,
                     const char* __restrict__ tiles, JobTable jt, Dims p,
                     Scratch s, float* __restrict__ out, PhaseClock clock) {
  cg::grid_group grid = cg::this_grid();
  clock.start();
  extern __shared__ __align__(16) unsigned char sm_raw[];
  float* sm = reinterpret_cast<float*>(sm_raw);
  WeightRing ring;
  for (int t = 0; t < kSlots; ++t)
    ring.slot[t] = reinterpret_cast<unsigned*>(sm + t * p.raw);
  ring.bar = reinterpret_cast<unsigned long long*>(sm + kSlots * p.raw);
  float* As = sm + kSlots * p.raw + kBarFloats;
  float* red = As + p.stage;
  const int T = p.T, d = p.d, L = p.layers;
  // a job's rows: the walk's one (its tiles are columns only), the
  // out-projection's one row for K4, else T
  auto part = [&](int j) {
    const bool one = j == 4 * L + 2 || (j == 4 * L + 3 && p.k_last >= 0);
    return job_part(tiles, jt, j, one ? 1 : T);
  };
  // job j's tile, and the copy of job j + 2 started
  auto take = [&](int j) {
    const Part q = part(j);
    ring.take(q.bytes, j);
    const Part q2 = part(j + 2);
    ring.fill(q2.src, q2.bytes, j + 2);
    return q;
  };
  auto wc = [&](int j) {
    return reinterpret_cast<const float*>(ring.slot[j % kSlots]);
  };
  // a product phase over job j: the block's rows of src staged, its tile's
  // sums
  // (p.chunk rows at a time where a tile's rows do not fit at once: an
  // output's bits do not depend on the rows staged beside it)
  auto product = [&](int j, const Rows& src, int K, int N, const void* bias,
                     const float* res, float* o, int act) {
    const Part q = take(j);
    if (q.bytes == 0) return;
    const int lds = stage_ld(K);
    if constexpr (!kWide) {
      stage_rows<WT>(src, q.row0, q.nr, K, As, lds, q.n0 == 0);
      rows_product<WT>(As, lds, q.nr, K, wc(j), q.ldw, q.nc, q.row0, q.n0,
                       static_cast<const WT*>(bias), N, res, o, N, act, red);
      return;
    }
    for (int r0 = 0; r0 < q.nr; r0 += p.chunk) {
      const int nr = min(p.chunk, q.nr - r0);
      stage_rows<WT>(src, q.row0 + r0, nr, K, As, lds, q.n0 == 0);
      rows_product<WT>(As, lds, nr, K, wc(j), q.ldw, q.nc, q.row0 + r0,
                       q.n0, static_cast<const WT*>(bias), N, res, o, N, act,
                       red);
    }
  };

  ring.init();
  // this block's walk pairs, zeroed before the first barrier
  const int jw = 4 * L + 2;
  {
    const Part q = part(jw);
    zero_pairs(s.hp, T, p.H, Slice{nullptr, p.H, p.H, q.n0, q.nc});
    const Part q0 = part(0), q1 = part(1);
    ring.fill(q0.src, q0.bytes, 0);
    ring.fill(q1.src, q1.bytes, 1);
  }

  product(0, Rows{x, p.Din, false, p.zero0, false, nullptr, nullptr,
                  nullptr},
          p.Din, d, w.b_in, nullptr, s.x, kActNone);
  clock.sync(grid, kPhIn);
  for (int l = 0; l < L; ++l) {
    const Layer& Ly = w.layer[l];
    const int j = 1 + 4 * l;
    // qkv: layer 0 reads the in-projection; a later layer the sum before
    // the last LayerNorm, normalised here and written to x (the residual)
    Rows in = rows_of(s.x, d, true);
    if (l > 0) {
      in = rows_of(s.a, d, true);
      in.ln_s = w.layer[l - 1].ln2_s;
      in.ln_b = w.layer[l - 1].ln2_b;
      in.x_out = s.x;
    }
    product(j, in, d, 3 * d, Ly.b_qkv, nullptr, s.qkv, kActNone);
    clock.sync(grid, kPhQkv);
    attention_phase<WT, kWide>(s.qkv, T, d, p.heads, s.att, As);
    clock.sync(grid, kPhAttn);
    product(j + 1, rows_of(s.att, d, true), d, d, Ly.b_o, s.x, s.a,
            kActNone);
    clock.sync(grid, kPhAttnOut);
    Rows f_in = rows_of(s.a, d, true);
    f_in.ln_s = Ly.ln1_s;
    f_in.ln_b = Ly.ln1_b;
    f_in.x_out = s.x;
    product(j + 2, f_in, d, p.ff, Ly.b_f1, nullptr, s.f, kActRelu);
    clock.sync(grid, kPhFf1);
    product(j + 3, rows_of(s.f, p.ff, true), p.ff, d, Ly.b_f2, s.x, s.a,
            kActNone);
    clock.sync(grid, kPhFf2);
  }
  Rows r_in = rows_of(s.a, d, true);
  r_in.ln_s = w.layer[L - 1].ln2_s;
  r_in.ln_b = w.layer[L - 1].ln2_b;
  product(4 * L + 1, r_in, d, p.H, w.b_r, nullptr, s.xin, kActNone);
  clock.sync(grid, kPhWih);

  {
    const Part q = take(jw);
    walk_phase<WT>(s.xin, nullptr, T, p.H,
                   Slice{nullptr, p.H, p.H, q.n0, q.bytes ? q.nc : 0},
                   wc(jw), q.ldw, s.hp, As);
  }
  clock.closed(kPhRnn);

  // the out-projection of the walk's last row (K4) or of every row (K5),
  // staged from the pairs as they arrive
  {
    const int j = 4 * L + 3;
    const bool last = p.k_last >= 0;
    const Part q = take(j);
    if (q.bytes > 0) {
      if (last) {
        stage_pairs<WT>(s.hp, T - 1, 1, p.H, As, p.H);
        float* sums = red + vec_red_floats(q.nc);
        vec_sums(As, p.H, wc(j), q.ldw, q.nc, red, sums);
        for (int c = threadIdx.x; c < q.nc; c += kThreads)
          out[q.n0 + c] = finish<WT>(sums[c], static_cast<const WT*>(w.b_out),
                                     q.n0 + c, nullptr, 0, kActNone);
      } else {
        const int lds = stage_ld(p.H);
        if constexpr (!kWide) {
          stage_pairs<WT>(s.hp, q.row0, q.nr, p.H, As, lds);
          rows_product<WT>(As, lds, q.nr, p.H, wc(j), q.ldw, q.nc, q.row0,
                           q.n0, static_cast<const WT*>(w.b_out), p.S,
                           nullptr, out, p.S, kActNone, red);
        } else {
          for (int r0 = 0; r0 < q.nr; r0 += p.chunk) {
            const int nr = min(p.chunk, q.nr - r0);
            stage_pairs<WT>(s.hp, q.row0 + r0, nr, p.H, As, lds);
            rows_product<WT>(As, lds, nr, p.H, wc(j), q.ldw, q.nc,
                             q.row0 + r0, q.n0,
                             static_cast<const WT*>(w.b_out), p.S, nullptr,
                             out, p.S, kActNone, red);
          }
        }
      }
    }
  }
  if (clock.clk != nullptr) clock.sync(grid, kPhOut);
}

// scratch floats by part, in the order of Scratch, each a multiple of 4
inline void scratch_parts(int T, int d, int ff, int H, size_t* n) {
  auto r4 = [](size_t v) { return (v + 3) / 4 * 4; };
  n[0] = r4(static_cast<size_t>(T) * d);
  n[1] = r4(static_cast<size_t>(T) * 3 * d);
  n[2] = n[0];
  n[3] = n[0];
  n[4] = r4(static_cast<size_t>(T) * ff);
  n[5] = r4(static_cast<size_t>(T) * H);
  n[6] = 2 * n[5];                // the pairs, 8 bytes each
}

// the shared memory regions of Dims for the launch's T rows over G blocks,
// a block staging at most p->chunk rows of its tile at a time
void size_regions_at(const Weights& w, Dims* p, int G) {
  const int T = p->T, d = p->d;
  int raw = 0, stage = 0, red = 0;
  for (int j = 0; j < n_jobs(p->layers); ++j) {
    const JobTiles t = job_tiles(w, *p, j, G);
    raw = t.bytes / 4 > raw ? static_cast<int>(t.bytes / 4) : raw;
    if (j == 4 * p->layers + 2) continue;          // the walk: below
    const bool out1 = j == 4 * p->layers + 3 && p->k_last >= 0;
    const Cut c = rows_cut(out1 ? 1 : T, t.n_ct, G);
    const int rg = c.rg < p->chunk ? c.rg : p->chunk;
    const int st = rg * stage_ld(t.K);
    const int rd = out1 ? 2 * vec_red_floats(t.nc) : kWarps * rg * t.ldw;
    stage = st > stage ? st : stage;
    red = rd > red ? rd : red;
  }
  // attention's q, k, v and weights; the walk's hidden state and sums
  const int hs = (d / p->heads) | 1;
  const int attn = kWarps * hs + 2 * T * hs + kWarps * score_rows(T);
  const int cpb = job_tiles(w, *p, 4 * p->layers + 2, G).nc;
  const int walk = p->H + vec_red_floats(cpb) + cpb;
  stage = attn > stage ? attn : stage;
  stage = walk > stage ? walk : stage;
  auto r4 = [](int v) { return (v + 3) / 4 * 4; };
  p->raw = r4(raw);
  p->stage = r4(stage);
  p->red = r4(red);
}

inline size_t smem_bytes(const Dims& p);

// size_regions_at with every tile's rows staged at once where that fits
// smem_max bytes (the default shapes: one chunk), else with the rows a
// stage holds halved until it fits or holds one
void size_regions(const Weights& w, Dims* p, int G, int smem_max) {
  p->chunk = p->T;
  size_regions_at(w, p, G);
  while (smem_bytes(*p) > static_cast<size_t>(smem_max) && p->chunk > 1) {
    p->chunk = (p->chunk + 1) / 2;
    size_regions_at(w, p, G);
  }
}

// a block's shared memory for the regions of size_regions
inline size_t smem_bytes(const Dims& p) {
  return sizeof(float) * (kSlots * static_cast<size_t>(p.raw) + kBarFloats +
                          p.stage + p.red);
}

template <typename WT>
int launch(const float* x, const Weights& w, const char* tiles, Dims p,
           const Scratch& s, float* out, PhaseClock clock,
           cudaStream_t stream) {
  int sms = 0, smem_max = 0;
  const cudaError_t err = device_limits(&sms, &smem_max);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = sms;           // one block per SM, all co-resident
  if (grid < kColTiles) return kErrShape;
  size_regions(w, &p, grid, smem_max);
  const size_t smem = smem_bytes(p);
  if (smem > static_cast<size_t>(smem_max)) return kErrSmem;
  JobTable jt;
  jt.n = n_jobs(p.layers);
  long long at = 0;
  for (int j = 0; j < jt.n; ++j) {
    jt.job[j] = job_tiles(w, p, j, grid);
    jt.base[j] = at;
    at += jt.job[j].n_ct * jt.job[j].bytes;
  }
  Weights w_arg = w;
  Scratch s_arg = s;
  void* args[] = {&x, &w_arg, &tiles, &jt, &p, &s_arg, &out, &clock};
  if (p.T > kMaxT || p.chunk < p.T) {
    static size_t allowed = 0;
    return launch_cooperative(fused_forward_kernel<WT, true>, grid, smem,
                              args, stream, &allowed);
  }
  static size_t allowed = 0;
  return launch_cooperative(fused_forward_kernel<WT, false>, grid, smem, args,
                            stream, &allowed);
}

// tile ct of job t, row k, column c (f32, [n_ct][K][ldw]) = the weight's
// (K, N) entry (k, ct nc + c) widened, 0 past its tile or N
template <typename WT>
__global__ void widen_tiles(const WT* __restrict__ w, JobTiles t,
                            float* __restrict__ dst) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (e >= t.n_ct * static_cast<long long>(t.K) * t.ldw) return;
  const int c = static_cast<int>(e % t.ldw);
  const long long r = e / t.ldw;
  const int k = static_cast<int>(r % t.K), ct = static_cast<int>(r / t.K);
  const int n = ct * t.nc + c;
  dst[e] = c < t.nc && n < t.N
               ? wvalue(w[static_cast<size_t>(k) * t.N + n])
               : 0.0f;
}

bool dims_ok(int layers, int n_w, int heads, int d, int Din, int ff, int H,
             int S) {
  return layers >= 1 && layers <= kMaxLayers && n_w == 2 + 12 * layers + 5 &&
         heads >= 1 && d >= 1 && d % heads == 0 && Din >= 1 && ff >= 1 &&
         H >= 1 && S >= 1;
}

Dims model_dims(int Din, int d, int heads, int ff, int layers, int H, int S) {
  Dims p;
  p.T = 1;
  p.Din = Din;
  p.d = d;
  p.heads = heads;
  p.ff = ff;
  p.layers = layers;
  p.H = H;
  p.S = S;
  p.zero0 = -1;
  p.k_last = -1;
  p.chunk = 1;
  p.raw = p.stage = p.red = 0;
  return p;
}

}  // namespace

// The shared memory (bytes) a block of fused_forward_launch needs for T
// rows (k_last as the launch's) at these widths on this device, or -1 for
// widths outside the kernel's limits.
extern "C" long long fused_forward_smem_bytes(int T, int Din, int d,
                                              int heads, int ff, int layers,
                                              int H, int S, int k_last) {
  int sms = 0, smem_max = 0;
  if (T < 1 || k_last < -1 || k_last >= T ||
      !dims_ok(layers, 2 + 12 * layers + 5, heads, d, Din, ff, H, S) ||
      device_limits(&sms, &smem_max) != cudaSuccess)
    return -1;
  const Weights w{};
  Dims p = model_dims(Din, d, heads, ff, layers, H, S);
  p.T = k_last >= 0 ? k_last + 1 : T;
  p.k_last = k_last;
  size_regions(w, &p, sms, smem_max);
  return static_cast<long long>(smem_bytes(p));
}

// Bytes of the weights' tile-major copy on this device (the tiles of every
// job, job_tiles), or -1 for widths outside the kernel's limits or a copy
// beyond 2 GB.
extern "C" int fused_forward_tiles_bytes(int is_bf16, int Din, int d,
                                         int heads, int ff, int layers, int H,
                                         int S) {
  int sms = 0, smem_max = 0;
  if (!dims_ok(layers, 2 + 12 * layers + 5, heads, d, Din, ff, H, S) ||
      device_limits(&sms, &smem_max) != cudaSuccess)
    return -1;
  const Weights w{};
  const Dims p = model_dims(Din, d, heads, ff, layers, H, S);
  (void)is_bf16;                  // the copy is f32 in both packings
  const long long n = job_base(w, p, n_jobs(layers), sms);
  return n > 0x7fffffffLL ? -1 : static_cast<int>(n);
}

// Write the tile-major copy of the packed weights (the list of
// ops/fused_forward.py::pack_weights) into `tiles` (tiles_bytes bytes,
// 16-byte aligned) on `stream`: each tile's columns widened to f32, zeros
// past a matrix's last column. Returns a CUDA error code, or -1.
extern "C" int fused_forward_tiles(const void* const* weights, int n_w,
                                   int is_bf16, int Din, int d, int heads,
                                   int ff, int layers, int H, int S,
                                   void* tiles, long long tiles_bytes,
                                   void* stream) {
  int sms = 0, smem_max = 0;
  if (!dims_ok(layers, n_w, heads, d, Din, ff, H, S) ||
      (reinterpret_cast<uintptr_t>(tiles) & 15) != 0)
    return kErrShape;
  const cudaError_t err = device_limits(&sms, &smem_max);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Weights w = unpack_weights(weights, layers);
  const Dims p = model_dims(Din, d, heads, ff, layers, H, S);
  if (tiles_bytes != job_base(w, p, n_jobs(layers), sms)) return kErrShape;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(tiles);
  for (int j = 0; j < n_jobs(layers); ++j) {
    const JobTiles t = job_tiles(w, p, j, sms);
    const long long n = t.n_ct * static_cast<long long>(t.K) * t.ldw;
    const int blocks = static_cast<int>((n + kThreads - 1) / kThreads);
    if (is_bf16)
      widen_tiles<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(t.w), t, dst);
    else
      widen_tiles<float><<<blocks, kThreads, 0, st>>>(
          static_cast<const float*>(t.w), t, dst);
    dst += n;
  }
  return static_cast<int>(cudaGetLastError());
}

// weights: the packed list of ops/fused_forward.py::pack_weights, n_w =
// 2 + 12 * layers + 5 device pointers; tiles: their tile-major copy
// (fused_forward_tiles). scratch: the floats of scratch_parts for T rows
// (ops/fused_forward.py::scratch_floats), 16-byte aligned. k_last >= 0
// writes out (S,) for that row and computes rows 0..k_last only; k_last ==
// -1 writes out (T, S). Any T and head width whose tiles fit a block:
// returns a CUDA error code, or -1 for a shape outside the kernel's limits,
// -2 when the rows and widths need more shared memory than a block has
// (fused_forward_smem_bytes gives the bytes). clock: null, or clock_rows rows of 4 u64 for the per-phase
// clock (PhaseClock).
extern "C" int fused_forward_launch(const void* x, const void* const* weights,
                                    const void* tiles, int n_w, int is_bf16,
                                    int T, int Din, int d, int heads, int ff,
                                    int layers, int H, int S, int zero0,
                                    int k_last, void* scratch, void* out,
                                    void* clock, int clock_rows,
                                    void* stream) {
  if (T < 1 || !dims_ok(layers, n_w, heads, d, Din, ff, H, S) ||
      k_last < -1 || k_last >= T ||
      (reinterpret_cast<uintptr_t>(scratch) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(tiles) & 15) != 0)
    return kErrShape;
  const Weights w = unpack_weights(weights, layers);

  // the scratch is laid out for the caller's T rows
  size_t n[7];
  scratch_parts(T, d, ff, H, n);
  float* at = static_cast<float*>(scratch);
  Scratch s;
  float** bufs[] = {&s.x, &s.qkv, &s.att, &s.a, &s.f, &s.xin};
  for (int i = 0; i < 6; ++i) {
    *bufs[i] = at;
    at += n[i];
  }
  s.hp = reinterpret_cast<unsigned long long*>(at);

  Dims p = model_dims(Din, d, heads, ff, layers, H, S);
  p.T = k_last >= 0 ? k_last + 1 : T;
  p.zero0 = zero0;
  p.k_last = k_last;
  const float* xf = static_cast<const float*>(x);
  const char* tc = static_cast<const char*>(tiles);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PhaseClock ck{static_cast<unsigned long long*>(clock),
                      clock != nullptr ? clock_rows : 0, 0};
  if (is_bf16) return launch<__nv_bfloat16>(xf, w, tc, p, s, of, ck, st);
  return launch<float>(xf, w, tc, p, s, of, ck, st);
}
