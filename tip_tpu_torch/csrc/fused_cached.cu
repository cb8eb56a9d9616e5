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
// the out-projection 1, and one per replayed RNN step:
//   rnn_carry:  1 + 4 L + 2          = 19 at L = 4
//   replay:     1 + 4 L + 2 + steps  = 19 + (valid slots, at most W) <= 59
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
// fixed order, the bias and the residual, and runs LayerNorm or ReLU on the
// one row in its own shared memory, so the vector work costs no phase and
// no barrier. Attention rides in the out-projection's units: a unit needs
// only the heads of its K-slice, computes them from the rings (one warp per
// head; the token's own row comes from shared memory, so the ring write
// needs no barrier before the read) and multiplies on. Block 0 does the
// in-place writes. The replay variant computes the old ring rows' RNN
// inputs (W x d by d x H, the windowed kernels' product_phase) in the first
// phase, where they wait for nothing, replaces the new token's row after
// the layers, and then walks the valid slots with the windowed kernels'
// rnn_phase (W_hh columns resident in shared memory, a barrier per step),
// skipping invalid slots outright: the validity bits are the same in every
// block. Ring rows other than `slot` are never written in a launch; `slot`
// is written by block 0 and read by nobody.

#include "fused_phases.cuh"

namespace {

constexpr int kTile = 32;         // columns of a matrix-vector unit

struct Dims {
  int W;        // ring slots
  int Din, d, heads, ff, layers, H, S;
  int zero0;    // first of the three zeroed input columns
  int slot, commit, rnn_carry;
  int cpb;      // W_hh columns per block in the replay
  int cap;      // floats of one partial-sum buffer
};

// global scratch, f32: partial sums of each product, and the replay's RNN
// inputs (W, H) and hidden states (W, H)
struct Scratch {
  float *p_in, *p_qkv, *p_o, *p_f1, *p_f2, *p_ih, *p_hh, *p_out, *xin, *hs;
};

struct Rings {
  void *k, *v, *enc, *h;          // packing dtype
  unsigned char* valid;           // (W,) bool
};

// how a (K, N) product is cut: n_ct column tiles x n_ks slices of ks rows
struct Cut {
  int n_ct, n_ks, ks;
};

__device__ inline Cut cut_of(int K, int N, int grid) {
  Cut c;
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
                            int N, const Cut& c, int unit, float* part,
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
  const Cut c = cut_of(K, N, gridDim.x);
  for (int unit = blockIdx.x; unit < c.n_ct * c.n_ks; unit += gridDim.x)
    matvec_unit<WT>(vin, W, K, N, c, unit, part, red);
}

// element i of a product whose partial sums another phase stored
__device__ __forceinline__ float gather(const float* part, int n_ks, int N,
                                        int i) {
  float s = __ldcg(part + i);
  for (int ks = 1; ks < n_ks; ++ks)
    s += __ldcg(part + static_cast<size_t>(ks) * N + i);
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
// kr, vr (W, d), one warp per head (attend_head, fused_phases.cuh): slot
// `slot` is the token itself when committed, its k and v taken from qkv
// (shared memory), not from the ring.
template <typename WT>
__device__ void attend_heads(const float* qkv, const WT* kr, const WT* vr,
                             const unsigned char* valid, const Dims& p,
                             int h_lo, int h_hi, float* att, float* ps) {
  const int warp = threadIdx.x >> 5;
  const int d = p.d, hd = p.d / p.heads;
  for (int hh = h_lo + warp; hh <= h_hi; hh += kWarps) {
    const float* q = qkv + hh * hd;
    attend_head<WT>(q, q + d, q + 2 * d, kr + hh * hd, vr + hh * hd, d, valid,
                    p.W, hd, p.slot, p.commit != 0, false, ps + warp * kMaxT,
                    att + hh * hd);
  }
}

template <typename WT>
__global__ void __launch_bounds__(kThreads)
fused_cached_kernel(const float* __restrict__ tok, Weights w, Dims p,
                    Scratch s, Rings r, float* __restrict__ y) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char sm_raw[];
  const int d = p.d, H = p.H, W = p.W, G = gridDim.x;
  const int hd = d / p.heads;
  // widest product input, a multiple of 4 floats (16-byte regions after it)
  const int k_max = (max(max(p.Din, d), max(p.ff, H)) + 3) / 4 * 4;
  // shared memory: the rounded input of the next product, the residual
  // row, qkv, the warps' partial sums, the softmax weights, the replay's
  // step list, product_phase's staging rows, rnn_phase's region
  float* vin = reinterpret_cast<float*>(sm_raw);          // [k_max]
  float* xres = vin + k_max;                              // [d]
  float* qkv = xres + d;                                  // [3 d]
  float* red = qkv + 3 * d;                               // [kWarps][kTile]
  float* ps = red + kWarps * kTile;                       // [kWarps][kMaxT]
  int* rows = reinterpret_cast<int*>(ps + kWarps * kMaxT);  // [kMaxT]
  float* stage = reinterpret_cast<float*>(rows + kMaxT);  // [kRows][d]
  unsigned char* rnn_sm =
      reinterpret_cast<unsigned char*>(stage + kRows * d);
  auto Wt = [](const void* q) { return static_cast<const WT*>(q); };
  const bool writer = blockIdx.x == 0 && p.commit;
  WT* k_ring = static_cast<WT*>(r.k);
  WT* v_ring = static_cast<WT*>(r.v);
  WT* enc = static_cast<WT*>(r.enc);
  WT* h_ring = static_cast<WT*>(r.h);

  // ---- the token, fixed and rounded; the in-projection ---------------------
  for (int k = threadIdx.x; k < p.Din; k += kThreads)
    vin[k] = round_cd<WT>(input_fix(tok[k], k, p.zero0));
  __syncthreads();
  matvec_phase<WT>(vin, Wt(w.w_in), p.Din, d, s.p_in, red);
  if (!p.rnn_carry)
    // the old ring rows' RNN inputs wait for nothing; row `slot` is
    // replaced after the layers when the token is committed
    product_phase<WT>(enc, d, W, d, Wt(w.w_ih), Wt(w.b_r), H, nullptr, s.xin,
                      kActNone, false, -1, stage);
  grid.sync();
  {
    const Cut c = cut_of(p.Din, d, G);
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
    grid.sync();
    {
      const Cut c = cut_of(d, 3 * d, G);
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
      const Cut c = cut_of(d, d, G);
      for (int unit = blockIdx.x; unit < c.n_ct * c.n_ks; unit += G) {
        const int ks = unit / c.n_ct;
        const int k0 = ks * c.ks, k1 = min(d, k0 + c.ks);
        attend_heads<WT>(qkv, kr, vr, r.valid, p, k0 / hd, (k1 - 1) / hd,
                         vin, ps);
        __syncthreads();
        matvec_unit<WT>(vin, Wt(L.w_o), d, d, c, unit, s.p_o, red);
      }
    }
    grid.sync();
    {
      const Cut c = cut_of(d, d, G);
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
    grid.sync();
    {
      const Cut c = cut_of(d, p.ff, G);
      for (int i = threadIdx.x; i < p.ff; i += kThreads)
        vin[i] = round_cd<WT>(fmaxf(
            gather(s.p_f1, c.n_ks, p.ff, i) + wload(Wt(L.b_f1) + i), 0.0f));
      __syncthreads();
    }
    matvec_phase<WT>(vin, Wt(L.w_f2), p.ff, d, s.p_f2, red);
    grid.sync();
    {
      const Cut c = cut_of(p.ff, d, G);
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
  const Cut c_ih = cut_of(d, H, G);
  if (p.rnn_carry) {
    // one step from the carried hidden; both products in one phase
    for (int k = threadIdx.x; k < H; k += kThreads)
      vin[k] = wvalue(h_ring[k]);
    __syncthreads();
    matvec_phase<WT>(vin, Wt(w.w_hh), H, H, s.p_hh, red);
    grid.sync();
    const Cut c_hh = cut_of(H, H, G);
    for (int i = threadIdx.x; i < H; i += kThreads) {
      const float pre = gather(s.p_ih, c_ih.n_ks, H, i) + wload(Wt(w.b_r) + i);
      const float ht = tanhf(pre + gather(s.p_hh, c_hh.n_ks, H, i));
      if (writer) h_ring[i] = to_ring<WT>(ht);
      vin[i] = round_cd<WT>(ht);
    }
    __syncthreads();
  } else {
    grid.sync();
    // the valid slots, oldest first: the walk starts after the cursor
    if (threadIdx.x == 0) {
      int n = 0;
      for (int t = 0; t < W; ++t) {
        const int idx = (p.slot + 1 + t) % W;
        if (r.valid[idx] || (p.commit && idx == p.slot)) rows[n++] = idx;
      }
      rows[kMaxT - 1] = n;        // W < kMaxT leaves the last entry free
    }
    __syncthreads();
    const int steps = rows[kMaxT - 1];
    // the committed token's RNN input replaces its ring row's, each block
    // for the W_hh columns it owns
    const int c0 = blockIdx.x * p.cpb;
    if (p.commit && threadIdx.x < p.cpb && c0 + threadIdx.x < H) {
      const int i = c0 + threadIdx.x;
      s.xin[static_cast<size_t>(p.slot) * H + i] =
          gather(s.p_ih, c_ih.n_ks, H, i) + wload(Wt(w.b_r) + i);
    }
    __syncthreads();
    rnn_phase<WT>(grid, s.xin, Wt(w.w_hh), steps, H, p.cpb, s.hs, rnn_sm,
                  rows);
    for (int k = threadIdx.x; k < H; k += kThreads)
      vin[k] = steps > 0 ? round_cd<WT>(__ldcg(
                               s.hs + static_cast<size_t>(steps - 1) * H + k))
                         : 0.0f;
    __syncthreads();
  }

  // ---- out-projection -------------------------------------------------------
  matvec_phase<WT>(vin, Wt(w.w_out), H, p.S, s.p_out, red);
  grid.sync();
  if (blockIdx.x == 0) {
    const Cut c = cut_of(H, p.S, G);
    for (int i = threadIdx.x; i < p.S; i += kThreads)
      y[i] = gather(s.p_out, c.n_ks, p.S, i) + wload(Wt(w.b_out) + i);
  }
}

template <typename WT>
int launch(const float* tok, const Weights& w, Dims p, float* scratch,
           int scratch_floats, const Rings& r, float* y, cudaStream_t stream) {
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const int grid = sms;           // one block per SM, all co-resident
  p.cpb = (p.H + grid - 1) / grid;
  int n_max = 3 * p.d;
  if (p.ff > n_max) n_max = p.ff;
  if (p.H > n_max) n_max = p.H;
  if (p.S > n_max) n_max = p.S;
  p.cap = kTile * grid > n_max ? kTile * grid : n_max;
  const size_t need = 8 * static_cast<size_t>(p.cap) +
                      2 * static_cast<size_t>(p.W) * p.H;
  if (static_cast<size_t>(scratch_floats) < need) return kErrShape;
  Scratch s;
  float** bufs[] = {&s.p_in, &s.p_qkv, &s.p_o,  &s.p_f1,
                    &s.p_f2, &s.p_ih,  &s.p_hh, &s.p_out};
  for (int i = 0; i < 8; ++i)
    *bufs[i] = scratch + static_cast<size_t>(i) * p.cap;
  s.xin = scratch + 8 * static_cast<size_t>(p.cap);
  s.hs = s.xin + static_cast<size_t>(p.W) * p.H;

  int k_max = p.Din;
  if (p.d > k_max) k_max = p.d;
  if (p.ff > k_max) k_max = p.ff;
  if (p.H > k_max) k_max = p.H;
  k_max = (k_max + 3) / 4 * 4;
  const size_t head_floats = static_cast<size_t>(k_max) + 4 * p.d +
                             kWarps * kTile + kWarps * kMaxT + kMaxT +
                             kRows * p.d;
  const size_t head_bytes = (head_floats * sizeof(float) + 15) / 16 * 16;
  const size_t rnn_bytes =
      (static_cast<size_t>(p.cpb) * p.H * sizeof(WT) + 15) / 16 * 16 +
      static_cast<size_t>(p.H) * sizeof(float);
  const size_t smem = head_bytes + rnn_bytes;
  if (smem > static_cast<size_t>(smem_max)) return kErrSmem;
  Weights w_arg = w;
  Rings r_arg = r;
  void* args[] = {&tok, &w_arg, &p, &s, &r_arg, &y};
  return launch_cooperative(fused_cached_kernel<WT>, grid, smem, args,
                            stream);
}

}  // namespace

// The least scratch (in floats) fused_cached_launch takes on a card of
// `sms` SMs, so that the caller can allocate it.
extern "C" int fused_cached_scratch_floats(int sms, int W, int d, int ff,
                                           int H, int S) {
  int n_max = 3 * d;
  if (ff > n_max) n_max = ff;
  if (H > n_max) n_max = H;
  if (S > n_max) n_max = S;
  const int cap = kTile * sms > n_max ? kTile * sms : n_max;
  return 8 * cap + 2 * W * H;
}

// weights: the packed list of ops/fused_forward.py::pack_weights, n_w =
// 2 + 12 * layers + 5 device pointers. tok (Din,) f32; k, v (layers, W, d),
// enc (W, d), h (H,) in the packing dtype, valid (W,) bytes; y (S,) f32;
// scratch: at least fused_cached_scratch_floats floats. slot in [0, W).
// Returns a CUDA error code, or -1 for a shape outside the kernel's limits
// (or a scratch too small), -2 when the widths need more shared memory
// than a block has.
extern "C" int fused_cached_launch(
    const void* tok, const void* const* weights, int n_w, int is_bf16, int W,
    int Din, int d, int heads, int ff, int layers, int H, int S, int zero0,
    int slot, int commit, int rnn_carry, void* k, void* v, void* enc, void* h,
    void* valid, void* scratch, int scratch_floats, void* y, void* stream) {
  if (W < 1 || W >= kMaxT || layers < 1 || layers > kMaxLayers ||
      n_w != 2 + 12 * layers + 5 || heads < 1 || d < 1 || d % heads != 0 ||
      d / heads > kMaxHeadDim || Din < 1 || ff < 1 || H < 1 || S < 1 ||
      slot < 0 || slot >= W)
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
  p.cpb = 0;
  p.cap = 0;
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
  if (is_bf16)
    return launch<__nv_bfloat16>(tf, w, p, sf, scratch_floats, r, yf, st);
  return launch<float>(tf, w, p, sf, scratch_floats, r, yf, st);
}
