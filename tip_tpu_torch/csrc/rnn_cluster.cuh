// The walk over time of the tanh RNN with W_hh resident in a thread-block
// cluster: K1's forward (fused_rnn.cu) and, run backwards, the recurrence
// of K10's BPTT (fused_rnn_bwd.cu).
//
//   forward:  h_t  = tanh(xin_t + h_{t-1} W),            h_{-1} = 0
//   backward: da_t = (g_t + da_{t+1} W^T) (1 - h_t^2),   da_T = 0
//
// for W (H, H) stored row-major as (in, out). Both are a (B, H) x (H, H)
// product a step whose every output needs the whole previous row, so what
// bounds them is latency: T dependent steps, each of which would read W
// (1 MB in f32 at H 512) from L2 through one SM if W stayed in memory.
//
// Both walks keep W on chip for the whole launch, spread over a cluster of
// 8 blocks (the portable cluster size): block r takes output columns [r
// cols, (r+1) cols) (cols 32 or 64, the columns past H zero). A cluster
// owns a tile of batch rows (up to 16 in f32, 32 in bf16: an H100 runs at
// most 15 clusters of these blocks at once); every block keeps the tile's
// whole previous row (h_{t-1} or da_{t+1}) in two buffers that alternate,
// so one cluster barrier a step is enough: in a step each block computes
// its columns for the tile, 8 warps each one eighth of the depth, adds the 8
// partial sums in a fixed order, finishes them with the inputs loaded a
// step ahead (xin_t; or g_t and h_t), writes them to global memory and,
// through distributed shared memory, into the next buffer of every block.
// The launch plan (cluster, columns a block, batch tile, clusters, shared
// bytes) comes from ops/fused_rnn.py and is checked here (walk_plan_ok,
// tc_plan_ok).
//
// f32 (walk_kernel): W's slice in shared memory as (depth, cols), W's
// columns for the forward and its rows transposed as staged for the
// backward; warp k takes depth slice k, a lane two columns (so that each
// previous value is read once a block), summed with fmaf on the CUDA
// cores; the row buffers f32.
//
// bf16 (tc_walk_kernel): the step's product runs on the tensor cores, bf16
// mma.sync m16n8k16 with f32 sums, swapped so that the block's columns are
// the 16-row side and the batch tile the 8-wide one: out^T (cols, tile) =
// W_slice^T (cols, H) h^T (H, tile), 16 mma a warp at tiles up to 8 rows,
// 32 at 16. W's slice is staged once through shared memory and then kept
// in registers as the mma's A fragments for the whole launch (warp k: its
// 64-deep slice of the block's columns, 64 registers a thread at 64
// columns), so no step reads W at all; the forward reads W's columns with
// ldmatrix.trans, the backward W's rows as they lie (no transposed copy).
// The row buffers hold the bf16 rows as they are (h_{t-1} and da_{t+1} are
// bf16 values), padded so that ldmatrix is free of bank conflicts, and the
// broadcast is 16 bytes a store (two lanes pair their four columns). The
// cluster barrier is split into arrive.release after the broadcast and
// wait.acquire after the step's global stores. The step rounds where
// tip_tpu's kernel does. Forwards: the f32 sum to bf16, the add of xin_t in
// f32 to bf16, tanh (accurate tanhf) in f32 to bf16. Backwards: da = (g +
// sum)(1 - h^2) in f32, rounded to bf16 once; that value is written as
// dxin, is the next step's row, and is written a row up into dW's operand
// (shifted: shifted[b, t-1] = da_t, shifted[b, T-1] = 0), so that dW =
// hs^T shifted is one plain product. With the clock on (kClock, a separate
// instantiation) block 0's thread 0 sums the cycles of each phase of the
// step: product, split sum, epilogue, broadcast, barrier wait.
//
// What holds a bf16 step once the product is on the tensor cores: its
// chain of dependent latencies (the ldmatrix of the row, the mma, the
// partial sums through shared memory and a block barrier, tanh, the
// broadcast and the cluster barrier), nearly the same at every tile.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rnnc {

namespace cg = cooperative_groups;

constexpr int kCluster = 8;
constexpr int kThreads = 256;
constexpr int kSplits = kThreads / 32;   // a warp a depth slice
constexpr int kMaxSmem = 232448;         // dynamic shared memory of a block

// the depth a warp takes: H / 8 rounded up to a multiple of 4
__host__ __device__ constexpr int slice_depth(int H) {
  return ((H + kSplits - 1) / kSplits + 3) / 4 * 4;
}

// the columns a block of the cluster keeps: H / 8 rounded up to a
// multiple of `unit` (f32 32, bf16 16 a column tile of the mma), so that
// the 8 blocks cover H; the last blocks' columns past H are zero
__host__ __device__ constexpr int block_cols(int H, int unit) {
  return ((H + kCluster - 1) / kCluster + unit - 1) / unit * unit;
}

// H rounded up to a multiple of m: the row stride of a padded copy
__host__ __device__ constexpr int round_up(int H, int m) {
  return (H + m - 1) / m * m;
}

// the f32 walk's W slice, two row buffers and partial sums
__host__ __device__ constexpr size_t smem_bytes(int H, int cols, int bt) {
  return sizeof(float) *
         (static_cast<size_t>(kSplits) * slice_depth(H) * cols +
          2 * static_cast<size_t>(bt) * kSplits * slice_depth(H) +
          static_cast<size_t>(kSplits) * bt * cols);
}

// The end of an f32 forward step, h = tanh(xin + sum), and of a bf16 one
// (tc_walk_kernel: tip_tpu's three roundings, the f32 sum, the add, the
// tanh), with the bf16 rounding helpers
struct F32Step {
  static __device__ __forceinline__ float step(float in, float sum) {
    return tanhf(in + sum);
  }
};

struct Bf16Step {
  static __device__ __forceinline__ float rnd(float v) {   // to bf16, f32
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ unsigned bits(float v) {
    return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
  }
  static __device__ __forceinline__ float step(float in, float sum) {
    return rnd(tanhf(rnd(in + rnd(sum))));
  }
};

// The f32 walk. BT batch rows a cluster; C = cols / 32 columns a thread
// (lane, lane + 32, ...). kBack: in = g, hs = the hidden states, out = da;
// else in = xin, out = h. Rows of global memory are read and written 16
// bytes at a time where H is a multiple of 4, else a value at a time (the
// values past H read as zero); there the backward also writes hs and da
// with rows padded to a multiple of 4 (pad: hs's copy, then da's, B T
// round_up(H, 4) each, zero past H), dW's operands. kAligned (H a multiple of
// 4) and the other case are separate instantiations.
template <int BT, int C, bool kBack, bool kAligned>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
walk_kernel(const float* __restrict__ in, const float* __restrict__ hs,
            const float* __restrict__ w, float* __restrict__ out,
            float* __restrict__ pad, int B, int T, int H) {
  using S = float;
  constexpr int cols = 32 * C;
  constexpr int quads = BT * cols / 4;   // float4 outputs of a block a step
  constexpr int kVec = 16 / static_cast<int>(sizeof(S));   // a copy's values
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b0 = (blockIdx.x / kCluster) * BT;
  const int col0 = rank * cols;
  const int klen = slice_depth(H);
  const int ld = kSplits * klen;         // padded depth, a row's stride
  const int tid = threadIdx.x, lane = tid % 32, ks = tid / 32;

  extern __shared__ float4 sh4[];
  S* Ws = reinterpret_cast<S*>(sh4);                   // (ld, cols)
  float* hbuf = reinterpret_cast<float*>(
      Ws + static_cast<size_t>(ld) * cols);            // 2 x (BT, ld)
  float* red = hbuf + 2 * BT * ld;                     // (kSplits, BT, cols)

  if (!kBack && H % kVec == 0 && col0 + cols <= H && ld == H) {
    // W's column slice, 16 bytes a copy
    for (int e = tid; e < H * (cols / kVec); e += kThreads) {
      const int i = e / (cols / kVec), q = e % (cols / kVec);
      const S* src = w + static_cast<size_t>(i) * H + col0 + kVec * q;
      const unsigned dst = static_cast<unsigned>(
          __cvta_generic_to_shared(Ws + i * cols + kVec * q));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                   "l"(src));
    }
    asm volatile("cp.async.commit_group;\n" ::);
  } else {
    // Ws[i, c] = W[i, col0 + c] (forward) or W[col0 + c, i] (backward: a
    // row of W, transposed; consecutive threads on consecutive columns),
    // zero past H
    for (int e = tid; e < ld * cols; e += kThreads) {
      const int c = e % cols, i = e / cols;
      const int j = col0 + c;
      S v = 0.0f;
      if (i < H && j < H)
        v = kBack ? w[static_cast<size_t>(j) * H + i]
                  : w[static_cast<size_t>(i) * H + j];
      Ws[i * cols + c] = v;
    }
  }
  for (int e = tid; e < 2 * BT * ld; e += kThreads) hbuf[e] = 0.0f;

  // the thread's float4 of outputs (row ob, columns oc..oc+3) and its
  // inputs, loaded a step ahead
  const bool owner = tid < quads;
  const int ob = tid / (cols / 4), oc = 4 * (tid % (cols / 4));
  const int orow = b0 + ob;
  const bool live = owner && orow < B && col0 + oc < H;
  const size_t o_at = static_cast<size_t>(orow) * T * H + col0 + oc;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  constexpr bool vec = kAligned;     // 16-byte rows
  const int ldp = round_up(H, 4);
  const bool pad_live = !vec && pad != nullptr && owner && orow < B &&
                        col0 + oc < ldp;
  const size_t p_at = static_cast<size_t>(orow) * T * ldp + col0 + oc;
  auto t_of = [&](int s) { return kBack ? T - 1 - s : s; };
  auto ld4 = [&](const S* p, int s) {
    const S* a = p + o_at + static_cast<size_t>(t_of(s)) * H;
    if (vec) return *reinterpret_cast<const float4*>(a);
    const int c = col0 + oc;
    return make_float4(a[0], c + 1 < H ? a[1] : 0.0f, c + 2 < H ? a[2] : 0.0f,
                       c + 3 < H ? a[3] : 0.0f);
  };
  float4 in_next = live ? ld4(in, 0) : zero;
  float4 h_next = kBack && live ? ld4(hs, 0) : zero;

  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  cluster.sync();   // every block runs before any block writes into it

  for (int s = 0; s < T; ++s) {
    const int t = t_of(s);
    const float* hc = hbuf + (s & 1) * BT * ld;
    float* hn = hbuf + ((s + 1) & 1) * BT * ld;
    const float4 iv = in_next, hv = h_next;
    if (live && s + 1 < T) {
      in_next = ld4(in, s + 1);
      if (kBack) h_next = ld4(hs, s + 1);
    }
    float acc[C][2][BT];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int b = 0; b < BT; ++b) acc[c][j][b] = 0.0f;
    const int k0 = ks * klen;
#pragma unroll 2
    for (int i = k0; i < k0 + klen; i += 4) {
      float wv[C][4];
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wv[c][j] = Ws[(i + j) * cols + lane + 32 * c];
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        const float4 h = *reinterpret_cast<const float4*>(hc + b * ld + i);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          acc[c][0][b] = fmaf(h.x, wv[c][0], acc[c][0][b]);
          acc[c][1][b] = fmaf(h.y, wv[c][1], acc[c][1][b]);
          acc[c][0][b] = fmaf(h.z, wv[c][2], acc[c][0][b]);
          acc[c][1][b] = fmaf(h.w, wv[c][3], acc[c][1][b]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int b = 0; b < BT; ++b)
        red[(ks * BT + b) * cols + lane + 32 * c] =
            acc[c][0][b] + acc[c][1][b];
    __syncthreads();
    if (owner) {
      float4 sm = zero;
      for (int k = 0; k < kSplits; ++k) {   // in order: the same bits
        const float4 r =
            *reinterpret_cast<const float4*>(red + (k * BT + ob) * cols + oc);
        sm.x += r.x;
        sm.y += r.y;
        sm.z += r.z;
        sm.w += r.w;
      }
      float4 o;
      if (kBack) {   // da = (g + da_{t+1} W^T) (1 - h^2)
        o = make_float4((iv.x + sm.x) * (1.0f - hv.x * hv.x),
                        (iv.y + sm.y) * (1.0f - hv.y * hv.y),
                        (iv.z + sm.z) * (1.0f - hv.z * hv.z),
                        (iv.w + sm.w) * (1.0f - hv.w * hv.w));
      } else {
        o = make_float4(F32Step::step(iv.x, sm.x), F32Step::step(iv.y, sm.y),
                        F32Step::step(iv.z, sm.z), F32Step::step(iv.w, sm.w));
      }
      if (!live) o = zero;   // the padding past H stays 0
      if (live) {
        float* at = out + o_at + static_cast<size_t>(t) * H;
        if (vec) {
          *reinterpret_cast<float4*>(at) = o;
        } else {
          const int c = col0 + oc;
          at[0] = o.x;
          if (c + 1 < H) at[1] = o.y;
          if (c + 2 < H) at[2] = o.z;
          if (c + 3 < H) at[3] = o.w;
        }
      }
      if (kBack && pad_live) {   // dW's operands, rows padded
        const size_t at = p_at + static_cast<size_t>(t) * ldp;
        *reinterpret_cast<float4*>(pad + at) = hv;
        *reinterpret_cast<float4*>(
            pad + static_cast<size_t>(B) * T * ldp + at) = o;
      }
      float4* dst = reinterpret_cast<float4*>(hn + ob * ld + col0 + oc);
      if (col0 + oc < ld) {
#pragma unroll
        for (int r = 0; r < kCluster; ++r)
          *cluster.map_shared_rank(dst, r) = o;
      }
    }
    // the new row is in every block; everyone is done with the old and red
    cluster.sync();
  }
}

template <int BT, int C, bool kBack, bool kAligned>
cudaError_t launch_one(const float* in, const float* hs, const float* w,
                       float* out, float* pad, int B, int T, int H,
                       int clusters, size_t smem, cudaStream_t st) {
  // the attribute once per process and kernel: kMaxSmem covers every plan
  static const cudaError_t attr = cudaFuncSetAttribute(
      walk_kernel<BT, C, kBack, kAligned>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  walk_kernel<BT, C, kBack, kAligned>
      <<<clusters * kCluster, kThreads, smem, st>>>(in, hs, w, out, pad, B,
                                                    T, H);
  return cudaGetLastError();
}

template <int BT, int C, bool kBack>
cudaError_t launch(const float* in, const float* hs, const float* w,
                   float* out, float* pad, int B, int T, int H, int clusters,
                   size_t smem, cudaStream_t st) {
  return H % 4 == 0
             ? launch_one<BT, C, kBack, true>(in, hs, w, out, pad, B, T, H,
                                              clusters, smem, st)
             : launch_one<BT, C, kBack, false>(in, hs, w, out, pad, B, T, H,
                                               clusters, smem, st);
}

template <int C, bool kBack>
cudaError_t launch_tile(int bt, const float* in, const float* hs,
                        const float* w, float* out, float* pad, int B, int T,
                        int H, int clusters, size_t smem, cudaStream_t st) {
  switch (bt) {
    case 1: return launch<1, C, kBack>(in, hs, w, out, pad, B, T, H,
                                       clusters, smem, st);
    case 2: return launch<2, C, kBack>(in, hs, w, out, pad, B, T, H,
                                       clusters, smem, st);
    case 4: return launch<4, C, kBack>(in, hs, w, out, pad, B, T, H,
                                       clusters, smem, st);
    case 8: return launch<8, C, kBack>(in, hs, w, out, pad, B, T, H,
                                       clusters, smem, st);
    case 16: return launch<16, C, kBack>(in, hs, w, out, pad, B, T, H,
                                         clusters, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

// A plan of the f32 walk (ops/fused_rnn.py), checked: a cluster of 8
// blocks of `cols` columns each (block_cols(H, 32): 32, 64 or 96), `bt`
// batch rows a cluster (1, 2, 4, 8 or 16), `clusters` clusters that cover
// the B rows exactly, `smem` bytes of shared memory.
inline bool walk_plan_ok(int B, int H, int cluster, int cols, int bt,
                         int clusters, long long smem) {
  return cluster == kCluster && cols == block_cols(H, 32) && cols <= 96 &&
         (bt == 1 || bt == 2 || bt == 4 || bt == 8 || bt == 16) &&
         clusters > 0 && static_cast<long long>(clusters) * bt >= B &&
         static_cast<long long>(clusters - 1) * bt < B &&
         smem == static_cast<long long>(smem_bytes(H, cols, bt)) &&
         smem <= kMaxSmem;
}

// one f32 walk by a checked plan; pad: the backward's padded operands
// where H is not a multiple of 4 (else null)
template <bool kBack>
cudaError_t walk(const float* in, const float* hs, const float* w,
                 float* out, float* pad, int B, int T, int H, int cols,
                 int bt, int clusters, long long smem, cudaStream_t st) {
  const size_t sm = static_cast<size_t>(smem);
  switch (cols) {
    case 32: return launch_tile<1, kBack>(bt, in, hs, w, out, pad, B, T, H,
                                          clusters, sm, st);
    case 64: return launch_tile<2, kBack>(bt, in, hs, w, out, pad, B, T, H,
                                          clusters, sm, st);
    case 96: return launch_tile<3, kBack>(bt, in, hs, w, out, pad, B, T, H,
                                          clusters, sm, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---- the bf16 walk on the tensor cores ----

using bf16 = __nv_bfloat16;

// The walk's padded depth: 64 a warp (512) up to 64 columns a block, the
// block's columns a warp past that (768 at 96 columns, H up to 768: the
// deep instantiation, W's slice 96 x 96 a warp in registers)
__host__ __device__ constexpr int tc_depth(int cols) {
  return kSplits * (cols > 64 ? cols : 64);
}
constexpr int kTcDepth = tc_depth(64);   // H up to 512
// bf16 stride of a buffered row
__host__ __device__ constexpr int tc_ldh(int cols) {
  return tc_depth(cols) + 8;
}
constexpr int kLdh = tc_ldh(64);
// the phases of the step's clock (kClock), in the order of the step
constexpr int kTcPhases = 5;

constexpr int kTcMaxTile = 32;           // batch rows of a cluster at most
// rows of the row buffers: the mma's 8-wide side, 1 to 4 times
__host__ __device__ constexpr int tc_rows(int bt) { return (bt + 7) / 8 * 8; }

// a block asks for at least this much, so that no two share an SM
constexpr size_t kTcMinSmem = 120 * 1024;

// W's slice as staged (forward (depth, cols + 8), backward (cols, ldh)),
// the two row buffers (bf16) and the partial sums (f32, (kSplits, bt, cols
// + 4)); every part a multiple of 16 bytes; at least kTcMinSmem
__host__ __device__ constexpr size_t tc_smem_bytes(int cols, int bt,
                                                   bool back) {
  const size_t need =
      2 * (back ? static_cast<size_t>(cols) * tc_ldh(cols)
                : static_cast<size_t>(tc_depth(cols)) * (cols + 8)) +
      2 * 2 * static_cast<size_t>(tc_rows(bt)) * tc_ldh(cols) +
      4 * static_cast<size_t>(kSplits) * bt * (cols + 4);
  return need > kTcMinSmem ? need : kTcMinSmem;
}

__device__ __forceinline__ unsigned long long tc_stamp() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}

// The step's clock: cycles summed by phase over the steps (block 0's
// thread 0 writes them); compiled only into the clocked instantiation
template <bool kOn>
struct StepClock {
  unsigned long long t0 = 0, t1 = 0, last = 0, sum[kTcPhases] = {};
  __device__ __forceinline__ void start() {
    if constexpr (kOn) t0 = tc_stamp();
  }
  __device__ __forceinline__ void loop() {
    if constexpr (kOn) last = t1 = tc_stamp();
  }
  __device__ __forceinline__ void mark(int phase) {
    if constexpr (kOn) {
      const unsigned long long now = tc_stamp();
      sum[phase] += now - last;
      last = now;
    }
  }
  // clk: the kernel's start, the loop's start, then the end of each phase
  // as if the phases ran one after another (7 u64)
  __device__ __forceinline__ void write(unsigned long long* clk) const {
    if constexpr (kOn) {
      if (clk != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
        clk[0] = t0;
        clk[1] = t1;
        unsigned long long at = t1;
        for (int i = 0; i < kTcPhases; ++i) clk[2 + i] = at += sum[i];
      }
    }
  }
};

// in a clocked launch only: the values are computed before the next stamp
template <bool kOn>
__device__ __forceinline__ void tc_settle(uint32_t a, uint32_t b) {
  if constexpr (kOn) asm volatile("" ::"r"(a), "r"(b) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p)))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p)))
      : "memory");
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float4 bf16x4_to_f(uint2 u) {
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  return Bf16Step::bits(lo) | (Bf16Step::bits(hi) << 16);
}

// MT = cols / 16 column tiles of a block (2, 4 or 6), NB = batch tiles of
// 8 rows (1 to 4: tiles of up to 8 NB rows); bt the tile (runtime); the
// depth tc_depth(cols), KS 16-deep steps a warp (4; 6 at 96 columns). kBack:
// in = g, hs = the hidden states, out = da, shifted = da a row up (dW's
// operand); else in = xin, out = h. kClock: the step's clock into clk.
// Rows of global memory are read and written 16 bytes at a time where H is
// a multiple of 8, else a value at a time (the values past H read as
// zero); there the backward writes shifted with rows padded to a multiple
// of 8 (zero past H) and hs likewise into hs_pad, dW's operands. kAligned (H a
// multiple of 8) and the other case are separate instantiations.
template <int MT, int NB, bool kBack, bool kClock, bool kAligned>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
tc_walk_kernel(const bf16* __restrict__ in, const bf16* __restrict__ hs,
               const bf16* __restrict__ w, bf16* __restrict__ out,
               bf16* __restrict__ shifted, bf16* __restrict__ hs_pad, int B,
               int T, int H, int bt, unsigned long long* __restrict__ clk) {
  constexpr int cols = 16 * MT;
  constexpr int depth = tc_depth(cols);
  constexpr int ldh = tc_ldh(cols);
  constexpr int KS = depth / kSplits / 16;       // 16-deep steps a warp
  constexpr int ldw = kBack ? ldh : cols + 8;    // W's slice, staged
  constexpr int ldr = cols + 4;                  // the partial sums
  constexpr int R = 8 * NB;                      // rows of a row buffer
  static_assert(KS % 2 == 0, "a row's fragments come 32 deep at a time");
  // the epilogue's quads (four outputs) a thread takes: 1, or 2-3 at tiles
  // past 16 rows of 64 columns
  constexpr int QPT = (R * cols / 4 + kThreads - 1) / kThreads;
  StepClock<kClock> clock;
  clock.start();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b0 = (blockIdx.x / kCluster) * bt;
  const int col0 = rank * cols;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane >> 2, q = lane & 3;
  const int kw = warp * 16 * KS;   // the warp's depth slice
  constexpr bool vec = kAligned;       // 16-byte rows
  const int lds = vec ? H : round_up(H, 8);   // shifted's row stride

  extern __shared__ float4 sh4[];
  bf16* Ws = reinterpret_cast<bf16*>(sh4);
  bf16* hbuf = Ws + (kBack ? cols * ldh : depth * ldw);   // 2 x (R, ldh)
  float* red = reinterpret_cast<float*>(hbuf + 2 * R * ldh);  // (8, bt, ldr)

  // W's slice, 16 bytes a copy, zero past H: forward Ws[i, c] = W[i, col0
  // + c], backward Ws[c, i] = W[col0 + c, i] (a row of W as it lies); a
  // value at a time where H is not a multiple of 8
  constexpr int per_row = (kBack ? depth : cols) / 8;
  for (int e = tid; e < (kBack ? cols : depth) * per_row; e += kThreads) {
    const int r = e / per_row, c = 8 * (e % per_row);
    const int i = kBack ? c : r, j = kBack ? r : c;   // W[i, col0 + j]...
    bf16* dst = Ws + r * ldw + c;
    const bool in_w = i < H && col0 + j < H;
    const bf16* src = kBack ? w + static_cast<size_t>(col0 + j) * H + i
                            : w + static_cast<size_t>(i) * H + col0 + j;
    if (in_w && vec) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                   "l"(src));
    } else if (in_w) {
      // forward: W[i, col0 + j + u]; backward: W[col0 + j, i + u]
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const bool ok = kBack ? i + u < H : col0 + j + u < H;
        dst[u] = ok ? src[u] : __float2bfloat16_rn(0.0f);
      }
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int e = tid; e < 2 * R * ldh / 8; e += kThreads)
    reinterpret_cast<uint4*>(hbuf)[e] = make_uint4(0, 0, 0, 0);

  // quad j of the thread, qd = tid + j kThreads: four outputs (row ob,
  // columns oc..oc+3; lanes qd and qd ^ 1 hold eight) and its inputs,
  // loaded a step ahead
  const int quads = bt * cols / 4;
  // pair_live: the lane pair's first column lies inside H, so both lanes
  // broadcast the pair's eight columns (where H is not a multiple of 8 the
  // odd lane's four may lie past H while the even lane's do not; they are
  // zero, and the even lane's reach ranks 4-7 only through the odd lane)
  bool owner[QPT], live[QPT], pad_live[QPT], pair_live[QPT];
  int ob[QPT], oc[QPT];
  size_t o_at[QPT];
  uint2 in_next[QPT], h_next[QPT];
  auto t_of = [&](int s) { return kBack ? T - 1 - s : s; };
  const uint2 zero2 = make_uint2(0, 0);
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int qd = tid + j * kThreads;
    owner[j] = qd < quads;
    ob[j] = qd / (cols / 4);
    oc[j] = 4 * (qd % (cols / 4));
    live[j] = owner[j] && b0 + ob[j] < B && col0 + oc[j] < H;
    pad_live[j] = !vec && owner[j] && b0 + ob[j] < B && col0 + oc[j] < lds;
    pair_live[j] = owner[j] && b0 + ob[j] < B && col0 + (oc[j] & ~4) < H;
    o_at[j] = static_cast<size_t>(b0 + ob[j]) * T * H + col0 + oc[j];
  }
  auto ld4 = [&](const bf16* p, int j, int s) {
    const bf16* a = p + o_at[j] + static_cast<size_t>(t_of(s)) * H;
    if (vec) return *reinterpret_cast<const uint2*>(a);
    const unsigned short* u = reinterpret_cast<const unsigned short*>(a);
    const int c = col0 + oc[j];
    const unsigned v1 = c + 1 < H ? u[1] : 0u, v2 = c + 2 < H ? u[2] : 0u,
                   v3 = c + 3 < H ? u[3] : 0u;
    return make_uint2(u[0] | (v1 << 16), v2 | (v3 << 16));
  };
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    in_next[j] = live[j] ? ld4(in, j, 0) : zero2;
    h_next[j] = kBack && live[j] ? ld4(hs, j, 0) : zero2;
  }

  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  // the mma's A fragments of W_slice^T (cols x the warp's depth): column
  // tile mt, 16-deep step kk; ldmatrix matrix lane / 8 holds rows 8 (m % 2)
  // and depth 8 (m / 2) of the 16 x 16 piece
  uint32_t wa[MT][KS][4];
  {
    const int mat = lane >> 3, r8 = lane & 7;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const int m = 16 * mt + 8 * (mat & 1);
        const int k = kw + 16 * kk + 8 * (mat >> 1);
        if (kBack)
          ldsm_x4(wa[mt][kk], Ws + (m + r8) * ldw + k);
        else
          ldsm_x4_trans(wa[mt][kk], Ws + (k + r8) * ldw + m);
      }
  }
  cluster.sync();   // every block's buffers are zero before any write
  clock.loop();

  for (int s = 0; s < T; ++s) {
    const int t = t_of(s);
    const bf16* hc = hbuf + (s & 1) * R * ldh;
    bf16* hn = hbuf + ((s + 1) & 1) * R * ldh;
    uint2 iv[QPT], hv[QPT];
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      iv[j] = in_next[j];
      hv[j] = h_next[j];
      if (live[j] && s + 1 < T) {
        in_next[j] = ld4(in, j, s + 1);
        if (kBack) h_next[j] = ld4(hs, j, s + 1);
      }
    }
    // the product, a batch tile of 8 rows at a time: the B fragments of
    // h^T (the warp's depth slice of rows 8 nb..), ldmatrix matrix lane / 8
    // holding depth 8 (lane / 8) of 32; then the warp's partial sums,
    // red[warp, n, m]: fragment register r holds column m = 16 mt + g (+8
    // for r >= 2) and row n = 8 nb + 2 q (+1 for odd r)
    float* rw = red + warp * bt * ldr;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      if (8 * nb >= bt) break;
      uint32_t hb[KS][2];
#pragma unroll
      for (int half = 0; half < KS / 2; ++half) {
        uint32_t r[4];
        ldsm_x4(r, hc + (8 * nb + (lane & 7)) * ldh + kw + 32 * half +
                       8 * (lane >> 3));
        hb[2 * half][0] = r[0];
        hb[2 * half][1] = r[1];
        hb[2 * half + 1][0] = r[2];
        hb[2 * half + 1][1] = r[3];
      }
      float acc[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mt][r] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma16816(acc[mt], wa[mt][kk], hb[kk]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int n = 8 * nb + 2 * q + (r & 1);
          if (n < bt) rw[n * ldr + 16 * mt + g + 8 * (r >> 1)] = acc[mt][r];
        }
    }
    clock.mark(0);   // product
    __syncthreads();
    float4 sm[QPT];
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      sm[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (owner[j]) {
        float4 u[kSplits];
#pragma unroll
        for (int k = 0; k < kSplits; ++k)   // all loads in flight
          u[k] = *reinterpret_cast<const float4*>(
              red + (k * bt + ob[j]) * ldr + oc[j]);
#pragma unroll
        for (int k = 0; k < kSplits; ++k) {   // in order: the same bits
          sm[j].x += u[k].x;
          sm[j].y += u[k].y;
          sm[j].z += u[k].z;
          sm[j].w += u[k].w;
        }
      }
    }
    tc_settle<kClock>(__float_as_uint(sm[0].x), __float_as_uint(sm[QPT - 1].w));
    clock.mark(1);   // split sum
    uint2 mine[QPT];
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      mine[j] = zero2;
      if (owner[j]) {
        const float4 i4 = bf16x4_to_f(iv[j]);
        const float4 a = sm[j];
        float4 o;
        if (kBack) {   // da = (g + da_{t+1} W^T) (1 - h^2), rounded once
          const float4 h4 = bf16x4_to_f(hv[j]);
          o = make_float4((i4.x + a.x) * (1.0f - h4.x * h4.x),
                          (i4.y + a.y) * (1.0f - h4.y * h4.y),
                          (i4.z + a.z) * (1.0f - h4.z * h4.z),
                          (i4.w + a.w) * (1.0f - h4.w * h4.w));
        } else {
          o = make_float4(Bf16Step::step(i4.x, a.x), Bf16Step::step(i4.y, a.y),
                          Bf16Step::step(i4.z, a.z), Bf16Step::step(i4.w, a.w));
        }
        mine[j] = make_uint2(bf16x2_bits(o.x, o.y), bf16x2_bits(o.z, o.w));
      }
    }
    tc_settle<kClock>(mine[0].x, mine[QPT - 1].y);
    clock.mark(2);   // epilogue
    // a lane pair's eight columns, 16 bytes: the even lane broadcasts to
    // ranks 0-3, the odd one to 4-7
    const bool odd = tid & 1;
    uint4 v8[QPT];
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const uint2 other =
          make_uint2(__shfl_xor_sync(0xffffffffu, mine[j].x, 1),
                     __shfl_xor_sync(0xffffffffu, mine[j].y, 1));
      v8[j] = odd ? make_uint4(other.x, other.y, mine[j].x, mine[j].y)
                  : make_uint4(mine[j].x, mine[j].y, other.x, other.y);
      if (vec ? live[j] : pair_live[j]) {
        uint4* dst = reinterpret_cast<uint4*>(hn + ob[j] * ldh + col0 +
                                              (oc[j] & ~4));
#pragma unroll
        for (int r = 0; r < kCluster / 2; ++r)
          *cluster.map_shared_rank(dst, (odd ? kCluster / 2 : 0) + r) = v8[j];
      }
    }
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    clock.mark(3);   // broadcast
    if (vec) {
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        if (!live[j] || odd) continue;
        const size_t at = o_at[j] - (oc[j] & 4);   // the pair's eight columns
        *reinterpret_cast<uint4*>(out + at + static_cast<size_t>(t) * H) =
            v8[j];
        if (kBack) {   // dW's operand: da_t a row up, zero in the last row
          if (t > 0)
            *reinterpret_cast<uint4*>(shifted + at +
                                      static_cast<size_t>(t - 1) * H) = v8[j];
          if (t == T - 1)
            *reinterpret_cast<uint4*>(shifted + at +
                                      static_cast<size_t>(t) * H) =
                make_uint4(0, 0, 0, 0);
        }
      }
    } else {
      // a value at a time; the backward's operands padded to lds columns
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        const unsigned short o4[4] = {
            static_cast<unsigned short>(mine[j].x),
            static_cast<unsigned short>(mine[j].x >> 16),
            static_cast<unsigned short>(mine[j].y),
            static_cast<unsigned short>(mine[j].y >> 16)};
        const int c = col0 + oc[j];
        if (live[j]) {
          unsigned short* o = reinterpret_cast<unsigned short*>(
              out + o_at[j] + static_cast<size_t>(t) * H);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (c + u < H) o[u] = o4[u];
        }
        if (kBack && pad_live[j]) {
          const unsigned short h4[4] = {
              static_cast<unsigned short>(hv[j].x),
              static_cast<unsigned short>(hv[j].x >> 16),
              static_cast<unsigned short>(hv[j].y),
              static_cast<unsigned short>(hv[j].y >> 16)};
          const size_t p_at = (static_cast<size_t>(b0 + ob[j]) * T + t) * lds +
                              c;
          unsigned short* hp =
              reinterpret_cast<unsigned short*>(hs_pad + p_at);
          unsigned short* sp =
              reinterpret_cast<unsigned short*>(shifted + p_at);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (c + u >= lds) break;
            hp[u] = h4[u];
            if (t > 0) sp[u - lds] = o4[u];
            if (t == T - 1) sp[u] = 0;
          }
        }
      }
    }
    // the new row is in every block; everyone is done with the old and red
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    clock.mark(4);   // barrier wait
  }
  clock.write(clk);
}

template <int MT, int NB, bool kBack, bool kClock, bool kAligned>
cudaError_t tc_launch(const bf16* in, const bf16* hs, const bf16* w,
                      bf16* out, bf16* shifted, bf16* hs_pad, int B, int T,
                      int H, int bt, int clusters, size_t smem,
                      unsigned long long* clk, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      tc_walk_kernel<MT, NB, kBack, kClock, kAligned>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  tc_walk_kernel<MT, NB, kBack, kClock, kAligned>
      <<<clusters * kCluster, kThreads, smem, st>>>(
          in, hs, w, out, shifted, hs_pad, B, T, H, bt, clk);
  return cudaGetLastError();
}

template <int MT, bool kBack, bool kClock, bool kAligned>
cudaError_t tc_launch_rows(const bf16* in, const bf16* hs, const bf16* w,
                           bf16* out, bf16* shifted, bf16* hs_pad, int B,
                           int T, int H, int bt, int clusters, size_t smem,
                           unsigned long long* clk, cudaStream_t st) {
  switch (tc_rows(bt) / 8) {
    case 1: return tc_launch<MT, 1, kBack, kClock, kAligned>(
        in, hs, w, out, shifted, hs_pad, B, T, H, bt, clusters, smem, clk,
        st);
    case 2: return tc_launch<MT, 2, kBack, kClock, kAligned>(
        in, hs, w, out, shifted, hs_pad, B, T, H, bt, clusters, smem, clk,
        st);
    case 3: return tc_launch<MT, 3, kBack, kClock, kAligned>(
        in, hs, w, out, shifted, hs_pad, B, T, H, bt, clusters, smem, clk,
        st);
    case 4: return tc_launch<MT, 4, kBack, kClock, kAligned>(
        in, hs, w, out, shifted, hs_pad, B, T, H, bt, clusters, smem, clk,
        st);
    default: return cudaErrorInvalidValue;
  }
}

// A plan of the bf16 walk, checked: a cluster of 8 blocks of `cols`
// columns each (block_cols(H, 32): 32, 64 or 96; the depth tc_depth(cols)),
// `bt` batch rows a cluster (1 to kTcMaxTile), `clusters` clusters that
// cover the B rows exactly, `smem` bytes of shared memory.
inline bool tc_plan_ok(int B, int H, int cluster, int cols, int bt,
                       int clusters, long long smem, bool back) {
  return cluster == kCluster && cols == block_cols(H, 32) && cols <= 96 &&
         bt >= 1 && bt <= kTcMaxTile && clusters > 0 &&
         static_cast<long long>(clusters) * bt >= B &&
         static_cast<long long>(clusters - 1) * bt < B &&
         smem == static_cast<long long>(tc_smem_bytes(cols, bt, back)) &&
         smem <= kMaxSmem;
}

// one bf16 walk by a checked plan, with rows of 16 bytes (kAligned) or not;
// shifted: the backward's dW operand (B, T, H; rows of round_up(H, 8)
// where H is not a multiple of 8, and then hs_pad the same of hs), clk:
// null or the clock's 7 u64 (a separate instantiation, up to 64 columns a
// block, 16-byte rows)
template <bool kBack, bool kAligned>
cudaError_t tc_walk_rows(const bf16* in, const bf16* hs, const bf16* w,
                         bf16* out, bf16* shifted, bf16* hs_pad, int B,
                         int T, int H, int cols, int bt, int clusters,
                         size_t sm, cudaStream_t st) {
  switch (cols) {
    case 32: return tc_launch_rows<2, kBack, false, kAligned>(
        in, hs, w, out, shifted, hs_pad, B, T, H, bt, clusters, sm, nullptr,
        st);
    case 64: return tc_launch_rows<4, kBack, false, kAligned>(
        in, hs, w, out, shifted, hs_pad, B, T, H, bt, clusters, sm, nullptr,
        st);
    case 96: return tc_launch_rows<6, kBack, false, kAligned>(
        in, hs, w, out, shifted, hs_pad, B, T, H, bt, clusters, sm, nullptr,
        st);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kBack>
cudaError_t tc_walk(const bf16* in, const bf16* hs, const bf16* w, bf16* out,
                    bf16* shifted, bf16* hs_pad, int B, int T, int H,
                    int cols, int bt, int clusters, long long smem,
                    unsigned long long* clk, cudaStream_t st) {
  const size_t sm = static_cast<size_t>(smem);
  const bool vec = H % 8 == 0;
  if (clk != nullptr) {
    if (!vec) return cudaErrorInvalidValue;
    switch (cols) {
      case 32: return tc_launch_rows<2, kBack, true, true>(
          in, hs, w, out, shifted, hs_pad, B, T, H, bt, clusters, sm, clk,
          st);
      case 64: return tc_launch_rows<4, kBack, true, true>(
          in, hs, w, out, shifted, hs_pad, B, T, H, bt, clusters, sm, clk,
          st);
      default: return cudaErrorInvalidValue;
    }
  }
  return vec ? tc_walk_rows<kBack, true>(in, hs, w, out, shifted, hs_pad, B,
                                         T, H, cols, bt, clusters, sm, st)
             : tc_walk_rows<kBack, false>(in, hs, w, out, shifted, hs_pad,
                                          B, T, H, cols, bt, clusters, sm,
                                          st);
}

}  // namespace rnnc
