// The walk over time of the tanh RNN with W_hh resident in a thread-block
// cluster: K1's forward (fused_rnn.cu) and, run backwards, the recurrence
// of K10's BPTT (fused_rnn_bwd.cu).
//
//   forward:  h_t  = tanh(xin_t + h_{t-1} W),            h_{-1} = 0
//   backward: da_t = (g_t + da_{t+1} W^T) (1 - h_t^2),   da_T = 0
//
// for W (H, H) stored row-major as (in, out). Both are a (B, H) x (H, H)
// product a step whose every output needs the whole previous row, so what
// bounds them is latency: T dependent steps, each of which would read 1 MB
// of W from L2 through one SM at H 512 if W stayed in memory.
//
// Design: W stays on chip for the whole launch, spread over a cluster of 8
// blocks (the portable cluster size). Block r takes output columns [r cols,
// (r+1) cols) (cols 32 or 64, the columns past H zero) and keeps the slice
// of W they need in its shared memory as (depth, cols): W's columns for
// the forward, W's rows transposed on the way in for the backward (so the
// backward needs no transposed copy of W). A cluster owns a tile of up to
// 16 batch rows; every block keeps the tile's whole previous row (h_{t-1}
// or da_{t+1}) in two buffers, the depth padded with zeros to 8 slices of a
// multiple of 4. In a step each block computes its columns for the tile:
// warp k takes depth slice k, a lane two columns (so that each previous
// value is read from shared memory once a block), and the 8 partial sums
// are added in a fixed order. Then a thread per 4 outputs finishes them
// with the inputs it loaded a step ahead (xin_t; or g_t and h_t), writes
// them to global memory and, through distributed shared memory, into the
// next buffer of every block of the cluster, and the cluster waits on one
// barrier. The buffers alternate, so one barrier a step is enough. The
// launch plan (cluster, columns a block, batch tile, clusters, shared
// bytes) comes from ops/fused_rnn.py and is checked by walk_plan_ok.
//
// Storage: the inputs, W and the outputs are f32, or bf16 (the bf16
// variants of K1 and K10). In bf16, W's slice stays bf16 in shared memory
// (half the bytes), the inputs are widened exactly as they are loaded, the
// products are summed in f32 as in f32, and a step rounds where tip_tpu's
// kernel does. Forwards: the sum to bf16, the add of xin_t in f32 to bf16,
// tanh (accurate tanhf) in f32 to bf16. Backwards: da = (g + sum)(1 - h^2)
// in f32, rounded to bf16 once; that value is written as dxin and is the
// next step's row. The row buffers hold the exact f32 image of the bf16
// row (h_{t-1} or da_{t+1}).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// W's slice (w_bytes an entry), then the two row buffers and the partial
// sums (f32)
__host__ __device__ constexpr size_t smem_bytes(int H, int cols, int bt,
                                                int w_bytes = 4) {
  return static_cast<size_t>(w_bytes) * kSplits * slice_depth(H) * cols +
         sizeof(float) *
             (2 * static_cast<size_t>(bt) * kSplits * slice_depth(H) +
              static_cast<size_t>(kSplits) * bt * cols);
}

// What differs between the two storage types: 4 consecutive values to and
// from f32, the end of a forward step, h = tanh(xin + sum), and the value
// a backward step passes on (keep: as stored)
template <class S>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float from_f(float v) { return v; }
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  static __device__ __forceinline__ float step(float in, float sum) {
    return tanhf(in + sum);
  }
  static __device__ __forceinline__ float keep(float v) { return v; }
};

template <>
struct Io<__nv_bfloat16> {
  using S = __nv_bfloat16;
  static __device__ __forceinline__ float to_f(S v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ S from_f(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float rnd(float v) {   // to bf16, f32
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ unsigned bits(float v) {
    return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
  }
  static __device__ __forceinline__ float4 load4(const S* p) {   // 8 bytes
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
  }
  static __device__ __forceinline__ void store4(S* p, float4 v) {
    *reinterpret_cast<uint2*>(p) = make_uint2(
        bits(v.x) | (bits(v.y) << 16), bits(v.z) | (bits(v.w) << 16));
  }
  // tip_tpu's three roundings: the f32 sum, the add, the tanh
  static __device__ __forceinline__ float step(float in, float sum) {
    return rnd(tanhf(rnd(in + rnd(sum))));
  }
  static __device__ __forceinline__ float keep(float v) { return rnd(v); }
};

// BT batch rows a cluster; C = cols / 32 columns a thread (lane, lane + 32).
// kBack: in = g, hs = the hidden states, out = da; else in = xin, out = h.
// S: the storage of in, hs, w and out (f32 or bf16)
template <int BT, int C, bool kBack, class S>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
walk_kernel(const S* __restrict__ in, const S* __restrict__ hs,
            const S* __restrict__ w, S* __restrict__ out, int B, int T,
            int H) {
  using IO = Io<S>;
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
      S v = IO::from_f(0.0f);
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
  auto t_of = [&](int s) { return kBack ? T - 1 - s : s; };
  auto ld4 = [&](const S* p, int s) {
    return IO::load4(p + o_at + static_cast<size_t>(t_of(s)) * H);
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
          wv[c][j] = IO::to_f(Ws[(i + j) * cols + lane + 32 * c]);
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
      if (kBack) {   // da = (g + da_{t+1} W^T) (1 - h^2), as stored
        o = make_float4(IO::keep((iv.x + sm.x) * (1.0f - hv.x * hv.x)),
                        IO::keep((iv.y + sm.y) * (1.0f - hv.y * hv.y)),
                        IO::keep((iv.z + sm.z) * (1.0f - hv.z * hv.z)),
                        IO::keep((iv.w + sm.w) * (1.0f - hv.w * hv.w)));
      } else {
        o = make_float4(IO::step(iv.x, sm.x), IO::step(iv.y, sm.y),
                        IO::step(iv.z, sm.z), IO::step(iv.w, sm.w));
      }
      if (!live) o = zero;   // the padding past H stays 0
      if (live) IO::store4(out + o_at + static_cast<size_t>(t) * H, o);
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

template <int BT, int C, bool kBack, class S>
cudaError_t launch(const S* in, const S* hs, const S* w, S* out, int B,
                   int T, int H, int clusters, size_t smem, cudaStream_t st) {
  // the attribute once per process and kernel: kMaxSmem covers every plan
  static const cudaError_t attr = cudaFuncSetAttribute(
      walk_kernel<BT, C, kBack, S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  walk_kernel<BT, C, kBack, S><<<clusters * kCluster, kThreads, smem, st>>>(
      in, hs, w, out, B, T, H);
  return cudaGetLastError();
}

template <int C, bool kBack, class S>
cudaError_t launch_tile(int bt, const S* in, const S* hs, const S* w,
                        S* out, int B, int T, int H, int clusters,
                        size_t smem, cudaStream_t st) {
  switch (bt) {
    case 1: return launch<1, C, kBack, S>(in, hs, w, out, B, T, H, clusters,
                                          smem, st);
    case 2: return launch<2, C, kBack, S>(in, hs, w, out, B, T, H, clusters,
                                          smem, st);
    case 4: return launch<4, C, kBack, S>(in, hs, w, out, B, T, H, clusters,
                                          smem, st);
    case 8: return launch<8, C, kBack, S>(in, hs, w, out, B, T, H, clusters,
                                          smem, st);
    case 16: return launch<16, C, kBack, S>(in, hs, w, out, B, T, H,
                                            clusters, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

// A plan of ops/fused_rnn.py, checked: a cluster of 8 blocks of `cols`
// columns each (32 or 64, the 8 blocks covering H, a multiple of 4), `bt`
// batch rows a cluster (1, 2, 4, 8 or 16), `clusters` clusters that cover
// the B rows exactly, `smem` bytes of shared memory for W stored `w_bytes`
// bytes an entry.
inline bool walk_plan_ok(int B, int H, int cluster, int cols, int bt,
                         int clusters, long long smem, int w_bytes = 4) {
  return cluster == kCluster && (cols == 32 || cols == 64) &&
         cols * kCluster >= H && (cols == 32 || cols * kCluster / 2 < H) &&
         H % 4 == 0 && (bt == 1 || bt == 2 || bt == 4 || bt == 8 ||
                        bt == 16) &&
         clusters > 0 && static_cast<long long>(clusters) * bt >= B &&
         static_cast<long long>(clusters - 1) * bt < B &&
         smem == static_cast<long long>(smem_bytes(H, cols, bt, w_bytes)) &&
         smem <= kMaxSmem;
}

// one walk by a checked plan
template <bool kBack, class S = float>
cudaError_t walk(const S* in, const S* hs, const S* w, S* out, int B, int T,
                 int H, int cols, int bt, int clusters, long long smem,
                 cudaStream_t st) {
  const size_t sm = static_cast<size_t>(smem);
  return cols == 64
             ? launch_tile<2, kBack, S>(bt, in, hs, w, out, B, T, H,
                                        clusters, sm, st)
             : launch_tile<1, kBack, S>(bt, in, hs, w, out, B, T, H,
                                        clusters, sm, st);
}

}  // namespace rnnc
