// K1: fused tanh-RNN over time, f32.
//
// Replaces tip_tpu/ops/pallas_kernels.py::fused_rnn (Pallas kernel
// _rnn_kernel): h_t = tanh(xin_t + h_{t-1} W_hh), h_{-1} = 0, for
// xin (B, T, H) with both biases already folded in and W_hh (H, H) stored
// row-major as (in, out).
//
// What bounds it on the H100: not bytes (W_hh once, xin and the output
// once: 1.2 MB at B 1, T 40, H 512, a third of a microsecond) and not
// operations (21 MFLOP at B 1), but latency: 40 dependent steps, each a
// (B, H) x (H, H) product that needs the whole h_{t-1}. A design that
// reads W_hh from L2 in every step pays 1 MB through one SM per step at
// B 1 (the first version of this kernel, 23 us a step).
//
// Design: W_hh stays on chip for the whole launch, spread over a thread
// block cluster of 8 blocks (the portable cluster size). Block r holds
// columns [r H/8, (r+1) H/8) of W_hh in its shared memory (128 KB at
// H 512), loaded once with cp.async. A cluster owns a tile of up to 16
// batch rows; every block keeps the tile's whole h in two buffers. In a
// step each block computes its columns of h_t for the tile: warp k takes
// rows [k H/8, (k+1) H/8) of the slice, a lane two columns (so that each
// h value is read from shared memory once a block), and the 8 partial sums
// are added in a fixed order. Then a thread per 4 outputs applies tanh to
// the inputs it loaded a step ahead, writes them to global memory and,
// through distributed shared memory, into the next-h buffer of every block
// of the cluster, and the cluster waits on one barrier. The buffers
// alternate, so that one barrier a step is enough: nothing reads W_hh from
// L2 or HBM after the first load. The launch plan (cluster, columns a
// block, batch tile, clusters, shared bytes) comes from
// ops/fused_rnn.py::fused_rnn_plan and is checked here.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;
constexpr int kThreads = 256;
constexpr int kSplits = kThreads / 32;   // a warp per slice of W_hh's rows
constexpr int kMaxSmem = 232448;         // dynamic shared memory of a block

// BT batch rows a cluster; C = cols / 32 columns a thread (lane, lane + 32)
template <int BT, int C>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
fused_rnn_cluster(const float* __restrict__ xin, const float* __restrict__ w,
                  float* __restrict__ out, int B, int T, int H) {
  constexpr int cols = 32 * C;
  constexpr int quads = BT * cols / 4;   // float4 outputs of a block a step
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b0 = (blockIdx.x / kCluster) * BT;
  const int col0 = rank * cols;
  const int klen = H / kSplits;
  const int tid = threadIdx.x, lane = tid % 32, ks = tid / 32;

  extern __shared__ float4 sh4[];
  float* Ws = reinterpret_cast<float*>(sh4);          // (H, cols)
  float* hbuf = Ws + static_cast<size_t>(H) * cols;   // 2 x (BT, H)
  float* red = hbuf + 2 * BT * H;                     // (kSplits, BT, cols)

  // W_hh's column slice, once, 16 bytes a copy
  for (int e = tid; e < H * (cols / 4); e += kThreads) {
    const int i = e / (cols / 4), q = e % (cols / 4);
    const float* src = w + static_cast<size_t>(i) * H + col0 + 4 * q;
    const unsigned dst = static_cast<unsigned>(
        __cvta_generic_to_shared(Ws + i * cols + 4 * q));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int e = tid; e < BT * H; e += kThreads) hbuf[e] = 0.0f;   // h_{-1}

  // the thread's float4 of outputs (row ob, columns oc..oc+3) and its
  // inputs, loaded a step ahead
  const bool owner = tid < quads;
  const int ob = tid / (cols / 4), oc = 4 * (tid % (cols / 4));
  const int orow = b0 + ob;
  const bool live = owner && orow < B;
  const float* x_o = xin + static_cast<size_t>(orow) * T * H + col0 + oc;
  float4 x_next = live ? *reinterpret_cast<const float4*>(x_o)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  cluster.sync();   // every block runs before any block writes into it

  for (int t = 0; t < T; ++t) {
    const float* hc = hbuf + (t & 1) * BT * H;
    float* hn = hbuf + ((t + 1) & 1) * BT * H;
    const float4 xv = x_next;
    if (live && t + 1 < T)
      x_next = *reinterpret_cast<const float4*>(x_o + (t + 1) * H);
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
        const float4 h = *reinterpret_cast<const float4*>(hc + b * H + i);
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
      float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int k = 0; k < kSplits; ++k) {   // in order: the same bits
        const float4 r =
            *reinterpret_cast<const float4*>(red + (k * BT + ob) * cols + oc);
        s.x += r.x;
        s.y += r.y;
        s.z += r.z;
        s.w += r.w;
      }
      const float4 h = make_float4(tanhf(xv.x + s.x), tanhf(xv.y + s.y),
                                   tanhf(xv.z + s.z), tanhf(xv.w + s.w));
      if (live)
        *reinterpret_cast<float4*>(out + (static_cast<size_t>(orow) * T + t) *
                                             H + col0 + oc) = h;
      float4* dst = reinterpret_cast<float4*>(hn + ob * H + col0 + oc);
#pragma unroll
      for (int r = 0; r < kCluster; ++r) *cluster.map_shared_rank(dst, r) = h;
    }
    // h_t is in every block; everyone is done with h_{t-1} and `red`
    cluster.sync();
  }
}

inline size_t smem_bytes(int H, int cols, int bt) {
  return sizeof(float) * (static_cast<size_t>(H) * cols +
                          2 * static_cast<size_t>(bt) * H +
                          static_cast<size_t>(kSplits) * bt * cols);
}

template <int BT, int C>
cudaError_t launch(const float* xin, const float* w, float* out, int B, int T,
                   int H, int clusters, size_t smem, cudaStream_t st) {
  // the attribute once per process and kernel: kMaxSmem covers every plan
  static const cudaError_t attr = cudaFuncSetAttribute(
      fused_rnn_cluster<BT, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (attr != cudaSuccess) return attr;
  fused_rnn_cluster<BT, C><<<clusters * kCluster, kThreads, smem, st>>>(
      xin, w, out, B, T, H);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_tile(int bt, const float* xin, const float* w, float* out,
                        int B, int T, int H, int clusters, size_t smem,
                        cudaStream_t st) {
  switch (bt) {
    case 1: return launch<1, C>(xin, w, out, B, T, H, clusters, smem, st);
    case 2: return launch<2, C>(xin, w, out, B, T, H, clusters, smem, st);
    case 4: return launch<4, C>(xin, w, out, B, T, H, clusters, smem, st);
    case 8: return launch<8, C>(xin, w, out, B, T, H, clusters, smem, st);
    case 16: return launch<16, C>(xin, w, out, B, T, H, clusters, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The plan of ops/fused_rnn.py::fused_rnn_plan, checked: a cluster of 8
// blocks of `cols` columns each (cols * 8 = H, cols 32 or 64), `bt` batch
// rows a cluster (1, 2, 4, 8 or 16), `clusters` clusters that cover the B
// rows exactly, `smem` bytes of shared memory.
extern "C" int fused_rnn_launch(const void* xin, const void* w_hh, void* out,
                                int B, int T, int H, int cluster, int cols,
                                int bt, int clusters, long long smem,
                                void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  const bool ok =
      cluster == kCluster && (cols == 32 || cols == 64) &&
      cols * kCluster == H && H % (4 * kSplits) == 0 && clusters > 0 &&
      static_cast<long long>(clusters) * bt >= B &&
      static_cast<long long>(clusters - 1) * bt < B &&
      smem == static_cast<long long>(smem_bytes(H, cols, bt)) &&
      smem <= kMaxSmem;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const float* x = static_cast<const float*>(xin);
  const float* wf = static_cast<const float*>(w_hh);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  return static_cast<int>(
      cols == 64 ? launch_tile<2>(bt, x, wf, o, B, T, H, clusters, sm, st)
                 : launch_tile<1>(bt, x, wf, o, B, T, H, clusters, sm, st));
}
