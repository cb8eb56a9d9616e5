// K2 decode_fused and K3 tail_fused: the streaming runner's per-frame
// decode (stages 4-5) and tail (stages 6-7), f32, one block a stream: a
// single stream is a grid of one block, a pool of B streams one launch of B
// blocks over inputs and outputs with a leading stream axis.
//
// Replaces tip_tpu/ops/fused_tail.py::decode_fused (Pallas kernel
// _decode_kernel) and tip_tpu/ops/fused_tail.py::tail_fused (Pallas kernel
// _tail_kernel). The quaternion and forward-kinematics device functions are
// in tip_quat.cuh, shared with csrc/fused_fk.cu (K6).
//
// What bounds them on the H100: neither bytes nor operations. K2 reads
// about 3.2 KB (the 6-frame output ring) and does a few thousand flops; K3
// reads about 1.1 KB and does a few thousand flops. At the card's rates
// both are well under a microsecond of work; what is left is the launch
// (an empty kernel's floor) and the dependent chain inside the kernel: one
// round trip of loads, then the arithmetic of one lane.
//
// Design: no block barrier and no shared memory on the path. Every load a
// thread needs is issued at its start, before any arithmetic. K2: thread t <
// 18 owns 6D row t (columns 6t..6t+5), thread 18 the columns between the 6D
// rows and the SBP rows (the root velocity), thread 19 + k SBP row k; each
// loads all its columns of the filter's rows at once (no load behind a
// branch), filters them in registers (the filter divides by sum(coeff),
// summed in registers from weights loaded once) and decodes them; the four
// cases of Shepperd's method share one square root and three divisions. A
// filter longer than kMaxFilter frames is summed in further chunks of
// kMaxFilter rows, each chunk's weights in registers and its loads issued
// together; every sum keeps the row order.
// K3: one warp a stream; lane l < 18 decodes pose quat l, lane l < J+1
// composes link l's chain from the FK plan (tip_quat.cuh), lanes 0-4 the
// SBP residues from the links' frames by shuffles, lane 0 the feet mean
// from lanes 0 and 1.
//
// The arithmetic follows the plain PyTorch versions (ops/fused_tail.py)
// and tip_tpu's kernels (see tip_quat.cuh for the codecs).

#include <cuda_runtime.h>

#include "tip_quat.cuh"

namespace {

using namespace tipq;

constexpr int kMaxFilter = 16;  // K2: filter rows a chunk
constexpr int kRowsAtOnce = 8;  // K2: filter rows loaded in one go
constexpr int kGapLane = 18;    // K2: the columns after the 6D rows
constexpr int kSbpLane0 = 19;   // K2: SBP row k's thread is kSbpLane0 + k

// the weights of filter rows r0 .. r0 + kMaxFilter - 1 (the last row's
// where they run past nf) into cw, the real ones added to csum in order
__device__ __forceinline__ void load_weights(const float* __restrict__ coeff,
                                             int r0, int nf,
                                             float (&cw)[kMaxFilter],
                                             float& csum) {
#pragma unroll
  for (int k = 0; k < kMaxFilter; ++k) {
    cw[k] = __ldg(coeff + min(r0 + k, nf - 1));
    if (r0 + k < nf) csum += cw[k];
  }
}

// acc[i] += cw[k] * row r0 + k of the filter at column col[i], for the rows
// below nf, in row order; the rows' loads go out kRowsAtOnce at a time
// (rows clamped to real ones, no load behind a branch)
__device__ __forceinline__ void filter_rows(const float* __restrict__ filt,
                                            int r0, int nf, int D,
                                            const int (&col)[6],
                                            const float (&cw)[kMaxFilter],
                                            float (&acc)[6]) {
#pragma unroll
  for (int k0 = 0; k0 < kMaxFilter; k0 += kRowsAtOnce) {
    if (r0 + k0 < nf) {
      float x[kRowsAtOnce][6];
#pragma unroll
      for (int j = 0; j < kRowsAtOnce; ++j)
#pragma unroll
        for (int i = 0; i < 6; ++i)
          x[j][i] = filt[min(r0 + k0 + j, nf - 1) * D + col[i]];
#pragma unroll
      for (int j = 0; j < kRowsAtOnce; ++j)
#pragma unroll
        for (int i = 0; i < 6; ++i)
          acc[i] = r0 + k0 + j < nf ? fmaf(cw[k0 + j], x[j][i], acc[i])
                                    : acc[i];
    }
  }
}

template <bool kClock>
__global__ void __launch_bounds__(128)
decode_kernel(const float* __restrict__ y_t, const float* __restrict__ filt,
              const float* __restrict__ coeff, int nf,
              const float* __restrict__ local9, int use_filter,
              const unsigned char* __restrict__ use_filter_b, int D,
              int n_sbps, int B, float* __restrict__ out,
              unsigned long long* __restrict__ clk) {
  CycleClock<kClock, 3> clock;
  clock.stamp(0);
  const int t = threadIdx.x;
  const int b = blockIdx.x;
  // the first chunk's weights, summed in order in registers
  float cw[kMaxFilter];
  float csum = 0.0f;
  load_weights(coeff, 0, nf, cw, csum);
  // this block's stream; use_filter_b holds one flag a stream (a pool's
  // streams switch to the filter at their own frames), else the flag is
  // use_filter for every stream
  y_t += static_cast<size_t>(b) * D;
  filt += static_cast<size_t>(b) * nf * D;
  float* y_f = out + static_cast<size_t>(b) * D;
  float* c_t = out + static_cast<size_t>(B) * D + 4 * n_sbps * b;
  float* q = out + static_cast<size_t>(B) * (D + 4 * n_sbps) + 4 * 18 * b;
  const bool on = use_filter_b != nullptr ? use_filter_b[b] != 0
                                          : use_filter != 0;

  // this thread's columns: a 6D row (6), the columns between the 6D rows
  // and the SBP rows (at most 6) or an SBP row (4); a thread with none
  // reads column 0 and writes nothing
  const int sbp0 = D - 4 * n_sbps;
  int c0 = 0, n = 0;
  if (t < 18) {
    c0 = 6 * t;
    n = 6;
  } else if (t == kGapLane) {
    c0 = 108;
    n = sbp0 - 108;
  } else if (t < kSbpLane0 + n_sbps) {
    c0 = sbp0 + 4 * (t - kSbpLane0);
    n = 4;
  }
  int col[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) col[i] = c0 + min(i, max(n - 1, 0));
  // thread 0's quat is the root IMU's matrix
  float m[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) m[i] = t == 0 ? local9[9 * b + i] : 0.0f;

  // every load unconditional (rows and columns clamped to real ones) and
  // issued before the sums: one round trip
  float v[6];
  if (on) {
    float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    filter_rows(filt, 0, nf, D, col, cw, acc);
    // a filter longer than a chunk: the next chunks, one after another
#pragma unroll 1
    for (int r0 = kMaxFilter; r0 < nf; r0 += kMaxFilter) {
      load_weights(coeff, r0, nf, cw, csum);
      filter_rows(filt, r0, nf, D, col, cw, acc);
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) v[i] = acc[i] / csum;
  } else {
#pragma unroll
    for (int i = 0; i < 6; ++i) v[i] = y_t[col[i]];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i)
    if (i < n) y_f[c0 + i] = v[i];
  if constexpr (kClock) {
    __syncthreads();
    clock.stamp(1);
  }

  if (t < 18) {
    if (t > 0) sixd_to_matrix(v, m);
    const Q r = matrix_to_q(m);
    q[4 * t + 0] = r.x;
    q[4 * t + 1] = r.y;
    q[4 * t + 2] = r.z;
    q[4 * t + 3] = r.w;
  } else if (t >= kSbpLane0 && n == 4) {
    const int k = t - kSbpLane0;
    c_t[4 * k + 0] = v[0] > 0.0f ? 1.0f : 0.0f;
    c_t[4 * k + 1] = v[1] / 5.0f;
    c_t[4 * k + 2] = v[2] / 5.0f;
    c_t[4 * k + 3] = v[3] / 5.0f;
  }
  if constexpr (kClock) {
    __syncthreads();
    clock.stamp(2);
    clock.write(clk);
  }
}

constexpr int kSbps = 5;
// pq row of SBP body k: [lankle, rankle, lwrist, rwrist, root]; row = link +
// 1 (in registers: a table in constant memory would cost a load before the
// loads that need it)
__device__ __forceinline__ int sbp_row(int k) {
  return k == 0 ? 3 : k == 1 ? 6 : k == 2 ? 15 : k == 3 ? 19 : 0;
}

// K3's outputs, one allocation: (B, L, 7) pq_com, (B, L, 7) pq_jf, (B, 108)
// hist, (B, 3) vres, (B, 5, 3) clocs, (B, 5, 3) rres, (B, 5) act
template <bool kClock, bool kDeep>
__global__ void __launch_bounds__(32)
tail_kernel(const float* __restrict__ s, const float* __restrict__ ct,
            const float* __restrict__ prev_pq,
            const float4* __restrict__ plan, int J, float dt, int B,
            float* __restrict__ out, unsigned long long* __restrict__ clk) {
  CycleClock<kClock, 7> clock;
  clock.stamp(0);
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int L = J + 1;
  Plan pl;
  pl.load(plan);
  s += 114 * b;
  ct += 4 * kSbps * b;
  prev_pq += 7 * L * b;
  float* pq_com = out + 7 * L * b;
  float* pq_jf = out + 7 * L * (B + b);
  float* hist = out + 14 * L * B + 108 * b;
  float* vres = out + (14 * L + 108) * B + 3 * b;
  float* clocs = out + (14 * L + 111) * B + 3 * kSbps * b;
  float* rres = out + (14 * L + 126) * B + 3 * kSbps * b;
  float* act = out + (14 * L + 141) * B + kSbps * b;

  // every per-frame load, issued before any arithmetic. s[0:57] has the
  // layout of a pose: root xyz, root axis-angle, 17 joint axis-angles (in
  // nimble order, which the plan's quat indices follow)
  const V root_p = load_v(s);
  const int row = sbp_row(lane < kSbps ? lane : 0);
  const V aa = lane < kPoseQuats ? load_v(s + 3 + 3 * lane) : V{0, 0, 0};
  const float4 c4 = lane < kSbps ? make_float4(ct[4 * lane], ct[4 * lane + 1],
                                               ct[4 * lane + 2],
                                               ct[4 * lane + 3])
                                 : float4{0, 0, 0, 0};
  const float* prev = prev_pq + 7 * row;
  const V x1 = load_v(prev);
  const Q q1 = load_q(prev + 3);

  const Q qn = aa_to_q(aa);
  settle<kClock>(qn.w);
  clock.stamp(1);

  const Link f = fk_walk<kDeep>(pl, root_p, qn);
  settle<kClock>(f.c.x + f.q.w);
  clock.stamp(2);

  store_link(f, L, pq_com, pq_jf);
  clock.stamp(3);

  // 6D history re-encode from the decoded quats
  if (lane < kPoseQuats) {
    const float n = fmaxf(qnorm(qn), 1e-12f);
    const float x = qn.x / n, y = qn.y / n, z = qn.z / n, w = qn.w / n;
    float* h = hist + 6 * lane;
    h[0] = 1.0f - 2.0f * (y * y + z * z);
    h[1] = 2.0f * (x * y - w * z);
    h[2] = 2.0f * (x * y + w * z);
    h[3] = 1.0f - 2.0f * (x * x + z * z);
    h[4] = 2.0f * (x * z - w * y);
    h[5] = 2.0f * (y * z + w * x);
  }
  settle<kClock>(0.0f);
  clock.stamp(4);

  // per-SBP velocity residues, lanes 0-4, the links' frames by shuffles
  const V x2 = shfl_v(f.c, row);
  const Q q2 = shfl_q(f.q, row);
  const bool flag = c4.x > 0.0f;
  const V offs{c4.y, c4.z, c4.w};
  const V vel = vscale(vsub(x2, x1), 1.0f / dt);
  // angular velocity: sub = q2 - q1 or q2 + q1, the smaller in norm
  const Q dm{q2.x - q1.x, q2.y - q1.y, q2.z - q1.z, q2.w - q1.w};
  const Q dp{q2.x + q1.x, q2.y + q1.y, q2.z + q1.z, q2.w + q1.w};
  const Q sub = qnorm(dm) < qnorm(dp) ? dm : dp;
  const Q dori = qmul(sub, Q{-q2.x, -q2.y, -q2.z, q2.w});
  const V w{2.0f * dori.x / dt, 2.0f * dori.y / dt, 2.0f * dori.z / dt};
  const V r = vadd(vcross(w, offs), vel);
  const float fl = flag ? 1.0f : 0.0f;
  if (lane < kSbps) {
    const float nan = __int_as_float(0x7fc00000);
    float* cl = clocs + 3 * lane;
    float* rr = rres + 3 * lane;
    cl[0] = flag ? x2.x + offs.x : 100.0f;
    cl[1] = flag ? x2.y + offs.y : 100.0f;
    cl[2] = flag ? x2.z + offs.z : 100.0f;
    rr[0] = flag ? r.x : nan;
    rr[1] = flag ? r.y : nan;
    rr[2] = flag ? r.z : nan;
    act[lane] = fl;
  }
  settle<kClock>(r.x);
  clock.stamp(5);

  // clipped mean over the active feet (lanes 0 and 1; 0 when none is
  // active)
  const V r1 = shfl_v(r, 1);
  const float fl1 = __shfl_sync(kFull, fl, 1);
  if (lane == 0) {
    const float n = fmaxf(fl + fl1, 1.0f);
    const V sum = vadd(vscale(r, fl), vscale(r1, fl1));
    vres[0] = fminf(fmaxf(sum.x / n, -0.5f), 0.5f);
    vres[1] = fminf(fmaxf(sum.y / n, -0.5f), 0.5f);
    vres[2] = fminf(fmaxf(sum.z / n, -0.5f), 0.5f);
  }
  settle<kClock>(0.0f);
  clock.stamp(6);
  clock.write(clk);
}

// The launch floor: B blocks of 32 threads that write one float a block.
__global__ void floor_kernel(float* __restrict__ out) {
  if (threadIdx.x == 0) out[blockIdx.x] = 1.0f;
}

// One thread: the step of %globaltimer (the smallest change seen over
// `reads` reads in a tight loop, and how many changes there were), then
// the SM's cycles against %globaltimer's ns over a spin of `spin` cycles.
__global__ void timer_probe_kernel(int reads, long long spin,
                                   unsigned long long* __restrict__ out) {
  unsigned long long prev, t, step = ~0ull, changes = 0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(prev));
  for (int i = 0; i < reads; ++i) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (t != prev) {
      step = t - prev < step ? t - prev : step;
      ++changes;
      prev = t;
    }
  }
  unsigned long long g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  const long long c0 = clock64();
  long long c1 = c0;
  while (c1 - c0 < spin) c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  out[0] = step;
  out[1] = changes;
  out[2] = g1 - g0;
  out[3] = static_cast<unsigned long long>(c1 - c0);
}

}  // namespace

// B streams: y_t (B, D), filt (B, nf, D), local9 (B, 9) -> out: y_f (B,
// D), then c_t (B, n_sbps, 4), then q (B, 18, 4). use_filter_b: (B,)
// bytes, one flag a stream, or null for use_filter on every stream. clock:
// null, or 3 u64 (the per-phase clock: start, filter, decode).
extern "C" int decode_fused_launch(const void* y_t, const void* filt,
                                   const void* coeff, int nf,
                                   const void* local9, int use_filter,
                                   const void* use_filter_b, int B, int D,
                                   int n_sbps, void* out, void* clock,
                                   void* stream) {
  if (B < 1 || nf < 1 || n_sbps < 1
      || kSbpLane0 + n_sbps > 128 || D < 108 + 4 * n_sbps
      || D > 114 + 4 * n_sbps)
    return -1;
  const int threads = 32 * ((kSbpLane0 + n_sbps + 31) / 32);
  auto kernel = clock != nullptr ? decode_kernel<true> : decode_kernel<false>;
  kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y_t), static_cast<const float*>(filt),
      static_cast<const float*>(coeff), nf, static_cast<const float*>(local9),
      use_filter, static_cast<const unsigned char*>(use_filter_b), D, n_sbps,
      B, static_cast<float*>(out), static_cast<unsigned long long*>(clock));
  return static_cast<int>(cudaGetLastError());
}

// B streams: s (B, 114), ct (B, 20), prev_pq (B, J+1, 7) -> out (K3's
// outputs, above); plan: the skeleton's FK plan (tip_quat.cuh); deep: it
// has a chain deeper than kMaxDepth. clock: null, or 7 u64 (start, then
// K3_PHASES of ops/fused_tail.py).
extern "C" int tail_fused_launch(const void* s, const void* ct,
                                 const void* prev_pq, const void* plan, int B,
                                 int J, int deep, float dt, void* out,
                                 void* clock, void* stream) {
  if (B < 1 || J + 1 != 20) return -1;
  auto kernel = clock != nullptr
                    ? (deep ? tail_kernel<true, true> : tail_kernel<true, false>)
                    : (deep ? tail_kernel<false, true>
                            : tail_kernel<false, false>);
  kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<const float*>(ct),
      static_cast<const float*>(prev_pq), static_cast<const float4*>(plan), J,
      dt, B, static_cast<float*>(out),
      static_cast<unsigned long long*>(clock));
  return static_cast<int>(cudaGetLastError());
}

// The launch floor: an empty kernel of B blocks of 32 threads (each writes
// out[b]), timed beside K2, K3 and K6.
extern "C" int tail_floor_launch(int B, void* out, void* stream) {
  if (B < 1) return -1;
  floor_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out: 4 u64 (see timer_probe_kernel).
extern "C" int timer_probe_launch(int reads, long long spin, void* out,
                                  void* stream) {
  timer_probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      reads, spin, static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
