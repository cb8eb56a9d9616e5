// K6 fk_bullet_fused: forward kinematics of one pose, f32, one warp a pose
// (B poses with a leading axis are one launch of B blocks).
//
// Replaces tip_tpu/ops/kinematics.py::fk_bullet_fused (Pallas kernel
// _fk_kernel): a (57,) bullet-ordered pose (root position, root axis-angle,
// 17 active joints' axis-angles) -> the (J+1, 7) CoM and joint frames of
// the skeleton. It is the FK part of K3 (csrc/fused_tail.cu) and shares
// its device code through tip_quat.cuh.
//
// What bounds it on the H100: neither bytes nor operations. It reads about
// 0.9 KB and does about two thousand flops; what is left is the launch and
// one round trip of loads before a chain of at most kMaxDepth steps (a
// deeper chain's further passes read their rows then).
//
// Design: one block of 32 threads, no barrier and no shared memory. Lanes
// 0-17 decode axis-angle -> quat; lane l composes link l's chain from the
// skeleton's FK plan (a table built once on the host, loaded before the
// pose) and writes its CoM and joint frames. Another skeleton of the same
// pose layout needs no rebuild.

#include <cuda_runtime.h>

#include "tip_quat.cuh"

namespace {

using namespace tipq;

// out: (B, L, 7) CoM frames, then (B, L, 7) joint frames
template <bool kClock, bool kDeep>
__global__ void __launch_bounds__(32)
fk_kernel(const float* __restrict__ pose, const float4* __restrict__ plan,
          int J, int B, float* __restrict__ out,
          unsigned long long* __restrict__ clk) {
  CycleClock<kClock, 4> clock;
  clock.stamp(0);
  const int lane = threadIdx.x;
  const int b = blockIdx.x;       // this block's pose
  const int L = J + 1;
  Plan pl;
  pl.load(plan);
  pose += 57 * b;
  const V root_p = load_v(pose);
  const V aa = lane < kPoseQuats ? load_v(pose + 3 + 3 * lane) : V{0, 0, 0};
  const Q qn = aa_to_q(aa);
  settle<kClock>(qn.w);
  clock.stamp(1);
  const Link f = fk_walk<kDeep>(pl, root_p, qn);
  settle<kClock>(f.c.x + f.q.w);
  clock.stamp(2);
  store_link(f, L, out + 7 * L * b, out + 7 * L * (B + b));
  settle<kClock>(0.0f);
  clock.stamp(3);
  clock.write(clk);
}

}  // namespace

// B poses (B, 57) -> out: (B, J+1, 7) CoM frames, then (B, J+1, 7) joint
// frames; plan: the skeleton's FK plan (tip_quat.cuh) for the bullet pose
// order; deep: it has a chain deeper than kMaxDepth. clock: null, or 4 u64
// (start, then K6_PHASES of ops/kinematics.py).
extern "C" int fk_bullet_fused_launch(const void* pose, const void* plan,
                                      int B, int J, int deep, void* out,
                                      void* clock, void* stream) {
  if (B < 1 || J < 0 || J + 1 > kMaxLinks) return -1;
  auto kernel = clock != nullptr
                    ? (deep ? fk_kernel<true, true> : fk_kernel<true, false>)
                    : (deep ? fk_kernel<false, true> : fk_kernel<false, false>);
  kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pose), static_cast<const float4*>(plan), J, B,
      static_cast<float*>(out), static_cast<unsigned long long*>(clock));
  return static_cast<int>(cudaGetLastError());
}
