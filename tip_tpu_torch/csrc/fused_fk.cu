// K6 fk_bullet_fused: forward kinematics of one pose, f32, one block a
// pose (B poses with a leading axis are one launch of B blocks).
//
// Replaces tip_tpu/ops/kinematics.py::fk_bullet_fused (Pallas kernel
// _fk_kernel): a (57,) bullet-ordered pose (root position, root axis-angle,
// 17 active joints' axis-angles) -> the (J+1, 7) CoM and joint frames of
// the skeleton. It is the FK part of K3 (csrc/fused_tail.cu) and shares
// its device code through tip_quat.cuh.
//
// What bounds it on the H100: neither bytes nor operations. It reads about
// 0.9 KB and does about two thousand flops; what is left is the launch and
// the dependent chain of the 19-joint tree walk in one thread.
//
// Design: one block of 32 threads. 18 threads decode axis-angle -> quat,
// thread 0 walks the tree (parents first), one thread per link builds the
// CoM and joint frames. The skeleton's tree arrives as int32 tables, so
// another skeleton of the same pose layout needs no rebuild.

#include <cuda_runtime.h>

#include "tip_quat.cuh"

namespace {

__global__ void fk_kernel(const float* __restrict__ pose,
                          const float* __restrict__ joff,
                          const float* __restrict__ coff,
                          const int* __restrict__ parent,
                          const int* __restrict__ is_fixed,
                          const int* __restrict__ slot, int J,
                          float* __restrict__ pq_com,
                          float* __restrict__ pq_jf) {
  __shared__ tipq::FkShared sh;
  const int b = blockIdx.x;       // this block's pose
  pose += 57 * b;
  pq_com += 7 * (J + 1) * b;
  pq_jf += 7 * (J + 1) * b;
  tipq::fk_block(pose, joff, coff, parent, is_fixed, slot, J, sh, pq_com,
                 pq_jf);
}

}  // namespace

extern "C" int fk_bullet_fused_launch(const void* pose, const void* joff,
                                      const void* coff, const void* parent,
                                      const void* is_fixed, const void* slot,
                                      int B, int J, void* pq_com,
                                      void* pq_jf, void* stream) {
  if (B < 1 || J < 0 || J + 1 > tipq::kMaxLinks) return -1;
  fk_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pose), static_cast<const float*>(joff),
      static_cast<const float*>(coff), static_cast<const int*>(parent),
      static_cast<const int*>(is_fixed), static_cast<const int*>(slot), J,
      static_cast<float*>(pq_com), static_cast<float*>(pq_jf));
  return static_cast<int>(cudaGetLastError());
}
