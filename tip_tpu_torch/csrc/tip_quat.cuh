// Quaternion (xyzw) and forward-kinematics device functions shared by
// csrc/fused_tail.cu (K2, K3) and csrc/fused_fk.cu (K6), f32.
//
// The arithmetic follows the plain PyTorch versions (ops/rotations.py,
// ops/kinematics.py): the axis-angle decode clamps the squared norm at
// 1e-24 and switches to the series 0.5 - angle^2/48 below 1e-6; the
// Shepperd matrix -> quat picks the first of equal maxima and signs w == 0
// as +1; the 6D decode normalises with +1e-6 in the denominator; cos is the
// plain cosf; a fixed joint inherits its parent's quaternion.

#pragma once

#include <cuda_runtime.h>

namespace tipq {

struct Q { float x, y, z, w; };
struct V { float x, y, z; };

__device__ __forceinline__ V vcross(V a, V b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V vadd(V a, V b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V vsub(V a, V b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V vscale(V a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ float vnorm(V a) { return sqrtf(a.x * a.x + a.y * a.y + a.z * a.z); }
__device__ __forceinline__ float qnorm(Q q) {
  return sqrtf(q.x * q.x + q.y * q.y + q.z * q.z + q.w * q.w);
}
__device__ __forceinline__ Q load_q(const float* p) { return {p[0], p[1], p[2], p[3]}; }
__device__ __forceinline__ V load_v(const float* p) { return {p[0], p[1], p[2]}; }

__device__ __forceinline__ Q qmul(Q a, Q b) {
  V v1{a.x, a.y, a.z}, v2{b.x, b.y, b.z};
  const float w = a.w * b.w - (v1.x * v2.x + v1.y * v2.y + v1.z * v2.z);
  V c = vcross(v1, v2);
  return {a.w * v2.x + b.w * v1.x + c.x, a.w * v2.y + b.w * v1.y + c.y,
          a.w * v2.z + b.w * v1.z + c.z, w};
}

__device__ __forceinline__ V qrot(Q q, V v) {
  V qv{q.x, q.y, q.z};
  V t = vscale(vcross(qv, v), 2.0f);
  V c = vcross(qv, t);
  return {v.x + q.w * t.x + c.x, v.y + q.w * t.y + c.y, v.z + q.w * t.z + c.z};
}

__device__ __forceinline__ Q aa_to_q(V aa) {
  const float a2 = aa.x * aa.x + aa.y * aa.y + aa.z * aa.z;
  const float angle = sqrtf(fmaxf(a2, 1e-24f));
  const float half = 0.5f * angle;
  const float k = angle < 1e-6f ? 0.5f - angle * angle / 48.0f
                                : sinf(half) / angle;
  return {aa.x * k, aa.y * k, aa.z * k, cosf(half)};
}

// m is row-major: m[3 * r + c]
__device__ inline Q matrix_to_q(const float* m) {
  const float m00 = m[0], m01 = m[1], m02 = m[2];
  const float m10 = m[3], m11 = m[4], m12 = m[5];
  const float m20 = m[6], m21 = m[7], m22 = m[8];
  const float tw = 1.0f + m00 + m11 + m22;
  const float tx = 1.0f + m00 - m11 - m22;
  const float ty = 1.0f - m00 + m11 - m22;
  const float tz = 1.0f - m00 - m11 + m22;
  const bool is_w = (tw >= tx) && (tw >= ty) && (tw >= tz);
  const bool is_x = !is_w && (tx >= ty) && (tx >= tz);
  const bool is_y = !is_w && !is_x && (ty >= tz);
  Q q;
  if (is_w) {
    const float h = sqrtf(fmaxf(tw, 1e-12f)) / 2.0f;
    q = {(m21 - m12) / (4 * h), (m02 - m20) / (4 * h), (m10 - m01) / (4 * h), h};
  } else if (is_x) {
    const float h = sqrtf(fmaxf(tx, 1e-12f)) / 2.0f;
    q = {h, (m01 + m10) / (4 * h), (m02 + m20) / (4 * h), (m21 - m12) / (4 * h)};
  } else if (is_y) {
    const float h = sqrtf(fmaxf(ty, 1e-12f)) / 2.0f;
    q = {(m01 + m10) / (4 * h), h, (m12 + m21) / (4 * h), (m02 - m20) / (4 * h)};
  } else {
    const float h = sqrtf(fmaxf(tz, 1e-12f)) / 2.0f;
    q = {(m02 + m20) / (4 * h), (m12 + m21) / (4 * h), h, (m10 - m01) / (4 * h)};
  }
  const float n = fmaxf(qnorm(q), 1e-12f);
  q = {q.x / n, q.y / n, q.z / n, q.w / n};
  const float sgn = q.w < 0.0f ? -1.0f : 1.0f;  // w == 0 -> +1
  return {q.x * sgn, q.y * sgn, q.z * sgn, q.w * sgn};
}

// 6D row [r00, r01, r10, r11, r20, r21] -> quat
__device__ inline Q sixd_to_q(const float* s) {
  V a1{s[0], s[2], s[4]}, a2{s[1], s[3], s[5]};
  a1 = vscale(a1, 1.0f / (vnorm(a1) + 1e-6f));
  a2 = vscale(a2, 1.0f / (vnorm(a2) + 1e-6f));
  V a3 = vcross(a1, a2);
  const float m[9] = {a1.x, a2.x, a3.x, a1.y, a2.y, a3.y, a1.z, a2.z, a3.z};
  return matrix_to_q(m);
}

// ---------------------------------------------------------------------------
// forward kinematics of one pose by one block
// ---------------------------------------------------------------------------

constexpr int kMaxLinks = 32;   // links of a skeleton, root included
constexpr int kPoseQuats = 18;  // root + 17 spherical joints in a pose

struct FkShared {
  Q qn[kPoseQuats];   // decoded pose[3:57]: root, then 17 joint slots
  Q qa[kMaxLinks];    // world link quats
  V pj[kMaxLinks];    // joint-frame positions
  V pc[kMaxLinks];    // CoM-frame positions
};

// pose: root xyz, root axis-angle, 17 joint axis-angles (57 floats).
// slot[j]: which of the 17 decoded joint quats is joint j's local rotation
// (unused where is_fixed[j]). Parents come before their children. Writes
// the (J+1, 7) CoM and joint frames and leaves the decoded quats, world
// quats and positions in sh. Every thread of a block of at least
// max(kPoseQuats, J+1) threads calls it; it ends in a barrier.
__device__ inline void fk_block(const float* __restrict__ pose,
                                const float* __restrict__ joff,
                                const float* __restrict__ coff,
                                const int* __restrict__ parent,
                                const int* __restrict__ is_fixed,
                                const int* __restrict__ slot, int J,
                                FkShared& sh, float* __restrict__ pq_com,
                                float* __restrict__ pq_jf) {
  const int tid = threadIdx.x;
  if (tid < kPoseQuats) sh.qn[tid] = aa_to_q(load_v(pose + 3 + 3 * tid));
  __syncthreads();

  // tree walk, parents first
  if (tid == 0) {
    sh.qa[0] = sh.qn[0];
    sh.pj[0] = load_v(pose);
    for (int j = 0; j < J; ++j) {
      const int ps = parent[j] + 1;
      sh.pj[j + 1] = vadd(sh.pj[ps], qrot(sh.qa[ps], load_v(joff + 3 * j)));
      sh.qa[j + 1] = is_fixed[j] ? sh.qa[ps]
                                 : qmul(sh.qa[ps], sh.qn[1 + slot[j]]);
    }
  }
  __syncthreads();

  // CoM and joint frames per link
  if (tid < J + 1) {
    const Q q = sh.qa[tid];
    const V p = sh.pj[tid];
    const V c = vadd(p, qrot(q, load_v(coff + 3 * tid)));
    sh.pc[tid] = c;
    float* jf = pq_jf + 7 * tid;
    float* cm = pq_com + 7 * tid;
    jf[0] = p.x; jf[1] = p.y; jf[2] = p.z;
    cm[0] = c.x; cm[1] = c.y; cm[2] = c.z;
    jf[3] = cm[3] = q.x;
    jf[4] = cm[4] = q.y;
    jf[5] = cm[5] = q.z;
    jf[6] = cm[6] = q.w;
  }
  __syncthreads();
}

}  // namespace tipq
