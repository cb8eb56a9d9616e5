// Quaternion (xyzw) and forward-kinematics device functions shared by
// csrc/fused_tail.cu (K2, K3) and csrc/fused_fk.cu (K6), f32, with their
// per-phase clock.
//
// The arithmetic follows the plain PyTorch versions (ops/rotations.py,
// ops/kinematics.py): the axis-angle decode clamps the squared norm at
// 1e-24 and switches to the series 0.5 - angle^2/48 below 1e-6; the
// Shepperd matrix -> quat picks the first of equal maxima and signs w == 0
// as +1; the 6D decode normalises with +1e-6 in the denominator; cos is the
// plain cosf; a fixed joint inherits its parent's quaternion.
//
// Forward kinematics is one warp a pose and walks no tree serially: lane l
// owns link l and composes the chain of joints from the root down to it
// from the skeleton's FK plan (ops/kinematics.py::fk_plan_table), with no
// barrier; each step's joint rotation comes by a shuffle from the lane that
// decoded it. A pass composes kMaxDepth steps from registers loaded at the
// start; a deeper chain goes on from the frame the pass reached in further
// passes of kMaxDepth steps, which every lane of the warp takes part in.

#pragma once

#include <cuda_runtime.h>

namespace tipq {

constexpr int kMaxLinks = 32;   // links of a skeleton, root included: a warp
constexpr int kPoseQuats = 18;  // root + 17 spherical joints in a pose
constexpr int kMaxDepth = 8;    // chain joints a pass composes
constexpr int kPlanRows = kMaxLinks;  // row 0 + a chain of kMaxLinks - 1
constexpr unsigned kFull = 0xffffffffu;

// The per-phase clock of K2, K3 and K6, compiled in only where kOn (the
// kernels' clocked instantiation): thread 0 of block 0 reads the SM's cycle
// counter (clock64, local to the SM and fine for a kernel of one block a
// stream) at the start and after each phase, once the phase's results are
// settled, and writes the kRows stamps to clk at the end.
template <bool kOn, int kRows>
struct CycleClock {
  unsigned long long t[kRows];
  __device__ __forceinline__ void stamp(int i) {
    if constexpr (kOn) t[i] = clock64();
  }
  __device__ __forceinline__ void write(unsigned long long* clk) const {
    if constexpr (kOn) {
      if (clk != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
#pragma unroll
        for (int i = 0; i < kRows; ++i) clk[i] = t[i];
      }
    }
  }
};

// In a clocked launch only: wait until every lane's v is computed (a store
// needs its value), then let the warp meet, so that the next stamp closes
// the phase.
template <bool kOn>
__device__ __forceinline__ void settle(float v) {
  if constexpr (kOn) {
    __shared__ float sink[32];
    sink[threadIdx.x & 31] = v;
    __syncwarp();
  }
}

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
__device__ __forceinline__ V xyz(float4 e) { return {e.x, e.y, e.z}; }

// lane src's q / v, every lane of the warp taking part
__device__ __forceinline__ Q shfl_q(Q q, int src) {
  return {__shfl_sync(kFull, q.x, src), __shfl_sync(kFull, q.y, src),
          __shfl_sync(kFull, q.z, src), __shfl_sync(kFull, q.w, src)};
}
__device__ __forceinline__ V shfl_v(V v, int src) {
  return {__shfl_sync(kFull, v.x, src), __shfl_sync(kFull, v.y, src),
          __shfl_sync(kFull, v.z, src)};
}

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

// m is row-major: m[3 * r + c]. Shepperd's four cases share one square
// root and three divisions: the case picks the trace term, the three
// numerators and the place of h, so a warp whose lanes take different
// cases does not run them one after another. Each case's values are those
// of its own formula.
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
  const float a = m21 - m12, b = m02 - m20, c = m10 - m01;
  const float d = m01 + m10, e = m02 + m20, f = m12 + m21;
  // w: (a, b, c, h); x: (h, d, e, a); y: (d, h, f, b); z: (e, f, h, c)
  const float t = is_w ? tw : is_x ? tx : is_y ? ty : tz;
  const float u0 = is_w ? a : is_x ? d : is_y ? d : e;
  const float u1 = is_w ? b : is_x ? e : f;
  const float u2 = is_w ? c : is_x ? a : is_y ? b : c;
  const float h = sqrtf(fmaxf(t, 1e-12f)) / 2.0f;
  const float r0 = u0 / (4 * h), r1 = u1 / (4 * h), r2 = u2 / (4 * h);
  Q q;
  if (is_w) q = {r0, r1, r2, h};
  else if (is_x) q = {h, r0, r1, r2};
  else if (is_y) q = {r0, h, r1, r2};
  else q = {r0, r1, h, r2};
  const float n = fmaxf(qnorm(q), 1e-12f);
  q = {q.x / n, q.y / n, q.z / n, q.w / n};
  const float sgn = q.w < 0.0f ? -1.0f : 1.0f;  // w == 0 -> +1
  return {q.x * sgn, q.y * sgn, q.z * sgn, q.w * sgn};
}

// 6D row [r00, r01, r10, r11, r20, r21] -> row-major rotation matrix m
__device__ inline void sixd_to_matrix(const float* s, float* m) {
  V a1{s[0], s[2], s[4]}, a2{s[1], s[3], s[5]};
  a1 = vscale(a1, 1.0f / (vnorm(a1) + 1e-6f));
  a2 = vscale(a2, 1.0f / (vnorm(a2) + 1e-6f));
  const V a3 = vcross(a1, a2);
  m[0] = a1.x; m[1] = a2.x; m[2] = a3.x;
  m[3] = a1.y; m[4] = a2.y; m[5] = a3.y;
  m[6] = a1.z; m[7] = a2.z; m[8] = a3.z;
}

// ---------------------------------------------------------------------------
// forward kinematics of one pose by one warp
// ---------------------------------------------------------------------------

// The FK plan of a skeleton (ops/kinematics.py::fk_plan_table): float4
// entries [kPlanRows][kMaxLinks], lane l reading column l. Row 0: link l's
// CoM offset and, as int bits, its depth (joints on the chain from the
// root, 0 for the root link). Row k = 1..depth: the k-th joint of the chain
// from the root, its joint offset and, as int bits, the
// index of its rotation among the pose's 18 decoded quats (-1: a fixed
// joint). Entries past a chain, and links past the skeleton's, are zero.
// Rows 0..kMaxDepth are loaded at the start; a deeper chain's further rows
// are read by the pass that composes them.
struct Plan {
  float4 e[kMaxDepth + 1];
  const float4* col;  // this lane's column
  __device__ __forceinline__ void load(const float4* __restrict__ plan) {
    col = plan + (threadIdx.x & 31);
#pragma unroll
    for (int k = 0; k <= kMaxDepth; ++k) e[k] = __ldg(col + k * kMaxLinks);
  }
  __device__ __forceinline__ int depth() const {
    return __float_as_int(e[0].w);
  }
};

struct Link {
  V p;  // joint-frame position
  Q q;  // world quat
  V c;  // CoM-frame position
};

// Every lane of the warp calls it: root_p the pose's root position, qn
// lane i's decoded pose quat (lanes 0..17: root, then the 17 joint slots).
// Returns lane l's link frames; lanes past the skeleton's links get the
// root's. kDeep: the skeleton has a chain deeper than a pass (the kernels
// are instantiated for both, so that a shallow skeleton's walk carries no
// code for further passes).
template <bool kDeep>
__device__ __forceinline__ Link fk_walk(const Plan& plan, V root_p, Q qn) {
  const int depth = plan.depth();
  Q q = shfl_q(qn, 0);
  V p = root_p;
  // this link's own chain, root first: the serial walk's steps for its
  // ancestors, in its order
  Q g[kMaxDepth];
#pragma unroll
  for (int k = 1; k <= kMaxDepth; ++k) {
    const int qi = __float_as_int(plan.e[k].w);
    g[k - 1] = shfl_q(qn, qi < 0 ? 0 : qi);
  }
#pragma unroll
  for (int k = 1; k <= kMaxDepth; ++k) {
    if (k <= depth) {
      p = vadd(p, qrot(q, xyz(plan.e[k])));
      if (__float_as_int(plan.e[k].w) >= 0) q = qmul(q, g[k - 1]);
    }
  }
  if constexpr (kDeep) {
    // chains deeper than a pass (none of AMASS's, at most 7): further
    // passes from the frame reached, kMaxDepth rows each, loaded together;
    // as many passes in every lane (the warp's deepest chain), so each
    // pass's shuffles are the warp's
    const int deepest = __reduce_max_sync(kFull, depth);
#pragma unroll 1
    for (int k0 = kMaxDepth + 1; k0 <= deepest; k0 += kMaxDepth) {
      float4 e[kMaxDepth];
#pragma unroll
      for (int i = 0; i < kMaxDepth; ++i)
        e[i] = __ldg(plan.col + min(k0 + i, kPlanRows - 1) * kMaxLinks);
#pragma unroll
      for (int i = 0; i < kMaxDepth; ++i) {
        const int qi = __float_as_int(e[i].w);
        g[i] = shfl_q(qn, qi < 0 ? 0 : qi);
      }
#pragma unroll
      for (int i = 0; i < kMaxDepth; ++i) {
        if (k0 + i <= depth) {
          p = vadd(p, qrot(q, xyz(e[i])));
          if (__float_as_int(e[i].w) >= 0) q = qmul(q, g[i]);
        }
      }
    }
  }
  return {p, q, vadd(p, qrot(q, xyz(plan.e[0])))};
}

// lane l < L writes link l's (7,) CoM and joint frames
__device__ __forceinline__ void store_link(const Link& f, int L,
                                           float* __restrict__ pq_com,
                                           float* __restrict__ pq_jf) {
  const int l = threadIdx.x & 31;
  if (l >= L) return;
  float* jf = pq_jf + 7 * l;
  float* cm = pq_com + 7 * l;
  jf[0] = f.p.x; jf[1] = f.p.y; jf[2] = f.p.z;
  cm[0] = f.c.x; cm[1] = f.c.y; cm[2] = f.c.z;
  jf[3] = cm[3] = f.q.x;
  jf[4] = cm[4] = f.q.y;
  jf[5] = cm[5] = f.q.z;
  jf[6] = cm[6] = f.q.w;
}

}  // namespace tipq
