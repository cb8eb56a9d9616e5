// K2 decode_fused and K3 tail_fused: the streaming runner's per-frame
// decode (stages 4-5) and tail (stages 6-7), f32, one block each.
//
// Replaces tip_tpu/ops/fused_tail.py::decode_fused (Pallas kernel
// _decode_kernel) and tip_tpu/ops/fused_tail.py::tail_fused (Pallas kernel
// _tail_kernel), which in turn subsumes ops/kinematics.py::fk_bullet_fused.
//
// What bounds them on the H100: neither bytes nor operations. K2 reads
// about 3.2 KB (the 6-frame output ring) and does a few thousand flops;
// K3 reads about 1.1 KB and does a few thousand flops, mostly in the
// 19-joint tree walk. At the
// card's rates both are well under a microsecond of work; what is left is
// the launch and the dependent chain of the tree walk in one thread.
//
// Design: one small block per kernel, every intermediate in registers or
// shared memory, one launch per frame instead of the dozens of small
// PyTorch ops of the plain path. K2: threads stride over the output
// columns for the filter, then one thread per SBP row and one per quat.
// K3: 18 threads decode axis-angle -> quat, thread 0 walks the tree
// (parents first), one thread per link builds the CoM and joint frames,
// one per SBP the residues, and one per history row the 6D encode.
//
// The arithmetic follows the plain PyTorch versions (ops/fused_tail.py)
// and tip_tpu's kernels: the Shepperd matrix -> quat picks the first of
// equal maxima and signs w == 0 as +1; the 6D decode normalises with
// +1e-6 in the denominator; the filter divides by sum(coeff); cos is the
// plain cosf.

#include <cuda_runtime.h>

namespace {

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
__device__ Q matrix_to_q(const float* m) {
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
__device__ Q sixd_to_q(const float* s) {
  V a1{s[0], s[2], s[4]}, a2{s[1], s[3], s[5]};
  a1 = vscale(a1, 1.0f / (vnorm(a1) + 1e-6f));
  a2 = vscale(a2, 1.0f / (vnorm(a2) + 1e-6f));
  V a3 = vcross(a1, a2);
  const float m[9] = {a1.x, a2.x, a3.x, a1.y, a2.y, a3.y, a1.z, a2.z, a3.z};
  return matrix_to_q(m);
}

__global__ void decode_kernel(const float* __restrict__ y_t,
                              const float* __restrict__ filt,
                              const float* __restrict__ coeff, int nf,
                              const float* __restrict__ local9, int use_filter,
                              int D, int n_sbps, float* __restrict__ y_f,
                              float* __restrict__ c_t, float* __restrict__ q) {
  extern __shared__ float yf[];
  float csum = 0.0f;
  for (int k = 0; k < nf; ++k) csum += coeff[k];
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float v;
    if (use_filter) {
      float acc = 0.0f;
      for (int k = 0; k < nf; ++k) acc = fmaf(coeff[k], filt[k * D + c], acc);
      v = acc / csum;
    } else {
      v = y_t[c];
    }
    yf[c] = v;
    y_f[c] = v;
  }
  __syncthreads();

  const int tid = threadIdx.x;
  if (tid < 18) {
    Q r;
    if (tid == 0) {
      float m[9];
      for (int i = 0; i < 9; ++i) m[i] = local9[i];
      r = matrix_to_q(m);
    } else {
      r = sixd_to_q(yf + 6 * tid);
    }
    q[4 * tid + 0] = r.x;
    q[4 * tid + 1] = r.y;
    q[4 * tid + 2] = r.z;
    q[4 * tid + 3] = r.w;
  } else if (tid >= 32 && tid < 32 + n_sbps) {
    const int k = tid - 32;
    const float* row = yf + (D - 4 * n_sbps) + 4 * k;
    c_t[4 * k + 0] = row[0] > 0.0f ? 1.0f : 0.0f;
    c_t[4 * k + 1] = row[1] / 5.0f;
    c_t[4 * k + 2] = row[2] / 5.0f;
    c_t[4 * k + 3] = row[3] / 5.0f;
  }
}

constexpr int kMaxLinks = 32;
constexpr int kSbps = 5;
// pq row per SBP body: [lankle, rankle, lwrist, rwrist, root]; row = link + 1
__constant__ int kSbpRows[kSbps] = {3, 6, 15, 19, 0};

__device__ __forceinline__ Q load_q(const float* p) { return {p[0], p[1], p[2], p[3]}; }
__device__ __forceinline__ V load_v(const float* p) { return {p[0], p[1], p[2]}; }

__global__ void tail_kernel(const float* __restrict__ s,
                            const float* __restrict__ ct,
                            const float* __restrict__ prev_pq,
                            const float* __restrict__ joff,
                            const float* __restrict__ coff,
                            const int* __restrict__ parent,
                            const int* __restrict__ is_fixed,
                            const int* __restrict__ slot, int J, float dt,
                            float* __restrict__ pq_com, float* __restrict__ pq_jf,
                            float* __restrict__ hist, float* __restrict__ vres,
                            float* __restrict__ clocs, float* __restrict__ rres,
                            float* __restrict__ act) {
  __shared__ Q qn[18];            // decoded s[3:57]: root, nimble slots 0..16
  __shared__ Q qa[kMaxLinks];     // world link quats
  __shared__ V pj[kMaxLinks];     // joint-frame positions
  __shared__ V pc[kMaxLinks];     // CoM-frame positions
  __shared__ V res_s[kSbps];
  __shared__ float fl_s[kSbps];
  const int tid = threadIdx.x;
  const int n_links = J + 1;

  // 18 axis-angle -> quat decodes (root + 17 nimble joint slots)
  if (tid < 18) qn[tid] = aa_to_q(load_v(s + 3 + 3 * tid));
  __syncthreads();

  // tree walk, parents first
  if (tid == 0) {
    qa[0] = qn[0];
    pj[0] = load_v(s);
    for (int j = 0; j < J; ++j) {
      const int ps = parent[j] + 1;
      pj[j + 1] = vadd(pj[ps], qrot(qa[ps], load_v(joff + 3 * j)));
      qa[j + 1] = is_fixed[j] ? qa[ps] : qmul(qa[ps], qn[1 + slot[j]]);
    }
  }
  __syncthreads();

  // CoM and joint frames per link
  if (tid < n_links) {
    const Q q = qa[tid];
    const V p = pj[tid];
    const V c = vadd(p, qrot(q, load_v(coff + 3 * tid)));
    pc[tid] = c;
    float* jf = pq_jf + 7 * tid;
    float* cm = pq_com + 7 * tid;
    jf[0] = p.x; jf[1] = p.y; jf[2] = p.z;
    cm[0] = c.x; cm[1] = c.y; cm[2] = c.z;
    jf[3] = cm[3] = q.x;
    jf[4] = cm[4] = q.y;
    jf[5] = cm[5] = q.z;
    jf[6] = cm[6] = q.w;
  }
  // 6D history re-encode from the decoded quats
  if (tid < 18) {
    Q q = qn[tid];
    const float n = fmaxf(qnorm(q), 1e-12f);
    const float x = q.x / n, y = q.y / n, z = q.z / n, w = q.w / n;
    float* h = hist + 6 * tid;
    h[0] = 1.0f - 2.0f * (y * y + z * z);
    h[1] = 2.0f * (x * y - w * z);
    h[2] = 2.0f * (x * y + w * z);
    h[3] = 1.0f - 2.0f * (x * x + z * z);
    h[4] = 2.0f * (x * z - w * y);
    h[5] = 2.0f * (y * z + w * x);
  }
  __syncthreads();

  // per-SBP velocity residues
  if (tid < kSbps) {
    const int row = kSbpRows[tid];
    const V x1 = load_v(prev_pq + 7 * row);
    const Q q1 = load_q(prev_pq + 7 * row + 3);
    const V x2 = pc[row];
    const Q q2 = qa[row];
    const bool flag = ct[4 * tid] > 0.0f;
    const V offs = load_v(ct + 4 * tid + 1);
    const V v = vscale(vsub(x2, x1), 1.0f / dt);
    // angular velocity: sub = q2 - q1 or q2 + q1, the smaller in norm
    const Q dm{q2.x - q1.x, q2.y - q1.y, q2.z - q1.z, q2.w - q1.w};
    const Q dp{q2.x + q1.x, q2.y + q1.y, q2.z + q1.z, q2.w + q1.w};
    const Q sub = qnorm(dm) < qnorm(dp) ? dm : dp;
    const Q dori = qmul(sub, Q{-q2.x, -q2.y, -q2.z, q2.w});
    const V w{2.0f * dori.x / dt, 2.0f * dori.y / dt, 2.0f * dori.z / dt};
    const V r = vadd(vcross(w, offs), v);
    const float nan = __int_as_float(0x7fc00000);
    float* cl = clocs + 3 * tid;
    float* rr = rres + 3 * tid;
    cl[0] = flag ? x2.x + offs.x : 100.0f;
    cl[1] = flag ? x2.y + offs.y : 100.0f;
    cl[2] = flag ? x2.z + offs.z : 100.0f;
    rr[0] = flag ? r.x : nan;
    rr[1] = flag ? r.y : nan;
    rr[2] = flag ? r.z : nan;
    act[tid] = flag ? 1.0f : 0.0f;
    res_s[tid] = r;
    fl_s[tid] = flag ? 1.0f : 0.0f;
  }
  __syncthreads();

  // clipped mean over the active feet (0 when none is active)
  if (tid == 0) {
    const float n = fmaxf(fl_s[0] + fl_s[1], 1.0f);
    const V sum = vadd(vscale(res_s[0], fl_s[0]), vscale(res_s[1], fl_s[1]));
    vres[0] = fminf(fmaxf(sum.x / n, -0.5f), 0.5f);
    vres[1] = fminf(fmaxf(sum.y / n, -0.5f), 0.5f);
    vres[2] = fminf(fmaxf(sum.z / n, -0.5f), 0.5f);
  }
}

}  // namespace

extern "C" int decode_fused_launch(const void* y_t, const void* filt,
                                   const void* coeff, int nf,
                                   const void* local9, int use_filter, int D,
                                   int n_sbps, void* y_f, void* c_t, void* q,
                                   void* stream) {
  decode_kernel<<<1, 128, D * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y_t), static_cast<const float*>(filt),
      static_cast<const float*>(coeff), nf, static_cast<const float*>(local9),
      use_filter, D, n_sbps, static_cast<float*>(y_f), static_cast<float*>(c_t),
      static_cast<float*>(q));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tail_fused_launch(const void* s, const void* ct,
                                 const void* prev_pq, const void* joff,
                                 const void* coff, const void* parent,
                                 const void* is_fixed, const void* slot, int J,
                                 float dt, void* pq_com, void* pq_jf,
                                 void* hist, void* vres, void* clocs,
                                 void* rres, void* act, void* stream) {
  tail_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<const float*>(ct),
      static_cast<const float*>(prev_pq), static_cast<const float*>(joff),
      static_cast<const float*>(coff), static_cast<const int*>(parent),
      static_cast<const int*>(is_fixed), static_cast<const int*>(slot), J, dt,
      static_cast<float*>(pq_com), static_cast<float*>(pq_jf),
      static_cast<float*>(hist), static_cast<float*>(vres),
      static_cast<float*>(clocs), static_cast<float*>(rres),
      static_cast<float*>(act));
  return static_cast<int>(cudaGetLastError());
}
