// K2 decode_fused and K3 tail_fused: the streaming runner's per-frame
// decode (stages 4-5) and tail (stages 6-7), f32, one block a stream: a
// single stream is a grid of one block, a pool of B streams one launch of B
// blocks over inputs and outputs with a leading stream axis.
//
// Replaces tip_tpu/ops/fused_tail.py::decode_fused (Pallas kernel
// _decode_kernel) and tip_tpu/ops/fused_tail.py::tail_fused (Pallas kernel
// _tail_kernel). The quaternion and tree-walk device functions are in
// tip_quat.cuh, shared with csrc/fused_fk.cu (K6).
//
// What bounds them on the H100: neither bytes nor operations. K2 reads
// about 3.2 KB (the 6-frame output ring) and does a few thousand flops;
// K3 reads about 1.1 KB and does a few thousand flops, mostly in the
// 19-joint tree walk. At the
// card's rates both are well under a microsecond of work; what is left is
// the launch and the dependent chain of the tree walk in one thread.
//
// Design: one small block per stream, every intermediate in registers or
// shared memory, one launch per frame (or per pool tick) instead of the
// dozens of small PyTorch ops of the plain path. K2: threads stride over the output
// columns for the filter, then one thread per SBP row and one per quat.
// K3: 18 threads decode axis-angle -> quat, thread 0 walks the tree
// (parents first), one thread per link builds the CoM and joint frames,
// one per SBP the residues, and one per history row the 6D encode.
//
// The arithmetic follows the plain PyTorch versions (ops/fused_tail.py)
// and tip_tpu's kernels (see tip_quat.cuh for the codecs); the filter
// divides by sum(coeff).

#include <cuda_runtime.h>

#include "tip_quat.cuh"

namespace {

using namespace tipq;

__global__ void decode_kernel(const float* __restrict__ y_t,
                              const float* __restrict__ filt,
                              const float* __restrict__ coeff, int nf,
                              const float* __restrict__ local9, int use_filter,
                              const unsigned char* __restrict__ use_filter_b,
                              int D, int n_sbps, float* __restrict__ y_f,
                              float* __restrict__ c_t, float* __restrict__ q) {
  extern __shared__ float yf[];
  // this block's stream; use_filter_b holds one flag a stream (a pool's
  // streams switch to the filter at their own frames), else the flag is
  // use_filter for every stream
  const int b = blockIdx.x;
  y_t += static_cast<size_t>(b) * D;
  filt += static_cast<size_t>(b) * nf * D;
  local9 += 9 * b;
  y_f += static_cast<size_t>(b) * D;
  c_t += 4 * n_sbps * b;
  q += 4 * 18 * b;
  if (use_filter_b != nullptr) use_filter = use_filter_b[b];
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

constexpr int kSbps = 5;
// pq row per SBP body: [lankle, rankle, lwrist, rwrist, root]; row = link + 1
__constant__ int kSbpRows[kSbps] = {3, 6, 15, 19, 0};

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
  __shared__ FkShared sh;
  __shared__ V res_s[kSbps];
  __shared__ float fl_s[kSbps];
  const int tid = threadIdx.x;
  // this block's stream
  const int b = blockIdx.x;
  const int n_pq = 7 * (J + 1);
  s += 114 * b;
  ct += 4 * kSbps * b;
  prev_pq += n_pq * b;
  pq_com += n_pq * b;
  pq_jf += n_pq * b;
  hist += 108 * b;
  vres += 3 * b;
  clocs += 3 * kSbps * b;
  rres += 3 * kSbps * b;
  act += kSbps * b;

  // s[0:57] has the layout of a pose: root xyz, root axis-angle, 17 joint
  // axis-angles (in nimble order, which slot[] maps the joints to)
  fk_block(s, joff, coff, parent, is_fixed, slot, J, sh, pq_com, pq_jf);

  // 6D history re-encode from the decoded quats
  if (tid < kPoseQuats) {
    Q q = sh.qn[tid];
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

  // per-SBP velocity residues
  if (tid < kSbps) {
    const int row = kSbpRows[tid];
    const V x1 = load_v(prev_pq + 7 * row);
    const Q q1 = load_q(prev_pq + 7 * row + 3);
    const V x2 = sh.pc[row];
    const Q q2 = sh.qa[row];
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

// B streams: y_t (B, D), filt (B, nf, D), local9 (B, 9) -> y_f (B, D), c_t
// (B, n_sbps, 4), q (B, 18, 4). use_filter_b: (B,) bytes, one flag a
// stream, or null for use_filter on every stream.
extern "C" int decode_fused_launch(const void* y_t, const void* filt,
                                   const void* coeff, int nf,
                                   const void* local9, int use_filter,
                                   const void* use_filter_b, int B, int D,
                                   int n_sbps, void* y_f, void* c_t, void* q,
                                   void* stream) {
  if (B < 1) return -1;
  decode_kernel<<<B, 128, D * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y_t), static_cast<const float*>(filt),
      static_cast<const float*>(coeff), nf, static_cast<const float*>(local9),
      use_filter, static_cast<const unsigned char*>(use_filter_b), D, n_sbps,
      static_cast<float*>(y_f), static_cast<float*>(c_t),
      static_cast<float*>(q));
  return static_cast<int>(cudaGetLastError());
}

// B streams: every input but the skeleton's tables, and every output,
// carries a leading stream axis.
extern "C" int tail_fused_launch(const void* s, const void* ct,
                                 const void* prev_pq, const void* joff,
                                 const void* coff, const void* parent,
                                 const void* is_fixed, const void* slot, int B,
                                 int J, float dt, void* pq_com, void* pq_jf,
                                 void* hist, void* vres, void* clocs,
                                 void* rres, void* act, void* stream) {
  if (B < 1 || J < 0 || J + 1 > kMaxLinks) return -1;
  tail_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
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
