// bf16 products of the bf16 variants of K11 and K12 (encoder_train.cu:
// encoder_layer_fwd_bf16_launch, encoder_layer_bwd_bf16_launch) on Hopper's
// warpgroup MMA, with their operands staged by the Tensor Memory
// Accelerator.
//
// product: C (M, N) = op(A) op(B) over K, both operands bf16 in device
// memory, the sums f32, through one of train_gemm.cuh's epilogues (bias,
// ReLU + dropout mask, dReLU + mask, residual add), stored in f32 or bf16.
// A is (M, K) row-major, or stored (K, M) (TA: a weight gradient's
// activations); B is (K, N) row-major, or stored (N, K) (TB: a weight read
// transposed). So the NN (forward), NT (input gradients) and TN (weight
// gradients) products all read their operands as they lie in memory:
// wgmma takes a bf16 operand K-major or M/N-major from shared memory (its
// transpose flags), where TF32 takes K-major only (train_mma.cuh's
// reason to stay on mma.sync for the f32 kernels).
//
// A block computes a BM x BN tile (64 x 64, 64 x 128, or 128 x 128 where
// those give two blocks an SM: half the bytes from L2 of 64-row tiles),
// one warpgroup (128 threads) each 64 of its rows, over one chunk of K.
// Thread 0 asks TMA for 64-deep slices of A (BM x 64) and B (64 x BN) into
// a ring of kStages stages, each completing an mbarrier with its bytes;
// the warpgroups wait on a stage's barrier, issue four wgmma.mma_async
// m64nBNk16 on it (the descriptors read TMA's 128-byte swizzle) and, while
// they run, wait for the previous slice's and free its stage for the slice
// kStages ahead. TMA fills rows and columns past the matrix with zeros,
// so ragged edges need no masks. The epilogue goes through shared memory
// (the stages' bytes, free by then): the tile's f32 sums, then a thread
// per four consecutive outputs (16-byte f32 or 8-byte bf16 stores), then,
// where asked, the column sums of each 64 rows' f32 outputs (a bias
// gradient's partial sums, rows in order).
//
// The launch plan (ops/encoder_train.py::product_plan, a pure function of
// M, N, K) picks the tile and a split of K so that a product launches
// about 132 blocks where the shapes allow it. The splits of a 64-row tile
// form one thread block cluster (at most 16 blocks): each leaves its f32
// partial tile in its shared memory, then block z adds the splits' rows
// [z rows, (z + 1) rows) in rank order through distributed shared memory
// and applies their epilogue, so a split product is one launch. No float
// atomics: two calls give the same bits. The TMA descriptors are encoded
// on the host once for each address and shape (tile_map).
//
// What bounds a product on the H100: 989 TFLOP/s of bf16 tensor-core work
// against 3.35 TB/s. K11's and K12's products are operations-bound at B
// 256 (FF1: 5.4 GFLOP, 5.4 us) and bytes-bound at B 1 (the weights; each
// product a few us, launch and latency). What holds a tile today: its
// prologue (the first slice's TMA latency) and its epilogue are not
// overlapped with another tile's products (no persistent blocks, no
// producer warp); FF1 at B 256 runs at about 160 TFLOP/s.

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "hashmask.cuh"
#include "train_gemm.cuh"

namespace bg {

constexpr int WM = 64;          // rows of a warpgroup: one m64 wgmma
constexpr int BK = 64;          // depth of a stage: 128 bytes of bf16
constexpr int kStages = 3;      // 64 x 128 tiles: 3 blocks an SM
constexpr int kMaxSplits = 16;  // a cluster's blocks (non-portable size)
constexpr int kWarpgroup = 128;
constexpr int kRowBytes = 128;  // a swizzled row: 64 bf16
constexpr int kAtomBytes = 1024;   // 8 swizzled rows
constexpr int kChunkBytes = BK * kRowBytes;   // 64 columns of 64 rows

// the epilogue of a product's outputs: train_gemm.cuh's kinds, with bf16
// biases, the ReLU's signs as bytes and f32 or bf16 stores
struct EpiArgs {
  int kind;                    // tg::Epi
  int out_bf16;                // out is bf16 (else f32)
  void* out;                   // (M, N)
  const __nv_bfloat16* bias;   // E_BIAS, E_BIAS_RELU_DROP: (N,)
  const float* aux;            // E_ADD: the residual, (M, N) f32
  const uint8_t* pos;          // E_DRELU_DROP: 1 where the ReLU's input > 0
  uint8_t* pos_out;            // E_BIAS_RELU_DROP: writes those (or null)
  float* colpart;              // (ceil(M / WM), N) column sums (or null)
  hm::Drop drop;               // E_BIAS_RELU_DROP, E_DRELU_DROP
};

// a product's launch: tile rows and width, rows of K a split takes,
// splits (128-row tiles are never split)
struct Plan {
  int bm, bn, kchunk, splits;
};

template <int BM, int BN>
struct Smem {
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int LDT = BN + 4;   // the epilogue's f32 tiles
  static constexpr size_t BYTES =
      static_cast<size_t>(kStages) * STAGE + kAtomBytes + 8 * kStages;
  // the sums, a split tile's summed rows (64-row tiles) and the column
  // sums of each 64 rows
  static_assert(((BM == WM ? 2 : 1) * BM * LDT + BN * BM / WM) * 4 <=
                    kStages * STAGE,
                "epilogue");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// a box of a 2-D map into shared memory, completing `bar` with its bytes;
// c0 the inner (column) coordinate
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// a wgmma shared-memory descriptor of 128-byte-swizzled rows: lbo the
// stride between 64-wide chunks of an M/N-major operand, sbo between
// groups of 8 rows (bytes)
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of the sums across the
// asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_sums(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// the four 16-deep steps of one staged slice: a (the warpgroup's 64 x 64,
// K-major, or M-major if TA) and b (BN x 64 K-major if TB, else 64 x BN
// N-major)
template <bool TA, bool TB, int BN>
__device__ __forceinline__ void mma_slice(float (&acc)[BN / 2],
                                          const uint8_t* a,
                                          const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    // K-major: 16 values are 32 bytes along a row; M/N-major: 16 rows
    const uint64_t da = TA ? desc(a + kk * 16 * kRowBytes, kChunkBytes,
                                  kAtomBytes)
                           : desc(a + kk * 32, 16, kAtomBytes);
    const uint64_t db = TB ? desc(b + kk * 32, 16, kAtomBytes)
                           : desc(b + kk * 16 * kRowBytes, kChunkBytes,
                                  kAtomBytes);
    if constexpr (BN == 64)
      wgmma_n64<TA ? 1 : 0, TB ? 0 : 1>(acc, da, db);
    else
      wgmma_n128<TA ? 1 : 0, TB ? 0 : 1>(acc, da, db);
  }
}

// thread 0: the slice at row k of K into stage `a` (A, then B): A's rows
// of a warpgroup lie kChunkBytes apart either way
template <bool TA, bool TB, int BM, int BN>
__device__ __forceinline__ void load_slice(uint8_t* a, const CUtensorMap* ma,
                                           const CUtensorMap* mb,
                                           uint64_t* bar, int m0, int n0,
                                           int k) {
  mbar_expect_tx(bar, Smem<BM, BN>::STAGE);
  if (TA) {
#pragma unroll
    for (int c = 0; c < BM / 64; ++c)
      tma_load(a + c * kChunkBytes, ma, bar, m0 + 64 * c, k);
  } else {
    tma_load(a, ma, bar, k, m0);
  }
  uint8_t* b = a + Smem<BM, BN>::A_BYTES;
  if (TB) {
    tma_load(b, mb, bar, k, n0);
  } else {
#pragma unroll
    for (int c = 0; c < BN / 64; ++c)
      tma_load(b + c * kChunkBytes, mb, bar, n0 + 64 * c, k);
  }
}

// Output (gm, gn) of the product sum v through the epilogue
__device__ __forceinline__ float epi_value(float v, int gm, int gn, int N,
                                           const EpiArgs& ep) {
  const size_t o = static_cast<size_t>(gm) * N + gn;
  switch (ep.kind) {
    case tg::E_BIAS:
      return v + __bfloat162float(ep.bias[gn]);
    case tg::E_BIAS_RELU_DROP: {
      const float f = fmaxf(v + __bfloat162float(ep.bias[gn]), 0.0f);
      if (ep.pos_out) ep.pos_out[o] = f > 0.0f ? 1 : 0;
      return f * hm::drop_at(ep.drop, gm, gn, N);
    }
    case tg::E_DRELU_DROP:
      v = v * hm::drop_at(ep.drop, gm, gn, N);
      return v * (ep.pos[o] ? 1.0f : 0.0f);
    case tg::E_ADD:
      return ep.aux[o] + v;
    default:
      return v;
  }
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

// The epilogue of rows [r0, r1) of the 64 x BN tile at (m0, n0) whose f32
// sums are in t (row stride ldt): outputs through ep, four consecutive
// columns a thread (N % 4 == 0), each output's f32 value left in t (0 past
// the matrix)
template <int BN>
__device__ void rows_epilogue(float* t, int ldt, int r0, int r1, int m0,
                              int n0, int M, int N, const EpiArgs& ep) {
  for (int e = threadIdx.x; e < (r1 - r0) * (BN / 4); e += blockDim.x) {
    const int r = r0 + e / (BN / 4), c = 4 * (e % (BN / 4));
    const int gm = m0 + r, gn = n0 + c;
    float* v = t + r * ldt + c;
    if (gm < M && gn < N) {
      float o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i] = epi_value(v[i], gm, gn + i, N, ep);
      const size_t at = static_cast<size_t>(gm) * N + gn;
      if (ep.out_bf16)
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(ep.out) + at) =
            make_uint2(bf16x2(o[0], o[1]), bf16x2(o[2], o[3]));
      else
        *reinterpret_cast<float4*>(static_cast<float*>(ep.out) + at) =
            make_float4(o[0], o[1], o[2], o[3]);
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = o[i];
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = 0.0f;
    }
  }
}

// out[c] = the sum of rows [r0, r1) of column c of t, rows in order
template <int BN>
__device__ void column_sums(const float* t, int ldt, int r0, int r1,
                            float* out) {
  for (int c = threadIdx.x; c < BN; c += blockDim.x) {
    float s = 0.0f;
    for (int r = r0; r < r1; ++r) s += t[r * ldt + c];
    out[c] = s;
  }
}

// The epilogue of a split 64 x BN tile (the sums of the block's split in
// t): the cluster's block z sums rows [z rows, (z + 1) rows) of the tile
// over the splits in rank order, and applies their epilogue; the column
// sums are each block's rows' sums added in rank order
template <int BN>
__device__ void split_epilogue(float* t, int m0, int n0, int M, int N,
                               int cols, const EpiArgs& ep) {
  using S = Smem<WM, BN>;
  constexpr int BM = WM;
  const int tid = threadIdx.x;
  float* colpart =
      ep.colpart ? ep.colpart + static_cast<size_t>(blockIdx.y) * N + n0
                 : nullptr;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned splits = gridDim.z, z = blockIdx.z;
  const int rows = (BM + splits - 1) / splits;
  const int r0 = min(BM, static_cast<int>(z) * rows);
  const int r1 = min(BM, r0 + rows);
  cluster.sync();   // every split's sums are in its shared memory
  for (int e = tid; e < (r1 - r0) * (BN / 4); e += blockDim.x) {
    const int at = (r0 + e / (BN / 4)) * S::LDT + 4 * (e % (BN / 4));
    float4 u[kMaxSplits];
#pragma unroll
    for (int k = 0; k < kMaxSplits; ++k)   // all loads in flight
      if (k < static_cast<int>(splits))
        u[k] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(t, k) + at);
    float4 v = u[0];
#pragma unroll
    for (int k = 1; k < kMaxSplits; ++k)
      if (k < static_cast<int>(splits)) {
        v.x += u[k].x;
        v.y += u[k].y;
        v.z += u[k].z;
        v.w += u[k].w;
      }
    *reinterpret_cast<float4*>(t + at + BM * S::LDT) = v;
  }
  cluster.sync();   // every block has read the others' rows
  float* fin = t + BM * S::LDT;   // this block's rows, summed
  rows_epilogue<BN>(fin, S::LDT, r0, r1, m0, n0, M, N, ep);
  if (!colpart) return;
  __syncthreads();
  float* sums = fin + BM * S::LDT;
  column_sums<BN>(fin, S::LDT, r0, r1, sums);
  cluster.sync();   // every block's column sums are in place
  if (z == 0)
    for (int c = tid; c < cols; c += blockDim.x) {
      float v = 0.0f;
      for (unsigned k = 0; k < splits; ++k)
        v += cluster.map_shared_rank(sums, k)[c];
      colpart[c] = v;
    }
  cluster.sync();   // block 0 has read them
}

// One BM x BN tile over rows [z kchunk, (z + 1) kchunk) of K, z =
// blockIdx.z, through the epilogue; warpgroup w takes the tile's rows 64 w
// onwards. Where K is split (gridDim.z > 1, 64-row tiles) the gridDim.z
// blocks of a tile are one cluster, z its rank.
template <bool TA, bool TB, int BM, int BN>
__global__ void __launch_bounds__(BM / WM * kWarpgroup)
    gemm_kernel(const __grid_constant__ CUtensorMap ma,
                const __grid_constant__ CUtensorMap mb, int M, int N, int K,
                int kchunk, EpiArgs ep) {
  using S = Smem<BM, BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAtomBytes - 1) &
      ~static_cast<uintptr_t>(kAtomBytes - 1));   // the swizzle's alignment
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + kStages * S::STAGE);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = tid / kWarpgroup;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int k0 = blockIdx.z * kchunk;
  const int nk = (min(K, k0 + kchunk) - k0 + BK - 1) / BK;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < kStages && s < nk; ++s)
      load_slice<TA, TB, BM, BN>(sm + s * S::STAGE, &ma, &mb, full + s, m0,
                                 n0, k0 + s * BK);
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    mbar_wait(full + s, (kt / kStages) & 1);
    const uint8_t* a = sm + s * S::STAGE;
    fence_sums(acc);
    wgmma_fence();
    mma_slice<TA, TB, BN>(acc, a + wg * kChunkBytes, a + S::A_BYTES);
    wgmma_commit();
    wgmma_wait<1>();   // slice kt - 1's products are done
    fence_sums(acc);
    if (kt > 0) {
      __syncthreads();   // ... in every warp: its stage is free
      const int nxt = kt - 1 + kStages;
      if (tid == 0 && nxt < nk)
        load_slice<TA, TB, BM, BN>(sm + ((kt - 1) % kStages) * S::STAGE, &ma,
                                   &mb, full + (kt - 1) % kStages, m0, n0,
                                   k0 + nxt * BK);
    }
  }
  wgmma_wait<0>();
  fence_sums(acc);
  __syncthreads();   // every stage is read: the tile reuses their bytes
  // the sums' fragments: warp w holds rows 16 w + g (+8), columns 8 j + 2 q
  // (+1) of each 8-column group j
  float* t = reinterpret_cast<float*>(sm);
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int row = 16 * warp + g + 8 * ((i % 4) >> 1);
    const int col = 8 * (i / 4) + 2 * q;
    *reinterpret_cast<float2*>(t + row * S::LDT + col) =
        make_float2(acc[i], acc[i + 1]);
  }
  __syncthreads();
  const int cols = min(BN, N - n0);
  if (gridDim.z == 1) {
    rows_epilogue<BN>(t, S::LDT, 0, BM, m0, n0, M, N, ep);
    if (!ep.colpart) return;
    __syncthreads();
    float* sums = t + BM * S::LDT;   // each 64 rows' column sums
#pragma unroll
    for (int h = 0; h < BM / WM; ++h)
      column_sums<BN>(t, S::LDT, WM * h, WM * (h + 1), sums + h * BN);
    __syncthreads();
#pragma unroll
    for (int h = 0; h < BM / WM; ++h) {
      if (m0 + WM * h >= M) break;
      float* row = ep.colpart +
                   static_cast<size_t>(blockIdx.y * (BM / WM) + h) * N + n0;
      for (int c = tid; c < cols; c += blockDim.x) row[c] = sums[h * BN + c];
    }
    return;
  }
  if constexpr (BM != WM) {
    __trap();   // the plan splits only 64-row tiles
  } else {
    split_epilogue<BN>(t, m0, n0, M, N, cols, ep);
  }
}

// ---- host side ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime's entry-point
// query (the library links no libcuda)
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a row-major bf16 matrix (rows, cols) at p in boxes of
// box_rows rows by 64 columns, 128-byte swizzle, zeros past its edges.
// Encoded once for each (p, rows, cols, box_rows) and kept (a map holds
// nothing else, so a kept one is the map): weights keep their address
// from call to call, and so, as a rule, do the caching allocator's
// activations.
inline bool tile_map(CUtensorMap* m, const void* p, int rows, int cols,
                     int box_rows) {
  struct Kept {
    const void* p;
    int rows, cols, box_rows;
    CUtensorMap map;
  };
  static Kept kept[512] = {};
  static std::mutex mu;
  const size_t slot = ((reinterpret_cast<uintptr_t>(p) >> 8) ^
                       (static_cast<size_t>(rows) * 40503u) ^
                       (static_cast<size_t>(cols) * 131u) ^
                       static_cast<size_t>(box_rows)) % 512;
  std::lock_guard<std::mutex> lock(mu);
  Kept& k = kept[slot];
  if (k.p == p && k.rows == rows && k.cols == cols &&
      k.box_rows == box_rows) {
    *m = k.map;
    return true;
  }
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64u, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1u, 1u};
  if (enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims,
          strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  k = Kept{p, rows, cols, box_rows, *m};
  return true;
}

// Whether plan p is a launch of an (M, N, K) product: tiles 64 x 64, 64 x
// 128 or 128 x 128, K cut into chunks of whole 64-deep slices, at most
// kMaxSplits of them and none of a 128-row tile
inline bool plan_ok(const Plan& p, int M, int N, int K) {
  const bool tile = (p.bm == 64 && (p.bn == 64 || p.bn == 128)) ||
                    (p.bm == 128 && p.bn == 128);
  return tile && p.kchunk > 0 && p.kchunk % BK == 0 && p.splits >= 1 &&
         p.splits <= kMaxSplits && (p.bm == 64 || p.splits == 1) &&
         p.splits == (K + p.kchunk - 1) / p.kchunk && M > 0 && N > 0;
}

// Internal to each library that includes this header (K11/K12 bf16's and
// K10 bf16's launch the same instantiations): a function-local static of
// an inline function is one object across the libraries of a process, and
// the attribute set on one library's kernel would be missing on the
// other's.
namespace {

template <bool TA, bool TB, int BM, int BN>
inline cudaError_t launch(dim3 grid, const CUtensorMap& ma,
                          const CUtensorMap& mb, int M, int N, int K,
                          int kchunk, const EpiArgs& ep, cudaStream_t st) {
  constexpr size_t smem = Smem<BM, BN>::BYTES;
  auto* kernel = gemm_kernel<TA, TB, BM, BN>;
  // once per process and instantiation; a refusal shows at the launch
  static const cudaError_t attr =
      (cudaFuncSetAttribute(kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(smem)),
       cudaFuncSetAttribute(kernel,
                            cudaFuncAttributeNonPortableClusterSizeAllowed,
                            1));
  (void)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(BM / WM * kWarpgroup);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute cl[1];
  cl[0].id = cudaLaunchAttributeClusterDimension;
  cl[0].val.clusterDim.x = 1;
  cl[0].val.clusterDim.y = 1;
  cl[0].val.clusterDim.z = grid.z;   // a tile's splits: one cluster
  cfg.attrs = cl;
  cfg.numAttrs = grid.z > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, ma, mb, M, N, K, kchunk, ep);
}

}  // namespace

// C (M, N) = op(A) op(B) through ep by plan p (plan_ok): A (M, K), or
// stored (K, M) if TA; B (K, N), or stored (N, K) if TB; bf16, rows 16-byte
// aligned. One launch.
template <bool TA, bool TB>
inline cudaError_t product(const Plan& p, const void* A, const void* B,
                           int M, int N, int K, const EpiArgs& ep,
                           cudaStream_t st) {
  CUtensorMap ma, mb;
  const bool ok_a =
      TA ? tile_map(&ma, A, K, M, BK) : tile_map(&ma, A, M, K, p.bm);
  const bool ok_b = TB ? tile_map(&mb, B, N, K, p.bn)
                       : tile_map(&mb, B, K, N, BK);
  if (!ok_a || !ok_b) return cudaErrorInvalidValue;
  const dim3 grid((N + p.bn - 1) / p.bn, (M + p.bm - 1) / p.bm, p.splits);
  cudaError_t e;
  if (p.bm == 128)
    e = launch<TA, TB, 128, 128>(grid, ma, mb, M, N, K, p.kchunk, ep, st);
  else if (p.bn == 128)
    e = launch<TA, TB, 64, 128>(grid, ma, mb, M, N, K, p.kchunk, ep, st);
  else
    e = launch<TA, TB, 64, 64>(grid, ma, mb, M, N, K, p.kchunk, ep, st);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace bg
