// Counter-based dropout keep-masks, device side (twin of
// tip_tpu/ops/hashmask.py and tip_tpu_torch/ops/hashmask.py).
//
// The murmur3 finalizer over an element's linear index, in uint32 (the
// int32 wraparound multiplies and logical shifts of tip_tpu). The 31-bit
// hash is converted to float with round-to-nearest and compared with the
// keep probability in float, as tip_tpu does in f32.

#pragma once

namespace hm {

// the seed of batch tile `tile` (tip_tpu: seed + program_id * 104729,
// int32 wraparound)
__device__ __forceinline__ int tile_seed(int seed, int tile) {
  return static_cast<int>(static_cast<unsigned>(seed) +
                          static_cast<unsigned>(tile) * 104729u);
}

// keep value (0 or 1/p_keep) of linear index `idx` at dropout site `site`
__device__ __forceinline__ float keep(int seed, int site, unsigned idx,
                                      float p_keep, float inv_keep) {
  unsigned h = idx * 0x9E3779B9u;
  h = h + static_cast<unsigned>(seed) + static_cast<unsigned>(site) * 7919u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  const float u = __int2float_rn(static_cast<int>(h & 0x7FFFFFFFu)) * 0x1p-31f;
  return u < p_keep ? inv_keep : 0.0f;
}

// A dropout site over rows grouped in batch tiles of `tile_rows` rows
// (bt samples of T rows): the mask of (row, col) of an (N, ncols) matrix is
// indexed by the row within its tile, r * ncols + col, under the tile's
// seed.
struct Drop {
  int on;
  int seed;
  int site;
  int tile_rows;
  float p_keep;
  float inv_keep;
};

__device__ __forceinline__ float drop_at(const Drop& d, int row, int col,
                                         int ncols) {
  if (!d.on) return 1.0f;
  const int tile = row / d.tile_rows;
  const int r = row - tile * d.tile_rows;
  return keep(tile_seed(d.seed, tile), d.site,
              static_cast<unsigned>(r) * static_cast<unsigned>(ncols) +
                  static_cast<unsigned>(col),
              d.p_keep, d.inv_keep);
}

}  // namespace hm
