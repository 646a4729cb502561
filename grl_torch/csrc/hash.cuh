// K0: the stateless DropEdge hash, shared by dropedge_sm90.cu and
// dropedge_f32.cu (K1, K2), csr_spmm.cu (K5), ell.cu (K6) and dropout.cu
// (D); and its pair form, keep_pair, which tile.cu (K7) keys on both
// endpoints of an edge.
//
// Counterpart of grl_tpu/ops/pallas/csr_spmm.py:_mix32/_hash_keep
// (:179-213) and of grl_torch/ops/hashing.py, bit for bit: an id gid is
// kept iff (mix(mix(gid ^ s) + s) >> 8) * 2^-24 < keep, with s the seed
// mod 2^32 and keep = 1 - rate rounded to float32. The seed goes in twice,
// by xor and by add: a single xor makes every mask an xor-translate of one
// fixed set (csr_spmm.py:196-204). A pure function of (gid, seed), so a
// forward and a backward kernel see one mask whatever their tiling, and
// no mask is ever stored.
#pragma once

#include <cstdint>

namespace grl {

// murmur3 fmix32 round, as csr_spmm.py:_mix32.
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x *= 0x9E3779B9u;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// DropEdge keep bit of id gid.
__device__ __forceinline__ bool keep_edge(uint32_t gid, uint32_t seed, float keep) {
  const uint32_t x = mix32(mix32(gid ^ seed) + seed);
  return static_cast<float>(x >> 8) * (1.0f / 16777216.0f) < keep;
}

// DropEdge keep bit of the edge (recv, send), as grl_tpu/ops/tile.py:
// _hash_keep_pair (:63-79) and grl_torch/ops/hashing.py:keep_pair_bits:
// x = mix(mix(mix(recv ^ s) + send) + s), kept iff (x >> 8) * 2^-24 <
// keep, with s the seed xor the relation's mix. A tile cell gives both
// endpoints in either table layout, so the forward and the transposed
// walk draw one mask.
__device__ __forceinline__ bool keep_pair(uint32_t recv, uint32_t send, uint32_t seed, float keep) {
  const uint32_t x = mix32(mix32(mix32(recv ^ seed) + send) + seed);
  return static_cast<float>(x >> 8) * (1.0f / 16777216.0f) < keep;
}

}  // namespace grl
