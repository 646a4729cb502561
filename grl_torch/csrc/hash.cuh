// K0: the stateless DropEdge hash, shared by relagg.cu (K1, K2) and
// csr_spmm.cu (K5).
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

}  // namespace grl
