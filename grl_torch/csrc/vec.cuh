// 16-byte vector loads and stores of float32 and bfloat16 rows, converted
// to and from float32 registers; shared by csr_spmm.cu (K5), ell.cu (K6)
// and sparse_attention.cu (K4). Every pointer passed here is 16-byte
// aligned: the wrappers check the base pointers, and rows are a multiple
// of 16 bytes wide.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace grl {

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kElems = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kElems = 8;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// One packed 16-byte vector to and from float32 registers.
__device__ __forceinline__ void unpack16(const uint4& v, float (&x)[4]) {
  x[0] = __uint_as_float(v.x);
  x[1] = __uint_as_float(v.y);
  x[2] = __uint_as_float(v.z);
  x[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ void unpack16(const uint4& v, float (&x)[8]) {
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack16(const float (&x)[4]) {
  return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]), __float_as_uint(x[2]),
                    __float_as_uint(x[3]));
}

__device__ __forceinline__ uint4 pack16(const float (&x)[8]) {
  uint4 v;
  __nv_bfloat162* pairs = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) pairs[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  return v;
}

template <typename T, int kElems>
__device__ __forceinline__ void load16(const T* p, float (&x)[kElems]) {
  unpack16(__ldg(reinterpret_cast<const uint4*>(p)), x);
}

template <typename T, int kElems>
__device__ __forceinline__ void store16(T* p, const float (&x)[kElems]) {
  *reinterpret_cast<uint4*>(p) = pack16(x);
}

// A streaming store (st.global.cs): written once, evicted first.
template <typename T, int kElems>
__device__ __forceinline__ void store16_stream(T* p, const float (&x)[kElems]) {
  __stcs(reinterpret_cast<uint4*>(p), pack16(x));
}

// An L2 policy that keeps the lines it loads resident past lines of normal
// or evict_first priority: K5 and K6 gather the column slice they walk
// with it, while their edge metadata and outputs stream through.
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// A read-only 16-byte load under an L2 cache policy, left packed so that
// several can be in flight before any is converted.
__device__ __forceinline__ uint4 load16_hint(const void* p, uint64_t policy) {
  uint4 v;
  asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

}  // namespace grl
