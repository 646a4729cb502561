// 16-byte vector loads and stores of float32 and bfloat16 rows, converted
// to and from float32 registers; shared by csr_spmm.cu (K5) and
// sparse_attention.cu (K4). Every pointer passed here is 16-byte aligned:
// the wrappers check the base pointers, and rows are a multiple of 16
// bytes wide.
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

__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store16(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&x)[8]) {
  uint4 v;
  __nv_bfloat162* pairs = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) pairs[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

}  // namespace grl
