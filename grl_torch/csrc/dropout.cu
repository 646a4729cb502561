// D: dropout with a hashed keep mask on Hopper (sm_90a), one pass each way.
//
// Replaces flax nn.Dropout as grl_tpu uses it (grl_tpu/models/
// gcn_family.py:114,245), which XLA fused into the neighbouring ops on the
// TPU. For x of n elements, a seed in device memory and keep = 1 - rate
// rounded to float32:
//
//     y[i] = keep_edge(i, seed, keep) ? round(float(x[i]) * scale) : 0
//
// with keep_edge K0's hash of the flat element index i (hash.cuh, as
// grl_torch/ops/hashing.py:keep_bits), scale = 1 / keep rounded to float32,
// the product taken in float32 and rounded once to x's dtype (float32 or
// bfloat16). The backward is the same kernel on dy with the same seed: the
// mask is regenerated, never stored.
//
// Design and what bounds it. An elementwise pass: each thread takes
// 16-byte vectors of x in a grid-stride loop (one wave of blocks), hashes
// each element's index and writes the vector once; a ragged tail of
// n % (16 / itemsize) elements is taken one element at a time. It reads x
// once and writes y once: 2 n itemsize bytes, at the step's (N, 1280) bf16
// activation 0.87 GB, 0.259 ms at 3.35 TB/s. The hash's ~12 integer
// operations an element stay under the memory time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hash.cuh"
#include "vec.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n, const uint32_t* __restrict__ seed_ptr,
               float keep, float scale) {
  constexpr int kElems = grl::Vec<T>::kElems;
  const uint32_t seed = __ldg(seed_ptr);
  const long long vecs = n / kElems;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long v = first; v < vecs; v += stride) {
    float a[kElems];
    grl::unpack16(__ldcs(reinterpret_cast<const uint4*>(x) + v), a);
    const uint32_t gid = static_cast<uint32_t>(v * kElems);
#pragma unroll
    for (int i = 0; i < kElems; ++i) a[i] = grl::keep_edge(gid + i, seed, keep) ? a[i] * scale : 0.f;
    grl::store16_stream(y + v * kElems, a);
  }
  for (long long i = vecs * kElems + first; i < n; i += stride) {
    const float a = grl::to_float(x[i]);
    const float out = grl::keep_edge(static_cast<uint32_t>(i), seed, keep) ? a * scale : 0.f;
    if constexpr (sizeof(T) == 4) {
      y[i] = out;
    } else {
      y[i] = __float2bfloat16_rn(out);
    }
  }
}

}  // namespace

// Launches D on `stream` of `device` over n < 2^32 elements of x into y,
// blocks blocks of 256 threads; x and y 16-byte aligned, dtype 0 = float32,
// 1 = bfloat16; seed points at one uint32 in device memory. Does not
// synchronise, allocates nothing, returns cudaGetLastError().
extern "C" int grl_dropout(const void* x, void* y, long long n, const void* seed, float keep, float scale,
                           int blocks, int dtype, int device, void* stream) {
  if (n < 0 || n >= (1ll << 32) || blocks < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* sp = static_cast<const uint32_t*>(seed);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dropout_kernel<float><<<blocks, kThreads, 0, st>>>(static_cast<const float*>(x), static_cast<float*>(y), n, sp,
                                                      keep, scale);
  } else {
    dropout_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), n, sp, keep, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* grl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
