// K4: fused edge-restricted attention on Hopper (sm_90a).
//
// Replaces grl_tpu/ops/pallas/sparse_attention.py:_bucket_forward_pallas
// (the pallas_call at :106, body _atten_kernel :82-93) inside
// SparseAttentionKernel.attend (:197-201). For every receiver r with
// incoming edges s -> r:
//
//     score_s = f[r] . g[s]            (SDDMM, K wide)
//     alpha_s = softmax over r's edges of score_s
//     out[r]  = sum_s alpha_s * h[s]   (F wide)
//
// with f, g (N, K) and h, out (N, F) all float32 or all bfloat16, computed
// in float32 and written once in h's dtype; a receiver with no edge gets
// zeros (as _row_softmax's all-padding rows do).
//
// Design. The TPU kernel needs XLA to gather each bucket's [h | g]
// neighbour rows into a (rows, W, F+K) block before the call (:185-186),
// splits receivers into degree buckets of width W, and sends hubs wider
// than MAX_PALLAS_WIDTH = 32 to an XLA path (:188-191), because a block
// must fit VMEM. Here one warp owns one receiver row and gathers the rows
// itself, so one launch covers every degree, hubs and isolated receivers
// included. The warp walks the row's edges 32 at a time: each lane loads
// one sender's g row (16-byte loads when K allows), scores it against f[r]
// (staged once in shared memory), and the warp folds the batch into an
// online softmax (running max m and denominator l; the accumulator is
// rescaled by exp(m_old - m_new) when the max grows). The warp then
// gathers each sender's h row with 16-byte loads (lane i takes vectors i,
// i + 32, ...) and accumulates p * h in registers. The row is written once
// as acc / l. Scores and alpha never touch device memory, and there are no
// atomics.
//
// What bounds it. At the full-graph slice's shape (N = 169,343,
// E = 1,184,773, K = 16, F = 128, bf16) one call reads f, g and h once,
// the CSR (row pointers and senders) once, and writes out once: ~103 MB,
// 0.031 ms at 3.35 TB/s, against ~E*(2K + 2F) = 0.34 GFLOP, below the
// ridge. The realistic floor is again the gather: E rows of g (32 bytes)
// and of h (256 bytes) at random senders, ~0.34 GB if they miss the L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "vec.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps, one receiver row each
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// kVecs: 16-byte vectors of h a lane holds per pass over the F features.
template <typename T, int kVecs>
__global__ void __launch_bounds__(kThreads)
sparse_attention_kernel(const int* __restrict__ rowptr, const int* __restrict__ senders,
                        const T* __restrict__ f, const T* __restrict__ g,
                        const T* __restrict__ h, T* __restrict__ out, int N, int K, int F) {
  extern __shared__ float f_rows[];  // (kWarps, K)
  constexpr int kElems = grl::Vec<T>::kElems;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= N) return;  // the whole warp leaves together
  float* fr = f_rows + warp * K;
  for (int k = lane; k < K; k += 32) fr[k] = grl::to_float(f[static_cast<size_t>(r) * K + k]);
  __syncwarp();
  const int start = rowptr[r];
  const int end = rowptr[r + 1];
  const bool vector_g = K % kElems == 0;
  const int pass = 32 * kVecs * kElems;

  for (int f0 = 0; f0 < F; f0 += pass) {
    float acc[kVecs][kElems];
#pragma unroll
    for (int v = 0; v < kVecs; ++v)
#pragma unroll
      for (int i = 0; i < kElems; ++i) acc[v][i] = 0.f;
    float m = -INFINITY;  // running max of the scores
    float l = 0.f;        // running sum of exp(score - m)

    for (int base = start; base < end; base += 32) {
      const int e = base + lane;
      int s = 0;
      float score = -INFINITY;
      if (e < end) {
        s = senders[e];
        const T* grow = g + static_cast<size_t>(s) * K;
        float dot = 0.f;
        if (vector_g) {
          for (int k0 = 0; k0 < K; k0 += kElems) {
            float x[kElems];
            grl::load16(grow + k0, x);
#pragma unroll
            for (int i = 0; i < kElems; ++i) dot = fmaf(fr[k0 + i], x[i], dot);
          }
        } else {
          for (int k = 0; k < K; ++k) dot = fmaf(fr[k], grl::to_float(grow[k]), dot);
        }
        score = dot;
      }
      // The batch holds at least one edge, so m_new is finite, and the
      // first batch rescales the empty accumulator by exp(-inf) = 0.
      const float m_new = fmaxf(m, warp_max(score));
      const float corr = expf(m - m_new);
      const float p = e < end ? expf(score - m_new) : 0.f;
      l = l * corr + warp_sum(p);
      m = m_new;
#pragma unroll
      for (int v = 0; v < kVecs; ++v)
#pragma unroll
        for (int i = 0; i < kElems; ++i) acc[v][i] *= corr;

      const int n = min(32, end - base);
      for (int k = 0; k < n; ++k) {
        const int sk = __shfl_sync(0xffffffffu, s, k);
        const float pk = __shfl_sync(0xffffffffu, p, k);
        const T* hrow = h + static_cast<size_t>(sk) * F + f0;
#pragma unroll
        for (int v = 0; v < kVecs; ++v) {
          const int j = (v * 32 + lane) * kElems;
          if (f0 + j < F) {
            float x[kElems];
            grl::load16(hrow + j, x);
#pragma unroll
            for (int i = 0; i < kElems; ++i) acc[v][i] = fmaf(pk, x[i], acc[v][i]);
          }
        }
      }
    }

    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* orow = out + static_cast<size_t>(r) * F + f0;
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const int j = (v * 32 + lane) * kElems;
      if (f0 + j < F) {
#pragma unroll
        for (int i = 0; i < kElems; ++i) acc[v][i] *= inv;
        grl::store16(orow + j, acc[v]);
      }
    }
  }
}

template <typename T>
int launch(const int* rowptr, const int* senders, const void* f, const void* g,
           const void* h, void* out, int N, int K, int F, cudaStream_t stream) {
  constexpr int kElems = grl::Vec<T>::kElems;
  if (F % kElems != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int per_lane = (F / kElems + 31) / 32;
  const dim3 grid(static_cast<unsigned>((N + kWarps - 1) / kWarps));
  const size_t smem = static_cast<size_t>(kWarps) * K * sizeof(float);
  const T* fp = static_cast<const T*>(f);
  const T* gp = static_cast<const T*>(g);
  const T* hp = static_cast<const T*>(h);
  T* o = static_cast<T*>(out);
  if (per_lane <= 1)
    sparse_attention_kernel<T, 1><<<grid, kThreads, smem, stream>>>(rowptr, senders, fp, gp, hp, o, N, K, F);
  else if (per_lane <= 2)
    sparse_attention_kernel<T, 2><<<grid, kThreads, smem, stream>>>(rowptr, senders, fp, gp, hp, o, N, K, F);
  else
    sparse_attention_kernel<T, 4><<<grid, kThreads, smem, stream>>>(rowptr, senders, fp, gp, hp, o, N, K, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K4 on `stream` of `device`, does not synchronise, allocates
// nothing, and returns cudaGetLastError(). dtype: 0 = float32,
// 1 = bfloat16; F a multiple of 8, K <= 1024; f, g, h and out 16-byte
// aligned. rowptr (N + 1) and senders (E) are the receiver-major CSR.
extern "C" int grl_sparse_attention(const void* rowptr, const void* senders, const void* f,
                                    const void* g, const void* h, void* out, int N, int K,
                                    int F, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int* rp = static_cast<const int*>(rowptr);
  const int* sp = static_cast<const int*>(senders);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(rp, sp, f, g, h, out, N, K, F, s);
  if (dtype == 1) return launch<__nv_bfloat16>(rp, sp, f, g, h, out, N, K, F, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* grl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
