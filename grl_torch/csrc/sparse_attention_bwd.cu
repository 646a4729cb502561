// K4b: the backward of K4 (fused edge-restricted attention) on Hopper
// (sm_90a), in two launches.
//
// Replaces grl_tpu/ops/pallas/sparse_attention.py:attend_bwd (:206-259),
// the custom VJP of SparseAttentionKernel.attend, which the TPU ran in XLA
// outside Pallas. With alpha_e = softmax over r's edges of f[r] . g[s] and
// out[r] = sum_e alpha_e h[s] (K4), for dout (N, F):
//
//     dalpha_e = dout[r] . h[s]
//     dscore_e = alpha_e (dalpha_e - sum over r's edges of alpha dalpha)
//     df[r] = sum over r's edges   dscore_e g[s]
//     dg[s] = sum over s's edges   dscore_e f[r]
//     dh[s] = sum over s's edges   alpha_e dout[r]
//
// f, g (N, K), h, dout (N, F) and the outputs all float32 or all bfloat16,
// computed in float32, each output written once in its input's dtype.
//
// Design. attend_bwd is scatter-free in both directions, and so is this:
// launch 1 walks the receiver-major CSR (rowptr, senders), writes df and
// one float32 (dscore, alpha) pair per edge at the edge's receiver-major
// position; launch 2 walks the sender-major CSR (colptr, t_receivers,
// t_edge), gathers each edge's pair at t_edge and writes dg and dh. A
// group of G lanes (a power of two up to 32; the wrapper's plan,
// grl_torch/ops/sparse_attention.py:backward_launch) owns one node, walks
// nodes a grid row apart, and takes its node's edges in rounds of G, lane j
// owning edge j of the round. Launch 1 makes three passes over a
// receiver's edges: (A) each lane scores its edges (f . g, k in order) and
// parks the score in its pair slot, and the group takes the max; (B) for
// each edge of the round in turn the group reads h[s] and dout[r], lane i
// the 16-byte vectors i, i + G, ..., sums dalpha by xor shuffles (every
// lane gets the same bits), and the edge's owner turns its score into
// p = exp(score - max) and stores (dalpha, p), summing l = sum p and
// u = sum p dalpha; (C) each owner makes (dscore, alpha) of its pair, with
// alpha = p / l and dscore = alpha (dalpha - u / l), and the group reads g
// rows for df, lane i holding elements i, i + G, ... of K. h is read once
// per edge, on the only pass that reads it (the pair buffer carries what
// the later pass needs); the scores are made once. Launch 2 makes one pass
// over a sender's edges for each group-wide column pass over F (one at the
// main shape), each lane gathering its edge's pair and receiver, then the
// group reading dout[r] (and f[r] on the first pass) edge by edge. The
// loops run in step across the warp (as often as its busiest group needs),
// so every shuffle takes every lane. No atomics, and every sum has a fixed
// order that depends on G alone: two launches give the same bits.
//
// What bounds it. At the full-graph slice's shape (N = 169,343,
// E = 1,184,773, K = 16, F = 128, bf16) the function reads f, g, h and
// dout once, writes df, dg and dh once, writes and reads the 8-byte pairs
// once and reads both CSRs once: ~186 MB, 0.056 ms at 3.35 TB/s; its
// ~E (6K + 4F) = 0.72 GFLOP of float32 arithmetic is below the ridge. The
// realistic floor is the gathers: E rows of h (256 bytes) in launch 1 and
// of dout (256 bytes) in launch 2 at random nodes, plus the narrow g and f
// rows and the pairs, ~0.7 GB, most of it from L2 (h, g and dout, f each
// fit the 50 MB L2 beside each other at this shape). This first version
// keeps one row in flight a group; rings of rows in flight (K4's
// cp.async ring), column slices and a degree order are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "vec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kWarp = 0xffffffffu;
// Elements of an f, g, df or dg row one lane holds: the group covers K
// (sparse_attention.py:K_PER_LANE).
constexpr int kKPerLane = 4;

__device__ __forceinline__ float group_max(float x, int group) {
  for (int o = group >> 1; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kWarp, x, o));
  return x;
}

// The sum of x over the aligned group by xor shuffles: every lane adds the
// same two partial sums at each step, so every lane ends with the same bits.
__device__ __forceinline__ float group_sum(float x, int group) {
  for (int o = group >> 1; o > 0; o >>= 1) x += __shfl_xor_sync(kWarp, x, o);
  return x;
}

__device__ __forceinline__ void store_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_float(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// f[r] . g[s] in float32, k in order: 16-byte vectors where K allows.
template <typename T>
__device__ __forceinline__ float dot_row(const T* frow, const T* grow, int K) {
  constexpr int kElems = grl::Vec<T>::kElems;
  float dot = 0.f;
  if (K % kElems == 0) {
    for (int k0 = 0; k0 < K; k0 += kElems) {
      float a[kElems], b[kElems];
      grl::load16<T, kElems>(frow + k0, a);
      grl::load16<T, kElems>(grow + k0, b);
#pragma unroll
      for (int i = 0; i < kElems; ++i) dot = fmaf(a[i], b[i], dot);
    }
  } else {
    for (int k = 0; k < K; ++k) dot = fmaf(grl::to_float(frow[k]), grl::to_float(grow[k]), dot);
  }
  return dot;
}

// Lane `lane`'s share of a . b over F: its 16-byte vectors lane, lane + G, ...
template <typename T>
__device__ __forceinline__ float dot_share(const T* a_row, const T* b_row, int vecs, int lane, int group) {
  constexpr int kElems = grl::Vec<T>::kElems;
  float dot = 0.f;
#pragma unroll 2
  for (int v = lane; v < vecs; v += group) {
    float a[kElems], b[kElems];
    grl::load16<T, kElems>(a_row + v * kElems, a);
    grl::load16<T, kElems>(b_row + v * kElems, b);
#pragma unroll
    for (int i = 0; i < kElems; ++i) dot = fmaf(a[i], b[i], dot);
  }
  return dot;
}

// Launch 1: df and the (dscore, alpha) pairs, a group per receiver.
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
attention_bwd_receivers_kernel(const int* __restrict__ rowptr, const int* __restrict__ senders,
                               const T* __restrict__ f, const T* __restrict__ g, const T* __restrict__ h,
                               const T* __restrict__ dout, float2* __restrict__ pairs, T* __restrict__ df,
                               int N, int K, int F, int group_log2) {
  constexpr int kElems = grl::Vec<T>::kElems;
  const int group = 1 << group_log2;
  const int lane = threadIdx.x & (group - 1);
  const int group_base = (threadIdx.x & 31) & ~(group - 1);
  const int groups = kThreads >> group_log2;
  const int stride = gridDim.x * groups;
  const int vecs = F / kElems;
  int r = blockIdx.x * groups + (threadIdx.x >> group_log2);
  const int sweeps = __reduce_max_sync(kWarp, r < N ? (N - 1 - r) / stride + 1 : 0);

#pragma unroll 1
  for (int sweep = 0; sweep < sweeps; ++sweep, r += stride) {
    int start = 0, end = 0;
    if (r < N) start = __ldg(rowptr + r), end = __ldg(rowptr + r + 1);
    const int rounds = __reduce_max_sync(kWarp, (end - start + group - 1) >> group_log2);
    // Only dereferenced for a receiver that has edges (so r < N).
    const T* const frow = f + static_cast<size_t>(r) * K;
    const T* const drow = dout + static_cast<size_t>(r) * F;

    // (A) Each lane scores its edges, parks the scores, and the group takes the max.
    float m = -INFINITY;
#pragma unroll 1
    for (int round = 0; round < rounds; ++round) {
      const int e = start + (round << group_log2) + lane;
      if (e < end) {
        const float score = dot_row<T>(frow, g + static_cast<size_t>(__ldg(senders + e)) * K, K);
        pairs[e] = make_float2(score, 0.f);
        m = fmaxf(m, score);
      }
    }
    m = group_max(m, group);

    // (B) dalpha edge by edge, read by the whole group; p, l and u by the owners.
    float l = 0.f, u = 0.f;
#pragma unroll 1
    for (int round = 0; round < rounds; ++round) {
      const int base = start + (round << group_log2);
      const int e = base + lane;
      const bool mine = e < end;
      const int s = mine ? __ldg(senders + e) : 0;
      const int n = min(max(end - base, 0), group);  // this group's edges in the round
      const int most = __reduce_max_sync(kWarp, n);
      float dalpha = 0.f;
#pragma unroll 1
      for (int k = 0; k < most; ++k) {
        const int sk = __shfl_sync(kWarp, s, group_base + min(k, group - 1));
        const float part = k < n ? dot_share<T>(drow, h + static_cast<size_t>(sk) * F, vecs, lane, group) : 0.f;
        const float sum = group_sum(part, group);
        if (k == lane) dalpha = sum;
      }
      if (mine) {
        const float p = expf(pairs[e].x - m);
        l += p;
        u = fmaf(p, dalpha, u);
        pairs[e] = make_float2(dalpha, p);
      }
    }
    l = group_sum(l, group);
    u = group_sum(u, group);
    // l >= 1 wherever the receiver has an edge (its max scores p = 1).
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const float mean = u * inv;  // sum alpha dalpha

    // (C) (dscore, alpha) by the owners; df from g rows, read by the whole group.
    float acc[kKPerLane];
#pragma unroll
    for (int j = 0; j < kKPerLane; ++j) acc[j] = 0.f;
#pragma unroll 1
    for (int round = 0; round < rounds; ++round) {
      const int base = start + (round << group_log2);
      const int e = base + lane;
      const bool mine = e < end;
      const int s = mine ? __ldg(senders + e) : 0;
      float dscore = 0.f;
      if (mine) {
        const float2 q = pairs[e];
        const float alpha = q.y * inv;
        dscore = alpha * (q.x - mean);
        pairs[e] = make_float2(dscore, alpha);
      }
      const int n = min(max(end - base, 0), group);
      const int most = __reduce_max_sync(kWarp, n);
#pragma unroll 1
      for (int k = 0; k < most; ++k) {
        const int src = group_base + min(k, group - 1);
        const int sk = __shfl_sync(kWarp, s, src);
        const float dk = __shfl_sync(kWarp, dscore, src);
        if (k < n) {
          const T* const grow = g + static_cast<size_t>(sk) * K;
#pragma unroll
          for (int j = 0; j < kKPerLane; ++j) {
            const int c = lane + j * group;
            if (c < K) acc[j] = fmaf(dk, grl::to_float(grow[c]), acc[j]);
          }
        }
      }
    }
    if (r < N) {
#pragma unroll
      for (int j = 0; j < kKPerLane; ++j) {
        const int c = lane + j * group;
        if (c < K) store_float(df + static_cast<size_t>(r) * K + c, acc[j]);
      }
    }
  }
}

// Launch 2: dg and dh, a group per sender, over the transposed CSR.
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
attention_bwd_senders_kernel(const int* __restrict__ colptr, const int* __restrict__ t_receivers,
                             const int* __restrict__ t_edge, const float2* __restrict__ pairs,
                             const T* __restrict__ f, const T* __restrict__ dout, T* __restrict__ dg,
                             T* __restrict__ dh, int N, int K, int F, int group_log2) {
  constexpr int kElems = grl::Vec<T>::kElems;
  const int group = 1 << group_log2;
  const int lane = threadIdx.x & (group - 1);
  const int group_base = (threadIdx.x & 31) & ~(group - 1);
  const int groups = kThreads >> group_log2;
  const int stride = gridDim.x * groups;
  const int vecs = F / kElems;
  const int passes = (vecs + group - 1) >> group_log2;
  int s = blockIdx.x * groups + (threadIdx.x >> group_log2);
  const int sweeps = __reduce_max_sync(kWarp, s < N ? (N - 1 - s) / stride + 1 : 0);

#pragma unroll 1
  for (int sweep = 0; sweep < sweeps; ++sweep, s += stride) {
    int start = 0, end = 0;
    if (s < N) start = __ldg(colptr + s), end = __ldg(colptr + s + 1);
    const int rounds = __reduce_max_sync(kWarp, (end - start + group - 1) >> group_log2);

#pragma unroll 1
    for (int pass = 0; pass < passes; ++pass) {
      const int v = (pass << group_log2) + lane;  // this lane's vector of dh
      float acc[kElems], gacc[kKPerLane];
#pragma unroll
      for (int i = 0; i < kElems; ++i) acc[i] = 0.f;
#pragma unroll
      for (int j = 0; j < kKPerLane; ++j) gacc[j] = 0.f;

#pragma unroll 1
      for (int round = 0; round < rounds; ++round) {
        const int base = start + (round << group_log2);
        const int t = base + lane;
        int receiver = 0;
        float2 pair = make_float2(0.f, 0.f);
        if (t < end) {
          receiver = __ldg(t_receivers + t);
          pair = __ldg(pairs + __ldg(t_edge + t));
        }
        const int n = min(max(end - base, 0), group);
        const int most = __reduce_max_sync(kWarp, n);
#pragma unroll 1
        for (int k = 0; k < most; ++k) {
          const int src = group_base + min(k, group - 1);
          const int rk = __shfl_sync(kWarp, receiver, src);
          const float dscore = __shfl_sync(kWarp, pair.x, src);
          const float alpha = __shfl_sync(kWarp, pair.y, src);
          if (k < n) {
            if (v < vecs) {
              float x[kElems];
              grl::load16<T, kElems>(dout + static_cast<size_t>(rk) * F + v * kElems, x);
#pragma unroll
              for (int i = 0; i < kElems; ++i) acc[i] = fmaf(alpha, x[i], acc[i]);
            }
            if (pass == 0) {
              const T* const frow = f + static_cast<size_t>(rk) * K;
#pragma unroll
              for (int j = 0; j < kKPerLane; ++j) {
                const int c = lane + j * group;
                if (c < K) gacc[j] = fmaf(dscore, grl::to_float(frow[c]), gacc[j]);
              }
            }
          }
        }
      }
      if (s < N) {
        if (v < vecs) grl::store16<T, kElems>(dh + static_cast<size_t>(s) * F + v * kElems, acc);
        if (pass == 0) {
#pragma unroll
          for (int j = 0; j < kKPerLane; ++j) {
            const int c = lane + j * group;
            if (c < K) store_float(dg + static_cast<size_t>(s) * K + c, gacc[j]);
          }
        }
      }
    }
  }
}

bool bad_shape(int N, int K, int F, int group_log2, int blocks, int dtype) {
  const int elems = dtype == 0 ? 4 : 8;
  return N < 0 || K < 1 || K > (kKPerLane << group_log2) || F < elems || F % elems != 0 || group_log2 < 0 ||
         group_log2 > 5 || blocks < 1 || (dtype != 0 && dtype != 1);
}

}  // namespace

// Launch 1 of K4b on `stream` of `device`: df (N, K) and pairs (E, 2)
// float32 from the receiver-major CSR rowptr (N + 1) and senders (E).
// blocks blocks of 256 threads in groups of 2^group_log2 lanes, one
// receiver a group. dtype: 0 = float32, 1 = bfloat16; F a multiple of 16
// bytes, K at most 4 * 2^group_log2; f, g, h and dout 16-byte aligned. Does
// not synchronise, allocates nothing, returns cudaGetLastError().
extern "C" int grl_attention_bwd_receivers(const void* rowptr, const void* senders, const void* f, const void* g,
                                           const void* h, const void* dout, void* pairs, void* df, int N, int K,
                                           int F, int group_log2, int blocks, int dtype, int device,
                                           void* stream) {
  if (bad_shape(N, K, F, group_log2, blocks, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* rp = static_cast<const int*>(rowptr);
  const auto* sd = static_cast<const int*>(senders);
  auto* pr = static_cast<float2*>(pairs);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    attention_bwd_receivers_kernel<float><<<blocks, kThreads, 0, st>>>(
        rp, sd, static_cast<const float*>(f), static_cast<const float*>(g), static_cast<const float*>(h),
        static_cast<const float*>(dout), pr, static_cast<float*>(df), N, K, F, group_log2);
  } else {
    attention_bwd_receivers_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        rp, sd, static_cast<const __nv_bfloat16*>(f), static_cast<const __nv_bfloat16*>(g),
        static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(dout), pr,
        static_cast<__nv_bfloat16*>(df), N, K, F, group_log2);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch 2 of K4b: dg (N, K) and dh (N, F) from the sender-major CSR colptr
// (N + 1), t_receivers and t_edge (E) and launch 1's pairs. The same
// layout and conditions as launch 1; dout 16-byte aligned.
extern "C" int grl_attention_bwd_senders(const void* colptr, const void* t_receivers, const void* t_edge,
                                         const void* pairs, const void* f, const void* dout, void* dg, void* dh,
                                         int N, int K, int F, int group_log2, int blocks, int dtype, int device,
                                         void* stream) {
  if (bad_shape(N, K, F, group_log2, blocks, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* cp = static_cast<const int*>(colptr);
  const auto* tr = static_cast<const int*>(t_receivers);
  const auto* te = static_cast<const int*>(t_edge);
  const auto* pr = static_cast<const float2*>(pairs);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    attention_bwd_senders_kernel<float><<<blocks, kThreads, 0, st>>>(
        cp, tr, te, pr, static_cast<const float*>(f), static_cast<const float*>(dout), static_cast<float*>(dg),
        static_cast<float*>(dh), N, K, F, group_log2);
  } else {
    attention_bwd_senders_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        cp, tr, te, pr, static_cast<const __nv_bfloat16*>(f), static_cast<const __nv_bfloat16*>(dout),
        static_cast<__nv_bfloat16*>(dg), static_cast<__nv_bfloat16*>(dh), N, K, F, group_log2);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* grl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
