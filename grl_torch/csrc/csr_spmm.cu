// K5: sparse relational aggregation over a CSR layout, DropEdge fused, on
// Hopper (sm_90a).
//
// Replaces grl_tpu/ops/pallas/csr_spmm.py:csr_accumulate (the pallas_call
// at :300, kernel _make_kernel :216-271), forward and backward:
//
//     out[r, :] = sum_{e in row r} w[e] * hash_keep(gid[e], seed, rate) * X[col[e], :]
//
// with X (rows_src, F) and out (rows, F) both float32 or both bfloat16,
// accumulated in float32 registers and written once in X's dtype. The
// forward layout has rows receiver*L + relation and gathers sender rows of
// V; the backward (dV) is the same kernel on the transposed layout, whose
// rows are senders and which gathers rows receiver*L + relation of the
// cotangent. The mask is hash.cuh's keep_edge of the edge's position in the
// graph's edge arrays, so both walks see one mask, and a kept edge carries
// w / keep (csr_spmm.py:_hash_keep, bit for bit).
//
// Design. The TPU kernel buckets edges into (receiver block, sender chunk)
// cells that fit VMEM and walks them on the scalar core, accumulating into
// a VMEM scratch across its sequential chunk axis. Here the layout is
// plain CSR and one group of threads owns one output row: a warp for rows
// of at least 32 16-byte vectors, else the smallest power-of-two sub-warp
// that covers the row. The group walks its row's edge list 'group' edges at
// a time: each lane loads one edge's column, weight and id and hashes it;
// a ballot keeps the surviving edges, and for each of them the group
// gathers the source row with 16-byte loads (lane i takes vectors i,
// i + group, ...) and accumulates in registers. Dropped edges cost no
// gather. The row is written once; rows with no edge write zeros. No
// atomics, so the result is the same from run to run, and no scratch in
// device memory.
//
// What bounds it. At the full-graph slice's shape (N = 169,343 nodes,
// E = 1,184,773 edges, L = 1, F = 256 bf16) one call moves V and out once
// (N*F*2 bytes each) and 12 bytes of metadata per edge, ~188 MB: 0.056 ms
// at 3.35 TB/s, against ~2*E*F = 0.6 GFLOP, far below the bf16 ridge.
// The realistic floor is the gather: every edge reads a 512-byte row of V
// at a random sender, E*F*2 = 0.6 GB if V does not stay in the 50 MB L2.
// The design keeps each gather a full 16-byte-per-lane coalesced read of
// one row and keeps everything else to one pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hash.cuh"
#include "vec.cuh"

namespace {

constexpr int kThreads = 256;

// kVecs: 16-byte vectors a lane holds per pass over the row's features;
// rows wider than group * kVecs vectors take several passes.
template <typename T, int kVecs>
__global__ void __launch_bounds__(kThreads)
csr_accumulate_kernel(const int* __restrict__ rowptr, const int* __restrict__ cols,
                      const int* __restrict__ gids, const float* __restrict__ weights,
                      const T* __restrict__ X, T* __restrict__ out, int rows, int F,
                      int group_log2, int use_hash, uint32_t seed, float keep) {
  constexpr int kElems = grl::Vec<T>::kElems;
  const int group = 1 << group_log2;
  const int lane = threadIdx.x & (group - 1);
  const int row = blockIdx.x * (kThreads >> group_log2) + (threadIdx.x >> group_log2);
  if (row >= rows) return;  // the whole group leaves together
  const int group_base = (threadIdx.x & 31) & ~(group - 1);
  const unsigned group_bits = group == 32 ? 0xffffffffu : (1u << group) - 1u;
  const unsigned mask = group_bits << group_base;
  const int start = rowptr[row];
  const int end = rowptr[row + 1];
  const float inv_keep = 1.0f / keep;
  const int pass = group * kVecs * kElems;

  for (int f0 = 0; f0 < F; f0 += pass) {
    float acc[kVecs][kElems];
#pragma unroll
    for (int v = 0; v < kVecs; ++v)
#pragma unroll
      for (int i = 0; i < kElems; ++i) acc[v][i] = 0.f;

    for (int base = start; base < end; base += group) {
      const int e = base + lane;
      int col = 0;
      float coef = 0.f;
      if (e < end) {
        col = cols[e];
        coef = weights[e];
        if (use_hash)
          coef = grl::keep_edge(static_cast<uint32_t>(gids[e]), seed, keep) ? inv_keep * coef : 0.f;
      }
      unsigned kept = (__ballot_sync(mask, coef != 0.f) >> group_base) & group_bits;
      while (kept) {
        const int k = __ffs(kept) - 1;
        kept &= kept - 1;
        const int src = __shfl_sync(mask, col, k, group);
        const float c = __shfl_sync(mask, coef, k, group);
        const T* xrow = X + static_cast<size_t>(src) * F + f0;
#pragma unroll
        for (int v = 0; v < kVecs; ++v) {
          const int j = (v * group + lane) * kElems;
          if (f0 + j < F) {
            float x[kElems];
            grl::load16(xrow + j, x);
#pragma unroll
            for (int i = 0; i < kElems; ++i) acc[v][i] = fmaf(c, x[i], acc[v][i]);
          }
        }
      }
    }

    T* orow = out + static_cast<size_t>(row) * F + f0;
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const int j = (v * group + lane) * kElems;
      if (f0 + j < F) grl::store16(orow + j, acc[v]);
    }
  }
}

inline unsigned cdiv(long long a, long long b) { return static_cast<unsigned>((a + b - 1) / b); }

template <typename T>
int launch(const int* rowptr, const int* cols, const int* gids, const float* weights,
           const void* X, void* out, int rows, int F, int use_hash, uint32_t seed,
           float keep, cudaStream_t stream) {
  constexpr int kElems = grl::Vec<T>::kElems;
  if (F % kElems != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nvec = F / kElems;
  int group_log2 = 0;
  while ((1 << group_log2) < nvec && group_log2 < 5) ++group_log2;
  const int group = 1 << group_log2;
  const int per_lane = (nvec + group - 1) / group;
  const dim3 grid(cdiv(rows, kThreads >> group_log2));
  const T* x = static_cast<const T*>(X);
  T* o = static_cast<T*>(out);
  if (per_lane <= 1)
    csr_accumulate_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
        rowptr, cols, gids, weights, x, o, rows, F, group_log2, use_hash, seed, keep);
  else if (per_lane <= 2)
    csr_accumulate_kernel<T, 2><<<grid, kThreads, 0, stream>>>(
        rowptr, cols, gids, weights, x, o, rows, F, group_log2, use_hash, seed, keep);
  else
    csr_accumulate_kernel<T, 4><<<grid, kThreads, 0, stream>>>(
        rowptr, cols, gids, weights, x, o, rows, F, group_log2, use_hash, seed, keep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K5 on `stream` of `device`, does not synchronise, allocates
// nothing, and returns cudaGetLastError(). dtype: 0 = float32,
// 1 = bfloat16; F a multiple of 8; X and out 16-byte aligned.
extern "C" int grl_csr_accumulate(const void* rowptr, const void* cols, const void* gids,
                                  const void* weights, const void* X, void* out, int rows,
                                  int F, int dtype, int use_hash, uint32_t seed, float keep,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int* rp = static_cast<const int*>(rowptr);
  const int* c = static_cast<const int*>(cols);
  const int* g = static_cast<const int*>(gids);
  const float* w = static_cast<const float*>(weights);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(rp, c, g, w, X, out, rows, F, use_hash, seed, keep, s);
  if (dtype == 1) return launch<__nv_bfloat16>(rp, c, g, w, X, out, rows, F, use_hash, seed, keep, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* grl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
