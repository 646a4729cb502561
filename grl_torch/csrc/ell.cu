// K6: relational aggregation over degree-bucketed ELL gather tables,
// DropEdge fused, on Hopper (sm_90a).
//
// Replaces grl_tpu/ops/ell.py:ell_aggregate and ell_aggregate_projected
// (:244-320; _gather_reduce :154-181 and the inverse-permutation stitch
// :239-240, 263-264), XLA gathers on the TPU, in all four directions:
//
//     out[perm[j], :] = sum_k w[j,k] * hash_keep(gid[j,k], seed, rate) * X[idx[j,k], :]
//
// for every bucket-concatenated table row j, with X (rows_src, F) and out
// (rows, F) both float32 or both bfloat16, accumulated in float32 registers
// and written once in X's dtype. The forward tables have rows
// receiver*L + relation and gather sender rows; the backward (dV) is the
// same kernel on the transposed tables; the projected tables gather rows
// sender*L + relation into receivers and back. The mask is hash.cuh's
// keep_edge of the edge's position in the graph's edge arrays, as in K5,
// so every walk of one graph draws one mask.
//
// Design. The tables of all buckets are raveled and concatenated; a small
// table gives each bucket's (first row, width, first cell). One launch
// walks every bucket: a group of threads owns one table row, finds its
// bucket by a binary search over the first rows (a dozen entries, cached),
// and walks the row's W cells 'group' at a time: each lane loads one cell's
// index, weight and id, and hashes it; a ballot keeps the surviving
// edges, and for each the group gathers the source row with 16-byte loads
// (lane i takes vectors i, i + group, ...). Padding cells (w == 0) and
// dropped edges cost no gather. Each term is rounded before it is added
// (no fused multiply-add), in slot order: the plain version's arithmetic,
// so K6 equals it bit for bit (the hub einsum of buckets wider than 32
// aside), and a train step through K6 equals one through the plain version.
// The group is a warp for rows of at least
// 32 16-byte vectors, else the smallest power-of-two sub-warp that covers
// the row, as in csr_spmm.cu. Each row is written once, straight to its
// output row perm[j]: the TPU's separate stitch gather (one row read and
// written per output row) becomes a 4-byte read of perm. Zero-degree rows
// (all padding) are written as zeros. No atomics: the result is the same
// from run to run. The hub buckets that grl_tpu sends to an einsum
// (W > 32) are the same sum and take the same path.
//
// What bounds it. At the arxiv shape (N = 169,343, E = 1,184,773, L = 1,
// F = 256 bf16, arithmetic widths of quantum 2: ~1.3M table cells) a call
// moves X and out once (N*F*2 bytes each), 12 bytes per table cell and 4
// per row, ~190 MB: 0.057 ms at 3.35 TB/s, against 2*E*F = 0.6 GFLOP, far
// below the bf16 ridge. The realistic floor is the gather: every kept edge
// reads a 512-byte row of X at a random sender, ~0.4 GB where X does not
// stay in the 50 MB L2. The design keeps each gather a full 16-byte-per-lane
// read of one row and everything else to one pass.

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
ell_accumulate_kernel(const int* __restrict__ idx, const float* __restrict__ weight,
                      const int* __restrict__ gid, const int* __restrict__ buckets,
                      int num_buckets, const int* __restrict__ perm, const T* __restrict__ X,
                      T* __restrict__ out, int rows, int F, int group_log2, int use_hash,
                      uint32_t seed, float keep) {
  constexpr int kElems = grl::Vec<T>::kElems;
  const int group = 1 << group_log2;
  const int lane = threadIdx.x & (group - 1);
  const int row = blockIdx.x * (kThreads >> group_log2) + (threadIdx.x >> group_log2);
  if (row >= rows) return;  // the whole group leaves together
  const int group_base = (threadIdx.x & 31) & ~(group - 1);
  const unsigned group_bits = group == 32 ? 0xffffffffu : (1u << group) - 1u;
  const unsigned mask = group_bits << group_base;

  // The row's bucket: the last one whose first row is <= row.
  int lo = 0, hi = num_buckets - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(buckets + 3 * mid) <= row) lo = mid; else hi = mid - 1;
  }
  const int width = __ldg(buckets + 3 * lo + 1);
  const int start = __ldg(buckets + 3 * lo + 2) + (row - __ldg(buckets + 3 * lo)) * width;
  const float inv_keep = 1.0f / keep;
  const int pass = group * kVecs * kElems;
  T* const orow_base = out + static_cast<size_t>(__ldg(perm + row)) * F;

  for (int f0 = 0; f0 < F; f0 += pass) {
    float acc[kVecs][kElems];
#pragma unroll
    for (int v = 0; v < kVecs; ++v)
#pragma unroll
      for (int i = 0; i < kElems; ++i) acc[v][i] = 0.f;

    for (int k0 = 0; k0 < width; k0 += group) {
      int col = 0;
      float coef = 0.f;
      if (k0 + lane < width) {
        const int e = start + k0 + lane;
        coef = weight[e];
        if (coef != 0.f) {
          col = idx[e];
          if (use_hash)
            coef = grl::keep_edge(static_cast<uint32_t>(gid[e]), seed, keep) ? inv_keep * coef : 0.f;
        }
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
            for (int i = 0; i < kElems; ++i) acc[v][i] = __fadd_rn(acc[v][i], __fmul_rn(c, x[i]));
          }
        }
      }
    }

    T* orow = orow_base + f0;
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const int j = (v * group + lane) * kElems;
      if (f0 + j < F) grl::store16(orow + j, acc[v]);
    }
  }
}

inline unsigned cdiv(long long a, long long b) { return static_cast<unsigned>((a + b - 1) / b); }

template <typename T>
int launch(const int* idx, const float* weight, const int* gid, const int* buckets,
           int num_buckets, const int* perm, const void* X, void* out, int rows, int F,
           int use_hash, uint32_t seed, float keep, cudaStream_t stream) {
  constexpr int kElems = grl::Vec<T>::kElems;
  if (F % kElems != 0 || num_buckets < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int nvec = F / kElems;
  int group_log2 = 0;
  while ((1 << group_log2) < nvec && group_log2 < 5) ++group_log2;
  const int group = 1 << group_log2;
  const int per_lane = (nvec + group - 1) / group;
  const dim3 grid(cdiv(rows, kThreads >> group_log2));
  const T* x = static_cast<const T*>(X);
  T* o = static_cast<T*>(out);
  if (per_lane <= 1)
    ell_accumulate_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
        idx, weight, gid, buckets, num_buckets, perm, x, o, rows, F, group_log2, use_hash, seed, keep);
  else if (per_lane <= 2)
    ell_accumulate_kernel<T, 2><<<grid, kThreads, 0, stream>>>(
        idx, weight, gid, buckets, num_buckets, perm, x, o, rows, F, group_log2, use_hash, seed, keep);
  else
    ell_accumulate_kernel<T, 4><<<grid, kThreads, 0, stream>>>(
        idx, weight, gid, buckets, num_buckets, perm, x, o, rows, F, group_log2, use_hash, seed, keep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K6 on `stream` of `device`, does not synchronise, allocates
// nothing, and returns cudaGetLastError(). buckets: int32 (num_buckets, 3)
// = (first row, width, first cell), first rows increasing from 0; perm:
// int32 (rows,), a permutation of the output rows. dtype: 0 = float32,
// 1 = bfloat16; F a multiple of 8; X and out 16-byte aligned.
extern "C" int grl_ell_accumulate(const void* idx, const void* weight, const void* gid,
                                  const void* buckets, const void* perm, const void* X,
                                  void* out, int num_buckets, int rows, int F, int dtype,
                                  int use_hash, uint32_t seed, float keep, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int* i = static_cast<const int*>(idx);
  const float* w = static_cast<const float*>(weight);
  const int* g = static_cast<const int*>(gid);
  const int* b = static_cast<const int*>(buckets);
  const int* p = static_cast<const int*>(perm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(i, w, g, b, num_buckets, p, X, out, rows, F, use_hash, seed, keep, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(i, w, g, b, num_buckets, p, X, out, rows, F, use_hash, seed, keep, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* grl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
