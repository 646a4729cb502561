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
// plain CSR, and the columns are cut into slices (the wrapper's plan,
// grl_torch/ops/sparse.py:gather_slices): each output column depends on
// the same input column alone, so the grid is (row blocks, slices), one
// wave of blocks a slice, and the card walks every row of slice s before
// those of slice s + 1. One group of threads owns one (row, slice): a warp
// for slices of at least 32 16-byte vectors, else the smallest
// power-of-two sub-warp that covers the slice (16 lanes for a 256-byte
// slice row). A group walks rows a grid row apart, the next row's bounds
// and first edges loaded while it gathers, and walks a row's edge list
// 'group' edges at a time: each lane loads one edge's column, weight and
// id and hashes it; a ballot keeps the surviving edges, and the group
// gathers their slice rows kBatch edges at a time, every load of a batch
// issued before its products are summed (lane i takes vectors i,
// i + group, ...). Dropped edges cost no gather. The groups of a warp run
// their loops in step (as often as the longest needs), so that a warp of
// several groups does not split into serial paths. The sums are fmaf in
// edge order whatever the slicing, so the bits do not depend on the plan.
// The slice row is written once; rows with no edge write zeros. No
// atomics, so the result is the same from run to run, and no scratch in
// device memory.
//
// What bounds it. At the full-graph slice's shape (N = 169,343 nodes,
// E = 1,184,773 edges, L = 1, F = 256 bf16) one call moves V and out once
// (N*F*2 bytes each) and 12 bytes of metadata per edge, ~188 MB: 0.056 ms
// at 3.35 TB/s, against ~2*E*F = 0.6 GFLOP, far below the bf16 ridge.
// Every kept edge gathers a row of V at a random sender, ~0.42 GB, which
// has to come from HBM if V (87 MB) does not stay in the 50 MB L2. The
// slices bound the live part of V to a share of the L2 (128 bf16 columns
// of every row, 43 MB), so most bytes of V come from HBM once and most
// gathers hit L2; the gathers carry an evict_last policy and the metadata
// loads and output stores stream (ld/st .cs) so that they do not push the
// slice out. L2 hits are not free: on an H100 this walk gathers from an
// L2-resident V at about 4 TB/s (PERF.md), so the gathers from L2, not
// the bytes moved once, are its floor. Each slice walks the rows again
// (metadata read and hashed, 14 MB, and a row's chain of dependent loads
// once more), which is why narrower slices, whose V stays in L2 whole,
// lose: 64-column slices cost more than their hits save.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hash.cuh"
#include "vec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kWarp = 0xffffffffu;
// Kept edges whose slice rows are loaded before any of their products is
// summed: the loads in flight per lane.
constexpr int kBatch = 4;

// Lane i's edge of one round of 'group' edges (start + i), if it is in the
// row: loaded raw, hashed where it is used.
struct Round {
  int col = 0;
  float w = 0.f;
  uint32_t gid = 0;
};

__device__ __forceinline__ Round load_round(const int* __restrict__ cols, const float* __restrict__ weights,
                                            const int* __restrict__ gids, int e, int end, int use_hash) {
  Round m;
  if (e < end) {
    m.col = __ldcs(cols + e);
    m.w = __ldcs(weights + e);
    if (use_hash) m.gid = static_cast<uint32_t>(__ldcs(gids + e));
  }
  return m;
}

// kVecs: 16-byte vectors a lane holds per pass over the slice; slices
// wider than group * kVecs vectors take several passes. A group walks rows
// row, row + stride, ... (stride: the groups of one grid row), with the
// next row's bounds and first round of edges loaded a row ahead. Every
// loop runs as often in every group of a warp (the most any of them needs,
// the others idle through the rest), so the groups of a warp never diverge
// into paths that run one after the other, and the shuffles take every lane.
template <typename T, int kVecs>
__global__ void __launch_bounds__(kThreads)
csr_accumulate_kernel(const int* __restrict__ rowptr, const int* __restrict__ cols,
                      const int* __restrict__ gids, const float* __restrict__ weights,
                      const T* __restrict__ X, T* __restrict__ out, int rows, int F,
                      int col0, int slice_cols, int group_log2, int use_hash, uint32_t seed,
                      float keep) {
  constexpr int kElems = grl::Vec<T>::kElems;
  const int group = 1 << group_log2;
  const int lane = threadIdx.x & (group - 1);
  const int group_base = (threadIdx.x & 31) & ~(group - 1);
  const unsigned group_bits = group == 32 ? kWarp : (1u << group) - 1u;
  const int stride = gridDim.x * (kThreads >> group_log2);
  int row = blockIdx.x * (kThreads >> group_log2) + (threadIdx.x >> group_log2);
  const int sweeps = __reduce_max_sync(kWarp, row < rows ? (rows - 1 - row) / stride + 1 : 0);
  const int slice_begin = col0 + blockIdx.y * slice_cols;
  const int slice_end = min(F, slice_begin + slice_cols);
  const float inv_keep = 1.0f / keep;
  const int pass = group * kVecs * kElems;
  const uint64_t policy = grl::l2_evict_last();

  // Rows past the end have no edge and write nothing.
  int start = 0, end = 0, next_start = 0, next_end = 0;
  if (row < rows) start = __ldg(rowptr + row), end = __ldg(rowptr + row + 1);
  if (row + stride < rows) next_start = __ldg(rowptr + row + stride), next_end = __ldg(rowptr + row + stride + 1);
  Round first = load_round(cols, weights, gids, start + lane, end, use_hash);

  for (int sweep = 0; sweep < sweeps; ++sweep, row += stride) {
    // A row ahead: the next row's first round, the bounds of the one after.
    const Round next_first = load_round(cols, weights, gids, next_start + lane, next_end, use_hash);
    int after_start = 0, after_end = 0;
    if (row + 2 * stride < rows)
      after_start = __ldg(rowptr + row + 2 * stride), after_end = __ldg(rowptr + row + 2 * stride + 1);
    const int rounds = __reduce_max_sync(kWarp, (end - start + group - 1) >> group_log2);

    for (int f0 = slice_begin; f0 < slice_end; f0 += pass) {
      float acc[kVecs][kElems];
#pragma unroll
      for (int v = 0; v < kVecs; ++v)
#pragma unroll
        for (int i = 0; i < kElems; ++i) acc[v][i] = 0.f;

      for (int r = 0; r < rounds; ++r) {
        const Round m = r == 0 ? first : load_round(cols, weights, gids, start + (r << group_log2) + lane, end,
                                                    use_hash);
        float coef = m.w;
        if (use_hash && coef != 0.f) coef = grl::keep_edge(m.gid, seed, keep) ? inv_keep * coef : 0.f;
        unsigned kept = (__ballot_sync(kWarp, coef != 0.f) >> group_base) & group_bits;
        const int most = __reduce_max_sync(kWarp, __popc(kept));
        for (int b = 0; b < most; b += kBatch) {
          // The group's next kBatch kept edges in edge order (c = 0 past its last).
          int src[kBatch];
          float c[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int k = kept ? __ffs(kept) - 1 : 0;
            const bool valid = kept != 0;
            kept &= kept - 1;
            src[u] = __shfl_sync(kWarp, m.col, group_base + k);
            const float ck = __shfl_sync(kWarp, coef, group_base + k);
            c[u] = valid ? ck : 0.f;
          }
          uint4 raw[kBatch][kVecs];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const T* xrow = X + static_cast<size_t>(src[u]) * F;
#pragma unroll
            for (int v = 0; v < kVecs; ++v) {
              const int j = f0 + (v * group + lane) * kElems;
              if (c[u] != 0.f && j < slice_end) raw[u][v] = grl::load16_hint(xrow + j, policy);
            }
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
#pragma unroll
            for (int v = 0; v < kVecs; ++v) {
              const int j = f0 + (v * group + lane) * kElems;
              if (c[u] != 0.f && j < slice_end) {
                float x[kElems];
                grl::unpack16(raw[u][v], x);
#pragma unroll
                for (int i = 0; i < kElems; ++i) acc[v][i] = fmaf(c[u], x[i], acc[v][i]);
              }
            }
          }
        }
      }

      T* const orow = out + static_cast<size_t>(row) * F;
#pragma unroll
      for (int v = 0; v < kVecs; ++v) {
        const int j = f0 + (v * group + lane) * kElems;
        if (row < rows && j < slice_end) grl::store16_stream(orow + j, acc[v]);
      }
    }
    start = next_start, end = next_end, first = next_first;
    next_start = after_start, next_end = after_end;
  }
}

inline unsigned cdiv(long long a, long long b) { return static_cast<unsigned>((a + b - 1) / b); }

// Blocks of `kernel` the card holds at once (one grid row of the launch).
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int device, unsigned* blocks) {
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && per_sm * sms < 1) err = cudaErrorInvalidConfiguration;
  *blocks = static_cast<unsigned>(per_sm * sms);
  return err;
}

template <typename T, int kVecs>
int launch_with(const int* rowptr, const int* cols, const int* gids, const float* weights, const T* x,
                T* o, int rows, int F, int col0, int slice_cols, int num_slices, int group_log2,
                int use_hash, uint32_t seed, float keep, int device, cudaStream_t stream) {
  unsigned resident = 0;
  const cudaError_t err = resident_blocks(csr_accumulate_kernel<T, kVecs>, device, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned needed = cdiv(rows, kThreads >> group_log2);
  // A grid row of at most one wave, so that the rows of slice s are all
  // walked before those of slice s + 1 start, and each group walks several
  // rows, loading the next while it gathers.
  const dim3 grid(min(needed, resident), num_slices);
  csr_accumulate_kernel<T, kVecs><<<grid, kThreads, 0, stream>>>(
      rowptr, cols, gids, weights, x, o, rows, F, col0, slice_cols, group_log2, use_hash, seed, keep);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const int* rowptr, const int* cols, const int* gids, const float* weights,
           const void* X, void* out, int rows, int F, int col0, int slice_cols, int num_slices,
           int use_hash, uint32_t seed, float keep, int device, cudaStream_t stream) {
  constexpr int kElems = grl::Vec<T>::kElems;
  if (F % kElems != 0 || col0 < 0 || col0 % kElems != 0 || slice_cols <= 0 ||
      slice_cols % kElems != 0 || num_slices < 1 || num_slices > 65535 ||
      col0 + static_cast<long long>(num_slices - 1) * slice_cols >= F)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nvec = slice_cols / kElems;
  int group_log2 = 0;
  while ((1 << group_log2) < nvec && group_log2 < 5) ++group_log2;
  const int group = 1 << group_log2;
  const int per_lane = (nvec + group - 1) / group;
  const T* x = static_cast<const T*>(X);
  T* o = static_cast<T*>(out);
  if (per_lane <= 1)
    return launch_with<T, 1>(rowptr, cols, gids, weights, x, o, rows, F, col0, slice_cols, num_slices,
                             group_log2, use_hash, seed, keep, device, stream);
  if (per_lane <= 2)
    return launch_with<T, 2>(rowptr, cols, gids, weights, x, o, rows, F, col0, slice_cols, num_slices,
                             group_log2, use_hash, seed, keep, device, stream);
  return launch_with<T, 4>(rowptr, cols, gids, weights, x, o, rows, F, col0, slice_cols, num_slices,
                           group_log2, use_hash, seed, keep, device, stream);
}

}  // namespace

// Launches K5 on `stream` of `device`, does not synchronise, allocates
// nothing, and returns cudaGetLastError(). Columns [col0, F) are walked
// in num_slices slices of slice_cols columns, the last one clipped at F
// (grid row s: the slice from col0 + s * slice_cols); columns outside them
// are not written. dtype: 0 = float32, 1 = bfloat16; F, col0 and
// slice_cols multiples of 16 bytes; X and out 16-byte aligned.
extern "C" int grl_csr_accumulate(const void* rowptr, const void* cols, const void* gids,
                                  const void* weights, const void* X, void* out, int rows,
                                  int F, int col0, int slice_cols, int num_slices, int dtype,
                                  int use_hash, uint32_t seed, float keep, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int* rp = static_cast<const int*>(rowptr);
  const int* c = static_cast<const int*>(cols);
  const int* g = static_cast<const int*>(gids);
  const float* w = static_cast<const float*>(weights);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(rp, c, g, w, X, out, rows, F, col0, slice_cols, num_slices, use_hash, seed,
                         keep, device, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(rp, c, g, w, X, out, rows, F, col0, slice_cols, num_slices, use_hash,
                                 seed, keep, device, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* grl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
