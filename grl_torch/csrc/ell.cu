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
// walks every bucket, and the columns are cut into slices (the wrapper's
// plan, grl_torch/ops/sparse.py:gather_slices, shared with csr_spmm.cu):
// each output column depends on the same input column alone, so the grid
// is (row blocks, slices), one wave of blocks a slice, and the card walks
// every row of slice s before those of slice s + 1. A group of threads
// owns one (table row, slice): a warp for slices of at least 32 16-byte
// vectors, else the smallest power-of-two sub-warp that covers the slice
// (16 lanes for a 256-byte slice row), as in csr_spmm.cu. A group walks
// rows a grid row apart, the next row's span (its bucket, by a binary
// search over the first rows, a dozen cached entries), output row and
// first cells loaded while it gathers, and walks a row's W cells 'group'
// at a time: each lane loads one cell's index, weight and id, and hashes
// it; a ballot keeps the surviving edges, and the group gathers their
// slice rows kBatch edges at a time, every load of a batch issued before
// its terms are added (lane i takes vectors i, i + group, ...). Padding
// cells (w == 0) and dropped edges cost no gather. The groups of a warp
// run their loops in step (as often as the longest needs), so that a warp
// of several groups does not split into serial paths. Each term is
// rounded before it is added (no fused multiply-add), in slot order: the
// plain version's arithmetic, so K6 equals it bit for bit at every
// slicing (the hub einsum of buckets wider than 32 aside), and a train
// step through K6 equals one through the plain version. Each slice row is
// written once, straight to its output row perm[j]: the TPU's separate
// stitch gather (one row read and written per output row) becomes a
// 4-byte read of perm. Zero-degree rows (all padding) are written as
// zeros. No atomics: the result is the same from run to run. The hub
// buckets that grl_tpu sends to an einsum (W > 32) are the same sum and
// take the same path.
//
// What bounds it. At the arxiv shape (N = 169,343, E = 1,184,773, L = 1,
// F = 256 bf16, arithmetic widths of quantum 2: ~1.3M table cells) a call
// moves X and out once (N*F*2 bytes each), 12 bytes per table cell and 4
// per row, ~190 MB: 0.057 ms at 3.35 TB/s, against 2*E*F = 0.6 GFLOP, far
// below the bf16 ridge. Every kept edge gathers a row of X at a random
// sender, ~0.42 GB, which has to come from HBM if X (87 MB) does not stay
// in the 50 MB L2. The slices bound the live part of X to a share of the
// L2 (128 bf16 columns of every row, 43 MB), so most bytes of X come from
// HBM once and most gathers hit L2; the gathers carry an evict_last policy
// and the table loads and output stores stream (ld/st .cs) so that they
// do not push the slice out. As in csr_spmm.cu, the gathers from L2 (about
// 4 TB/s on an H100) are the floor, and each slice walks the rows again:
// the tables, ~16 MB, read and hashed once a slice.

#include <atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hash.cuh"
#include "vec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kWarp = 0xffffffffu;
// Kept edges whose slice rows are loaded before any of their terms is
// added: the loads in flight per lane.
constexpr int kBatch = 4;

// Lane i's cell of one round of 'group' cells of a row, if it is in the
// row: loaded raw, hashed where it is used.
struct Round {
  int col = 0;
  float w = 0.f;
  uint32_t gid = 0;
};

__device__ __forceinline__ Round load_round(const int* __restrict__ idx, const float* __restrict__ weight,
                                            const int* __restrict__ gid, int e, bool in_row, int use_hash) {
  Round m;
  if (in_row) {
    m.col = __ldcs(idx + e);
    m.w = __ldcs(weight + e);
    if (use_hash) m.gid = static_cast<uint32_t>(__ldcs(gid + e));
  }
  return m;
}

// Table row `row`'s first cell and width: its bucket is the last one whose
// first row is <= row (a binary search over a dozen cached entries). Rows
// past the end have width 0.
struct Span {
  int start = 0;
  int width = 0;
  int dest = 0;  // the output row, perm[row]
};

__device__ __forceinline__ Span row_span(const int* __restrict__ buckets, int num_buckets,
                                         const int* __restrict__ perm, int row, int rows) {
  Span span;
  if (row >= rows) return span;
  int lo = 0, hi = num_buckets - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(buckets + 3 * mid) <= row) lo = mid; else hi = mid - 1;
  }
  span.width = __ldg(buckets + 3 * lo + 1);
  span.start = __ldg(buckets + 3 * lo + 2) + (row - __ldg(buckets + 3 * lo)) * span.width;
  span.dest = __ldcs(perm + row);
  return span;
}

// kVecs: 16-byte vectors a lane holds per pass over the slice; slices
// wider than group * kVecs vectors take several passes. A group walks rows
// row, row + stride, ... (stride: the groups of one grid row), with the
// next row's span and first round of cells loaded a row ahead. Every loop
// runs as often in every group of a warp (the most any of them needs, the
// others idle through the rest), so the groups of a warp never diverge
// into paths that run one after the other, and the shuffles take every lane.
template <typename T, int kVecs>
__global__ void __launch_bounds__(kThreads)
ell_accumulate_kernel(const int* __restrict__ idx, const float* __restrict__ weight,
                      const int* __restrict__ gid, const int* __restrict__ buckets,
                      int num_buckets, const int* __restrict__ perm, const T* __restrict__ X,
                      T* __restrict__ out, int rows, int F, int col0, int slice_cols,
                      int group_log2, int use_hash, const uint32_t* __restrict__ seed_ptr, float keep) {
  const uint32_t seed = use_hash ? __ldg(seed_ptr) : 0u;  // the mask's seed, in device memory
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

  Span span = row_span(buckets, num_buckets, perm, row, rows);
  Span next = row_span(buckets, num_buckets, perm, row + stride, rows);
  Round first = load_round(idx, weight, gid, span.start + lane, lane < span.width, use_hash);

  for (int sweep = 0; sweep < sweeps; ++sweep, row += stride) {
    // A row ahead: the next row's first round, the span of the one after.
    const Round next_first = load_round(idx, weight, gid, next.start + lane, lane < next.width, use_hash);
    const Span after = row_span(buckets, num_buckets, perm, row + 2 * stride, rows);
    const int rounds = __reduce_max_sync(kWarp, (span.width + group - 1) >> group_log2);

    for (int f0 = slice_begin; f0 < slice_end; f0 += pass) {
      float acc[kVecs][kElems];
#pragma unroll
      for (int v = 0; v < kVecs; ++v)
#pragma unroll
        for (int i = 0; i < kElems; ++i) acc[v][i] = 0.f;

      for (int r = 0; r < rounds; ++r) {
        const int k0 = r << group_log2;
        const Round m = r == 0 ? first : load_round(idx, weight, gid, span.start + k0 + lane,
                                                    k0 + lane < span.width, use_hash);
        float coef = m.w;
        if (use_hash && coef != 0.f) coef = grl::keep_edge(m.gid, seed, keep) ? inv_keep * coef : 0.f;
        unsigned kept = (__ballot_sync(kWarp, coef != 0.f) >> group_base) & group_bits;
        const int most = __reduce_max_sync(kWarp, __popc(kept));
        for (int b = 0; b < most; b += kBatch) {
          // The group's next kBatch kept edges in slot order (c = 0 past its last).
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
                for (int i = 0; i < kElems; ++i)
                  acc[v][i] = __fadd_rn(acc[v][i], __fmul_rn(c[u], x[i]));
              }
            }
          }
        }
      }

      T* const orow = out + static_cast<size_t>(span.dest) * F;
#pragma unroll
      for (int v = 0; v < kVecs; ++v) {
        const int j = f0 + (v * group + lane) * kElems;
        if (row < rows && j < slice_end) grl::store16_stream(orow + j, acc[v]);
      }
    }
    span = next, next = after, first = next_first;
  }
}

inline unsigned cdiv(long long a, long long b) { return static_cast<unsigned>((a + b - 1) / b); }

// Blocks of kKernel the card holds at once (one grid row of the launch),
// asked of the runtime at the kernel's first launch on each device and kept:
// later launches, and those captured into a CUDA graph, make no query.
template <auto kKernel>
cudaError_t resident_blocks(int device, unsigned* blocks) {
  static std::atomic<unsigned> cached[64] = {};
  const bool cacheable = device >= 0 && device < 64;
  if (cacheable && (*blocks = cached[device].load(std::memory_order_acquire)) != 0) return cudaSuccess;
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKernel, kThreads, 0);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && per_sm * sms < 1) err = cudaErrorInvalidConfiguration;
  *blocks = static_cast<unsigned>(per_sm * sms);
  if (err == cudaSuccess && cacheable) cached[device].store(*blocks, std::memory_order_release);
  return err;
}

template <typename T, int kVecs>
int launch_with(const int* idx, const float* weight, const int* gid, const int* buckets, int num_buckets,
                const int* perm, const T* x, T* o, int rows, int F, int col0, int slice_cols,
                int num_slices, int group_log2, int use_hash, const uint32_t* seed, float keep, int device,
                cudaStream_t stream) {
  unsigned resident = 0;
  const cudaError_t err = resident_blocks<ell_accumulate_kernel<T, kVecs>>(device, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  // A grid row of at most one wave, so that the rows of slice s are all
  // walked before those of slice s + 1 start, and each group walks several
  // rows, loading the next while it gathers.
  const dim3 grid(min(cdiv(rows, kThreads >> group_log2), resident), num_slices);
  ell_accumulate_kernel<T, kVecs><<<grid, kThreads, 0, stream>>>(
      idx, weight, gid, buckets, num_buckets, perm, x, o, rows, F, col0, slice_cols, group_log2, use_hash,
      seed, keep);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const int* idx, const float* weight, const int* gid, const int* buckets,
           int num_buckets, const int* perm, const void* X, void* out, int rows, int F, int col0,
           int slice_cols, int num_slices, int use_hash, const uint32_t* seed, float keep, int device,
           cudaStream_t stream) {
  constexpr int kElems = grl::Vec<T>::kElems;
  if (F % kElems != 0 || num_buckets < 1 || col0 < 0 || col0 % kElems != 0 || slice_cols <= 0 ||
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
    return launch_with<T, 1>(idx, weight, gid, buckets, num_buckets, perm, x, o, rows, F, col0, slice_cols,
                             num_slices, group_log2, use_hash, seed, keep, device, stream);
  if (per_lane <= 2)
    return launch_with<T, 2>(idx, weight, gid, buckets, num_buckets, perm, x, o, rows, F, col0, slice_cols,
                             num_slices, group_log2, use_hash, seed, keep, device, stream);
  return launch_with<T, 4>(idx, weight, gid, buckets, num_buckets, perm, x, o, rows, F, col0, slice_cols,
                           num_slices, group_log2, use_hash, seed, keep, device, stream);
}

}  // namespace

// Launches K6 on `stream` of `device`, does not synchronise, allocates
// nothing, and returns cudaGetLastError(). buckets: int32 (num_buckets, 3)
// = (first row, width, first cell), first rows increasing from 0; perm:
// int32 (rows,), a permutation of the output rows. Columns [col0, F) are
// walked in num_slices slices of slice_cols columns, the last one clipped
// at F (grid row s: the slice from col0 + s * slice_cols); columns outside
// them are not written. dtype: 0 = float32, 1 = bfloat16; F, col0 and
// slice_cols multiples of 16 bytes; X and out 16-byte aligned. seed
// points at the mask's seed in device memory (one uint32), read only
// where use_hash is set.
extern "C" int grl_ell_accumulate(const void* idx, const void* weight, const void* gid,
                                  const void* buckets, const void* perm, const void* X,
                                  void* out, int num_buckets, int rows, int F, int col0,
                                  int slice_cols, int num_slices, int dtype, int use_hash,
                                  const uint32_t* seed, float keep, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int* i = static_cast<const int*>(idx);
  const float* w = static_cast<const float*>(weight);
  const int* g = static_cast<const int*>(gid);
  const int* b = static_cast<const int*>(buckets);
  const int* p = static_cast<const int*>(perm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(i, w, g, b, num_buckets, p, X, out, rows, F, col0, slice_cols, num_slices,
                         use_hash, seed, keep, device, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(i, w, g, b, num_buckets, p, X, out, rows, F, col0, slice_cols,
                                 num_slices, use_hash, seed, keep, device, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* grl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
