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
// must fit VMEM. Here one launch covers every degree, hubs and isolated
// receivers included, and gathers the rows itself. A group of G lanes
// (G: the 16-byte vectors of an h slice row, a power of two up to 32; the
// wrapper's plan, grl_torch/ops/sparse_attention.py:attention_launch)
// owns one receiver. Where h and g do not fit the L2 together, but a slice
// of h of 256-byte rows and g stay within twice the L2, the columns of h
// are cut into slices (sparse.py:gather_slices, widened to such rows): the
// grid is
// (receiver blocks, slices), one wave of blocks a slice, so the card walks
// every receiver of slice s before those of slice s + 1, and every slice
// scores its receivers again from g, so nothing per edge is written. A
// group walks receivers a grid row apart, the next one's first senders
// and the bounds of the one after loaded while it works on the current
// one. For each round of G edges, the group first copies the h slice rows
// of its first kStages = 4 edges (cp.async, 16 bytes a lane) into a ring
// of 4 stages that each lane keeps in shared memory, then scores the round
// while they arrive: each lane one edge (f . g in float32, k in order),
// the round's max by xor shuffles inside the group, folded into an online
// softmax (running max m; the sum l and the accumulator are rescaled by
// exp(m_old - m_new) when it grows), so a receiver of degree <= G takes
// its exact max in one round and a hub folds round by round. Then it
// reads the ring edge by edge in edge order, accumulating p * h and
// l += p in float32 registers, and refills each stage with the row 4
// edges further on as soon as it has read it. The rows in flight take
// shared memory, not registers, so a lane needs at most 64 registers and
// an SM holds 4 blocks. The row is written once as acc * (1 / l). The
// loops run in step across the warp (as often as its longest group
// needs), so a warp of several groups does not split into serial paths,
// and every shuffle takes every lane. No atomics, and the arithmetic
// depends on G alone: every slice walks the same edges in the same rounds,
// so two launches and any slicing at the same G give the same bits.
// g loads carry an L2 evict_last policy; rowptr, senders and f load, and
// out stores, streaming (.cs). The h copies carry no policy (see
// copy16_async).
//
// What bounds it. At the full-graph slice's shape (N = 169,343,
// E = 1,184,773, K = 16, F = 128, bf16) one call reads f, g and h once,
// the CSR (row pointers and senders) once, and writes out once: ~103 MB,
// 0.031 ms at 3.35 TB/s, against ~E*(2K + 2F) = 0.34 GFLOP, below the
// ridge. The gathers are the realistic floor: E rows of g (32 bytes) and
// of h (256 bytes) at random senders, 0.34 GB, plus g once more for every
// slice after the first: at the ~4.6 TB/s that gathers from L2 reach on an
// H100, ~0.074 ms. h and g (48.8 MB) nearly fit the 50 MB L2 here, and
// h rows are 256 bytes, so one slice. With h and g folded onto rows that
// surely stay in L2 (grl_torch/probes/attention.py) the walk takes within
// 5% of its time on the real graph (PERF.md): in bf16 this walk is bound by
// its own steps (each edge's shuffles, copy, wait and products, each
// receiver's scoring), not by L2 misses, which is also why slices of
// 128-byte rows, each a walk of its own, lose. In float32 (512-byte rows)
// misses count too: two slices of 256-byte rows beat one by 5%, and on
// graphs whose slice and g take more than twice the L2, one slice wins.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "vec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kWarp = 0xffffffffu;
// h slice rows a group has in flight, each lane's share copied
// asynchronously into its own ring of shared memory, so that the rows in
// flight take no registers. At the arxiv graph (mean in-degree 7) 4 beat 2
// and 8 by 1-7% on an H100 (PERF.md); grl_torch/probes/attention.py sweeps
// it when this line is edited.
constexpr int kStages = 4;

// The max of x over the aligned group of `group` lanes: xor shuffles of a
// distance below the group's width stay inside it. Every lane of the warp
// takes part.
__device__ __forceinline__ float group_max(float x, int group) {
  for (int o = group >> 1; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kWarp, x, o));
  return x;
}

// f[r] . g[s] in float32, k in order, from packed 16-byte vectors (the
// first `vecs` of kG).
template <typename T, int kG>
__device__ __forceinline__ float dot_packed(const uint4 (&fv)[kG], const uint4 (&gv)[kG], int vecs) {
  constexpr int kElems = grl::Vec<T>::kElems;
  float dot = 0.f;
#pragma unroll
  for (int v = 0; v < kG; ++v) {
    if (v < vecs) {
      float a[kElems], b[kElems];
      grl::unpack16(fv[v], a);
      grl::unpack16(gv[v], b);
#pragma unroll
      for (int i = 0; i < kElems; ++i) dot = fmaf(a[i], b[i], dot);
    }
  }
  return dot;
}

// The same dot read from device memory, for K that does not fit the
// packed registers (16-byte vectors where K allows, elements otherwise).
template <typename T>
__device__ __forceinline__ float dot_global(const T* frow, const T* grow, int K, uint64_t policy) {
  constexpr int kElems = grl::Vec<T>::kElems;
  float dot = 0.f;
  if (K % kElems == 0) {
#pragma unroll 4
    for (int k0 = 0; k0 < K; k0 += kElems) {
      float a[kElems], b[kElems];
      grl::unpack16(__ldcs(reinterpret_cast<const uint4*>(frow + k0)), a);
      grl::unpack16(grl::load16_hint(grow + k0, policy), b);
#pragma unroll
      for (int i = 0; i < kElems; ++i) dot = fmaf(a[i], b[i], dot);
    }
  } else {
    for (int k = 0; k < K; ++k) dot = fmaf(grl::to_float(frow[k]), grl::to_float(grow[k]), dot);
  }
  return dot;
}

// Asynchronous 16-byte copies from device memory into shared memory
// (cp.async, cached in L2 only), counted in commit groups per thread. They
// carry no L2 policy: the .L2::cache_hint form faulted with an illegal
// instruction in most of this kernel's instantiations on an H100 (PERF.md).
__device__ __forceinline__ void copy16_async(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void commit_copies() { asm volatile("cp.async.commit_group;" ::: "memory"); }
// Waits until at most kPending of this thread's commit groups are in flight.
template <int kPending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// kVecs: 16-byte vectors of h a lane holds per pass over the slice (wider
// slices take several passes, each scoring the edges again). kG: packed
// vectors of an f or g row loaded at once (K * itemsize <= 16 * kG), or 0
// to read them a vector at a time.
template <typename T, int kVecs, int kG>
__global__ void __launch_bounds__(kThreads, 4)
sparse_attention_kernel(const int* __restrict__ rowptr, const int* __restrict__ senders,
                        const T* __restrict__ f, const T* __restrict__ g, const T* __restrict__ h,
                        T* __restrict__ out, int N, int K, int F, int slice_cols, int group_log2) {
  constexpr int kElems = grl::Vec<T>::kElems;
  constexpr int kQ = kG > 0 ? kG : 1;
  // Lane t's slot (stage k, vector v) is ring[(k * kVecs + v) * kThreads + t]:
  // the lanes of a warp touch 32 consecutive vectors, without bank conflicts.
  extern __shared__ uint4 ring[];
  const uint32_t ring_lane = static_cast<uint32_t>(__cvta_generic_to_shared(ring + threadIdx.x));
  const int group = 1 << group_log2;
  const int lane = threadIdx.x & (group - 1);
  const int group_base = (threadIdx.x & 31) & ~(group - 1);
  const int groups = kThreads >> group_log2;
  const int stride = gridDim.x * groups;
  int r = blockIdx.x * groups + (threadIdx.x >> group_log2);
  const int sweeps = __reduce_max_sync(kWarp, r < N ? (N - 1 - r) / stride + 1 : 0);
  const int slice_begin = blockIdx.y * slice_cols;
  const int slice_end = min(F, slice_begin + slice_cols);
  const int pass = group * kVecs * kElems;
  const int vecs = K / kElems;  // packed vectors of an f or g row (kG > 0)
  const uint64_t policy = grl::l2_evict_last();

  // Receivers past the end have no edge and write nothing.
  auto load_bounds = [&](int row, int& start, int& end) {
    start = end = 0;
    if (row < N) start = __ldcs(rowptr + row), end = __ldcs(rowptr + row + 1);
  };
  auto load_sender = [&](int start, int end) { return start + lane < end ? __ldcs(senders + start + lane) : 0; };

  // A receiver ahead: the next one's first senders, the bounds of the one after.
  int start, end, next_start, next_end;
  load_bounds(r, start, end);
  load_bounds(r + stride, next_start, next_end);
  int sender = load_sender(start, end);

#pragma unroll 1
  for (int sweep = 0; sweep < sweeps; ++sweep, r += stride) {
    const int next_sender = load_sender(next_start, next_end);
    int after_start, after_end;
    load_bounds(r + 2 * stride, after_start, after_end);
    const int rounds = __reduce_max_sync(kWarp, (end - start + group - 1) >> group_log2);

#pragma unroll 1
    for (int f0 = slice_begin; f0 < slice_end; f0 += pass) {
      float acc[kVecs][kElems];
#pragma unroll
      for (int v = 0; v < kVecs; ++v)
#pragma unroll
        for (int i = 0; i < kElems; ++i) acc[v][i] = 0.f;
      float m = -INFINITY;  // running max of the scores
      float l = 0.f;        // running sum of exp(score - m), in edge order

#pragma unroll 1
      for (int round = 0; round < rounds; ++round) {
        const int base = start + (round << group_log2);
        const int e = base + lane;
        const bool valid = e < end;
        const int s = round == 0 ? sender : (valid ? __ldcs(senders + e) : 0);
        const int n = min(max(end - base, 0), group);  // this group's edges in the round
        const int most = __reduce_max_sync(kWarp, n);
        // Edge k of the round goes to stage k % kStages, one commit group
        // an edge (empty past the group's last), the first kStages now.
        auto copy_edge = [&](int k) {
          const T* hrow = h + static_cast<size_t>(__shfl_sync(kWarp, s, group_base + min(k, group - 1))) * F;
          const uint32_t slot = ring_lane + static_cast<uint32_t>((k & (kStages - 1)) * kVecs * kThreads * 16);
#pragma unroll
          for (int v = 0; v < kVecs; ++v) {
            const int j = f0 + (v * group + lane) * kElems;
            if (k < n && j < slice_end) copy16_async(slot + v * kThreads * 16, hrow + j);
          }
          commit_copies();
        };
#pragma unroll
        for (int k = 0; k < kStages; ++k) copy_edge(k);

        // The scores while the rows arrive: f[r] . g[s] in float32, k in order.
        float score = -INFINITY;
        if (valid) {
          if (kG > 0) {
            uint4 fq[kQ], gq[kQ];
            const uint4* frow = reinterpret_cast<const uint4*>(f + static_cast<size_t>(r) * K);
#pragma unroll
            for (int v = 0; v < kQ; ++v) {
              if (v < vecs) {
                fq[v] = __ldcs(frow + v);
                gq[v] = grl::load16_hint(g + static_cast<size_t>(s) * K + v * kElems, policy);
              }
            }
            score = dot_packed<T, kQ>(fq, gq, vecs);
          } else {
            score = dot_global<T>(f + static_cast<size_t>(r) * K, g + static_cast<size_t>(s) * K, K, policy);
          }
        }
        // A round with no edge of this group leaves m, l and acc as they
        // are; the first round with one rescales the empty sums by 0.
        const float m_new = fmaxf(m, group_max(score, group));
        const float corr = m_new == m ? 1.f : expf(m - m_new);
        const float p = valid ? expf(score - m_new) : 0.f;
        m = m_new;
        l *= corr;
#pragma unroll
        for (int v = 0; v < kVecs; ++v)
#pragma unroll
          for (int i = 0; i < kElems; ++i) acc[v][i] *= corr;

#pragma unroll 1
        for (int k = 0; k < most; ++k) {
          wait_copies<kStages - 1>();  // edge k's rows have landed
          const float pk = __shfl_sync(kWarp, p, group_base + min(k, group - 1));
          const float c = k < n ? pk : 0.f;
          l += c;
          const uint4* slot = ring + (k & (kStages - 1)) * kVecs * kThreads + threadIdx.x;
#pragma unroll
          for (int v = 0; v < kVecs; ++v) {
            const int j = f0 + (v * group + lane) * kElems;
            if (k < n && j < slice_end) {
              float x[kElems];
              grl::unpack16(slot[v * kThreads], x);
#pragma unroll
              for (int i = 0; i < kElems; ++i) acc[v][i] = fmaf(c, x[i], acc[v][i]);
            }
          }
          copy_edge(k + kStages);  // into the stage just read
        }
      }

      if (r < N) {
        const float inv = l > 0.f ? 1.f / l : 0.f;
        T* const orow = out + static_cast<size_t>(r) * F;
#pragma unroll
        for (int v = 0; v < kVecs; ++v) {
          const int j = f0 + (v * group + lane) * kElems;
          if (j < slice_end) {
#pragma unroll
            for (int i = 0; i < kElems; ++i) acc[v][i] *= inv;
            grl::store16_stream(orow + j, acc[v]);
          }
        }
      }
    }
    start = next_start, end = next_end, sender = next_sender;
    next_start = after_start, next_end = after_end;
  }
}

struct Args {
  const int* rowptr;
  const int* senders;
  const void* f;
  const void* g;
  const void* h;
  void* out;
  int N, K, F, slice_cols, num_slices, group_log2, blocks;
  cudaStream_t stream;
};

template <typename T, int kVecs, int kG>
int launch_with(const Args& a) {
  auto kernel = sparse_attention_kernel<T, kVecs, kG>;
  // At most 32 KB a block (kVecs = 2): 4 blocks an SM fit beside each other.
  const size_t smem = static_cast<size_t>(kStages) * kVecs * kThreads * sizeof(uint4);
  const dim3 grid(static_cast<unsigned>(a.blocks), static_cast<unsigned>(a.num_slices));
  kernel<<<grid, kThreads, smem, a.stream>>>(
      a.rowptr, a.senders, static_cast<const T*>(a.f), static_cast<const T*>(a.g), static_cast<const T*>(a.h),
      static_cast<T*>(a.out), a.N, a.K, a.F, a.slice_cols, a.group_log2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kVecs>
int launch_query(const Args& a) {
  constexpr int kElems = grl::Vec<T>::kElems;
  const int vecs = a.K % kElems == 0 ? a.K / kElems : 0;
  if (vecs >= 1 && vecs <= 2) return launch_with<T, kVecs, 2>(a);
  if (vecs >= 3 && vecs <= 4) return launch_with<T, kVecs, 4>(a);
  return launch_with<T, kVecs, 0>(a);
}

template <typename T>
int launch(const Args& a) {
  constexpr int kElems = grl::Vec<T>::kElems;
  if (a.F % kElems != 0 || a.slice_cols % kElems != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int per_lane = (a.slice_cols / kElems + (1 << a.group_log2) - 1) >> a.group_log2;
  if (per_lane <= 1) return launch_query<T, 1>(a);
  return launch_query<T, 2>(a);
}

}  // namespace

// Launches K4 on `stream` of `device`, does not synchronise, allocates
// nothing, and returns cudaGetLastError(). Columns [0, F) of out are
// written in num_slices slices of slice_cols columns, the last one clipped
// at F (grid row s: the slice from s * slice_cols), over a grid of
// `blocks` blocks a slice, each of 256 threads in groups of
// 2^group_log2 lanes, one receiver a group. dtype: 0 = float32, 1 = bfloat16; F and slice_cols
// multiples of 16 bytes, 1 <= K <= 1024; f, g, h and out 16-byte aligned.
// rowptr (N + 1) and senders (E) are the receiver-major CSR.
extern "C" int grl_sparse_attention(const void* rowptr, const void* senders, const void* f,
                                    const void* g, const void* h, void* out, int N, int K,
                                    int F, int slice_cols, int num_slices, int group_log2,
                                    int blocks, int dtype, int device, void* stream) {
  if (N < 0 || K < 1 || K > 1024 || slice_cols <= 0 || num_slices < 1 || num_slices > 65535 ||
      static_cast<long long>(num_slices - 1) * slice_cols >= F || group_log2 < 0 || group_log2 > 5 ||
      blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{static_cast<const int*>(rowptr), static_cast<const int*>(senders), f, g, h, out,
               N, K, F, slice_cols, num_slices, group_log2, blocks, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch<float>(a);
  if (dtype == 1) return launch<__nv_bfloat16>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* grl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
