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
// grl_torch/ops/sparse_attention.py:backward_launch) owns one node and
// walks nodes a grid row apart, the next node's bounds and first edges
// loaded while it works on the current one. It takes its node's edges in
// rounds of G, lane j owning edge j of the round, and reads the wide rows
// (h in launch 1, dout in launch 2) as K4's forward does
// (sparse_attention.cu): lane i copies 16-byte vector i (then i + G, ...,
// one pass of the row each) of the rows of the round's edges with
// cp.async into its own ring of `stages` slots in shared memory, the
// first `stages` edges before anything else and each slot refilled with
// the edge `stages` further on as soon as it is read, so several rows are
// in flight while the group works on the edges before them.
//
// Launch 1, a receiver r: dout[r] is loaded once into the lanes' registers
// (lane i its vector i). While the round's first h rows arrive, each lane
// loads f[r] and its own edge's g row (16-byte vectors; the g row is kept
// in registers) and scores it (f . g, k in order). Then for each edge of
// the round each lane stores its part of dout[r] . h[s] in shared memory,
// and at the end of the round each edge's owner adds its edge's G parts,
// lanes in order: no chain of shuffles an edge. Scores and dalpha stay in
// the owner's registers in the first round; a receiver with more than G
// edges (a hub) parks those of later rounds in their pair slots. With the
// group's max m, each owner makes p = exp(score - m), the group sums
// l = sum p and u = sum p dalpha, and each owner writes its pair once as
// (dscore, alpha) with alpha = p / l and dscore = alpha (dalpha - u / l)
// and adds dscore g[s] into a K-wide float32 sum of its own, from the g
// row in its registers (a hub's later rounds read theirs again). One
// reduce-scatter over the group (group_reduce_scatter: K - 1 shuffles a
// lane at G = K) gives df[r], lane j holding elements j, j + G, ....
// Launch 2, a sender s: each lane loads its own edge's receiver, t_edge
// and pair, and adds dscore f[r] into its own K-wide sum from f[r]'s
// 16-byte vectors; the group reads the dout rows through the ring, each
// lane adding alpha dout[r] for its vector of dh, edge by edge; one
// reduce-scatter gives dg[s]. The loops run in step across the warp (as
// often as its busiest group needs), so every shuffle takes every lane.
// No atomics, and every sum has a fixed order that depends on G alone: two
// launches give the same bits.
//
// What bounds it. At the full-graph slice's shape (N = 169,343,
// E = 1,184,773, K = 16, F = 128, bf16) the function reads f, g, h and
// dout once, writes df, dg and dh once and reads both CSRs once: ~163 MB,
// 0.049 ms at 3.35 TB/s; its ~E (6K + 4F) = 0.72 GFLOP of float32
// arithmetic is below the ridge. The realistic floor is the gathers: E
// rows of h (256 bytes) in launch 1 and of dout (256 bytes) in launch 2
// at random nodes, plus the narrow g and f rows and the pairs, ~0.7 GB,
// most of it from L2 (h, g and dout, f each fit the 50 MB L2 beside each
// other at this shape), at the ~4.6 TB/s that L2 gathers reach: ~0.15 ms.
// On an H100 (PERF.md) the walks do not wait on the rows in flight: rings
// of 2, 4 and 8 rows run within a few per cent of each other; each walk is
// bound by its own steps. Per-lane cp.async feeds the ring: one bulk copy
// a row (the gather probe's P-G) peaks at ~3.6 G rows/s on the card,
// slower than this walk's ~7 G rows/s. Walking the nodes in degree order
// (an index a node, so that the groups of a warp have even degrees) was
// slower than node order and is not done.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "vec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kWarp = 0xffffffffu;
constexpr int kMaxStages = 8;
constexpr int kMaxRowBytes = 128;  // of an f or g row: K * itemsize

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

// The sums of x[0..kN) over the aligned group, scattered: at step b
// (partner lane ^ 2^b) each lane keeps the elements whose index bit b is
// its lane bit b and adds the partner's copy of them, so after log2(G)
// steps lane j holds the sums of elements j, j + G, ... in x[0], x[1], ...
// (where kN < G, x[0] holds element j % kN). Each element's sum takes one
// order, fixed by G; kN - kN / G shuffles a lane instead of kN log2(G).
template <int kN>
__device__ __forceinline__ void group_reduce_scatter(float (&x)[kN], int lane, int group) {
#pragma unroll
  for (int b = 0; b < 5; ++b) {
    const int o = 1 << b;
    if (o < group) {
      const int half = (kN >> b) >> 1;  // a constant once unrolled
      if (half >= 1) {
        const bool upper = lane & o;
#pragma unroll
        for (int j = 0; j < kN / 2; ++j) {
          if (j < half) {
            const float keep = upper ? x[2 * j + 1] : x[2 * j];
            const float send = upper ? x[2 * j] : x[2 * j + 1];
            x[j] = keep + __shfl_xor_sync(kWarp, send, o);
          }
        }
      } else {
        x[0] += __shfl_xor_sync(kWarp, x[0], o);
      }
    }
  }
}

// Writes lane's share of a reduce-scattered K-wide row (elements lane,
// lane + G, ... below K) in T.
template <typename T, int kN>
__device__ __forceinline__ void store_scattered(T* row, const float (&x)[kN], int lane, int group, int K) {
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int c = i * group + lane;
    if (i * group < kN && c < K) {
      if constexpr (sizeof(T) == 4) row[c] = x[i];
      else row[c] = __float2bfloat16_rn(x[i]);
    }
  }
}

// The first `vecs` 16-byte vectors of an f or g row, the rest zero.
template <int kQ>
__device__ __forceinline__ void load_row(const void* row, int vecs, uint4 (&q)[kQ]) {
  const uint4* p = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int v = 0; v < kQ; ++v) q[v] = v < vecs ? __ldg(p + v) : make_uint4(0u, 0u, 0u, 0u);
}

// a . b in float32, k in order.
template <typename T, int kQ>
__device__ __forceinline__ float dot_rows(const uint4 (&a)[kQ], const uint4 (&b)[kQ]) {
  constexpr int kElems = grl::Vec<T>::kElems;
  float dot = 0.f;
#pragma unroll
  for (int v = 0; v < kQ; ++v) {
    float x[kElems], y[kElems];
    grl::unpack16(a[v], x);
    grl::unpack16(b[v], y);
#pragma unroll
    for (int i = 0; i < kElems; ++i) dot = fmaf(x[i], y[i], dot);
  }
  return dot;
}

// acc += c * q, element by element.
template <typename T, int kQ>
__device__ __forceinline__ void add_scaled(float (&acc)[kQ * grl::Vec<T>::kElems], float c, const uint4 (&q)[kQ]) {
  constexpr int kElems = grl::Vec<T>::kElems;
#pragma unroll
  for (int v = 0; v < kQ; ++v) {
    float x[kElems];
    grl::unpack16(q[v], x);
#pragma unroll
    for (int i = 0; i < kElems; ++i) acc[v * kElems + i] = fmaf(c, x[i], acc[v * kElems + i]);
  }
}

// Asynchronous 16-byte copies into shared memory (cp.async, cached in L2
// only; no L2 policy, as in sparse_attention.cu), counted in commit groups
// per thread.
__device__ __forceinline__ void copy16_async(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void commit_copies() { asm volatile("cp.async.commit_group;" ::: "memory"); }
// Waits until at most `pending` (stages - 1: 1, 3 or 7) of this thread's
// commit groups are in flight; the count must be an immediate.
__device__ __forceinline__ void wait_copies(int pending) {
  if (pending >= 7) asm volatile("cp.async.wait_group 7;" ::: "memory");
  else if (pending >= 3) asm volatile("cp.async.wait_group 3;" ::: "memory");
  else if (pending >= 1) asm volatile("cp.async.wait_group 1;" ::: "memory");
  else asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Launch 1: df and the (dscore, alpha) pairs, a group per receiver. kQ:
// 16-byte vectors an f or g row is held in (K * itemsize <= 16 * kQ).
template <typename T, int kQ>
__global__ void __launch_bounds__(kThreads, 4)
attention_bwd_receivers_kernel(const int* __restrict__ rowptr, const int* __restrict__ senders,
                               const T* __restrict__ f, const T* __restrict__ g, const T* __restrict__ h,
                               const T* __restrict__ dout, float2* __restrict__ pairs, T* __restrict__ df,
                               int N, int K, int F, int group_log2, int stages) {
  constexpr int kElems = grl::Vec<T>::kElems;
  constexpr int kN = kQ * kElems;
  // Lane t's slot of stage k is ring[k * kThreads + t]: the lanes of a warp
  // touch 32 consecutive vectors, without bank conflicts. After the ring,
  // each group's dalpha parts: lane j's part of the round's edge k at
  // parts[j * (G + 1) + k], a row a lane padded by one word, so that the
  // lanes' writes of one edge and the owners' reads of one lane's row fall
  // in distinct banks.
  extern __shared__ uint4 ring[];
  const uint32_t ring_lane = static_cast<uint32_t>(__cvta_generic_to_shared(ring + threadIdx.x));
  const int group = 1 << group_log2;
  const int lane = threadIdx.x & (group - 1);
  const int group_base = (threadIdx.x & 31) & ~(group - 1);
  const int groups = kThreads >> group_log2;
  const int stride = gridDim.x * groups;
  const int hvecs = F / kElems;  // 16-byte vectors of an h or dout row
  const int passes = (hvecs + group - 1) >> group_log2;
  const int kvecs = K / kElems;  // of an f or g row
  const int mask = stages - 1;
  float* const parts = reinterpret_cast<float*>(ring + stages * kThreads) +
                       (threadIdx.x >> group_log2) * group * (group + 1);
  float* const my_parts = parts + lane * (group + 1);
  int r = blockIdx.x * groups + (threadIdx.x >> group_log2);
  const int sweeps = __reduce_max_sync(kWarp, r < N ? (N - 1 - r) / stride + 1 : 0);

  auto load_bounds = [&](int row, int& start, int& end) {
    start = end = 0;
    if (row < N) start = __ldg(rowptr + row), end = __ldg(rowptr + row + 1);
  };
  auto load_sender = [&](int start, int end) { return start + lane < end ? __ldg(senders + start + lane) : 0; };
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
    const bool live = end > start;  // so r < N
    const uint4* const drow = reinterpret_cast<const uint4*>(dout + static_cast<size_t>(r) * F);
    const uint4 dq0 = live && lane < hvecs ? __ldg(drow + lane) : make_uint4(0u, 0u, 0u, 0u);

    // Each owner's score, dalpha and g row of round 0 stay in registers.
    float m = -INFINITY, score0 = 0.f, dalpha0 = 0.f;
    uint4 g0[kQ];
#pragma unroll 1
    for (int round = 0; round < rounds; ++round) {
      const int base = start + (round << group_log2);
      const int e = base + lane;
      const bool valid = e < end;
      const int s = round == 0 ? sender : (valid ? __ldg(senders + e) : 0);
      const int n = min(max(end - base, 0), group);  // this group's edges in the round
      const int most = __reduce_max_sync(kWarp, n);
      float score = -INFINITY, dalpha = 0.f;
#pragma unroll 1
      for (int pass = 0; pass < passes; ++pass) {
        const int v = (pass << group_log2) + lane;  // this lane's vector of h and dout
        // Edge k of the round goes to slot k % stages, one commit group an
        // edge (empty past the group's last).
        auto copy_edge = [&](int k) {
          const int sk = __shfl_sync(kWarp, s, group_base + min(k, group - 1));
          if (k < n && v < hvecs)
            copy16_async(ring_lane + static_cast<uint32_t>((k & mask) * kThreads * 16),
                         h + static_cast<size_t>(sk) * F + v * kElems);
          commit_copies();
        };
#pragma unroll 1
        for (int k = 0; k < stages; ++k) copy_edge(k);
        if (pass == 0 && valid) {  // the score while the rows arrive
          uint4 fq[kQ], gq[kQ];
          load_row<kQ>(f + static_cast<size_t>(r) * K, kvecs, fq);
          load_row<kQ>(g + static_cast<size_t>(s) * K, kvecs, gq);
          score = dot_rows<T, kQ>(fq, gq);
          if (round == 0) {
#pragma unroll
            for (int q = 0; q < kQ; ++q) g0[q] = gq[q];
          }
        }
        float dx[kElems];
        grl::unpack16(pass == 0 ? dq0 : (live && v < hvecs ? __ldg(drow + v) : make_uint4(0u, 0u, 0u, 0u)), dx);
#pragma unroll 1
        for (int k = 0; k < most; ++k) {
          wait_copies(mask);  // edge k's vectors have landed
          float part = 0.f;
          if (k < n && v < hvecs) {
            float x[kElems];
            grl::unpack16(ring[(k & mask) * kThreads + threadIdx.x], x);
#pragma unroll
            for (int i = 0; i < kElems; ++i) part = fmaf(dx[i], x[i], part);
          }
          my_parts[k] = part;
          copy_edge(k + stages);  // into the slot just read
        }
        // Each owner adds its edge's parts, lanes in order.
        __syncwarp();
        if (valid) {
          float sum = 0.f;
          for (int j = 0; j < group; ++j) sum += parts[j * (group + 1) + lane];
          dalpha += sum;
        }
        __syncwarp();  // every owner has read before the next pass writes
      }
      if (valid) {
        m = fmaxf(m, score);
        if (round == 0) score0 = score, dalpha0 = dalpha;
        else pairs[e] = make_float2(score, dalpha);  // a hub's later rounds, parked
      }
    }
    m = group_max(m, group);

    // l = sum p and u = sum p dalpha, p = exp(score - m).
    float l = 0.f, u = 0.f;
#pragma unroll 1
    for (int round = 0; round < rounds; ++round) {
      const int e = start + (round << group_log2) + lane;
      if (e < end) {
        const float2 q = round == 0 ? make_float2(score0, dalpha0) : pairs[e];
        const float p = expf(q.x - m);
        l += p;
        u = fmaf(p, q.y, u);
      }
    }
    l = group_sum(l, group);
    u = group_sum(u, group);
    // l >= 1 wherever the receiver has an edge (its max scores p = 1).
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const float mean = u * inv;  // sum alpha dalpha

    // Each owner's pair, written once, and its dscore g[s] into acc.
    float acc[kN];
#pragma unroll
    for (int j = 0; j < kN; ++j) acc[j] = 0.f;
#pragma unroll 1
    for (int round = 0; round < rounds; ++round) {
      const int e = start + (round << group_log2) + lane;
      if (e < end) {
        const float2 q = round == 0 ? make_float2(score0, dalpha0) : pairs[e];
        const float alpha = expf(q.x - m) * inv;
        const float dscore = alpha * (q.y - mean);
        pairs[e] = make_float2(dscore, alpha);
        if (round == 0) {
          add_scaled<T, kQ>(acc, dscore, g0);
        } else {
          uint4 gq[kQ];
          load_row<kQ>(g + static_cast<size_t>(__ldg(senders + e)) * K, kvecs, gq);
          add_scaled<T, kQ>(acc, dscore, gq);
        }
      }
    }
    group_reduce_scatter<kN>(acc, lane, group);
    if (r < N) store_scattered<T, kN>(df + static_cast<size_t>(r) * K, acc, lane, group, K);
    start = next_start, end = next_end, sender = next_sender;
    next_start = after_start, next_end = after_end;
  }
}

// Launch 2: dg and dh, a group per sender, over the transposed CSR.
template <typename T, int kQ>
__global__ void __launch_bounds__(kThreads, 4)
attention_bwd_senders_kernel(const int* __restrict__ colptr, const int* __restrict__ t_receivers,
                             const int* __restrict__ t_edge, const float2* __restrict__ pairs,
                             const T* __restrict__ f, const T* __restrict__ dout, T* __restrict__ dg,
                             T* __restrict__ dh, int N, int K, int F, int group_log2, int stages) {
  constexpr int kElems = grl::Vec<T>::kElems;
  constexpr int kN = kQ * kElems;
  extern __shared__ uint4 ring[];
  const uint32_t ring_lane = static_cast<uint32_t>(__cvta_generic_to_shared(ring + threadIdx.x));
  const int group = 1 << group_log2;
  const int lane = threadIdx.x & (group - 1);
  const int group_base = (threadIdx.x & 31) & ~(group - 1);
  const int groups = kThreads >> group_log2;
  const int stride = gridDim.x * groups;
  const int hvecs = F / kElems;
  const int passes = (hvecs + group - 1) >> group_log2;
  const int kvecs = K / kElems;
  const int mask = stages - 1;
  int s = blockIdx.x * groups + (threadIdx.x >> group_log2);
  const int sweeps = __reduce_max_sync(kWarp, s < N ? (N - 1 - s) / stride + 1 : 0);

  auto load_bounds = [&](int node, int& start, int& end) {
    start = end = 0;
    if (node < N) start = __ldg(colptr + node), end = __ldg(colptr + node + 1);
  };
  // The receiver and receiver-major slot of this lane's first edge.
  auto load_first = [&](int start, int end, int& receiver, int& slot) {
    receiver = slot = 0;
    if (start + lane < end) receiver = __ldg(t_receivers + start + lane), slot = __ldg(t_edge + start + lane);
  };
  int start, end, next_start, next_end, receiver, slot;
  load_bounds(s, start, end);
  load_bounds(s + stride, next_start, next_end);
  load_first(start, end, receiver, slot);

#pragma unroll 1
  for (int sweep = 0; sweep < sweeps; ++sweep, s += stride) {
    int next_receiver, next_slot;
    load_first(next_start, next_end, next_receiver, next_slot);
    int after_start, after_end;
    load_bounds(s + 2 * stride, after_start, after_end);
    const int rounds = __reduce_max_sync(kWarp, (end - start + group - 1) >> group_log2);

    float gacc[kN];  // this lane's sum of dscore f[r] over its edges
#pragma unroll
    for (int j = 0; j < kN; ++j) gacc[j] = 0.f;
#pragma unroll 1
    for (int pass = 0; pass < passes; ++pass) {
      const int v = (pass << group_log2) + lane;  // this lane's vector of dh
      float acc[kElems];
#pragma unroll
      for (int i = 0; i < kElems; ++i) acc[i] = 0.f;
#pragma unroll 1
      for (int round = 0; round < rounds; ++round) {
        const int base = start + (round << group_log2);
        const int t = base + lane;
        const bool valid = t < end;
        int rt = receiver, at = slot;
        if (round > 0) {
          rt = valid ? __ldg(t_receivers + t) : 0;
          at = valid ? __ldg(t_edge + t) : 0;
        }
        const float2 pair = valid ? __ldg(pairs + at) : make_float2(0.f, 0.f);
        const int n = min(max(end - base, 0), group);
        const int most = __reduce_max_sync(kWarp, n);
        auto copy_edge = [&](int k) {
          const int rk = __shfl_sync(kWarp, rt, group_base + min(k, group - 1));
          if (k < n && v < hvecs)
            copy16_async(ring_lane + static_cast<uint32_t>((k & mask) * kThreads * 16),
                         dout + static_cast<size_t>(rk) * F + v * kElems);
          commit_copies();
        };
#pragma unroll 1
        for (int k = 0; k < stages; ++k) copy_edge(k);
        if (pass == 0 && valid) {  // dscore f[r] while the rows arrive
          uint4 fq[kQ];
          load_row<kQ>(f + static_cast<size_t>(rt) * K, kvecs, fq);
          add_scaled<T, kQ>(gacc, pair.x, fq);
        }
#pragma unroll 1
        for (int k = 0; k < most; ++k) {
          wait_copies(mask);
          const float alpha = __shfl_sync(kWarp, pair.y, group_base + min(k, group - 1));
          if (k < n && v < hvecs) {
            float x[kElems];
            grl::unpack16(ring[(k & mask) * kThreads + threadIdx.x], x);
#pragma unroll
            for (int i = 0; i < kElems; ++i) acc[i] = fmaf(alpha, x[i], acc[i]);
          }
          copy_edge(k + stages);
        }
      }
      if (s < N && v < hvecs) grl::store16<T, kElems>(dh + static_cast<size_t>(s) * F + v * kElems, acc);
    }
    group_reduce_scatter<kN>(gacc, lane, group);
    if (s < N) store_scattered<T, kN>(dg + static_cast<size_t>(s) * K, gacc, lane, group, K);
    start = next_start, end = next_end, receiver = next_receiver, slot = next_slot;
    next_start = after_start, next_end = after_end;
  }
}

// 16-byte vectors an f or g row of K elements is held in: 2, 4 or 8.
int row_vectors(int K, int dtype) {
  const int vecs = K * (dtype == 0 ? 4 : 2) / 16;
  return vecs <= 2 ? 2 : vecs <= 4 ? 4 : 8;
}

bool bad_shape(int N, int K, int F, int group_log2, int blocks, int stages, int dtype) {
  const int elems = dtype == 0 ? 4 : 8;
  return (dtype != 0 && dtype != 1) || N < 0 || K < elems || K % elems != 0 ||
         K * (dtype == 0 ? 4 : 2) > kMaxRowBytes || F < elems || F % elems != 0 || group_log2 < 0 ||
         group_log2 > 5 || blocks < 1 || stages < 2 || stages > kMaxStages || (stages & (stages - 1)) != 0;
}

struct Args {
  const void* ptr[8];
  int N, K, F, group_log2, blocks, stages;
  cudaStream_t stream;
};

// The kernel of each walk for T and kQ, launched from Args.
template <typename T, int kQ>
struct Receivers {
  static int run(const Args& a) {
    const int group = 1 << a.group_log2;
    const int smem = a.stages * kThreads * static_cast<int>(sizeof(uint4)) + kThreads * (group + 1) * 4;
    const cudaError_t err = cudaFuncSetAttribute(attention_bwd_receivers_kernel<T, kQ>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attention_bwd_receivers_kernel<T, kQ><<<a.blocks, kThreads, smem, a.stream>>>(
        static_cast<const int*>(a.ptr[0]), static_cast<const int*>(a.ptr[1]), static_cast<const T*>(a.ptr[2]),
        static_cast<const T*>(a.ptr[3]), static_cast<const T*>(a.ptr[4]), static_cast<const T*>(a.ptr[5]),
        static_cast<float2*>(const_cast<void*>(a.ptr[6])), static_cast<T*>(const_cast<void*>(a.ptr[7])), a.N,
        a.K, a.F, a.group_log2, a.stages);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T, int kQ>
struct Senders {
  static int run(const Args& a) {
    attention_bwd_senders_kernel<T, kQ><<<a.blocks, kThreads, a.stages * kThreads * sizeof(uint4), a.stream>>>(
        static_cast<const int*>(a.ptr[0]), static_cast<const int*>(a.ptr[1]), static_cast<const int*>(a.ptr[2]),
        static_cast<const float2*>(a.ptr[3]), static_cast<const T*>(a.ptr[4]), static_cast<const T*>(a.ptr[5]),
        static_cast<T*>(const_cast<void*>(a.ptr[6])), static_cast<T*>(const_cast<void*>(a.ptr[7])), a.N, a.K,
        a.F, a.group_log2, a.stages);
    return static_cast<int>(cudaGetLastError());
  }
};

template <template <typename, int> class Launch>
int dispatch(const Args& a, int dtype) {
  const int q = row_vectors(a.K, dtype);
  if (dtype == 0)
    return q == 2 ? Launch<float, 2>::run(a) : q == 4 ? Launch<float, 4>::run(a) : Launch<float, 8>::run(a);
  return q == 2 ? Launch<__nv_bfloat16, 2>::run(a)
                : q == 4 ? Launch<__nv_bfloat16, 4>::run(a) : Launch<__nv_bfloat16, 8>::run(a);
}

}  // namespace

// Launch 1 of K4b on `stream` of `device`: df (N, K) and pairs (E, 2)
// float32 from the receiver-major CSR rowptr (N + 1) and senders (E).
// blocks blocks of 256 threads in groups of 2^group_log2 lanes, one
// receiver a group, with rings of `stages` (2, 4 or 8) rows a lane in
// stages * 4 KB of shared memory, and 1 KB * (G + 1) of dalpha parts.
// dtype: 0 = float32, 1 = bfloat16; F and K multiples of 16 bytes,
// K * itemsize <= 128 bytes; f, g, h and dout 16-byte aligned. Does not synchronise, allocates nothing, returns
// cudaGetLastError().
extern "C" int grl_attention_bwd_receivers(const void* rowptr, const void* senders, const void* f, const void* g,
                                           const void* h, const void* dout, void* pairs, void* df, int N, int K,
                                           int F, int group_log2, int blocks, int stages, int dtype, int device,
                                           void* stream) {
  if (bad_shape(N, K, F, group_log2, blocks, stages, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{{rowptr, senders, f, g, h, dout, pairs, df}, N, K, F, group_log2, blocks, stages,
               static_cast<cudaStream_t>(stream)};
  return dispatch<Receivers>(a, dtype);
}

// Launch 2 of K4b: dg (N, K) and dh (N, F) from the sender-major CSR colptr
// (N + 1), t_receivers and t_edge (E) and launch 1's pairs. The same
// layout and conditions as launch 1.
extern "C" int grl_attention_bwd_senders(const void* colptr, const void* t_receivers, const void* t_edge,
                                         const void* pairs, const void* f, const void* dout, void* dg, void* dh,
                                         int N, int K, int F, int group_log2, int blocks, int stages, int dtype,
                                         int device, void* stream) {
  if (bad_shape(N, K, F, group_log2, blocks, stages, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{{colptr, t_receivers, t_edge, pairs, f, dout, dg, dh}, N, K, F, group_log2, blocks, stages,
               static_cast<cudaStream_t>(stream)};
  return dispatch<Senders>(a, dtype);
}

extern "C" const char* grl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
