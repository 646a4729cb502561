// K2 in float32 on Hopper (sm_90a): the gradient in V of the DropEdge
// neighbor aggregation, with a cp.async ring and a split-K reduced inside a
// thread-block cluster.
//
// K2 replaces grl_tpu/ops/pallas/relagg.py:284 (_dropedge_bwd, body
// _dropedge_bwd_kernel :183-210), per batch b the (N x N*L) @ (N*L x F)
// product
//
//     dV[b, m, :] = sum_{n, l} A[b, n, l, m] * keep(gid) / keep * g[b, n, l, :]
//
// A (B, N, L, N), g (B, N, L, F) and dV (B, N, F), all float32, accumulated
// in exact float32 FMAs (wgmma has no float32 mode, and TF32 keeps ~3
// digits), scaled by 1/keep once. The mask is grl::keep_edge of
// gid = ((b*N + n)*L + l)*N + m (hash.cuh), the element's index in A: the
// mask of every other DropEdge kernel and of the plain versions in
// grl_torch/ops/relagg.py.
//
// What bounds it. At the flagship's shape (B=8, N=256, L=6, F=256) a call is
// 2*B*N*L*N*F = 1.6 GFLOP against 27 MB (A 12.6 MB, g 12.6 MB, dV 2 MB):
// 60 FLOP/byte, above the H100's float32 ridge of ~20, so operations bound
// it, at 0.0240 ms (67 TFLOP/s of float32 FMA outside the tensor cores).
//
// What the design does about it.
// - A's (N*L, N) view is k-major for K2's output rows: a stage of 32 rows
//   of A over 128 of its columns is 32 contiguous 512-byte runs, copied into
//   shared memory as they stand (16-byte cp.async, 4-byte where N or F is
//   not a multiple of 4 or an operand is not 16-byte aligned), beside 32
//   rows of g over 128 features. No transpose of A touches any memory.
// - Four stages of 32 KB in flight: the copies of three steps overlap the
//   products of the current one, with one __syncthreads a step. The 128 KB
//   ring keeps one block on an SM, whose threads then have up to 255
//   registers: enough to load the next row's operands while the current
//   row's FMAs run. (On an H100 SXM, two blocks an SM at 128 registers
//   each, with 16-row stages, ran no faster than one.) How many blocks run
//   at once in clusters of S depends on the card's GPCs: the planner asks
//   (cudaOccupancyMaxActiveClusters) and fits S to whole waves.
// - 256 threads, each an 8 x 8 tile of the 128 x 128 output tile: four
//   16-byte shared-memory reads feed 64 FMAs a row of the reduction. A warp
//   spans 4 x 8 threads, so each of its reads is one 128-byte wavefront.
// - The mask: each thread, once its own copies of a stage have landed, tests
//   the A values it copied and hashes only the nonzero ones (about one in
//   500 at the main path's density of 0.002), writing dropped ones back as
//   zero before the stage's barrier.
// - The N*L reduction rows (1536 at the main shape, 48 steps of 32) are
//   split into S equal runs of whole steps (S divides the step count and is
//   at most 8), one block each; the S blocks of an output tile form a
//   cluster. Each block leaves its float32 partial in its own shared memory
//   (over the ring); after a cluster barrier block s sums its share of the
//   tile's rows over all S partials through distributed shared memory, in
//   the fixed order 0..S-1, so two launches give the same bits, with no
//   workspace in device memory and no atomics (dropedge_sm90.cu's bf16 K2
//   reduces the same way).
// The Python planner (grl_torch/ops/relagg.py:dropedge_f32_plan) picks S.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

#include "hash.cuh"

namespace cg = cooperative_groups;

namespace {

using grl::keep_edge;

constexpr int kBM = 128;       // output rows (A's columns m) a block
constexpr int kBN = 128;       // output columns (features f) a block
constexpr int kBK = 32;        // reduction rows (A's rows) a stage
constexpr int kStages = 4;     // ring depth: 128 KB, one block an SM
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int kMaxSplits = 8;  // the portable cluster size
constexpr int kStageFloats = kBK * (kBM + kBN);
// The ring, reused by the epilogue's kBM x kBN float32 partial.
constexpr int kSmemBytes = (kStages * kStageFloats > kBM * kBN ? kStages * kStageFloats : kBM * kBN) * 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// kVec floats from global to shared memory, or zeros where !valid.
template <int kVec>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  if constexpr (kVec == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(valid ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// ---------------------------------------------------------------------------
// dV (N x F) = (A * mask)^T (N x N*L) @ g (N*L x F), per batch.
// Grid (S * ceil(F / 128), ceil(N / 128), B) in clusters of (S, 1, 1): the S
// blocks of a cluster share output rows 128 y.. and columns 128 (x / S)..;
// block s of the cluster walks 32-row steps s * steps_per_split.. of the
// N*L reduction rows.
// ---------------------------------------------------------------------------
template <int kVec>
__global__ void __launch_bounds__(kThreads, 1)
dropedge_bwd_f32_kernel(const float* __restrict__ A, const float* __restrict__ g, float* __restrict__ dV,
                        int N, int NL, int F, int steps_per_split, uint32_t seed, float keep) {
  constexpr int kRowChunks = kBM / kVec;                   // copies a 128-wide row
  constexpr int kChunks = kBK * kRowChunks / kThreads;     // copies a thread, each operand
  static_assert(kBM == kBN && kChunks * kThreads == kBK * kRowChunks, "tile");
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int split = static_cast<int>(cluster.block_rank());
  const int f0 = (blockIdx.x / S) * kBN, m0 = blockIdx.y * kBM, b = blockIdx.z;
  const int row0 = split * steps_per_split * kBK;  // the split's first reduction row
  const int tid = threadIdx.x;
  // Thread (ty, tx) of 16 x 16 owns output rows ty*4.. and 64 + ty*4..,
  // columns tx*4.. and 64 + tx*4..; warp w covers ty 4 (w / 2).. and tx
  // 8 (w % 2)...
  const int warp = tid / 32, lane = tid % 32;
  const int ty = (warp / 2) * 4 + lane / 8, tx = (warp % 2) * 8 + lane % 8;
  const float* Ab = A + static_cast<size_t>(b) * NL * N;
  const float* gb = g + static_cast<size_t>(b) * NL * F;

  // Stage k of the split: rows row0 + 32 k.. of A (columns m0..) and g
  // (columns f0..); a commit group even when k is past the last step, so
  // the wait below counts the same groups at every step.
  const auto load = [&](int k) {
    if (k < steps_per_split) {
      float* As = smem + (k % kStages) * kStageFloats;
      float* Gs = As + kBK * kBM;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int c = tid + i * kThreads;
        const int kk = c / kRowChunks, col = (c % kRowChunks) * kVec;
        const int r = row0 + k * kBK + kk;
        const bool row_ok = r < NL;
        const bool a_ok = row_ok && m0 + col < N, g_ok = row_ok && f0 + col < F;
        cp_async<kVec>(As + kk * kBM + col, a_ok ? Ab + static_cast<size_t>(r) * N + m0 + col : A, a_ok);
        cp_async<kVec>(Gs + kk * kBN + col, g_ok ? gb + static_cast<size_t>(r) * F + f0 + col : g, g_ok);
      }
    }
    cp_async_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) load(k);
  for (int k = 0; k < steps_per_split; ++k) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage k have landed
    float* As = smem + (k % kStages) * kStageFloats;
    const float* Gs = As + kBK * kBM;
    // The mask over the A values this thread copied: zeros stay zero and
    // are not hashed (the ragged edges are zero-filled).
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = tid + i * kThreads;
      const int kk = c / kRowChunks, col = (c % kRowChunks) * kVec;
      float* p = As + kk * kBM + col;
      const uint32_t gid0 = (static_cast<uint32_t>(b) * NL + row0 + k * kBK + kk) * N + m0 + col;
      if constexpr (kVec == 4) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f) {
#pragma unroll 1
          for (int e = 0; e < 4; ++e)
            if (p[e] != 0.f && !keep_edge(gid0 + e, seed, keep)) p[e] = 0.f;
        }
      } else {
        if (*p != 0.f && !keep_edge(gid0, seed, keep)) *p = 0.f;
      }
    }
    __syncthreads();  // stage k (masked) is visible; stage k - 1 is read by all
    load(k + kStages - 1);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(As + kk * kBM + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(As + kk * kBM + 64 + ty * 4);
      const float4 g0 = *reinterpret_cast<const float4*>(Gs + kk * kBN + tx * 4);
      const float4 g1 = *reinterpret_cast<const float4*>(Gs + kk * kBN + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float v[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
    }
  }

  // The partial over the ring: thread rows ty*4.. and 64 + ty*4.., columns
  // tx*4.. and 64 + tx*4...
  cp_async_wait<0>();
  __syncthreads();  // every product has read its stage
  float* partial = smem;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = partial + ((i / 4) * 64 + ty * 4 + i % 4) * kBN;
    *reinterpret_cast<float4*>(row + tx * 4) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + 64 + tx * 4) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  cluster.sync();  // every partial of the cluster is written

  // Block s sums rows [s * per, (s + 1) * per) of the tile over the S
  // partials, in rank order.
  const int per = (kBM + S - 1) / S;
  const int row_lo = split * per;
  const int rows = min(kBM, row_lo + per) - row_lo;
  const float scale = 1.0f / keep;
  for (int q = tid; q < rows * (kBN / 4); q += kThreads) {
    const int row = row_lo + q / (kBN / 4), c = (q % (kBN / 4)) * 4;
    const int m = m0 + row, f = f0 + c;
    if (m >= N || f >= F) continue;
    // Every rank's 4 values are requested before any is added, so the
    // remote reads overlap; the sum then runs in rank order.
    float4 part[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < S) part[s] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(partial + row * kBN + c, s));
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      if (s < S) {
        sum[0] += part[s].x;
        sum[1] += part[s].y;
        sum[2] += part[s].z;
        sum[3] += part[s].w;
      }
    }
    float* out = dV + (static_cast<size_t>(b) * N + m) * F + f;
    if constexpr (kVec == 4) {
      *reinterpret_cast<float4*>(out) = make_float4(sum[0] * scale, sum[1] * scale, sum[2] * scale, sum[3] * scale);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (f + e < F) out[e] = sum[e] * scale;
    }
  }
  cluster.sync();  // no block leaves while another still reads its partial
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------
inline unsigned cdiv(int a, int b) { return static_cast<unsigned>((a + b - 1) / b); }

bool valid_shape(int B, int N, int L, int F, int vec, const void* A, const void* g, const void* dV) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (B <= 0 || N <= 0 || L <= 0 || F <= 0 || B > 65535 || cdiv(N, kBM) > 65535u) return false;
  if (static_cast<unsigned long long>(B) * N * L * N >= (1ull << 32)) return false;
  if (vec == 4) return N % 4 == 0 && F % 4 == 0 && aligned(A) && aligned(g) && aligned(dV);
  return vec == 1;
}

// Lets the kernel use its 64 KB of dynamic shared memory (past the default
// 48 KB) on `device`, once per process and device.
template <int kVec>
cudaError_t raise_smem_limit(int device) {
  static std::atomic<uint64_t> raised{0};
  const uint64_t bit = device >= 0 && device < 64 ? 1ull << device : 0;
  if (raised.load(std::memory_order_acquire) & bit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(dropedge_bwd_f32_kernel<kVec>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err == cudaSuccess) raised.fetch_or(bit, std::memory_order_release);
  return err;
}

cudaLaunchConfig_t cluster_config(dim3 grid, int S, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = static_cast<size_t>(kSmemBytes);
  config.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(S);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

template <int kVec>
int launch(const float* A, const float* g, float* dV, int B, int N, int L, int F, int S, uint32_t seed,
           float keep, int device, cudaStream_t stream) {
  const int steps = static_cast<int>(cdiv(N * L, kBK));
  if (S < 1 || S > kMaxSplits || steps % S != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = raise_smem_limit<kVec>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config =
      cluster_config(dim3(S * cdiv(F, kBN), cdiv(N, kBM), static_cast<unsigned>(B)), S, stream, &attr);
  err = cudaLaunchKernelEx(&config, dropedge_bwd_f32_kernel<kVec>, A, g, dV, N, N * L, F, steps / S, seed, keep);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2, float32: dV = (A * keep(gid) / keep)^T @ g over A's (N*L, N) view, the
// N*L rows split S ways, S a divisor of ceil(N*L / 32) and at most 8. vec is
// the copy width in floats: 4 needs N % 4 == 0, F % 4 == 0 and 16-byte
// aligned operands; 1 takes any. A is (B, N, L, N), g (B, N, L, F), dV
// (B, N, F), all contiguous. Runs on `stream` of `device`, does not
// synchronise, allocates nothing, and returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape, pointer or plan it does not take).
extern "C" int grl_dropedge_f32_backward(const void* A, const void* g, void* dV, int B, int N, int L, int F,
                                         int S, int vec, uint32_t seed, float keep, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!valid_shape(B, N, L, F, vec, A, g, dV)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* a = static_cast<const float*>(A);
  const auto* gp = static_cast<const float*>(g);
  auto* out = static_cast<float*>(dV);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec == 4 ? launch<4>(a, gp, out, B, N, L, F, S, seed, keep, device, s)
                  : launch<1>(a, gp, out, B, N, L, F, S, seed, keep, device, s);
}

// How many clusters of S blocks (16-byte copies) the card holds at once
// (cudaOccupancyMaxActiveClusters; 0 means it cannot launch them).
extern "C" int grl_dropedge_f32_max_clusters(int S, int device, int* clusters) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = raise_smem_limit<4>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config = cluster_config(dim3(S, 1, 1), S, nullptr, &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, dropedge_bwd_f32_kernel<4>, &config));
}

extern "C" const char* grl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
