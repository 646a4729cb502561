// K1 and K2 in bfloat16 on Hopper (sm_90a): the DropEdge neighbor
// aggregation and its gradient in V, with TMA rings, wgmma and, for K2, a
// split-K reduced inside a thread-block cluster; and K3, the aggregation
// without DropEdge, which is K1's kernel with the mask compiled out.
//
// K1 replaces grl_tpu/ops/pallas/relagg.py:220 (_dropedge_forward, body
// _dropedge_kernel :157-180), per batch b the (N*L x N) @ (N x F) product
//
//     out[b, n, l, :] = sum_m A[b, n, l, m] * keep(gid) / keep * V[b, m, :]
//
// K3 replaces relagg.py:99 (_agg_forward, body _agg_kernel :76-89), the same
// product over A itself: forward_body<BN, false>, with no mask pass, no
// proxy fence and no 1/keep in the epilogue. K1 at keep 1 drops nothing and
// multiplies by exactly 1, so it gives K3's bits.
//
// K2 replaces relagg.py:284 (_dropedge_bwd, body _dropedge_bwd_kernel
// :183-210), per batch the (N x N*L) @ (N*L x F) product
//
//     dV[b, m, :] = sum_{n, l} A[b, n, l, m] * keep(gid) / keep * g[b, n, l, :]
//
// A (B, N, L, N), V (B, N, F), g and out (B, N, L, F), dV (B, N, F), all
// bfloat16, accumulated in float32, scaled by 1/keep once and rounded to
// bfloat16 once. The mask is grl::keep_edge of gid = ((b*N + n)*L + l)*N + m
// (hash.cuh), the element's index in A: the mask of dropedge_f32.cu's float32
// kernels and of the plain versions in grl_torch/ops/relagg.py.
//
// What bounds them. At the flagship's shape (B=8, N=256, L=6, F=256) a call
// is 2*B*N*L*N*F = 1.6 GFLOP against 13.6 MB that must cross device memory
// (A 6.3 MB, the (N*L, F) operand 6.3 MB, the (N, F) one 1 MB): about 120
// FLOP/byte, under the H100's bf16 ridge of ~295, so bytes bound them, at
// 0.0041 ms (0.0063 ms at F=512). At that size a kernel lives or dies by
// latency: a call is a few microseconds of traffic spread over 132 SMs.
//
// What the design does about it.
// - One producer warp keeps TMA loads in flight into a ring of two stages
//   in dynamic shared memory (one full and one empty mbarrier a stage), so
//   the next step's load overlaps this step's product. A stage holds a
//   64 x 64 box of A (64 rows of A's (N*L, N) view, 128-byte swizzled) and
//   64 rows of the other operand as BN/64 boxes of 64 x 64. Two stages keep
//   a block at ~82 KB of shared memory at BN = 256, so two blocks share an
//   SM and the main shape's grids (and K2's clusters) run in one wave;
//   four stages halved the clusters the card holds. Three-dimensional
//   tensor maps (columns, rows, batch) make TMA zero-fill past a batch's
//   rows and columns, so ragged edges need no code in the main loop.
// - One consumer warpgroup applies the mask to the staged A tile: each
//   thread reads its four 16-byte chunks and notes the nonzero entries
//   (about one in 500 at the main path's density of 0.002); only those are
//   hashed on their gid, recovered through TMA's 128-byte swizzle (chunk c
//   of row r lies at chunk c ^ (r % 8)), and dropped entries are written
//   back as zero. A fence.proxy.async (by the threads that wrote) and a
//   warpgroup barrier make those writes visible to wgmma. Each A element
//   is staged and hashed once per output-column tile of BN = min(F, 256)
//   columns.
// - wgmma.m64nBNk16 multiplies from shared memory into float32 registers.
//   K1 reads the A tile K-major, exactly as staged, and V MN-major; K2 reads
//   the same tile transposed (MN-major, which bf16 allows) and g MN-major,
//   so no transpose of A ever touches device memory.
// - K2's reduction runs over N*L rows (1536 at the main shape), too long
//   for one block and too short for a second pass: the launcher splits it
//   into S equal runs of whole 64-row steps (S divides the step count and
//   is at most 8), one block each, and the S blocks of an output tile form
//   a cluster. Each block leaves its float32 partial in its own shared
//   memory; after a cluster barrier block s sums its share of the tile's
//   rows over all S partials through distributed shared memory (16-byte
//   remote loads, every rank's issued before any is added) in the fixed
//   order 0..S-1, so the result is deterministic, with no workspace in
//   device memory and no atomics. (Pushing 8-byte accumulator pairs from
//   registers into the owners' shared memory instead was slower on the
//   H100.)
// - The epilogues write bfloat16 with 16-byte stores: K1 and K3 through a
//   staging tile in shared memory, K2 straight from its cluster sum.
//
// The launchers encode the tensor maps on the host at every call (a map
// holds the base pointer) through the CUDA driver API's cuTensorMapEncodeTiled,
// reached with cudaGetDriverEntryPointByVersion (CUDA 12.5 or later), and
// pass them as __grid_constant__ parameters; each kernel's shared-memory
// limit is raised once per device, at its first launch there. TMA needs
// 16-byte global strides: N % 8 == 0 and F % 8 == 0, and 16-byte aligned
// base pointers. The Python planners (grl_torch/ops/relagg.py:
// aggregate_plan for K3, dropedge_plan for K1/K2) pick BN and S.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

#include "hash.cuh"
#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

using grl::keep_edge;
using namespace grl;

constexpr int kThreads = kConsumers + 32;     // one consumer warpgroup and one producer warp
constexpr int kMaxSplits = 8;                 // the portable cluster size
__host__ __device__ constexpr int bwd_ring(int BN) { return ring_bytes(BN, kTile * (BN + 8) * 4); }  // float32 partial

// ---------------------------------------------------------------------------
// The mask pass over a staged 64 x 64 A tile
// ---------------------------------------------------------------------------
// The tile holds A's rows row0.. (of batch b, row0 = b*N*L + first row) and
// columns col0..; TMA wrote logical 16-byte chunk c of row r at chunk
// c ^ (r % 8) of that row. Entries the hash drops become zero; zero entries
// (+0 or -0) stay as they are and are not hashed.
//
// Each thread reads its 4 chunks and notes their nonzero entries as bits;
// only those entries are hashed, in one compact loop that keeps the rarely
// taken path small (a fully unrolled hash of every entry of each nonzero
// chunk cost more than the step's four products on the H100).
__device__ __forceinline__ void mask_tile(uint8_t* tile, int tid, uint32_t row0, uint32_t N,
                                          uint32_t col0, uint32_t seed, float keep) {
  constexpr int kChunks = kTile * 8 / kConsumers;  // 16-byte chunks a thread
  uint32_t nonzero = 0;  // bit 8 * i + e: entry e of the thread's chunk i
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const uint4 v = *reinterpret_cast<const uint4*>(tile + (tid + i * kConsumers) * 16);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if ((w[e >> 1] >> (16 * (e & 1))) & 0x7FFFu) nonzero |= 1u << (8 * i + e);
  }
  bool wrote = false;
#pragma unroll 1
  while (nonzero != 0u) {
    const int bit = __ffs(nonzero) - 1;
    nonzero &= nonzero - 1u;
    const int q = tid + (bit >> 3) * kConsumers;  // physical chunk q: row q / 8, slot q % 8
    const int r = q >> 3, e = bit & 7;
    const uint32_t c = static_cast<uint32_t>((q & 7) ^ (r & 7));
    if (!keep_edge((row0 + r) * N + col0 + c * 8 + e, seed, keep)) {
      reinterpret_cast<uint16_t*>(tile + q * 16)[e] = 0;
      wrote = true;
    }
  }
  // A thread's generic-proxy writes, before wgmma (the async proxy) reads
  // the tile and before TMA refills it.
  if (wrote) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  consumers_sync();
}

// The producer's step k: one A box at (a_col, a_row, b) and BN / 64 boxes
// of the other operand at (x_col + 64 j, x_row, b).
template <int BN>
__device__ __forceinline__ void produce(const Ring& ring, int k, const CUtensorMap* map_a,
                                        const CUtensorMap* map_x, int a_col, int a_row, int x_col,
                                        int x_row, int b) {
  const int stage = k % kStages;
  mbar_wait(ring.empty + stage, ((k / kStages) & 1) ^ 1);
  uint8_t* a = ring.base + stage * stage_bytes(BN);
  mbar_expect_tx(ring.full + stage, stage_bytes(BN));
  tma_load(a, map_a, ring.full + stage, a_col, a_row, b);
#pragma unroll
  for (int j = 0; j < BN / 64; ++j)
    tma_load(a + kBoxBytes * (1 + j), map_x, ring.full + stage, x_col + 64 * j, x_row, b);
}

// ---------------------------------------------------------------------------
// K1 (kMask) and K3: out (N*L x F) = (A * mask) (N*L x N) @ V (N x F), per
// batch. Grid (ceil(F / BN), ceil(N*L / 64), B): block (x, y, z) owns output
// rows 64 y.. and columns BN x.. of batch z and walks ceil(N / 64) steps of
// 64 columns of A (rows of V). map_a and map_v point at the kernel's
// __grid_constant__ parameters.
// ---------------------------------------------------------------------------
template <int BN, bool kMask>
__device__ __forceinline__ void forward_body(const CUtensorMap* map_a, const CUtensorMap* map_v,
                                             __nv_bfloat16* __restrict__ out, int N, int NL, int F,
                                             uint32_t seed, float keep) {
  extern __shared__ uint8_t smem_raw[];
  const Ring ring = make_ring(smem_raw, fwd_ring(BN));
  const int f0 = blockIdx.x * BN, r0 = blockIdx.y * kTile, b = blockIdx.z;
  const int steps = (N + kTile - 1) / kTile;
  const int tid = threadIdx.x;

  if (tid >= kConsumers) {
    if (tid == kConsumers)
      for (int k = 0; k < steps; ++k)
        produce<BN>(ring, k, map_a, map_v, k * kTile, r0, f0, k * kTile, b);
    return;
  }

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int k = 0; k < steps; ++k) {
    const int stage = k % kStages;
    mbar_wait(ring.full + stage, (k / kStages) & 1);
    uint8_t* a = ring.base + stage * stage_bytes(BN);
    if constexpr (kMask) mask_tile(a, tid, static_cast<uint32_t>(b * NL + r0), N, k * kTile, seed, keep);
    forward_mma<BN>(acc, a);
    mbar_arrive(ring.empty + stage);
  }
  // K1's 1/keep in float32, then bf16 through the staging tile.
  forward_epilogue<BN, kMask, true>(acc, ring.base, out, tid, r0, f0, b, NL, F, 1.0f / keep);
}


// K1. A kernel of its own name, so that a trace tells K1 and K3 apart.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
dropedge_fwd_sm90_kernel(const __grid_constant__ CUtensorMap map_a,
                         const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ out,
                         int N, int NL, int F, const uint32_t* __restrict__ seed, float keep) {
  forward_body<BN, true>(&map_a, &map_v, out, N, NL, F, __ldg(seed), keep);
}

// K3.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
relagg_fwd_sm90_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ out,
                       int N, int NL, int F) {
  forward_body<BN, false>(&map_a, &map_v, out, N, NL, F, 0u, 1.0f);
}

// ---------------------------------------------------------------------------
// K2: dV (N x F) = (A * mask)^T (N x N*L) @ g (N*L x F), per batch.
// Grid (S * ceil(F / BN), ceil(N / 64), B) in clusters of (S, 1, 1): the S
// blocks of a cluster share output rows 64 y.. and columns BN (x / S)..;
// block s of the cluster walks 64-row steps s * steps_per_split.. of the
// N*L reduction rows.
// ---------------------------------------------------------------------------
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
dropedge_bwd_sm90_kernel(const __grid_constant__ CUtensorMap map_a,
                         const __grid_constant__ CUtensorMap map_g, __nv_bfloat16* __restrict__ dV,
                         int N, int NL, int F, int steps_per_split, const uint32_t* __restrict__ seed_ptr,
                         float keep) {
  constexpr int kStride = BN + 8;  // partial row, float32: shifts rows by 8 banks
  extern __shared__ uint8_t smem_raw[];
  const Ring ring = make_ring(smem_raw, bwd_ring(BN));
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int split = static_cast<int>(cluster.block_rank());
  const int f0 = (blockIdx.x / S) * BN, m0 = blockIdx.y * kTile, b = blockIdx.z;
  const int step0 = split * steps_per_split;
  const int tid = threadIdx.x;
  const uint32_t seed = __ldg(seed_ptr);
  float* partial = reinterpret_cast<float*>(ring.base);

  if (tid >= kConsumers) {
    if (tid == kConsumers)
      for (int k = 0; k < steps_per_split; ++k) {
        const int r = (step0 + k) * kTile;
        produce<BN>(ring, k, &map_a, &map_g, m0, r, f0, r, b);
      }
  } else {
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int k = 0; k < steps_per_split; ++k) {
      const int stage = k % kStages;
      mbar_wait(ring.full + stage, (k / kStages) & 1);
      uint8_t* a = ring.base + stage * stage_bytes(BN);
      mask_tile(a, tid, static_cast<uint32_t>(b * NL + (step0 + k) * kTile), N, m0, seed, keep);
      fence_registers(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk)  // both MN-major: 16 K rows = 2048 bytes on
        wgmma<BN, 1, 1>(acc, descriptor(a + 2048 * kk, kBoxBytes, 1024),
                        descriptor(a + kBoxBytes + 2048 * kk, kBoxBytes, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_registers(acc);
      mbar_arrive(ring.empty + stage);
    }
    consumers_sync();  // every product has read its stage: the ring becomes the partial
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2)
      *reinterpret_cast<float2*>(partial + frag_row(tid, i) * kStride + frag_col(tid, i)) =
          make_float2(acc[i], acc[i + 1]);
  }
  __syncwarp();
  cluster.sync();  // every partial of the cluster is written

  if (tid < kConsumers) {
    // Block s sums rows [s * per, (s + 1) * per) of the tile over the S
    // partials, in rank order.
    const int per = (kTile + S - 1) / S;
    const int row_lo = split * per;
    const int rows = min(kTile, row_lo + per) - row_lo;
    constexpr int kChunks = BN / 8;
    const float scale = 1.0f / keep;
    for (int q = tid; q < rows * kChunks; q += kConsumers) {
      const int row = row_lo + q / kChunks, c = q % kChunks;
      const int m = m0 + row, f = f0 + 8 * c;
      if (m >= N || f >= F) continue;
      // Every rank's 8 values are requested before any is added, so the
      // remote reads overlap; the sum then runs in rank order.
      float4 part[kMaxSplits][2];
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s) {
        if (s < S) {
          const float4* p = reinterpret_cast<const float4*>(
              cluster.map_shared_rank(partial + row * kStride + 8 * c, s));
          part[s][0] = p[0];
          part[s][1] = p[1];
        }
      }
      float sum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s) {
        if (s < S) {
          const float4 lo = part[s][0], hi = part[s][1];
          sum[0] += lo.x; sum[1] += lo.y; sum[2] += lo.z; sum[3] += lo.w;
          sum[4] += hi.x; sum[5] += hi.y; sum[6] += hi.z; sum[7] += hi.w;
        }
      }
      uint4 packed;
      uint32_t* w = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 pair = __floats2bfloat162_rn(sum[2 * e] * scale, sum[2 * e + 1] * scale);
        w[e] = *reinterpret_cast<const uint32_t*>(&pair);
      }
      *reinterpret_cast<uint4*>(dV + (static_cast<size_t>(b) * N + m) * F + f) = packed;
    }
  }
  __syncwarp();
  cluster.sync();  // no block leaves while another still reads its partial
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------
bool valid_shape(const void* A, const void* X, const void* out, int B, int N, int L, int F) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  return B > 0 && N > 0 && L > 0 && F > 0 && N % 8 == 0 && F % 8 == 0 && aligned(A) &&
         aligned(X) && aligned(out) &&
         static_cast<unsigned long long>(B) * N * L * N < (1ull << 32) && B <= 65535 &&
         cdiv(N * L, kTile) <= 65535u;
}

enum class Kernel { kK1, kK2, kK3 };

// Lets K1, K2 or K3 at width BN use its dynamic shared memory (past the
// default 48 KB) on `device`. The attribute holds for the process, so it is
// set at the kernel's first launch on each device (bit d of `raised`) and
// later launches skip it.
template <int BN, Kernel kKernel>
cudaError_t raise_smem_limit(int device) {
  static std::atomic<uint64_t> raised{0};
  const uint64_t bit = device >= 0 && device < 64 ? 1ull << device : 0;
  if (raised.load(std::memory_order_acquire) & bit) return cudaSuccess;
  cudaError_t err;
  if constexpr (kKernel == Kernel::kK2)
    err = cudaFuncSetAttribute(dropedge_bwd_sm90_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes(bwd_ring(BN)));
  else if constexpr (kKernel == Kernel::kK1)
    err = cudaFuncSetAttribute(dropedge_fwd_sm90_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes(fwd_ring(BN)));
  else
    err = cudaFuncSetAttribute(relagg_fwd_sm90_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes(fwd_ring(BN)));
  if (err == cudaSuccess) raised.fetch_or(bit, std::memory_order_release);
  return err;
}

// K1 (kMask) or K3.
template <int BN, bool kMask>
int launch_forward(const void* A, const void* V, void* out, int B, int N, int L, int F,
                   const uint32_t* seed, float keep, int device, cudaStream_t stream) {
  CUtensorMap map_a, map_v;
  if (!encode(&map_a, A, N, N * L, B) || !encode(&map_v, V, F, N, B))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = raise_smem_limit<BN, kMask ? Kernel::kK1 : Kernel::kK3>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int smem = smem_bytes(fwd_ring(BN));
  const dim3 grid(cdiv(F, BN), cdiv(N * L, kTile), static_cast<unsigned>(B));
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if constexpr (kMask)
    dropedge_fwd_sm90_kernel<BN><<<grid, kThreads, smem, stream>>>(map_a, map_v, o, N, N * L, F, seed, keep);
  else
    relagg_fwd_sm90_kernel<BN><<<grid, kThreads, smem, stream>>>(map_a, map_v, o, N, N * L, F);
  return static_cast<int>(cudaGetLastError());
}

cudaLaunchConfig_t cluster_config(dim3 grid, int smem, int S, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(S);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

template <int BN>
int launch_backward(const void* A, const void* g, void* dV, int B, int N, int L, int F, int S,
                    const uint32_t* seed, float keep, int device, cudaStream_t stream) {
  const int steps = static_cast<int>(cdiv(N * L, kTile));
  if (S < 1 || S > kMaxSplits || steps % S != 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_a, map_g;
  if (!encode(&map_a, A, N, N * L, B) || !encode(&map_g, g, F, N * L, B))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = raise_smem_limit<BN, Kernel::kK2>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int smem = smem_bytes(bwd_ring(BN));
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config = cluster_config(
      dim3(S * cdiv(F, BN), cdiv(N, kTile), static_cast<unsigned>(B)), smem, S, stream, &attr);
  err = cudaLaunchKernelEx(&config, dropedge_bwd_sm90_kernel<BN>, map_a, map_g, static_cast<__nv_bfloat16*>(dV), N, N * L, F,
                           steps / S, seed, keep);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int max_clusters(int S, int device, int* clusters) {
  const cudaError_t err = raise_smem_limit<BN, Kernel::kK2>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int smem = smem_bytes(bwd_ring(BN));
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config = cluster_config(dim3(S, 1, 1), smem, S, nullptr, &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, dropedge_bwd_sm90_kernel<BN>, &config));
}

// Dispatch on BN in {64, 128, 192, 256}: `return CALL(<BN>)`.
#define GRL_DISPATCH(BN, CALL)                               \
  switch (BN) {                                              \
    case 64: return CALL(64);                                \
    case 128: return CALL(128);                              \
    case 192: return CALL(192);                              \
    case 256: return CALL(256);                              \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

}  // namespace

// Each launcher runs on `stream` of `device`, does not synchronise,
// allocates nothing, and returns cudaGetLastError() (cudaErrorInvalidValue
// for a shape, pointer or plan it does not take). All operands bfloat16,
// contiguous, 16-byte aligned; N % 8 == 0, F % 8 == 0; BN in {64, 128, 192,
// 256}. A is (B, N, L, N), V (B, N, F), g and out (B, N, L, F), dV (B, N, F).

// K3: out = A @ V.
extern "C" int grl_relagg_sm90_forward(const void* A, const void* V, void* out, int B, int N, int L,
                                       int F, int BN, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!valid_shape(A, V, out, B, N, L, F)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GRL_AGGREGATE(bn) launch_forward<bn, false>(A, V, out, B, N, L, F, nullptr, 1.0f, device, s)
  GRL_DISPATCH(BN, GRL_AGGREGATE)
#undef GRL_AGGREGATE
}

// K1: out = (A * keep(gid) / keep) @ V. `seed` points at the mask's seed in
// device memory (one uint32, read by the kernel), so that a launch captured
// in a CUDA graph reads the value the graph's earlier work wrote there.
extern "C" int grl_dropedge_sm90_forward(const void* A, const void* V, void* out, int B, int N, int L,
                                         int F, int BN, const uint32_t* seed, float keep, int device,
                                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!valid_shape(A, V, out, B, N, L, F)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GRL_FORWARD(bn) launch_forward<bn, true>(A, V, out, B, N, L, F, seed, keep, device, s)
  GRL_DISPATCH(BN, GRL_FORWARD)
#undef GRL_FORWARD
}

// K2: dV = (A * keep(gid) / keep)^T @ g over A's (N*L, N) view, the N*L
// rows split S ways, S a divisor of ceil(N*L / 64) and at most 8.
extern "C" int grl_dropedge_sm90_backward(const void* A, const void* g, void* dV, int B, int N, int L,
                                          int F, int BN, int S, const uint32_t* seed, float keep,
                                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!valid_shape(A, g, dV, B, N, L, F)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GRL_BACKWARD(bn) launch_backward<bn>(A, g, dV, B, N, L, F, S, seed, keep, device, s)
  GRL_DISPATCH(BN, GRL_BACKWARD)
#undef GRL_BACKWARD
}

// How many clusters of S blocks of K2 at width BN the card can hold at once
// (cudaOccupancyMaxActiveClusters; 0 means it cannot launch them).
extern "C" int grl_dropedge_sm90_max_clusters(int BN, int S, int device, int* clusters) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
#define GRL_CLUSTERS(bn) max_clusters<bn>(S, device, clusters)
  GRL_DISPATCH(BN, GRL_CLUSTERS)
#undef GRL_CLUSTERS
}

extern "C" const char* grl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
