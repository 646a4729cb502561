// P: the gather-rate probe's kernels on Hopper (sm_90a), float32 rows.
//
// Replaces the four pallas_calls of scripts/probe_gather.py, which
// measured how fast a TPU can gather rows for the ELL kernel's hot loop:
//
//   E1 (:154, vmem_take_kernel :129-135): gather rows of a window resident
//      in fast memory by a per-row local index: out[r] = win[idx[r]].
//   E2 (:177, vmem_tala_kernel :137-142): the take_along_axis form, one
//      index per element: out[r, f] = win[idx[r, f], f].
//   F  (:219, windowed_kernel :200-209): stream window i of V into fast
//      memory, then gather rows locally from it:
//      out[i*rows_per_window + k] = V[i*window_rows + idx[i, k]].
//   G  (:285, dma_kernel :247-279): a ring of DEPTH single-row asynchronous
//      copies from V into fast memory, summing each block's rows into one
//      float32 row: out[b] = sum_j V[idx[b, j]].
//
// Design. A TPU window is 2048 rows of 128 float32 (1 MB of VMEM); a block
// here has at most 227 KB of shared memory, so the callers use windows of
// 256 rows (128 KB) and keep the script's total rows gathered. The TPU's
// grid runs in order on one core and keeps the window resident across
// grid steps; here blocks run in parallel on 132 SMs, so every block
// stages its own window (E1, E2: the one window, from L2 after the first;
// F: window blockIdx / blocks_per_window, read from device memory once and
// from L2 by the window's other blocks), then gathers its rows_per_block
// rows from shared memory with 32 warps (one block an SM fits a 128 KB
// window): a warp per row with 16-byte loads (E1, F), a
// thread per element (E2: consecutive threads take consecutive features,
// whose shared-memory banks differ whatever the row).
//
// G keeps the TPU kernel's mechanism, one asynchronous copy per gathered
// row, as Hopper's bulk copy (cp.async.bulk completing on an mbarrier, the
// counterpart of make_async_copy with a DMA semaphore), and is laid out to
// keep megabytes of rows in flight on the card (the probe's wrapper plans
// it: grl_torch/probes/gather.py:row_dma_plan). One output row's rows are
// split over a thread-block cluster of `cluster` CTAs, so that the
// script's 32 output rows fill the card with two CTAs an SM; CTA c of the
// cluster takes the c-th chunk of ceil(rows / cluster) rows. A CTA has `warps` warps, each
// with its own ring of `depth` row slots and one mbarrier a slot: lane 0
// issues the copies of the warp's rows (chunk rows w, w + warps, ...), the
// warp waits on a slot's barrier, adds the row into float32 registers and
// hands the slot to the row `depth` further on. The warps' sums are added
// in warp order in shared memory, and CTA 0 of the cluster adds the CTAs'
// sums in rank order over distributed shared memory: the order of every
// sum depends on the plan alone.
//
// What bounds them. E1, E2 and F read the window(s) and the indices once
// and write every gathered row once: bytes-bound, the write of
// rows * F * 4 bytes dominates (1.18M rows of 512 B: 0.18 ms at 3.35 TB/s).
// G reads each gathered row once from a random place of V: bound by
// bytes too, but really by how fast the card completes single-row copies,
// which is what it measures. HBM at 3.35 TB/s with ~1 us of latency needs
// a few MB in flight: 256 CTAs of 8 warps of 8 512-byte rows hold 8 MB. On
// an H100 (PERF.md) the rate follows the warps that wait on and add rows
// on each SM, not the rows in flight: deeper rings do not help.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;  // E1, E2, F: one block of 32 warps a 128 KB window
constexpr int kMaxVecs = 4;  // G: float4s per lane, F <= 512
constexpr int kMaxWarps = 8;  // G: issuing warps a CTA
constexpr int kMaxCluster = 8;  // G: the portable cluster size
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block can take

// The window of window_rows rows of V starting at row `first`, into shared
// memory, by all threads of the block.
__device__ __forceinline__ void stage_window(float4* win, const float* V, size_t first,
                                             int window_rows, int nvec) {
  const float4* src = reinterpret_cast<const float4*>(V + first * nvec * 4);
  for (int i = threadIdx.x; i < window_rows * nvec; i += blockDim.x) win[i] = __ldg(src + i);
  __syncthreads();
}

// E1 and F: block b gathers rows [b*rows_per_block, (b+1)*rows_per_block)
// from window b / blocks_per_window; idx holds row numbers in the window.
__global__ void __launch_bounds__(kThreads)
window_gather_kernel(const float* __restrict__ V, const int* __restrict__ idx,
                     float* __restrict__ out, int window_rows, int F, int rows_per_block,
                     int blocks_per_window) {
  extern __shared__ float4 win[];
  const int nvec = F / 4;
  stage_window(win, V, static_cast<size_t>(blockIdx.x / blocks_per_window) * window_rows,
               window_rows, nvec);
  const size_t row0 = static_cast<size_t>(blockIdx.x) * rows_per_block;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows_per_block; r += kThreads >> 5) {
    const int local = __ldg(idx + row0 + r);
    float4* dst = reinterpret_cast<float4*>(out + (row0 + r) * F);
    for (int v = lane; v < nvec; v += 32) dst[v] = win[local * nvec + v];
  }
}

// E2: out[r, f] = win[idx[r, f], f] for the block's rows.
__global__ void __launch_bounds__(kThreads)
window_take_along_kernel(const float* __restrict__ V, const int* __restrict__ idx,
                         float* __restrict__ out, int window_rows, int F, int rows_per_block) {
  extern __shared__ float4 win[];
  stage_window(win, V, 0, window_rows, F / 4);
  const float* w = reinterpret_cast<const float*>(win);
  const size_t e0 = static_cast<size_t>(blockIdx.x) * rows_per_block * F;
  const int n = rows_per_block * F;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int f = i % F;
    out[e0 + i] = w[__ldg(idx + e0 + i) * F + f];
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One bulk copy of `bytes` from global `src` into shared `dst`, completing
// on `bar`, which first expects that many bytes.
__device__ __forceinline__ void issue_row(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void wait_parity(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void add4(float4& acc, const float4& x) {
  acc.x += x.x;
  acc.y += x.y;
  acc.z += x.z;
  acc.w += x.w;
}

// G's shared memory: the rings (warps * depth rows of F floats), the warps'
// sums (warps rows), one mbarrier a slot, then the CTA's chunk of indices.
__host__ __device__ inline size_t dma_smem_bytes(int F, int chunk, int warps, int depth) {
  return (static_cast<size_t>(warps) * depth + warps) * F * 4 + static_cast<size_t>(warps) * depth * 8 +
         static_cast<size_t>(chunk) * 4;
}

// G: output row blockIdx.x / cluster, CTA rank c of its cluster summing
// rows [c * chunk, (c + 1) * chunk) of idx's row, `warps` warps each
// keeping `depth` row copies in flight.
__global__ void __launch_bounds__(kMaxWarps * 32)
row_dma_sum_kernel(const float* __restrict__ V, const int* __restrict__ idx, float* __restrict__ out,
                   int F, int rows, int depth) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int ctas = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvec = F / 4;
  const unsigned bytes = static_cast<unsigned>(F) * 4u;
  const int chunk = (rows + ctas - 1) / ctas;
  const int first = rank * chunk;
  const int count = max(0, min(rows, first + chunk) - first);
  float4* slots = reinterpret_cast<float4*>(smem);  // warps * depth rows
  float4* sums = slots + static_cast<size_t>(warps) * depth * nvec;  // warps rows
  uint64_t* bars = reinterpret_cast<uint64_t*>(sums + static_cast<size_t>(warps) * nvec);
  int* chunk_rows = reinterpret_cast<int*>(bars + warps * depth);

  const int* row_idx = idx + static_cast<size_t>(blockIdx.x / ctas) * rows + first;
  for (int i = threadIdx.x; i < count; i += blockDim.x) chunk_rows[i] = __ldg(row_idx + i);
  if (threadIdx.x == 0) {
    for (int s = 0; s < warps * depth; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_addr(bars + s)), "r"(1u) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // This warp's rows: chunk rows warp, warp + warps, ...
  const int mine = count > warp ? (count - warp + warps - 1) / warps : 0;
  float4* ring = slots + static_cast<size_t>(warp) * depth * nvec;
  uint64_t* ring_bars = bars + warp * depth;
  auto issue = [&](int j) {
    const int s = j % depth;
    issue_row(ring + s * nvec, V + static_cast<size_t>(chunk_rows[warp + j * warps]) * F, bytes, ring_bars + s);
  };
  if (lane == 0)
    for (int j = 0; j < depth && j < mine; ++j) issue(j);

  float4 acc[kMaxVecs];
#pragma unroll
  for (int v = 0; v < kMaxVecs; ++v) acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < mine; ++j) {
    const int s = j % depth;
    wait_parity(ring_bars + s, static_cast<unsigned>(j / depth) & 1u);
    const float4* slot = ring + s * nvec;
#pragma unroll
    for (int v = 0; v < kMaxVecs; ++v)
      if (lane + 32 * v < nvec) add4(acc[v], slot[lane + 32 * v]);
    __syncwarp();  // every lane has read the slot before it is refilled
    if (lane == 0 && j + depth < mine) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue(j + depth);
    }
  }
#pragma unroll
  for (int v = 0; v < kMaxVecs; ++v)
    if (lane + 32 * v < nvec) sums[warp * nvec + lane + 32 * v] = acc[v];
  __syncthreads();
  // The CTA's sum, warps in order, into warp 0's row.
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    float4 total = sums[v];
    for (int w = 1; w < warps; ++w) add4(total, sums[w * nvec + v]);
    sums[v] = total;
  }
  cluster.sync();  // every CTA's sum is written
  if (rank == 0) {
    float4* dst = reinterpret_cast<float4*>(out + static_cast<size_t>(blockIdx.x / ctas) * F);
    for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
      float4 total = sums[v];
      for (int c = 1; c < ctas; ++c) add4(total, *cluster.map_shared_rank(sums + v, c));
      dst[v] = total;
    }
  }
  cluster.sync();  // no CTA leaves while CTA 0 still reads its sum
}

int window_bytes(int window_rows, int F) { return window_rows * F * 4; }

}  // namespace

// Every entry point launches on `stream` of `device`, does not
// synchronise, allocates nothing, and returns cudaGetLastError(). All
// arrays are float32 / int32, contiguous and 16-byte aligned; F is a
// multiple of 4; a window of window_rows * F floats fits 227 KB.

// E1 (blocks_per_window = blocks: every block reads window 0) and F.
extern "C" int grl_probe_window_gather(const void* V, const void* idx, void* out, int window_rows,
                                       int F, int rows_per_block, int blocks,
                                       int blocks_per_window, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = window_bytes(window_rows, F);
  err = cudaFuncSetAttribute(window_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_gather_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(V), static_cast<const int*>(idx), static_cast<float*>(out),
      window_rows, F, rows_per_block, blocks_per_window);
  return static_cast<int>(cudaGetLastError());
}

// E2.
extern "C" int grl_probe_window_take_along(const void* win, const void* idx, void* out,
                                           int window_rows, int F, int rows_per_block, int blocks,
                                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = window_bytes(window_rows, F);
  err = cudaFuncSetAttribute(window_take_along_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_take_along_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(win), static_cast<const int*>(idx), static_cast<float*>(out),
      window_rows, F, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

// G: `blocks` output rows, each over a cluster of `cluster` CTAs of
// `warps` warps with `depth` row copies in flight a warp. F <= 512.
extern "C" int grl_probe_row_dma_sum(const void* V, const void* idx, void* out, int F, int rows, int blocks,
                                     int cluster, int warps, int depth, int device, void* stream) {
  if (F < 4 || F % 4 != 0 || F > 128 * kMaxVecs || rows < 1 || blocks < 1 || cluster < 1 ||
      cluster > kMaxCluster || warps < 1 || warps > kMaxWarps || depth < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = dma_smem_bytes(F, (rows + cluster - 1) / cluster, warps, depth);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(row_dma_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(blocks * cluster), 1, 1);
  config.blockDim = dim3(static_cast<unsigned>(warps * 32), 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(cluster);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, row_dma_sum_kernel, static_cast<const float*>(V),
                           static_cast<const int*>(idx), static_cast<float*>(out), F, rows, depth);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* grl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
