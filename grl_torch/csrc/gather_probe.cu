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
// whose shared-memory banks differ whatever the row). G is the per-row DMA
// of the TPU kernel written with Hopper's bulk copy engine: one thread
// issues cp.async.bulk copies of one row each into a ring of DEPTH slots,
// each slot with its own mbarrier (the counterpart of make_async_copy with
// a DMA semaphore); the warp waits on a slot's barrier, adds the row into
// float32 registers and hands the slot back to the next row. Block b
// loads its own indices into shared memory first.
//
// What bounds them. E1, E2 and F read the window(s) and the indices once
// and write every gathered row once: bytes-bound, the write of
// rows * F * 4 bytes dominates (1.18M rows of 512 B: 0.18 ms at 3.35 TB/s).
// G reads each gathered row once from a random place of V: bound by
// bytes too, but really by how many copies are in flight (DEPTH per
// block), which is what it measures.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;  // E1, E2, F: one block of 32 warps a 128 KB window
constexpr int kDepth = 8;  // row copies in flight per block (G)
constexpr int kMaxVecs = 4;  // G: float4s per lane, F <= 512

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

// G: one warp per block; lane 0 keeps kDepth row copies in flight.
__global__ void __launch_bounds__(32)
row_dma_sum_kernel(const float* __restrict__ V, const int* __restrict__ idx,
                   float* __restrict__ out, int F, int rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* slots = reinterpret_cast<float4*>(smem);  // kDepth rows of F floats
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + static_cast<size_t>(kDepth) * F * 4);
  int* rows = reinterpret_cast<int*>(bars + kDepth);
  const int lane = threadIdx.x;
  const int nvec = F / 4;
  const unsigned bytes = static_cast<unsigned>(F) * 4u;
  const int* block_idx = idx + static_cast<size_t>(blockIdx.x) * rows_per_block;
  for (int i = lane; i < rows_per_block; i += 32) rows[i] = __ldg(block_idx + i);
  if (lane == 0) {
    for (int s = 0; s < kDepth; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_addr(bars + s)), "r"(1u) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  if (lane == 0)
    for (int j = 0; j < kDepth && j < rows_per_block; ++j)
      issue_row(slots + j * nvec, V + static_cast<size_t>(rows[j]) * F, bytes, bars + j);

  float4 acc[kMaxVecs];
#pragma unroll
  for (int v = 0; v < kMaxVecs; ++v) acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < rows_per_block; ++j) {
    const int s = j % kDepth;
    wait_parity(bars + s, static_cast<unsigned>(j / kDepth) & 1u);
    const float4* slot = slots + s * nvec;
#pragma unroll
    for (int v = 0; v < kMaxVecs; ++v) {
      const int k = lane + 32 * v;
      if (k < nvec) {
        const float4 x = slot[k];
        acc[v].x += x.x;
        acc[v].y += x.y;
        acc[v].z += x.z;
        acc[v].w += x.w;
      }
    }
    __syncwarp();  // every lane has read the slot before it is refilled
    if (lane == 0 && j + kDepth < rows_per_block) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue_row(slots + s * nvec, V + static_cast<size_t>(rows[j + kDepth]) * F, bytes, bars + s);
    }
  }
  float4* dst = reinterpret_cast<float4*>(out + static_cast<size_t>(blockIdx.x) * F);
#pragma unroll
  for (int v = 0; v < kMaxVecs; ++v)
    if (lane + 32 * v < nvec) dst[lane + 32 * v] = acc[v];
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

// G. F <= 512.
extern "C" int grl_probe_row_dma_sum(const void* V, const void* idx, void* out, int F,
                                     int rows_per_block, int blocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (F % 4 != 0 || F > 128 * kMaxVecs) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kDepth) * F * 4 + kDepth * sizeof(uint64_t) +
                      static_cast<size_t>(rows_per_block) * sizeof(int);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(row_dma_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  row_dma_sum_kernel<<<blocks, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(V), static_cast<const int*>(idx), static_cast<float*>(out), F,
      rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* grl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
