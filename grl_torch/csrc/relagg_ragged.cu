// K3 in bfloat16 on Hopper (sm_90a) for the shapes TMA cannot read: the
// neighbor aggregation at N % 8 != 0 or F % 8 != 0 (the "ragged" route;
// dropedge_sm90.cu's TMA kernel takes N % 8 == 0 and F % 8 == 0).
//
// K3 replaces grl_tpu/ops/pallas/relagg.py:99 (_agg_forward, body
// _agg_kernel :76-89), per batch b the (N*L x N) @ (N x F) product
//
//     out[b, n, l, :] = sum_m A[b, n, l, m] * V[b, m, :]
//
// A (B, N, L, N), V (B, N, F) and out (B, N, L, F), all bfloat16,
// accumulated in float32 and rounded to bfloat16 once. A is read in place,
// as its (N*L, N) row-major view, with no transpose and no padding copy.
//
// What bounds it. At a trainer's ragged bucket (B=8, N=230, L=6, F=256) a
// call is 2*B*N*L*N*F = 1.3 GFLOP against 11.7 MB that must cross device
// memory (A 5.1 MB, out 5.7 MB, V 0.9 MB): ~111 FLOP/byte, under the H100's
// bf16 ridge of ~295, so bytes bound it, at 0.0035 ms (0.0055 at F=512).
// Like the aligned route, it lives or dies by latency.
//
// Why not TMA. A's rows are 2N bytes apart, and TMA needs global strides
// that are multiples of 16 bytes (N % 8 == 0); V's are 2F bytes apart.
//
// What the design does about it.
// - The consumer half is dropedge_sm90.cu's, shared through sm90.cuh: a
//   warpgroup runs wgmma.m64nBNk16 over a 64 x 64 A box staged K-major in
//   the 128-byte swizzled layout and BN/64 boxes of V (BN up to 256, so one
//   block covers F <= 256 and A's band is read once), then rounds through
//   the same staging tile. Launched at an aligned N it gives the TMA
//   route's bits exactly: the same boxes, summed in the same order.
// - The copy into the ring is the threads' own: each of the 128 threads
//   issues 4-byte cp.async copies (N even) of A's box straight into the
//   swizzled stage, logical 16-byte chunk c of row r at chunk c ^ (r % 8),
//   as TMA's 128-byte swizzle places it; columns >= N and rows past the
//   batch's N*L are zero-filled (src-size 0). Odd N has no 4-byte
//   alignment, so it takes 2-byte loads and shared stores (cp.async has no
//   2-byte form). V keeps its TMA map where F % 8 == 0 (one thread, on the
//   stage's full barrier); otherwise it takes the same copies, zero past F.
// - Two stages: the copies of step k + 1 are in flight while the wgmmas of
//   step k run. Each thread waits for its own copies (cp.async.wait_group),
//   fences them to the async proxy that wgmma reads through, and a
//   warpgroup barrier makes every thread's copies of the step visible; the
//   same barrier tells every thread that step k - 1's stage is free.
// - With no producer warp a block is 128 threads at ~82 KB of shared memory
//   (BN = 256): two blocks an SM, each thread up to 255 registers.
// The Python planner (grl_torch/ops/relagg.py:ragged_plan) picks BN.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

#include "sm90.cuh"

namespace {

using namespace grl;

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;" ::: "memory"); }

// Byte offset of element (row, col) of a 64 x 64 bf16 box in the 128-byte
// swizzled layout (TMA's CU_TENSOR_MAP_SWIZZLE_128B, 1024-aligned box).
__device__ __forceinline__ int swizzled(int row, int col) {
  return row * 128 + (((col >> 3) ^ (row & 7)) << 4) + ((col & 7) << 1);
}

// Copies box rows row0.. (< rows) and columns col0.. (< cols) of a
// row-major bf16 matrix with `stride` elements a row into a 64 x 64
// swizzled box, zero past either edge. kVec elements a copy: 2 (4-byte
// cp.async: stride, col0 and the base even) or 1 (2-byte loads and shared
// stores).
template <int kVec>
__device__ __forceinline__ void copy_box(uint8_t* box, const __nv_bfloat16* __restrict__ src, int row0, int rows,
                                         int col0, int cols, int stride, int tid) {
  constexpr int kPerRow = kTile / kVec;
  constexpr int kCopies = kTile * kPerRow / kConsumers;  // a thread's copies
  // 2-byte loads land in registers before their stores: 8 in flight at a
  // time keeps the accumulators out of local memory.
  constexpr int kUnroll = kVec == 2 ? kCopies : 8;
#pragma unroll kUnroll
  for (int i = 0; i < kCopies; ++i) {
    const int q = tid + i * kConsumers;
    const int row = q / kPerRow, col = (q % kPerRow) * kVec;
    const int r = row0 + row, c = col0 + col;
    const bool valid = r < rows && c < cols;
    const __nv_bfloat16* from = src + (valid ? static_cast<size_t>(r) * stride + c : 0);
    if constexpr (kVec == 2) {
      cp_async4(box + swizzled(row, col), from, valid);
    } else {
      const unsigned short bits = valid ? __ldg(reinterpret_cast<const unsigned short*>(from)) : 0;
      *reinterpret_cast<unsigned short*>(box + swizzled(row, col)) = bits;
    }
  }
}

// ---------------------------------------------------------------------------
// out (N*L x F) = A (N*L x N) @ V (N x F), per batch. Grid (ceil(F / BN),
// ceil(N*L / 64), B): block (x, y, z) owns output rows 64 y.. and columns
// BN x.. of batch z and walks ceil(N / 64) steps of 64 columns of A (rows
// of V). kVTma: V through map_v; else copied like A.
// ---------------------------------------------------------------------------
template <int BN, int kVec, bool kVTma>
__global__ void __launch_bounds__(kConsumers, 1)
relagg_ragged_kernel(const __grid_constant__ CUtensorMap map_v, const __nv_bfloat16* __restrict__ A,
                     const __nv_bfloat16* __restrict__ V, __nv_bfloat16* __restrict__ out, int N, int NL, int F) {
  extern __shared__ uint8_t smem_raw[];
  const Ring ring = make_ring(smem_raw, fwd_ring(BN));
  const int f0 = blockIdx.x * BN, r0 = blockIdx.y * kTile, b = blockIdx.z;
  const int steps = (N + kTile - 1) / kTile;
  const int tid = threadIdx.x;
  const __nv_bfloat16* Ab = A + static_cast<size_t>(b) * NL * N;
  const __nv_bfloat16* Vb = V + static_cast<size_t>(b) * N * F;

  // Step k's copies into stage k % 2: one commit group a thread.
  const auto issue = [&](int k) {
    const int stage = k % kStages;
    uint8_t* a = ring.base + stage * stage_bytes(BN);
    copy_box<kVec>(a, Ab, r0, NL, k * kTile, N, N, tid);
    if constexpr (kVTma) {
      if (tid == 0) {
        mbar_expect_tx(ring.full + stage, kBoxBytes * (BN / 64));
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load(a + kBoxBytes * (1 + j), &map_v, ring.full + stage, f0 + 64 * j, k * kTile, b);
      }
    } else {
#pragma unroll 1
      for (int j = 0; j < BN / 64; ++j)
        copy_box<kVec>(a + kBoxBytes * (1 + j), Vb, k * kTile, N, f0 + 64 * j, F, F, tid);
    }
    cp_async_commit();
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  issue(0);
  for (int k = 0; k < steps; ++k) {
    const int stage = k % kStages;
    cp_async_wait_all();  // this thread's copies of step k have landed
    // ... and are ordered before wgmma's (async-proxy) reads of them.
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    consumers_sync();  // every thread's copies of step k; step k - 1's stage is read
    if (k + 1 < steps) issue(k + 1);
    if constexpr (kVTma) mbar_wait(ring.full + stage, (k / kStages) & 1);
    forward_mma<BN>(acc, ring.base + stage * stage_bytes(BN));
  }
  if (reinterpret_cast<uintptr_t>(out) % 16 == 0 && F % 8 == 0)
    forward_epilogue<BN, false, true>(acc, ring.base, out, tid, r0, f0, b, NL, F, 1.0f);
  else
    forward_epilogue<BN, false, false>(acc, ring.base, out, tid, r0, f0, b, NL, F, 1.0f);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------
// Lets the kernel use its dynamic shared memory (past the default 48 KB) on
// `device`, once per process and device.
template <int BN, int kVec, bool kVTma>
cudaError_t raise_smem_limit(int device) {
  static std::atomic<uint64_t> raised{0};
  const uint64_t bit = device >= 0 && device < 64 ? 1ull << device : 0;
  if (raised.load(std::memory_order_acquire) & bit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(relagg_ragged_kernel<BN, kVec, kVTma>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(fwd_ring(BN)));
  if (err == cudaSuccess) raised.fetch_or(bit, std::memory_order_release);
  return err;
}

template <int BN, int kVec, bool kVTma>
int launch(const void* A, const void* V, void* out, int B, int N, int L, int F, int device, cudaStream_t stream) {
  CUtensorMap map_v = {};
  if (kVTma && !encode(&map_v, V, F, N, B)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = raise_smem_limit<BN, kVec, kVTma>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(cdiv(F, BN), cdiv(N * L, kTile), static_cast<unsigned>(B));
  relagg_ragged_kernel<BN, kVec, kVTma><<<grid, kConsumers, smem_bytes(fwd_ring(BN)), stream>>>(
      map_v, static_cast<const __nv_bfloat16*>(A), static_cast<const __nv_bfloat16*>(V),
      static_cast<__nv_bfloat16*>(out), N, N * L, F);
  return static_cast<int>(cudaGetLastError());
}

template <int kVec, bool kVTma>
int dispatch(int BN, const void* A, const void* V, void* out, int B, int N, int L, int F, int device,
             cudaStream_t s) {
  switch (BN) {
    case 64: return launch<64, kVec, kVTma>(A, V, out, B, N, L, F, device, s);
    case 128: return launch<128, kVec, kVTma>(A, V, out, B, N, L, F, device, s);
    case 192: return launch<192, kVec, kVTma>(A, V, out, B, N, L, F, device, s);
    case 256: return launch<256, kVec, kVTma>(A, V, out, B, N, L, F, device, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// K3, bfloat16, any N and F: out = A @ V. BN in {64, 128, 192, 256}; vec is
// the copy width in elements: 2 needs N even, 4-byte aligned A and, unless
// v_tma, F even and a 4-byte aligned V; 1 takes any. v_tma (V through TMA)
// needs F % 8 == 0 and a 16-byte aligned V. A is (B, N, L, N), V (B, N, F),
// out (B, N, L, F), all contiguous. Runs on `stream` of `device`, does not
// synchronise, allocates nothing, and returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape, pointer or plan it does not take).
extern "C" int grl_relagg_ragged_forward(const void* A, const void* V, void* out, int B, int N, int L, int F,
                                         int BN, int vec, int v_tma, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto aligned = [](const void* p, uintptr_t bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; };
  if (B <= 0 || N <= 0 || L <= 0 || F <= 0 || B > 65535 || cdiv(N * L, kTile) > 65535u ||
      static_cast<unsigned long long>(B) * N * L * N >= (1ull << 32) || !aligned(A, 2) || !aligned(V, 2) ||
      !aligned(out, 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (v_tma && !(F % 8 == 0 && aligned(V, 16))) return static_cast<int>(cudaErrorInvalidValue);
  if (vec == 2 && !(N % 2 == 0 && aligned(A, 4) && (v_tma || (F % 2 == 0 && aligned(V, 4)))))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 2) return v_tma ? dispatch<2, true>(BN, A, V, out, B, N, L, F, device, s)
                             : dispatch<2, false>(BN, A, V, out, B, N, L, F, device, s);
  if (vec == 1) return v_tma ? dispatch<1, true>(BN, A, V, out, B, N, L, F, device, s)
                             : dispatch<1, false>(BN, A, V, out, B, N, L, F, device, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* grl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
