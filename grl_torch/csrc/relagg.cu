// K3: relational neighbor aggregation on Hopper (sm_90a).
//
// Replaces the TPU kernel grl_tpu/ops/pallas/relagg.py:pallas_neighbor_aggregate
// (_agg_forward :92-123, body _agg_kernel :76-89):
//
//     out[b, n, l, :] = sum_m A[b, n, l, m] * V[b, m, :]
//
// with A (B, N, L, N) and V (B, N, F) both float32 or both bfloat16,
// accumulated in float32 and written once in the operand dtype.
//
// Layout. A is read in place, in the dataset layout: row (b, n, l) starts at
// element ((b*N + n)*L + l)*N, so A[b] viewed as an (N*L, N) row-major matrix
// is a free reshape. The output is written in place: row (b, n, l) starts at
// ((b*N + n)*L + l)*F. Each batch b is therefore one plain GEMM
// (N*L x N) @ (N x F) -> (N*L x F); no transpose of the dominant operand A
// ever touches device memory (the TPU kernel's round-1 version lost to XLA
// exactly by paying those extra passes, relagg.py:1-11).
//
// Grid. One block owns one (BM x BN) tile of one batch's output; it walks
// the whole reduction dimension m itself in shared-memory tiles. That loop
// replaces the TPU's sequential k grid axis and its pl.when(k == 0) scratch
// reset: blocks run in parallel in no order on Hopper, so nothing carries
// between them and no cross-block reduction is needed. Any N is taken: rows,
// columns and the reduction edge are masked (zero-filled) inside the kernel,
// so the 64-quantum serving buckets (64, 192) run, unlike the TPU kernel
// which needs N % 128 == 0 (relagg.py:52-62).
//
// What bounds it. At the serving shape B=8, N=256, L=6, F=256 the call is
// 2*B*N*L*N*F = 1.6 GFLOP against ~13.6 MB moved in bf16 (A 6.3 MB, V 1 MB,
// out 6.3 MB; twice that in f32): ~120 FLOP/byte, under the H100's bf16
// ridge of ~295 FLOP/byte, so the floor is device-memory bandwidth. The
// design keeps A's device-memory traffic at one pass: the column tiles of
// one row band are blockIdx.x-adjacent, so they are scheduled together and
// the F/BN re-reads of the band's A rows hit the 50 MB L2; a batch's V
// panel (<= 256 KB) stays in L2 too; each output element is written once,
// in the operand dtype. The bf16 path runs on the tensor cores through
// WMMA (mma.sync) 16x16x16 fragments with float accumulators; float32 runs
// as a register-tiled SIMT product in full float32 (no TF32), because the
// f32 path is held to ~1e-4 relative. wgmma, TMA and a pipelined smem ring
// are the later, fast version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>

namespace {

using namespace nvcuda;

// ---------------------------------------------------------------------------
// float32: 64x64 output tile, 256 threads, 4x4 outputs per thread.
// ---------------------------------------------------------------------------
constexpr int kF32BM = 64;
constexpr int kF32BN = 64;
constexpr int kF32BK = 16;
constexpr int kF32Threads = 256;

__global__ void __launch_bounds__(kF32Threads)
relagg_f32_kernel(const float* __restrict__ A, const float* __restrict__ V,
                  float* __restrict__ out, int M, int K, int F) {
  // As is stored transposed (k-major) so a thread's 4 rows are contiguous.
  __shared__ float As[kF32BK][kF32BM + 4];
  __shared__ float Vs[kF32BK][kF32BN + 4];

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kF32BM;
  const int col0 = blockIdx.x * kF32BN;
  const float* Ab = A + static_cast<size_t>(b) * M * K;
  const float* Vb = V + static_cast<size_t>(b) * K * F;
  float* Ob = out + static_cast<size_t>(b) * M * F;

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // 4 output columns each
  const int ty = tid / 16;  // 4 output rows each

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kF32BK) {
    for (int i = tid; i < kF32BM * kF32BK; i += kF32Threads) {
      const int r = i / kF32BK, c = i % kF32BK;
      const int gr = row0 + r, gc = k0 + c;
      As[c][r] = (gr < M && gc < K) ? Ab[static_cast<size_t>(gr) * K + gc] : 0.f;
    }
    for (int i = tid; i < kF32BK * kF32BN; i += kF32Threads) {
      const int r = i / kF32BN, c = i % kF32BN;
      const int gr = k0 + r, gc = col0 + c;
      Vs[r][c] = (gr < K && gc < F) ? Vb[static_cast<size_t>(gr) * F + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kF32BK; ++kk) {
      float a[4], v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = Vs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty * 4 + i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tx * 4 + j;
      if (gc < F) Ob[static_cast<size_t>(gr) * F + gc] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: 64x64 output tile, 4 warps in a 2x2 layout, each warp 32x32 as
// 2x2 WMMA 16x16x16 fragments with float accumulators.
// ---------------------------------------------------------------------------
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kBf16Threads = 128;
// Row pads keep every fragment pointer 32-byte aligned and the leading
// dimensions multiples of 8 (bf16) / 4 (float), as WMMA requires, while
// shifting rows across shared-memory banks.
constexpr int kAStride = kBK + 8;  // 40 bf16 = 80 bytes
constexpr int kVStride = kBN + 8;  // 72 bf16 = 144 bytes
constexpr int kCStride = kBN + 4;  // 68 float = 272 bytes

__global__ void __launch_bounds__(kBf16Threads)
relagg_bf16_kernel(const __nv_bfloat16* __restrict__ A,
                   const __nv_bfloat16* __restrict__ V,
                   __nv_bfloat16* __restrict__ out, int M, int K, int F) {
  __shared__ __align__(32) __nv_bfloat16 As[kBM * kAStride];
  __shared__ __align__(32) __nv_bfloat16 Vs[kBK * kVStride];
  __shared__ __align__(32) float Cs[kBM * kCStride];

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const __nv_bfloat16* Ab = A + static_cast<size_t>(b) * M * K;
  const __nv_bfloat16* Vb = V + static_cast<size_t>(b) * K * F;
  __nv_bfloat16* Ob = out + static_cast<size_t>(b) * M * F;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;  // warp's 32-row half of the tile
  const int wn = warp % 2;  // warp's 32-column half of the tile
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kBf16Threads) {
      const int r = i / kBK, c = i % kBK;
      const int gr = row0 + r, gc = k0 + c;
      As[r * kAStride + c] =
          (gr < M && gc < K) ? Ab[static_cast<size_t>(gr) * K + gc] : zero;
    }
    for (int i = tid; i < kBK * kBN; i += kBf16Threads) {
      const int r = i / kBN, c = i % kBN;
      const int gr = k0 + r, gc = col0 + c;
      Vs[r * kVStride + c] =
          (gr < K && gc < F) ? Vb[static_cast<size_t>(gr) * F + gc] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * kAStride + kk, kAStride);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fv[j], Vs + kk * kVStride + wn * 32 + j * 16, kVStride);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * kCStride + wn * 32 + j * 16,
                              acc[i][j], kCStride, wmma::mem_row_major);
  __syncthreads();

  for (int i = tid; i < kBM * kBN; i += kBf16Threads) {
    const int r = i / kBN, c = i % kBN;
    const int gr = row0 + r, gc = col0 + c;
    if (gr < M && gc < F)
      Ob[static_cast<size_t>(gr) * F + gc] = __float2bfloat16(Cs[r * kCStride + c]);
  }
}

inline unsigned cdiv(int a, int b) { return static_cast<unsigned>((a + b - 1) / b); }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Launches on `stream` of `device`,
// does not synchronise, allocates nothing; returns cudaGetLastError().
extern "C" int grl_relagg_forward(const void* A, const void* V, void* out, int B,
                                  int N, int L, int F, int dtype, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = N * L;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid(cdiv(F, kF32BN), cdiv(M, kF32BM), static_cast<unsigned>(B));
    relagg_f32_kernel<<<grid, kF32Threads, 0, s>>>(
        static_cast<const float*>(A), static_cast<const float*>(V),
        static_cast<float*>(out), M, N, F);
  } else if (dtype == 1) {
    const dim3 grid(cdiv(F, kBN), cdiv(M, kBM), static_cast<unsigned>(B));
    relagg_bf16_kernel<<<grid, kBf16Threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(A), static_cast<const __nv_bfloat16*>(V),
        static_cast<__nv_bfloat16*>(out), M, N, F);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* grl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
