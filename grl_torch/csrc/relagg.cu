// Relational neighbor aggregation on Hopper (sm_90a): K3 in float32, K3 in
// bfloat16 where N or F is not a multiple of 8, and K1 (DropEdge fused in)
// in float32. The bfloat16 K1/K2, and the bfloat16 K3 at N % 8 == 0 and
// F % 8 == 0, are dropedge_sm90.cu's TMA + wgmma kernels; the float32 K2 is
// dropedge_f32.cu's.
//
// K3 replaces grl_tpu/ops/pallas/relagg.py:pallas_neighbor_aggregate
// (_agg_forward :92-123, body _agg_kernel :76-89):
//
//     out[b, n, l, :] = sum_m A[b, n, l, m] * V[b, m, :]
//
// K1 replaces pallas_dropedge_aggregate (_dropedge_forward :213-248, body
// _dropedge_kernel :157-180): the same product over A * keep(gid) / keep,
// with A (B, N, L, N), V (B, N, F) and out (B, N, L, F) all in one dtype,
// accumulated in float32 and written once in the operand dtype.
//
// The DropEdge mask is a pure function of (seed, gid), where
// gid = ((b*N + n)*L + l)*N + m is the element's index in A (the wrapper
// refuses B*N*L*N >= 2^32): the two-injection murmur construction of
// grl_tpu/ops/pallas/csr_spmm.py:_hash_keep (:190-213), keep the entry iff
// (mix(mix(gid ^ s) + s) >> 8) * 2^-24 < keep (hash.cuh). The TPU kernels seed the
// TPU's hardware PRNG per (b, l, i, k) tile instead (relagg.py:151-154),
// whose bits cannot be reproduced here; keyed on the element, the mask is
// the same whatever the tiling, so K1 and K2 (in their other sources) tile
// differently and still see one mask, and the plain PyTorch version
// computes the identical mask.
// Dropped entries of an A tile become 0 as it is staged in shared memory;
// the 1/keep rescale multiplies the float32 accumulator once, in the
// epilogue (grl_tpu multiplies the bf16 tile by bf16(1/keep) instead,
// relagg.py:173-175, within 2^-8 relative of this).
//
// Layout. A is read in place, in the dataset layout: row (b, n, l) starts at
// element ((b*N + n)*L + l)*N, so A[b] viewed as an (N*L, N) row-major matrix
// is a free reshape. K3 and K1 are therefore one plain GEMM per batch,
// (N*L x N) @ (N x F) -> (N*L x F), with the output row (b, n, l) written in
// place at ((b*N + n)*L + l)*F, and no transpose of the dominant operand A
// ever touches device memory (the TPU kernel's round-1 version lost to XLA
// exactly by paying such passes, relagg.py:1-11).
//
// Grid. One block owns one (BM x BN) tile of one batch's output; it walks
// the whole reduction dimension itself in shared-memory tiles. That loop
// replaces the TPU's sequential grid axis k and its pl.when scratch
// resets: blocks run in parallel in no order on
// Hopper, so nothing carries between them and no cross-block reduction is
// needed. Any N is taken: rows, columns and the reduction edge are masked
// (zero-filled) inside the kernel, unlike the TPU kernel which needs
// N % 128 == 0 (relagg.py:52-62).
//
// What bounds them. At the flagship's shape B=8, N=256, L=6, F=256 each call
// is 2*B*N*L*N*F = 1.6 GFLOP against ~13.6 MB moved in bf16 (A 6.3 MB,
// V 1 MB, out 6.3 MB; ~21 MB at F=512):
// ~120 FLOP/byte, under the H100's bf16 ridge of ~295 FLOP/byte, so the
// floor is device-memory bandwidth, 0.0041 ms (0.0063 ms at F=512). The
// design keeps A's device-memory traffic at one pass: the column tiles of
// one row band are blockIdx.x-adjacent, so they are scheduled together and
// the F/BN re-reads of the band's A rows hit the 50 MB L2; a batch's V panel
// (<= 256 KB) stays in L2 too; each output element is written once, in the
// operand dtype. The mask costs two integer hashes per nonzero A entry
// staged, no bytes. bf16 K3 runs on the tensor cores through WMMA
// (mma.sync) 16x16x16 fragments with float accumulators; float32 runs as a
// register-tiled SIMT product in full float32 (no TF32), because the f32
// path is held to ~1e-4 relative. This bf16 kernel is K3's route for the
// shapes TMA cannot read (N % 8 or F % 8, e.g. the unaligned buckets of a
// trainer padded at another quantum); dropedge_sm90.cu's TMA + wgmma K3
// takes the rest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>

#include "hash.cuh"

namespace {

using namespace nvcuda;
using grl::keep_edge;

// Element (row, k) of batch b of A, an (M x K) row-major matrix a batch:
// its index in A.
__device__ __forceinline__ size_t a_index(int b, int row, int k, int M, int K) {
  return static_cast<size_t>(b) * M * K + static_cast<size_t>(row) * K + k;
}

__device__ __forceinline__ bool is_zero(float a) { return a == 0.f; }

// A's entry with DropEdge applied (unscaled). Zero entries stay zero
// whatever their bit, so only nonzero ones are hashed.
template <bool kDrop, typename T>
__device__ __forceinline__ T masked(T a, size_t gid, uint32_t seed, float keep, T zero) {
  if (kDrop && !is_zero(a) && !keep_edge(static_cast<uint32_t>(gid), seed, keep)) return zero;
  return a;
}

// ---------------------------------------------------------------------------
// float32: 64x64 output tile, 256 threads, 4x4 outputs per thread.
// out (M x F) = A (M x K) @ X (K x F), batched over blockIdx.z.
// ---------------------------------------------------------------------------
constexpr int kF32BM = 64;
constexpr int kF32BN = 64;
constexpr int kF32BK = 16;
constexpr int kF32Threads = 256;

template <bool kDrop>
__global__ void __launch_bounds__(kF32Threads)
relagg_f32_kernel(const float* __restrict__ A, const float* __restrict__ X,
                  float* __restrict__ out, int M, int K, int F, uint32_t seed,
                  float keep) {
  // As is stored k-major so a thread's 4 rows are contiguous.
  __shared__ float As[kF32BK][kF32BM + 4];
  __shared__ float Xs[kF32BK][kF32BN + 4];

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kF32BM;
  const int col0 = blockIdx.x * kF32BN;
  const float* Xb = X + static_cast<size_t>(b) * K * F;
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
    // Neighbouring threads take neighbouring addresses of A, along k.
    for (int i = tid; i < kF32BM * kF32BK; i += kF32Threads) {
      const int r = i / kF32BK, c = i % kF32BK;
      const int gr = row0 + r, gc = k0 + c;
      float a = 0.f;
      if (gr < M && gc < K) {
        const size_t gid = a_index(b, gr, gc, M, K);
        a = masked<kDrop>(A[gid], gid, seed, keep, 0.f);
      }
      As[c][r] = a;
    }
    for (int i = tid; i < kF32BK * kF32BN; i += kF32Threads) {
      const int r = i / kF32BN, c = i % kF32BN;
      const int gr = k0 + r, gc = col0 + c;
      Xs[r][c] = (gr < K && gc < F) ? Xb[static_cast<size_t>(gr) * F + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kF32BK; ++kk) {
      float a[4], v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = Xs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float scale = kDrop ? 1.0f / keep : 1.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty * 4 + i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tx * 4 + j;
      if (gc < F) Ob[static_cast<size_t>(gr) * F + gc] = kDrop ? acc[i][j] * scale : acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 K3: 64x64 output tile, 4 warps in a 2x2 layout, each warp 32x32
// as 2x2 WMMA 16x16x16 fragments with float accumulators.
// ---------------------------------------------------------------------------
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kBf16Threads = 128;
// Row pads keep every fragment pointer 32-byte aligned and the leading
// dimensions multiples of 8 (bf16) / 4 (float), as WMMA requires, while
// shifting rows across shared-memory banks.
constexpr int kAStride = kBK + 8;   // As[row][k], 40 bf16 = 80 bytes
constexpr int kXStride = kBN + 8;   // 72 bf16 = 144 bytes
constexpr int kCStride = kBN + 4;   // 68 float = 272 bytes

__global__ void __launch_bounds__(kBf16Threads)
relagg_bf16_kernel(const __nv_bfloat16* __restrict__ A,
                   const __nv_bfloat16* __restrict__ X,
                   __nv_bfloat16* __restrict__ out, int M, int K, int F) {
  __shared__ __align__(32) __nv_bfloat16 As[kBM * kAStride];
  __shared__ __align__(32) __nv_bfloat16 Xs[kBK * kXStride];
  __shared__ __align__(32) float Cs[kBM * kCStride];

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const __nv_bfloat16* Xb = X + static_cast<size_t>(b) * K * F;
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
          (gr < M && gc < K) ? A[a_index(b, gr, gc, M, K)] : zero;
    }
    for (int i = tid; i < kBK * kBN; i += kBf16Threads) {
      const int r = i / kBN, c = i % kBN;
      const int gr = k0 + r, gc = col0 + c;
      Xs[r * kXStride + c] =
          (gr < K && gc < F) ? Xb[static_cast<size_t>(gr) * F + gc] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fx[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fx[j], Xs + kk * kXStride + wn * 32 + j * 16, kXStride);
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * kAStride + kk, kAStride);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fx[j], acc[i][j]);
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

// out (B x M x F) = A @ X over B batches; dtype 0 = float32, 1 = bfloat16
// (K3 only: the bfloat16 K1 is dropedge_sm90.cu's).
template <bool kDrop>
int launch(const void* A, const void* X, void* out, int B, int M, int K, int F,
           int dtype, uint32_t seed, float keep, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid(cdiv(F, kF32BN), cdiv(M, kF32BM), static_cast<unsigned>(B));
    relagg_f32_kernel<kDrop><<<grid, kF32Threads, 0, s>>>(
        static_cast<const float*>(A), static_cast<const float*>(X),
        static_cast<float*>(out), M, K, F, seed, keep);
  } else if constexpr (!kDrop) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(cdiv(F, kBN), cdiv(M, kBM), static_cast<unsigned>(B));
    relagg_bf16_kernel<<<grid, kBf16Threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(A), static_cast<const __nv_bfloat16*>(X),
        static_cast<__nv_bfloat16*>(out), M, K, F);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point launches on `stream` of `device`, does not synchronise,
// allocates nothing, and returns cudaGetLastError(). dtype: 0 = float32,
// 1 = bfloat16 (K3 only). A is (B, N, L, N), V (B, N, F), out (B, N, L, F).

// K3: out = A @ V.
extern "C" int grl_relagg_forward(const void* A, const void* V, void* out, int B,
                                  int N, int L, int F, int dtype, int device,
                                  void* stream) {
  return launch<false>(A, V, out, B, N * L, N, F, dtype, 0u, 1.0f,
                                      device, stream);
}

// K1, float32: out = (A * keep(gid) / keep) @ V.
extern "C" int grl_dropedge_forward(const void* A, const void* V, void* out, int B,
                                    int N, int L, int F, int dtype, uint32_t seed,
                                    float keep, int device, void* stream) {
  return launch<true>(A, V, out, B, N * L, N, F, dtype, seed, keep, device, stream);
}

extern "C" const char* grl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
