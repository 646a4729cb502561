// K2 in float32 on Hopper (sm_90a): the gradient in V of the DropEdge
// neighbor aggregation, with a cp.async ring and a split-K reduced inside a
// thread-block cluster; and K1 and K3 in float32, the forward with the mask
// compiled in or out, in 3xTF32 on wgmma (notes further down).
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
//
// K1 replaces grl_tpu/ops/pallas/relagg.py:220 (_dropedge_forward, body
// _dropedge_kernel :157-180) and K3 relagg.py:99 (_agg_forward, body
// _agg_kernel :76-89), per batch b the (N*L x N) @ (N x F) product
//
//     out[b, n, l, :] = sum_m A[b, n, l, m] * keep(gid) / keep * V[b, m, :]
//
// (K3: A itself, no 1/keep). The same FLOPs as K2: 0.0240 ms at the
// flagship's shape (0.0481 at F = 512) at the float32 rate outside the
// tensor cores, 0.0098 (0.0195) ms in 3xTF32 at a third of the 495 TFLOP/s
// TF32 tensor rate, above the bytes' 0.0081 (0.0125) ms. K2's SIMT
// loop runs at about half an SM's float32 FMA rate, where torch.matmul's
// float32 product (TF32 off) sits too, so the forward takes the tensor
// cores instead, in 3xTF32: each float32 operand is split into a TF32 hi
// part and a TF32 lo part (x - hi, rounded), and a_lo b_hi + a_hi b_lo +
// a_hi b_hi run as wgmma.m64n128k8 into float32 accumulators, which keeps
// ~22 of each product's 24 bits (about 1e-6 of the output's scale against
// the plain float32 product, inside the f32 limits).
// - Output tiles of 128 of A's N*L rows by 128 features, reduction steps of
//   32 of A's N columns (V's rows). A four-stage cp.async ring holds A's
//   stage as it stands in A (128 rows of 32 columns, 16-byte copies along
//   each row; 8- or 4-byte where N or F is not a multiple of 4, or an
//   operand's alignment forbids), in rows padded to 36 floats, and V's
//   stage (32 rows of 128), padded to 136.
// - wgmma reads TF32 B only K-major: each step's V stage is split into hi
//   and lo and written transposed, into two K-major 128-byte swizzled
//   copies (16 KB each, double-buffered), while the previous step's wgmmas
//   run. A goes to wgmma from registers: each of the two warpgroups loads
//   its 64 rows' fragments (conflict-free with the padding) and splits them.
// - The mask is hashed on the A values a thread copied, as in K2, read back
//   at once as bits of nonzero entries and hashed only where set, after the
//   stage's transpose, while the tensor cores run. K3 is the same template
//   with the mask and 1/keep compiled out, so K1 at keep 1 gives K3's bits.
// - 192 (F = 256) or 384 (F = 512) tiles of 8 steps would fill 1.45 or
//   2.91 waves of the 132 one-block-an-SM slots (205 KB of shared memory a
//   block). Instead one block a slot runs over all tiles
//   (relagg.py:dropedge_f32_forward_plan), each streaming its tiles' stages
//   through one ring, so the next tile's copies overlap this one's products
//   and stores.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

#include "hash.cuh"
#include "sm90.cuh"

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
  else if constexpr (kVec == 2)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(valid ? 8 : 0) : "memory");
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
                        int N, int NL, int F, int steps_per_split, const uint32_t* __restrict__ seed_ptr,
                        float keep) {
  constexpr int kRowChunks = kBM / kVec;                   // copies a 128-wide row
  constexpr int kChunks = kBK * kRowChunks / kThreads;     // copies a thread, each operand
  static_assert(kBM == kBN && kChunks * kThreads == kBK * kRowChunks, "tile");
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int split = static_cast<int>(cluster.block_rank());
  const int f0 = (blockIdx.x / S) * kBN, m0 = blockIdx.y * kBM, b = blockIdx.z;
  const int row0 = split * steps_per_split * kBK;  // the split's first reduction row
  const uint32_t seed = __ldg(seed_ptr);
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
// The float32 forward (K1, K3)
// ---------------------------------------------------------------------------
constexpr int kFwdBK = 32;      // reduction columns (A's columns m) a stage
constexpr int kFwdStages = 4;   // ring depth
constexpr int kFwdAStride = kFwdBK + 4;  // an A stage row (k along it): 16-byte aligned, fragment reads conflict-free
constexpr int kFwdVStride = kBN + 8;     // a V stage row (n along it)
constexpr int kFwdStageFloats = kBM * kFwdAStride + kFwdBK * kFwdVStride;
// V's stage transposed for wgmma, K-major, 128-byte swizzled: kBN rows (n)
// of kFwdBK = 32 floats (k), 16 KB; a TF32 hi and lo copy, two of each.
constexpr int kBTFloats = kBN * kFwdBK;
constexpr int kFwdSmemBytes = 1024 + 4 * kBTFloats * 4 + kFwdStages * kFwdStageFloats * 4;

// A float32 x split into TF32 hi + lo, x - hi - lo within 2^-22 |x|.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// d (64 x 128, the warpgroup's accumulators) += a (64 x 8, TF32, from
// registers) @ b (8 x 128, TF32, K-major in shared memory at descriptor b).
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Accumulator d[i] of thread tid (of 256) lies at tile row
// 64 (tid / 128) + 16 (tid / 32 % 4) + (tid % 32) / 4 + 8 ((i / 2) % 2) and
// column 8 (i / 4) + 2 (tid % 4) + i % 2 (wgmma's m64nN fragment, one
// warpgroup a 64-row half).
__device__ __forceinline__ int forward_row(int tid, int i) {
  return 64 * (tid >> 7) + 16 * ((tid >> 5) & 3) + ((tid & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int forward_col(int tid, int i) { return 8 * (i >> 2) + 2 * (tid & 3) + (i & 1); }

// Stores accumulators d[i], d[i + 1] (one row, two adjacent columns) of the
// output tile at (r0, f0) of batch b, times `scale` (K1).
template <int kVec, bool kMask>
__device__ __forceinline__ void forward_store(float* __restrict__ out, float x0, float x1, int b, int r, int f,
                                              int NL, int F, float scale) {
  if (r >= NL || f >= F) return;
  if constexpr (kMask) {
    x0 *= scale;
    x1 *= scale;
  }
  float* dst = out + (static_cast<size_t>(b) * NL + r) * F + f;
  if constexpr (kVec >= 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
  } else {
    dst[0] = x0;
    if (f + 1 < F) dst[1] = x1;
  }
}

// ---------------------------------------------------------------------------
// K1 (kMask) and K3: out (N*L x F) = (A * mask) (N*L x N) @ V (N x F), per
// batch, scaled by 1/keep (K1), in output tiles of 128 of a batch's N*L
// rows by 128 columns, tile t = (b * row_tiles + y) * f_tiles + x (the
// column tiles of one band of A adjacent).
// Grid (G): block c walks tiles c, c + G, c + 2 G.., each over the `steps`
// 32-column steps of A's N columns (V's rows), the reduction, and streams
// the stages of all its tiles through one ring, so the next tile's copies
// overlap this tile's last products and its stores.
// ---------------------------------------------------------------------------
template <int kVec, bool kMask>
__global__ void __launch_bounds__(kThreads, 1)
dropedge_fwd_f32_kernel(const float* __restrict__ A, const float* __restrict__ V, float* __restrict__ out,
                        int B, int N, int NL, int F, int steps, const uint32_t* __restrict__ seed_ptr,
                        float keep) {
  const uint32_t seed = kMask ? __ldg(seed_ptr) : 0u;  // K3 passes no seed
  constexpr int kAChunksRow = kFwdBK / kVec;             // copies a 32-wide A row
  constexpr int kVChunksRow = kBN / kVec;                // copies a 128-wide V row
  constexpr int kChunks = kBM * kAChunksRow / kThreads;  // copies a thread, each operand
  static_assert(kChunks * kThreads == kFwdBK * kVChunksRow, "tile");
  // 4-byte copies (16 a thread and operand) stay a loop: unrolled, their
  // addresses take the registers the products need.
  constexpr int kCopyUnroll = kVec == 1 ? 1 : kChunks;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // The transposed V copies first, 1024-aligned (the swizzle's atom), then
  // the ring.
  const uint32_t raw_addr = grl::smem_u32(smem_raw);
  float* bt = reinterpret_cast<float*>(smem_raw + (((raw_addr + 1023u) & ~1023u) - raw_addr));
  float* smem = bt + 4 * kBTFloats;
  const int G = static_cast<int>(gridDim.x), first = static_cast<int>(blockIdx.x);
  const int row_tiles = (NL + kBM - 1) / kBM, f_tiles = (F + kBN - 1) / kBN;
  const int tiles = B * row_tiles * f_tiles;
  const int my_tiles = first < tiles ? (tiles - first + G - 1) / G : 0;
  const int stages = my_tiles * steps;  // the block's stream of stages
  const int tid = threadIdx.x;

  // A position in the block's stream: step k of tile t (batch b, first row
  // r0, first column f0). Stepping divides only where a tile ends.
  struct Cursor {
    int k, t, b, r0, f0;
  };
  const auto at_tile = [&](int t) {
    const int x = t % f_tiles, rest = t / f_tiles;
    return Cursor{0, t, rest / row_tiles, (rest % row_tiles) * kBM, x * kBN};
  };
  const auto step = [&](Cursor& c) {
    if (++c.k == steps) c = at_tile(c.t + G);
  };
  // The next stage to copy, to mask, and to finish.
  Cursor to_load = at_tile(first), to_mask = to_load, to_finish = to_load;

  // Stage g: columns 32 k.. of A's rows r0.. and the same rows of V
  // (columns f0..); a commit group even past the last stage, so the waits
  // below count the same groups at every stage.
  const auto load = [&](int g) {
    if (g < stages) {
      const Cursor w = to_load;
      step(to_load);
      float* As = smem + (g % kFwdStages) * kFwdStageFloats;
      float* Vs = As + kBM * kFwdAStride;
      const int c0 = w.k * kFwdBK;
      const float* Ab = A + static_cast<size_t>(w.b) * NL * N;
      const float* Vb = V + static_cast<size_t>(w.b) * N * F;
#pragma unroll kCopyUnroll
      for (int i = 0; i < kChunks; ++i) {
        const int c = tid + i * kThreads;
        const int row = c / kAChunksRow, col = (c % kAChunksRow) * kVec;
        const bool a_ok = w.r0 + row < NL && c0 + col < N;
        cp_async<kVec>(As + row * kFwdAStride + col,
                       a_ok ? Ab + static_cast<size_t>(w.r0 + row) * N + c0 + col : A, a_ok);
        const int vrow = c / kVChunksRow, vcol = (c % kVChunksRow) * kVec;
        const bool v_ok = c0 + vrow < N && w.f0 + vcol < F;
        cp_async<kVec>(Vs + vrow * kFwdVStride + vcol,
                       v_ok ? Vb + static_cast<size_t>(c0 + vrow) * F + w.f0 + vcol : V, v_ok);
      }
    }
    cp_async_commit();
  };

  // K1's mask over the A values this thread copied into stage g, once they
  // have landed. All of them are read first and their nonzero entries noted
  // as bits (one shared-memory round trip); only those are hashed (about
  // one in 500 at the main path's density of 0.002), and dropped ones are
  // written back as zero. The ragged edges are zero-filled.
  const auto mask = [&](int g) {
    const Cursor w = to_mask;
    step(to_mask);
    float* As = smem + (g % kFwdStages) * kFwdStageFloats;
    uint32_t nonzero = 0;  // bit kVec * i + e: entry e of the thread's copy i
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = tid + i * kThreads;
      const float* p = As + (c / kAChunksRow) * kFwdAStride + (c % kAChunksRow) * kVec;
      if constexpr (kVec == 4) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        nonzero |= ((v.x != 0.f ? 1u : 0u) | (v.y != 0.f ? 2u : 0u) | (v.z != 0.f ? 4u : 0u) |
                    (v.w != 0.f ? 8u : 0u)) << (4 * i);
      } else if constexpr (kVec == 2) {
        const float2 v = *reinterpret_cast<const float2*>(p);
        nonzero |= ((v.x != 0.f ? 1u : 0u) | (v.y != 0.f ? 2u : 0u)) << (2 * i);
      } else {
        nonzero |= (*p != 0.f ? 1u : 0u) << i;
      }
    }
#pragma unroll 1
    while (nonzero != 0u) {
      const int bit = __ffs(nonzero) - 1;
      nonzero &= nonzero - 1u;
      const int c = tid + (bit / kVec) * kThreads;
      const int row = c / kAChunksRow, col = (c % kAChunksRow) * kVec + bit % kVec;
      if (!keep_edge((static_cast<uint32_t>(w.b) * NL + w.r0 + row) * N + w.k * kFwdBK + col, seed, keep))
        As[row * kFwdAStride + col] = 0.f;
    }
  };

  // V's stage g, split into TF32 hi and lo and transposed into the K-major
  // 128-byte swizzled copies of buffer g % 2 (logical 16-byte chunk c of
  // row n at chunk c ^ (n % 8)). Thread tid takes row n = tid % 128 and the
  // four k-quads q = tid / 128 + 2 j: 4 reads down a column of V (a warp
  // reads 32 adjacent floats), one 16-byte store of each copy (8 adjacent
  // rows of a quarter-warp hit 8 distinct chunks).
  const auto transpose = [&](int g) {
    const float* Vs = smem + (g % kFwdStages) * kFwdStageFloats + kBM * kFwdAStride;
    float* hi = bt + (g % 2) * 2 * kBTFloats;
    float* lo = hi + kBTFloats;
    const int n = tid % kBN;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = tid / kBN + 2 * j;
      uint32_t h[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(Vs[(4 * q + e) * kFwdVStride + n], h[e], l[e]);
      const int at = n * kFwdBK + ((q ^ (n & 7)) << 2);
      *reinterpret_cast<uint4*>(hi + at) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo + at) = make_uint4(l[0], l[1], l[2], l[3]);
    }
    // The generic-proxy stores, before wgmma (the async proxy) reads them.
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  };

  // Stage g's products on the tensor cores, issued asynchronously: warpgroup
  // tid / 128 multiplies its 64 rows of A (from registers, split into TF32
  // hi and lo) by the 128 columns of V's transposed copies, four k-steps of
  // 8 in three passes, a_lo b_hi + a_hi b_lo + a_hi b_hi, so the float32
  // sum keeps ~22 bits of each product against TF32's 11.
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const auto products = [&](int g) {
    const float* As = smem + (g % kFwdStages) * kFwdStageFloats;
    const float* hi = bt + (g % 2) * 2 * kBTFloats;
    const float* lo = hi + kBTFloats;
    const int row = 64 * (tid >> 7) + 16 * ((tid >> 5) & 3) + ((tid & 31) >> 2), t = tid & 3;
    uint32_t a_hi[4][4], a_lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* p = As + row * kFwdAStride + 8 * kk + t;
      split_tf32(p[0], a_hi[kk][0], a_lo[kk][0]);                    // (row, t)
      split_tf32(p[8 * kFwdAStride], a_hi[kk][1], a_lo[kk][1]);      // (row + 8, t)
      split_tf32(p[4], a_hi[kk][2], a_lo[kk][2]);                    // (row, t + 4)
      split_tf32(p[8 * kFwdAStride + 4], a_hi[kk][3], a_lo[kk][3]);  // (row + 8, t + 4)
    }
    grl::fence_registers(acc);
    grl::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // k-step kk: 8 floats = 32 bytes along each K-major row
      wgmma_tf32(acc, a_lo[kk], grl::descriptor(hi + 8 * kk, 16, 1024));
      wgmma_tf32(acc, a_hi[kk], grl::descriptor(lo + 8 * kk, 16, 1024));
      wgmma_tf32(acc, a_hi[kk], grl::descriptor(hi + 8 * kk, 16, 1024));
    }
    grl::wgmma_commit();
  };
  const float scale = 1.0f / keep;

  // Stage g + 1's copies land, are transposed and masked (K1) while stage
  // g's products run on the tensor cores: a warp that hashes waits on the
  // hash while they run.
#pragma unroll
  for (int g = 0; g < kFwdStages - 1; ++g) load(g);
  if (stages > 0) {
    cp_async_wait<kFwdStages - 2>();  // this thread's copies of stage 0 have landed
    __syncthreads();
    transpose(0);
    if constexpr (kMask) mask(0);
    __syncthreads();
  }
  for (int g = 0; g < stages; ++g) {
    products(g);
    cp_async_wait<kFwdStages - 3>();  // this thread's copies of stage g + 1 have landed
    __syncthreads();  // stage g + 1 is visible; stage g - 1's ring slot and copies are free
    load(g + kFwdStages - 1);
    if (g + 1 < stages) {
      transpose(g + 1);
      if constexpr (kMask) mask(g + 1);  // A's entries this thread copied; read after the next barrier
    }
    grl::wgmma_wait_all();
    grl::fence_registers(acc);
    __syncthreads();  // stage g + 1 is transposed and masked; every product of stage g is done
    if (to_finish.k == steps - 1) {
      // The tile is done: its rows straight to out.
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        forward_store<kVec, kMask>(out, acc[i], acc[i + 1], to_finish.b, to_finish.r0 + forward_row(tid, i),
                                   to_finish.f0 + forward_col(tid, i), NL, F, scale);
        acc[i] = acc[i + 1] = 0.f;
      }
    }
    step(to_finish);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------
inline unsigned cdiv(int a, int b) { return static_cast<unsigned>((a + b - 1) / b); }

// The shape, copy width and pointers a kernel takes: `tiles` is its grid's
// y extent, which must fit 65535.
bool valid_shape(int B, int N, int L, int F, int vec, unsigned tiles, const void* x, const void* y, const void* z) {
  const auto aligned = [](const void* p, uintptr_t bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; };
  if (B <= 0 || N <= 0 || L <= 0 || F <= 0 || B > 65535 || tiles > 65535u) return false;
  if (static_cast<unsigned long long>(B) * N * L * N >= (1ull << 32)) return false;
  if (vec == 4) return N % 4 == 0 && F % 4 == 0 && aligned(x, 16) && aligned(y, 16) && aligned(z, 16);
  if (vec == 2) return N % 2 == 0 && F % 2 == 0 && aligned(x, 8) && aligned(y, 8) && aligned(z, 8);
  return vec == 1;
}

// Lets kKernel use its kBytes of dynamic shared memory (past the default
// 48 KB) on `device`, once per process and device.
template <auto kKernel, int kBytes>
cudaError_t raise_smem_limit(int device) {
  static std::atomic<uint64_t> raised{0};
  const uint64_t bit = device >= 0 && device < 64 ? 1ull << device : 0;
  if (raised.load(std::memory_order_acquire) & bit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err == cudaSuccess) raised.fetch_or(bit, std::memory_order_release);
  return err;
}

cudaLaunchConfig_t cluster_config(dim3 grid, int S, int smem, cudaStream_t stream, cudaLaunchAttribute* attr) {
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

// Launches kKernel on a (S * x_tiles, y_tiles, B) grid in clusters of S,
// its `steps` reduction steps split S ways.
template <auto kKernel, int kBytes>
int launch(const float* a, const float* x, float* out, unsigned x_tiles, unsigned y_tiles, int B, int N, int NL,
           int F, int steps, int S, const uint32_t* seed, float keep, int device, cudaStream_t stream) {
  if (S < 1 || S > kMaxSplits || steps % S != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = raise_smem_limit<kKernel, kBytes>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config =
      cluster_config(dim3(S * x_tiles, y_tiles, static_cast<unsigned>(B)), S, kBytes, stream, &attr);
  err = cudaLaunchKernelEx(&config, kKernel, a, x, out, N, NL, F, steps / S, seed, keep);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each launcher runs on `stream` of `device`, does not synchronise,
// allocates nothing, and returns cudaGetLastError() (cudaErrorInvalidValue
// for a shape, pointer or plan it does not take). All operands float32 and
// contiguous: A (B, N, L, N), V (B, N, F), g and out (B, N, L, F), dV
// (B, N, F). vec is the copy width in floats: 4 needs N % 4 == 0,
// F % 4 == 0 and 16-byte aligned operands; 2 (the forward only) N and F
// even and 8-byte aligned operands; 1 takes any.

// K2: dV = (A * keep(gid) / keep)^T @ g over A's (N*L, N) view, the N*L rows
// split S ways, S a divisor of ceil(N*L / 32) and at most 8.
extern "C" int grl_dropedge_f32_backward(const void* A, const void* g, void* dV, int B, int N, int L, int F,
                                         int S, int vec, const uint32_t* seed, float keep, int device,
                                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (vec == 2 || !valid_shape(B, N, L, F, vec, cdiv(N, kBM), A, g, dV))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* a = static_cast<const float*>(A);
  const auto* gp = static_cast<const float*>(g);
  auto* out = static_cast<float*>(dV);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int steps = static_cast<int>(cdiv(N * L, kBK));
  const unsigned x = cdiv(F, kBN), y = cdiv(N, kBM);
  return vec == 4 ? launch<dropedge_bwd_f32_kernel<4>, kSmemBytes>(a, gp, out, x, y, B, N, N * L, F, steps, S, seed,
                                                                   keep, device, s)
                  : launch<dropedge_bwd_f32_kernel<1>, kSmemBytes>(a, gp, out, x, y, B, N, N * L, F, steps, S, seed,
                                                                   keep, device, s);
}

template <auto kKernel>
int launch_forward(const float* a, const float* v, float* o, int B, int N, int L, int F, int blocks,
                   const uint32_t* seed, float keep, int device, cudaStream_t stream) {
  const long long tiles = static_cast<long long>(B) * cdiv(N * L, kBM) * cdiv(F, kBN);
  if (blocks < 1 || blocks > tiles) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = raise_smem_limit<kKernel, kFwdSmemBytes>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  kKernel<<<blocks, kThreads, kFwdSmemBytes, stream>>>(a, v, o, B, N, N * L, F, static_cast<int>(cdiv(N, kFwdBK)),
                                                       seed, keep);
  return static_cast<int>(cudaGetLastError());
}

// K1 (mask != 0) or K3 (mask == 0, keep ignored): out = (A * keep(gid) /
// keep) @ V, or A @ V, over A's (N*L, N) view in tiles of 128 x 128, on
// `blocks` blocks (1 to the tile count), block c walking tiles c,
// c + blocks... K1 at keep 1 gives K3's bits: it drops nothing and
// multiplies by exactly 1. `seed` points at the mask's seed in device
// memory (one uint32; K3 reads none and may pass null).
extern "C" int grl_dropedge_f32_forward(const void* A, const void* V, void* out, int B, int N, int L, int F,
                                        int blocks, int vec, int mask, const uint32_t* seed, float keep, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!valid_shape(B, N, L, F, vec, 1u, A, V, out)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* a = static_cast<const float*>(A);
  const auto* v = static_cast<const float*>(V);
  auto* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GRL_FORWARD(vec_, mask_) \
  launch_forward<dropedge_fwd_f32_kernel<vec_, mask_>>(a, v, o, B, N, L, F, blocks, seed, keep, device, s)
  if (vec == 4) return mask ? GRL_FORWARD(4, true) : GRL_FORWARD(4, false);
  if (vec == 2) return mask ? GRL_FORWARD(2, true) : GRL_FORWARD(2, false);
  return mask ? GRL_FORWARD(1, true) : GRL_FORWARD(1, false);
#undef GRL_FORWARD
}

// How many clusters of S blocks (16-byte copies) of K2 the card holds at
// once (cudaOccupancyMaxActiveClusters; 0 means it cannot launch them).
extern "C" int grl_dropedge_f32_max_clusters(int S, int device, int* clusters) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = raise_smem_limit<dropedge_bwd_f32_kernel<4>, kSmemBytes>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config = cluster_config(dim3(S, 1, 1), S, kSmemBytes, nullptr, &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, dropedge_bwd_f32_kernel<4>, &config));
}

// How many blocks of the forward (16-byte copies) the card runs at once:
// its blocks an SM times the SMs.
extern "C" int grl_dropedge_f32_forward_slots(int device, int* slots) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = raise_smem_limit<dropedge_fwd_f32_kernel<4, true>, kFwdSmemBytes>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dropedge_fwd_f32_kernel<4, true>, kThreads,
                                                      kFwdSmemBytes);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  *slots = per_sm * sms;
  return static_cast<int>(err);
}

extern "C" const char* grl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
