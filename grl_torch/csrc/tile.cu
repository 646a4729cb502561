// K7: relational aggregation over dense adjacency tiles, DropEdge fused,
// on Hopper (sm_90a).
//
// Replaces grl_tpu/ops/tile.py:_apply_tables (:220-276), XLA on the TPU,
// as tile_aggregate (:502) and tile_aggregate_projected (:565) call it in
// all four directions. A planned direction holds, per relation and width
// bucket, rows of W dense B x B tiles side by side along the contraction
// axis (the K-concat layout, (rows, B, W*B)), each row's source block ids
// (col) and its output block. For output block o, relation r and the row
// j of r's tables that holds o:
//
//     out[o*B + a, :] = sum_w sum_k  round(tiles[j, a, w*B + k] * keep_pair(recv, send))
//                                    * X[col[j, w]*B + k, :]
//
// a float32 sum, where round() takes the masked cell to the operand's
// dtype (tiles.astype(dt) there) and keep_pair (hash.cuh) is 1/keep or 0,
// keyed on the seed xor the relation's mix. In the forward layout recv =
// o*B + a and send = col*B + k; in the transposed (backward) tables the
// two swap, so both walks draw one mask. The source row stride and
// relation offset, and the output's, pick the direction:
//
//   forward             X = V (N, F)           -> out (N, L*F), relation r at column r*F
//   projected forward   X = Vr, row n*L + r    -> out (N, F), relations summed
//   backward            X = g, column r*F      -> out (N, F), relations summed
//   projected backward  X = g (N, F)           -> out (N*L, F), relation r at row n*L + r
//
// In the stacked directions each relation's sum is rounded to the operand
// dtype on its own (a relation with no tables writes exact zeros); in the
// summed ones the relations add in float32 and round once. Rows at N or
// beyond read as 0 and are never written.
//
// Design (simple first). One CTA of 4 warps owns 64 output rows of one
// output block and 64 output columns, and walks every relation in one
// launch. It finds its table row through row_of_block, grl_tpu's inv_perm
// offset to the relation's rows, so the stitch is fused into the write.
// For each of the row's tiles (the per-row tile count skips the padding
// slots, which hold zero tiles) it walks the contraction 32 columns at a
// time: it stages the 64 x 32 slice of the tile in shared memory, masking
// and rounding each nonzero cell as it goes (zero cells are not hashed),
// and the 32 x 64 slice of the source block, then multiplies with float32
// accumulation: mma.sync m16n8k16 on bf16 operands (a warp owns 32 x 32
// outputs), plain FMA on float32 ones (no TF32). No atomics: two launches
// give the same bits. The seed is read from device memory, so a captured
// CUDA graph draws new masks at each replay.
//
// What bounds it. At the clustered arxiv plan (B = 128, 3,712 tile slots
// a direction, 3,198 of them tiles, F = 256 bf16) a call must move the
// real tiles (104.8 MB of bf16; padding slots are skipped), X and out
// (87 MB each): ~278 MB, or 0.083 ms at 3.35 TB/s, against 27 GFLOP of
// tile products (0.027 ms at the bf16 tensor rate): it is bound by bytes,
// mostly the tiles, which do not fit the 50 MB L2 (121.6 MB of slots). The CTAs of one output block are launched next to
// each other (the column chunk is the fastest grid index) so that a tile
// slice read from HBM by one is found in L2 by the others. This design
// hashes every nonzero cell once for each column chunk and stages with
// plain loads and barriers (no cp.async ring, no wgmma): a later PR's work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "hash.cuh"
#include "vec.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kBM = 64;        // output rows of a CTA
constexpr int kBN = 64;        // output columns of a CTA
constexpr int kKC = 32;        // contraction columns staged at a time
constexpr int kCells = kBM * kKC / kThreads;  // tile cells a thread stages (16)
// bf16 rows of 40 elements (80 bytes): the fragment loads of a warp
// (8 rows x 4 words) fall on 32 distinct banks.
constexpr int kPad = 8;

template <typename XT>
struct Smem;
template <>
struct Smem<__nv_bfloat16> {
  __nv_bfloat16 a[kBM][kKC + kPad];  // masked tile slice, (row, k)
  __nv_bfloat16 x[kBN][kKC + kPad];  // source slice, transposed: (column, k)
};
template <>
struct Smem<float> {
  float a[kBM][kKC + 1];  // masked tile slice, (row, k)
  float x[kKC][kBN + 4];  // source slice, (k, column)
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One CTA: output rows o*B + m0 .. + kBM of block o = blockIdx.z, columns
// c0 .. c0 + kBN. TileT: the tiles' storage dtype; XT: the operand's (X and
// out): bf16 multiplies on mma.sync, float32 with FMA.
template <typename TileT, typename XT>
__global__ void __launch_bounds__(kThreads)
tile_apply_kernel(const TileT* __restrict__ tiles, const int* __restrict__ col, const int* __restrict__ rows,
                  const int* __restrict__ row_of_block, const int* __restrict__ rel_mix,
                  const XT* __restrict__ X, XT* __restrict__ out, int N, int nb, int B, int L, int F,
                  long long src_row_stride, long long src_rel_offset, long long out_row_stride,
                  long long out_rel_offset, int stack, int transposed, int use_hash,
                  const uint32_t* __restrict__ seed_ptr, float keep) {
  constexpr bool kMma = std::is_same<XT, __nv_bfloat16>::value;
  constexpr int kTileElems = grl::Vec<TileT>::kElems;
  __shared__ __align__(16) Smem<XT> sm;

  const int t = threadIdx.x;
  const int c0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int o = blockIdx.z;
  const uint32_t seed = use_hash ? __ldg(seed_ptr) : 0u;  // the mask's seed, in device memory
  const float inv_keep = 1.0f / keep;
  // Staging: tile row sa, cells sc .. sc + kCells of the slice; source row
  // xk of the slice.
  const int sa = t >> 1, sc = (t & 1) * kCells;
  const int xk = t >> 2;

  // mma.sync: acc[mi * 4 + ni] is the (16 x 8) fragment (mi, ni) of the
  // warp's 32 x 32 outputs; FMA: acc[i][q] is row ty * 8 + i, column
  // tx * 4 + q.
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;

  // The output: rows o*B + m0 + row, columns c0 + column, at relation r.
  auto write = [&](int r) {
    XT* base = out + static_cast<long long>(r) * out_rel_offset;
    if constexpr (kMma) {
      const int warp = t >> 5, lane = t & 31, g = lane >> 2, tg = lane & 3;
      const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const long long n = static_cast<long long>(o) * B + m0 + wm * 32 + mi * 16 + g + 8 * h;
            const int c = c0 + wn * 32 + ni * 8 + tg * 2;
            if (n < N && c < F) {
              *reinterpret_cast<uint32_t*>(base + n * out_row_stride + c) =
                  pack_bf16(acc[mi * 4 + ni][2 * h], acc[mi * 4 + ni][2 * h + 1]);
            }
          }
    } else {
      const int ty = t >> 4, tx = t & 15;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const long long n = static_cast<long long>(o) * B + m0 + ty * 8 + i;
        const int c = c0 + tx * 4;
        if (n < N && c < F)
          *reinterpret_cast<float4*>(base + n * out_row_stride + c) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }
  };

  for (int r = 0; r < L; ++r) {
    const int j = __ldg(row_of_block + static_cast<long long>(r) * nb + o);
    if (j >= 0) {
      const int first_slot = __ldg(rows + 3 * j), W = __ldg(rows + 3 * j + 1), count = __ldg(rows + 3 * j + 2);
      const uint32_t seed_r = seed ^ static_cast<uint32_t>(__ldg(rel_mix + r));
      const XT* src = X + static_cast<long long>(r) * src_rel_offset;
      // Tile row m0 + sa of table row j.
      const TileT* tile_row = tiles + static_cast<size_t>(first_slot) * B * B + static_cast<size_t>(m0 + sa) * W * B;
      const uint32_t a_id = static_cast<uint32_t>(o * B + m0 + sa);
      for (int w = 0; w < count; ++w) {
        const int s = __ldg(col + first_slot + w);
        for (int kk = 0; kk < B; kk += kKC) {
          // The tile slice, masked and rounded cell by cell.
          float v[kCells];
#pragma unroll
          for (int q = 0; q < kCells; q += kTileElems) {
            float x[kTileElems];
            grl::load16<TileT, kTileElems>(tile_row + static_cast<size_t>(w) * B + kk + sc + q, x);
#pragma unroll
            for (int e = 0; e < kTileElems; ++e) v[q + e] = x[e];
          }
          if (use_hash) {
#pragma unroll
            for (int e = 0; e < kCells; ++e) {
              if (v[e] != 0.f) {
                const uint32_t k_id = static_cast<uint32_t>(s * B + kk + sc + e);
                const bool kept = transposed ? grl::keep_pair(k_id, a_id, seed_r, keep)
                                             : grl::keep_pair(a_id, k_id, seed_r, keep);
                v[e] = kept ? __fmul_rn(v[e], inv_keep) : 0.f;
              }
            }
          }
          // The source slice: rows s*B + kk + xk, columns c0 ...; rows at N
          // or beyond and columns at F or beyond are zeros.
          const long long n = static_cast<long long>(s) * B + kk + xk;
          const XT* xrow = src + n * src_row_stride;
          if constexpr (kMma) {
            uint4 packed[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float p[8];
#pragma unroll
              for (int e = 0; e < 8; ++e) p[e] = v[h * 8 + e];
              packed[h] = grl::pack16(p);
            }
            *reinterpret_cast<uint4*>(&sm.a[sa][sc]) = packed[0];
            *reinterpret_cast<uint4*>(&sm.a[sa][sc + 8]) = packed[1];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int cl = ((t & 3) * 2 + h) * 8;  // slice column of this 8-wide vector
              float x[8];
              if (n < N && c0 + cl < F) {
                grl::load16<XT, 8>(xrow + c0 + cl, x);
              } else {
#pragma unroll
                for (int e = 0; e < 8; ++e) x[e] = 0.f;
              }
#pragma unroll
              for (int e = 0; e < 8; ++e) sm.x[cl + e][xk] = __float2bfloat16_rn(x[e]);
            }
          } else {
#pragma unroll
            for (int e = 0; e < kCells; ++e) sm.a[sa][sc + e] = v[e];
#pragma unroll
            for (int h = 0; h < 4; ++h) {
              const int cl = ((t & 3) * 4 + h) * 4;
              float x[4];
              if (n < N && c0 + cl < F) {
                grl::load16<XT, 4>(xrow + c0 + cl, x);
              } else {
#pragma unroll
                for (int e = 0; e < 4; ++e) x[e] = 0.f;
              }
              *reinterpret_cast<float4*>(&sm.x[xk][cl]) = make_float4(x[0], x[1], x[2], x[3]);
            }
          }
          __syncthreads();
          if constexpr (kMma) {
            const int warp = t >> 5, lane = t & 31, g = lane >> 2, tg = lane & 3;
            const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
            for (int ks = 0; ks < kKC; ks += 16) {
              const int kb = ks + tg * 2;
              uint32_t a[2][4];
#pragma unroll
              for (int mi = 0; mi < 2; ++mi) {
                const int row = wm * 32 + mi * 16 + g;
                a[mi][0] = *reinterpret_cast<const uint32_t*>(&sm.a[row][kb]);
                a[mi][1] = *reinterpret_cast<const uint32_t*>(&sm.a[row + 8][kb]);
                a[mi][2] = *reinterpret_cast<const uint32_t*>(&sm.a[row][kb + 8]);
                a[mi][3] = *reinterpret_cast<const uint32_t*>(&sm.a[row + 8][kb + 8]);
              }
#pragma unroll
              for (int ni = 0; ni < 4; ++ni) {
                const int cn = wn * 32 + ni * 8 + g;
                const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&sm.x[cn][kb]);
                const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&sm.x[cn][kb + 8]);
#pragma unroll
                for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi * 4 + ni], a[mi], b0, b1);
              }
            }
          } else {
            const int ty = t >> 4, tx = t & 15;
#pragma unroll 8
            for (int k = 0; k < kKC; ++k) {
              const float4 b = *reinterpret_cast<const float4*>(&sm.x[k][tx * 4]);
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                const float a = sm.a[ty * 8 + i][k];
                acc[i][0] = fmaf(a, b.x, acc[i][0]);
                acc[i][1] = fmaf(a, b.y, acc[i][1]);
                acc[i][2] = fmaf(a, b.z, acc[i][2]);
                acc[i][3] = fmaf(a, b.w, acc[i][3]);
              }
            }
          }
          __syncthreads();
        }
      }
    }
    if (stack) {
      write(r);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
    }
  }
  if (!stack) write(0);
}

template <typename TileT, typename XT>
int launch(const void* tiles, const int* col, const int* rows, const int* row_of_block, const int* rel_mix,
           const void* X, void* out, int N, int nb, int B, int L, int F, long long src_row_stride,
           long long src_rel_offset, long long out_row_stride, long long out_rel_offset, int stack,
           int transposed, int use_hash, const uint32_t* seed, float keep, cudaStream_t stream) {
  const dim3 grid((F + kBN - 1) / kBN, B / kBM, nb);
  tile_apply_kernel<TileT, XT><<<grid, kThreads, 0, stream>>>(
      static_cast<const TileT*>(tiles), col, rows, row_of_block, rel_mix, static_cast<const XT*>(X),
      static_cast<XT*>(out), N, nb, B, L, F, src_row_stride, src_rel_offset, out_row_stride, out_rel_offset,
      stack, transposed, use_hash, seed, keep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K7 on `stream` of `device`, does not synchronise, allocates
// nothing, and returns cudaGetLastError(). tiles: every relation's buckets
// raveled and concatenated, (slots * B * B,) in tile_dtype; col: int32
// (slots,); rows: int32 (table rows, 3) = (first slot, width W, tile
// count); row_of_block: int32 (L, nb), the table row of each (relation,
// output block), or -1 where the relation has no tables; rel_mix: int32
// (L,), each relation's seed mix. X's row n of relation r starts at
// element n * src_row_stride + r * src_rel_offset; out's at n *
// out_row_stride + r * out_rel_offset (stack) or n * out_row_stride (the
// relations summed). dtype and tile_dtype: 0 = float32, 1 = bfloat16. B a
// multiple of 64, F of 8, X and out 16-byte aligned, nb <= 65535. seed
// points at the mask's seed in device memory (one uint32), read only where
// use_hash is set.
extern "C" int grl_tile_apply(const void* tiles, const void* col, const void* rows, const void* row_of_block,
                              const void* rel_mix, const void* X, void* out, int num_nodes, int nb, int B, int L,
                              int F, long long src_row_stride, long long src_rel_offset, long long out_row_stride,
                              long long out_rel_offset, int stack, int transposed, int tile_dtype, int dtype,
                              int use_hash, const uint32_t* seed, float keep, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || B % kBM != 0 || F <= 0 || F % 8 != 0 || nb < 1 || nb > 65535 || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* c = static_cast<const int*>(col);
  const int* rw = static_cast<const int*>(rows);
  const int* rb = static_cast<const int*>(row_of_block);
  const int* mix = static_cast<const int*>(rel_mix);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GRL_TILE_LAUNCH(TileT, XT)                                                                              \
  return launch<TileT, XT>(tiles, c, rw, rb, mix, X, out, num_nodes, nb, B, L, F, src_row_stride, src_rel_offset, \
                           out_row_stride, out_rel_offset, stack, transposed, use_hash, seed, keep, s)
  if (tile_dtype == 1 && dtype == 1) GRL_TILE_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (tile_dtype == 0 && dtype == 1) GRL_TILE_LAUNCH(float, __nv_bfloat16);
  if (tile_dtype == 1 && dtype == 0) GRL_TILE_LAUNCH(__nv_bfloat16, float);
  if (tile_dtype == 0 && dtype == 0) GRL_TILE_LAUNCH(float, float);
#undef GRL_TILE_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* grl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
