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
// beyond read as 0 and are never written. Each output element is summed by
// one warpgroup in a fixed order with no atomics, so two launches give the
// same bits; the seed is read from device memory, so a captured CUDA graph
// draws new masks at each replay. Two routes, picked on the host by dtype
// alone (grl_torch/ops/tile.py:launch_plan).
//
// What bounds it. At the clustered arxiv plan (B = 128, 3198 tiles in
// ~3,700 slots a direction, 1.5% of their cells nonzero, F = 256 bf16) a
// call must move the real tiles (104.8 MB of bf16; a padding slot adds
// exact zeros and is skipped), X and out (86.7 MB each): ~278 MB, or
// 0.083 ms at 3.35 TB/s, against 27 GFLOP of tile products (0.027 ms at
// the bf16 tensor rate): bytes bound it, mostly the tiles, which do not
// fit the 50 MB L2. A tile's source block (64 KB at F = 256) is read for
// each of its tiles, 210 MB in all, much of it from L2 under the LPA
// order, which keeps a block's source blocks near it.
//
// The persistent route: bfloat16 tiles under bfloat16 operands, the path
// the tile phase and configs/arxiv_full_graph.yaml's bf16 run take. The
// simple first kernel (the other route, below) re-staged and re-hashed
// every tile once per 64-column chunk, staged through registers with no
// load in flight during its products, and lived a few steps a CTA with
// its prologue and epilogue exposed: 0.42 ms at F = 256, 18-20% of the
// bound. This design:
// - Persistent CTAs, one a SM, each walking a fixed list of work items
//   (output block; 128-row pair of 64-row parts where 128 divides B, else
//   one part; column chunk: F in the fewest chunks of at most 256 columns,
//   BN a chunk's width rounded up to 64) that the
//   host deals out once per plan and width, in block order, each item to
//   the CTA with the least work so far: the CTAs run items of neighbouring
//   blocks at one time, so the source blocks they share under the LPA order
//   are found in L2, and they finish together.
// - A ring of stages in dynamic shared memory (four at BN = 256), filled by
//   a producer warpgroup that runs ahead across items while the consumers
//   write the last one out. A stage holds one 64-column slice of a tile for
//   each consumer (64 x 64, K-major, 128-byte swizzle) and the matching 64
//   source rows of BN columns (MN-major, BN / 64 boxes of 64 x 64). The
//   source boxes come by TMA, through one 3-D map (column, relation, row)
//   over X that the launcher encodes at each call: the backward's column
//   offset r*F and the projected forward's row n*L + r are the same
//   address, and TMA zero-fills rows at N or beyond and columns at F or
//   beyond, so the ragged last block needs no code. The tile slices come by
//   16-byte cp.async into the swizzled layout, completing on the stage's
//   mbarrier (cp.async.mbarrier.arrive), 8 copies a producer thread a
//   stage: each table row has its own width W, so a TMA map would be
//   needed for each width bucket, made per plan and kept in device memory,
//   where cp.async reads the K-concat rows at any W with no map.
// - Two consumer warpgroups (one where 128 does not divide B), each owning
//   a 64 x BN output fragment in float32 registers and one 64-row tile
//   slice of the stage, sharing the source boxes: a source block is staged
//   once for 128 output rows. Each masks its slice in place, as K1's
//   mask_tile does: it scans its 16-byte chunks, hashes only the nonzero
//   cells (~60 of 4096 here) and rewrites each as bf16(w * 1/keep) or 0,
//   then fences the async proxy and meets at its own barrier; wgmma
//   .m64nBNk16 then reads the slice K-major and the source MN-major. At
//   F <= 256 every cell is staged and hashed once; at F = 512 once for each
//   of the two column chunks, which run as neighbouring work items. One
//   step's products stay in flight while the next stage is masked; a stage
//   is handed back to the producer once the products after it are issued.
// - The epilogue rounds to bf16 through a 64 x 64 staging box a consumer
//   and writes 16-byte stores, one 64-column box at a time: the staging
//   stays outside the ring, so the producer keeps loading meanwhile.
// The producer warpgroup gives registers to the consumers (setmaxnreg),
// which keep up to 128 float32 accumulators a thread. Nothing touches the
// accumulators while products are in flight (a register fence there made
// ptxas wait after every step), and the stacked and summed epilogues are
// separate instantiations (one inside the relation loop, as a runtime
// branch, spilled): ptxas reports no spill and no serialized wgmma. On an
// H100 (700 W), on the clustered plan at F = 256, a launch takes ~0.12 ms,
// ~70% of the bound, against the simple route's 0.42 (PERF.md, K7's row).
//
// The simple route: every other dtype pair (float32 tiles, float32
// operands). One CTA of 4 warps owns 64 output rows of one output block
// and 64 output columns, and walks every relation in one launch. It finds
// its table row through row_of_block, grl_tpu's inv_perm offset to the
// relation's rows, so the stitch is fused into the write. For each of the
// row's tiles (the per-row tile count skips the padding slots, which hold
// zero tiles) it walks the contraction 32 columns at a time: it stages the
// 64 x 32 slice of the tile in shared memory, masking and rounding each
// nonzero cell as it goes (zero cells are not hashed), and the 32 x 64
// slice of the source block, then multiplies with float32 accumulation:
// mma.sync m16n8k16 on bf16 operands (a warp owns 32 x 32 outputs), plain
// FMA on float32 ones (no TF32). The CTAs of one output block are launched
// next to each other so that a tile slice read from HBM by one is found in
// L2 by the others. Its float32-operand products are the next to redesign
// (3xTF32 wgmma, as dropedge_f32.cu's K1/K3).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "hash.cuh"
#include "sm90.cuh"
#include "vec.cuh"

// ---------------------------------------------------------------------------
// The simple route
// ---------------------------------------------------------------------------
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

// ---------------------------------------------------------------------------
// The persistent route: bfloat16 tiles under bfloat16 operands
// ---------------------------------------------------------------------------
namespace {

constexpr int kWarpgroup = 128;
constexpr int kBox = 64;                          // a staged box: 64 x 64 bf16, 128-byte rows
constexpr int kBoxBytes = kBox * kBox * 2;        // 8 KB
constexpr int kEpiStride = kBox + 8;              // staging row, bf16: shifts rows by 4 banks
constexpr int kEpiBytes = kBox * kEpiStride * 2;  // a consumer's epilogue box
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 232448;               // the H100's dynamic shared memory a block
// Registers a thread after the producer gives its own away (two consumers).
constexpr int kProducerRegs = 56, kConsumerRegs = 224;

__host__ __device__ constexpr int stage_bytes(int BN, int consumers) { return kBoxBytes * (consumers + BN / 64); }
// 1024 bytes of alignment slack, the ring, the consumers' epilogue boxes,
// and a full and an empty mbarrier a stage (grl_torch/ops/tile.py:
// persistent_smem gives the same sum).
__host__ __device__ constexpr int smem_bytes(int BN, int consumers, int stages) {
  return 1024 + stages * stage_bytes(BN, consumers) + consumers * kEpiBytes + 16 * stages;
}

struct Params {
  const __nv_bfloat16* tiles;
  const int* col;
  const int* rows;
  const int* row_of_block;
  const int* rel_mix;
  const int* work;  // the CTAs' first items (ctas + 1), then the items
  __nv_bfloat16* out;
  long long out_row_stride, out_rel_offset;
  int N, nb, B, L, F, src_relations, chunks, parts, stages, ctas, transposed, use_hash;
  const uint32_t* seed;
  float keep;
};

// A work item: output block o, its rows m0.. (the item's first row within
// the block), columns c0.. .
struct Item {
  int o, m0, c0;
};

template <int BN, int kWG>
__device__ __forceinline__ Item decode(int item, const Params& p) {
  const int rest = item / p.chunks;
  return {rest / p.parts, (rest % p.parts) * kBox * kWG, (item % p.chunks) * BN};
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(__cvta_generic_to_global(src))
               : "memory");
}

// An arrival on `bar` once every cp.async this thread issued has landed;
// it counts as one of the barrier's expected arrivals.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(grl::smem_u32(bar)) : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Consumer warpgroup w's own barrier (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void consumer_sync(int w) { asm volatile("bar.sync %0, 128;" ::"r"(1 + w) : "memory"); }

// The mask pass over a consumer's staged 64 x 64 tile slice (thread tid <
// 128 of the warpgroup): cells of output rows out0.. and source columns
// src0.. ; cp.async wrote logical chunk c of row r at chunk c ^ (r % 8).
// Each nonzero cell becomes bf16(w * 1/keep) where the pair hash keeps it
// and 0 where it drops it; zero cells (+0 or -0) are not hashed.
__device__ __forceinline__ void mask_slice(uint8_t* box, int tid, uint32_t out0, uint32_t src0, uint32_t seed,
                                           float keep, float inv_keep, bool transposed) {
  constexpr int kChunks = kBox * 8 / kWarpgroup;  // 16-byte chunks a thread (4)
  uint32_t nonzero = 0;                           // bit 8 * i + e: entry e of the thread's chunk i
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const uint4 v = *reinterpret_cast<const uint4*>(box + (tid + i * kWarpgroup) * 16);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if ((w[e >> 1] >> (16 * (e & 1))) & 0x7FFFu) nonzero |= 1u << (8 * i + e);
  }
#pragma unroll 1
  while (nonzero != 0u) {
    const int bit = __ffs(nonzero) - 1;
    nonzero &= nonzero - 1u;
    const int q = tid + (bit >> 3) * kWarpgroup;  // physical chunk q: row q / 8, slot q % 8
    const int r = q >> 3, e = bit & 7;
    const uint32_t out_id = out0 + r;
    const uint32_t src_id = src0 + static_cast<uint32_t>(((q & 7) ^ (r & 7)) * 8 + e);
    const bool kept = transposed ? grl::keep_pair(src_id, out_id, seed, keep) : grl::keep_pair(out_id, src_id, seed, keep);
    uint16_t* cell = reinterpret_cast<uint16_t*>(box + q * 16) + e;
    const float w = __uint_as_float(static_cast<uint32_t>(*cell) << 16);
    const __nv_bfloat16 masked = __float2bfloat16_rn(kept ? __fmul_rn(w, inv_keep) : 0.f);
    *cell = *reinterpret_cast<const uint16_t*>(&masked);
  }
}

// The producer warpgroup (thread tid < 128): for each step of each item, a
// stage's tile slices by cp.async (4 x kWG 16-byte copies a thread) and its
// BN / 64 source boxes by TMA (thread 0).
template <int BN, int kWG>
__device__ __forceinline__ void produce(const CUtensorMap* map_x, const Params& p, uint8_t* ring, uint64_t* full,
                                        uint64_t* empty, int tid, int first, int last) {
  constexpr int kStage = stage_bytes(BN, kWG);
  const int* items = p.work + p.ctas + 1;
  const int B = p.B, S = p.stages, slices = B / kBox;
  int k = 0;
  for (int it = first; it < last; ++it) {
    const Item item = decode<BN, kWG>(__ldg(items + it), p);
    for (int r = 0; r < p.L; ++r) {
      const int j = __ldg(p.row_of_block + static_cast<long long>(r) * p.nb + item.o);
      if (j < 0) continue;
      const int slot0 = __ldg(p.rows + 3 * j), W = __ldg(p.rows + 3 * j + 1), count = __ldg(p.rows + 3 * j + 2);
      const int rel = p.src_relations > 1 ? r : 0;
      // Row item.m0 of table row j's K-concat (B, W*B) matrix.
      const __nv_bfloat16* rows = p.tiles + static_cast<size_t>(slot0) * B * B + static_cast<size_t>(item.m0) * W * B;
      for (int t = 0; t < count; ++t) {
        const int s = __ldg(p.col + slot0 + t);
        for (int ks = 0; ks < slices; ++ks, ++k) {
          const int stage = k % S;
          grl::mbar_wait(empty + stage, ((k / S) & 1) ^ 1);
          uint8_t* base = ring + stage * kStage;
          if (tid == 0) {
            grl::mbar_expect_tx(full + stage, (BN / 64) * kBoxBytes);
#pragma unroll
            for (int jb = 0; jb < BN / 64; ++jb)
              grl::tma_load(base + (kWG + jb) * kBoxBytes, map_x, full + stage, item.c0 + 64 * jb, rel,
                            s * B + ks * kBox);
          }
          // Thread tid copies chunk tid % 8 of rows tid / 8 + 16 i (i < 4 kWG),
          // to slot (tid % 8) ^ (row % 8) of its row: row % 8 is fixed.
          const __nv_bfloat16* from = rows + t * B + ks * kBox + static_cast<size_t>(tid >> 3) * W * B + (tid & 7) * 8;
          const size_t step = static_cast<size_t>(16) * W * B;
          const uint32_t to = grl::smem_u32(base) + (tid >> 3) * 128 + (((tid & 7) ^ ((tid >> 3) & 7)) << 4);
#pragma unroll
          for (int i = 0; i < 4 * kWG; ++i)
            cp_async16(to + (i >> 2) * kBoxBytes + (i & 3) * 16 * 128, from + i * step);
          cp_async_arrive(full + stage);
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Consumer warpgroup w's fragment rounded to bf16, rows o*B + m0.. (< N),
// columns c0.. (< F), at element offset `rel` of out: one 64-column box at
// a time through the warpgroup's staging box, 16-byte stores.
template <int BN>
__device__ __forceinline__ void write_fragment(const float (&acc)[BN / 2], __nv_bfloat16* staging, const Params& p,
                                               const Item& item, int m0, long long rel, int w, int tid) {
  __nv_bfloat16* base = p.out + rel;
#pragma unroll
  for (int jb = 0; jb < BN / 64; ++jb) {
    const int f0 = item.c0 + 64 * jb;
    if (f0 >= p.F) break;
#pragma unroll
    for (int i = 32 * jb; i < 32 * jb + 32; i += 2)
      *reinterpret_cast<__nv_bfloat162*>(staging + grl::frag_row(tid, i) * kEpiStride + grl::frag_col(tid, i) -
                                         64 * jb) = __floats2bfloat162_rn(acc[i], acc[i + 1]);
    consumer_sync(w);
#pragma unroll
    for (int q = tid; q < kBox * 8; q += kWarpgroup) {
      const int row = q >> 3, c = q & 7;
      const long long n = static_cast<long long>(item.o) * p.B + m0 + row;
      const int f = f0 + 8 * c;
      if (n < p.N && f < p.F)
        *reinterpret_cast<uint4*>(base + n * p.out_row_stride + f) =
            *reinterpret_cast<const uint4*>(staging + row * kEpiStride + 8 * c);
    }
    consumer_sync(w);
  }
}

// Every product in flight has landed; the stage they read goes back to the
// producer.
template <int BN>
__device__ __forceinline__ void drain(float (&acc)[BN / 2], uint64_t* empty, int& held) {
  wgmma_wait<0>();
  grl::fence_registers(acc);
  if (held >= 0) grl::mbar_arrive(empty + held);
  held = -1;
}

// Consumer warpgroup w (thread tid < 128 of it): rows m0 + 64 w.. of each
// item, every relation's tiles in turn; kStack: each relation written on
// its own, else their sum once.
template <int BN, int kWG, bool kStack>
__device__ __forceinline__ void consume(const Params& p, uint8_t* ring, uint8_t* epilogue, uint64_t* full,
                                        uint64_t* empty, int w, int tid, int first, int last) {
  constexpr int kStage = stage_bytes(BN, kWG);
  const int* items = p.work + p.ctas + 1;
  const int B = p.B, S = p.stages, slices = B / kBox;
  const uint32_t seed = p.use_hash ? __ldg(p.seed) : 0u;  // the mask's seed, in device memory
  const float inv_keep = 1.0f / p.keep;
  __nv_bfloat16* staging = reinterpret_cast<__nv_bfloat16*>(epilogue + w * kEpiBytes);
  float acc[BN / 2];
  int k = 0;
  int held = -1;  // the stage the products in flight may still read

  for (int it = first; it < last; ++it) {
    const Item item = decode<BN, kWG>(__ldg(items + it), p);
    const int m0 = item.m0 + kBox * w;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int r = 0; r < p.L; ++r) {
      const int j = __ldg(p.row_of_block + static_cast<long long>(r) * p.nb + item.o);
      if (j >= 0) {
        const int slot0 = __ldg(p.rows + 3 * j), count = __ldg(p.rows + 3 * j + 2);
        const uint32_t seed_r = seed ^ static_cast<uint32_t>(__ldg(p.rel_mix + r));
        for (int t = 0; t < count; ++t) {
          const int s = __ldg(p.col + slot0 + t);
          for (int ks = 0; ks < slices; ++ks, ++k) {
            const int stage = k % S;
            grl::mbar_wait(full + stage, (k / S) & 1);
            uint8_t* base = ring + stage * kStage;
            uint8_t* slice = base + w * kBoxBytes;
            if (p.use_hash)
              mask_slice(slice, tid, static_cast<uint32_t>(item.o * B + m0), static_cast<uint32_t>(s * B + ks * kBox),
                         seed_r, p.keep, inv_keep, p.transposed != 0);
            // The stage's generic-proxy writes (cp.async, the mask) before
            // wgmma's async-proxy reads, for the whole warpgroup.
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            consumer_sync(w);
            grl::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kBox / 16; ++kk)  // the slice K-major: 16 columns = 32 bytes on
              grl::wgmma<BN, 0, 1>(acc, grl::descriptor(slice + 32 * kk, 16, 1024),
                                   grl::descriptor(base + kWG * kBoxBytes + 2048 * kk, kBoxBytes, 1024));
            grl::wgmma_commit();
            wgmma_wait<1>();  // the previous step's products have read their stage
            if (held >= 0) grl::mbar_arrive(empty + held);
            held = stage;
          }
        }
      }
      if constexpr (kStack) {
        drain<BN>(acc, empty, held);
        write_fragment<BN>(acc, staging, p, item, m0, r * p.out_rel_offset, w, tid);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      }
    }
    if constexpr (!kStack) {
      drain<BN>(acc, empty, held);
      write_fragment<BN>(acc, staging, p, item, m0, 0, w, tid);
    }
  }
}

template <int BN, int kWG, bool kStack>
__global__ void __launch_bounds__(kWarpgroup * (kWG + 1), 1)
tile_apply_persistent_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = grl::smem_u32(smem_raw);
  uint8_t* ring = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint8_t* epilogue = ring + p.stages * stage_bytes(BN, kWG);
  uint64_t* full = reinterpret_cast<uint64_t*>(epilogue + kWG * kEpiBytes);
  uint64_t* empty = full + p.stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      grl::mbar_init(full + s, kWarpgroup + 1);  // the producers' cp.async arrivals and thread 0's expect_tx
      grl::mbar_init(empty + s, kWG * kWarpgroup);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / kWarpgroup, tid = threadIdx.x % kWarpgroup;
  const int first = __ldg(p.work + blockIdx.x), last = __ldg(p.work + blockIdx.x + 1);
  if (wg == 0) {
    if constexpr (kWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    produce<BN, kWG>(&map_x, p, ring, full, empty, tid, first, last);
  } else {
    if constexpr (kWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    consume<BN, kWG, kStack>(p, ring, epilogue, full, empty, wg - 1, tid, first, last);
  }
}

// X's rows as a bf16 tensor map of dims (F columns, `relations`, N rows):
// element (c, r, n) at n * row_stride + r * rel_offset + c; boxes of 64
// columns x 1 relation x 64 rows, 128-byte swizzle, zeros past every edge.
bool encode_source(CUtensorMap* map, const void* X, int F, int relations, int N, long long row_stride,
                   long long rel_offset) {
  const grl::EncodeTiled fn = grl::encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(F), static_cast<cuuint64_t>(relations),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(relations > 1 ? rel_offset : row_stride) * 2,
                                 static_cast<cuuint64_t>(row_stride) * 2};
  const cuuint32_t box[3] = {kBox, 1, kBox};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(X), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Lets the kernel use up to the card's dynamic shared memory on `device`,
// once per process and device (bit d of `raised`).
template <int BN, int kWG, bool kStack>
cudaError_t raise_smem_limit(int device) {
  static std::atomic<uint64_t> raised{0};
  const uint64_t bit = device >= 0 && device < 64 ? 1ull << device : 0;
  if (raised.load(std::memory_order_acquire) & bit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(tile_apply_persistent_kernel<BN, kWG, kStack>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err == cudaSuccess) raised.fetch_or(bit, std::memory_order_release);
  return err;
}

template <int BN, int kWG, bool kStack>
int launch_persistent(const CUtensorMap& map, const Params& p, int smem, int device, cudaStream_t stream) {
  const cudaError_t err = raise_smem_limit<BN, kWG, kStack>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_apply_persistent_kernel<BN, kWG, kStack><<<p.ctas, kWarpgroup * (kWG + 1), smem, stream>>>(map, p);
  return static_cast<int>(cudaGetLastError());
}

template <int kWG, bool kStack>
int dispatch_persistent(int BN, const CUtensorMap& map, const Params& p, int smem, int device, cudaStream_t s) {
  switch (BN) {
    case 64: return launch_persistent<64, kWG, kStack>(map, p, smem, device, s);
    case 128: return launch_persistent<128, kWG, kStack>(map, p, smem, device, s);
    case 192: return launch_persistent<192, kWG, kStack>(map, p, smem, device, s);
    case 256: return launch_persistent<256, kWG, kStack>(map, p, smem, device, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches K7's persistent route (bfloat16 tiles and operands) on `stream`
// of `device`, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape, pointer or plan it
// does not take). The tables are grl_tile_apply's; work is int32: the
// first item of each of the `ctas` CTAs and the end (ctas + 1), then the
// items, each (block * parts + part) * chunks + chunk. X's row n of
// relation r starts at element n * src_row_stride + r * src_rel_offset
// (src_relations is L, or 1 where every relation reads the same rows); out
// as grl_tile_apply's. BN in {64, 128, 192, 256} with chunks * BN >= F;
// consumers (1 or 2) warpgroups of 64 rows each, parts * 64 * consumers ==
// B; stages in [2, 8]; smem_bytes the ring's sum (smem_bytes() above, at
// most 232,448). tiles, X and out 16-byte aligned, F and the strides
// multiples of 8.
extern "C" int grl_tile_persistent(const void* tiles, const void* col, const void* rows, const void* row_of_block,
                                   const void* rel_mix, const void* work, const void* X, void* out, int num_nodes,
                                   int nb, int B, int L, int F, int src_relations, long long src_row_stride,
                                   long long src_rel_offset, long long out_row_stride, long long out_rel_offset,
                                   int stack, int transposed, int BN, int chunks, int consumers, int parts,
                                   int stages, int smem, int ctas, int use_hash, const uint32_t* seed, float keep,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto aligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  if (num_nodes <= 0 || nb < 1 || L < 1 || F <= 0 || F % 8 != 0 || BN % 64 != 0 || BN < 64 || BN > 256 ||
      static_cast<long long>(chunks) * BN < F || (consumers != 1 && consumers != 2) ||
      static_cast<long long>(parts) * kBox * consumers != B || stages < 2 || stages > kMaxStages ||
      smem != smem_bytes(BN, consumers, stages) || smem > kSmemLimit || ctas < 1 ||
      (src_relations != 1 && src_relations != L) || src_row_stride % 8 != 0 || src_rel_offset % 8 != 0 ||
      out_row_stride % 8 != 0 || out_rel_offset % 8 != 0 || !aligned(tiles) || !aligned(X) || !aligned(out) ||
      static_cast<long long>(nb) * B >= (1ll << 31) || (use_hash && seed == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  if (!encode_source(&map, X, F, src_relations, num_nodes, src_row_stride, src_rel_offset))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.tiles = static_cast<const __nv_bfloat16*>(tiles);
  p.col = static_cast<const int*>(col);
  p.rows = static_cast<const int*>(rows);
  p.row_of_block = static_cast<const int*>(row_of_block);
  p.rel_mix = static_cast<const int*>(rel_mix);
  p.work = static_cast<const int*>(work);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.out_row_stride = out_row_stride;
  p.out_rel_offset = out_rel_offset;
  p.N = num_nodes;
  p.nb = nb;
  p.B = B;
  p.L = L;
  p.F = F;
  p.src_relations = src_relations;
  p.chunks = chunks;
  p.parts = parts;
  p.stages = stages;
  p.ctas = ctas;
  p.transposed = transposed;
  p.use_hash = use_hash;
  p.seed = seed;
  p.keep = keep;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (consumers == 2) return stack ? dispatch_persistent<2, true>(BN, map, p, smem, device, s)
                                  : dispatch_persistent<2, false>(BN, map, p, smem, device, s);
  return stack ? dispatch_persistent<1, true>(BN, map, p, smem, device, s)
               : dispatch_persistent<1, false>(BN, map, p, smem, device, s);
}

extern "C" const char* grl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
