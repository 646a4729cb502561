// Hopper building blocks shared by dropedge_sm90.cu (bf16 K1, K2 and K3 at
// N % 8 == 0 and F % 8 == 0) and relagg_ragged.cu (bf16 K3 at other N and
// F): PTX wrappers for mbarriers, TMA and wgmma, the two-stage ring of
// 64 x 64 bf16 A boxes in the 128-byte swizzled layout, the consumer
// warpgroup's forward product over one staged step and its epilogue, and
// the host's tensor-map encoder. The forward product and epilogue are one
// code for both sources, so K3 on either route sums in one order.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace grl {
constexpr int kTile = 64;                     // A's box is 64 x 64: rows x columns
constexpr int kBoxBytes = kTile * kTile * 2;  // 8 KB of bf16, 128-byte rows
constexpr int kConsumers = 128;               // one warpgroup: mask pass, wgmma, epilogue
constexpr int kStages = 2;  // ring depth: ~82 KB a block at BN = 256, two blocks an SM


__host__ __device__ constexpr int stage_bytes(int BN) { return kBoxBytes * (1 + BN / 64); }
__host__ __device__ constexpr int max_of(int a, int b) { return a > b ? a : b; }
// Dynamic shared memory: 1024 bytes of alignment slack, the ring (reused by
// the epilogue's tile) and a full and an empty barrier a stage.
__host__ __device__ constexpr int ring_bytes(int BN, int epilogue_bytes) {
  return max_of(kStages * stage_bytes(BN), epilogue_bytes);
}
__host__ __device__ constexpr int fwd_ring(int BN) { return ring_bytes(BN, kTile * (BN + 8) * 2); }  // bf16 staging tile
__host__ __device__ constexpr int smem_bytes(int ring) { return 1024 + ring + 2 * kStages * 8; }

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(smem_u32(bar)) : "memory");
}

// Waits for the phase of parity `parity` to complete. A phase that never
// completes (a load that never lands) traps after ~2^26 tries, seconds
// where a real wait takes microseconds: the launch then fails with an
// error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// One box of a three-dimensional tensor map into shared memory, completing
// on `bar`: coordinates (column, row, batch).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

// The consumer warpgroup's own barrier (id 1; id 0 is __syncthreads).
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 128;" ::: "memory"); }

// wgmma shared-memory matrix descriptor of a 128-byte-swizzled tile whose
// 1024-byte swizzle atoms start 1024-aligned. K-major (rows of 64 K values):
// sbo = 1024, the stride of 8-row groups; lbo is unused. MN-major (rows of
// 64 M or N values, one row per K): lbo is the stride between 64-wide
// column blocks, sbo = 1024 the stride between groups of 8 K rows.
__device__ __forceinline__ uint64_t descriptor(const void* tile, uint32_t lbo, uint32_t sbo) {
  const uint32_t addr = smem_u32(tile);
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory"); }

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions.
template <int R>
__device__ __forceinline__ void fence_registers(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma.m64nNk16.f32.bf16.bf16, A and B from shared memory; kTransA /
// kTransB: 0 = K-major, 1 = MN-major. Every accumulator register is listed.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1), "n"(kTransA), "n"(kTransB));
}

template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1), "n"(kTransA), "n"(kTransB));
}

template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[96], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(1), "n"(kTransA), "n"(kTransB));
}

template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1), "n"(kTransA), "n"(kTransB));
}

template <int BN, int kTransA, int kTransB>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t a, uint64_t b) {
  if constexpr (BN == 64) wgmma_m64n64k16<kTransA, kTransB>(d, a, b);
  else if constexpr (BN == 128) wgmma_m64n128k16<kTransA, kTransB>(d, a, b);
  else if constexpr (BN == 192) wgmma_m64n192k16<kTransA, kTransB>(d, a, b);
  else wgmma_m64n256k16<kTransA, kTransB>(d, a, b);
}

// Accumulator element i of thread t in a warpgroup's m64nN fragment lies at
// row 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2), column
// 8 * (i / 4) + 2 * (t % 4) + i % 2.
__device__ __forceinline__ int frag_row(int tid, int i) { return 16 * (tid >> 5) + ((tid & 31) >> 2) + 8 * ((i >> 1) & 1); }
__device__ __forceinline__ int frag_col(int tid, int i) { return 8 * (i >> 2) + 2 * (tid & 3); }

struct Ring {
  uint8_t* base;  // 1024-aligned
  uint64_t* full;
  uint64_t* empty;
};

// Carves the ring and its barriers out of dynamic shared memory and
// initialises the barriers: full expects the producer's one arrival (with
// the stage's bytes), empty the arrival of every consumer thread.
__device__ __forceinline__ Ring make_ring(uint8_t* raw, int region_bytes) {
  Ring ring;
  const uint32_t raw_addr = smem_u32(raw);
  ring.base = raw + (((raw_addr + 1023u) & ~1023u) - raw_addr);
  ring.full = reinterpret_cast<uint64_t*>(ring.base + region_bytes);
  ring.empty = ring.full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(ring.full + s, 1);
      mbar_init(ring.empty + s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return ring;
}

// The consumer warpgroup's products over one staged step of K1 and K3:
// out (64 x BN) += A box (64 x 64, K-major, as staged) @ V boxes (64 x BN,
// MN-major), in four wgmma k16 slices.
template <int BN>
__device__ __forceinline__ void forward_mma(float (&acc)[BN / 2], const uint8_t* a) {
  fence_registers(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)  // A K-major: 16 columns = 32 bytes on
    wgmma<BN, 0, 1>(acc, descriptor(a + 32 * kk, 16, 1024),
                    descriptor(a + kBoxBytes + 2048 * kk, kBoxBytes, 1024));
  wgmma_commit();
  wgmma_wait_all();
  fence_registers(acc);
}

// The forward epilogue of the consumer warpgroup (thread tid < 128): scale
// by `scale` unless it is 1 (K1's 1/keep), round to bf16 through a staging
// tile over the ring (every product has read its stage once all consumers
// pass the first barrier), and store rows r0.. (< NL) and columns f0..
// (< F) of batch b. kWide: 16-byte stores, for F % 8 == 0 and a 16-byte
// aligned out; else element by element.
template <int BN, bool kScale, bool kWide>
__device__ __forceinline__ void forward_epilogue(float (&acc)[BN / 2], uint8_t* ring, __nv_bfloat16* __restrict__ out,
                                                 int tid, int r0, int f0, int b, int NL, int F, float scale) {
  constexpr int kStride = BN + 8;  // staging row, bf16: shifts rows by 4 banks
  consumers_sync();
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(ring);
  if constexpr (kScale) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] *= scale;
  }
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2)
    *reinterpret_cast<__nv_bfloat162*>(tile + frag_row(tid, i) * kStride + frag_col(tid, i)) =
        __floats2bfloat162_rn(acc[i], acc[i + 1]);
  consumers_sync();
  constexpr int kChunks = BN / 8;  // 16-byte chunks a row
  for (int q = tid; q < kTile * kChunks; q += kConsumers) {
    const int row = q / kChunks, c = q % kChunks;
    const int r = r0 + row, f = f0 + 8 * c;
    if (r >= NL || f >= F) continue;
    __nv_bfloat16* dst = out + (static_cast<size_t>(b) * NL + r) * F + f;
    const __nv_bfloat16* src = tile + row * kStride + 8 * c;
    if constexpr (kWide) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (f + e < F) dst[e] = src[e];
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps
// ---------------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The CUDA driver API's cuTensorMapEncodeTiled (the libraries do not link libcuda).
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 (B, rows, cols) row-major tensor as a tensor map with 64 x 64
// boxes, 128-byte swizzle and zero fill past every edge.
inline bool encode(CUtensorMap* map, const void* ptr, int cols, int rows, int batches) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batches)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(cols) * rows * 2};
  const cuuint32_t box[3] = {kTile, kTile, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline unsigned cdiv(int a, int b) { return static_cast<unsigned>((a + b - 1) / b); }

}  // namespace grl
