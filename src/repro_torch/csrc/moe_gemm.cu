// Grouped SwiGLU expert GEMM with a per-row-tile occupancy skip (kernel K1;
// K3b is the same launch with every row live).
//
// Replaces the TPU kernel src/repro/kernels/moe_gemm/kernel.py,
// moe_gemm_grouped_pallas (body _grouped_kernel), and with an all-live mask
// moe_gemm_pallas:
//
//     out[e] = bf16(silu(x[e] @ wg[e]) * (x[e] @ wu[e])) @ wd[e]
//
// with f32 accumulation, for x [E, C, d], wg/wu [E, d, F], wd [E, F, d],
// all bf16, row-major.  A 64-row tile (ROW_TILE) with no live row (per the
// row_valid [E, C] mask) skips all three products and gives exact zeros; a
// tile with any live row computes every row.  Rows past C are masked.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s), counting the
// rows of tiles with a live row and the weights of experts with such a tile:
//   prefill, x [8, 320, 4096], F 14336, 1472 rows, 7 live experts:
//     5.19e11 FLOP (0.525 ms) against 2.47 GB of weights (0.746 ms): bytes;
//   decode, C = 8, 40 rows, 5 live experts: 1.76 GB, 0.526 ms: bytes;
//   K3b, x [8, 640, 4096], all 5120 rows: 1.80e12 FLOP, 1.824 ms: operations.
// So the kernel has to keep the tensor cores busy at prefill and K3b, and
// keep enough weight bytes in flight at decode.
//
// Design (Hopper only, sm_90a):
// - Two launches.  The TPU kernel carries an f32 [BC, d] accumulator across a
//   sequential F grid axis; GPU blocks run in no order, so gate_up writes
//   h = bf16(silu(g) * u) to a bf16 scratch [E, C, F] (g and u stay f32 until
//   that one rounding) and down computes h @ wd with f32 accumulation over all
//   of F inside one block: no split-K, no atomics, deterministic.
// - A block covers 128 rows (two 64-row occupancy halves) of one expert and
//   a 128-column (gate_up: of g and of u) or 256-column (down) output tile.
//   Each half decides its occupancy from row_valid itself, in both launches,
//   so a dark half's h is never written and never read.
// - TMA loads each operand tile through a 3-D tensor map ([E, rows, cols]):
//   rows past C of one expert zero-fill and never read the next expert, and
//   a weight tile wider than d or F is clipped.  128-byte swizzle; tiles are
//   64 columns (128 bytes) wide, the wider weight tiles being 2 or 4 boxes.
// - Warp specialisation: warpgroup 0 is the producer (one thread issues the
//   TMA loads of a 4-stage ring, each stage 48 KB, onto `full` mbarriers);
//   warpgroups 1 and 2 are the consumers, one per 64-row half, each issuing
//   wgmma m64n128k16 (gate_up: g and u, 2 x 64 f32 registers) or m64n256k16
//   (down: 128 f32 registers) straight from shared memory and releasing a
//   stage through its `empty` mbarrier once its products have read it.
//   A dark half's consumer takes no part in the ring.  setmaxnreg moves
//   registers from the producer to the consumers.
// - B (the weights, [d, F] and [F, d] row-major) is MN-major: wgmma reads it
//   with the transpose-B flag, so no weight is transposed or copied.
// - Raster: the row block is the fastest grid dimension, then the n-tile,
//   then the expert, so the row blocks that read one weight tile run
//   together and the tile comes from device memory once.
// - The epilogue is in registers: gate_up rounds silu(g) * u once to bf16
//   and stores h for live halves, down stores bf16 out, and exact zeros for
//   dark halves, clipped at C and at the tile's column bound.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;            // occupancy tile: one consumer warpgroup's rows
constexpr int BLOCK_M = 2 * BM;   // rows per block
constexpr int BK = 64;            // contraction per stage: one 128-byte swizzle row
constexpr int BOX = 64;           // columns per TMA box of a weight tile
constexpr int GU_BN = 128;        // gate_up output columns (of g and of u)
constexpr int DN_BN = 256;        // down output columns
constexpr int STAGES = 4;
constexpr int THREADS = 384;      // producer warpgroup + two consumer warpgroups
constexpr int A_BYTES = BLOCK_M * BK * 2;    // 16 KB
constexpr int BOX_BYTES = BK * BOX * 2;      // 8 KB: a [BK, BOX] weight box
constexpr int STAGE_BYTES = A_BYTES + 2 * GU_BN / BOX * BOX_BYTES;  // 48 KB
static_assert(STAGE_BYTES == A_BYTES + DN_BN / BOX * BOX_BYTES, "both launches use one stage size");
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;  // alignment slack, ring, barriers

// ---------------------------------------------------------------- PTX helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box at (c0, c1, c2) (innermost first) of `map` into shared memory at
// `dst`, completing `bytes` of the transaction on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand at `p`:
// start address, leading byte offset (MN-major: the step between 64-column
// boxes; unused for K-major), stride byte offset (the step between 8-row
// groups: 8 x 128 bytes), layout 128B swizzle.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses to the accumulators across a wgmma wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma from shared memory, A K-major, B MN-major (the transpose-B flag set):
// D[64 x N] = A[64 x 16] B[16 x N] + (accumulate ? D : 0), f32 accumulators in
// the fragment layout of for_fragment below.  The first product of a tile
// starts from zero this way: zeroing the registers with other instructions
// would make ptxas serialize the wgmma pipeline.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db, int accumulate) {
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
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(accumulate));
}

// True (in every thread) iff half `half` of the block's rows [c0, c0 + 128)
// holds a live row below C.  Every thread of the block calls it.
__device__ __forceinline__ bool half_live(const uint8_t* row_valid, int e, int c0, int C, int half) {
  const int r = threadIdx.x - half * BM;
  bool v = false;
  if (r >= 0 && r < BM && c0 + half * BM + r < C) v = row_valid[(size_t)e * C + c0 + half * BM + r] != 0;
  return __syncthreads_or(v) != 0;
}

// The accumulator fragment of a 64-row wgmma: thread t of the warpgroup holds,
// for each 8-column group j, rows (16 * warp + lane / 4) and 8 below it, at
// columns 8 j + 2 (lane % 4) and the next one.  Calls f(i, row, col) with
// i the index of the pair's first value.
template <int N, typename Fn>
__device__ __forceinline__ void for_fragment(int tid, Fn f) {
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) f(4 * j + 2 * i, 16 * warp + lane / 4 + 8 * i, 8 * j + 2 * (lane % 4));
}

// Exact zeros on rows [r0, r0 + nrows) below C, columns [n0, n0 + BN) below N.
template <int BN>
__device__ __forceinline__ void store_zeros(bf16* dst, int r0, int nrows, int C, int N, int n0, int tid, int nthreads) {
  for (int i = tid; i < nrows * BN / 2; i += nthreads) {
    const int r = r0 + i / (BN / 2), c = n0 + (i % (BN / 2)) * 2;
    if (r < C && c < N) *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r * N + c) = __floats2bfloat162_rn(0.f, 0.f);
  }
}

__device__ __forceinline__ unsigned char* ring_base() {
  extern __shared__ unsigned char smem_raw[];
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
}

// Set up the ring's barriers: `full` completes when a stage's TMA bytes have
// landed, `empty` when every warp of each live consumer has released it.
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty, int live_halves) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * live_halves);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// h[e, c, f] = bf16(silu(x[e] @ wg[e]) * (x[e] @ wu[e])) on the live 64-row
// halves of rows [c0, c0 + 128), columns [n0, n0 + 128).
__global__ void __launch_bounds__(THREADS, 1) gate_up_kernel(
    const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_wg,
    const __grid_constant__ CUtensorMap map_wu, const uint8_t* __restrict__ row_valid, bf16* __restrict__ h, int C,
    int D, int F) {
  const int c0 = blockIdx.x * BLOCK_M, n0 = blockIdx.y * GU_BN, e = blockIdx.z;
  const bool live[2] = {half_live(row_valid, e, c0, C, 0), half_live(row_valid, e, c0, C, 1)};
  if (!live[0] && !live[1]) return;  // the down launch writes its zeros
  unsigned char* ring = ring_base();
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  init_ring(full, empty, live[0] + live[1]);
  const int KT = D / BK;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      prefetch_map(&map_x);
      prefetch_map(&map_wg);
      prefetch_map(&map_wu);
      const int boxes = n0 + BOX < F ? 2 : 1;  // a box wholly past F is not loaded (its columns are not stored)
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], (kt / STAGES - 1) & 1);
        unsigned char* st = ring + s * STAGE_BYTES;
        mbar_expect_tx(&full[s], A_BYTES + 2 * boxes * BOX_BYTES);
        tma_load(st, &map_x, &full[s], kt * BK, c0, e);
        for (int j = 0; j < boxes; ++j) {
          tma_load(st + A_BYTES + j * BOX_BYTES, &map_wg, &full[s], n0 + j * BOX, kt * BK, e);
          tma_load(st + A_BYTES + (GU_BN / BOX + j) * BOX_BYTES, &map_wu, &full[s], n0 + j * BOX, kt * BK, e);
        }
      }
    }
  } else {  // consumer of 64-row half wg - 1
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int half = wg - 1, tid = threadIdx.x % 128;
    if (!live[half]) return;
    float g[GU_BN / 2], u[GU_BN / 2];
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(&full[s], (kt / STAGES) & 1);
      const unsigned char* st = ring + s * STAGE_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = smem_desc(st + half * (A_BYTES / 2) + kk * 32, 0);
        wgmma_n128(g, da, smem_desc(st + A_BYTES + kk * 16 * 128, BOX_BYTES), kt | kk);
        wgmma_n128(u, da, smem_desc(st + A_BYTES + GU_BN / BOX * BOX_BYTES + kk * 16 * 128, BOX_BYTES), kt | kk);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: release it
      if (kt > 0 && tid % 32 == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(g);
    fence_regs(u);
    const int r0 = c0 + half * BM;
    bf16* he = h + (size_t)e * C * F;
    for_fragment<GU_BN>(tid, [&](int i, int r, int c) {
      if (r0 + r < C && n0 + c < F) {
        const float a0 = g[i], a1 = g[i + 1];
        const float h0 = a0 / (1.f + expf(-a0)) * u[i], h1 = a1 / (1.f + expf(-a1)) * u[i + 1];
        *reinterpret_cast<__nv_bfloat162*>(he + (size_t)(r0 + r) * F + n0 + c) = __floats2bfloat162_rn(h0, h1);
      }
    });
  }
}

// out[e] = bf16(h[e] @ wd[e]) on the live 64-row halves of rows [c0, c0 + 128),
// columns [n0, n0 + 256), exact zeros on the dark halves.
__global__ void __launch_bounds__(THREADS, 1) down_kernel(
    const __grid_constant__ CUtensorMap map_h, const __grid_constant__ CUtensorMap map_wd,
    const uint8_t* __restrict__ row_valid, bf16* __restrict__ out, int C, int F, int D) {
  const int c0 = blockIdx.x * BLOCK_M, n0 = blockIdx.y * DN_BN, e = blockIdx.z;
  bf16* oute = out + (size_t)e * C * D;
  const bool live[2] = {half_live(row_valid, e, c0, C, 0), half_live(row_valid, e, c0, C, 1)};
  if (!live[0] && !live[1]) {
    store_zeros<DN_BN>(oute, c0, BLOCK_M, C, D, n0, threadIdx.x, THREADS);
    return;
  }
  unsigned char* ring = ring_base();
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  init_ring(full, empty, live[0] + live[1]);
  const int KT = F / BK;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      prefetch_map(&map_h);
      prefetch_map(&map_wd);
      const int boxes = min(DN_BN / BOX, (D - n0) / BOX);  // boxes wholly past d are not loaded
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], (kt / STAGES - 1) & 1);
        unsigned char* st = ring + s * STAGE_BYTES;
        mbar_expect_tx(&full[s], A_BYTES + boxes * BOX_BYTES);
        tma_load(st, &map_h, &full[s], kt * BK, c0, e);
        for (int j = 0; j < boxes; ++j) tma_load(st + A_BYTES + j * BOX_BYTES, &map_wd, &full[s], n0 + j * BOX, kt * BK, e);
      }
    }
  } else {  // consumer of 64-row half wg - 1
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int half = wg - 1, tid = threadIdx.x % 128;
    const int r0 = c0 + half * BM;
    if (!live[half]) {
      store_zeros<DN_BN>(oute, r0, BM, C, D, n0, tid, 128);
      return;
    }
    float acc[DN_BN / 2];
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(&full[s], (kt / STAGES) & 1);
      const unsigned char* st = ring + s * STAGE_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_n256(acc, smem_desc(st + half * (A_BYTES / 2) + kk * 32, 0),
                   smem_desc(st + A_BYTES + kk * 16 * 128, BOX_BYTES), kt | kk);
      wgmma_commit();
      wgmma_wait<1>();
      if (kt > 0 && tid % 32 == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    for_fragment<DN_BN>(tid, [&](int i, int r, int c) {
      if (r0 + r < C && n0 + c < D)
        *reinterpret_cast<__nv_bfloat162*>(oute + (size_t)(r0 + r) * D + n0 + c) =
            __floats2bfloat162_rn(acc[i], acc[i + 1]);
    });
  }
}

// ------------------------------------------------------------------ host side
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D map over a contiguous bf16 [E, rows, cols] array, boxes of [1, box_rows,
// 64] with the 128-byte swizzle; out-of-range elements read as zero.
bool make_map(CUtensorMap* map, const void* base, int E, int rows, int cols, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {(cuuint32_t)BOX, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
                        elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Row tile the occupancy skip works at; the Python wrapper reads it.
extern "C" int moe_gemm_row_tile() { return BM; }

// Both launches on `stream`.  x, h, out [E, C, *] and the weights are
// contiguous, 16-byte-aligned bf16; row_valid is [E, C] bytes (0 = dark
// slot); h is the caller's [E, C, F] bf16 scratch; D and F are multiples of
// 64.  Returns the CUDA error code (0 = ok).
extern "C" int moe_gemm_grouped(const void* x, const void* wg, const void* wu, const void* wd,
                                const void* row_valid, void* h, void* out, int E, int C, int D,
                                int F, void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || D % BK || F % BK) return (int)cudaErrorInvalidValue;
  if (!encode_tiled()) return (int)cudaErrorSymbolNotFound;
  CUtensorMap map_x, map_wg, map_wu, map_h, map_wd;
  if (!make_map(&map_x, x, E, C, D, BLOCK_M) || !make_map(&map_wg, wg, E, D, F, BK) ||
      !make_map(&map_wu, wu, E, D, F, BK) || !make_map(&map_h, h, E, C, F, BLOCK_M) ||
      !make_map(&map_wd, wd, E, F, D, BK))
    return (int)cudaErrorInvalidValue;
  static bool attrs_set = false;
  if (!attrs_set) {
    cudaError_t err = cudaFuncSetAttribute(gate_up_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(down_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    attrs_set = true;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rb = (C + BLOCK_M - 1) / BLOCK_M;
  const uint8_t* rv = static_cast<const uint8_t*>(row_valid);
  gate_up_kernel<<<dim3(rb, (F + GU_BN - 1) / GU_BN, E), THREADS, SMEM_BYTES, s>>>(
      map_x, map_wg, map_wu, rv, static_cast<bf16*>(h), C, D, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  down_kernel<<<dim3(rb, (D + DN_BN - 1) / DN_BN, E), THREADS, SMEM_BYTES, s>>>(
      map_h, map_wd, rv, static_cast<bf16*>(out), C, F, D);
  return (int)cudaGetLastError();
}
