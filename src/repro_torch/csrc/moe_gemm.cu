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
// Design (Hopper only, sm_90a; the PTX building blocks are in hopper.cuh,
// shared with K3 and K4):
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

#include "hopper.cuh"

namespace {

constexpr int BM = OCC_ROWS;      // occupancy tile: one consumer warpgroup's rows
constexpr int BLOCK_M = 2 * BM;   // rows per block
constexpr int BK = 64;            // contraction per stage: one 128-byte swizzle row
constexpr int GU_BN = 128;        // gate_up output columns (of g and of u)
constexpr int DN_BN = 256;        // down output columns
constexpr int STAGES = 4;
constexpr int THREADS = 384;      // producer warpgroup + two consumer warpgroups
constexpr int A_BYTES = BLOCK_M * BK * 2;    // 16 KB
constexpr int BOX_BYTES = BK * BOX * 2;      // 8 KB: a [BK, BOX] weight box
constexpr int STAGE_BYTES = A_BYTES + 2 * GU_BN / BOX * BOX_BYTES;  // 48 KB
static_assert(STAGE_BYTES == A_BYTES + DN_BN / BOX * BOX_BYTES, "both launches use one stage size");
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;  // alignment slack, ring, barriers

// True (in every thread) iff half `half` of the block's rows [c0, c0 + 128)
// holds a live row below C.  Every thread of the block calls it.
__device__ __forceinline__ bool half_live(const uint8_t* row_valid, int e, int c0, int C, int half) {
  return rows_live(row_valid, e, c0 + half * BM, C, half);
}

// h[e, c, f] = bf16(silu(x[e] @ wg[e]) * (x[e] @ wu[e])) on the live 64-row
// halves of rows [c0, c0 + 128), columns [n0, n0 + 128).
__global__ void __launch_bounds__(THREADS, 1) k1_gate_up_kernel(
    const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_wg,
    const __grid_constant__ CUtensorMap map_wu, const uint8_t* __restrict__ row_valid, bf16* __restrict__ h, int C,
    int D, int F) {
  const int c0 = blockIdx.x * BLOCK_M, n0 = blockIdx.y * GU_BN, e = blockIdx.z;
  const bool live[2] = {half_live(row_valid, e, c0, C, 0), half_live(row_valid, e, c0, C, 1)};
  if (!live[0] && !live[1]) return;  // the down launch writes its zeros
  unsigned char* ring = ring_base();
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  init_ring(full, empty, STAGES, 4 * (live[0] + live[1]));
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
        wgmma_ss<GU_BN, 0, 1>(g, da, smem_desc(st + A_BYTES + kk * 16 * 128, BOX_BYTES), kt | kk);
        wgmma_ss<GU_BN, 0, 1>(u, da, smem_desc(st + A_BYTES + GU_BN / BOX * BOX_BYTES + kk * 16 * 128, BOX_BYTES), kt | kk);
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
__global__ void __launch_bounds__(THREADS, 1) k1_down_kernel(
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
  init_ring(full, empty, STAGES, 4 * (live[0] + live[1]));
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
        wgmma_ss<DN_BN, 0, 1>(acc, smem_desc(st + half * (A_BYTES / 2) + kk * 32, 0),
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
  static bool gate_up_set = false, down_set = false;
  cudaError_t err = allow_smem(k1_gate_up_kernel, SMEM_BYTES, gate_up_set);
  if (err == cudaSuccess) err = allow_smem(k1_down_kernel, SMEM_BYTES, down_set);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rb = (C + BLOCK_M - 1) / BLOCK_M;
  const uint8_t* rv = static_cast<const uint8_t*>(row_valid);
  k1_gate_up_kernel<<<dim3(rb, (F + GU_BN - 1) / GU_BN, E), THREADS, SMEM_BYTES, s>>>(
      map_x, map_wg, map_wu, rv, static_cast<bf16*>(h), C, D, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k1_down_kernel<<<dim3(rb, (D + DN_BN - 1) / DN_BN, E), THREADS, SMEM_BYTES, s>>>(
      map_h, map_wd, rv, static_cast<bf16*>(out), C, F, D);
  return (int)cudaGetLastError();
}
