// Backward of the grouped SwiGLU expert GEMM (kernels K2 dgrad and K3
// wgrad), with the forward's per-row-tile occupancy skip.
//
// Replaces the TPU kernels in src/repro/kernels/moe_gemm/kernel.py:
// moe_gemm_grouped_pallas_dgrad (body _grouped_dgrad_kernel, prologue
// _silu_grads) and moe_gemm_grouped_pallas_wgrad (body
// _grouped_wgrad_kernel).  Per expert, with f32 accumulation:
//
//     a = x @ wg    u = x @ wu    s = sigmoid(a)    dh = go @ wd^T
//     da = dh * u * s * (1 + a * (1 - s))    du = dh * s * a    h = s * a * u
//     dx  = da @ wg^T + du @ wu^T                          (K2, dgrad)
//     dwg = x^T @ da    dwu = x^T @ du    dwd = h^T @ go     (K3, wgrad)
//
// for go, x [E, C, d], wg/wu [E, d, F], wd [E, F, d], all bf16 row-major.
// A 64-row tile of slots with no live row (row_valid [E, C]) is dark, as
// in the forward: its dx is exact zeros and it adds nothing to any weight
// gradient; an expert with no live tile gets exact-zero weight gradients.
//
// The TPU kernels carry f32 scratch across a sequential grid axis (F for
// dgrad, C for wgrad).  GPU blocks run in no order, so this is three
// launches instead:
//   1. silu_grads: per live 64-row half and F slab, recompute a, u and dh
//      (each a contraction over d) and store da, du and h as bf16 to
//      [E, C, F] scratch.  These are the rounding points the tensor cores
//      need (the TPU kernel keeps da/du in f32 and rounds only h).
//   2. dgrad: dx = [da | du] @ [wg^T ; wu^T], one contraction over 2F
//      inside the block.
//   3. wgrad: dwg/dwu (sharing the x^T tile) and dwd, contracting over
//      the expert's live 64-row tiles only.
// K2 is launches 1+2, K3 is launches 1+3; the training backward runs 1
// once and feeds both.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s): at the training
// shape (C = 640 per expert, 2816 occupied rows, d = 4096, F = 14336)
// the recompute is 6 d F FLOP per row (1.0e12, 1.0 ms), dgrad 4 d F
// (0.67 ms, against 0.49 ms for reading the live experts' wg and wu once)
// and wgrad 6 d F (1.0 ms) while writing all 3 d F weight gradients per
// expert (2.8 GB, 0.84 ms): the tensor cores bound each launch, and
// dgrad's weight reads and wgrad's writes come close.
//
// Design.  All three launches are warp-specialised wgmma + TMA kernels on
// K1's mainloop (Hopper only, sm_90a; the PTX building blocks, the
// wgmma.mma_async wrappers among them, are in hopper.cuh, shared with K1
// and K4): warpgroup 0 is the producer (one thread issues TMA loads into a
// ring of stages on full/empty mbarriers), warpgroups 1 and 2 are the
// consumers, each owning 64 output rows and issuing wgmma from shared
// memory into f32 register accumulators, a tile's first product with
// scale-d = 0; setmaxnreg moves registers from the producer to the
// consumers.  Operands are read in place through 3-D tensor maps
// ([E, rows, cols], 64-column boxes, 128-byte swizzle; rows past C
// zero-fill inside one expert):
// - silu_grads: a block covers 128 rows of one expert (two 64-row
//   occupancy halves, one consumer each; a dark half takes no part) and
//   128 columns of F.  The three products in one pass would hold three
//   64 x 128 f32 accumulators (192 of a consumer's 232 registers) and need
//   80 KB stages (x, go and three weight tiles), two of them at most; so
//   the block makes two passes over d through one 3-stage ring of 48 KB
//   stages: dh = go @ wd^T first (wd [F, d] row-major is the K-major B, no
//   transpose), parked in shared memory as f32 (64 KB, each thread its own
//   values), then a and u, reading the weights MN-major (transpose-B, as
//   K1).  The elementwise backward runs on the register fragments, and da,
//   du, h are stored once as bf16.
// - wgrad: persistent blocks (one per SM) walk 128 x 128 tiles of
//   [dwg | dwu] ([d, F]; two accumulators per consumer, as K1's gate_up)
//   or 128 x 256 tiles of dwd ([F, d], as K1's down).  A = x^T or h^T is
//   read MN-major (the transpose-A flag) and B = da/du or go MN-major
//   (transpose-B), one live 64-row tile per stage: each block first lists
//   every expert's live row tiles in shared memory (a warp ballot per
//   tile, then one warp per expert compacts), and the producer walks only
//   those, so a dark tile is never loaded and an expert with no live tile
//   writes exact zeros without loading anything.  The producer runs on
//   into the next output tile while the consumers write theirs as bf16
//   into shared memory (128-byte swizzle) and hand it to TMA stores, so
//   the 2.8 GB of writes overlap the next tile's products.
// - dgrad: K1's down launch with another operand walk.  A block covers 128
//   rows of one expert (two 64-row occupancy halves, one consumer each)
//   and DG_BN = 256 columns of d (a 128-column tile was measured slower,
//   PERF.md), and contracts over 2F in one ring of 4 48 KB stages: F/64
//   stages of (da, wg), then F/64 of (du, wu).  wg/wu [d, F] row-major are
//   the K-major B of da @ wg^T, read through [DG_BN, 64] boxes with no
//   transpose flag.  The producer loads only the live
//   halves' rows of da/du, so the scratch the recompute leaves unwritten on
//   dark tiles (any bits, NaN among them) never reaches shared memory; a
//   dark half's consumer writes exact zeros, and a block with both halves
//   dark writes zeros and loads nothing.  The output is bf16, written once
//   from the register fragments, clipped at C and d.

#include "hopper.cuh"

namespace {

constexpr int BM = OCC_ROWS;     // the occupancy tile
constexpr int BLOCK_M = 2 * BM;  // rows of one expert (silu_grads, dgrad) or output rows (wgrad) per block
constexpr int BK = 64;           // contraction per stage: one 128-byte swizzle row
constexpr int THREADS = 384;     // producer warpgroup + two consumer warpgroups
constexpr int MAX_TILES = 256;   // row tiles per expert (the wrapper's MAX_ROW_TILES)
constexpr int BOX_BYTES = BK * BOX * 2;  // 8 KB: a [64 rows, 64] box
constexpr int A_BYTES = BLOCK_M * BK * 2;  // 16 KB: [128 rows, 64] of x or go, or two boxes of x^T / h^T

// ------------------------------------------------------ launch 1: silu_grads
constexpr int SG_BN = 128;  // F columns per block
constexpr int SG_STAGES = 3;
constexpr int SG_W_BYTES = SG_BN / BOX * BOX_BYTES;  // a [64, 128] tile of wg or wu: 2 boxes, 16 KB
constexpr int SG_WD_BYTES = SG_BN * SWIZZLE_BYTES;  // a [128, 64] tile of wd: 16 KB
constexpr int SG_STAGE_BYTES = A_BYTES + 2 * SG_W_BYTES;  // 48 KB: x, wg, wu (the dh pass uses go, wd: 32 KB)
constexpr int SG_DH_BYTES = 2 * 128 * (SG_BN / 2) * 4;  // dh, f32, 64 values per consumer thread: 64 KB
constexpr int SG_SMEM = 1024 + SG_STAGES * SG_STAGE_BYTES + SG_DH_BYTES + 2 * SG_STAGES * 8;

// da, du, h (bf16 [E, C, F]) on the live 64-row halves of rows [c0, c0 + 128),
// columns [n0, n0 + 128), in two passes over d through one ring: first
// dh = go @ wd^T, parked in shared memory as f32 (each thread its own
// fragment), then a = x @ wg and u = x @ wu, so a consumer holds at most two
// 64 x 128 accumulators.
__global__ void __launch_bounds__(THREADS, 1) k23_silu_grads_kernel(
    const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_go,
    const __grid_constant__ CUtensorMap map_wg, const __grid_constant__ CUtensorMap map_wu,
    const __grid_constant__ CUtensorMap map_wd, const uint8_t* __restrict__ row_valid, bf16* __restrict__ da,
    bf16* __restrict__ du, bf16* __restrict__ h, int C, int D, int F) {
  const int c0 = blockIdx.x * BLOCK_M, n0 = blockIdx.y * SG_BN, e = blockIdx.z;
  const bool live[2] = {rows_live(row_valid, e, c0, C, 0), rows_live(row_valid, e, c0 + BM, C, 1)};
  if (!live[0] && !live[1]) return;  // nothing reads a dark tile's scratch
  unsigned char* ring = ring_base();
  float* parked = reinterpret_cast<float*>(ring + SG_STAGES * SG_STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + SG_STAGES * SG_STAGE_BYTES + SG_DH_BYTES);
  uint64_t* empty = full + SG_STAGES;
  init_ring(full, empty, SG_STAGES, 4 * (live[0] + live[1]));
  const int KT = D / BK;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      prefetch_map(&map_x);
      prefetch_map(&map_go);
      prefetch_map(&map_wg);
      prefetch_map(&map_wu);
      prefetch_map(&map_wd);
      const int boxes = min(SG_BN / BOX, (F - n0) / BOX);  // weight boxes wholly past F are not loaded
      for (int it = 0; it < 2 * KT; ++it) {
        const int s = it % SG_STAGES, k0 = (it % KT) * BK;
        if (it >= SG_STAGES) mbar_wait(&empty[s], (it / SG_STAGES - 1) & 1);
        unsigned char* st = ring + s * SG_STAGE_BYTES;
        if (it < KT) {  // dh pass: go, wd (rows past F zero-fill)
          mbar_expect_tx(&full[s], A_BYTES + SG_WD_BYTES);
          tma_load(st, &map_go, &full[s], k0, c0, e);
          tma_load(st + A_BYTES, &map_wd, &full[s], k0, n0, e);
        } else {  // a, u pass: x, wg, wu
          mbar_expect_tx(&full[s], A_BYTES + 2 * boxes * BOX_BYTES);
          tma_load(st, &map_x, &full[s], k0, c0, e);
          for (int j = 0; j < boxes; ++j) {
            tma_load(st + A_BYTES + j * BOX_BYTES, &map_wg, &full[s], n0 + j * BOX, k0, e);
            tma_load(st + A_BYTES + SG_W_BYTES + j * BOX_BYTES, &map_wu, &full[s], n0 + j * BOX, k0, e);
          }
        }
      }
    }
  } else {  // consumer of 64-row half wg - 1
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int half = wg - 1, tid = threadIdx.x % 128;
    if (!live[half]) return;
    float* mine = parked + half * 128 + tid;  // value i at mine[256 i]: consecutive threads, consecutive words
    {
      float g[SG_BN / 2];
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % SG_STAGES;
        mbar_wait(&full[s], (kt / SG_STAGES) & 1);
        const unsigned char* st = ring + s * SG_STAGE_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)  // wd [F, d] row-major is the K-major B of go @ wd^T
          wgmma_ss<SG_BN, 0, 0>(g, smem_desc(st + half * (A_BYTES / 2) + kk * 32, 0),
                                smem_desc(st + A_BYTES + kk * 32, 0), kt | kk);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: release it
        if (kt > 0 && tid % 32 == 0) mbar_arrive(&empty[(kt - 1) % SG_STAGES]);
      }
      wgmma_wait<0>();
      fence_regs(g);
      if (tid % 32 == 0) mbar_arrive(&empty[(KT - 1) % SG_STAGES]);
#pragma unroll
      for (int i = 0; i < SG_BN / 2; ++i) mine[256 * i] = g[i];
    }
    float a[SG_BN / 2], u[SG_BN / 2];
    for (int kt = 0; kt < KT; ++kt) {
      const int it = KT + kt, s = it % SG_STAGES;
      mbar_wait(&full[s], (it / SG_STAGES) & 1);
      const unsigned char* st = ring + s * SG_STAGE_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dx = smem_desc(st + half * (A_BYTES / 2) + kk * 32, 0);
        const unsigned char* w = st + A_BYTES + kk * 16 * SWIZZLE_BYTES;
        wgmma_ss<SG_BN, 0, 1>(a, dx, smem_desc(w, BOX_BYTES), kt | kk);
        wgmma_ss<SG_BN, 0, 1>(u, dx, smem_desc(w + SG_W_BYTES, BOX_BYTES), kt | kk);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (kt > 0 && tid % 32 == 0) mbar_arrive(&empty[(it - 1) % SG_STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(a);
    fence_regs(u);
    // a, u and dh share one fragment layout, so the backward of silu(a) * u
    // is elementwise on the registers
    const int r0 = c0 + half * BM;
    const size_t ho = (size_t)e * C * F;
    for_fragment<SG_BN>(tid, [&](int i, int r, int c) {
      if (r0 + r < C && n0 + c < F) {
        float vda[2], vdu[2], vh[2];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const float av = a[i + t], uv = u[i + t], gv = mine[256 * (i + t)];
          const float sg = 1.f / (1.f + expf(-av));
          vda[t] = gv * uv * sg * (1.f + av * (1.f - sg));
          vdu[t] = gv * sg * av;
          vh[t] = sg * av * uv;
        }
        const size_t at = ho + (size_t)(r0 + r) * F + n0 + c;
        *reinterpret_cast<__nv_bfloat162*>(da + at) = __floats2bfloat162_rn(vda[0], vda[1]);
        *reinterpret_cast<__nv_bfloat162*>(du + at) = __floats2bfloat162_rn(vdu[0], vdu[1]);
        *reinterpret_cast<__nv_bfloat162*>(h + at) = __floats2bfloat162_rn(vh[0], vh[1]);
      }
    });
  }
}

// ----------------------------------------------------------- launch 3: wgrad
constexpr int WG_STAGES = 3;
constexpr int WGU_BN = 128;  // [dwg | dwu] columns (of F) per tile
constexpr int WD_BN = 256;   // dwd columns (of d) per tile
constexpr int WG_STAGE_BYTES = A_BYTES + 2 * WGU_BN / BOX * BOX_BYTES;  // 48 KB
static_assert(WG_STAGE_BYTES == A_BYTES + WD_BN / BOX * BOX_BYTES, "both wgrad kernels use one stage size");
constexpr int OUT_BYTES = WD_BN / BOX * BOX_BYTES;  // one consumer's staged output tile: 32 KB
static_assert(OUT_BYTES == 2 * WGU_BN / BOX * BOX_BYTES, "both wgrad kernels stage one size");
constexpr int MAX_EXPERTS = 256;     // wgrad keeps a count of live row tiles per expert
constexpr int MAX_LISTED = 4096;     // and their indices, [E, ceil(C / 64)] in all
constexpr int LIST_BYTES = MAX_EXPERTS * 4 + MAX_LISTED * 2;
constexpr int WG_SMEM = 1024 + WG_STAGES * WG_STAGE_BYTES + 2 * OUT_BYTES + LIST_BYTES + 2 * WG_STAGES * 8;

// count[e] = the number of live row tiles of expert e (tiles holding a
// live row), listed in order at tiles[e * ceil(C / 64) ...].  Every thread
// of the block calls it: each warp ballots whole tiles into a bit each (in
// `scratch`, E * ceil(C / 2048) words), then one warp per expert compacts
// its bits.
__device__ __forceinline__ void list_live_tiles(const uint8_t* row_valid, int E, int C, uint32_t* scratch,
                                                int* count, uint16_t* tiles) {
  const int ct = (C + BM - 1) / BM, words = (ct + 31) / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < E * words; i += THREADS) scratch[i] = 0;
  __syncthreads();
  for (int g = warp; g < E * ct; g += THREADS / 32) {
    const int e = g / ct, t = g % ct, r = t * BM + lane;
    const uint8_t* rv = row_valid + (size_t)e * C;
    const bool v = (r < C && rv[r]) || (r + 32 < C && rv[r + 32]);
    if (__any_sync(0xffffffffu, v) && lane == 0) atomicOr(&scratch[e * words + t / 32], 1u << (t % 32));
  }
  __syncthreads();
  for (int e = warp; e < E; e += THREADS / 32) {
    int n = 0;
    for (int i = 0; i < words; ++i) {
      const uint32_t w = scratch[e * words + i];
      if (w >> lane & 1) tiles[e * ct + n + __popc(w & ((1u << lane) - 1))] = 32 * i + lane;
      n += __popc(w);
    }
    if (lane == 0) count[e] = n;
  }
  __syncthreads();
}

// out0[e] (and out1[e] when TWO) = A[e]^T @ B0[e] (and B1[e]) over each
// expert's live row tiles, for A [E, C, M] and B [E, C, N]: a persistent
// block walks [128, BN] output tiles (M rows fastest, then N, then the
// expert).  The producer runs on into the next tile while the consumers
// stage theirs in shared memory and hand it to TMA stores.  gate/up: A = x,
// B = da, du (TWO); down: A = h, B = go.
template <int BN, bool TWO>
__device__ __forceinline__ void wgrad_tiles(const CUtensorMap* map_a, const CUtensorMap* map_b0,
                                            const CUtensorMap* map_b1, const CUtensorMap* map_o0,
                                            const CUtensorMap* map_o1, const uint8_t* row_valid, bf16* out0,
                                            bf16* out1, int E, int C, int M, int N) {
  constexpr int NB = BN / BOX;
  const int ct = (C + BM - 1) / BM;
  const int n_m = (M + BLOCK_M - 1) / BLOCK_M, n_n = (N + BN - 1) / BN, total = E * n_m * n_n;
  unsigned char* ring = ring_base();
  unsigned char* staging = ring + WG_STAGES * WG_STAGE_BYTES;
  int* count = reinterpret_cast<int*>(staging + 2 * OUT_BYTES);
  uint16_t* tiles = reinterpret_cast<uint16_t*>(count + MAX_EXPERTS);
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * OUT_BYTES + LIST_BYTES);
  uint64_t* empty = full + WG_STAGES;
  list_live_tiles(row_valid, E, C, reinterpret_cast<uint32_t*>(staging), count, tiles);
  init_ring(full, empty, WG_STAGES, 8);  // every warp of both consumers releases each stage
  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      prefetch_map(map_a);
      prefetch_map(map_b0);
      if (TWO) prefetch_map(map_b1);
      int it = 0;
      for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
        const int e = tile / (n_m * n_n), m0 = tile % n_m * BLOCK_M, n0 = tile / n_m % n_n * BN;
        const int a_boxes = m0 + BM < M ? 2 : 1, b_boxes = min(NB, (N - n0) / BOX);  // boxes wholly outside: not loaded
        for (int i = 0; i < count[e]; ++i) {
          const int s = it % WG_STAGES, c0 = tiles[e * ct + i] * BM;
          if (it >= WG_STAGES) mbar_wait(&empty[s], (it / WG_STAGES - 1) & 1);
          unsigned char* st = ring + s * WG_STAGE_BYTES;
          mbar_expect_tx(&full[s], (a_boxes + (TWO ? 2 : 1) * b_boxes) * BOX_BYTES);
          for (int j = 0; j < a_boxes; ++j) tma_load(st + j * BOX_BYTES, map_a, &full[s], m0 + j * BOX, c0, e);
          for (int j = 0; j < b_boxes; ++j) {
            tma_load(st + A_BYTES + j * BOX_BYTES, map_b0, &full[s], n0 + j * BOX, c0, e);
            if (TWO) tma_load(st + A_BYTES + (NB + j) * BOX_BYTES, map_b1, &full[s], n0 + j * BOX, c0, e);
          }
          ++it;
        }
      }
    }
  } else {  // consumer of output rows [m0 + 64 half, + 64) of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int half = wg - 1, tid = threadIdx.x % 128, lane = tid % 32;
    unsigned char* stage = staging + half * OUT_BYTES;
    float acc0[BN / 2], acc1[TWO ? BN / 2 : 1];
    int it = 0;
    for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
      const int e = tile / (n_m * n_n), m0 = tile % n_m * BLOCK_M, n0 = tile / n_m % n_n * BN;
      const int r0 = m0 + half * BM;  // a half past M computes on boxes not loaded; its stores are clipped
      // broadcast: ptxas serialises the wgmma of a loop whose trip count it cannot see is warp-uniform
      const int k_tiles = __shfl_sync(0xffffffffu, count[e], 0);
      int pending = -1;
      for (int k = 0; k < k_tiles; ++k) {
        const int s = it % WG_STAGES;
        mbar_wait(&full[s], (it / WG_STAGES) & 1);
        const unsigned char* st = ring + s * WG_STAGE_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk) {  // 16 rows of the live tile per product
          const uint64_t dA = smem_desc(st + half * BOX_BYTES + kk * 16 * SWIZZLE_BYTES, BOX_BYTES);
          const unsigned char* b = st + A_BYTES + kk * 16 * SWIZZLE_BYTES;
          wgmma_ss<BN, 1, 1>(acc0, dA, smem_desc(b, BOX_BYTES), k | kk);
          if constexpr (TWO) wgmma_ss<BN, 1, 1>(acc1, dA, smem_desc(b + NB * BOX_BYTES, BOX_BYTES), k | kk);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: release it
        if (pending >= 0 && lane == 0) mbar_arrive(&empty[pending]);
        pending = s;
        ++it;
      }
      if (k_tiles == 0) {  // the expert has no live row: exact zeros
        store_zeros<BN>(out0 + (size_t)e * M * N, r0, BM, M, N, n0, tid, 128);
        if (TWO) store_zeros<BN>(out1 + (size_t)e * M * N, r0, BM, M, N, n0, tid, 128);
        continue;
      }
      wgmma_wait<0>();
      fence_regs(acc0);
      fence_regs(acc1);
      if (lane == 0) mbar_arrive(&empty[pending]);
      // the epilogue: bf16 into this consumer's staging boxes (once the last
      // tile's stores have read them), then TMA stores, clipped at M and N
      if (tid == 0) bulk_wait_read<0>();
      named_barrier(1 + half, 128);
      for_fragment<BN>(tid, [&](int i, int r, int c) {
        unsigned char* box = stage + (c / BOX) * BOX_BYTES + swizzled(r, c % BOX);
        *reinterpret_cast<__nv_bfloat162*>(box) = __floats2bfloat162_rn(acc0[i], acc0[i + 1]);
        if constexpr (TWO)
          *reinterpret_cast<__nv_bfloat162*>(box + NB * BOX_BYTES) = __floats2bfloat162_rn(acc1[i], acc1[i + 1]);
      });
      fence_async_smem();
      named_barrier(1 + half, 128);
      if (tid == 0 && r0 < M) {
        for (int j = 0; j < NB && n0 + j * BOX < N; ++j) {
          tma_store(map_o0, stage + j * BOX_BYTES, n0 + j * BOX, r0, e);
          if (TWO) tma_store(map_o1, stage + (NB + j) * BOX_BYTES, n0 + j * BOX, r0, e);
        }
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait<0>();
  }
}

// dwg = x^T @ da and dwu = x^T @ du ([d, F] per expert) over live tiles.
__global__ void __launch_bounds__(THREADS, 1) k3_wgrad_gate_up_kernel(
    const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_da,
    const __grid_constant__ CUtensorMap map_du, const __grid_constant__ CUtensorMap map_dwg,
    const __grid_constant__ CUtensorMap map_dwu, const uint8_t* __restrict__ row_valid, bf16* __restrict__ dwg,
    bf16* __restrict__ dwu, int E, int C, int D, int F) {
  wgrad_tiles<WGU_BN, true>(&map_x, &map_da, &map_du, &map_dwg, &map_dwu, row_valid, dwg, dwu, E, C, D, F);
}

// dwd = h^T @ go ([F, d] per expert) over live tiles.
__global__ void __launch_bounds__(THREADS, 1) k3_wgrad_down_kernel(
    const __grid_constant__ CUtensorMap map_h, const __grid_constant__ CUtensorMap map_go,
    const __grid_constant__ CUtensorMap map_dwd, const uint8_t* __restrict__ row_valid, bf16* __restrict__ dwd, int E,
    int C, int D, int F) {
  wgrad_tiles<WD_BN, false>(&map_h, &map_go, &map_go, &map_dwd, &map_dwd, row_valid, dwd, dwd, E, C, F, D);
}

// ----------------------------------------------------------- launch 2: dgrad
constexpr int DG_BN = 256;  // d columns of dx per block
constexpr int DG_W_BYTES = DG_BN * SWIZZLE_BYTES;  // a K-major [DG_BN rows of d, 64 of F] tile of wg or wu: 32 KB
constexpr int DG_STAGE_BYTES = A_BYTES + DG_W_BYTES;  // 48 KB
constexpr int DG_STAGES = 4;  // a 192 KB ring
constexpr int DG_SMEM = 1024 + DG_STAGES * DG_STAGE_BYTES + 2 * DG_STAGES * 8;

// dx[e] = da[e] @ wg[e]^T + du[e] @ wu[e]^T on the live 64-row halves of
// rows [c0, c0 + 128), columns [n0, n0 + DG_BN) of d, exact zeros on the
// dark halves: one contraction over 2F, (da, wg) stages first.
__global__ void __launch_bounds__(THREADS, 1) k2_dgrad_kernel(
    const __grid_constant__ CUtensorMap map_da, const __grid_constant__ CUtensorMap map_du,
    const __grid_constant__ CUtensorMap map_wg, const __grid_constant__ CUtensorMap map_wu,
    const uint8_t* __restrict__ row_valid, bf16* __restrict__ dx, int C, int D, int F) {
  const int c0 = blockIdx.x * BLOCK_M, n0 = blockIdx.y * DG_BN, e = blockIdx.z;
  bf16* dxe = dx + (size_t)e * C * D;
  const bool live[2] = {rows_live(row_valid, e, c0, C, 0), rows_live(row_valid, e, c0 + BM, C, 1)};
  if (!live[0] && !live[1]) {
    store_zeros<DG_BN>(dxe, c0, BLOCK_M, C, D, n0, threadIdx.x, THREADS);
    return;
  }
  unsigned char* ring = ring_base();
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + DG_STAGES * DG_STAGE_BYTES);
  uint64_t* empty = full + DG_STAGES;
  init_ring(full, empty, DG_STAGES, 4 * (live[0] + live[1]));
  const int KF = F / BK, KT = 2 * KF;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      prefetch_map(&map_da);
      prefetch_map(&map_du);
      prefetch_map(&map_wg);
      prefetch_map(&map_wu);
      const uint32_t bytes = (live[0] + live[1]) * (A_BYTES / 2) + DG_W_BYTES;
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % DG_STAGES, k0 = (kt < KF ? kt : kt - KF) * BK;
        const CUtensorMap* map_a = kt < KF ? &map_da : &map_du;
        if (kt >= DG_STAGES) mbar_wait(&empty[s], (kt / DG_STAGES - 1) & 1);
        unsigned char* st = ring + s * DG_STAGE_BYTES;
        mbar_expect_tx(&full[s], bytes);
        for (int half = 0; half < 2; ++half)  // a dark half's rows are never loaded
          if (live[half]) tma_load(st + half * (A_BYTES / 2), map_a, &full[s], k0, c0 + half * BM, e);
        tma_load(st + A_BYTES, kt < KF ? &map_wg : &map_wu, &full[s], k0, n0, e);  // rows past d zero-fill
      }
    }
  } else {  // consumer of 64-row half wg - 1
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int half = wg - 1, tid = threadIdx.x % 128;
    const int r0 = c0 + half * BM;
    if (!live[half]) {
      store_zeros<DG_BN>(dxe, r0, BM, C, D, n0, tid, 128);
      return;
    }
    float acc[DG_BN / 2];
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % DG_STAGES;
      mbar_wait(&full[s], (kt / DG_STAGES) & 1);
      const unsigned char* st = ring + s * DG_STAGE_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)  // A and B both K-major: 32 bytes per k16 step, no transpose
        wgmma_ss<DG_BN, 0, 0>(acc, smem_desc(st + half * (A_BYTES / 2) + kk * 32, 0),
                              smem_desc(st + A_BYTES + kk * 32, 0), kt | kk);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: release it
      if (kt > 0 && tid % 32 == 0) mbar_arrive(&empty[(kt - 1) % DG_STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    for_fragment<DG_BN>(tid, [&](int i, int r, int c) {
      if (r0 + r < C && n0 + c < D)
        *reinterpret_cast<__nv_bfloat162*>(dxe + (size_t)(r0 + r) * D + n0 + c) =
            __floats2bfloat162_rn(acc[i], acc[i + 1]);
    });
  }
}

bool bad_shape(int E, int C, int D, int F) {
  const int tiles = (C + BM - 1) / BM;
  return E <= 0 || C <= 0 || tiles > MAX_TILES || E > MAX_EXPERTS || E * tiles > MAX_LISTED || D % BK || F % BK;
}

}  // namespace

// Row tile the occupancy skip works at; the Python wrapper reads it.
extern "C" int moe_gemm_bwd_row_tile() { return BM; }

// All launches on `stream`; every tensor is contiguous, 16-byte-aligned
// bf16 except row_valid ([E, C] bytes, 0 = dark slot); d and F are
// multiples of 64.  Each returns the CUDA error code (0 = ok).  da, du, h
// are the caller's [E, C, F] scratch.
extern "C" int moe_gemm_silu_grads(const void* go, const void* x, const void* wg, const void* wu,
                                   const void* wd, const void* row_valid, void* da, void* du, void* h, int E,
                                   int C, int D, int F, void* stream) {
  if (bad_shape(E, C, D, F)) return (int)cudaErrorInvalidValue;
  if (!encode_tiled()) return (int)cudaErrorSymbolNotFound;
  CUtensorMap map_x, map_go, map_wg, map_wu, map_wd;
  if (!make_map(&map_x, x, E, C, D, BLOCK_M) || !make_map(&map_go, go, E, C, D, BLOCK_M) ||
      !make_map(&map_wg, wg, E, D, F, BK) || !make_map(&map_wu, wu, E, D, F, BK) ||
      !make_map(&map_wd, wd, E, F, D, SG_BN))
    return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  const cudaError_t err = allow_smem(k23_silu_grads_kernel, SG_SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  k23_silu_grads_kernel<<<dim3((C + BLOCK_M - 1) / BLOCK_M, (F + SG_BN - 1) / SG_BN, E), THREADS, SG_SMEM,
                          static_cast<cudaStream_t>(stream)>>>(
      map_x, map_go, map_wg, map_wu, map_wd, static_cast<const uint8_t*>(row_valid), static_cast<bf16*>(da),
      static_cast<bf16*>(du), static_cast<bf16*>(h), C, D, F);
  return (int)cudaGetLastError();
}

extern "C" int moe_gemm_dgrad_from(const void* da, const void* du, const void* wg, const void* wu,
                                   const void* row_valid, void* dx, int E, int C, int D, int F, void* stream) {
  if (bad_shape(E, C, D, F)) return (int)cudaErrorInvalidValue;
  if (!encode_tiled()) return (int)cudaErrorSymbolNotFound;
  CUtensorMap map_da, map_du, map_wg, map_wu;
  if (!make_map(&map_da, da, E, C, F, BM) || !make_map(&map_du, du, E, C, F, BM) ||
      !make_map(&map_wg, wg, E, D, F, DG_BN) || !make_map(&map_wu, wu, E, D, F, DG_BN))
    return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  const cudaError_t err = allow_smem(k2_dgrad_kernel, DG_SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  k2_dgrad_kernel<<<dim3((C + BLOCK_M - 1) / BLOCK_M, (D + DG_BN - 1) / DG_BN, E), THREADS, DG_SMEM,
                    static_cast<cudaStream_t>(stream)>>>(map_da, map_du, map_wg, map_wu,
                                                         static_cast<const uint8_t*>(row_valid),
                                                         static_cast<bf16*>(dx), C, D, F);
  return (int)cudaGetLastError();
}

extern "C" int moe_gemm_wgrad_from(const void* x, const void* go, const void* da, const void* du,
                                   const void* h, const void* row_valid, void* dwg, void* dwu, void* dwd, int E,
                                   int C, int D, int F, void* stream) {
  if (bad_shape(E, C, D, F)) return (int)cudaErrorInvalidValue;
  if (!encode_tiled()) return (int)cudaErrorSymbolNotFound;
  CUtensorMap map_x, map_go, map_da, map_du, map_h, map_dwg, map_dwu, map_dwd;
  if (!make_map(&map_x, x, E, C, D, BM) || !make_map(&map_go, go, E, C, D, BM) ||
      !make_map(&map_da, da, E, C, F, BM) || !make_map(&map_du, du, E, C, F, BM) ||
      !make_map(&map_h, h, E, C, F, BM) || !make_map(&map_dwg, dwg, E, D, F, BM) ||
      !make_map(&map_dwu, dwu, E, D, F, BM) || !make_map(&map_dwd, dwd, E, F, D, BM))
    return (int)cudaErrorInvalidValue;
  static bool gate_up_set = false, down_set = false;
  static int sms = 0;
  cudaError_t err = allow_smem(k3_wgrad_gate_up_kernel, WG_SMEM, gate_up_set);
  if (err == cudaSuccess) err = allow_smem(k3_wgrad_down_kernel, WG_SMEM, down_set);
  if (err == cudaSuccess && !sms) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* rv = static_cast<const uint8_t*>(row_valid);
  const int m_d = (D + BLOCK_M - 1) / BLOCK_M, m_f = (F + BLOCK_M - 1) / BLOCK_M;
  const int gu_tiles = E * m_d * ((F + WGU_BN - 1) / WGU_BN), dn_tiles = E * m_f * ((D + WD_BN - 1) / WD_BN);
  k3_wgrad_gate_up_kernel<<<min(gu_tiles, sms), THREADS, WG_SMEM, s>>>(
      map_x, map_da, map_du, map_dwg, map_dwu, rv, static_cast<bf16*>(dwg), static_cast<bf16*>(dwu), E, C, D, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k3_wgrad_down_kernel<<<min(dn_tiles, sms), THREADS, WG_SMEM, s>>>(map_h, map_go, map_dwd, rv,
                                                                     static_cast<bf16*>(dwd), E, C, D, F);
  return (int)cudaGetLastError();
}
