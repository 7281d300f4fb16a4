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
// A BM-row tile of slots with no live row (row_valid [E, C]) is dark, as
// in the forward: its dx is exact zeros and it adds nothing to any weight
// gradient; an expert with no live tile gets exact-zero weight gradients.
//
// The TPU kernels carry f32 scratch across a sequential grid axis (F for
// dgrad, C for wgrad).  GPU blocks run in no order, so this is three
// launches instead:
//   1. silu_grads: per live tile and 64-column F slab, recompute a, u and
//      dh (each a contraction over d) and store da, du and h as bf16 to
//      [E, C, F] scratch.  These are the rounding points the tensor cores
//      need (the TPU kernel keeps da/du in f32 and rounds only h).
//   2. dgrad: dx = [da | du] @ [wg^T ; wu^T], one contraction over 2F
//      inside the block; the transposed weights are read as row-major
//      [n, k] tiles and fed to column-major WMMA fragments.
//   3. wgrad: dwg/dwu (sharing the x^T tile) and dwd, contracting over C
//      inside the block.  Each block lists its expert's live tiles in
//      shared memory first and loops over those only.
// K2 is launches 1+2, K3 is launches 1+3; the training backward runs 1
// once and feeds both.
//
// What bounds it on an H100: at the training shape (C = 640 per expert,
// ~5100 occupied rows, d = 4096, F = 14336) dgrad is ~10 d F FLOP per
// row (3.0e12) and wgrad ~12 d F per row (3.6e12) against ~2.8 GB of
// weights and weight gradients, so the tensor cores bound both (~3 and
// ~3.7 ms at 989 TFLOP/s).  Design as K1: bf16 WMMA 16x16x16 with f32
// accumulators, a three-stage cp.async ring, 64x64 output tiles per
// 128-thread block; no wgmma, TMA or persistent blocks yet.  Rows past C
// are zero-filled by cp.async with 0 source bytes, so they add nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;        // slot rows per tile (the occupancy tile) / output rows
constexpr int BN = 64;        // output columns per tile
constexpr int BK = 32;        // contraction step per pipeline stage
constexpr int STAGES = 3;
constexpr int THREADS = 128;  // 4 warps in a 2x2 grid, 32x32 outputs each
constexpr int MAX_TILES = 256;  // row tiles per expert that wgrad can list
constexpr int LDA = BK + 8;   // pitch of an [BM, BK] A tile and an [BN, BK] B^T tile
constexpr int LDB = BN + 8;   // pitch of a [BK, BN] B tile
constexpr int LDT = BM + 8;   // pitch of a [BK, BM] A^T tile
constexpr int LDC = BN + 4;   // pitch of the f32 epilogue tile
constexpr int A_ELEMS = BM * LDA;
constexpr int BT_ELEMS = BN * LDA;
constexpr int B_ELEMS = BK * LDB;
constexpr int AT_ELEMS = BK * LDT;
constexpr int EPI_BYTES = BM * LDC * 4;
constexpr int cmax(int a, int b) { return a > b ? a : b; }
// silu_grads stage: x, go (A), wg, wu (B), wd^T (B^T)
constexpr int SG_STAGE_BYTES = (2 * A_ELEMS + 2 * B_ELEMS + BT_ELEMS) * 2;
constexpr int SG_SMEM = cmax(STAGES * SG_STAGE_BYTES, EPI_BYTES);  // > 48 KB: dynamic
// dgrad stage: da or du (A), wg^T or wu^T (B^T)
constexpr int DG_STAGE_BYTES = (A_ELEMS + BT_ELEMS) * 2;
constexpr int DG_SMEM = cmax(STAGES * DG_STAGE_BYTES, EPI_BYTES);
// wgrad gate/up stage: x^T (A^T), da, du (B); down stage: h^T (A^T), go (B)
constexpr int WGU_STAGE_BYTES = (AT_ELEMS + 2 * B_ELEMS) * 2;
constexpr int WGU_SMEM = cmax(STAGES * WGU_STAGE_BYTES, EPI_BYTES);
constexpr int WD_STAGE_BYTES = (AT_ELEMS + B_ELEMS) * 2;
constexpr int WD_SMEM = cmax(STAGES * WD_STAGE_BYTES, EPI_BYTES);

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAT;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBT;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// True (in every thread) iff a row of [c0, c0 + BM) below C is live.
__device__ __forceinline__ bool tile_live(const uint8_t* row_valid, int e, int c0, int C) {
  const int r = threadIdx.x;
  bool v = false;
  if (r < BM && c0 + r < C) v = row_valid[(size_t)e * C + c0 + r] != 0;
  return __syncthreads_or(v) != 0;
}

// [BM, BK] tile of a row-major [C, K] matrix at (c0, k0); rows >= C are zero.
__device__ __forceinline__ void load_a(bf16* s, const bf16* A, int C, int K, int c0, int k0) {
  for (int i = threadIdx.x; i < BM * BK / 8; i += THREADS) {
    const int r = i / (BK / 8), cc = (i % (BK / 8)) * 8;
    const bool ok = c0 + r < C;
    cp_async16(s + r * LDA + cc, A + (size_t)(ok ? c0 + r : 0) * K + k0 + cc, ok);
  }
}

// [BK, BN] tile of a row-major [R, N] matrix at (r0, n0); rows >= R are zero.
__device__ __forceinline__ void load_b(bf16* s, const bf16* B, int R, int N, int r0, int n0) {
  for (int i = threadIdx.x; i < BK * BN / 8; i += THREADS) {
    const int r = i / (BN / 8), cc = (i % (BN / 8)) * 8;
    const bool ok = r0 + r < R;
    cp_async16(s + r * LDB + cc, B + (size_t)(ok ? r0 + r : 0) * N + n0 + cc, ok);
  }
}

// [BN, BK] tile (rows n0.., columns k0..) of a row-major [*, K] matrix:
// read as a column-major [BK, BN] B operand, i.e. the matrix transposed.
__device__ __forceinline__ void load_bt(bf16* s, const bf16* W, int K, int n0, int k0) {
  for (int i = threadIdx.x; i < BN * BK / 8; i += THREADS) {
    const int r = i / (BK / 8), cc = (i % (BK / 8)) * 8;
    cp_async16(s + r * LDA + cc, W + (size_t)(n0 + r) * K + k0 + cc, true);
  }
}

// [BK, BM] tile (rows c0.., columns m0..) of a row-major [C, M] matrix,
// rows >= C zero: read as a column-major [BM, BK] A operand (transposed).
__device__ __forceinline__ void load_at(bf16* s, const bf16* X, int C, int M, int c0, int m0) {
  for (int i = threadIdx.x; i < BK * BM / 8; i += THREADS) {
    const int r = i / (BM / 8), cc = (i % (BM / 8)) * 8;
    const bool ok = c0 + r < C;
    cp_async16(s + r * LDT + cc, X + (size_t)(ok ? c0 + r : 0) * M + m0 + cc, ok);
  }
}

// Write the f32 epilogue tile's rows below R as bf16 into a row-major [R, N] matrix.
__device__ __forceinline__ void store_tile(bf16* dst, const float* sC, int R, int N, int r0, int n0) {
  for (int i = threadIdx.x; i < BM * BN / 2; i += THREADS) {
    const int r = i / (BN / 2), cc = (i % (BN / 2)) * 2;
    if (r0 + r < R) {
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)(r0 + r) * N + n0 + cc) =
          __floats2bfloat162_rn(sC[r * LDC + cc], sC[r * LDC + cc + 1]);
    }
  }
}

__device__ __forceinline__ void zero_tile(bf16* dst, int R, int N, int r0, int n0) {
  for (int i = threadIdx.x; i < BM * BN / 2; i += THREADS) {
    const int r = i / (BN / 2), cc = (i % (BN / 2)) * 2;
    if (r0 + r < R)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)(r0 + r) * N + n0 + cc) = __floats2bfloat162_rn(0.f, 0.f);
  }
}

// Stage a warp's 2x2 accumulator fragments in the f32 tile and write them out.
__device__ __forceinline__ void flush(FragC (&acc)[2][2], float* sC, bf16* dst, int R, int N, int r0, int n0,
                                      int wm, int wn) {
  __syncthreads();  // sC may alias the last stage, or the previous flush
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sC + (wm + 16 * i) * LDC + wn + 16 * j, acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  store_tile(dst, sC, R, N, r0, n0);
}

__device__ __forceinline__ void zero_acc(FragC (&acc)[2][2]) {
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
}

// Launch 1: da, du, h (bf16 [E, C, F]) on live tiles.
__global__ void __launch_bounds__(THREADS) silu_grads_kernel(
    const bf16* __restrict__ go, const bf16* __restrict__ x, const bf16* __restrict__ wg,
    const bf16* __restrict__ wu, const bf16* __restrict__ wd, const uint8_t* __restrict__ row_valid,
    bf16* __restrict__ da, bf16* __restrict__ du, bf16* __restrict__ h, int C, int D, int F) {
  const int n0 = blockIdx.x * BN, c0 = blockIdx.y * BM, e = blockIdx.z;
  if (!tile_live(row_valid, e, c0, C)) return;  // nothing reads a dark tile's scratch
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t xo = (size_t)e * C * D, wo = (size_t)e * D * F;
  auto sX = [&](int s) { return reinterpret_cast<bf16*>(smem + s * SG_STAGE_BYTES); };
  auto sGo = [&](int s) { return sX(s) + A_ELEMS; };
  auto sWg = [&](int s) { return sX(s) + 2 * A_ELEMS; };
  auto sWu = [&](int s) { return sX(s) + 2 * A_ELEMS + B_ELEMS; };
  auto sWdT = [&](int s) { return sX(s) + 2 * A_ELEMS + 2 * B_ELEMS; };
  auto load_stage = [&](int s, int kt) {
    const int k0 = kt * BK;
    load_a(sX(s), x + xo, C, D, c0, k0);
    load_a(sGo(s), go + xo, C, D, c0, k0);
    load_b(sWg(s), wg + wo, D, F, k0, n0);
    load_b(sWu(s), wu + wo, D, F, k0, n0);
    load_bt(sWdT(s), wd + wo, D, n0, k0);  // (wd^T)[k, n] = wd[n, k]
  };
  const int KT = D / BK;
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  const int warp = threadIdx.x / 32, wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  FragC a[2][2], u[2][2], dh[2][2];
  zero_acc(a);
  zero_acc(u);
  zero_acc(dh);
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < KT) load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const int s = kt % STAGES;
    for (int kk = 0; kk < BK; kk += 16) {
      FragA fx[2], fgo[2];
      FragB fb[2];
      FragBT fbt[2];
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(fx[i], sX(s) + (wm + 16 * i) * LDA + kk, LDA);
        wmma::load_matrix_sync(fgo[i], sGo(s) + (wm + 16 * i) * LDA + kk, LDA);
      }
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], sWg(s) + kk * LDB + wn + 16 * j, LDB);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) wmma::mma_sync(a[i][j], fx[i], fb[j], a[i][j]);
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], sWu(s) + kk * LDB + wn + 16 * j, LDB);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) wmma::mma_sync(u[i][j], fx[i], fb[j], u[i][j]);
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fbt[j], sWdT(s) + (wn + 16 * j) * LDA + kk, LDA);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) wmma::mma_sync(dh[i][j], fgo[i], fbt[j], dh[i][j]);
    }
  }
  cp_async_wait<0>();
  // a, u and dh fragments share one element layout, so the backward of
  // silu(a) * u is elementwise: a <- da, u <- du, dh <- h
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      for (int t = 0; t < a[i][j].num_elements; ++t) {
        const float av = a[i][j].x[t], uv = u[i][j].x[t], g = dh[i][j].x[t];
        const float s = 1.f / (1.f + expf(-av));
        a[i][j].x[t] = g * uv * s * (1.f + av * (1.f - s));
        u[i][j].x[t] = g * s * av;
        dh[i][j].x[t] = s * av * uv;
      }
  float* sC = reinterpret_cast<float*>(smem);
  const size_t ho = (size_t)e * C * F;
  flush(a, sC, da + ho, C, F, c0, n0, wm, wn);
  flush(u, sC, du + ho, C, F, c0, n0, wm, wn);
  flush(dh, sC, h + ho, C, F, c0, n0, wm, wn);
}

// Launch 2: dx = da @ wg^T + du @ wu^T on live tiles, exact zeros on dark ones.
__global__ void __launch_bounds__(THREADS) dgrad_kernel(
    const bf16* __restrict__ da, const bf16* __restrict__ du, const bf16* __restrict__ wg,
    const bf16* __restrict__ wu, const uint8_t* __restrict__ row_valid, bf16* __restrict__ dx, int C, int D,
    int F) {
  const int n0 = blockIdx.x * BN, c0 = blockIdx.y * BM, e = blockIdx.z;
  bf16* dxe = dx + (size_t)e * C * D;
  if (!tile_live(row_valid, e, c0, C)) {
    zero_tile(dxe, C, D, c0, n0);
    return;
  }
  __shared__ __align__(128) unsigned char smem[DG_SMEM];
  const size_t ho = (size_t)e * C * F, wo = (size_t)e * D * F;
  auto sA = [&](int s) { return reinterpret_cast<bf16*>(smem + s * DG_STAGE_BYTES); };
  auto sBT = [&](int s) { return sA(s) + A_ELEMS; };
  const int KF = F / BK;
  auto load_stage = [&](int s, int kt) {  // the first F steps pair da with wg, the rest du with wu
    const bool first = kt < KF;
    const int k0 = (first ? kt : kt - KF) * BK;
    load_a(sA(s), (first ? da : du) + ho, C, F, c0, k0);
    load_bt(sBT(s), (first ? wg : wu) + wo, F, n0, k0);  // (wg^T)[f, n] = wg[n, f]
  };
  const int KT = 2 * KF;
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  const int warp = threadIdx.x / 32, wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  FragC acc[2][2];
  zero_acc(acc);
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < KT) load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const int s = kt % STAGES;
    for (int kk = 0; kk < BK; kk += 16) {
      FragA fa[2];
      FragBT fb[2];
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], sA(s) + (wm + 16 * i) * LDA + kk, LDA);
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], sBT(s) + (wn + 16 * j) * LDA + kk, LDA);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  flush(acc, reinterpret_cast<float*>(smem), dxe, C, D, c0, n0, wm, wn);
}

// The live row tiles of expert e, in order, into tiles[]; returns their count.
__device__ __forceinline__ int list_live_tiles(const uint8_t* row_valid, int e, int C, int* tiles,
                                               uint8_t* flags, int* count) {
  const int ct = (C + BM - 1) / BM;
  for (int t = threadIdx.x; t < ct; t += THREADS) flags[t] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < C; i += THREADS)
    if (row_valid[(size_t)e * C + i]) flags[i / BM] = 1;
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int t = 0; t < ct; ++t)
      if (flags[t]) tiles[n++] = t;
    *count = n;
  }
  __syncthreads();
  return *count;
}

// Launch 3a: dwg = x^T @ da and dwu = x^T @ du ([d, F] per expert) over live tiles.
__global__ void __launch_bounds__(THREADS) wgrad_gate_up_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ da, const bf16* __restrict__ du,
    const uint8_t* __restrict__ row_valid, bf16* __restrict__ dwg, bf16* __restrict__ dwu, int C, int D,
    int F) {
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, e = blockIdx.z;
  __shared__ __align__(128) unsigned char smem[WGU_SMEM];
  __shared__ int tiles[MAX_TILES];
  __shared__ uint8_t flags[MAX_TILES];
  __shared__ int n_live;
  const int KT = list_live_tiles(row_valid, e, C, tiles, flags, &n_live) * (BM / BK);
  const size_t xo = (size_t)e * C * D, ho = (size_t)e * C * F;
  auto sXT = [&](int s) { return reinterpret_cast<bf16*>(smem + s * WGU_STAGE_BYTES); };
  auto sDa = [&](int s) { return sXT(s) + AT_ELEMS; };
  auto sDu = [&](int s) { return sXT(s) + AT_ELEMS + B_ELEMS; };
  auto load_stage = [&](int s, int kt) {
    const int c0 = tiles[kt / (BM / BK)] * BM + (kt % (BM / BK)) * BK;
    load_at(sXT(s), x + xo, C, D, c0, m0);
    load_b(sDa(s), da + ho, C, F, c0, n0);
    load_b(sDu(s), du + ho, C, F, c0, n0);
  };
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  const int warp = threadIdx.x / 32, wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  FragC ag[2][2], au[2][2];
  zero_acc(ag);
  zero_acc(au);
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < KT) load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const int s = kt % STAGES;
    for (int kk = 0; kk < BK; kk += 16) {
      FragAT fa[2];
      FragB fb[2];
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], sXT(s) + kk * LDT + wm + 16 * i, LDT);
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], sDa(s) + kk * LDB + wn + 16 * j, LDB);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) wmma::mma_sync(ag[i][j], fa[i], fb[j], ag[i][j]);
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], sDu(s) + kk * LDB + wn + 16 * j, LDB);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) wmma::mma_sync(au[i][j], fa[i], fb[j], au[i][j]);
    }
  }
  cp_async_wait<0>();
  float* sC = reinterpret_cast<float*>(smem);
  const size_t wo = (size_t)e * D * F;
  flush(ag, sC, dwg + wo, D, F, m0, n0, wm, wn);
  flush(au, sC, dwu + wo, D, F, m0, n0, wm, wn);
}

// Launch 3b: dwd = h^T @ go ([F, d] per expert) over live tiles.
__global__ void __launch_bounds__(THREADS) wgrad_down_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ go, const uint8_t* __restrict__ row_valid,
    bf16* __restrict__ dwd, int C, int D, int F) {
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, e = blockIdx.z;
  __shared__ __align__(128) unsigned char smem[WD_SMEM];
  __shared__ int tiles[MAX_TILES];
  __shared__ uint8_t flags[MAX_TILES];
  __shared__ int n_live;
  const int KT = list_live_tiles(row_valid, e, C, tiles, flags, &n_live) * (BM / BK);
  const size_t xo = (size_t)e * C * D, ho = (size_t)e * C * F;
  auto sHT = [&](int s) { return reinterpret_cast<bf16*>(smem + s * WD_STAGE_BYTES); };
  auto sGo = [&](int s) { return sHT(s) + AT_ELEMS; };
  auto load_stage = [&](int s, int kt) {
    const int c0 = tiles[kt / (BM / BK)] * BM + (kt % (BM / BK)) * BK;
    load_at(sHT(s), h + ho, C, F, c0, m0);
    load_b(sGo(s), go + xo, C, D, c0, n0);
  };
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  const int warp = threadIdx.x / 32, wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  FragC acc[2][2];
  zero_acc(acc);
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < KT) load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const int s = kt % STAGES;
    for (int kk = 0; kk < BK; kk += 16) {
      FragAT fa[2];
      FragB fb[2];
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], sHT(s) + kk * LDT + wm + 16 * i, LDT);
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], sGo(s) + kk * LDB + wn + 16 * j, LDB);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  flush(acc, reinterpret_cast<float*>(smem), dwd + (size_t)e * F * D, F, D, m0, n0, wm, wn);
}

bool bad_shape(int E, int C, int D, int F) {
  return E <= 0 || C <= 0 || (C + BM - 1) / BM > MAX_TILES || D % BK || D % BN || D % BM || F % BK ||
         F % BN || F % BM;
}

}  // namespace

// Row tile the occupancy skip works at; the Python wrapper reads it.
extern "C" int moe_gemm_bwd_row_tile() { return BM; }

// All launches on `stream`; every tensor is contiguous bf16 except
// row_valid ([E, C] bytes, 0 = dark slot).  Each returns the CUDA error
// code (0 = ok).  da, du, h are the caller's [E, C, F] scratch.
extern "C" int moe_gemm_silu_grads(const void* go, const void* x, const void* wg, const void* wu,
                                   const void* wd, const void* row_valid, void* da, void* du, void* h, int E,
                                   int C, int D, int F, void* stream) {
  if (bad_shape(E, C, D, F)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(silu_grads_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SG_SMEM);
  if (err != cudaSuccess) return (int)err;
  silu_grads_kernel<<<dim3(F / BN, (C + BM - 1) / BM, E), THREADS, SG_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(go), static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
      static_cast<const bf16*>(wu), static_cast<const bf16*>(wd), static_cast<const uint8_t*>(row_valid),
      static_cast<bf16*>(da), static_cast<bf16*>(du), static_cast<bf16*>(h), C, D, F);
  return (int)cudaGetLastError();
}

extern "C" int moe_gemm_dgrad_from(const void* da, const void* du, const void* wg, const void* wu,
                                   const void* row_valid, void* dx, int E, int C, int D, int F, void* stream) {
  if (bad_shape(E, C, D, F)) return (int)cudaErrorInvalidValue;
  dgrad_kernel<<<dim3(D / BN, (C + BM - 1) / BM, E), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(da), static_cast<const bf16*>(du), static_cast<const bf16*>(wg),
      static_cast<const bf16*>(wu), static_cast<const uint8_t*>(row_valid), static_cast<bf16*>(dx), C, D, F);
  return (int)cudaGetLastError();
}

extern "C" int moe_gemm_wgrad_from(const void* x, const void* go, const void* da, const void* du,
                                   const void* h, const void* row_valid, void* dwg, void* dwu, void* dwd, int E,
                                   int C, int D, int F, void* stream) {
  if (bad_shape(E, C, D, F)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* rv = static_cast<const uint8_t*>(row_valid);
  wgrad_gate_up_kernel<<<dim3(F / BN, D / BM, E), THREADS, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(da), static_cast<const bf16*>(du), rv,
      static_cast<bf16*>(dwg), static_cast<bf16*>(dwu), C, D, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wgrad_down_kernel<<<dim3(D / BN, F / BM, E), THREADS, 0, s>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(go), rv, static_cast<bf16*>(dwd), C, D, F);
  return (int)cudaGetLastError();
}
