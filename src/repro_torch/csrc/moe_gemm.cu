// Grouped SwiGLU expert GEMM with a per-row-tile occupancy skip (kernel K1).
//
// Replaces the TPU kernel src/repro/kernels/moe_gemm/kernel.py,
// moe_gemm_grouped_pallas (body _grouped_kernel):
//
//     out[e] = bf16(silu(x[e] @ wg[e]) * (x[e] @ wu[e])) @ wd[e]
//
// with f32 accumulation, for x [E, C, d], wg/wu [E, d, F], wd [E, F, d],
// all bf16, row-major.  A row tile of BM slots with no live row (per the
// row_valid [E, C] mask) skips all three products and writes exact zeros;
// a tile with any live row computes every row.  Rows past C are masked.
//
// What bounds it on an H100: at prefill shapes (C = 320 per expert,
// d = 4096, F = 14336) the three products are 9.0e11 FLOP per layer
// against 2.8 GB of weights, so the tensor cores bound it (0.91 ms at
// 989 TFLOP/s vs 0.84 ms for the bytes at 3.35 TB/s).  At decode
// (C = 8) it is bound by reading the weights of experts with a live
// tile.  Design: bf16 WMMA 16x16x16 tiles with f32 accumulators, a
// three-stage cp.async ring for the A and B tiles, 64x64 output tiles per
// 128-thread block.  No wgmma, TMA or persistent blocks yet.
//
// The TPU kernel carries an f32 [BC, d] accumulator across a sequential F
// grid axis.  GPU blocks run in no order, so this kernel uses two
// launches instead: gate_up writes h = bf16(silu(g) * u) to a bf16
// scratch [E, C, F] (g and u stay f32 until that one rounding), and down
// computes h @ wd with f32 accumulation over all of F inside the block.
// Both launches decide occupancy at the same BM-row tile from row_valid
// themselves, so a dark tile's h is never written and never read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;        // slot rows per tile: the occupancy tile
constexpr int BN = 64;        // output columns per tile
constexpr int BK = 32;        // contraction step per pipeline stage
constexpr int STAGES = 3;
constexpr int THREADS = 128;  // 4 warps in a 2x2 grid, 32x32 outputs each
constexpr int LDA = BK + 8;   // smem pitch (elements) of an A tile row
constexpr int LDB = BN + 8;   // smem pitch of a B tile row
constexpr int LDC = BN + 4;   // smem pitch of the f32 epilogue tile
constexpr int A_ELEMS = BM * LDA;
constexpr int B_ELEMS = BK * LDB;
constexpr int GU_STAGE_BYTES = (A_ELEMS + 2 * B_ELEMS) * 2;
constexpr int DN_STAGE_BYTES = (A_ELEMS + B_ELEMS) * 2;
constexpr int EPI_BYTES = BM * LDC * 4;
constexpr int GU_SMEM = STAGES * GU_STAGE_BYTES > EPI_BYTES ? STAGES * GU_STAGE_BYTES : EPI_BYTES;
constexpr int DN_SMEM = STAGES * DN_STAGE_BYTES > EPI_BYTES ? STAGES * DN_STAGE_BYTES : EPI_BYTES;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
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

// A tile [BM, BK] of a row-major [C, K] matrix at (c0, k0); rows >= C are zero.
__device__ __forceinline__ void load_a(bf16* sA, const bf16* A, int C, int K, int c0, int k0) {
  for (int i = threadIdx.x; i < BM * BK / 8; i += THREADS) {
    const int r = i / (BK / 8), cc = (i % (BK / 8)) * 8;
    const bool ok = c0 + r < C;
    cp_async16(sA + r * LDA + cc, A + (size_t)(ok ? c0 + r : 0) * K + k0 + cc, ok);
  }
}

// B tile [BK, BN] of a row-major [K, N] matrix at (k0, n0).
__device__ __forceinline__ void load_b(bf16* sB, const bf16* B, int N, int k0, int n0) {
  for (int i = threadIdx.x; i < BK * BN / 8; i += THREADS) {
    const int r = i / (BN / 8), cc = (i % (BN / 8)) * 8;
    cp_async16(sB + r * LDB + cc, B + (size_t)(k0 + r) * N + n0 + cc, true);
  }
}

// Write the f32 epilogue tile's rows below C as bf16 into a row-major [C, N] matrix.
__device__ __forceinline__ void store_tile(bf16* dst, const float* sC, int C, int N, int c0, int n0) {
  for (int i = threadIdx.x; i < BM * BN / 2; i += THREADS) {
    const int r = i / (BN / 2), cc = (i % (BN / 2)) * 2;
    if (c0 + r < C) {
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)(c0 + r) * N + n0 + cc) =
          __floats2bfloat162_rn(sC[r * LDC + cc], sC[r * LDC + cc + 1]);
    }
  }
}

// h[e, c, f] = bf16(silu(x[e] @ wg[e]) * (x[e] @ wu[e])) for live tiles.
__global__ void __launch_bounds__(THREADS) gate_up_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ wg, const bf16* __restrict__ wu,
    const uint8_t* __restrict__ row_valid, bf16* __restrict__ h, int C, int D, int F) {
  const int n0 = blockIdx.x * BN, c0 = blockIdx.y * BM, e = blockIdx.z;
  if (!tile_live(row_valid, e, c0, C)) return;  // the down launch writes its zeros
  __shared__ __align__(128) unsigned char smem[GU_SMEM];
  const bf16* xe = x + (size_t)e * C * D;
  const bf16* wge = wg + (size_t)e * D * F;
  const bf16* wue = wu + (size_t)e * D * F;
  auto sA = [&](int s) { return reinterpret_cast<bf16*>(smem + s * GU_STAGE_BYTES); };
  auto sG = [&](int s) { return sA(s) + A_ELEMS; };
  auto sU = [&](int s) { return sA(s) + A_ELEMS + B_ELEMS; };
  auto load_stage = [&](int s, int kt) {
    load_a(sA(s), xe, C, D, c0, kt * BK);
    load_b(sG(s), wge, F, kt * BK, n0);
    load_b(sU(s), wue, F, kt * BK, n0);
  };
  const int KT = D / BK;
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  const int warp = threadIdx.x / 32, wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  FragC g[2][2], u[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(g[i][j], 0.f);
      wmma::fill_fragment(u[i][j], 0.f);
    }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < KT) load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const int s = kt % STAGES;
    for (int kk = 0; kk < BK; kk += 16) {
      FragA fa[2];
      FragB fb[2];
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], sA(s) + (wm + 16 * i) * LDA + kk, LDA);
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], sG(s) + kk * LDB + wn + 16 * j, LDB);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) wmma::mma_sync(g[i][j], fa[i], fb[j], g[i][j]);
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], sU(s) + kk * LDB + wn + 16 * j, LDB);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) wmma::mma_sync(u[i][j], fa[i], fb[j], u[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float* sC = reinterpret_cast<float*>(smem);
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) {
      // g and u fragments share one element layout, so silu(g) * u is elementwise
      for (int t = 0; t < g[i][j].num_elements; ++t) {
        const float a = g[i][j].x[t];
        g[i][j].x[t] = a / (1.f + expf(-a)) * u[i][j].x[t];
      }
      wmma::store_matrix_sync(sC + (wm + 16 * i) * LDC + wn + 16 * j, g[i][j], LDC, wmma::mem_row_major);
    }
  __syncthreads();
  store_tile(h + (size_t)e * C * F, sC, C, F, c0, n0);
}

// out[e] = bf16(h[e] @ wd[e]) for live tiles, exact zeros for dark ones.
__global__ void __launch_bounds__(THREADS) down_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ wd, const uint8_t* __restrict__ row_valid,
    bf16* __restrict__ out, int C, int F, int D) {
  const int n0 = blockIdx.x * BN, c0 = blockIdx.y * BM, e = blockIdx.z;
  bf16* oute = out + (size_t)e * C * D;
  if (!tile_live(row_valid, e, c0, C)) {
    for (int i = threadIdx.x; i < BM * BN / 2; i += THREADS) {
      const int r = i / (BN / 2), cc = (i % (BN / 2)) * 2;
      if (c0 + r < C)
        *reinterpret_cast<__nv_bfloat162*>(oute + (size_t)(c0 + r) * D + n0 + cc) = __floats2bfloat162_rn(0.f, 0.f);
    }
    return;
  }
  __shared__ __align__(128) unsigned char smem[DN_SMEM];
  const bf16* he = h + (size_t)e * C * F;
  const bf16* wde = wd + (size_t)e * F * D;
  auto sA = [&](int s) { return reinterpret_cast<bf16*>(smem + s * DN_STAGE_BYTES); };
  auto sB = [&](int s) { return sA(s) + A_ELEMS; };
  auto load_stage = [&](int s, int kt) {
    load_a(sA(s), he, C, F, c0, kt * BK);
    load_b(sB(s), wde, D, kt * BK, n0);
  };
  const int KT = F / BK;
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  const int warp = threadIdx.x / 32, wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  FragC acc[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < KT) load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const int s = kt % STAGES;
    for (int kk = 0; kk < BK; kk += 16) {
      FragA fa[2];
      FragB fb[2];
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], sA(s) + (wm + 16 * i) * LDA + kk, LDA);
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], sB(s) + kk * LDB + wn + 16 * j, LDB);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float* sC = reinterpret_cast<float*>(smem);
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sC + (wm + 16 * i) * LDC + wn + 16 * j, acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  store_tile(oute, sC, C, D, c0, n0);
}

}  // namespace

// Row tile the occupancy skip works at; the Python wrapper reads it.
extern "C" int moe_gemm_row_tile() { return BM; }

// Both launches on `stream`.  x, h, out [E, C, *] and the weights are
// contiguous bf16; row_valid is [E, C] bytes (0 = dark slot); h is the
// caller's [E, C, F] bf16 scratch.  Returns the CUDA error code (0 = ok).
extern "C" int moe_gemm_grouped(const void* x, const void* wg, const void* wu, const void* wd,
                                const void* row_valid, void* h, void* out, int E, int C, int D,
                                int F, void* stream) {
  if (E <= 0 || C <= 0 || D % BK || D % BN || F % BK || F % BN) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ct = (C + BM - 1) / BM;
  gate_up_kernel<<<dim3(F / BN, ct, E), THREADS, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wg), static_cast<const bf16*>(wu),
      static_cast<const uint8_t*>(row_valid), static_cast<bf16*>(h), C, D, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  down_kernel<<<dim3(D / BN, ct, E), THREADS, 0, s>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(wd), static_cast<const uint8_t*>(row_valid),
      static_cast<bf16*>(out), C, F, D);
  return (int)cudaGetLastError();
}
