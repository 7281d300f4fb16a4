// RWKV6 WKV recurrence (kernel K5).
//
// Replaces the TPU kernel src/repro/kernels/rwkv_wkv/kernel.py,
// wkv6_pallas (body _kernel): per (b, h), over t in order,
//   y_t = r_t^T (S + diag(u) k_t v_t^T)      (S before this step's update)
//   S   = diag(w_t) S + k_t v_t^T
// with r/k/v [B, H, T, D] bf16 (the model's serving dtype) or f32 (its
// f32 check on the card), widened to f32 before any product,
// w [B, H, T, D] f32, u [H, D] f32, y [B, H, T, D] f32 and the
// final state S [B, H, D, D] f32.  The TPU kernel starts from S = 0; an
// optional s0 [B, H, D, D] starts from a carried state instead (decode),
// as the scan form wkv6_ref does.
//
// What bounds it on an H100: each input is read once and each output
// written once, and the recurrence takes at least 5 D^2 FLOP per (b, h, t)
// in f32 outside the tensor cores once the u term is hoisted (below):
// w * s + k * v for the state and r * s for y.  At the prefill shape
// (B 4, H 64, T 1024, D 64) that is 5.37 GFLOP (0.080 ms at 67 TFLOP/s)
// against 239 MB (0.071 ms at 3.35 TB/s): operations bound it.  As FP32
// instructions (a MUL and two FMAs per (i, j)) it needs 0.096 ms at the
// 1.98 GHz boost clock, and every other instruction takes an issue slot
// from them.
//
// Design.  The TPU kernel keeps S in VMEM across sequential time blocks;
// here one block per (b, h) walks all of T itself with S in registers, so
// S touches device memory only for s0 and the final state.
// - What a step's FMAs need arrives through shared memory, and that
//   delivers 128 bytes a clock to an SM's lanes, broadcast or not (an
//   LDS.128 takes four wavefronts even when every lane reads one address).
//   Each (i, j) takes 3 FP32 instructions and r_i, k_i, w_i (12 bytes), so
//   a lane reuses each row value over COLS = 4 columns: a thread holds a
//   16-row x 4-column block of S, each column's 64 rows split over SPLIT =
//   4 adjacent lanes (64 threads per (b, h), two blocks per SM at the
//   prefill shape).  A lane's rows are the float4 chunks q, q + 4, q + 8,
//   q + 12 of a row vector, so the 4 lanes of a column group read distinct
//   banks.  y is reduce-scattered over them: 3 shuffles for 4 columns,
//   after which lane q holds column q and writes it.  Other layouts were
//   measured (PERF.md): one column a thread is twice as slow (shared
//   memory), 8 rows x 4 columns over 8 lanes (two warps per scheduler) 4%
//   faster at prefill but half again slower at decode, 8 x 8 slower at
//   both.
// - The u term is hoisted: y_t = r_t^T S + c_t v_t with the scalar c_t =
//   sum_i r_i u_i k_i, one number per step, so a step costs 3 instructions
//   per (i, j) instead of 4.  The sums run in another order than
//   wkv6_plain.
// - The steps run in passes of BT = 32.  Each pass's raw r/k/v/w rows are
//   copied with 16-byte cp.async into a double buffer two passes ahead, and
//   widened into a double buffer of f32 r, k, v, w with c_t (a warp-wide
//   sum per step) one pass ahead: each warp widens its share of pass p + 1
//   a step at a time between groups of four steps of pass p, so the
//   widening's shuffle chains overlap the FMAs instead of stalling a pass
//   (a dedicated producer warp was slower: its shared-memory traffic queues
//   behind the consumers').  One barrier a pass.  The steps are
//   software-pipelined: step tt + 1's operands load and step tt - 1's
//   partial sums are reduce-scattered while step tt's FMAs issue, and y
//   leaves from the registers: a warp's stores of one step cover 128
//   contiguous bytes (8 column groups x 4 lanes), so staging it through
//   shared memory would only add shared-memory traffic.
// - A single step (T = 1, decode) skips all of that: the state comes from
//   device memory, so the staging's copy, widening and barriers would sit
//   on the path of a 16 KB load.  Each lane loads its own rows of r, k, w,
//   u and its columns' v straight into registers and folds its rows' share
//   of c_t into its partial sums.
// Any T is taken, the last pass running the remainder.  The inputs are
// read through their element strides (b, h, t; the last dim contiguous,
// every row 16-byte aligned), so the model's [B, T, H, D] activations need
// no copy; y is written in the [B, T, H, D] layout the model reads back.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int D = 64;                 // head size
constexpr int BT = 32;                // time steps staged per pass
constexpr int SPLIT = 4;              // lanes per state column
constexpr int ROWS = D / SPLIT;       // rows of S per lane and column: 16
constexpr int COLS = 4;               // state columns per thread
constexpr int THREADS = SPLIT * D / COLS;  // 64
constexpr int WARPS = THREADS / 32;

#ifdef K5_PHASES
// A timeline: thread 0 adds up the cycles it spends waiting at each pass's
// barrier (for the pass's rows and the other warps), in the steps with the
// next pass's widening folded in, and in the steps of the last pass alone;
// each block logs them with its total cycles and nanoseconds (clock64,
// globaltimer).
constexpr int PHASE_BLOCKS = 1024, PHASE_SLOTS = 8;
__device__ unsigned long long k5_phase_log[PHASE_BLOCKS * PHASE_SLOTS];
#define K5_STAMP(i)                                   \
  if (threadIdx.x == 0) {                             \
    const long long now = clock64();                  \
    phase[i] += now - last;                           \
    last = now;                                       \
  }
#else
#define K5_STAMP(i)
#endif

// Dynamic shared memory: a double buffer of raw rows (r, k, v in T, then w)
// and a double buffer of widened rows (f32 r, k, v, w, then c per step).
template <typename T>
struct Smem {
  static constexpr int RAW_T = BT * D * sizeof(T);
  static constexpr int RAW = 3 * RAW_T + BT * D * 4;
  static constexpr int WIDE = 4 * BT * D * 4 + BT * 4;
  static constexpr int BYTES = 2 * RAW + 2 * WIDE;
};

// COLS consecutive f32 in one load or store.
struct alignas(4 * COLS) Cols {
  float x[COLS];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ float2 widen2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 widen2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float widen1(float x) { return x; }
__device__ __forceinline__ float widen1(bf16 x) { return __bfloat162float(x); }
// Four consecutive elements from device memory (8- or 16-byte aligned), widened.
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Widen step tt of a raw buffer half into a wide one (a warp, two elements
// a lane) and store c_t = sum_i r_i u_i k_i.
template <typename T>
__device__ __forceinline__ void widen_step(const unsigned char* raw, float* wide, int tt, int lane, float u0,
                                           float u1) {
  const int e = tt * D + 2 * lane;
  const T* rows = reinterpret_cast<const T*>(raw) + e;
  const float2 rr = widen2(rows), kk = widen2(rows + BT * D), vv = widen2(rows + 2 * BT * D);
  const float2 ww = *reinterpret_cast<const float2*>(reinterpret_cast<const float*>(raw + 3 * Smem<T>::RAW_T) + e);
  *reinterpret_cast<float2*>(wide + e) = rr;
  *reinterpret_cast<float2*>(wide + BT * D + e) = kk;
  *reinterpret_cast<float2*>(wide + 2 * BT * D + e) = vv;
  *reinterpret_cast<float2*>(wide + 3 * BT * D + e) = ww;
  float c = fmaf(rr.x * u0, kk.x, rr.y * u1 * kk.y);
#pragma unroll
  for (int o = 16; o; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
  if (lane == 0) wide[4 * BT * D + tt] = c;
}

// Row of S in slot m (of ROWS) of the lane at position q of its column
// group: the lane holds the float4 chunks q, q + SPLIT, ... of a row vector.
__device__ __forceinline__ int row_of(int q, int m) { return 4 * (q + SPLIT * (m / 4)) + m % 4; }

// The 4 lanes of a column group each hold 4 partial sums, one per column;
// afterwards lane q holds the group's whole sum for column q.  Two halving
// exchanges, 3 shuffles: a lane keeps the pair of columns bit 1 of q
// selects and sends the other pair to lane q ^ 2, then keeps the column
// bit 0 selects and sends the other to lane q ^ 1.
__device__ __forceinline__ float reduce_scatter(const float (&p)[COLS], int q) {
  const bool hi2 = q & 2, hi1 = q & 1;
  float a[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    a[i] = (hi2 ? p[i + 2] : p[i]) + __shfl_xor_sync(0xffffffffu, hi2 ? p[i] : p[i + 2], 2);
  return (hi1 ? a[1] : a[0]) + __shfl_xor_sync(0xffffffffu, hi1 ? a[0] : a[1], 1);
}

// One step's operands for a lane, from a widened buffer half: its ROWS rows
// of r, k, w, its columns' v and the step's c.
struct Step {
  float4 r[ROWS / 4], k[ROWS / 4], w[ROWS / 4];
  Cols v;
  float c;
};

__device__ __forceinline__ Step load_step(const float* wide, int tt, int q, int j0) {
  Step st;
#pragma unroll
  for (int m4 = 0; m4 < ROWS / 4; ++m4) {
    st.r[m4] = reinterpret_cast<const float4*>(wide + tt * D)[q + SPLIT * m4];
    st.k[m4] = reinterpret_cast<const float4*>(wide + (BT + tt) * D)[q + SPLIT * m4];
    st.w[m4] = reinterpret_cast<const float4*>(wide + (3 * BT + tt) * D)[q + SPLIT * m4];
  }
  st.v = *reinterpret_cast<const Cols*>(wide + (2 * BT + tt) * D + j0);
  st.c = wide[4 * BT * D + tt];
  return st;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) wkv6_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, const float* __restrict__ s0,
    float* __restrict__ y, float* __restrict__ s_final, int H, int Tn, long long sb, long long sh,
    long long st) {
  using S = Smem<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // rows row_of(q, .), columns j0 .. j0 + COLS - 1; y's column j0 + q
  const int q = tid % SPLIT, j0 = tid / SPLIT * COLS;
  const long long in0 = (long long)b * sb + (long long)h * sh;
  const size_t state0 = ((size_t)b * H + h) * D * D;
  const int passes = (Tn + BT - 1) / BT;
  auto raw_half = [&](int p) { return smem + (p & 1) * S::RAW; };
  auto wide_half = [&](int p) { return reinterpret_cast<float*>(smem + 2 * S::RAW + (p & 1) * S::WIDE); };

  // 16-byte cp.async copies of pass p's raw rows into its raw half
  auto stage = [&](int p) {
    constexpr int CT = D * sizeof(T) / 16;  // chunks of an r/k/v row (w: 16)
    const int t0 = p * BT, nt = min(BT, Tn - t0);
    unsigned char* raw = raw_half(p);
    for (int i = tid; i < nt * CT; i += THREADS) {
      const int tt = i / CT, cc = i % CT;
      const long long off = in0 + (long long)(t0 + tt) * st + cc * (16 / (int)sizeof(T));
      unsigned char* dst = raw + tt * D * (int)sizeof(T) + cc * 16;
      cp_async16(dst, r + off);
      cp_async16(dst + S::RAW_T, k + off);
      cp_async16(dst + 2 * S::RAW_T, v + off);
    }
    for (int i = tid; i < nt * (D / 4); i += THREADS) {
      const int tt = i / (D / 4), cc = i % (D / 4);
      cp_async16(raw + 3 * S::RAW_T + tt * D * 4 + cc * 16, w + in0 + (long long)(t0 + tt) * st + cc * 4);
    }
    cp_async_commit();
  };

  float s[COLS][ROWS];  // in flight while the first rows load
#pragma unroll
  for (int m = 0; m < ROWS; ++m) {
    Cols row = {};
    if (s0) row = *reinterpret_cast<const Cols*>(s0 + state0 + (size_t)row_of(q, m) * D + j0);
#pragma unroll
    for (int c = 0; c < COLS; ++c) s[c][m] = row.x[c];
  }
  if (Tn == 1) {
    // Decode: one step straight from device memory.  Each lane loads its own
    // rows of r, k, w and u and its columns' v, and folds its rows' share of
    // c_t into its partial sums (c_lane v_j), so the reduce-scatter yields y
    // with no staging, no barrier and no separate sum for c_t.
    float vj[COLS], ya[COLS], yb[COLS], cl = 0.f;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      vj[c] = widen1(v[in0 + j0 + c]);
      ya[c] = yb[c] = 0.f;
    }
#pragma unroll
    for (int m4 = 0; m4 < ROWS / 4; ++m4) {
      const int i0 = 4 * (q + SPLIT * m4);
      const float4 rv = load4(r + in0 + i0), kv = load4(k + in0 + i0);
      const float4 wv = *reinterpret_cast<const float4*>(w + in0 + i0);
      const float4 uv = *reinterpret_cast<const float4*>(u + h * D + i0);
      const float rs[4] = {rv.x, rv.y, rv.z, rv.w}, ks[4] = {kv.x, kv.y, kv.z, kv.w};
      const float ws[4] = {wv.x, wv.y, wv.z, wv.w}, us[4] = {uv.x, uv.y, uv.z, uv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) cl = fmaf(rs[e] * us[e], ks[e], cl);
#pragma unroll
      for (int c = 0; c < COLS; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& sij = s[c][4 * m4 + e];
          if (e % 2) yb[c] = fmaf(rs[e], sij, yb[c]);
          else ya[c] = fmaf(rs[e], sij, ya[c]);
          sij = fmaf(ws[e], sij, ks[e] * vj[c]);
        }
    }
    float part[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) part[c] = fmaf(cl, vj[c], ya[c] + yb[c]);
    y[((size_t)b * H + h) * D + j0 + q] = reduce_scatter(part, q);  // y[b, 0, h, j0 + q]
  } else {
    stage(0);
    if (passes > 1) stage(1);
    const float u0 = u[h * D + 2 * lane], u1 = u[h * D + 2 * lane + 1];  // a lane widens elements 2 lane, + 1
    if (passes > 1) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();
    // pass 0's rows, four a warp at a time (the group's rows past T: stale, unread)
    for (int t4 = 0; t4 < BT / WARPS && warp + WARPS * t4 < Tn; t4 += 4)
#pragma unroll
      for (int g = 0; g < 4 && t4 + g < BT / WARPS; ++g)
        widen_step<T>(raw_half(0), wide_half(0), warp + WARPS * (t4 + g), lane, u0, u1);
#ifdef K5_PHASES
    long long phase[3] = {0, 0, 0}, last = clock64();
    const long long start = last;
    unsigned long long ns0;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns0));
#endif

    // The steps, software-pipelined: step tt + 1's operands load and step
    // tt - 1's partial sums are reduce-scattered while step tt's FMAs issue.
    Step cur, nxt;
    float pend[COLS], pend_v = 0.f, pend_c = 0.f;  // step tt - 1: partials, this lane's v_j and c
    float* yp = nullptr;                             // where step tt - 1's y goes, for column j0 + q
    auto step = [&](const float* wide, int tt, int nt, float* yrow) {
      nxt = load_step(wide, min(tt + 1, nt - 1), q, j0);
      const float y_prev = reduce_scatter(pend, q);
      if (yp) *yp = fmaf(pend_c, pend_v, y_prev);
      float ya[COLS], yb[COLS];
#pragma unroll
      for (int c = 0; c < COLS; ++c) ya[c] = yb[c] = 0.f;
#pragma unroll
      for (int m4 = 0; m4 < ROWS / 4; ++m4) {
        const float rs[4] = {cur.r[m4].x, cur.r[m4].y, cur.r[m4].z, cur.r[m4].w};
        const float ks[4] = {cur.k[m4].x, cur.k[m4].y, cur.k[m4].z, cur.k[m4].w};
        const float ws[4] = {cur.w[m4].x, cur.w[m4].y, cur.w[m4].z, cur.w[m4].w};
#pragma unroll
        for (int c = 0; c < COLS; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& sij = s[c][4 * m4 + e];
            if (e % 2) yb[c] = fmaf(rs[e], sij, yb[c]);
            else ya[c] = fmaf(rs[e], sij, ya[c]);
            sij = fmaf(ws[e], sij, ks[e] * cur.v.x[c]);
          }
      }
      pend_v = cur.v.x[0];
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        pend[c] = ya[c] + yb[c];
        if (c && q == c) pend_v = cur.v.x[c];
      }
      pend_c = cur.c;
      yp = yrow + (size_t)tt * H * D;
      cur = nxt;
    };
#pragma unroll
    for (int c = 0; c < COLS; ++c) pend[c] = 0.f;

    for (int p = 0; p < passes; ++p) {
      const int t0 = p * BT, nt = min(BT, Tn - t0);
      cp_async_wait<0>();  // pass p + 1's rows
      __syncthreads();     // pass p widened; pass p + 1's rows visible; the other halves free
      K5_STAMP(0);
      if (p + 2 < passes) stage(p + 2);  // into the raw half widened during the last pass
      const float* wide = wide_half(p);
      float* yrow = y + (((size_t)b * Tn + t0) * H + h) * D + j0 + q;  // y[b, t0 + tt, h, j0 + q] at [tt H D]
      cur = load_step(wide, 0, q, j0);
      if (p + 1 < passes) {
        // nt == BT: 8 groups of 4 steps, each with this warp's share of
        // widening pass p + 1 folded in, so its shuffle chain overlaps FMAs
        constexpr int PER = (BT / WARPS + 7) / 8;  // steps each warp widens per group
        for (int g4 = 0; g4 < BT / 4; ++g4) {
#pragma unroll
          for (int i = 0; i < PER; ++i)
            if (g4 * PER + i < BT / WARPS)
              widen_step<T>(raw_half(p + 1), wide_half(p + 1), warp + WARPS * (g4 * PER + i), lane, u0, u1);
#pragma unroll
          for (int g = 0; g < 4; ++g) step(wide, 4 * g4 + g, BT, yrow);
        }
        K5_STAMP(1);
      } else {
#pragma unroll 2
        for (int tt = 0; tt < nt; ++tt) step(wide, tt, nt, yrow);
        K5_STAMP(2);
      }
    }
    *yp = fmaf(pend_c, pend_v, reduce_scatter(pend, q));
#ifdef K5_PHASES
    const int blk = blockIdx.y * gridDim.x + blockIdx.x;
    if (threadIdx.x == 0 && blk < PHASE_BLOCKS) {
      unsigned long long ns1;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns1));
      for (int i = 0; i < 3; ++i) k5_phase_log[blk * PHASE_SLOTS + i] = phase[i];
      k5_phase_log[blk * PHASE_SLOTS + 3] = clock64() - start;
      k5_phase_log[blk * PHASE_SLOTS + 4] = ns1 - ns0;
    }
#endif
  }

#pragma unroll
  for (int m = 0; m < ROWS; ++m) {
    Cols row;
#pragma unroll
    for (int c = 0; c < COLS; ++c) row.x[c] = s[c][m];
    *reinterpret_cast<Cols*>(s_final + state0 + (size_t)row_of(q, m) * D + j0) = row;
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u, const void* s0,
           void* y, void* s_final, int B, int H, int Tn, long long sb, long long sh, long long st,
           cudaStream_t stream) {
  static bool smem_set = false;  // above 48 KB: raise the kernel's limit once per process
  if (!smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(wkv6_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<T>::BYTES);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  wkv6_kernel<T><<<dim3(H, B), THREADS, Smem<T>::BYTES, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(s_final), H, Tn, sb, sh, st);
  return (int)cudaGetLastError();
}

}  // namespace

#ifdef K5_PHASES
// Copy the last launch's timeline, [1024 blocks, 8] u64 (see k5_phase_log).
extern "C" int k5_phases(void* out) {
  return (int)cudaMemcpyFromSymbol(out, k5_phase_log, sizeof(k5_phase_log));
}
#endif

// r/k/v (bf16 if in_bf16, else f32) and w (f32) share the element
// strides sb, sh, st of a [B, H, T, 64] view whose last dim is contiguous;
// the four base pointers are 16-byte aligned and the strides multiples of
// 8, so every row starts on 16 bytes.  u [H, 64], s0 (nullptr: start from
// zero) and s_final [B, H, 64, 64] f32 contiguous, u and s0 16-byte aligned; y
// f32 contiguous in the [B, T, H, 64] layout.  Returns the CUDA error code
// (0 = ok).
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v, const void* w, const void* u,
                        const void* s0, void* y, void* s_final, int B, int H, int Tn, int head_dim,
                        long long sb, long long sh, long long st, int in_bf16, void* stream) {
  if (B <= 0 || H <= 0 || Tn <= 0 || head_dim != D || B > 65535) return (int)cudaErrorInvalidValue;
  if ((sb | sh | st) % 8 ||
      ((uintptr_t)r | (uintptr_t)k | (uintptr_t)v | (uintptr_t)w | (uintptr_t)u | (uintptr_t)s0) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) return launch<bf16>(r, k, v, w, u, s0, y, s_final, B, H, Tn, sb, sh, st, s);
  return launch<float>(r, k, v, w, u, s0, y, s_final, B, H, Tn, sb, sh, st, s);
}
