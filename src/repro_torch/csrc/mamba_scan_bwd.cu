// Mamba selective scan, backward (kernel K6b).
//
// No TPU kernel stands behind this one: the JAX model differentiates its
// lax.scan (src/repro/models/mamba.py, _scan_ssm, chunked and rematerialised
// over 64-step chunks), so this is a port-side kernel.  It is the exact
// reverse of K6's recurrence (csrc/mamba_scan.cu).  Per batch row b and
// channel i, with e_t,s = exp(dt_t,i a_i,s) and the adjoint g_t = dL/dh_t,
//   g_t   = e_t+1 g_t+1 + dy_t,i C_t           (g_S-1 from dh_final, or 0)
//   dx_t  = sum_s g_t,s dt_t B_t,s + d_skip_i dy_t,i
//   ddt_t = sum_s g_t,s (a_s e_t,s h_t-1,s + x_t B_t,s)
//   da_s += g_t,s dt_t e_t,s h_t-1,s           dd_skip += dy_t x_t
//   dB_t,s = sum_i g_t,s dt_t x_t              dC_t,s = sum_i dy_t h_t,s
//   dh0   = e_0 g_0
// with x [B, S, di] bf16 or f32 (widened first), dt and dy [B, S, di] f32,
// B/C [B, S, ds] f32, a [di, ds] f32 (= -exp(a_log)), d_skip [di] f32, and
// the forward's checkpoints hck [B, nck, ds, di] f32: the state before
// step k * CK (h0, or zeros, at k = 0), which K6 writes when autograd
// records it.
//
// What bounds it on an H100 (3.35 TB/s; 16 exponentials a clock an SM): at
// the training shape x [4, 1024, 16384] bf16 the function must read x
// (134 MB), dt and dy (268 MB each) and write dx and ddt (268 MB each),
// about 1.21 GB or 0.36 ms, and take B S di ds = 1.07 G exponentials,
// 0.26 ms.  This design also reads the checkpoints (537 MB at CK = 8) and
// writes and reads the dB/dC partials of its blocks (134 MB each way),
// about 2.0 GB or 0.60 ms, and takes one exponential a (b, t, i, s).
//
// Design (the Hopper redesign; the first design gave each channel one
// thread holding its 16 states, 64 channels a block at 46 KB of shared
// memory, so 8 warps an SM, recomputed each chunk's states into shared
// memory, took a second exponential in the walk and summed dB/dC with a
// 31-shuffle transposing butterfly a step).
// - A thread holds a 2 x 2 tile: states 2 sg, 2 sg + 1 of two neighbouring
//   channels (lane 4 sg + cg of warp w: channels 8 w + 2 cg and the next),
//   64 channels a block (256 threads), registers sized for two blocks an
//   SM (16 warps).  Both sums then start in registers: dB/dC over the
//   tile's two channels, dx/ddt over its two states.
// - A chunk is the checkpoint interval, CK = 8 steps.  The recompute keeps
//   e_t,s in registers and h_t,s in shared memory (one float4 a thread and
//   step, conflict-free), so the backward takes one exponential a
//   (b, t, i, s); the walk reads h_t for dC and h_t-1 for
//   e_t h_t-1 g = (e_t g) h_t-1.  A longer interval would need twice those
//   registers and shared memory (one block an SM) or a second exponential,
//   so the interval stays at 8.
// - dx and ddt: summed over the 8 lanes of a channel pair by two
//   transposing shuffle rounds and a plain one (lane ends with one of the
//   four sums, d_skip dy added on the lanes of sg 0); dB and dC: over the
//   warp's 4 channel pairs by two transposing rounds, then over the block's
//   8 warps in order once a chunk: 7 shuffles a step for 4 (b, t, i, s).
// - A chunk's buffers lie together, and each thread takes its views of them
//   once a chunk, so every shared-memory access of the walk is a constant
//   offset.
// - The next chunk's dt, dy, B, C and checkpoint are copied by cp.async
//   (and x through registers, widened) while the current one is walked;
//   dx and ddt leave through shared memory as whole rows.  Where di is a
//   multiple of 8 every row moves in 16-byte pieces (one cp.async and one
//   store a thread for each of dt/dy, the checkpoint and dx/ddt).  One block
//   barrier a chunk.
// - A second launch sums the block partials (dB, dC) and the per-row
//   partials (da, dd_skip) in a fixed order: no float atomics anywhere, so
//   two runs give the same bits.  (Summing the partials over a cluster of 8
//   blocks through distributed shared memory cut them 8x but cost more in
//   the blocks' lockstep than the 134 MB it saved: PERF.md.)
// Padded steps (past S), states (past ds) and channels (past di) are held
// as zeros: dt = 0 makes e = 1 and every product 0, so they change nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int MAX_DS = 16;            // states a channel
constexpr int CHN = 64;               // channels a block
constexpr int THREADS = 256;          // a 2 x 2 tile a thread
constexpr int WARPS = THREADS / 32;
constexpr int CK = 8;                 // steps between the forward's checkpoints: one chunk
constexpr int NV = 2 * MAX_DS;        // values a step hands to the channel sums: dB (s), dC (16 + s)
constexpr int XPT = CK * CHN / THREADS;  // x, dt, dy elements a thread stages a chunk (scalar path)
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;
static_assert(XPT * THREADS == CK * CHN && 2 * CK * MAX_DS == THREADS && WARPS * 32 == CK * NV, "tile shapes");
static_assert(2 * CK * CHN == 4 * THREADS && MAX_DS * CHN == 4 * THREADS, "one 16-byte piece a thread");

// One chunk's buffers; the block holds two, one walked while the other is filled.
struct Buf {
  float x[CK][CHN], dt[CK][CHN], dy[CK][CHN];
  float b[CK][MAX_DS], c[CK][MAX_DS];  // B and C rows
  float hck[MAX_DS][CHN];              // the chunk's checkpoint
  float red[WARPS][CK][NV];            // each warp's channel sums a step
  float out[2][CK][CHN];               // dx, ddt rows on their way out
};

struct Smem {
  Buf buf[2];
  float4 hs[CK][THREADS];  // h_t of the thread's tile after each step, from the recompute
};

#ifdef K6B_PHASES
// A timeline: thread 0 of each block adds up the cycles of each phase
// (clock64) and logs them with its total cycles and nanoseconds.
constexpr int PHASE_BLOCKS = 1024, PHASE_SLOTS = 8, NPHASE = 6;
__device__ unsigned long long k6b_phase_log[PHASE_BLOCKS * PHASE_SLOTS];
#define K6B_STAMP(k)                   \
  do {                                 \
    const long long now_ = clock64();  \
    phase[k] += now_ - last;           \
    last = now_;                       \
  } while (0)
#else
#define K6B_STAMP(k) \
  do {               \
  } while (0)
#endif

// 2^x on the special-function unit (ex2.approx.ftz: ~2 ulp)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }
template <typename TX>
__device__ __forceinline__ TX zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16(0.f); }

// 4 or 16 bytes from device memory into shared memory, asynchronously; zeros where !ok (src is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// x staged through registers: 8 bf16 (one 16-byte piece, VEC) or XPT elements a thread
template <typename TX, bool VEC>
struct PendingX {
  TX v[XPT];
};
template <>
struct PendingX<bf16, true> {
  uint4 v;
};
template <>
struct PendingX<float, true> {};  // f32 x goes by cp.async

// Issue the copies of chunk kc into bf: dt, dy, B, C and the checkpoint by cp.async, x by cp.async (f32 and
// VEC) or into registers.  VEC: di a multiple of 8, every row in 16-byte pieces.
template <typename TX, bool VEC>
__device__ __forceinline__ void stage(Buf& bf, PendingX<TX, VEC>& px, const TX* x, const float* dt,
                                      const float* dy, const float* Bm, const float* Cm, const float* hck, int b,
                                      int kc, int nck, int S, int DI, int DS, int i0, int width) {
  const int tid = threadIdx.x, t0 = kc * CK, n = min(CK, S - t0);
  const long long row0 = ((long long)b * S + t0) * DI + i0;  // element (t0, i0) of this row block
  if constexpr (VEC) {
    {  // dt and dy: 2 arrays x 8 rows x 16 pieces
      const int arr = tid >> 7, r = (tid >> 4) & 7, col = (tid & 15) * 4;
      const bool ok = r < n && col < width;
      const long long o = ok ? row0 + (long long)r * DI + col : 0;
      cp_async16(arr ? &bf.dy[r][col] : &bf.dt[r][col], (arr ? dy : dt) + o, ok);
    }
    {  // the checkpoint: 16 rows x 16 pieces
      const int s = tid >> 4, col = (tid & 15) * 4;
      const bool ok = s < DS && col < width;
      const long long o = ok ? (((long long)b * nck + kc) * DS + s) * DI + i0 + col : 0;
      cp_async16(&bf.hck[s][col], hck + o, ok);
    }
    if constexpr (sizeof(TX) == 4) {  // f32 x: 8 rows x 16 pieces
      if (tid < 128) {
        const int r = tid >> 4, col = (tid & 15) * 4;
        const bool ok = r < n && col < width;
        const long long o = ok ? row0 + (long long)r * DI + col : 0;
        cp_async16(&bf.x[r][col], reinterpret_cast<const float*>(x) + o, ok);
      }
    } else {  // bf16 x: 8 rows x 8 pieces of 8, through registers
      if (tid < 64) {
        const int r = tid >> 3, col = (tid & 7) * 8;
        const bool ok = r < n && col < width;
        px.v = ok ? *reinterpret_cast<const uint4*>(x + row0 + (long long)r * DI + col) : make_uint4(0, 0, 0, 0);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < XPT; ++k) {
      const int idx = tid + k * THREADS, r = idx / CHN, col = idx % CHN;
      const bool ok = r < n && col < width;
      const long long o = ok ? row0 + (long long)r * DI + col : 0;
      px.v[k] = ok ? x[o] : zero<TX>();
      cp_async4(&bf.dt[r][col], dt + o, ok);
      cp_async4(&bf.dy[r][col], dy + o, ok);
    }
#pragma unroll
    for (int k = 0; k < MAX_DS * CHN / THREADS; ++k) {
      const int idx = tid + k * THREADS, s = idx / CHN, col = idx % CHN;
      const bool ok = s < DS && col < width;
      const long long o = ok ? (((long long)b * nck + kc) * DS + s) * DI + i0 + col : 0;
      cp_async4(&bf.hck[s][col], hck + o, ok);
    }
  }
  {  // B and C rows: 2 x 8 x 16 elements (ds need not be a multiple of 4)
    const int which = tid / (CK * MAX_DS), r = (tid / MAX_DS) % CK, s = tid % MAX_DS;
    const bool ok = r < n && s < DS;
    const long long o = ok ? ((long long)b * S + t0 + r) * DS + s : 0;
    cp_async4(which ? &bf.c[r][s] : &bf.b[r][s], (which ? Cm : Bm) + o, ok);
  }
  cp_async_commit();
}

template <typename TX, bool VEC>
__device__ __forceinline__ void store_x(Buf& bf, const PendingX<TX, VEC>& px) {
  const int tid = threadIdx.x;
  if constexpr (VEC) {
    if constexpr (sizeof(TX) == 2) {
      if (tid < 64) {
        const bf16* v = reinterpret_cast<const bf16*>(&px.v);
        float4* dst = reinterpret_cast<float4*>(&bf.x[tid >> 3][(tid & 7) * 8]);
        dst[0] = make_float4(widen(v[0]), widen(v[1]), widen(v[2]), widen(v[3]));
        dst[1] = make_float4(widen(v[4]), widen(v[5]), widen(v[6]), widen(v[7]));
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < XPT; ++k) {
      const int idx = tid + k * THREADS;
      bf.x[idx / CHN][idx % CHN] = widen(px.v[k]);
    }
  }
}

template <typename TX, bool VEC>
__global__ void __launch_bounds__(THREADS, 2) mamba_scan_bwd_kernel(
    const TX* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ A, const float* __restrict__ Dskip,
    const float* __restrict__ hck, const float* __restrict__ dy, const float* __restrict__ dh_final,
    float* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ part_bc, float* __restrict__ part_a,
    float* __restrict__ part_d, float* __restrict__ dh0, int S, int DI, int DS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int B = gridDim.y, b = blockIdx.y, blk = blockIdx.x, tid = threadIdx.x;
  // lane 4 sg + cg of warp w: states 2 sg, 2 sg + 1 of the block's channels c0 = 8 w + 2 cg and c0 + 1
  const int lane = tid & 31, warp = tid >> 5, sg = lane >> 2, cg = lane & 3, c0 = warp * 8 + 2 * cg;
  const int i0 = blk * CHN, width = min(CHN, DI - i0);
  const int nck = (S + CK - 1) / CK;
#ifdef K6B_PHASES
  long long phase[NPHASE] = {0, 0, 0, 0, 0, 0}, last = clock64();
  const long long start = last;
  unsigned long long ns0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns0));
#endif
  float a2[2][2], g[2][2], da[2][2], dsk0[2], dd[2];  // [channel k][state m]; a2 = a log2 e: e = 2^(dt a2)
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int c = i0 + c0 + k;
    const bool live = c0 + k < width;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int s = 2 * sg + m;
      const bool on = live && s < DS;
      a2[k][m] = on ? A[(long long)c * DS + s] * LOG2E : 0.f;
      g[k][m] = on && dh_final != nullptr ? dh_final[((long long)b * DI + c) * DS + s] : 0.f;
      da[k][m] = 0.f;
    }
    dsk0[k] = live && sg == 0 ? Dskip[c] : 0.f;  // d_skip dy enters dx once, on the channel's lanes of sg 0
    dd[k] = 0.f;
  }
  const int slot = (cg >> 1) * MAX_DS + 2 * sg + (cg & 1);  // the dB/dC value the channel sum leaves here
  const int j2 = (sg >> 1) & 3;                              // dx (j2 < 2) or ddt of channel c0 + (j2 & 1)
  PendingX<TX, VEC> px;
  stage<TX, VEC>(sm.buf[0], px, x, dt, dy, Bm, Cm, hck, b, nck - 1, nck, S, DI, DS, i0, width);
  store_x<TX, VEC>(sm.buf[0], px);
  cp_async_wait_all();
  __syncthreads();
  K6B_STAMP(0);
  float4* const hsp = &sm.hs[0][tid];  // this thread's h_t, step r at hsp[r * THREADS]
  for (int it = 0; it < nck; ++it) {
    const int kc = nck - 1 - it, t0 = kc * CK, n = min(CK, S - t0);
    Buf& bf = sm.buf[it & 1];
    // this thread's views of the chunk's buffers: every access below is a constant offset from one of these
    const float2 *xs = reinterpret_cast<const float2*>(&bf.x[0][c0]), *dts = reinterpret_cast<const float2*>(&bf.dt[0][c0]);
    const float2 *dys = reinterpret_cast<const float2*>(&bf.dy[0][c0]);
    const float2 *bs = reinterpret_cast<const float2*>(&bf.b[0][2 * sg]), *cs = reinterpret_cast<const float2*>(&bf.c[0][2 * sg]);
    float *outs = &bf.out[j2 >> 1][0][c0 + (j2 & 1)], *reds = &bf.red[warp][0][slot];
    float h[2][2];
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int m = 0; m < 2; ++m) h[k][m] = bf.hck[2 * sg + m][c0 + k];
    const float4 hin = make_float4(h[0][0], h[0][1], h[1][0], h[1][1]);  // h before the chunk
    if (kc > 0) stage<TX, VEC>(sm.buf[(it & 1) ^ 1], px, x, dt, dy, Bm, Cm, hck, b, kc - 1, nck, S, DI, DS, i0, width);
    // the chunk's states from its checkpoint: e_t kept in registers, h_t in shared memory
    float e[CK][2][2];
#pragma unroll
    for (int r = 0; r < CK; ++r) {
      const float2 d2 = dts[r * (CHN / 2)], x2 = xs[r * (CHN / 2)], b2 = bs[r * (MAX_DS / 2)];
      const float d[2] = {d2.x, d2.y}, dbx[2] = {d2.x * x2.x, d2.y * x2.y}, bv[2] = {b2.x, b2.y};
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          e[r][k][m] = ex2(d[k] * a2[k][m]);
          h[k][m] = fmaf(dbx[k], bv[m], e[r][k][m] * h[k][m]);
        }
      hsp[r * THREADS] = make_float4(h[0][0], h[0][1], h[1][0], h[1][1]);
    }
    K6B_STAMP(1);
    // then the chunk backwards
    float4 hcur = hsp[(CK - 1) * THREADS];  // h_t of the step walked
#pragma unroll
    for (int r = CK - 1; r >= 0; --r) {
      const float4 hprev = r > 0 ? hsp[(r - 1) * THREADS] : hin;  // h_t-1
      const float2 x2 = xs[r * (CHN / 2)], d2 = dts[r * (CHN / 2)], y2 = dys[r * (CHN / 2)];
      const float2 b2 = bs[r * (MAX_DS / 2)], c2 = cs[r * (MAX_DS / 2)];
      const float xv[2] = {x2.x, x2.y}, d[2] = {d2.x, d2.y}, dyv[2] = {y2.x, y2.y};
      const float dbx[2] = {d2.x * x2.x, d2.y * x2.y}, bv[2] = {b2.x, b2.y}, cv[2] = {c2.x, c2.y};
      const float ht[2][2] = {{hcur.x, hcur.y}, {hcur.z, hcur.w}}, hp[2][2] = {{hprev.x, hprev.y}, {hprev.z, hprev.w}};
      float v[4] = {0.f, 0.f, 0.f, 0.f}, u[4];  // v: dB of states 0, 1 then dC, summed over the two channels
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float gb = 0.f, gae = 0.f;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          g[k][m] = fmaf(dyv[k], cv[m], g[k][m]);
          v[2 + m] = fmaf(dyv[k], ht[k][m], v[2 + m]);
          gb = fmaf(g[k][m], bv[m], gb);
          v[m] = fmaf(g[k][m], dbx[k], v[m]);
          g[k][m] *= e[r][k][m];
          const float ge = g[k][m] * hp[k][m];  // g e_t h_t-1
          gae = fmaf(ge, a2[k][m], gae);
          da[k][m] = fmaf(ge, d[k], da[k][m]);
        }
        u[k] = fmaf(d[k], gb, dsk0[k] * dyv[k]);  // this lane's share of dx
        u[2 + k] = fmaf(xv[k], gb, LN2 * gae);      // and of ddt
        dd[k] = fmaf(dyv[k], xv[k], dd[k]);
      }
      hcur = hprev;
      // dx, ddt: summed over the 8 state-pair lanes (bits 4, 3 transposing, bit 2 plain); lane ends with u[j2]
      {
        const bool up = lane & 16;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float send = up ? u[j] : u[j + 2], keep = up ? u[j + 2] : u[j];
          u[j] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
        }
        const bool up8 = lane & 8;
        const float w = (up8 ? u[1] : u[0]) + __shfl_xor_sync(0xffffffffu, up8 ? u[0] : u[1], 8);
        outs[r * CHN] = w + __shfl_xor_sync(0xffffffffu, w, 4);  // the lanes of sg 2 j, 2 j + 1 write alike
      }
      // dB, dC: summed over the 4 channel-pair lanes (bits 1, 0 transposing); lane ends with v[cg]
      {
        const bool up = lane & 2;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float send = up ? v[j] : v[j + 2], keep = up ? v[j + 2] : v[j];
          v[j] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
        }
        const bool up1 = lane & 1;
        reds[r * NV] = (up1 ? v[1] : v[0]) + __shfl_xor_sync(0xffffffffu, up1 ? v[0] : v[1], 1);
      }
    }
    K6B_STAMP(2);
    if (kc > 0) store_x<TX, VEC>(sm.buf[(it & 1) ^ 1], px);
    cp_async_wait_all();
    __syncthreads();  // this chunk's red and out complete; the next chunk's tiles in place
    K6B_STAMP(3);
    {
      const int r = tid / NV, j = tid % NV;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) sum += bf.red[w][r][j];
      if (r < n) part_bc[(((long long)blk * B + b) * S + t0 + r) * NV + j] = sum;
    }
    K6B_STAMP(4);
    const long long row0 = ((long long)b * S + t0) * DI + i0;
    if constexpr (VEC) {  // 2 arrays x 8 rows x 16 pieces
      const int which = tid >> 7, r = (tid >> 4) & 7, col = (tid & 15) * 4;
      if (r < n && col < width)
        *reinterpret_cast<float4*>((which ? ddt : dx) + row0 + (long long)r * DI + col) =
            *reinterpret_cast<const float4*>(&bf.out[which][r][col]);
    } else {
#pragma unroll
      for (int k = 0; k < 2 * XPT; ++k) {
        const int idx = tid + k * THREADS, which = idx / (CK * CHN), r = (idx / CHN) % CK, col = idx % CHN;
        if (r < n && col < width) (which ? ddt : dx)[row0 + (long long)r * DI + col] = bf.out[which][r][col];
      }
    }
    K6B_STAMP(5);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int c = i0 + c0 + k;
    if (c0 + k >= width) continue;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int s = 2 * sg + m;
      if (s < DS) {
        const long long o = ((long long)b * DI + c) * DS + s;
        part_a[o] = da[k][m];
        if (dh0 != nullptr) dh0[o] = g[k][m];
      }
    }
    if (sg == 0) part_d[(long long)b * DI + c] = dd[k];
  }
#ifdef K6B_PHASES
  const int lb = blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0 && lb < PHASE_BLOCKS) {
    unsigned long long ns1;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns1));
    for (int k = 0; k < NPHASE; ++k) k6b_phase_log[lb * PHASE_SLOTS + k] = phase[k];
    k6b_phase_log[lb * PHASE_SLOTS + 6] = clock64() - start;
    k6b_phase_log[lb * PHASE_SLOTS + 7] = ns1 - ns0;
  }
#endif
}

struct SumJobs {
  const float* part[3];
  float* out[3];
  int n_parts[3];
  long long n_out[3];
};

// out[j] = sum_p part[p][j], p in order: blockIdx.y picks the job.
__global__ void __launch_bounds__(256) sum_parts_kernel(SumJobs jobs) {
  const int job = blockIdx.y;
  const long long n = jobs.n_out[job];
  const float* part = jobs.part[job];
  for (long long j = blockIdx.x * 256LL + threadIdx.x; j < n; j += 256LL * gridDim.x) {
    float sum = 0.f;
    for (int p = 0; p < jobs.n_parts[job]; ++p) sum += part[p * n + j];
    jobs.out[job][j] = sum;
  }
}

template <typename TX, bool VEC>
int launch(const void* x, const void* dt, const void* Bm, const void* Cm, const void* A, const void* Dskip,
           const void* hck, const void* dy, const void* dh_final, void* dx, void* ddt, void* dbc, void* da, void* dd,
           void* dh0, void* part_bc, void* part_a, void* part_d, int B, int S, int DI, int DS, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem);
  cudaError_t err =
      cudaFuncSetAttribute(mamba_scan_bwd_kernel<TX, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nblk = (DI + CHN - 1) / CHN;
  mamba_scan_bwd_kernel<TX, VEC><<<dim3(nblk, B), THREADS, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(dt), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(A), static_cast<const float*>(Dskip),
      static_cast<const float*>(hck), static_cast<const float*>(dy), static_cast<const float*>(dh_final),
      static_cast<float*>(dx), static_cast<float*>(ddt), static_cast<float*>(part_bc), static_cast<float*>(part_a),
      static_cast<float*>(part_d), static_cast<float*>(dh0), S, DI, DS);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  SumJobs jobs = {{static_cast<const float*>(part_bc), static_cast<const float*>(part_a),
                   static_cast<const float*>(part_d)},
                  {static_cast<float*>(dbc), static_cast<float*>(da), static_cast<float*>(dd)},
                  {nblk, B, B},
                  {(long long)B * S * NV, (long long)DI * DS, (long long)DI}};
  long long most = jobs.n_out[0];
  for (int k = 1; k < 3; ++k) most = jobs.n_out[k] > most ? jobs.n_out[k] : most;
  const long long blocks = (most + 255) / 256;
  sum_parts_kernel<<<dim3((unsigned)(blocks < 65535 ? blocks : 65535), 3), 256, 0, stream>>>(jobs);
  return (int)cudaGetLastError();
}

template <typename TX>
int launch_for(bool vec, const void* x, const void* dt, const void* Bm, const void* Cm, const void* A,
               const void* Dskip, const void* hck, const void* dy, const void* dh_final, void* dx, void* ddt,
               void* dbc, void* da, void* dd, void* dh0, void* part_bc, void* part_a, void* part_d, int B, int S,
               int DI, int DS, cudaStream_t stream) {
  if (vec)
    return launch<TX, true>(x, dt, Bm, Cm, A, Dskip, hck, dy, dh_final, dx, ddt, dbc, da, dd, dh0, part_bc, part_a,
                            part_d, B, S, DI, DS, stream);
  return launch<TX, false>(x, dt, Bm, Cm, A, Dskip, hck, dy, dh_final, dx, ddt, dbc, da, dd, dh0, part_bc, part_a,
                           part_d, B, S, DI, DS, stream);
}

}  // namespace

// The checkpoint interval (steps) this build reads: the forward writes hck at it (ops.ckpt_steps reads this).
extern "C" int mamba_scan_bwd_ckpt_steps(void) { return CK; }

// Channels a block serves: the dB/dC partials are [ceil(DI / this), B, S, 32] f32.
extern "C" int mamba_scan_bwd_block_channels(void) { return CHN; }

// x [B, S, DI] (bf16 if x_bf16, else f32), dt and dy [B, S, DI], Bm/Cm [B, S, DS], A [DI, DS], Dskip [DI],
// hck [B, ceil(S / CK), DS, DI], dh_final (nullptr: zeros) [B, DI, DS], all f32 but x and contiguous.
// Writes dx and ddt [B, S, DI], dbc [B, S, 2, 16] (dB at [..., 0, :DS], dC at [..., 1, :DS]), da [DI, DS],
// dd [DI] and, when not nullptr, dh0 [B, DI, DS]; part_bc [ceil(DI / 64), B, S, 32], part_a [B, DI, DS] and
// part_d [B, DI] are scratch.  1 <= DS <= 16.  Returns the CUDA error code (0 = ok).
extern "C" int mamba_scan_bwd(const void* x, const void* dt, const void* Bm, const void* Cm, const void* A,
                              const void* Dskip, const void* hck, const void* dy, const void* dh_final, void* dx,
                              void* ddt, void* dbc, void* da, void* dd, void* dh0, void* part_bc, void* part_a,
                              void* part_d, int B, int S, int DI, int DS, int x_bf16, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || DI <= 0 || DS <= 0 || DS > MAX_DS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte pieces need every row to start on 16 bytes: di a multiple of 8 and 16-byte-aligned bases
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dt) |
                          reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(hck) |
                          reinterpret_cast<uintptr_t>(dx) | reinterpret_cast<uintptr_t>(ddt);
  const bool vec = DI % 8 == 0 && (bases & 15) == 0;
  if (x_bf16)
    return launch_for<bf16>(vec, x, dt, Bm, Cm, A, Dskip, hck, dy, dh_final, dx, ddt, dbc, da, dd, dh0, part_bc,
                            part_a, part_d, B, S, DI, DS, s);
  return launch_for<float>(vec, x, dt, Bm, Cm, A, Dskip, hck, dy, dh_final, dx, ddt, dbc, da, dd, dh0, part_bc,
                           part_a, part_d, B, S, DI, DS, s);
}

#ifdef K6B_PHASES
// Copy the last launch's timeline, [1024 blocks, 8] u64: the cycles of staging, recompute, walk, the chunk
// barrier, the block sums, the rows out; the block's total cycles and nanoseconds.
extern "C" int k6b_phases(void* out) {
  return (int)cudaMemcpyFromSymbol(out, k6b_phase_log, sizeof(k6b_phase_log));
}
#endif
