// Mamba selective scan (kernel K6).
//
// No TPU kernel stands behind this one: the JAX model runs the recurrence
// as a lax.scan (src/repro/models/mamba.py, _scan_ssm), so this is a
// port-side kernel.  Per batch row b and inner channel i, over t in order,
//   h_s = exp(dt_t,i a_i,s) h_s + (dt_t,i x_t,i) B_t,s      (s < ds)
//   y_t,i = sum_s h_s C_t,s + d_skip_i x_t,i
// with x [B, S, di] bf16 (the model's serving dtype) or f32 (its f32
// check), widened to f32 first, dt [B, S, di] f32, B/C [B, S, ds] f32,
// a [di, ds] f32 (= -exp(a_log)), d_skip [di] f32, an optional carried
// state h0 [B, di, ds] f32 (nullptr: zeros), y [B, S, di] f32 and the
// final state h [B, di, ds] f32.  h may be h0 itself: a decode step
// writes the cache's state in place.  Under autograd the launch also writes
// checkpoints hck [B, ceil(S / ck), ds, di] f32, the state before every
// ck-th step, which the backward (K6b, csrc/mamba_scan_bwd.cu) recomputes
// its chunks from; serving passes none, and that build of the kernel
// (CKPT false) has no store for them.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s f32, 16 exponentials a
// clock an SM on the special-function units): at Jamba's prefill (B 4,
// S 256, di 16384, ds 16) it reads x (33.6 MB in bf16), dt (67.1 MB), h0
// (4.2 MB) and writes y (67.1 MB) and h (4.2 MB), about 176 MB or 53 us;
// it takes B S di ds = 268 M exponentials, 64 us at 132 SMs x 16 a clock
// x 1.98 GHz; and 4 f32 FLOP per (t, i, s) (dt a, dt x B, the state's
// FMA, the output's FMA: 1.07 GFLOP, 16 us).  The exponentials bound it.
// A decode step (S = 1) is bound by its bytes: h0 read and h written.
//
// Design (the Hopper redesign; the first design gave each channel one
// thread holding all 16 states, 128 channels a block, and staged each
// 32-step chunk between two barriers).
// - Four threads a channel, four states each (lanes 4 c + q of a warp hold
//   states 4 q .. 4 q + 3 of channel c), y summed over the four by two
//   shuffles: four times the warps, and no 16-long chain of FMAs a step.
// - Each exponential is one ex2.approx of dt (a log2 e), with a log2 e
//   folded in once per (i, s): one special-function op and one multiply a
//   (t, i, s).
// - A block serves 64 channels of one batch row and walks the sequence in
//   chunks of CH = 16 steps staged in shared memory: x (widened) and dt as
//   [CH][64] tiles, B and C as [CH][16] rows read as one float4 a thread
//   and step.  The staging is double-buffered through registers: each
//   thread issues its share of the next chunk's loads before it walks the
//   current one and stores them into the other buffer after, so a chunk
//   costs one barrier and its loads overlap the walk.
// - y and the checkpoints leave through shared memory too (double-buffered
//   with the tiles): a chunk's rows are written while the next chunk is
//   walked, each row of the block's 64 channels by consecutive threads.
//   The checkpoint test is made once per 8 steps (an interval is a
//   multiple of 8), not once a step.
// - The registers are sized for four blocks an SM (32 warps).
// - A decode step (S = 1, no checkpoints) has a kernel of its own: a
//   thread per (b, i, four states), no shared memory and no barrier, a,
//   h0 and h as float4 loads and stores where ds = 16 (coalesced across
//   the channel's four threads), in place when h is h0.
// States past ds are held as zeros (a = B = C = 0), so they add nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int MAX_DS = 16;        // states a channel
constexpr int SPLIT = 4;          // threads a channel
constexpr int NS = MAX_DS / SPLIT;  // states a thread
constexpr int CHN = 64;           // channels a block
constexpr int THREADS = CHN * SPLIT;
constexpr int CH = 16;            // time steps staged a chunk
constexpr int MIN_BLOCKS = 4;     // blocks an SM the registers are sized for (32 warps)
constexpr int CK_UNIT = 8;        // a checkpoint interval is a multiple of this (K6b's is 8)
constexpr int SLOTS = CH / CK_UNIT;  // checkpoints a chunk can hold
constexpr int XPT = CH * CHN / THREADS;      // x (and dt) elements a thread stages a chunk
constexpr int BPT = (CH * MAX_DS + THREADS - 1) / THREADS;  // B (and C) elements a thread stages a chunk
constexpr float LOG2E = 1.4426950408889634f;
static_assert(CH % CK_UNIT == 0 && XPT * THREADS == CH * CHN, "chunk shape");

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }
template <typename TX>
__device__ __forceinline__ TX zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16(0.f); }

// 2^x on the special-function unit (ex2.approx.ftz: ~2 ulp)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One thread's share of a chunk's tiles, held in registers between its loads and its stores.
template <typename TX>
struct Pending {
  TX x[XPT];
  float dt[XPT], b[BPT], c[BPT];
};

template <typename TX>
__device__ __forceinline__ void load_chunk(Pending<TX>& p, const TX* x, const float* dt, const float* Bm,
                                           const float* Cm, int b, int t0, int n, int S, int DI, int DS, int i0,
                                           int width) {
#pragma unroll
  for (int k = 0; k < XPT; ++k) {
    const int idx = threadIdx.x + k * THREADS, r = idx / CHN, col = idx % CHN;
    const bool ok = r < n && col < width;
    const long long o = ((long long)b * S + t0 + r) * DI + i0 + col;
    p.x[k] = ok ? x[o] : zero<TX>();
    p.dt[k] = ok ? dt[o] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < BPT; ++k) {
    const int idx = threadIdx.x + k * THREADS, r = idx / MAX_DS, s = idx % MAX_DS;
    const bool ok = r < n && s < DS;
    const long long o = ((long long)b * S + t0 + r) * DS + s;
    p.b[k] = ok ? Bm[o] : 0.f;
    p.c[k] = ok ? Cm[o] : 0.f;
  }
}

struct Tiles {
  float x[CH][CHN], dt[CH][CHN];
  float b[CH][MAX_DS], c[CH][MAX_DS];
};

// A chunk's outputs on their way out as whole rows of the block's channels (a checkpoint row padded so
// that the four threads of a channel store to different banks).
struct Outs {
  float y[CH][CHN];
  float ck[SLOTS][MAX_DS][CHN + 2];
};

struct Smem {
  Tiles tiles[2];
  Outs outs[2];
};

template <typename TX>
__device__ __forceinline__ void store_chunk(const Pending<TX>& p, Tiles& s) {
#pragma unroll
  for (int k = 0; k < XPT; ++k) {
    const int idx = threadIdx.x + k * THREADS;
    s.x[idx / CHN][idx % CHN] = widen(p.x[k]);
    s.dt[idx / CHN][idx % CHN] = p.dt[k];
  }
#pragma unroll
  for (int k = 0; k < BPT; ++k) {
    const int idx = threadIdx.x + k * THREADS;
    if (idx < CH * MAX_DS) {
      s.b[idx / MAX_DS][idx % MAX_DS] = p.b[k];
      s.c[idx / MAX_DS][idx % MAX_DS] = p.c[k];
    }
  }
}

// y rows t0 .. t0 + n - 1 and the chunk's checkpoints from shared memory, each row of the block's
// channels written by consecutive threads.
template <bool CKPT>
__device__ __forceinline__ void flush(const Outs& o, float* y, float* hck, int b, int t0, int n, int S, int DI,
                                      int DS, int ck, int i0, int width) {
  for (int idx = threadIdx.x; idx < n * CHN; idx += THREADS) {
    const int r = idx / CHN, col = idx % CHN;
    if (col < width) y[((long long)b * S + t0 + r) * DI + i0 + col] = o.y[r][col];
  }
  if (CKPT) {
    const int nck = (S + ck - 1) / ck;
    for (int j = 0; j < SLOTS; ++j) {
      const int t = t0 + j * CK_UNIT;
      if (j * CK_UNIT >= n || t % ck) continue;
      float* out = hck + ((long long)b * nck + t / ck) * DS * DI + i0;
      for (int idx = threadIdx.x; idx < DS * CHN; idx += THREADS) {
        const int s = idx / CHN, col = idx % CHN;
        if (col < width) out[(long long)s * DI + col] = o.ck[j][s][col];
      }
    }
  }
}

template <typename TX, bool CKPT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) mamba_scan_kernel(
    const TX* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ A, const float* __restrict__ Dskip, const float* h0, float* __restrict__ y,
    float* h_out, float* __restrict__ hck, int S, int DI, int DS, int ck) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int b = blockIdx.y, i0 = blockIdx.x * CHN, ch = threadIdx.x / SPLIT, q = threadIdx.x % SPLIT;
  const int i = i0 + ch, width = min(CHN, DI - i0);
  const bool live = i < DI;
  float a2[NS], h[NS];
#pragma unroll
  for (int m = 0; m < NS; ++m) {
    const int s = q * NS + m;
    a2[m] = live && s < DS ? A[(long long)i * DS + s] * LOG2E : 0.f;
    h[m] = h0 != nullptr && live && s < DS ? h0[((long long)b * DI + i) * DS + s] : 0.f;
  }
  const float dsk = live ? Dskip[i] : 0.f;
  Pending<TX> p;
  load_chunk(p, x, dt, Bm, Cm, b, 0, min(CH, S), S, DI, DS, i0, width);
  store_chunk(p, sm.tiles[0]);
  __syncthreads();
  for (int t0 = 0, buf = 0; t0 < S; t0 += CH, buf ^= 1) {
    const int n = min(CH, S - t0);
    const bool more = t0 + CH < S;
    if (more) load_chunk(p, x, dt, Bm, Cm, b, t0 + CH, min(CH, S - t0 - CH), S, DI, DS, i0, width);
    if (t0)  // the last chunk's outputs, staged before the last barrier
      flush<CKPT>(sm.outs[buf ^ 1], y, hck, b, t0 - CH, CH, S, DI, DS, ck, i0, width);
    const Tiles& s = sm.tiles[buf];
    Outs& o = sm.outs[buf];
    for (int r0 = 0; r0 < n; r0 += CK_UNIT) {
      if (CKPT && (t0 + r0) % ck == 0) {  // the state before this step
#pragma unroll
        for (int m = 0; m < NS; ++m) o.ck[r0 / CK_UNIT][q * NS + m][ch] = h[m];
      }
#pragma unroll
      for (int rr = 0; rr < CK_UNIT; ++rr) {
        const int r = r0 + rr;
        if (r >= n) break;
        const float xv = s.x[r][ch], d = s.dt[r][ch], dx = d * xv;
        const float4 bv = reinterpret_cast<const float4*>(s.b[r])[q], cv = reinterpret_cast<const float4*>(s.c[r])[q];
        const float bs[NS] = {bv.x, bv.y, bv.z, bv.w}, cs[NS] = {cv.x, cv.y, cv.z, cv.w};
        float acc = 0.f;
#pragma unroll
        for (int m = 0; m < NS; ++m) {
          h[m] = fmaf(ex2(d * a2[m]), h[m], dx * bs[m]);
          acc = fmaf(h[m], cs[m], acc);
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        if (q == 0) o.y[r][ch] = fmaf(dsk, xv, acc);
      }
    }
    if (more) store_chunk(p, sm.tiles[buf ^ 1]);  // the other buffer: its last reader finished before the last barrier
    __syncthreads();
    if (!more) flush<CKPT>(o, y, hck, b, t0, n, S, DI, DS, ck, i0, width);
  }
  if (live) {
#pragma unroll
    for (int m = 0; m < NS; ++m)
      if (q * NS + m < DS) h_out[((long long)b * DI + i) * DS + q * NS + m] = h[m];
  }
}

// One step from the carried state: a thread per (b, i, four states).  VEC: ds = 16 and every row 16-byte
// aligned, so a, h0, h, B and C move as float4.
template <typename TX, bool VEC>
__global__ void __launch_bounds__(256) mamba_step_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                                                         const float* __restrict__ Bm, const float* __restrict__ Cm,
                                                         const float* __restrict__ A,
                                                         const float* __restrict__ Dskip, const float* h0,
                                                         float* __restrict__ y, float* h_out, int B, int DI, int DS) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int q = (int)(idx % SPLIT);
  const long long bi = idx / SPLIT;  // b * DI + i
  const bool live = bi < (long long)B * DI;
  const int i = live ? (int)(bi % DI) : 0, b = live ? (int)(bi / DI) : 0;
  float av[NS], hv[NS], bs[NS], cs[NS];
  if (VEC && live) {
    const float4 a4 = reinterpret_cast<const float4*>(A + (long long)i * MAX_DS)[q];
    const float4 h4 = h0 ? reinterpret_cast<const float4*>(h0 + bi * MAX_DS)[q] : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 b4 = reinterpret_cast<const float4*>(Bm + (long long)b * MAX_DS)[q];
    const float4 c4 = reinterpret_cast<const float4*>(Cm + (long long)b * MAX_DS)[q];
    av[0] = a4.x, av[1] = a4.y, av[2] = a4.z, av[3] = a4.w;
    hv[0] = h4.x, hv[1] = h4.y, hv[2] = h4.z, hv[3] = h4.w;
    bs[0] = b4.x, bs[1] = b4.y, bs[2] = b4.z, bs[3] = b4.w;
    cs[0] = c4.x, cs[1] = c4.y, cs[2] = c4.z, cs[3] = c4.w;
  } else {
#pragma unroll
    for (int m = 0; m < NS; ++m) {
      const int s = q * NS + m;
      const bool ok = live && s < DS;
      av[m] = ok ? A[(long long)i * DS + s] : 0.f;
      hv[m] = ok && h0 ? h0[bi * DS + s] : 0.f;
      bs[m] = ok ? Bm[(long long)b * DS + s] : 0.f;
      cs[m] = ok ? Cm[(long long)b * DS + s] : 0.f;
    }
  }
  const float xv = live ? widen(x[bi]) : 0.f, d = live ? dt[bi] : 0.f, dx = d * xv;
  float acc = 0.f;
#pragma unroll
  for (int m = 0; m < NS; ++m) {
    hv[m] = fmaf(ex2(d * (av[m] * LOG2E)), hv[m], dx * bs[m]);
    acc = fmaf(hv[m], cs[m], acc);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  if (!live) return;
  if (q == 0) y[bi] = fmaf(Dskip[i], xv, acc);
  if (VEC) {
    reinterpret_cast<float4*>(h_out + bi * MAX_DS)[q] = make_float4(hv[0], hv[1], hv[2], hv[3]);
  } else {
#pragma unroll
    for (int m = 0; m < NS; ++m)
      if (q * NS + m < DS) h_out[bi * DS + q * NS + m] = hv[m];
  }
}

template <typename TX, bool CKPT>
int launch(const void* x, const void* dt, const void* Bm, const void* Cm, const void* A, const void* Dskip,
           const void* h0, void* y, void* h_out, void* hck, int B, int S, int DI, int DS, int ck, cudaStream_t stream) {
  if (!CKPT && S == 1) {
    const long long threads = (long long)B * DI * SPLIT;
    const int blocks = (int)((threads + 255) / 256);
    const bool vec = DS == MAX_DS && ((uintptr_t)A | (uintptr_t)h0 | (uintptr_t)h_out | (uintptr_t)Bm | (uintptr_t)Cm) % 16 == 0;
    if (vec)
      mamba_step_kernel<TX, true><<<blocks, 256, 0, stream>>>(
          static_cast<const TX*>(x), static_cast<const float*>(dt), static_cast<const float*>(Bm),
          static_cast<const float*>(Cm), static_cast<const float*>(A), static_cast<const float*>(Dskip),
          static_cast<const float*>(h0), static_cast<float*>(y), static_cast<float*>(h_out), B, DI, DS);
    else
      mamba_step_kernel<TX, false><<<blocks, 256, 0, stream>>>(
          static_cast<const TX*>(x), static_cast<const float*>(dt), static_cast<const float*>(Bm),
          static_cast<const float*>(Cm), static_cast<const float*>(A), static_cast<const float*>(Dskip),
          static_cast<const float*>(h0), static_cast<float*>(y), static_cast<float*>(h_out), B, DI, DS);
    return (int)cudaGetLastError();
  }
  static bool smem_set = false;  // above 48 KB: raise the kernel's limit once per process
  if (!smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(mamba_scan_kernel<TX, CKPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Smem));
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const dim3 grid((DI + CHN - 1) / CHN, B);
  mamba_scan_kernel<TX, CKPT><<<grid, THREADS, sizeof(Smem), stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(dt), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(A), static_cast<const float*>(Dskip),
      static_cast<const float*>(h0), static_cast<float*>(y), static_cast<float*>(h_out), static_cast<float*>(hck), S,
      DI, DS, ck);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, S, DI] (bf16 if x_bf16, else f32), dt [B, S, DI], Bm/Cm [B, S, DS],
// A [DI, DS], Dskip [DI], h0 (nullptr: zeros) and h_out [B, DI, DS] f32, y
// [B, S, DI] f32, all contiguous; h_out may equal h0.  hck (nullptr: none)
// [B, ceil(S / ck), DS, DI] f32 receives the checkpoints, ck a multiple of
// 8.  1 <= DS <= 16.
// S = 1 without checkpoints takes the one-step kernel.  Returns the CUDA
// error code (0 = ok).
extern "C" int mamba_scan_fwd(const void* x, const void* dt, const void* Bm, const void* Cm, const void* A,
                              const void* Dskip, const void* h0, void* y, void* h_out, void* hck, int B, int S, int DI,
                              int DS, int ck, int x_bf16, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || DI <= 0 || DS <= 0 || DS > MAX_DS || (hck != nullptr && ck <= 0) ||
      (hck != nullptr && ck % CK_UNIT))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hck != nullptr) {
    if (x_bf16) return launch<bf16, true>(x, dt, Bm, Cm, A, Dskip, h0, y, h_out, hck, B, S, DI, DS, ck, s);
    return launch<float, true>(x, dt, Bm, Cm, A, Dskip, h0, y, h_out, hck, B, S, DI, DS, ck, s);
  }
  if (x_bf16) return launch<bf16, false>(x, dt, Bm, Cm, A, Dskip, h0, y, h_out, nullptr, B, S, DI, DS, 1, s);
  return launch<float, false>(x, dt, Bm, Cm, A, Dskip, h0, y, h_out, nullptr, B, S, DI, DS, 1, s);
}
