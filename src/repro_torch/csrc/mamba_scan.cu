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
//
// Design (simple first): one thread per (b, i) holds the ds <= 16 states
// and its row of a in registers and walks t.  A block serves 128 channels
// of one batch row and stages the sequence in chunks of CH steps in shared
// memory: x (widened) and dt as [CH][128] tiles, copied with coalesced loads
// (the channel is the fastest index), and the chunk's B and C rows, which
// every channel of the block reads (a broadcast).  y is stored from the
// registers, 128 consecutive floats a step for the block.  States past ds
// are held as zeros (a = B = C = 0), so they add nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int MAX_DS = 16;   // states a channel
constexpr int THREADS = 128; // channels a block
constexpr int CH = 32;       // time steps staged a chunk

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }

template <typename TX, bool CKPT>
__global__ void __launch_bounds__(THREADS) mamba_scan_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                                                             const float* __restrict__ Bm, const float* __restrict__ Cm,
                                                             const float* __restrict__ A, const float* __restrict__ Dskip,
                                                             const float* h0, float* __restrict__ y, float* h_out,
                                                             float* __restrict__ hck, int S, int DI, int DS, int ck) {
  __shared__ float sx[CH][THREADS], sdt[CH][THREADS];
  __shared__ float sb[CH][MAX_DS], sc[CH][MAX_DS];
  const int b = blockIdx.y, i0 = blockIdx.x * THREADS, i = i0 + threadIdx.x;
  const bool live = i < DI;
  float a[MAX_DS], h[MAX_DS];
#pragma unroll
  for (int s = 0; s < MAX_DS; ++s) {
    a[s] = live && s < DS ? A[(long long)i * DS + s] : 0.f;
    h[s] = h0 != nullptr && live && s < DS ? h0[((long long)b * DI + i) * DS + s] : 0.f;
  }
  const float dsk = live ? Dskip[i] : 0.f;
  const int width = min(THREADS, DI - i0);  // live channels of this block
  for (int t0 = 0; t0 < S; t0 += CH) {
    const int n = min(CH, S - t0);
    __syncthreads();  // the previous chunk's reads are done
    for (int k = threadIdx.x; k < n * THREADS; k += THREADS) {
      const int r = k / THREADS, col = k % THREADS;
      const long long o = ((long long)b * S + t0 + r) * DI + i0 + col;
      sx[r][col] = col < width ? widen(x[o]) : 0.f;
      sdt[r][col] = col < width ? dt[o] : 0.f;
    }
    for (int k = threadIdx.x; k < n * MAX_DS; k += THREADS) {
      const int r = k / MAX_DS, s = k % MAX_DS;
      const long long o = ((long long)b * S + t0 + r) * DS + s;
      sb[r][s] = s < DS ? Bm[o] : 0.f;
      sc[r][s] = s < DS ? Cm[o] : 0.f;
    }
    __syncthreads();
    if (live) {
      for (int r = 0; r < n; ++r) {
        if (CKPT && (t0 + r) % ck == 0) {  // [s][channel]: each store coalesced over the block's channels
          float* out = hck + ((long long)b * ((S + ck - 1) / ck) + (t0 + r) / ck) * DS * DI + i;
#pragma unroll
          for (int s = 0; s < MAX_DS; ++s)
            if (s < DS) out[(long long)s * DI] = h[s];
        }
        const float xv = sx[r][threadIdx.x], d = sdt[r][threadIdx.x], dx = d * xv;
        float acc = 0.f;
#pragma unroll
        for (int s = 0; s < MAX_DS; ++s) {
          h[s] = expf(d * a[s]) * h[s] + dx * sb[r][s];
          acc += h[s] * sc[r][s];
        }
        y[((long long)b * S + t0 + r) * DI + i] = acc + dsk * xv;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < MAX_DS; ++s)
      if (s < DS) h_out[((long long)b * DI + i) * DS + s] = h[s];
  }
}

template <typename TX, bool CKPT>
int launch(const void* x, const void* dt, const void* Bm, const void* Cm, const void* A, const void* Dskip,
           const void* h0, void* y, void* h_out, void* hck, int B, int S, int DI, int DS, int ck, cudaStream_t stream) {
  const dim3 grid((DI + THREADS - 1) / THREADS, B);
  mamba_scan_kernel<TX, CKPT><<<grid, THREADS, 0, stream>>>(
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
// [B, ceil(S / ck), DS, DI] f32 receives the checkpoints.  1 <= DS <= 16.
// Returns the CUDA error code (0 = ok).
extern "C" int mamba_scan_fwd(const void* x, const void* dt, const void* Bm, const void* Cm, const void* A,
                              const void* Dskip, const void* h0, void* y, void* h_out, void* hck, int B, int S, int DI,
                              int DS, int ck, int x_bf16, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || DI <= 0 || DS <= 0 || DS > MAX_DS || (hck != nullptr && ck <= 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hck != nullptr) {
    if (x_bf16) return launch<bf16, true>(x, dt, Bm, Cm, A, Dskip, h0, y, h_out, hck, B, S, DI, DS, ck, s);
    return launch<float, true>(x, dt, Bm, Cm, A, Dskip, h0, y, h_out, hck, B, S, DI, DS, ck, s);
  }
  if (x_bf16) return launch<bf16, false>(x, dt, Bm, Cm, A, Dskip, h0, y, h_out, nullptr, B, S, DI, DS, 1, s);
  return launch<float, false>(x, dt, Bm, Cm, A, Dskip, h0, y, h_out, nullptr, B, S, DI, DS, 1, s);
}
