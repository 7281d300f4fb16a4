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
// Design (simple first, as K6): one thread per (b, i) holds its ds <= 16
// adjoints, its row of a and its da sums in registers.  A block serves 64
// channels (two warps) of one batch row and walks the checkpoint chunks from
// the last to the first.  For each chunk it stages x, dt, dy (coalesced
// [CK][64] tiles) and the chunk's B and C rows in shared memory, recomputes
// the chunk's CK states from its checkpoint into shared memory ([step][s]
// [channel]: conflict-free), then walks the chunk backwards.  The state is
// recomputed once (K5b's lesson: no state twice); e_t,s is the one
// exponential the walk takes again, so the backward costs two exponentials
// a (b, t, i, s), each one ex2.approx of dt (a log2 e), a log2 e held in
// registers (~1e-6 relative, against the 1e-3 the gradients are held to).
// A step's B and C rows come from shared memory as float4 broadcasts.  CK = 8
// keeps a block at 46 KB of shared memory, so four blocks (eight warps)
// share an SM; at 16 steps (88 KB) two would, too few to hide the walk's
// latency.  dB and dC are sums over channels: each warp sums its 32 lanes'
// 32 values (16 dB, 16 dC) by a transposing butterfly (31 shuffles a step,
// lane l ends with value l), the two warps are added in order, and the
// block writes one partial a (b, t) and value.  da and dd_skip are each
// thread's own sums over t, written a batch row at a time.  A second launch
// of this source sums the partials over blocks (dB, dC) and over batch rows
// (da, dd_skip) in a fixed order: no float atomics, so two runs give the
// same bits.
//
// What bounds it on an H100 (3.35 TB/s; 16 exponentials a clock an SM): at
// the training shape x [4, 1024, 16384] bf16 the function must read x
// (134 MB), dt and dy (268 MB each) and write dx and ddt (268 MB each),
// about 1.21 GB or 0.36 ms, and take B S di ds = 1.07 G exponentials,
// 0.26 ms.  This design also reads the checkpoints (537 MB at CK = 8) and
// writes and reads the dB/dC partials (134 MB each way), about 2.0 GB or
// 0.60 ms, and takes two exponentials a (b, t, i, s), 0.51 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int MAX_DS = 16;    // states a channel
constexpr int THREADS = 64;   // channels a block: two warps
constexpr int WARPS = THREADS / 32;
constexpr int CK = 8;         // steps between the forward's checkpoints
constexpr int NV = 2 * MAX_DS;  // values a lane hands to the channel sums: dB (s), dC (16 + s)

struct Smem {
  float hs[CK + 1][MAX_DS][THREADS];  // hs[0] the checkpoint, hs[r + 1] the state after the chunk's step r
  float sx[CK][THREADS], sdt[CK][THREADS], sdy[CK][THREADS];
  float sb[CK][MAX_DS], sc[CK][MAX_DS];
  float red[WARPS][CK][NV];  // each warp's channel sums a step
};

// 2^x on the special-function unit (ex2.approx.ftz: ~2 ulp)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }

// One round of warp_transpose_sum: the lane keeps the half of v[0, 2 HALF)
// its bit HALF selects and adds its partner's copy of that half.
template <int HALF>
__device__ __forceinline__ void transpose_round(float (&v)[NV], int lane) {
  const bool up = lane & HALF;
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const float send = up ? v[j] : v[j + HALF];
    const float keep = up ? v[j + HALF] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, HALF);
  }
}

// v[NV] in each lane -> lane l returns the sum over the warp's 32 lanes of v[l]
// (5 rounds, 31 shuffles; every index static, so v stays in registers).
__device__ __forceinline__ float warp_transpose_sum(float (&v)[NV], int lane) {
  static_assert(NV == 32, "one value a lane");
  transpose_round<16>(v, lane);
  transpose_round<8>(v, lane);
  transpose_round<4>(v, lane);
  transpose_round<2>(v, lane);
  transpose_round<1>(v, lane);
  return v[0];
}

template <typename TX>
__global__ void __launch_bounds__(THREADS) mamba_scan_bwd_kernel(
    const TX* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ A, const float* __restrict__ Dskip,
    const float* __restrict__ hck, const float* __restrict__ dy, const float* __restrict__ dh_final,
    float* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ part_bc, float* __restrict__ part_a,
    float* __restrict__ part_d, float* __restrict__ dh0, int S, int DI, int DS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int B = gridDim.y, b = blockIdx.y, blk = blockIdx.x, i0 = blk * THREADS, tid = threadIdx.x;
  const int i = i0 + tid, lane = tid & 31, warp = tid >> 5;
  const bool live = i < DI;
  const int width = min(THREADS, DI - i0);  // live channels of this block
  const int nck = (S + CK - 1) / CK;
  float a[MAX_DS], a2[MAX_DS], g[MAX_DS], da[MAX_DS], h[MAX_DS];  // a2 = a log2 e: e = 2^(dt a2)
#pragma unroll
  for (int s = 0; s < MAX_DS; ++s) {
    const bool on = live && s < DS;
    a[s] = on ? A[(long long)i * DS + s] : 0.f;
    a2[s] = a[s] * 1.4426950408889634f;
    g[s] = on && dh_final != nullptr ? dh_final[((long long)b * DI + i) * DS + s] : 0.f;
    da[s] = 0.f;
  }
  const float dsk = live ? Dskip[i] : 0.f;
  float dd = 0.f;
  for (int kc = nck - 1; kc >= 0; --kc) {
    const int t0 = kc * CK, n = min(CK, S - t0);
    __syncthreads();  // the previous chunk's reads of the tiles are done
    for (int k = tid; k < n * THREADS; k += THREADS) {
      const int r = k / THREADS, col = k % THREADS;
      const long long o = ((long long)b * S + t0 + r) * DI + i0 + col;
      const bool in = col < width;
      sm.sx[r][col] = in ? widen(x[o]) : 0.f;
      sm.sdt[r][col] = in ? dt[o] : 0.f;
      sm.sdy[r][col] = in ? dy[o] : 0.f;
    }
    for (int k = tid; k < n * MAX_DS; k += THREADS) {
      const int r = k / MAX_DS, s = k % MAX_DS;
      const long long o = ((long long)b * S + t0 + r) * DS + s;
      sm.sb[r][s] = s < DS ? Bm[o] : 0.f;
      sm.sc[r][s] = s < DS ? Cm[o] : 0.f;
    }
#pragma unroll
    for (int s = 0; s < MAX_DS; ++s) {
      h[s] = live && s < DS ? hck[(((long long)b * nck + kc) * DS + s) * DI + i] : 0.f;
      sm.hs[0][s][tid] = h[s];
    }
    __syncthreads();
    // the chunk's states from its checkpoint, each kept in shared memory
    for (int r = 0; r < n; ++r) {
      const float d = sm.sdt[r][tid], dbx = d * sm.sx[r][tid];
      float bv[MAX_DS];
#pragma unroll
      for (int q = 0; q < MAX_DS / 4; ++q) {
        const float4 t4 = reinterpret_cast<const float4*>(sm.sb[r])[q];
        bv[4 * q] = t4.x; bv[4 * q + 1] = t4.y; bv[4 * q + 2] = t4.z; bv[4 * q + 3] = t4.w;
      }
#pragma unroll
      for (int s = 0; s < MAX_DS; ++s) {
        h[s] = ex2(d * a2[s]) * h[s] + dbx * bv[s];
        sm.hs[r + 1][s][tid] = h[s];
      }
    }
    // then the chunk backwards: h holds h_t, hs[r] gives h_t-1
    for (int r = n - 1; r >= 0; --r) {
      const float xv = sm.sx[r][tid], d = sm.sdt[r][tid], dyv = sm.sdy[r][tid], dxv = d * xv;
      float v[NV], bv[MAX_DS], cv[MAX_DS];
#pragma unroll
      for (int q = 0; q < MAX_DS / 4; ++q) {
        const float4 b4 = reinterpret_cast<const float4*>(sm.sb[r])[q];
        const float4 c4 = reinterpret_cast<const float4*>(sm.sc[r])[q];
        bv[4 * q] = b4.x; bv[4 * q + 1] = b4.y; bv[4 * q + 2] = b4.z; bv[4 * q + 3] = b4.w;
        cv[4 * q] = c4.x; cv[4 * q + 1] = c4.y; cv[4 * q + 2] = c4.z; cv[4 * q + 3] = c4.w;
      }
      float dxa = dyv * dsk, ddta = 0.f;
#pragma unroll
      for (int s = 0; s < MAX_DS; ++s) {
        const float hp = sm.hs[r][s][tid];
        g[s] += dyv * cv[s];
        v[MAX_DS + s] = dyv * h[s];
        const float e = ex2(d * a2[s]), eh = e * hp, gd = g[s] * d;
        ddta += g[s] * (eh * a[s] + xv * bv[s]);
        da[s] += gd * eh;
        dxa += gd * bv[s];
        v[s] = gd * xv;
        g[s] *= e;
        h[s] = hp;
      }
      dd += dyv * xv;
      if (live) {
        const long long o = ((long long)b * S + t0 + r) * DI + i;
        dx[o] = dxa;
        ddt[o] = ddta;
      }
      sm.red[warp][r][lane] = warp_transpose_sum(v, lane);
    }
    __syncthreads();
    for (int k = tid; k < n * NV; k += THREADS) {
      const int r = k / NV, j = k % NV;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) sum += sm.red[w][r][j];
      part_bc[(((long long)blk * B + b) * S + t0 + r) * NV + j] = sum;
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < MAX_DS; ++s) {
      if (s < DS) {
        const long long o = ((long long)b * DI + i) * DS + s;
        part_a[o] = da[s];
        if (dh0 != nullptr) dh0[o] = g[s];
      }
    }
    part_d[(long long)b * DI + i] = dd;
  }
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

template <typename TX>
int launch(const void* x, const void* dt, const void* Bm, const void* Cm, const void* A, const void* Dskip,
           const void* hck, const void* dy, const void* dh_final, void* dx, void* ddt, void* dbc, void* da, void* dd,
           void* dh0, void* part_bc, void* part_a, void* part_d, int B, int S, int DI, int DS, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(mamba_scan_bwd_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nblk = (DI + THREADS - 1) / THREADS;
  mamba_scan_bwd_kernel<TX><<<dim3(nblk, B), THREADS, smem, stream>>>(
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

}  // namespace

// The checkpoint interval (steps) this build reads: the forward writes hck at it (ops.ckpt_steps reads this).
extern "C" int mamba_scan_bwd_ckpt_steps(void) { return CK; }

// Channels a block serves: the dB/dC partials are [ceil(DI / this), B, S, 32] f32.
extern "C" int mamba_scan_bwd_block_channels(void) { return THREADS; }

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
  if (x_bf16)
    return launch<bf16>(x, dt, Bm, Cm, A, Dskip, hck, dy, dh_final, dx, ddt, dbc, da, dd, dh0, part_bc, part_a,
                        part_d, B, S, DI, DS, s);
  return launch<float>(x, dt, Bm, Cm, A, Dskip, hck, dy, dh_final, dx, ddt, dbc, da, dd, dh0, part_bc, part_a,
                       part_d, B, S, DI, DS, s);
}
