// Backward of the RWKV6 WKV recurrence (kernel K5b).
//
// A port-side kernel: the JAX package has no Pallas backward for
// src/repro/kernels/rwkv_wkv/kernel.py (wkv6_pallas); its model runs the
// scan _wkv_scan (src/repro/models/rwkv.py) and XLA differentiates it.
// This kernel computes the same gradients for K5's forward
// (csrc/rwkv_wkv.cu).  Per (b, h), with S_{t-1} the state before step t
// (S_0 = s0, or 0), G_t = dL/dS_t (G_T = dS_final, or 0) and dy_t the
// gradient of y_t:
//   dr_t[i] = sum_j dy_t[j] S_{t-1}[i,j] + u_i k_t[i] (v_t . dy_t)
//   dk_t[i] = sum_j v_t[j] G_t[i,j]     + u_i r_t[i] (v_t . dy_t)
//   dv_t[j] = sum_i k_t[i] G_t[i,j]     + dy_t[j] sum_i u_i r_t[i] k_t[i]
//   dw_t[i] = sum_j S_{t-1}[i,j] G_t[i,j]
//   du[i]   = sum_t r_t[i] k_t[i] (v_t . dy_t)   (per (b, h); the wrapper sums over b)
//   G_{t-1} = diag(w_t) G_t + r_t dy_t^T,  ds0 = G_0
// r/k/v bf16 or f32 (widened to f32 first), w, u, s0, dy, dS_final f32;
// every gradient is written in f32.
//
// What bounds it on an H100: 14 D^2 f32 FLOP per (b, h, t) outside the
// tensor cores (the S and G recurrences, a MUL and an FMA an element each,
// and the four 64-term sums dr, dk, dv, dw), 15.0 GFLOP at the training
// shape (B 4, H 64, T 1024, D 64: 0.224 ms at 67 TFLOP/s) against 0.150 ms
// for its bytes (bf16 r/k/v, f32 w and dy read once, four f32 gradients
// written once): operations bound it.
//
// Design (simple first; speed is later work).  Every sum over j (dr, dk,
// dw) is taken inside one thread when that thread holds a whole row i of
// S or G, and the sum over i (dv) when it holds a whole column j of G; so
// the kernel needs no cross-thread reduction, only per-step vectors
// broadcast from shared memory.  One block of 64 threads per (b, h) and
// role (blockIdx.z):
// - role 0, thread i holds row i.  Pass 1 walks t forward from s0,
//   writes dr_t and the du partial, and stores S every CH = 32 steps to a
//   snapshot buffer ([B, H, T / CH, D, D] f32, each state transposed so
//   that a warp's stores are coalesced).  Pass 2 walks the chunks in
//   reverse carrying G: it recomputes the chunk's states from its snapshot,
//   keeping one every Q = 4 steps in a small scratch ([B, H, CH / Q, D, D]
//   f32), then for each 4-step piece in reverse recomputes its states into
//   shared memory and steps G back through them, writing dk_t and dw_t.
//   S_{t-1} is never rebuilt from S_t by dividing by w_t: decays reach 1e-30.
// - role 1, thread j holds column j of G and walks t backward from
//   dS_final, writing dv_t (the G recurrence a second time, so that no sum
//   over rows crosses threads).
// Each block stages CH steps of its per-step vectors into shared memory at
// once, widened to f32, with the step's scalar v.dy (role 0) or
// sum_i u_i r_i k_i (role 1) summed by one warp.  The inputs are read
// through their element strides (b, h, t; the last dim contiguous), one
// element a thread, so the model's [B, T, H, D] activations need no copy;
// the gradients are written in the [B, T, H, D] layout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int D = 64;         // head size
constexpr int THREADS = D;    // one thread per row (role 0) or column (role 1)
constexpr int WARPS = THREADS / 32;
constexpr int CH = 32;        // steps staged at once; a snapshot of S every CH steps
constexpr int Q = 4;          // steps whose states pass 2 keeps in shared memory
constexpr int SUBS = CH / Q;  // states kept per chunk in the scratch

// Dynamic shared memory: CH staged rows of r, k, v, w, dy (f32), a scalar
// per staged step, then role 0's Q states (row i of state qq at [qq][j][i]).
constexpr int STAGE_FLOATS = 5 * CH * D + CH;
constexpr int SMEM_BYTES = (STAGE_FLOATS + Q * D * D) * 4;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }

template <typename T>
struct Args {
  const T *r, *k, *v;
  const float *w, *u, *s0, *dy, *ds_final;
  float *dr, *dk, *dv, *dw, *du_part, *ds0, *snap, *sub;
  int H, Tn;
  long long sb, sh, st, dsb, dsh, dst;
};

// The staged rows of one chunk in shared memory.
struct Stage {
  float *r, *k, *v, *w, *dy, *scalar;
  __device__ explicit Stage(float* base)
      : r(base), k(base + CH * D), v(base + 2 * CH * D), w(base + 3 * CH * D), dy(base + 4 * CH * D),
        scalar(base + 5 * CH * D) {}
};

// Stage steps t0 .. t0 + nt - 1 (thread e loads element e of each row),
// then each step's scalar: role 0 v.dy, role 1 sum_i u_i r_i k_i (u_lo,
// u_hi: u at this lane and lane + 32).  Starts and ends with a barrier, so
// the previous chunk's rows are no longer read when they are overwritten.
template <typename T>
__device__ void stage(const Args<T>& a, const Stage& s, long long in0, long long dy0, int t0, int nt, int role,
                      float u_lo, float u_hi) {
  const int e = threadIdx.x;
  __syncthreads();
#pragma unroll 4
  for (int tt = 0; tt < nt; ++tt) {
    const long long off = in0 + (long long)(t0 + tt) * a.st + e;
    s.r[tt * D + e] = widen(a.r[off]);
    s.k[tt * D + e] = widen(a.k[off]);
    s.v[tt * D + e] = widen(a.v[off]);
    s.w[tt * D + e] = a.w[off];
    s.dy[tt * D + e] = a.dy[dy0 + (long long)(t0 + tt) * a.dst + e];
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int tt = warp; tt < nt; tt += WARPS) {
    const float* p = role == 0 ? s.v + tt * D : s.r + tt * D;
    const float* q = role == 0 ? s.dy + tt * D : s.k + tt * D;
    float x = role == 0 ? p[lane] * q[lane] + p[lane + 32] * q[lane + 32]
                        : u_lo * p[lane] * q[lane] + u_hi * p[lane + 32] * q[lane + 32];
#pragma unroll
    for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) s.scalar[tt] = x;
  }
  __syncthreads();
}

// S[:] = w S[:] + k v[:] for one row (v: a staged row, read as a broadcast).
__device__ __forceinline__ void advance(float (&S)[D], float w, float k, const float* v) {
#pragma unroll
  for (int j4 = 0; j4 < D / 4; ++j4) {
    const float4 vv = reinterpret_cast<const float4*>(v)[j4];
    S[4 * j4] = fmaf(w, S[4 * j4], k * vv.x);
    S[4 * j4 + 1] = fmaf(w, S[4 * j4 + 1], k * vv.y);
    S[4 * j4 + 2] = fmaf(w, S[4 * j4 + 2], k * vv.z);
    S[4 * j4 + 3] = fmaf(w, S[4 * j4 + 3], k * vv.w);
  }
}

// sum_j S[j] x[j] (x: a staged row), in four partial sums.
__device__ __forceinline__ float dot(const float (&S)[D], const float* x) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j4 = 0; j4 < D / 4; ++j4) {
    const float4 xx = reinterpret_cast<const float4*>(x)[j4];
    acc[0] = fmaf(S[4 * j4], xx.x, acc[0]);
    acc[1] = fmaf(S[4 * j4 + 1], xx.y, acc[1]);
    acc[2] = fmaf(S[4 * j4 + 2], xx.z, acc[2]);
    acc[3] = fmaf(S[4 * j4 + 3], xx.w, acc[3]);
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// A state row kept transposed in memory: element j of row i at [j][i].
__device__ __forceinline__ void store_t(float* base, const float (&S)[D], int i) {
#pragma unroll
  for (int j = 0; j < D; ++j) base[j * D + i] = S[j];
}
__device__ __forceinline__ void load_t(float (&S)[D], const float* base, int i) {
#pragma unroll
  for (int j = 0; j < D; ++j) S[j] = base[j * D + i];
}

// A row of a [D, D] f32 matrix in device memory (16-byte aligned), or zeros.
__device__ __forceinline__ void load_row(float (&S)[D], const float* m) {
#pragma unroll
  for (int j4 = 0; j4 < D / 4; ++j4) {
    const float4 x = m ? reinterpret_cast<const float4*>(m)[j4] : make_float4(0.f, 0.f, 0.f, 0.f);
    S[4 * j4] = x.x;
    S[4 * j4 + 1] = x.y;
    S[4 * j4 + 2] = x.z;
    S[4 * j4 + 3] = x.w;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) wkv6_bwd_kernel(Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  const Stage s(smem);
  const int h = blockIdx.x, b = blockIdx.y, role = blockIdx.z, e = threadIdx.x;
  const int H = a.H, Tn = a.Tn, chunks = (Tn + CH - 1) / CH;
  const long long in0 = (long long)b * a.sb + (long long)h * a.sh;
  const long long dy0 = (long long)b * a.dsb + (long long)h * a.dsh;
  const size_t bh = (size_t)b * H + h;
  const size_t state0 = bh * D * D;
  // gradient (b, t, h, e) in the [B, T, H, D] layout
  auto out = [&](int t) { return (((size_t)b * Tn + t) * H + h) * D + e; };
  const int lane = e % 32;
  const float u_lo = a.u[h * D + lane], u_hi = a.u[h * D + lane + 32];

  if (role == 1) {
    // dv: thread j = e holds column j of G, G[i] = G_t[i, j]
    float G[D];
#pragma unroll
    for (int i = 0; i < D; ++i) G[i] = a.ds_final ? a.ds_final[state0 + (size_t)i * D + e] : 0.f;
    for (int c = chunks - 1; c >= 0; --c) {
      const int t0 = c * CH, nt = min(CH, Tn - t0);
      stage(a, s, in0, dy0, t0, nt, 1, u_lo, u_hi);
      for (int tt = nt - 1; tt >= 0; --tt) {
        const float dyj = s.dy[tt * D + e];
        const float* kr = s.k + tt * D;
        const float* rr = s.r + tt * D;
        const float* wr = s.w + tt * D;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i4 = 0; i4 < D / 4; ++i4) {
          const float4 k4 = reinterpret_cast<const float4*>(kr)[i4];
          const float4 r4 = reinterpret_cast<const float4*>(rr)[i4];
          const float4 w4 = reinterpret_cast<const float4*>(wr)[i4];
          const float ks[4] = {k4.x, k4.y, k4.z, k4.w}, rs[4] = {r4.x, r4.y, r4.z, r4.w};
          const float ws[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            float& g = G[4 * i4 + m];
            acc[m] = fmaf(ks[m], g, acc[m]);
            g = fmaf(ws[m], g, rs[m] * dyj);
          }
        }
        a.dv[out(t0 + tt)] = fmaf(dyj, s.scalar[tt], (acc[0] + acc[1]) + (acc[2] + acc[3]));
      }
    }
    return;
  }

  // role 0, thread i = e holds row i.  Pass 1: S forward, dr, du, snapshots.
  float* stash = smem + STAGE_FLOATS;
  const float ui = a.u[h * D + e];
  float S[D];
  load_row(S, a.s0 ? a.s0 + state0 + (size_t)e * D : nullptr);
  float du = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const int t0 = c * CH, nt = min(CH, Tn - t0);
    store_t(a.snap + (bh * chunks + c) * D * D, S, e);  // S_{t0 - 1}
    stage(a, s, in0, dy0, t0, nt, 0, u_lo, u_hi);
    for (int tt = 0; tt < nt; ++tt) {
      const float ki = s.k[tt * D + e], vdy = s.scalar[tt];
      a.dr[out(t0 + tt)] = fmaf(ui * ki, vdy, dot(S, s.dy + tt * D));
      du = fmaf(s.r[tt * D + e] * ki, vdy, du);
      advance(S, s.w[tt * D + e], ki, s.v + tt * D);
    }
  }
  a.du_part[bh * D + e] = du;

  // Pass 2: G backward through the chunks in reverse; S (row i) is reused
  // for the recomputed states.
  float G[D];
  load_row(G, a.ds_final ? a.ds_final + state0 + (size_t)e * D : nullptr);
  float* sub = a.sub + bh * SUBS * D * D;
  for (int c = chunks - 1; c >= 0; --c) {
    const int t0 = c * CH, nt = min(CH, Tn - t0);
    stage(a, s, in0, dy0, t0, nt, 0, u_lo, u_hi);
    load_t(S, a.snap + (bh * chunks + c) * D * D, e);
    const int pieces = (nt + Q - 1) / Q;
    for (int tt = 0; tt < (pieces - 1) * Q; ++tt) {  // the state before each piece but the first
      advance(S, s.w[tt * D + e], s.k[tt * D + e], s.v + tt * D);
      if ((tt + 1) % Q == 0) store_t(sub + ((tt + 1) / Q) * D * D, S, e);
    }
    for (int p = pieces - 1; p >= 0; --p) {
      const int q0 = p * Q, nq = min(Q, nt - q0);
      load_t(S, p ? sub + p * D * D : a.snap + (bh * chunks + c) * D * D, e);  // the state before the piece
      for (int qq = 0; qq < nq; ++qq) {
        store_t(stash + qq * D * D, S, e);  // S_{t-1} of step q0 + qq
        if (qq + 1 < nq) advance(S, s.w[(q0 + qq) * D + e], s.k[(q0 + qq) * D + e], s.v + (q0 + qq) * D);
      }
      for (int qq = nq - 1; qq >= 0; --qq) {
        const int tt = q0 + qq;
        const float ri = s.r[tt * D + e], wi = s.w[tt * D + e], vdy = s.scalar[tt];
        const float* prev = stash + qq * D * D;
        float dk[4] = {0.f, 0.f, 0.f, 0.f}, dw[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j4 = 0; j4 < D / 4; ++j4) {
          const float4 v4 = reinterpret_cast<const float4*>(s.v + tt * D)[j4];
          const float4 y4 = reinterpret_cast<const float4*>(s.dy + tt * D)[j4];
          const float vs[4] = {v4.x, v4.y, v4.z, v4.w}, ys[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            float& g = G[4 * j4 + m];
            dk[m] = fmaf(vs[m], g, dk[m]);
            dw[m] = fmaf(prev[(4 * j4 + m) * D + e], g, dw[m]);
            g = fmaf(wi, g, ri * ys[m]);
          }
        }
        a.dk[out(t0 + tt)] = fmaf(ui * ri, vdy, (dk[0] + dk[1]) + (dk[2] + dk[3]));
        a.dw[out(t0 + tt)] = (dw[0] + dw[1]) + (dw[2] + dw[3]);
      }
    }
  }
  if (a.ds0) {
#pragma unroll
    for (int j4 = 0; j4 < D / 4; ++j4)
      reinterpret_cast<float4*>(a.ds0 + state0 + (size_t)e * D)[j4] =
          make_float4(G[4 * j4], G[4 * j4 + 1], G[4 * j4 + 2], G[4 * j4 + 3]);
  }
}

template <typename T>
int launch(const Args<T>& a, int B, cudaStream_t stream) {
  static bool smem_set = false;  // above 48 KB: raise the kernel's limit once per process
  if (!smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(wkv6_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  wkv6_bwd_kernel<T><<<dim3(a.H, B, 2), THREADS, SMEM_BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Scratch sizes in floats for B x H heads over T steps: the snapshots, then the kept states.
extern "C" long long wkv6_bwd_scratch_floats(int B, int H, int Tn, int which) {
  const long long heads = (long long)B * H;
  return which == 0 ? heads * ((Tn + CH - 1) / CH) * D * D : heads * SUBS * D * D;
}

// r/k/v (bf16 if in_bf16, else f32) and w (f32) share the element strides
// sb, sh, st of a [B, H, T, 64] view whose last dim is contiguous; dy (f32)
// has its own strides dsb, dsh, dst, last dim contiguous.  u [H, 64], s0
// and dS_final (nullptr: zero) [B, H, 64, 64] f32 contiguous, s0 and
// dS_final 16-byte aligned.  Writes dr, dk, dv, dw f32 contiguous in the
// [B, T, H, 64] layout, du_part [B, H, 64] f32, ds0 [B, H, 64, 64] f32
// (nullptr: not written; 16-byte aligned), using snap and sub as scratch
// (wkv6_bwd_scratch_floats).  Returns the CUDA error code (0 = ok).
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v, const void* w, const void* u, const void* s0,
                        const void* dy, const void* ds_final, void* dr, void* dk, void* dv, void* dw, void* du_part,
                        void* ds0, void* snap, void* sub, int B, int H, int Tn, int head_dim, long long sb,
                        long long sh, long long st, long long dsb, long long dsh, long long dst, int in_bf16,
                        void* stream) {
  if (B <= 0 || H <= 0 || Tn <= 0 || head_dim != D || B > 65535) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)s0 | (uintptr_t)ds_final | (uintptr_t)ds0) % 16) return (int)cudaErrorMisalignedAddress;
  Args<float> af{static_cast<const float*>(r), static_cast<const float*>(k), static_cast<const float*>(v),
                 static_cast<const float*>(w), static_cast<const float*>(u), static_cast<const float*>(s0),
                 static_cast<const float*>(dy), static_cast<const float*>(ds_final), static_cast<float*>(dr),
                 static_cast<float*>(dk), static_cast<float*>(dv), static_cast<float*>(dw),
                 static_cast<float*>(du_part), static_cast<float*>(ds0), static_cast<float*>(snap),
                 static_cast<float*>(sub), H, Tn, sb, sh, st, dsb, dsh, dst};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!in_bf16) return launch<float>(af, B, s);
  Args<bf16> ab{static_cast<const bf16*>(r), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                af.w, af.u, af.s0, af.dy, af.ds_final, af.dr, af.dk, af.dv, af.dw, af.du_part, af.ds0, af.snap,
                af.sub, H, Tn, sb, sh, st, dsb, dsh, dst};
  return launch<bf16>(ab, B, s);
}
