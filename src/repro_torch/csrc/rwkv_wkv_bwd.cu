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
// Design (the Hopper redesign; the first design walked all T steps in
// series in one 64-thread block per (b, h), 512 blocks at the training
// shape).  Both recurrences are linear with a diagonal decay, so time is
// cut into chunks of C = 32 steps, in two launches:
// 1. wkv6_bwd_sweep_kernel, a block of 128 per (b, h, direction) (all of
//    them resident at once), a thread 32 columns of one row in registers:
//    forward, the state S0 before every chunk (S0[c+1] = P_c S0[c] + L_c,
//    with the chunk's own end state from zero L_c = sum_s b_s k_s v_s^T);
//    backward, the gradient G1 at every
//    chunk's last step (G1[c-1] = P_c G1[c] + M_c, M_c = sum_s a_s r_s
//    dy_s^T), ds0 and du.  a_s = prod_{m<s} w_m, b_s = prod_{m>s} w_m and
//    P = prod w are products of decays (two threads a row), never
//    quotients; the next chunk's rows load during this chunk's work.
// 2. wkv6_bwd_grad_kernel, a block per (b, h, chunk) (8192 at the training
//    shape; a chunk's heads run together, so their rows of the [B, T, H, D]
//    activations are read together), from the chunk's S0 and G1 in closed
//    form: within the chunk S_{t-1} = a_t S0 + sum_{s<t} E(s,t) k_s v_s^T
//    and G_t = b_t G1 + sum_{s>t} E(t,s) r_s dy_s^T with
//    E(s,t) = prod_{s<m<t} w_m.  The D x D parts are products in shared
//    memory (X1 = S0 dy^T, X2 = G1 v^T, v dy^T, and dv's G1^T (k b) +
//    KER dy); the pair parts are a walk over the chunk a row and 8 future
//    steps a thread, carrying sigma_t[s] = S_{t-1}[i] . dy_s (the state
//    seen through the chunk's dy rows) and rho_t = S_{t-1}[i] . G1[i]:
//    dr_t = sigma_t[t] + ..., dw_t = b_t rho_t + sum_{s>t} E(t,s) r_s
//    sigma_t[s], dk_t = b_t X2[t] + sum_{s>t} E(t,s) r_s (v_t . dy_s) + ...,
//    and KER[t,s] = sum_i k_t[i] E(t,s) r_s[i], summed over the rows by
//    warp shuffles and then over the warps in order.  E(t,s) across the
//    chunk's four 8-step blocks is a product of a within-block suffix,
//    whole blocks' decays and a running product: no division anywhere.
// This design's own traffic (the inputs read by both launches, the chunk
// edges written and read back) is about 1.41 GB at the training shape,
// 0.42 ms at 3.35 TB/s.
// No float atomics: every sum has a fixed order, so the same inputs give
// the same bits.  A ragged last chunk is padded with identity steps
// (w = 1, r = k = v = dy = 0), whose gradients are not written.  The
// inputs are read through their element strides (b, h, t; the last dim
// contiguous), so the model's [B, T, H, D] activations need no copy; the
// gradients are written in the [B, T, H, D] layout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int D = 64;          // head size
constexpr int C = 32;          // steps a chunk
constexpr int QB = 8;          // steps a block of the chunk (a thread's future steps in the walk)
constexpr int NQ = C / QB;     // blocks a chunk
constexpr int THREADS = 256;   // the grad kernel's block: 4 threads a row of the state
constexpr int WARPS = THREADS / 32;
constexpr int LDP = D + 4;     // padded row of the shared S0, G1, v and dy tiles (conflict-free float4 reads)

template <typename T>
struct Args {
  const T *r, *k, *v;
  const float *w, *u, *s0, *dy, *ds_final;
  float *dr, *dk, *dv, *dw, *du_part, *ds0, *states;
  int H, Tn, NC;
  long long sb, sh, st, dsb, dsh, dst;
};

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void fma4(float4& acc, float s, const float4& x) {
  acc.x = fmaf(s, x.x, acc.x);
  acc.y = fmaf(s, x.y, acc.y);
  acc.z = fmaf(s, x.z, acc.z);
  acc.w = fmaf(s, x.w, acc.w);
}
__device__ __forceinline__ float dot4(const float4& x, const float4& y, float acc) {
  return fmaf(x.w, y.w, fmaf(x.z, y.z, fmaf(x.y, y.y, fmaf(x.x, y.x, acc))));
}

// The chunk's rows in shared memory, widened to f32, steps past the end as
// identity steps.  v and dy rows are LDP apart, the others D.
struct Rows {
  float *r, *k, *v, *w, *dy;
};

// 16 bytes of r/k/v widened to f32 into shared memory (16-byte aligned): 4 floats, or 8 bf16.
__device__ __forceinline__ void put16(float* dst, const uint4& u, float) {
  *reinterpret_cast<float4*>(dst) = make_float4(__uint_as_float(u.x), __uint_as_float(u.y), __uint_as_float(u.z),
                                                __uint_as_float(u.w));
}
__device__ __forceinline__ float lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ void put16(float* dst, const uint4& u, bf16) {
  *reinterpret_cast<float4*>(dst) = make_float4(lo(u.x), hi(u.x), lo(u.y), hi(u.y));
  *reinterpret_cast<float4*>(dst + 4) = make_float4(lo(u.z), hi(u.z), lo(u.w), hi(u.w));
}

// One thread's 16-byte pieces of a chunk's rows (rows start on 16 bytes: the wrapper copies views
// that do not), held in registers between their loads and their stores, so that a thread has all its
// loads in flight at once (and, in the sweep, the next chunk's during this chunk's work).
template <typename T, int NT>
struct Pieces {
  static constexpr int EV = 16 / sizeof(T), PR = D / EV;  // r/k/v elements a piece, pieces a row
  static constexpr int NR = (C * PR + NT - 1) / NT;       // r/k/v pieces a thread of NT
  static constexpr int NF = (C * (D / 4) + NT - 1) / NT;  // w and dy pieces a thread
  uint4 r[NR], k[NR], v[NR];
  float4 w[NF], dy[NF];
};

// Load the rows of steps t0 .. t0 + n - 1 (past the end: identity steps); r and dy only with rdy.
template <typename T, int NT>
__device__ __forceinline__ void load_rows(Pieces<T, NT>& p, const Args<T>& a, int b, int h, int t0, int n, bool rdy) {
  using P = Pieces<T, NT>;
  const long long in0 = (long long)b * a.sb + (long long)h * a.sh;
  const long long dy0 = (long long)b * a.dsb + (long long)h * a.dsh;
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int j = 0; j < P::NR; ++j) {
    const int idx = threadIdx.x + j * NT, tt = idx / P::PR, e = (idx % P::PR) * P::EV;
    const bool live = idx < C * P::PR && tt < n;
    const long long off = in0 + (long long)(t0 + tt) * a.st + e;
    p.r[j] = rdy && live ? *reinterpret_cast<const uint4*>(a.r + off) : z;
    p.k[j] = live ? *reinterpret_cast<const uint4*>(a.k + off) : z;
    p.v[j] = live ? *reinterpret_cast<const uint4*>(a.v + off) : z;
  }
#pragma unroll
  for (int j = 0; j < P::NF; ++j) {
    const int idx = threadIdx.x + j * NT, tt = idx / (D / 4), e = (idx % (D / 4)) * 4;
    const bool live = idx < C * (D / 4) && tt < n;
    p.w[j] = live ? ld4(a.w + in0 + (long long)(t0 + tt) * a.st + e) : make_float4(1.f, 1.f, 1.f, 1.f);
    p.dy[j] = rdy && live ? ld4(a.dy + dy0 + (long long)(t0 + tt) * a.dst + e) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <typename T, int NT>
__device__ __forceinline__ void store_rows(const Pieces<T, NT>& p, const Rows& s) {
  using P = Pieces<T, NT>;
#pragma unroll
  for (int j = 0; j < P::NR; ++j) {
    const int idx = threadIdx.x + j * NT, tt = idx / P::PR, e = (idx % P::PR) * P::EV;
    if (idx >= C * P::PR) break;
    put16(s.r + tt * D + e, p.r[j], T());
    put16(s.k + tt * D + e, p.k[j], T());
    put16(s.v + tt * LDP + e, p.v[j], T());
  }
#pragma unroll
  for (int j = 0; j < P::NF; ++j) {
    const int idx = threadIdx.x + j * NT, tt = idx / (D / 4), e = (idx % (D / 4)) * 4;
    if (idx >= C * (D / 4)) break;
    *reinterpret_cast<float4*>(s.w + tt * D + e) = p.w[j];
    *reinterpret_cast<float4*>(s.dy + tt * LDP + e) = p.dy[j];
  }
}

// Scratch: states [B H][NC][2][D][D], S0 (the state before the chunk) at [0] and G1 (G at its last
// step) at [1].
__device__ __forceinline__ size_t state_at(int bh, int NC, int c, int which) {
  return (((size_t)bh * NC + c) * 2 + which) * D * D;
}

// Shared memory layout of a chunk's rows: r, k [C][D]; v [C][LDP]; w [C][D]; dy [C][LDP].
constexpr int ROWS_FLOATS = 3 * C * D + 2 * C * LDP;
__device__ __forceinline__ Rows rows_at(float* base) {
  return Rows{base, base + C * D, base + 2 * C * D, base + 2 * C * D + C * LDP, base + 3 * C * D + C * LDP};
}

// ---------------------------------------------------------------- 1. sweep
// A block of 128 threads per (b, h, direction), so that all B H 2 chains are resident at once (four
// blocks an SM): forward the state S over the chunks, backward the gradient G; a thread holds 32 columns
// of one row in registers.  Per chunk: every row's decay products (a thread 16 steps of a row) and,
// backward, v_t . dy_t; the state at the chunk's edge written out; then the state scaled by the chunk's
// decay P and the rank-1 sum of the chunk's own steps added (S: S0[c+1] = P S0[c] + sum_s b_s k_s
// v_s^T; G: G1[c-1] = P G1[c] + sum_s a_s r_s dy_s^T).  The next chunk's rows are loaded during this
// chunk's work.  The backward block also sums du and writes ds0.
constexpr int SW_THREADS = 128;
constexpr int SW_HALF = C / 2;  // steps a thread of the decay pass
constexpr int SW_FLOATS = ROWS_FLOATS + C * D + C + D;

template <typename T>
__global__ void __launch_bounds__(SW_THREADS, 4) wkv6_bwd_sweep_kernel(Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  const Rows s = rows_at(smem);
  float* coef = smem + ROWS_FLOATS;  // b_s k_s (forward) or a_s r_s (backward), [C][D]
  float* vdy = coef + C * D;         // v_t . dy_t (backward)
  float* decay = vdy + C;            // each row's P
  const int h = blockIdx.x, back = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int bh = b * a.H + h, NC = a.NC, Tn = a.Tn;
  const int row = tid / 2, col = 32 * (tid % 2), half = tid % 2;  // 32 columns of one row; steps of a half
  const float* init = back ? a.ds_final : a.s0;
  float4 X[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    X[j] = init ? ld4(init + (size_t)bh * D * D + row * D + col + 4 * j) : make_float4(0.f, 0.f, 0.f, 0.f);
  float du = 0.f;
  Pieces<T, SW_THREADS> p;
  {
    const int c = back ? NC - 1 : 0;
    load_rows(p, a, b, h, c * C, min(C, Tn - c * C), back);
  }
  for (int kk = 0; kk < NC; ++kk) {
    const int c = back ? NC - 1 - kk : kk;
    __syncthreads();  // the last chunk's rows are read
    store_rows(p, s);
    if (kk + 1 < NC) {  // the next chunk's loads, in flight during this one
      const int cn = back ? c - 1 : c + 1;
      load_rows(p, a, b, h, cn * C, min(C, Tn - cn * C), back);
    }
    __syncthreads();
    {  // row `row`'s decays over this thread's 16 steps, the other half's product, the chunk's P
      float wq = 1.f;
#pragma unroll
      for (int m = 0; m < SW_HALF; ++m) wq *= s.w[(half * SW_HALF + m) * D + row];
      const float other = __shfl_xor_sync(0xffffffffu, wq, 1);
      if (half == 0) decay[row] = wq * other;
      float acc = back ? (half ? other : 1.f) : (half ? 1.f : other);
      const float* coeff_of = back ? s.r : s.k;
#pragma unroll
      for (int m = 0; m < SW_HALF; ++m) {  // forward: coef[t] = k_t prod_{m>t} w_m; backward: r_t prod_{m<t} w_m
        const int t = back ? half * SW_HALF + m : half * SW_HALF + SW_HALF - 1 - m;
        coef[t * D + row] = coeff_of[t * D + row] * acc;
        acc *= s.w[t * D + row];
      }
    }
    if (back) {  // v_t . dy_t, a warp 8 steps
      for (int t = warp; t < C; t += SW_THREADS / 32) {
        float x = s.v[t * LDP + lane] * s.dy[t * LDP + lane] + s.v[t * LDP + lane + 32] * s.dy[t * LDP + lane + 32];
#pragma unroll
        for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
        if (lane == 0) vdy[t] = x;
      }
    }
    __syncthreads();
    if (back) {
#pragma unroll 4
      for (int m = 0; m < SW_HALF; ++m) {
        const int t = half * SW_HALF + m;
        du = fmaf(s.r[t * D + row] * s.k[t * D + row], vdy[t], du);
      }
    }
    const float P = decay[row];
    float4* edge = reinterpret_cast<float4*>(a.states + state_at(bh, NC, c, back) + row * D + col);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      edge[j] = X[j];
      X[j] = make_float4(P * X[j].x, P * X[j].y, P * X[j].z, P * X[j].w);
    }
    const float* rows = (back ? s.dy : s.v) + col;
#pragma unroll 4
    for (int t = 0; t < C; ++t) {
      const float cf = coef[t * D + row];
#pragma unroll
      for (int j = 0; j < 8; ++j) fma4(X[j], cf, ld4(rows + t * LDP + 4 * j));
    }
  }
  if (back) {
    if (a.ds0) {
      float4* out = reinterpret_cast<float4*>(a.ds0 + (size_t)bh * D * D + row * D + col);
#pragma unroll
      for (int j = 0; j < 8; ++j) out[j] = X[j];
    }
    du += __shfl_xor_sync(0xffffffffu, du, 1);
    if (half == 0) a.du_part[(size_t)bh * D + row] = du;
  }
}

// ----------------------------------------------------------------- 2. grad
// Shared memory (floats).  KERP, the warps' KER partials [WARPS][C][C],
// lies over S0, v and X1, which are dead by then; KER over its first [C][C].
constexpr int G_S0 = 0, G_V = G_S0 + D * LDP, G_X1 = G_V + C * LDP, G_G1 = G_X1 + C * D;
constexpr int G_R = G_G1 + D * LDP, G_K = G_R + C * D, G_W = G_K + C * D, G_DY = G_W + C * D;
constexpr int G_X2 = G_DY + C * LDP, G_VDY = G_X2 + C * D, G_B = G_VDY + C * C, G_SQ = G_B + C * D;
constexpr int G_Z = G_SQ + C * D, G_U = G_Z + D, G_FLOATS = G_U + C;
static_assert(WARPS * C * C <= G_G1, "KER partials must fit over S0, v and X1");

template <typename T>
__global__ void __launch_bounds__(THREADS, 2) wkv6_bwd_grad_kernel(Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  float *S0 = smem + G_S0, *X1 = smem + G_X1, *G1 = smem + G_G1, *X2 = smem + G_X2, *VDY = smem + G_VDY;
  float *Bt = smem + G_B, *SQ = smem + G_SQ, *Z = smem + G_Z, *U = smem + G_U, *KER = smem;
  const Rows s{smem + G_R, smem + G_K, smem + G_V, smem + G_W, smem + G_DY};
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;  // a chunk's heads run together
  const int warp = tid / 32, lane = tid % 32;
  const int bh = b * a.H + h, t0 = c * C, n = min(C, a.Tn - t0), H = a.H, Tn = a.Tn;
  const float* u = a.u + (size_t)h * D;

  // P0: the chunk's rows, S0 and G1
  {
    Pieces<T, THREADS> p;  // every load in flight before the first store
    load_rows(p, a, b, h, t0, n, true);
    const float* S0g = a.states + state_at(bh, a.NC, c, 0);
    const float* G1g = a.states + state_at(bh, a.NC, c, 1);
    constexpr int N4 = D * D / 4 / THREADS;
    float4 sv[N4], gv[N4];
#pragma unroll
    for (int j = 0; j < N4; ++j) {
      sv[j] = ld4(S0g + 4 * (tid + j * THREADS));
      gv[j] = ld4(G1g + 4 * (tid + j * THREADS));
    }
    store_rows(p, s);
#pragma unroll
    for (int j = 0; j < N4; ++j) {
      const int idx = tid + j * THREADS, i = idx / (D / 4), j4 = idx % (D / 4);
      *reinterpret_cast<float4*>(S0 + i * LDP + 4 * j4) = sv[j];
      *reinterpret_cast<float4*>(G1 + i * LDP + 4 * j4) = gv[j];
    }
  }
  __syncthreads();

  // P1: X1[t][i] = S0[i] . dy_t (warps 0-3) and X2[t][i] = G1[i] . v_t (warps 4-7): a thread 4 rows
  // (l % 16 + 16 m) x 4 steps (l / 16 + 8 n)
  {
    const int half = tid / (THREADS / 2), l = tid % (THREADS / 2), it = l % 16, tt = l / 16;
    const float* M = half ? G1 : S0;
    const float* V = half ? s.v : s.dy;
    float* X = half ? X2 : X1;
    float acc[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n4 = 0; n4 < 4; ++n4) acc[m][n4] = 0.f;
#pragma unroll 2
    for (int j4 = 0; j4 < D / 4; ++j4) {
      float4 mr[4], vr[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) mr[m] = ld4(M + (it + 16 * m) * LDP + 4 * j4);
#pragma unroll
      for (int n4 = 0; n4 < 4; ++n4) vr[n4] = ld4(V + (tt + 8 * n4) * LDP + 4 * j4);
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n4 = 0; n4 < 4; ++n4) acc[m][n4] = dot4(mr[m], vr[n4], acc[m][n4]);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n4 = 0; n4 < 4; ++n4) X[(tt + 8 * n4) * D + it + 16 * m] = acc[m][n4];
  }
  {  // v_sv . dy_t for sv = tid / 8, t = tid % 8 + 8 m
    const int sv = tid / 8, tq = tid % 8;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int j4 = 0; j4 < D / 4; ++j4) {
      const float4 vv = ld4(s.v + sv * LDP + 4 * j4);
#pragma unroll
      for (int m = 0; m < 4; ++m) acc[m] = dot4(vv, ld4(s.dy + (tq + 8 * m) * LDP + 4 * j4), acc[m]);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) VDY[sv * C + tq + 8 * m] = acc[m];
  }
  for (int t = warp; t < C; t += WARPS) {  // U_t = sum_i u_i r_t[i] k_t[i]
    float x = u[lane] * s.r[t * D + lane] * s.k[t * D + lane] +
              u[lane + 32] * s.r[t * D + lane + 32] * s.k[t * D + lane + 32];
#pragma unroll
    for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) U[t] = x;
  }
  // the walk's thread: row i, future steps of block q (lanes 4 r + q of a warp hold rows 8 warp + r)
  const int i = tid / 4, q = tid % 4;
  float Wall[NQ];  // each block's decay prod w_m of row i
  {
    float acc = 1.f;
#pragma unroll
    for (int m = QB - 1; m >= 0; --m) {  // SQ[t][i] = prod of w over the steps after t in t's block
      SQ[(q * QB + m) * D + i] = acc;
      acc *= s.w[(q * QB + m) * D + i];
    }
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq) Wall[qq] = __shfl_sync(0xffffffffu, acc, (lane & ~3) + qq);
    float after = 1.f;  // prod over the blocks after q
#pragma unroll
    for (int qq = NQ - 1; qq >= 0; --qq)
      if (qq > q) after *= Wall[qq];
#pragma unroll
    for (int m = 0; m < QB; ++m) Bt[(q * QB + m) * D + i] = SQ[(q * QB + m) * D + i] * after;
    float z = 0.f;  // Z[i] = S0[i] . G1[i]
#pragma unroll
    for (int j = 0; j < 4; ++j) z = dot4(ld4(S0 + i * LDP + 16 * q + 4 * j), ld4(G1 + i * LDP + 16 * q + 4 * j), z);
    z += __shfl_xor_sync(0xffffffffu, z, 1);
    z += __shfl_xor_sync(0xffffffffu, z, 2);
    if (q == 0) Z[i] = z;
  }
  __syncthreads();

  // P2: the walk.  sigma[m] = S_{t-1}[i] . dy_{8q+m}, rho = S_{t-1}[i] . G1[i]
  float sig[QB], rr[QB], ww[QB];
#pragma unroll
  for (int m = 0; m < QB; ++m) {
    sig[m] = X1[(q * QB + m) * D + i];
    rr[m] = s.r[(q * QB + m) * D + i];
    ww[m] = s.w[(q * QB + m) * D + i];
  }
  float rho = Z[i];
  const float ui = u[i];
  __syncthreads();  // X1 and S0 are read: KERP may overwrite them
  float* kerp = smem + warp * C * C;
  const int r8 = lane / 4;
  const bool b2 = lane & 16, b1 = lane & 8, b0 = lane & 4;
  for (int qt = 0; qt < NQ; ++qt) {  // the block of step t; its 8 steps unrolled
    const bool after = q > qt, same = q == qt;
    float mid = 1.f;  // the decays of the whole blocks between t's and this thread's
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq)
      if (qq > qt && qq < q) mid *= Wall[qq];
#pragma unroll
    for (int tt = 0; tt < QB; ++tt) {
      const int t = qt * QB + tt;
      const float kt = s.k[t * D + i], wt = s.w[t * D + i], bt = Bt[t * D + i], rt = s.r[t * D + i];
      const float x2 = X2[t * D + i], vtt = VDY[t * C + t];
      const float4 va = ld4(VDY + t * C + q * QB), vb = ld4(VDY + t * C + q * QB + 4);
      const float vd[QB] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};
      // E(t, 8q): the suffix of t's block times the blocks between; 1 in t's own block (from step t + 1)
      float e = after ? SQ[t * D + i] * mid : 1.f;
      float dwp = 0.f, dkp = 0.f, ker[QB];
#pragma unroll
      for (int m = 0; m < QB; ++m) {
        const bool live = m > tt ? after || same : after;  // step 8 q + m after t
        const float beta = live ? e * rr[m] : 0.f;
        dwp = fmaf(beta, sig[m], dwp);
        dkp = fmaf(beta, vd[m], dkp);
        ker[m] = kt * beta;
        if (live) e *= ww[m];
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        dwp += __shfl_xor_sync(0xffffffffu, dwp, o);
        dkp += __shfl_xor_sync(0xffffffffu, dkp, o);
      }
      if (t < n) {
        const size_t at = (((size_t)b * Tn + t0 + t) * H + h) * D + i;
        if (same) a.dr[at] = fmaf(ui * kt, vtt, sig[tt]);  // sigma_t[t], held by the thread of t's block
        if (q == (qt + 1) % NQ) a.dk[at] = fmaf(ui * rt, vtt, fmaf(bt, x2, dkp));
        if (q == (qt + 2) % NQ) a.dw[at] = fmaf(bt, rho, dwp);
      }
      rho = fmaf(wt, rho, kt * x2);
#pragma unroll
      for (int m = 0; m < QB; ++m) sig[m] = fmaf(wt, sig[m], kt * vd[m]);
      // KER partial over this warp's 8 rows: a transposing butterfly over lanes 4 r + q (r = 0 .. 7);
      // lane 4 r + q ends with the sum for step 8 q + r
      float k4[4], k2[2];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float send = b2 ? ker[m] : ker[m + 4], keep = b2 ? ker[m + 4] : ker[m];
        k4[m] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float send = b1 ? k4[m] : k4[m + 2], keep = b1 ? k4[m + 2] : k4[m];
        k2[m] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
      }
      const float send = b0 ? k2[0] : k2[1], keep = b0 ? k2[1] : k2[0];
      kerp[t * C + q * QB + r8] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
    }
  }
  __syncthreads();

  // P3: KER[t][s] = sum over the warps in order, plus U_t on the diagonal (dv's u term); k_t b_t over b_t
  for (int idx = tid; idx < C * D; idx += THREADS) Bt[idx] *= s.k[idx];
  for (int idx = tid; idx < C * C; idx += THREADS) {
    float x = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < WARPS; ++w8) x += smem[w8 * C * C + idx];
    if (idx / C == idx % C) x += U[idx / C];
    KER[idx] = x;
  }
  __syncthreads();

  // P4: dv[t][j] = sum_i k_t[i] b_t[i] G1[i][j] + sum_s KER[t][s] dy_s[j] (steps tt, tt + 16; columns 4 j4 ..)
  {
    const int j4 = tid % 16, tt = tid / 16;
    float4 d0 = make_float4(0.f, 0.f, 0.f, 0.f), d1 = d0;
#pragma unroll 2
    for (int i4 = 0; i4 < D / 4; ++i4) {
      const float4 b0 = ld4(Bt + tt * D + 4 * i4), b1 = ld4(Bt + (tt + 16) * D + 4 * i4);  // k_t b_t
      const float c0[4] = {b0.x, b0.y, b0.z, b0.w}, c1[4] = {b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float4 g = ld4(G1 + (4 * i4 + m) * LDP + 4 * j4);
        fma4(d0, c0[m], g);
        fma4(d1, c1[m], g);
      }
    }
#pragma unroll 2
    for (int s4 = 0; s4 < C / 4; ++s4) {
      const float4 e0 = ld4(KER + tt * C + 4 * s4), e1 = ld4(KER + (tt + 16) * C + 4 * s4);
      const float c0[4] = {e0.x, e0.y, e0.z, e0.w}, c1[4] = {e1.x, e1.y, e1.z, e1.w};
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float4 y = ld4(s.dy + (4 * s4 + m) * LDP + 4 * j4);
        fma4(d0, c0[m], y);
        fma4(d1, c1[m], y);
      }
    }
    if (tt < n)
      *reinterpret_cast<float4*>(a.dv + (((size_t)b * Tn + t0 + tt) * H + h) * D + 4 * j4) = d0;
    if (tt + 16 < n)
      *reinterpret_cast<float4*>(a.dv + (((size_t)b * Tn + t0 + tt + 16) * H + h) * D + 4 * j4) = d1;
  }
}

template <typename T>
int launch(const Args<T>& a, int B, cudaStream_t stream) {
  static bool smem_set = false;  // the kernels' shared-memory limits, raised once per process
  if (!smem_set) {
    // above 48 KB of shared memory, and the largest carveout: four sweep blocks, two grad blocks an SM
    cudaError_t err = cudaFuncSetAttribute(wkv6_bwd_sweep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           SW_FLOATS * 4);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(wkv6_bwd_sweep_kernel<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(wkv6_bwd_grad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, G_FLOATS * 4);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(wkv6_bwd_grad_kernel<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  wkv6_bwd_sweep_kernel<T><<<dim3(a.H, 2, B), SW_THREADS, SW_FLOATS * 4, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_grad_kernel<T><<<dim3(a.H, a.NC, B), THREADS, G_FLOATS * 4, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace


// Scratch size in floats for B x H heads over T steps: S0 and G1 at every chunk's edge.
extern "C" long long wkv6_bwd_scratch_floats(int B, int H, int Tn) {
  return (long long)B * H * ((Tn + C - 1) / C) * 2 * D * D;
}

// r/k/v (bf16 if in_bf16, else f32) and w (f32) share the element strides
// sb, sh, st of a [B, H, T, 64] view whose last dim is contiguous; dy (f32)
// has its own strides dsb, dsh, dst, last dim contiguous; every row of each
// starts on 16 bytes.  u [H, 64], s0
// and dS_final (nullptr: zero) [B, H, 64, 64] f32 contiguous, s0 and
// dS_final 16-byte aligned.  Writes dr, dk, dv, dw f32 contiguous in the
// [B, T, H, 64] layout (dv 16-byte aligned), du_part [B, H, 64], ds0
// [B, H, 64, 64] f32 (nullptr: not written; 16-byte aligned), using
// states (16-byte aligned) as scratch (wkv6_bwd_scratch_floats).  Two
// launches on the stream.  Returns the CUDA error code (0 = ok).
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v, const void* w, const void* u, const void* s0,
                        const void* dy, const void* ds_final, void* dr, void* dk, void* dv, void* dw, void* du_part,
                        void* ds0, void* states, int B, int H, int Tn, int head_dim, long long sb,
                        long long sh, long long st, long long dsb, long long dsh, long long dst, int in_bf16,
                        void* stream) {
  if (B <= 0 || H <= 0 || Tn <= 0 || head_dim != D || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  const long long per16 = in_bf16 ? 8 : 4;  // r/k/v elements in 16 bytes: every row starts on 16 bytes
  if (((uintptr_t)s0 | (uintptr_t)ds_final | (uintptr_t)ds0 | (uintptr_t)dv | (uintptr_t)states |
       (uintptr_t)r | (uintptr_t)k | (uintptr_t)v | (uintptr_t)w | (uintptr_t)dy) % 16 ||
      (sb | sh | st) % per16 || (dsb | dsh | dst) % 4)
    return (int)cudaErrorMisalignedAddress;
  const int NC = (Tn + C - 1) / C;
  Args<float> af{static_cast<const float*>(r), static_cast<const float*>(k), static_cast<const float*>(v),
                 static_cast<const float*>(w), static_cast<const float*>(u), static_cast<const float*>(s0),
                 static_cast<const float*>(dy), static_cast<const float*>(ds_final), static_cast<float*>(dr),
                 static_cast<float*>(dk), static_cast<float*>(dv), static_cast<float*>(dw),
                 static_cast<float*>(du_part), static_cast<float*>(ds0), static_cast<float*>(states), H, Tn, NC,
                 sb, sh, st, dsb, dsh, dst};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!in_bf16) return launch<float>(af, B, s);
  Args<bf16> ab{static_cast<const bf16*>(r), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                af.w, af.u, af.s0, af.dy, af.ds_final, af.dr, af.dk, af.dv, af.dw, af.du_part, af.ds0, af.states,
                H, Tn, NC, sb, sh, st, dsb, dsh, dst};
  return launch<bf16>(ab, B, s);
}
