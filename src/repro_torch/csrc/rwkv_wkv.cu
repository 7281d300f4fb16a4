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
// written once, 4 D^2 FLOP per (b, h, t) in f32 outside the tensor cores.
// At the prefill shape (B 4, H 64, T 1024, D 64) that is 239 MB against
// 4.3 GFLOP: bytes bound it (0.071 ms at 3.35 TB/s; 0.064 ms of f32
// operations at 67 TFLOP/s).  Design: the TPU kernel keeps S in VMEM
// across sequential time blocks; here one 64-thread block per (b, h)
// walks all of T itself, thread j holding column S[:, j] in 64 f32
// registers for the whole run, so S touches device memory only for s0
// and the final state.  Per step thread j needs r, k, w and u for every
// row i (broadcast reads from shared memory) and only its own v_j, so y_j
// needs no cross-thread reduction; four partial sums break the FMA chain.
// BT time steps of r/k/v/w are staged in shared memory per pass with
// coalesced loads (the counterpart of the TPU kernel's [BT, D] blocks);
// any T is taken, the last pass running the remainder.  The inputs are
// read through their element strides (b, h, t; the last dim contiguous),
// so the model's [B, T, H, D] activations need no copy; y is written in
// the [B, T, H, D] layout the model reads back.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int D = 64;   // head size: one thread per state column
constexpr int BT = 32;  // time steps staged per pass (4 x 8 KB of shared memory)

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(D) wkv6_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, const float* __restrict__ s0,
    float* __restrict__ y, float* __restrict__ s_final, int H, int Tn, long long sb, long long sh,
    long long st) {
  __shared__ __align__(16) float sr[BT][D];
  __shared__ __align__(16) float sk[BT][D];
  __shared__ __align__(16) float sw[BT][D];
  __shared__ float sv[BT][D];
  __shared__ __align__(16) float su[D];

  const int h = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const long long in0 = (long long)b * sb + (long long)h * sh + j;
  const size_t state0 = ((size_t)b * H + h) * D * D + j;  // S[b, h, 0, j]
  su[j] = u[h * D + j];

  float s[D];
#pragma unroll
  for (int i = 0; i < D; ++i) s[i] = s0 ? s0[state0 + (size_t)i * D] : 0.f;

  for (int t0 = 0; t0 < Tn; t0 += BT) {
    const int nt = min(BT, Tn - t0);
    __syncthreads();  // every thread is done reading the previous pass
    for (int tt = 0; tt < nt; ++tt) {
      const long long off = in0 + (long long)(t0 + tt) * st;
      sr[tt][j] = widen(r[off]);
      sk[tt][j] = widen(k[off]);
      sv[tt][j] = widen(v[off]);
      sw[tt][j] = w[off];
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float vj = sv[tt][j];
      float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
#pragma unroll
      for (int i = 0; i < D; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&sr[tt][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&sk[tt][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&sw[tt][i]);
        const float4 u4 = *reinterpret_cast<const float4*>(&su[i]);
        float kv;
        kv = k4.x * vj;
        y0 = fmaf(r4.x, fmaf(u4.x, kv, s[i]), y0);
        s[i] = fmaf(w4.x, s[i], kv);
        kv = k4.y * vj;
        y1 = fmaf(r4.y, fmaf(u4.y, kv, s[i + 1]), y1);
        s[i + 1] = fmaf(w4.y, s[i + 1], kv);
        kv = k4.z * vj;
        y2 = fmaf(r4.z, fmaf(u4.z, kv, s[i + 2]), y2);
        s[i + 2] = fmaf(w4.z, s[i + 2], kv);
        kv = k4.w * vj;
        y3 = fmaf(r4.w, fmaf(u4.w, kv, s[i + 3]), y3);
        s[i + 3] = fmaf(w4.w, s[i + 3], kv);
      }
      y[(((size_t)b * Tn + t0 + tt) * H + h) * D + j] = (y0 + y1) + (y2 + y3);
    }
  }

#pragma unroll
  for (int i = 0; i < D; ++i) s_final[state0 + (size_t)i * D] = s[i];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u, const void* s0,
           void* y, void* s_final, int B, int H, int Tn, long long sb, long long sh, long long st,
           cudaStream_t stream) {
  wkv6_kernel<T><<<dim3(H, B), D, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(s_final), H, Tn, sb, sh, st);
  return (int)cudaGetLastError();
}

}  // namespace

// r/k/v (bf16 if in_bf16, else f32) and w (f32) share the element
// strides sb, sh, st of a [B, H, T, 64] view whose last dim is contiguous;
// u [H, 64], s0 (nullptr: start from zero) and s_final [B, H, 64, 64] f32
// contiguous; y f32 contiguous in the [B, T, H, 64] layout.  Returns the
// CUDA error code (0 = ok).
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v, const void* w, const void* u,
                        const void* s0, void* y, void* s_final, int B, int H, int Tn, int head_dim,
                        long long sb, long long sh, long long st, int in_bf16, void* stream) {
  if (B <= 0 || H <= 0 || Tn <= 0 || head_dim != D || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) return launch<bf16>(r, k, v, w, u, s0, y, s_final, B, H, Tn, sb, sh, st, s);
  return launch<float>(r, k, v, w, u, s0, y, s_final, B, H, Tn, sb, sh, st, s);
}
