// Flash attention forward with causal mask, sliding window and GQA (kernel K4).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py,
// flash_attention_pallas (body _kernel): online-softmax attention over
// q [B, H, Sq, D] (already scaled by D^-0.5 in its own dtype),
// k/v [B, K, Skv, D], bf16, query head h reading kv head h / (H / K),
// query row i at absolute position i + Skv - Sq.  Masked logits take
// NEG = -1e30 (not -inf), so a fully masked row gives uniform weights;
// p is rounded to bf16 before the PV product and the output is
// acc / max(l, 1e-30) in bf16, as in the TPU kernel.
//
// What bounds it on an H100: at the prefill shape (B=4, H=32, K=8,
// S=256, D=128) it does ~2.2e10 FLOP on 34 MB, a few microseconds
// either way; launch and the serial softmax pass dominate.  Design: one
// 128-thread block per (b, h, 64-row q tile), each warp owning 16 query
// rows.  S = Q K^T and O += P V run as bf16 WMMA 16x16x16 products with
// f32 accumulators; the running max and sum are one float per row (the
// TPU kernel replicates them over 128 lanes only for its layout), and
// the f32 O tile lives in shared memory so a warp can rescale its rows
// before each PV product.  KV tiles wholly past the causal limit or
// wholly before every row's window are skipped; they would only add
// exact zeros after the online rescale.  Ragged q and kv edges are
// masked in the kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 128;  // 4 warps x 16 query rows
constexpr float NEG = -1e30f;
constexpr int LDS = BKV + 4;  // f32 logits pitch
constexpr int LDP = BKV + 8;  // bf16 probabilities pitch

template <int D>
struct Layout {
  static constexpr int LDQ = D + 8;  // bf16 pitch of Q, K, V tiles
  static constexpr int LDO = D + 4;  // f32 pitch of the O tile
  static constexpr size_t q = 0;
  static constexpr size_t k = q + (size_t)BQ * LDQ * 2;
  static constexpr size_t v = k + (size_t)BKV * LDQ * 2;
  static constexpr size_t s = v + (size_t)BKV * LDQ * 2;
  static constexpr size_t p = s + (size_t)BQ * LDS * 4;
  static constexpr size_t o = p + (size_t)BQ * LDP * 2;
  static constexpr size_t stats = o + (size_t)BQ * LDO * 4;  // m, l, scale: 3 x BQ floats
  static constexpr size_t bytes = stats + 3 * BQ * 4;
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [r0, r0 + rows) of a row-major [S, D] matrix into smem pitch ld; rows >= S zero.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0, int rows, int S, int ld) {
  for (int i = threadIdx.x; i < rows * D / 8; i += THREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, int H, int KH, int Sq, int Skv, int causal, int window) {
  typedef Layout<D> L;
  constexpr int LDQ = L::LDQ, LDO = L::LDO;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::p);
  float* sO = reinterpret_cast<float*>(smem + L::o);
  float* sM = reinterpret_cast<float*>(smem + L::stats);
  float* sL = sM + BQ;
  float* sScale = sL + BQ;

  const int q0 = blockIdx.x * BQ, hh = blockIdx.y, b = blockIdx.z;
  const int kh = hh / (H / KH);
  const int q_offset = Skv - Sq;
  const bf16* qb = q + ((size_t)b * H + hh) * Sq * D;
  const bf16* kb = k + ((size_t)b * KH + kh) * Skv * D;
  const bf16* vb = v + ((size_t)b * KH + kh) * Skv * D;
  bf16* ob = o + ((size_t)b * H + hh) * Sq * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = warp * 16;

  load_rows<D>(sQ, qb, q0, BQ, Sq, LDQ);
  for (int i = threadIdx.x; i < BQ * LDO; i += THREADS) sO[i] = 0.f;
  if (threadIdx.x < BQ) {
    sM[threadIdx.x] = NEG;
    sL[threadIdx.x] = 0.f;
  }

  // KV tiles some row of this q tile can see
  const int q_last = min(q0 + BQ, Sq) - 1 + q_offset;
  const int kv_hi = causal ? min(Skv, q_last + 1) : Skv;
  int kv_lo = window > 0 ? max(0, q0 + q_offset - window + 1) : 0;
  kv_lo = (kv_lo / BKV) * BKV;

  for (int k0 = kv_lo; k0 < kv_hi; k0 += BKV) {
    __syncthreads();  // the previous tile's K/V reads are done
    load_rows<D>(sK, kb, k0, BKV, Skv, LDQ);
    load_rows<D>(sV, vb, k0, BKV, Skv, LDQ);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows
    for (int j = 0; j < BKV / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.f);
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, sQ + r0 * LDQ + kk, LDQ);
        wmma::load_matrix_sync(bt, sK + (16 * j) * LDQ + kk, LDQ);
        wmma::mma_sync(s, a, bt, s);
      }
      wmma::store_matrix_sync(sS + r0 * LDS + 16 * j, s, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax, one row at a time; lanes cover columns lane and lane + 32
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
      const int qpos = q0 + r + q_offset;
      float sv[2];
      bool in_range[2];
      for (int t = 0; t < 2; ++t) {
        const int c = lane + 32 * t, kpos = k0 + c;
        in_range[t] = kpos < Skv;
        bool keep = in_range[t];
        if (causal) keep = keep && kpos <= qpos;
        if (window > 0) keep = keep && qpos - kpos < window;
        sv[t] = keep ? sS[r * LDS + c] : NEG;
      }
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(sv[0], sv[1])));
      const float p0 = in_range[0] ? expf(sv[0] - m_new) : 0.f;
      const float p1 = in_range[1] ? expf(sv[1] - m_new) : 0.f;
      const float sum = warp_sum(p0 + p1);
      sP[r * LDP + lane] = __float2bfloat16(p0);
      sP[r * LDP + lane + 32] = __float2bfloat16(p1);
      if (lane == 0) {
        const float scale = expf(m_prev - m_new);
        sScale[r] = scale;
        sL[r] = sL[r] * scale + sum;
        sM[r] = m_new;
      }
      __syncwarp();
    }

    // rescale this warp's O rows, then O += P V
    for (int i = lane; i < 16 * D; i += 32) {
      const int rr = i / D, c = i % D;
      sO[(r0 + rr) * LDO + c] *= sScale[r0 + rr];
    }
    __syncwarp();
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sO + r0 * LDO + 16 * j, LDO, wmma::mem_row_major);
      for (int kk = 0; kk < BKV; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vt;
        wmma::load_matrix_sync(pa, sP + r0 * LDP + kk, LDP);
        wmma::load_matrix_sync(vt, sV + kk * LDQ + 16 * j, LDQ);
        wmma::mma_sync(acc, pa, vt, acc);
      }
      wmma::store_matrix_sync(sO + r0 * LDO + 16 * j, acc, LDO, wmma::mem_row_major);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < BQ * D / 2; i += THREADS) {
    const int r = i / (D / 2), c = (i % (D / 2)) * 2;
    if (q0 + r < Sq) {
      const float l = fmaxf(sL[r], 1e-30f);
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)(q0 + r) * D + c) =
          __floats2bfloat162_rn(sO[r * LDO + c] / l, sO[r * LDO + c + 1] / l);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KH, int Sq,
           int Skv, int causal, int window, cudaStream_t stream) {
  const size_t smem = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_kernel<D><<<dim3((Sq + BQ - 1) / BQ, H, B), THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), H, KH, Sq, Skv, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// q/o [B, H, Sq, D], k/v [B, KH, Skv, D], contiguous bf16; window <= 0
// means none.  Returns the CUDA error code (0 = ok).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                   int H, int KH, int Sq, int Skv, int D, int causal, int window,
                                   void* stream) {
  if (B <= 0 || KH <= 0 || H % KH || Sq <= 0 || Skv <= 0 || Sq > Skv) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, o, B, H, KH, Sq, Skv, causal, window, s);
    case 32: return launch<32>(q, k, v, o, B, H, KH, Sq, Skv, causal, window, s);
    case 64: return launch<64>(q, k, v, o, B, H, KH, Sq, Skv, causal, window, s);
    case 128: return launch<128>(q, k, v, o, B, H, KH, Sq, Skv, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
