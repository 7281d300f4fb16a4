// Flash attention forward with causal mask, sliding window and GQA (kernel K4).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py,
// flash_attention_pallas (body _kernel): online-softmax attention over
// q [B, H, Sq, D], k/v [B, K, Skv, D], bf16, query head h reading kv head
// h / (H / K), query row i at absolute position i + Skv - Sq.  q is scaled
// in the kernel's Q load with the caller's two bf16 rounding points,
// bf16(bf16(q * s1) * s2): s1 = 1 and s2 = D^-0.5 is the JAX wrapper's own
// scaling; the model passes its pre-scaled q with s1 = D^0.5 (JAX's
// attn_flash undoes its pre-scale in the working dtype first).  Masked
// logits take NEG = -1e30 (not -inf), so a row that sees no key averages
// them all; p is rounded to bf16 before the PV product and the output is
// acc / max(l, 1e-30) in bf16, as in the TPU kernel.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s): at the prefill
// shape (B=4, H=32, K=8, S=256, D=128, causal) it does 2.15e9 FLOP on 21 MB
// (q, k, v read once, o written once): 6.3 us of bytes against 2.2 us of
// operations.  The tensor cores are not the limit: the kernel has to
// stream its tiles without stalls, keep each block's serial softmax short,
// and cost the host little per call.
//
// Design (Hopper only, sm_90a; the wgmma.mma_async wrappers and the other
// PTX building blocks are in hopper.cuh):
// - GQA: a block serves HPB query heads that read one kv head, one consumer
//   warpgroup each, so each K/V tile it loads serves all of them.  The grid
//   follows the group H / K: where it is even (Mixtral's 4), HPB = 2 and a
//   block also pairs the q tiles, taking the q tile with the most KV tiles
//   and the one with the fewest in two passes, so every block does about the
//   same work (at the prefill shape 128 blocks of 5 KV steps, one wave on 132
//   SMs); where it is odd, HPB = 1, a block per query head and q tile.  A
//   pass starts with the q tile's longest KV range.  (A block per kv head, 4
//   warpgroups, and a block per query head measured slower at the prefill
//   shape: PERF.md §6.)
// - No tensor maps: q, k, v change on every call and each map costs
//   microseconds of host time to encode (PERF.md §6, on the H100 named there).
//   Every thread copies its share of each K/V tile with 16-byte cp.async
//   straight into the 128-byte-swizzled layout wgmma reads, through the views'
//   strides, so the model's [B, S, H, D] projections (handed over as
//   [B, H, S, D] views) are read in place.  A ring of KV stages (4, 2 at HPB = 1)
//   completes on `full` mbarriers through cp.async.mbarrier.arrive; a stage is
//   refilled once every consumer warp has released it on `empty`.  Where a
//   block's two passes together need no more KV tiles than the ring holds (the
//   prefill shape), each tile is loaded once and both passes read it.  Rows
//   past Skv and columns past D zero-fill: a head size D (a multiple of 8 up
//   to 128) is held as a tile of DP = 64 or 128 columns, each row's 16-byte
//   copies stopping at column D, so a load never reads into the next head of
//   a [B, S, H, D] view (h2o-danube's D = 120); the zero columns add nothing
//   to Q K^T, o's columns past D are not stored, and the scale is the
//   caller's, from the true D.
// - Each consumer loads and scales its head's Q rows itself (both roundings
//   in registers), requested before the KV tiles so they arrive first, and
//   stores them swizzled for wgmma.  No producer warp: at the prefill shape
//   a block's whole KV range is requested at once, so there is nothing to
//   keep in flight.
// - S = Q K^T is wgmma m64n64k16 from shared memory (K [64, D] row-major is
//   the K-major B operand, no transpose), its first product with scale-d =
//   0.  The warpgroups of a block issue their S products in turn (named
//   barriers), so one warpgroup's softmax runs while the tensor cores serve
//   the next.  The online softmax runs on the S accumulator in registers: a
//   row's 64 values sit in the 4 threads of a quad, so its max takes two
//   shuffles; exp(x - m) is the hardware's 2^((x - m) log2 e); the running
//   sum stays per thread until the end.  KV tiles wholly past the causal
//   limit or before every row's window are not loaded; only tiles that
//   straddle a limit are masked, from one column interval per row.
// - O += P V is wgmma with A from registers: P is rounded to bf16 and its
//   accumulator fragment repacked as the A fragment (the two layouts agree);
//   V [64, D] is MN-major, read with the transpose-B flag.  O stays in f32
//   registers and is rescaled there; the epilogue divides by the row sum,
//   stages O as bf16 in shared memory and stores whole 16-byte pieces of its
//   rows through o's strides.

#include "hopper.cuh"

#ifdef K4_PHASES
// A timeline of the kernel for `python -m repro_torch.kernels.flash_attention.phases`,
// which builds this source with -DK4_PHASES: the first thread of each warpgroup stamps
// clock64 at each phase (slots: 0 start, 1 Q stored, 2 + 4 g .. 5 + 4 g for
// the first 6 KV steps g: tile ready, S done, softmax done, PV done; 28 + p
// pass p stored; 30, 31 globaltimer at start and end).
__device__ unsigned long long k4_phase[1024 * 2 * 32];
#define K4_STAMP(slot, clock)                                                                          \
  do {                                                                                                 \
    if (tid == 0) {                                                                                    \
      unsigned long long t_;                                                                           \
      asm volatile("mov.u64 %0, %%" clock ";" : "=l"(t_));                                             \
      const unsigned blk_ = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;             \
      if (blk_ < 1024) k4_phase[(blk_ * 2 + w) * 32 + (slot)] = t_;                                    \
    }                                                                                                  \
  } while (0)
#else
#define K4_STAMP(slot, clock) ((void)0)
#endif

namespace {

constexpr int BQ = 64;   // query rows per block: one warpgroup's wgmma rows
constexpr int BKV = 64;  // keys per KV tile
constexpr int TILE_BYTES = 64 * SWIZZLE_BYTES;  // a swizzled [64 rows, 64 columns] box: 8 KB
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int TURN = 3;  // named barriers TURN, TURN + 1 order the warpgroups' S products (1, 2: Q stores)

template <int DP_, int HPB>
struct Tiles {
  static constexpr int PASSES = HPB == 2 ? 2 : 1;     // HPB = 2: two q tiles per block, a long and a short one
  static constexpr int DP = DP_;                      // columns held: D rounded up to whole 64-column boxes
  static constexpr int NBOX = DP / BOX;
  static constexpr int Q_BYTES = NBOX * TILE_BYTES;   // one head's [64, DP] Q tile
  static constexpr int KV_BYTES = NBOX * TILE_BYTES;  // a [64, DP] K or V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;    // K, then V
  static constexpr int STAGES = HPB == 1 ? 2 : 4;     // HPB = 1: two blocks per SM
  static constexpr int THREADS = 128 * HPB;
  static constexpr int SMEM = 1024 + PASSES * HPB * Q_BYTES + STAGES * STAGE_BYTES + 2 * STAGES * 8;
};

struct Strides {
  long long b, h, s;  // elements; D has a unit stride
};

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  Strides sq, sk, sv, so;
  int H, KH, Sq, Skv, D, causal, window;  // window < 0: none; D <= DP, a multiple of 8
  float s1, s2;                        // q is read as bf16(bf16(q * s1) * s2)
};

// 16 bytes from global `src` to shared `dst`; zeros when !valid (no bytes read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// Arrive on `bar` once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Rows [r0, r0 + 64) of one (b, head) of a [.., S, D] view (row stride rs)
// into the swizzled [64, DP] tile at shared address `dst`, thread t of nt
// copying its share; rows past S and columns past D are zeros.
template <int DP>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* base, long long rs, int r0, int S, int D, int t,
                                          int nt) {
  constexpr int CH = DP / 8;  // 16-byte chunks per row
  for (int i = t; i < 64 * CH; i += nt) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = r0 + r < S && c < D;
    cp_async16(dst + (c / BOX) * TILE_BYTES + swizzled(r, c % BOX), ok ? base + (r0 + r) * rs + c : base, ok);
  }
}


// 2^x, flushing results below 2^-126 to zero.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One online-softmax step on a tile's logits s (this thread's values of rows
// a and b): mask when asked (keys past Skv -inf, so weight 0; other masked
// keys NEG), update the running max m and sum l (this thread's part), and
// leave p = exp(x - m) in s and the factors that rescale the earlier sums
// in corr.  exp(x - m) is taken as 2^((x - m) log2 e): the difference
// first, exact where x = m, so a row whose logits are all NEG gets weights
// of exactly 1 (x log2 e - m log2 e, fused, would leave the rounding error
// of m log2 e, ~1e23 at |m| = 1e30).
__device__ __forceinline__ void softmax_step(float (&s)[BKV / 2], bool mask, int sk, int lo_a, int hi_a, int lo_b,
                                             int hi_b, int lane, float& m_a, float& m_b, float& l_a, float& l_b,
                                             float& corr_a, float& corr_b) {
  if (mask) {  // row a keeps the tile-local columns [lo_a, hi_a) below sk, row b [lo_b, hi_b)
    const int cb = 2 * (lane % 4);  // this thread's first column: bounds move, columns stay constants
    sk -= cb;
    lo_a -= cb;
    hi_a -= cb;
    lo_b -= cb;
    hi_b -= cb;
    if (sk >= BKV - cb && lo_a <= 0 && lo_b <= 0) {  // only the causal limit cuts: one compare a value
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (8 * j + (t & 1) >= (t < 2 ? hi_a : hi_b)) s[4 * j + t] = NEG;
    } else {
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int c = 8 * j + (t & 1), lo = t < 2 ? lo_a : lo_b, hi = t < 2 ? hi_a : hi_b;
          const float x = s[4 * j + t];
          s[4 * j + t] = c >= sk ? -__int_as_float(0x7f800000) : c >= lo && c < hi ? x : NEG;
        }
    }
  }
  // row max over the quad: this thread's 16 values, then two shuffles (one
  // running value per row: the registers go to O, S and P)
  float mx_a = m_a, mx_b = m_b;
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) {
    mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
    mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
  corr_a = ex2((m_a - mx_a) * LOG2E);
  corr_b = ex2((m_b - mx_b) * LOG2E);
  m_a = mx_a;
  m_b = mx_b;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) {
    s[4 * j] = ex2((s[4 * j] - m_a) * LOG2E);
    s[4 * j + 1] = ex2((s[4 * j + 1] - m_a) * LOG2E);
    s[4 * j + 2] = ex2((s[4 * j + 2] - m_b) * LOG2E);
    s[4 * j + 3] = ex2((s[4 * j + 3] - m_b) * LOG2E);
    sum_a += s[4 * j] + s[4 * j + 1];
    sum_b += s[4 * j + 2] + s[4 * j + 3];
  }
  l_a = l_a * corr_a + sum_a;
  l_b = l_b * corr_b + sum_b;
}

// A row at position p sees the keys [lo(p), hi(p)); both bounds grow with p.
__device__ __forceinline__ int lo_of(const Args& a, int p) { return a.window >= 0 ? max(0, p - a.window + 1) : 0; }
__device__ __forceinline__ int hi_of(const Args& a, int p) { return a.causal ? min(a.Skv, p + 1) : a.Skv; }

// Query rows [q0, q0 + 64) and the KV tiles [kv_lo, kv_lo + 64 n) some row of
// them sees: the first and last rows bound every row's interval.  A row that
// sees no key (`blind`) averages all of them, as the reference: then the
// span is every KV tile.
struct Span {
  int q0, kv_lo, n;
  bool blind;
};

__device__ __forceinline__ Span span_of(const Args& a, int qt) {
  Span sp;
  sp.q0 = qt * BQ;
  const int p_first = sp.q0 + a.Skv - a.Sq, p_last = min(sp.q0 + BQ, a.Sq) - 1 + a.Skv - a.Sq;
  sp.blind = lo_of(a, p_first) >= hi_of(a, p_first) || lo_of(a, p_last) >= hi_of(a, p_last);
  sp.kv_lo = sp.blind ? 0 : lo_of(a, p_first) / BKV * BKV;
  sp.n = ((sp.blind ? a.Skv : hi_of(a, p_last)) - sp.kv_lo + BKV - 1) / BKV;
  return sp;
}

template <int DP, int HPB>
__global__ void __launch_bounds__(Tiles<DP, HPB>::THREADS, 1) k4_flash_fwd_kernel(const Args a) {
  typedef Tiles<DP, HPB> T;
  const int D = a.D;
  const int n_qt = (a.Sq + BQ - 1) / BQ, b = blockIdx.z;
  const int h0 = blockIdx.y * HPB, kh = h0 / (a.H / a.KH);
  // the block's q tiles, one per pass, the one with the most KV tiles first:
  // tile n_qt - 1 - x, and with two passes also tile x (when it is another)
  const int qt1 = T::PASSES == 2 && (int)blockIdx.x < n_qt - 1 - (int)blockIdx.x ? blockIdx.x : -1;
  const Span sp0 = span_of(a, n_qt - 1 - blockIdx.x), sp1 = qt1 >= 0 ? span_of(a, qt1) : Span{0, sp0.kv_lo, 0, false};
  const int total = sp0.n + sp1.n;  // KV steps of the whole block
  // Two passes whose KV spans together fit the ring load each tile of their
  // union once and both read it in place (`resident`); otherwise the
  // passes' steps stream through the ring in turn.
  const int u_lo = min(sp0.kv_lo, sp1.kv_lo);
  const bool resident =
      T::PASSES == 2 && max(sp0.kv_lo + sp0.n * BKV, sp1.kv_lo + sp1.n * BKV) - u_lo <= T::STAGES * BKV;

  unsigned char* smem = ring_base();
  unsigned char* ring = smem + T::PASSES * HPB * T::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + T::STAGES * T::STAGE_BYTES);
  uint64_t* empty = full + T::STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], T::THREADS);  // every thread's copies of the stage
      mbar_init(&empty[s], 4 * HPB);    // every consumer warp's release
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto step_k0 = [&](int g) {  // the first key of KV step g: the passes' spans in turn
    return g < sp0.n ? sp0.kv_lo + g * BKV : sp1.kv_lo + (g - sp0.n) * BKV;
  };
  auto load_kv = [&](int s, int k0) {  // this thread's share of the KV tile at key k0 into stage s, on full[s]
    const uint32_t st = smem_u32(ring + s * T::STAGE_BYTES);
    load_tile<T::DP>(st, a.k + b * a.sk.b + kh * a.sk.h, a.sk.s, k0, a.Skv, D, threadIdx.x, T::THREADS);
    load_tile<T::DP>(st + T::KV_BYTES, a.v + b * a.sv.b + kh * a.sv.h, a.sv.s, k0, a.Skv, D, threadIdx.x, T::THREADS);
    cp_async_arrive(&full[s]);
  };

  // consumer warpgroup w: query head h0 + w.  Its Q rows are requested
  // first, then the block's first KV tiles, so Q and K arrive first; then
  // Q is scaled with both roundings, bf16(bf16(q * s1) * s2), and stored.
  const int w = threadIdx.x / 128, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int hh = h0 + w;
  K4_STAMP(0, "clock64");
  K4_STAMP(30, "globaltimer");
  {
    constexpr int CH = T::DP / 8, PER = BQ * CH / 128;  // 16-byte chunks per row, per thread
    const bf16* qb = a.q + b * a.sq.b + hh * a.sq.h;
    uint4 val[T::PASSES][PER];
#pragma unroll
    for (int pass = 0; pass < T::PASSES; ++pass) {
      const int q0 = pass ? qt1 * BQ : sp0.q0;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int i = tid + 128 * j, r = i / CH, c = (i % CH) * 8;
        val[pass][j] = (pass == 0 || qt1 >= 0) && q0 + r < a.Sq && c < D
                           ? *reinterpret_cast<const uint4*>(qb + (q0 + r) * a.sq.s + c)
                           : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    if (resident)
      for (int u = 0; u * BKV < max(sp0.kv_lo + sp0.n * BKV, sp1.kv_lo + sp1.n * BKV) - u_lo; ++u)
        load_kv(u, u_lo + u * BKV);
    else
      for (int g = 0; g < min(total, T::STAGES); ++g) load_kv(g, step_k0(g));
#pragma unroll
    for (int pass = 0; pass < T::PASSES; ++pass) {
      unsigned char* sQ = smem + (pass * HPB + w) * T::Q_BYTES;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int i = tid + 128 * j, r = i / CH, c = (i % CH) * 8;
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&val[pass][j]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float2 f = __bfloat1622float2(p[u]);
          f = __bfloat1622float2(__floats2bfloat162_rn(f.x * a.s1, f.y * a.s1));
          p[u] = __floats2bfloat162_rn(f.x * a.s2, f.y * a.s2);
        }
        *reinterpret_cast<uint4*>(sQ + (c / BOX) * TILE_BYTES + swizzled(r, c % BOX)) = val[pass][j];
      }
    }
    fence_async_smem();
    named_barrier(1 + w, 128);
  }
  K4_STAMP(1, "clock64");

  const int ra = 16 * warp + lane / 4;  // this thread's rows of a q tile: ra and ra + 8
  if (HPB > 1 && w == HPB - 1) named_barrier_arrive(TURN, 256);  // warpgroup 0 goes first
  int g = 0;                                                      // the block's KV step
#pragma unroll 1
  for (int pass = 0; pass < T::PASSES; ++pass) {
    if (pass && qt1 < 0) break;
    const Span sp = pass ? sp1 : sp0;
    unsigned char* sQ = smem + (pass * HPB + w) * T::Q_BYTES;
    float acc[T::DP / 2];                      // O, f32, in the accumulator layout
    float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;  // running max and sum
    for (int t = 0; t < sp.n; ++t, ++g) {
      const int s = resident ? (sp.kv_lo - u_lo) / BKV + t : g % T::STAGES, k0 = sp.kv_lo + t * BKV;
      mbar_wait(&full[s], resident ? 0 : (g / T::STAGES) & 1);
      if (g < 6) K4_STAMP(2 + 4 * g, "clock64");
      const unsigned char* sK = ring + s * T::STAGE_BYTES;
      // descriptors of the tiles' starts; each k16 step adds its offset (in 16-byte
      // units) to the address field
      const uint64_t dq = smem_desc(sQ, 0), dk = smem_desc(sK, 0);

      // S = Q K^T, issued in turn: warpgroup w waits for w - 1 to have issued
      // its own, so the products finish one warpgroup after another and one
      // warpgroup's softmax runs while the tensor cores serve the next
      float sc[BKV / 2];
      if (HPB > 1) named_barrier(TURN + w, 256);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T::DP / 16; ++kk) {
        const int step = ((kk / 4) * TILE_BYTES + (kk % 4) * 32) >> 4;
        wgmma_ss<BKV, 0, 0>(sc, dq + step, dk + step, kk);
      }
      wgmma_commit();
      if (HPB > 1 && (w + 1 < HPB || g + 1 < total)) named_barrier_arrive(TURN + (w + 1) % HPB, 256);
      wgmma_wait<0>();
      fence_regs(sc);
      if (g < 6) K4_STAMP(3 + 4 * g, "clock64");

      // mask only a tile that some row's interval does not cover
      const int q0 = sp.q0, off = a.Skv - a.Sq, p = q0 + ra + off;
      const bool mask = sp.blind || k0 + BKV > a.Skv || k0 < lo_of(a, min(q0 + BQ, a.Sq) - 1 + off) ||
                        k0 + BKV > hi_of(a, q0 + off);
      float corr_a, corr_b;
      softmax_step(sc, mask, a.Skv - k0, lo_of(a, p) - k0, hi_of(a, p) - k0, lo_of(a, p + 8) - k0,
                   hi_of(a, p + 8) - k0, lane, m_a, m_b, l_a, l_b, corr_a, corr_b);
      if (t > 0) {
#pragma unroll
        for (int j = 0; j < T::DP / 8; ++j) {
          acc[4 * j] *= corr_a;
          acc[4 * j + 1] *= corr_a;
          acc[4 * j + 2] *= corr_b;
          acc[4 * j + 3] *= corr_b;
        }
      }

      // O += P V: P as the A fragment of four k16 steps (bf16 pairs, the accumulator layout)
      uint32_t pf[BKV / 16][4];
#pragma unroll
      for (int kc = 0; kc < BKV / 16; ++kc)
#pragma unroll
        for (int r = 0; r < 4; ++r) pf[kc][r] = pack_bf16(sc[8 * kc + 2 * r], sc[8 * kc + 2 * r + 1]);
      if (g < 6) K4_STAMP(4 + 4 * g, "clock64");
      const uint64_t dv = smem_desc(sK + T::KV_BYTES, TILE_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BKV / 16; ++kc)
        wgmma_rs<T::DP, 1>(acc, pf[kc], dv + (kc * 16 * SWIZZLE_BYTES >> 4), t > 0 || kc > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (g < 6) K4_STAMP(5 + 4 * g, "clock64");

      if (!resident) {
        if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
        if (g + T::STAGES < total) {            // refill it once every consumer warp is
          mbar_wait(&empty[s], (g / T::STAGES) & 1);
          load_kv(s, step_k0(g + T::STAGES));
        }
      }
    }

    l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
    // one division per row, then products: acc / l within an f32 ulp.  O is
    // staged as bf16 in this pass's Q tile (its products are done with it)
    // and stored in 16-byte pieces of whole rows: stored from the
    // accumulator layout, every 4-byte store would touch 8 rows.
    const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
    for_fragment<T::DP>(tid, [&](int i, int r, int c) {
      const float inv = r == ra ? inv_a : inv_b;
      *reinterpret_cast<__nv_bfloat162*>(sQ + (c / BOX) * TILE_BYTES + swizzled(r, c % BOX)) =
          __floats2bfloat162_rn(acc[i] * inv, acc[i + 1] * inv);
    });
    named_barrier(1 + w, 128);
    constexpr int CH = T::DP / 8;
    bf16* ob = a.o + b * a.so.b + hh * a.so.h;
    for (int i = tid; i < BQ * CH; i += 128) {
      const int r = i / CH, c = (i % CH) * 8;
      if (sp.q0 + r < a.Sq && c < D)
        *reinterpret_cast<uint4*>(ob + (sp.q0 + r) * a.so.s + c) =
            *reinterpret_cast<const uint4*>(sQ + (c / BOX) * TILE_BYTES + swizzled(r, c % BOX));
    }
    K4_STAMP(28 + pass, "clock64");
  }
  K4_STAMP(31, "globaltimer");
}

template <int DP, int HPB>
int launch(const Args& a, int B, cudaStream_t stream) {
  typedef Tiles<DP, HPB> T;
  static bool smem_set = false;
  const cudaError_t err = allow_smem(k4_flash_fwd_kernel<DP, HPB>, T::SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (a.Sq + BQ - 1) / BQ;
  k4_flash_fwd_kernel<DP, HPB><<<dim3((n_qt + T::PASSES - 1) / T::PASSES, a.H / HPB, B), T::THREADS, T::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int HPB>
int launch_d(const Args& a, int B, cudaStream_t stream) {
  return a.D <= BOX ? launch<BOX, HPB>(a, B, stream) : launch<2 * BOX, HPB>(a, B, stream);
}

}  // namespace

// q/o [B, H, Sq, D], k/v [B, KH, Skv, D] bf16 with a unit stride in D, D a
// multiple of 8 from 8 to 128;
// strides holds the element strides (b, h, s) of q, k, v and o, in that
// order; q, k, v start 16-byte aligned with strides that are multiples of 8
// elements.  q is read as bf16(bf16(q * s1) * s2).  window < 0 means none.
// Returns the CUDA error code (0 = ok).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, const long long* strides,
                                   int B, int H, int KH, int Sq, int Skv, int D, int causal, int window, float s1,
                                   float s2, void* stream) {
  if (B <= 0 || KH <= 0 || H % KH || Sq <= 0 || Skv <= 0 || D < 8 || D > 128 || D % 8)
    return (int)cudaErrorInvalidValue;
  const long long* st = strides;
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
               static_cast<bf16*>(o), {st[0], st[1], st[2]}, {st[3], st[4], st[5]}, {st[6], st[7], st[8]},
               {st[9], st[10], st[11]}, H, KH, Sq, Skv, D, causal, window, s1, s2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (H / KH) % 2 ? launch_d<1>(a, B, s) : launch_d<2>(a, B, s);
}

#ifdef K4_PHASES
// The stamps of the launches since the last call into `host` (1024 x 2 x 32
// uint64), then zeros.
extern "C" int k4_phases(void* host) {
  void* dev = nullptr;
  cudaError_t err = cudaMemcpyFromSymbol(host, k4_phase, sizeof(k4_phase));
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&dev, k4_phase);
  if (err == cudaSuccess) err = cudaMemset(dev, 0, sizeof(k4_phase));
  return (int)err;
}
#endif
