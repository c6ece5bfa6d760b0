// K1, flash_attention forward: online-softmax attention with native GQA,
// per-row decode lanes, causal / window / kv_len masks, and the f32 LSE;
// and K1q, the same over an int8 KV cache.
//
// Replaces src/repro/kernels/flash_attention.py:_flash_kernel (launched by
// _fwd_call, entry flash_attention); K1q replaces it with quantized=True
// (flash_attention.py:141-169, operands :356-358).
//
// Two instances share the contract below:
//   * flash_fwd_mma_kernel<HD, Q8>, bf16 q over a bf16 cache (K1, Q8 false)
//     or an int8 one (K1q, Q8 true), prefill, chunks and decode alike: the
//     products on the tensor cores
//     (mma.sync m16n8k16, f32 accumulate; mma_bf16.cuh).  What
//     bounds it at the training shape (4 x 128 queries, 16 query heads over
//     8 KV heads, hd 128, causal: 0.27 GFLOP and ~2 MB, a bound of ~2 us)
//     is latency, and in decode (8 rows over a 512-position cache: ~2-8 MB,
//     a bound of 1-3 us) the chain of dependent K/V tiles: a call is a few
//     microseconds of work, so the design keeps every block's serial chain
//     short and enough blocks in flight:
//       - a block is one KV head's `rg` query heads (the largest of 4, 2, 1
//         dividing n_rep) times `qg` groups of 16 query rows, one warp per
//         (head, 16 rows), rg * qg = 4 where sq allows; each K/V tile is
//         read once for all its warps (training shape: 32 x 4 = 128 blocks
//         of 4 warps, one per SM, each K/V tile feeding four warps);
//       - K/V tiles of 64 keys, bf16 in shared memory (rows padded to
//         hd + 8 for conflict-free ldmatrix), filled by 16-byte cp.async
//         with zero fill past sk, double-buffered so that tile t + 1 loads
//         while tile t is multiplied; two barriers per tile;
//       - Q is staged once and held as A fragments in registers; S = Q K^T
//         and O += P V run on mma.sync from ldmatrix fragments; the online
//         softmax (m, l, corr) stays in registers in the accumulator layout
//         with quad shuffles and the fast exponential (__expf: a few f32
//         ulps, far below P's rounding); P is re-packed in registers as the
//         A operand of P V (no shared-memory round trip);
//       - K1's bf16 rounding: P before P V (l is summed from the f32 P), and
//         the output; S, m, l, the LSE and O's sums are f32.
//     At hd 256 (gemma3-1b) a warp's f32 O alone is 128 registers, and Q as
//     A fragments would be 64 more: there the warp reads Q's fragments from
//     its staged rows at each k-step (q_in_registers) and the K/V tiles hold
//     32 keys (mma_bk: S is 16 registers), which keeps both instances
//     spill-free (242 and 255 registers; 101,376 bytes of shared memory for
//     K1, 168,960 for K1q, whose ring of 16 KB int8 tiles is then smaller
//     than the warps' partial (m, l, O) it holds after the loop).  Every
//     hd <= 128 instance keeps its 64-key tiles and Q in registers.
//     In decode (sq == 1) a block is a KV head's query heads, one row each,
//     so the cache is read once per KV head (and not once per query head as
//     the FMA template read it).
//     K1q (Q8) keeps the structure and changes the staging and the scales:
//       - the int8 K/V tiles come in by 16-byte cp.async with zero fill
//         into a ring of four (16 KB a tile at hd 128: half of K1's bytes),
//         two tiles loaded ahead of the (one or two) in use;
//       - each tile is widened exactly in shared memory, K to bf16 and V to
//         f16 (an int8 value is exact in both), by integer bit tricks, not
//         the conversion units (mma_bf16.cuh: widen_i8x4_*), then read by
//         ldmatrix as K1 reads its tiles; a barrier before and after;
//       - a block always has four warps.  In decode (a block's two query
//         heads, one row each) the warps of a head form two key groups that
//         take alternate tiles (two tiles widened per step), and a cluster
//         of `splits` blocks (flash_attention.kv_splits plans it, 2 at the
//         engine's 8-row decode) splits the tiles again; the partial
//         (m, l, O) merge in shared memory, then in distributed shared
//         memory, into key group 0 of rank 0.  The chain of dependent tiles
//         is what bounds a decode call (~2.6 us a tile in one group, ~1 us
//         in four: PERF.md, section 6);
//       - the per-(batch row, KV head) scales cost one multiply each where
//         they apply: S = (q . k_int) * (k_scale / sqrt(hd)) on the
//         accumulator, O = (P . v_int) * v_scale / l at the end;
//       - numerics: the TPU kernel dequantizes first (k * k_scale, then
//         q . k^T * scale); this order differs from it by f32 rounding only.
//         The one rounding added is P to f16 before P V (relative 2^-11;
//         K1's bf16 P is 2^-8: f16 keeps three more bits of a value in
//         [0, 1], and the f16 product runs at the bf16 rate); l sums the
//         f32 P, and O's sums are f32.
//   * flash_fwd_kernel, the FMA template: f32 q over an f32 cache (K1) or an
//     int8 one (K1q), where the f32 gates leave no room for bf16 or TF32
//     rounding.  One block per (query batch-head, tile of BQ query rows),
//     f32 dot products in shared memory, BK = 32 keys per tile; int8 K/V
//     are dequantized while they are staged, in the TPU kernel's order.  At
//     hd 256 a block has one thread a column (256) and the tiles (84 KB)
//     move to dynamic shared memory.
// Both read q, k, v in the model's (b, s, heads, hd) layout through their
// strides, so neither the head fold nor a GQA repeat is ever copied: query
// head b_ = bi * h + hi reads KV head bi * kvh + hi / n_rep (the repro
// fold: batch-major, head = kv_head * n_rep + rep).  Per-row lanes:
// q_offset / kv_len are int32 device vectors of `rows` entries, rows
// dividing b, lane = bi / (b / rows); null pointers mean q_offset 0 and
// kv_len sk.  KV tiles past kv_len, past the causal limit or before the
// window are skipped, not computed and masked.  Masked probabilities are
// zeroed explicitly (NEG_INF = -1e30 never reaches an exp that counts), so
// a fully masked row or a kv_len == 0 lane emits exact zeros through the
// l_safe guard, as the TPU kernel does.  K1q's K and V scales are read at
// k_scale[bi * kvh + kv head]; the int8 cache is the only thing of size sk
// that crosses device memory: half of the bf16 cache's bytes, which is what
// bounds decode.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 128;
constexpr int BK = 32;
constexpr float NEG_INF = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }

template <>
__device__ __forceinline__ float to_f32<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

// one K or V element staged as f32: int8 is dequantized with its scale
template <typename KT>
__device__ __forceinline__ float stage(KT x, float scale) {
  if constexpr (std::is_same<KT, int8_t>::value) return to_f32(x) * scale;
  else return to_f32(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

// The FMA template's threads: 128, and one a column past hd 128.
template <int HD>
__host__ __device__ constexpr int fma_threads() { return HD > THREADS ? HD : THREADS; }

// The FMA template's f32 tiles.  Up to hd 128 they are static shared
// memory; at hd 256 (84 KB at BQ 16) they pass the 48 KB static limit and
// live in dynamic shared memory, with the opt-in raised at the launch.
template <int HD, int BQ>
struct FmaTiles {
  float Qs[BQ][HD];
  float Ks[BK][HD + 1];
  float Vs[BK][HD];
  float Ps[BQ][BK];
  float m_s[BQ], l_s[BQ], corr_s[BQ];
};

template <int HD, int BQ>
__host__ __device__ constexpr int fma_smem_bytes() {
  return HD > THREADS ? (int)sizeof(FmaTiles<HD, BQ>) : 0;
}

// The launch bounds promise one block a SM, no more: given the thread count
// alone, ptxas aimed at more and spilled 4-12 bytes in 7 of the 20 instances.
template <typename T, typename KT, int HD, int BQ>
__global__ void __launch_bounds__(HD > THREADS ? HD : THREADS, 1) flash_fwd_kernel(
    const T* __restrict__ q, const KT* __restrict__ k, const KT* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, const int* __restrict__ qoff,
    const int* __restrict__ kvlen, const float* __restrict__ kscale,
    const float* __restrict__ vscale, int rows, int b, int sq, int sk, int h,
    int kvh, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss, long long vsh,
    int causal, int window, float scale) {
  constexpr int NT = fma_threads<HD>();
  static_assert(HD <= NT && NT % HD == 0, "head_dim must divide the block");
  constexpr int E = BQ * BK;               // scores per tile
  constexpr int G = E >= NT ? 1 : NT / E;  // threads per score
  constexpr int EPT = E >= NT ? E / NT : 1;
  constexpr int RSTEP = NT / HD;                 // acc rows per pass
  constexpr int ACC = (BQ + RSTEP - 1) / RSTEP;  // acc entries per thread
  static_assert(G <= 32 && (32 % G) == 0, "score groups must sit in a warp");

  FmaTiles<HD, BQ>* tiles;
  if constexpr (fma_smem_bytes<HD, BQ>() > 0) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    tiles = reinterpret_cast<FmaTiles<HD, BQ>*>(smem_raw);
  } else {
    __shared__ FmaTiles<HD, BQ> static_tiles;
    tiles = &static_tiles;
  }
  auto& Qs = tiles->Qs;
  auto& Ks = tiles->Ks;
  auto& Vs = tiles->Vs;
  auto& Ps = tiles->Ps;
  auto& m_s = tiles->m_s;
  auto& l_s = tiles->l_s;
  auto& corr_s = tiles->corr_s;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int bi = bh / h, hi = bh % h;
  const int kvhi = hi / (h / kvh);
  const int q0 = blockIdx.y * BQ;
  const int lane_row = bi / (b / rows);
  const int qo = qoff ? qoff[lane_row] : 0;
  const int kl = kvlen ? min(max(kvlen[lane_row], 0), sk) : sk;

  const T* qb = q + bi * qsb + hi * qsh;
  const KT* kb = k + bi * ksb + kvhi * ksh;
  const KT* vb = v + bi * vsb + kvhi * vsh;
  // K1q: this block's KV batch-head scales (unused by K1)
  const float ks = kscale ? kscale[bi * kvh + kvhi] : 1.f;
  const float vs = vscale ? vscale[bi * kvh + kvhi] : 1.f;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    Qs[r][d] = q0 + r < sq ? to_f32(qb[(q0 + r) * qss + d]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int j = 0; j < ACC; ++j) acc[j] = 0.f;

  // KV range this query tile can see
  const int q_first = qo + q0;
  const int q_last = qo + min(q0 + BQ, sq) - 1;
  int kv_end = causal ? min(kl, q_last + 1) : kl;
  int kv_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  kv_begin = (kv_begin / BK) * BK;

  auto visible = [&](int r, int kpos) {
    const int qpos = q_first + r;
    return kpos < kl && (!causal || kpos <= qpos) &&
           (window <= 0 || kpos > qpos - window);
  };

  __syncthreads();
  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    for (int i = tid; i < BK * HD; i += NT) {
      const int j = i / HD, d = i % HD;
      const bool in = k0 + j < sk;
      Ks[j][d] = in ? stage(kb[(k0 + j) * kss + d], ks) : 0.f;
      Vs[j][d] = in ? stage(vb[(k0 + j) * vss + d], vs) : 0.f;
    }
    __syncthreads();

    // scores: each entry (r, j) is a dot over HD split across G lanes
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      const int e = tid / G + i * (NT / G);
      const int r = e / BK, j = e % BK;
      const int part = tid % G;
      float dot = 0.f;
#pragma unroll 8
      for (int t = 0; t < HD / G; ++t) {
        const int d = t * G + part;
        dot = fmaf(Qs[r][d], Ks[j][d], dot);
      }
#pragma unroll
      for (int off = G / 2; off > 0; off /= 2)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (part == 0) Ps[r][j] = visible(r, k0 + j) ? dot * scale : NEG_INF;
    }
    __syncthreads();

    // online softmax: one warp per row, one lane per key
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < BQ; r += NT / 32) {
      const float s = Ps[r][lane];
      const bool ok = visible(r, k0 + lane);
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p = ok ? expf(s - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      Ps[r][lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        corr_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P @ V
    const int d = tid % HD;
#pragma unroll
    for (int j = 0; j < ACC; ++j) {
      const int r = tid / HD + j * RSTEP;
      if (r < BQ) {
        float a = acc[j] * corr_s[r];
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk) a = fmaf(Ps[r][kk], Vs[kk][d], a);
        acc[j] = a;
      }
    }
    __syncthreads();
  }

  const int d = tid % HD;
#pragma unroll
  for (int j = 0; j < ACC; ++j) {
    const int r = tid / HD + j * RSTEP;
    if (r < BQ && q0 + r < sq) {
      const float l_safe = fmaxf(l_s[r], 1e-30f);
      out[(((long long)bi * sq + q0 + r) * h + hi) * HD + d] =
          from_f32<T>(acc[j] / l_safe);
    }
  }
  if (tid < BQ && q0 + tid < sq) {
    const float l_safe = fmaxf(l_s[tid], 1e-30f);
    lse[((long long)bi * h + hi) * sq + q0 + tid] = m_s[tid] + logf(l_safe);
  }
}

// ---- the tensor-core instance: bf16 q over a bf16 or an int8 K/V -------------

constexpr int Q8_STAGES = 4;   // K1q: int8 K/V tiles in its ring
constexpr int Q8_KGROUPS = 2;  // K1q: at most two key groups (widened tiles) at once

// Keys per K/V tile: 64, and 32 at hd 256, where a warp's f32 O alone
// takes 128 registers and a 64-key S tile 32 more (flash_mma_kv_tile gives
// it to flash_attention.kv_splits).
template <int HD>
__host__ __device__ constexpr int mma_bk() { return HD > 128 ? 32 : 64; }

// Up to hd 128 each warp holds its Q tile as A fragments in registers for
// the whole KV loop (HD / 4 registers); at hd 256 that would be 64 of them,
// so it reads them from its staged Q rows at each k-step instead.
template <int HD>
__host__ __device__ constexpr bool q_in_registers() { return HD <= 128; }

template <int HD, bool Q8>
constexpr int fwd_mma_smem_bytes(int warps, int kgroups) {
  // Q, then K and V: bf16 double-buffered (K1), or K1q's widened tiles, one
  // per key group (K bf16, V f16), and its ring of int8 tiles, which after
  // the loop holds the warps' partial (m, l, O): 4 + HD / 2 floats a lane
  // (more than the ring at hd 256)
  const int ring = Q8_STAGES * 2 * mma_bk<HD>() * HD;
  const int parts = warps * (4 + HD / 2) * 32 * 4;
  return Q8 ? (warps * 16 + 2 * mma_bk<HD>() * kgroups) * mma_bf16::pad_ld<HD>() * 2 +
                  (ring > parts ? ring : parts)
            : (warps * 16 + 4 * mma_bk<HD>()) * mma_bf16::pad_ld<HD>() * 2;
}

// Rows r0 .. r0 + rows - 1 of HD int8 each (row i at base + i * stride;
// rows at or past `limit` zero-filled) into an unpadded tile, 16 bytes per
// cp.async, by threads t of nt.
template <int HD>
__device__ __forceinline__ void stage_rows_i8(int8_t* dst, const int8_t* base, long long stride,
                                              int r0, int rows, int limit, int t, int nt) {
  constexpr int CH = HD / 16;
  for (int i = t; i < rows * CH; i += nt) {
    const int r = i / CH, ch = i % CH;
    const bool in = r0 + r < limit;
    mma_bf16::cp_async16(dst + r * HD + ch * 16, in ? base + (r0 + r) * stride + ch * 16 : base,
                         in);
  }
}

// K1q: an int8 K and V tile widened exactly into the padded tiles that
// ldmatrix reads, K to bf16 (Q K^T), V to f16 (P V); 16 elements a step.
template <int HD>
__device__ __forceinline__ void widen_tile(mma_bf16::bf16* Kw, __half* Vw, const int8_t* K8,
                                           const int8_t* V8, int t, int nt) {
  constexpr int CH = HD / 16, LD = mma_bf16::pad_ld<HD>();
  for (int i = t; i < mma_bk<HD>() * CH; i += nt) {
    const int r = i / CH, c = i % CH;
    const uint4 kw = *reinterpret_cast<const uint4*>(K8 + r * HD + c * 16);
    const uint4 vw = *reinterpret_cast<const uint4*>(V8 + r * HD + c * 16);
    uint4 k2[2], v2[2];
    mma_bf16::widen_i8x4_bf16(kw.x, k2[0].x, k2[0].y);
    mma_bf16::widen_i8x4_bf16(kw.y, k2[0].z, k2[0].w);
    mma_bf16::widen_i8x4_bf16(kw.z, k2[1].x, k2[1].y);
    mma_bf16::widen_i8x4_bf16(kw.w, k2[1].z, k2[1].w);
    mma_bf16::widen_i8x4_f16(vw.x, v2[0].x, v2[0].y);
    mma_bf16::widen_i8x4_f16(vw.y, v2[0].z, v2[0].w);
    mma_bf16::widen_i8x4_f16(vw.z, v2[1].x, v2[1].y);
    mma_bf16::widen_i8x4_f16(vw.w, v2[1].z, v2[1].w);
    uint4* kd = reinterpret_cast<uint4*>(Kw + r * LD + c * 16);
    uint4* vd = reinterpret_cast<uint4*>(Vw + r * LD + c * 16);
    kd[0] = k2[0];
    kd[1] = k2[1];
    vd[0] = v2[0];
    vd[1] = v2[1];
  }
}

template <int HD, bool Q8>
__global__ void __launch_bounds__(THREADS) flash_fwd_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const void* __restrict__ k_,
    const void* __restrict__ v_, __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
    const int* __restrict__ qoff, const int* __restrict__ kvlen,
    const float* __restrict__ kscale, const float* __restrict__ vscale, int rows, int b,
    int sq, int sk, int h, int kvh, int rg, int qg, int kgroups, int splits, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, int causal, int window, float scale) {
  using namespace mma_bf16;
  using KT = typename std::conditional<Q8, int8_t, bf16>::type;
  constexpr int LD = pad_ld<HD>();
  constexpr int MMA_BK = mma_bk<HD>();
  constexpr int KS = HD / 16;     // k-steps of Q K^T
  constexpr int NB = MMA_BK / 8;  // 8-key column blocks of S
  constexpr int DB = HD / 8;      // 8-column blocks of O
  constexpr int NSTAGE = Q8 ? Q8_STAGES : 2;
  constexpr bool Q_REGS = q_in_registers<HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = rg * qg;
  const int kgr = Q8 ? kgroups : 1;  // K/V tiles in use at once, one per key group
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [warps * 16][LD]
  // K1: [2 stages][MMA_BK][LD] bf16; K1q: [kgroups][MMA_BK][LD] widened tiles
  bf16* Ks = Qs + warps * 16 * LD;
  bf16* Vs = Ks + (Q8 ? kgr : 2) * MMA_BK * LD;  // the same for V (K1q: f16)
  // K1q's ring: [Q8_STAGES][K, V][MMA_BK][HD] int8
  int8_t* ring = reinterpret_cast<int8_t*>(Vs + (Q8 ? kgr : 2) * MMA_BK * LD);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_rep = h / kvh, groups = n_rep / rg;
  // K1q: a cluster of `splits` blocks along x shares one block's rows, its
  // rank taking every splits-th K/V tile (K1: splits 1)
  const int rank = Q8 ? (int)(blockIdx.x % splits) : 0;
  const int hb = Q8 ? (int)(blockIdx.x / splits) : (int)blockIdx.x;
  const int gi = hb % groups;
  const int kvhi = (hb / groups) % kvh;
  const int bi = hb / (groups * kvh);
  const int q0 = blockIdx.y * qg * 16;
  const int lane_row = bi / (b / rows);
  const int qo = qoff ? qoff[lane_row] : 0;
  const int kl = kvlen ? min(max(kvlen[lane_row], 0), sk) : sk;
  // K1q folds its per-(row, KV head) scales into S's scale and O's
  const float s_scale = Q8 ? scale * kscale[bi * kvh + kvhi] : scale;
  const float o_scale = Q8 ? vscale[bi * kvh + kvhi] : 1.f;

  // this warp: query head hi, local rows wq0 .. wq0 + 15.  With key groups
  // (K1q, sq <= 16) the warps of one head share rows 0-15 and key group kg
  // takes every kgroups-th of the block's tiles; warps past the last group
  // have no rows.
  const int hi = kvhi * n_rep + gi * rg + warp % rg;
  const int kg = kgr > 1 ? warp / rg : 0;
  const int wq0 = q0 + (kgr > 1 ? 0 : warp / rg) * 16;
  const KT* kb = static_cast<const KT*>(k_) + bi * ksb + kvhi * ksh;
  const KT* vb = static_cast<const KT*>(v_) + bi * vsb + kvhi * vsh;
  stage_rows<HD>(Qs + warp * 16 * LD, q + bi * qsb + hi * qsh, qss, wq0, 16, sq, lane, 32);

  // the KV range the block's rows can see, and the warp's own
  const int q_last = min(q0 + qg * 16, sq) - 1;
  const int kv_end = causal ? min(kl, qo + q_last + 1) : kl;
  int kv_begin = window > 0 ? max(0, qo + q0 - window + 1) : 0;
  kv_begin = (kv_begin / MMA_BK) * MMA_BK;
  const bool w_rows = wq0 < sq && kg < kgr;
  const int w_end = causal ? min(kl, qo + min(wq0 + 16, sq)) : kl;
  const int w_begin = window > 0 ? max(0, qo + wq0 - window + 1) : 0;

  // the block's n-th tile starts at key first + n * step; K1: into bf16
  // stage n % 2, K1q: into ring slot n % Q8_STAGES
  const int first = kv_begin + rank * MMA_BK, step = (Q8 ? splits : 1) * MMA_BK;
  auto load_kv = [&](int n) {
    const int k0 = first + n * step, st = n % NSTAGE;
    if (k0 >= kv_end) return;
    if constexpr (Q8) {
      int8_t* slot = ring + st * 2 * MMA_BK * HD;
      stage_rows_i8<HD>(slot, kb, kss, k0, MMA_BK, sk, tid, blockDim.x);
      stage_rows_i8<HD>(slot + MMA_BK * HD, vb, vss, k0, MMA_BK, sk, tid, blockDim.x);
    } else {
      stage_rows<HD>(Ks + st * MMA_BK * LD, kb, kss, k0, MMA_BK, sk, tid, blockDim.x);
      stage_rows<HD>(Vs + st * MMA_BK * LD, vb, vss, k0, MMA_BK, sk, tid, blockDim.x);
    }
  };
  // tiles in flight past the (at most Q8_KGROUPS) in use; one commit group
  // per tile
  constexpr int AHEAD = Q8 ? Q8_STAGES - Q8_KGROUPS : 1;
  cp_async_commit();  // the warp's Q rows
#pragma unroll
  for (int n = 0; n < AHEAD; ++n) {
    load_kv(n);
    cp_async_commit();
  }

  // Q as A fragments, held in registers for the whole KV loop up to hd 128
  // (each warp staged and reads only its own rows, so a warp barrier
  // suffices); at hd 256 read from the staged rows at each k-step
  const bf16* Qw = Qs + warp * 16 * LD;
  uint32_t qf[Q_REGS ? KS : 1][4];
  cp_async_wait<AHEAD>();
  __syncwarp();
  if constexpr (Q_REGS) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) load_a(qf[ks], Qw, LD, ks * 16, lane);
  }

  const int r = lane / 4, c = 2 * (lane % 4);
  const int qpos0 = qo + wq0 + r;  // the positions of rows r and r + 8
  float o[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int n0 = 0; first + n0 * step < kv_end; n0 += kgr) {
    for (int i = 0; i < kgr; ++i) {
      load_kv(n0 + AHEAD + i);
      cp_async_commit();
    }
    cp_async_wait<AHEAD>();  // tiles n0 .. n0 + kgr - 1 have landed (this thread's copies)
    __syncthreads();         // ... and every thread's
    if constexpr (Q8) {
      // every warp widens (the warps without rows too), then all may read
      for (int i = 0; i < kgr && first + (n0 + i) * step < kv_end; ++i) {
        const int8_t* slot = ring + ((n0 + i) % NSTAGE) * 2 * MMA_BK * HD;
        widen_tile<HD>(Ks + i * MMA_BK * LD, reinterpret_cast<__half*>(Vs + i * MMA_BK * LD),
                       slot, slot + MMA_BK * HD, tid, blockDim.x);
      }
      __syncthreads();
    }
    const int k0 = first + (n0 + kg) * step;
    if (w_rows && k0 < w_end && k0 + MMA_BK > w_begin) {
      const int buf = Q8 ? kg : n0 % 2;
      const bf16* Kt = Ks + buf * MMA_BK * LD;
      const bf16* Vt = Vs + buf * MMA_BK * LD;
      float s[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t qa[4];
        if constexpr (Q_REGS) {
#pragma unroll
          for (int i = 0; i < 4; ++i) qa[i] = qf[ks][i];
        } else {
          load_a(qa, Qw, LD, ks * 16, lane);
        }
#pragma unroll
        for (int j = 0; j < NB; j += 2) {
          uint32_t bb[4];
          load_b_rows(bb, Kt, LD, j * 8, ks * 16, lane);
          mma(s[j], qa, bb[0], bb[1]);
          mma(s[j + 1], qa, bb[2], bb[3]);
        }
      }
      // scale and mask; the tile's row maxima over the quad
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < NB; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = qpos0 + (e / 2) * 8, kpos = k0 + j * 8 + c + (e % 2);
          const bool ok = kpos < kl && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          s[j][e] = ok ? s[j][e] * s_scale : NEG_INF;
          mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
        }
      }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        corr[i] = __expf(m[i] - m_new);
        m[i] = m_new;
        l[i] *= corr[i];
      }
      // P = exp(S - m), masked entries exactly 0; l sums the f32 P (this
      // thread's columns; the quad's partial sums are added at the end)
#pragma unroll
      for (int j = 0; j < NB; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = s[j][e] == NEG_INF ? 0.f : __expf(s[j][e] - m[e / 2]);
          s[j][e] = p;
          l[e / 2] += p;
        }
      }
#pragma unroll
      for (int j = 0; j < DB; ++j) {
        o[j][0] *= corr[0];
        o[j][1] *= corr[0];
        o[j][2] *= corr[1];
        o[j][3] *= corr[1];
      }
      // O += P V, P re-packed from the accumulators as A fragments (bf16 for
      // K1, f16 for K1q)
#pragma unroll
      for (int kk = 0; kk < NB / 2; ++kk) {
        uint32_t a[4];
        if constexpr (Q8) pack_a_f16(a, s[2 * kk], s[2 * kk + 1]);
        else pack_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int j = 0; j < DB; j += 2) {
          uint32_t bb[4];
          load_b_cols(bb, Vt, LD, kk * 16, j * 8, lane);
          if constexpr (Q8) {
            mma_f16(o[j], a, bb[0], bb[1]);
            mma_f16(o[j + 1], a, bb[2], bb[3]);
          } else {
            mma(o[j], a, bb[0], bb[1]);
            mma(o[j + 1], a, bb[2], bb[3]);
          }
        }
      }
    }
    // K1: every warp is done with stage n0 % 2 before it is refilled.  K1q:
    // the next iteration's first barrier guards the widened tiles, and the
    // ring slots it refills were last read before this one's second barrier.
    if constexpr (!Q8) __syncthreads();
  }
  cp_async_wait<0>();

  if constexpr (Q8) {
    // Merge the partial (m, l, O) of the key groups, then of the cluster's
    // ranks, into key group 0 of rank 0.  Each thread's values, in the
    // accumulator layout, go to the ring (every tile in it was widened
    // before the loop's last barrier) at [warp][value][lane].  An empty part (m = NEG_INF, l = 0, O = 0) adds
    // nothing, and with every part empty O stays exactly 0.
    constexpr int PV = 4 + 4 * DB;
    float* part = reinterpret_cast<float*>(ring);
    auto store_part = [&]() {
      float* mine = part + warp * PV * 32 + lane;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mine[i * 32] = m[i];
        mine[(2 + i) * 32] = l[i];
      }
#pragma unroll
      for (int j = 0; j < DB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(4 + 4 * j + e) * 32] = o[j][e];
    };
    auto merge_part = [&](const float* theirs) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_other = theirs[i * 32];
        const float m_new = fmaxf(m[i], m_other);
        const float c_mine = __expf(m[i] - m_new), c_other = __expf(m_other - m_new);
        l[i] = l[i] * c_mine + theirs[(2 + i) * 32] * c_other;
#pragma unroll
        for (int j = 0; j < DB; ++j)
#pragma unroll
          for (int e = 2 * i; e < 2 * i + 2; ++e)
            o[j][e] = o[j][e] * c_mine + theirs[(4 + 4 * j + e) * 32] * c_other;
        m[i] = m_new;
      }
    };
    if (kgr > 1) {
      if (kg > 0 && kg < kgr) store_part();
      __syncthreads();
      if (kg == 0)
        for (int src = 1; src < kgr; ++src) merge_part(part + (warp + src * rg) * PV * 32 + lane);
    }
    if (splits > 1) {
      if (rank > 0 && kg == 0) store_part();
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      if (rank == 0 && kg == 0)
        for (int src = 1; src < splits; ++src)
          merge_part(cluster.map_shared_rank(part, src) + warp * PV * 32 + lane);
      cluster.sync();  // no block leaves while rank 0 still reads its values
      if (rank > 0) return;
    }
    if (kg > 0) return;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qrow = wq0 + r + 8 * i;
    if (!w_rows || qrow >= sq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    bf16* orow = out + (((long long)bi * sq + qrow) * h + hi) * HD;
#pragma unroll
    for (int j = 0; j < DB; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + c) = __floats2bfloat162_rn(
          o[j][2 * i] * o_scale / l_safe, o[j][2 * i + 1] * o_scale / l_safe);
    if (c == 0) lse[((long long)bi * h + hi) * sq + qrow] = m[i] + logf(l_safe);
  }
}

// every pointer and size of one launch
struct Args {
  const void *q, *k, *v;
  void *out, *lse;
  const int *qoff, *kvlen;
  const float *kscale, *vscale;
  int rows, b, sq, sk, h, kvh;
  long long st[9];
  int causal, window, splits;
};

template <typename T, typename KT, int HD, int BQ>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int smem = fma_smem_bytes<HD, BQ>();
  if constexpr (smem > 0) {
    // once per instantiation, so that a launch captured in a CUDA graph
    // makes no attribute call
    static bool limit_set = false;
    if (!limit_set) {
      const cudaError_t err = cudaFuncSetAttribute(
          flash_fwd_kernel<T, KT, HD, BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      limit_set = true;
    }
  }
  const dim3 grid(a.b * a.h, (a.sq + BQ - 1) / BQ);
  const long long* st = a.st;
  flash_fwd_kernel<T, KT, HD, BQ><<<grid, fma_threads<HD>(), smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const KT*>(a.k),
      static_cast<const KT*>(a.v), static_cast<T*>(a.out),
      static_cast<float*>(a.lse), a.qoff, a.kvlen, a.kscale, a.vscale, a.rows,
      a.b, a.sq, a.sk, a.h, a.kvh, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], a.causal, a.window, 1.0f / sqrtf((float)HD));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename KT, int HD>
int launch_bq(const Args& a, cudaStream_t stream) {
  return a.sq == 1 ? launch<T, KT, HD, 1>(a, stream) : launch<T, KT, HD, 16>(a, stream);
}

template <typename T, typename KT>
int launch_hd(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_bq<T, KT, 16>(a, stream);
    case 32: return launch_bq<T, KT, 32>(a, stream);
    case 64: return launch_bq<T, KT, 64>(a, stream);
    case 128: return launch_bq<T, KT, 128>(a, stream);
    case 256: return launch_bq<T, KT, 256>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int HD, bool Q8>
int launch_mma(const Args& a, cudaStream_t stream) {
  mma_bf16::QueryGrid qgrid = mma_bf16::query_grid(a.b, a.sq, a.h, a.kvh, false);
  int kgroups = 1;
  if (Q8) {
    // K1q: always four warps.  Where one group of 16 rows holds every query
    // row (decode: a block's two query heads, one row each), the warps of
    // one head form key groups instead, each taking every other K/V tile.
    // A cluster of `splits` blocks shares each block's rows.
    qgrid.qg = THREADS / 32 / qgrid.rg;
    qgrid.grid.y = (unsigned)((a.sq + 16 * qgrid.qg - 1) / (16 * qgrid.qg));
    qgrid.grid.x *= (unsigned)a.splits;
    kgroups = a.sq <= 16 ? (qgrid.qg < Q8_KGROUPS ? qgrid.qg : Q8_KGROUPS) : 1;
  }
  // raise the blocks' shared-memory limit once per instantiation, to the
  // largest block's, so that a launch captured in a CUDA graph makes no
  // attribute call
  static bool limit_set = false;
  if (!limit_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<HD, Q8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        fwd_mma_smem_bytes<HD, Q8>(THREADS / 32, Q8_KGROUPS));
    if (err != cudaSuccess) return static_cast<int>(err);
    limit_set = true;
  }
  const long long* st = a.st;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = qgrid.grid;
  cfg.blockDim = dim3(32 * qgrid.warps());
  cfg.dynamicSmemBytes = fwd_mma_smem_bytes<HD, Q8>(qgrid.warps(), kgroups);
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = Q8 ? a.splits : 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = Q8 && a.splits > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, flash_fwd_mma_kernel<HD, Q8>, static_cast<const __nv_bfloat16*>(a.q), a.k, a.v,
      static_cast<__nv_bfloat16*>(a.out), static_cast<float*>(a.lse), a.qoff, a.kvlen,
      a.kscale, a.vscale, a.rows, a.b, a.sq, a.sk, a.h, a.kvh, qgrid.rg, qgrid.qg, kgroups,
      Q8 ? a.splits : 1, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      a.causal, a.window, 1.0f / sqrtf((float)HD));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <bool Q8>
int launch_mma_hd(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_mma<16, Q8>(a, stream);
    case 32: return launch_mma<32, Q8>(a, stream);
    case 64: return launch_mma<64, Q8>(a, stream);
    case 128: return launch_mma<128, Q8>(a, stream);
    case 256: return launch_mma<256, Q8>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Keys per K/V tile of the tensor-core instance at head dim hd (mma_bk),
// or 0 for an unsupported hd.
extern "C" int flash_mma_kv_tile(int hd) {
  switch (hd) {
    case 16: return mma_bk<16>();
    case 32: return mma_bk<32>();
    case 64: return mma_bk<64>();
    case 128: return mma_bk<128>();
    case 256: return mma_bk<256>();
    default: return 0;
  }
}

// q: (b, sq, h, hd); k, v: (b, sk, kvh, hd), each with unit stride on hd and
// the given (batch, seq, head) strides.  out: contiguous (b, sq, h, hd);
// lse: contiguous f32 (b, h, sq).  qoff / kvlen: int32 device vectors of
// `rows` entries, or null.  dtype (of q and out): 0 = float32, 1 = bfloat16.
// kv_int8 = 0: k, v in q's dtype and kscale / vscale null (K1); kv_int8 = 1:
// k, v int8 with contiguous f32 (b, kvh) kscale / vscale (K1q).  bf16 q
// runs the tensor-core instance over either cache (q, k, v 16-byte aligned
// with strides of whole 16-byte steps: 8 bf16 or 16 int8 elements), f32 q
// the FMA template.  splits (1-8): the cluster of blocks over which K1q's
// tensor-core instance splits each block's K/V tiles (others ignore it).
// Returns the launch's cudaGetLastError() (cudaErrorInvalidValue for an
// unsupported hd).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    const void* qoff, const void* kvlen, const void* kscale, const void* vscale,
    int rows, int b, int sq, int sk, int h, int kvh, int hd, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, int causal, int window,
    int dtype, int kv_int8, int splits, void* stream) {
  const Args a{q, k, v, out, lse,
               static_cast<const int*>(qoff), static_cast<const int*>(kvlen),
               static_cast<const float*>(kscale), static_cast<const float*>(vscale),
               rows, b, sq, sk, h, kvh,
               {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh}, causal, window, splits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((kv_int8 && (kscale == nullptr || vscale == nullptr)) || splits < 1 || splits > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    return kv_int8 ? launch_mma_hd<true>(hd, a, s) : launch_mma_hd<false>(hd, a, s);
  return kv_int8 ? launch_hd<float, int8_t>(hd, a, s)
                 : launch_hd<float, float>(hd, a, s);
}
