// K1, flash_attention forward: online-softmax attention with native GQA,
// per-row decode lanes, causal / window / kv_len masks, and the f32 LSE.
//
// Replaces src/repro/kernels/flash_attention.py:_flash_kernel (launched by
// _fwd_call, entry flash_attention).
//
// Two instances share the contract below:
//   * flash_fwd_mma_kernel, bf16 q/k/v, prefill, chunks and decode alike:
//     the products on the tensor cores
//     (mma.sync m16n8k16, bf16 in, f32 accumulate; mma_bf16.cuh).  What
//     bounds it at the training shape (4 x 128 queries, 16 query heads over
//     8 KV heads, hd 128, causal: 0.27 GFLOP and ~2 MB, a bound of ~2 us)
//     is latency: a call is a few microseconds of work, so the design keeps
//     every block's serial chain short and enough blocks in flight:
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
//         ulps, far below P's bf16 rounding); P is rounded to bf16 and
//         re-packed in registers as the A operand of P V (no shared-memory
//         round trip);
//       - bf16 rounding: P before P V (l is summed from the f32 P), and the
//         output; S, m, l, the LSE and O's sums are f32.
//     In decode (sq == 1) a block is a KV head's query heads, one row each,
//     so the cache is read once per KV head; on the H100 that beat this
//     file's FMA template at every decode shape measured (PERF.md, PR 15),
//     which then left bf16.
//   * flash_fwd_kernel, the FMA template: f32 (where the f32 gates leave no
//     room for bf16 or TF32 rounding) and K1q's int8 K/V.  One block per
//     (query batch-head, tile of BQ query rows), f32 dot products in shared
//     memory, BK = 32 keys per tile.
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
// l_safe guard, as the TPU kernel does.
//
// K1q, the FMA template over an int8 KV cache (KT = int8_t), replaces
// _flash_kernel with quantized=True (flash_attention.py:141-169, operands
// :356-358).  K and V are int8 with one f32 scale per (batch row, KV head)
// each, read at k_scale[bi * kvh + kv head]; every element is dequantized
// while it is staged into shared memory, in the TPU kernel's order
// (k * k_scale first, then q . k^T * scale), so the int8 cache is the only
// thing that crosses device memory: a quarter of the bf16 cache's bytes,
// which is what bounds decode.  q and out stay f32 or bf16, lse f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int BK = 32;
constexpr float NEG_INF = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, typename KT, int HD, int BQ>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const T* __restrict__ q, const KT* __restrict__ k, const KT* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, const int* __restrict__ qoff,
    const int* __restrict__ kvlen, const float* __restrict__ kscale,
    const float* __restrict__ vscale, int rows, int b, int sq, int sk, int h,
    int kvh, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss, long long vsh,
    int causal, int window, float scale) {
  static_assert(HD <= THREADS && THREADS % HD == 0, "head_dim must divide 128");
  constexpr int E = BQ * BK;                        // scores per tile
  constexpr int G = E >= THREADS ? 1 : THREADS / E;  // threads per score
  constexpr int EPT = E >= THREADS ? E / THREADS : 1;
  constexpr int RSTEP = THREADS / HD;               // acc rows per pass
  constexpr int ACC = (BQ + RSTEP - 1) / RSTEP;     // acc entries per thread
  static_assert(G <= 32 && (32 % G) == 0, "score groups must sit in a warp");

  __shared__ float Qs[BQ][HD];
  __shared__ float Ks[BK][HD + 1];
  __shared__ float Vs[BK][HD];
  __shared__ float Ps[BQ][BK];
  __shared__ float m_s[BQ], l_s[BQ], corr_s[BQ];

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

  for (int i = tid; i < BQ * HD; i += THREADS) {
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
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int j = i / HD, d = i % HD;
      const bool in = k0 + j < sk;
      Ks[j][d] = in ? stage(kb[(k0 + j) * kss + d], ks) : 0.f;
      Vs[j][d] = in ? stage(vb[(k0 + j) * vss + d], vs) : 0.f;
    }
    __syncthreads();

    // scores: each entry (r, j) is a dot over HD split across G lanes
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      const int e = tid / G + i * (THREADS / G);
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
    for (int r = warp; r < BQ; r += THREADS / 32) {
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

// ---- the tensor-core instance: bf16 q, k, v --------------------------------

constexpr int MMA_BK = 64;  // keys per K/V tile

template <int HD>
constexpr int fwd_mma_smem_bytes(int warps) {
  return (warps * 16 + 4 * MMA_BK) * mma_bf16::pad_ld<HD>() * 2;
}

template <int HD>
__global__ void __launch_bounds__(THREADS) flash_fwd_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, const int* __restrict__ qoff, const int* __restrict__ kvlen,
    int rows, int b, int sq, int sk, int h, int kvh, int rg, int qg, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, int causal, int window, float scale) {
  using namespace mma_bf16;
  constexpr int LD = pad_ld<HD>();
  constexpr int KS = HD / 16;     // k-steps of Q K^T
  constexpr int NB = MMA_BK / 8;  // 8-key column blocks of S
  constexpr int DB = HD / 8;      // 8-column blocks of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = rg * qg;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [warps * 16][LD]
  bf16* Ks = Qs + warps * 16 * LD;                // [2][MMA_BK][LD]
  bf16* Vs = Ks + 2 * MMA_BK * LD;                // [2][MMA_BK][LD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_rep = h / kvh, groups = n_rep / rg;
  const int gi = blockIdx.x % groups;
  const int kvhi = (blockIdx.x / groups) % kvh;
  const int bi = blockIdx.x / (groups * kvh);
  const int q0 = blockIdx.y * qg * 16;
  const int lane_row = bi / (b / rows);
  const int qo = qoff ? qoff[lane_row] : 0;
  const int kl = kvlen ? min(max(kvlen[lane_row], 0), sk) : sk;

  // this warp: query head hi, local rows wq0 .. wq0 + 15
  const int hi = kvhi * n_rep + gi * rg + warp % rg;
  const int wq0 = q0 + (warp / rg) * 16;
  const bf16* kb = k + bi * ksb + kvhi * ksh;
  const bf16* vb = v + bi * vsb + kvhi * vsh;
  stage_rows<HD>(Qs + warp * 16 * LD, q + bi * qsb + hi * qsh, qss, wq0, 16, sq, lane, 32);

  // the KV range the block's rows can see, and the warp's own
  const int q_last = min(q0 + qg * 16, sq) - 1;
  const int kv_end = causal ? min(kl, qo + q_last + 1) : kl;
  int kv_begin = window > 0 ? max(0, qo + q0 - window + 1) : 0;
  kv_begin = (kv_begin / MMA_BK) * MMA_BK;
  const bool w_rows = wq0 < sq;
  const int w_end = causal ? min(kl, qo + min(wq0 + 16, sq)) : kl;
  const int w_begin = window > 0 ? max(0, qo + wq0 - window + 1) : 0;

  auto load_kv = [&](int k0, int st) {
    stage_rows<HD>(Ks + st * MMA_BK * LD, kb, kss, k0, MMA_BK, sk, tid, blockDim.x);
    stage_rows<HD>(Vs + st * MMA_BK * LD, vb, vss, k0, MMA_BK, sk, tid, blockDim.x);
  };
  cp_async_commit();  // the warp's Q rows
  if (kv_begin < kv_end) load_kv(kv_begin, 0);
  cp_async_commit();

  // Q as A fragments, held in registers for the whole KV loop (each warp
  // staged and reads only its own rows, so a warp barrier suffices)
  uint32_t qf[KS][4];
  cp_async_wait<1>();
  __syncwarp();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) load_a(qf[ks], Qs + warp * 16 * LD, LD, ks * 16, lane);

  const int r = lane / 4, c = 2 * (lane % 4);
  const int qpos0 = qo + wq0 + r;  // the positions of rows r and r + 8
  float o[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  int t = 0;
  for (int k0 = kv_begin; k0 < kv_end; k0 += MMA_BK, ++t) {
    const int st = t & 1;
    if (k0 + MMA_BK < kv_end) load_kv(k0 + MMA_BK, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed (this thread's copies)
    __syncthreads();     // ... and every thread's
    if (w_rows && k0 < w_end && k0 + MMA_BK > w_begin) {
      const bf16* Kt = Ks + st * MMA_BK * LD;
      const bf16* Vt = Vs + st * MMA_BK * LD;
      float s[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int j = 0; j < NB; j += 2) {
          uint32_t bb[4];
          load_b_rows(bb, Kt, LD, j * 8, ks * 16, lane);
          mma(s[j], qf[ks], bb[0], bb[1]);
          mma(s[j + 1], qf[ks], bb[2], bb[3]);
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
          s[j][e] = ok ? s[j][e] * scale : NEG_INF;
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
      // O += P V, P re-packed from the accumulators as bf16 A fragments
#pragma unroll
      for (int kk = 0; kk < NB / 2; ++kk) {
        uint32_t a[4];
        pack_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int j = 0; j < DB; j += 2) {
          uint32_t bb[4];
          load_b_cols(bb, Vt, LD, kk * 16, j * 8, lane);
          mma(o[j], a, bb[0], bb[1]);
          mma(o[j + 1], a, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }
  cp_async_wait<0>();

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
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + c) =
          __floats2bfloat162_rn(o[j][2 * i] / l_safe, o[j][2 * i + 1] / l_safe);
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
  int causal, window;
};

template <typename T, typename KT, int HD, int BQ>
void launch(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.b * a.h, (a.sq + BQ - 1) / BQ);
  const long long* st = a.st;
  flash_fwd_kernel<T, KT, HD, BQ><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const KT*>(a.k),
      static_cast<const KT*>(a.v), static_cast<T*>(a.out),
      static_cast<float*>(a.lse), a.qoff, a.kvlen, a.kscale, a.vscale, a.rows,
      a.b, a.sq, a.sk, a.h, a.kvh, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], a.causal, a.window, 1.0f / sqrtf((float)HD));
}

template <typename T, typename KT, int HD>
void launch_bq(const Args& a, cudaStream_t stream) {
  if (a.sq == 1)
    launch<T, KT, HD, 1>(a, stream);
  else
    launch<T, KT, HD, 16>(a, stream);
}

template <typename T, typename KT>
int launch_hd(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 16: launch_bq<T, KT, 16>(a, stream); break;
    case 32: launch_bq<T, KT, 32>(a, stream); break;
    case 64: launch_bq<T, KT, 64>(a, stream); break;
    case 128: launch_bq<T, KT, 128>(a, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_mma(const Args& a, cudaStream_t stream) {
  const mma_bf16::QueryGrid qgrid = mma_bf16::query_grid(a.b, a.sq, a.h, a.kvh, false);
  // raise the blocks' shared-memory limit once per instantiation, to the
  // largest block's, so that a launch captured in a CUDA graph makes no
  // attribute call
  static bool limit_set = false;
  if (!limit_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        fwd_mma_smem_bytes<HD>(THREADS / 32));
    if (err != cudaSuccess) return static_cast<int>(err);
    limit_set = true;
  }
  const long long* st = a.st;
  flash_fwd_mma_kernel<HD><<<qgrid.grid, 32 * qgrid.warps(),
                             fwd_mma_smem_bytes<HD>(qgrid.warps()), stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<__nv_bfloat16*>(a.out),
      static_cast<float*>(a.lse), a.qoff, a.kvlen, a.rows, a.b, a.sq, a.sk, a.h, a.kvh,
      qgrid.rg, qgrid.qg, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      a.causal, a.window, 1.0f / sqrtf((float)HD));
  return static_cast<int>(cudaGetLastError());
}

int launch_mma_hd(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_mma<16>(a, stream);
    case 32: return launch_mma<32>(a, stream);
    case 64: return launch_mma<64>(a, stream);
    case 128: return launch_mma<128>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (b, sq, h, hd); k, v: (b, sk, kvh, hd), each with unit stride on hd and
// the given (batch, seq, head) strides.  out: contiguous (b, sq, h, hd);
// lse: contiguous f32 (b, h, sq).  qoff / kvlen: int32 device vectors of
// `rows` entries, or null.  dtype (of q and out): 0 = float32, 1 = bfloat16.
// kv_int8 = 0: k, v in q's dtype and kscale / vscale null (K1); kv_int8 = 1:
// k, v int8 with contiguous f32 (b, kvh) kscale / vscale (K1q).  bf16 q,
// k, v run the tensor-core instance (every pointer 16-byte aligned and
// every stride a multiple of 8 elements), the rest the FMA template.
// Returns the launch's cudaGetLastError() (cudaErrorInvalidValue for an
// unsupported hd).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    const void* qoff, const void* kvlen, const void* kscale, const void* vscale,
    int rows, int b, int sq, int sk, int h, int kvh, int hd, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, int causal, int window,
    int dtype, int kv_int8, void* stream) {
  const Args a{q, k, v, out, lse,
               static_cast<const int*>(qoff), static_cast<const int*>(kvlen),
               static_cast<const float*>(kscale), static_cast<const float*>(vscale),
               rows, b, sq, sk, h, kvh,
               {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh}, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_int8 && (kscale == nullptr || vscale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    return kv_int8 ? launch_hd<__nv_bfloat16, int8_t>(hd, a, s) : launch_mma_hd(hd, a, s);
  return kv_int8 ? launch_hd<float, int8_t>(hd, a, s)
                 : launch_hd<float, float>(hd, a, s);
}
