// K1, flash_attention forward: online-softmax attention with native GQA,
// per-row decode lanes, causal / window / kv_len masks, and the f32 LSE.
//
// Replaces src/repro/kernels/flash_attention.py:_flash_kernel (launched by
// _fwd_call, entry flash_attention).
//
// Bound on the H100: bytes.  Decode reads each row's valid cache prefix once
// per query head for 1 query row; prefill on the serving path is 64 x 64
// per head.  Both sit far below the card's flop/byte ridge, so the kernel is
// built to read K/V once per block and never to materialise anything
// O(sq * sk) in device memory:
//   * one block per (query batch-head, tile of BQ query rows); a loop inside
//     the block takes the place of the TPU grid's sequential KV axis, with
//     the running (m, l) in shared memory and acc in registers;
//   * q, k, v are read in the model's (b, s, heads, hd) layout through their
//     strides, so neither the head fold nor a GQA repeat is ever copied.
//     Query head b_ = bi * h + hi reads KV head bi * kvh + hi / n_rep (the
//     repro fold: batch-major, head = kv_head * n_rep + rep);
//   * per-row lanes: q_offset / kv_len are int32 device vectors of `rows`
//     entries, rows dividing b, lane = bi / (b / rows); null pointers mean
//     q_offset 0 and kv_len sk.  KV tiles past kv_len, past the causal
//     limit or before the window are skipped, not computed and masked;
//   * masked probabilities are zeroed explicitly (NEG_INF = -1e30 never
//     reaches an exp that counts), so a fully masked row or a kv_len == 0
//     lane emits exact zeros through the l_safe guard, as the TPU kernel does.
// A simple, correct kernel: f32 dot products in shared memory, BK = 32 keys
// per tile (one per lane of the softmax warp).  Tensor cores, TMA and an
// FA-3 style pipeline are later work.
//
// K1q, the same kernel over an int8 KV cache (KT = int8_t), replaces
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

}  // namespace

// q: (b, sq, h, hd); k, v: (b, sk, kvh, hd), each with unit stride on hd and
// the given (batch, seq, head) strides.  out: contiguous (b, sq, h, hd);
// lse: contiguous f32 (b, h, sq).  qoff / kvlen: int32 device vectors of
// `rows` entries, or null.  dtype (of q and out): 0 = float32, 1 = bfloat16.
// kv_int8 = 0: k, v in q's dtype and kscale / vscale null (K1); kv_int8 = 1:
// k, v int8 with contiguous f32 (b, kvh) kscale / vscale (K1q).  Returns the
// launch's cudaGetLastError() (cudaErrorInvalidValue for an unsupported hd).
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
    return kv_int8 ? launch_hd<__nv_bfloat16, int8_t>(hd, a, s)
                   : launch_hd<__nv_bfloat16, __nv_bfloat16>(hd, a, s);
  return kv_int8 ? launch_hd<float, int8_t>(hd, a, s)
                 : launch_hd<float, float>(hd, a, s);
}
