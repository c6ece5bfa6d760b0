// K3, flash_attention backward: dq, dk, dv of online-softmax attention,
// recomputing the probabilities from the forward's f32 LSE, with native GQA,
// per-row lanes and causal / window / kv_len masks.
//
// Replaces src/repro/kernels/flash_attention.py:_bwd_dq_kernel (call :416)
// and :_bwd_dkv_kernel (call :459), launched by _bwd_call.
//
// Bound on the H100: at the training path's shapes (4 x 128 queries, 16
// query heads over 8 KV heads, hd 128, causal) the least time is set by the
// bytes (~10 MB in and out, ~3 us); the work is ~1 GFLOP of small products.
// What limits this kernel is its own instruction rate: f32 FMA out of shared
// memory, no tensor cores.  The design keeps everything O(sq * sk) out of
// device memory and needs no second pass and no atomics:
//   * dq: one block per (batch row, query head, tile of BQ queries).  A loop
//     inside the block takes the place of the TPU grid's sequential KV axis:
//     it walks the KV tiles the query tile can see (causal limit, the lane's
//     kv_len, the window), recomputes S = q k^T * scale, P = exp(S - lse)
//     and dP = dO v^T, forms dS = P * (dP - delta) * scale and accumulates
//     dq += dS k in f32 registers; dq is written once, in q's dtype.
//   * dk/dv: one block per (batch row, KV head, tile of BK keys).  A loop
//     inside the block takes the place of the TPU grid's sequential (rep, q)
//     axis: it walks the n_rep query heads of the group and the query tiles
//     that can see the tile, accumulating dv += P^T dO and dk += dS^T q in
//     f32 registers, so the GQA group sum happens in the accumulator and no
//     repeated K/V is ever made.  A tile past kv_len, or one no query sees,
//     writes zeros: every slot of dk/dv is written.
//   * no atomics: every output element has one writer, so the gradients are
//     the same bits run to run.
//   * q, k, v and dO are read in the model's (b, s, heads, hd) layout through
//     their strides (unit stride on hd); query head hi of batch row bi uses
//     KV head hi / n_rep; lanes as in K1 (lane = bi / (b / rows)).
//   * masked probabilities are zeroed explicitly, never left to underflow:
//     a fully masked row has lse ~ NEG_INF, where exp(S - lse) would be 1.
//   * tiles live in dynamic shared memory as f32 (52.4 KB at hd 128, past
//     the 48 KB static limit, so the launch raises the block's limit).
// delta = rowsum(dO * O) comes from the wrapper (a plain reduction, as the
// JAX package computes it outside Pallas too).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int BQ = 16;   // query rows per tile
constexpr int BK = 32;   // keys per tile

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Element strides of q, k, v, dO: (batch, seq, head) for each, unit on hd.
struct Strides {
  long long q[3], k[3], v[3], g[3];
};

struct Geometry {
  int rows, b, sq, sk, h, kvh, causal, window;
  float scale;
};

__device__ __forceinline__ bool visible(int qpos, int kpos, int kl,
                                        const Geometry& g) {
  return kpos < kl && (!g.causal || kpos <= qpos) &&
         (g.window <= 0 || kpos > qpos - g.window);
}

// Copy ROWS rows of hd values starting at row r0 of a (b, s, heads, hd)
// operand (base already at the batch row and head) into smem rows of stride
// LD, as f32; rows at or past `limit` are zero.
template <typename T, int HD, int ROWS, int LD>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long row_stride, int r0,
                                          int limit) {
  for (int i = threadIdx.x; i < ROWS * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    dst[r * LD + d] =
        r0 + r < limit ? to_f32(src[(long long)(r0 + r) * row_stride + d]) : 0.f;
  }
}

// S (times scale) and dP for a BQ x BK tile, one (r, j) pair per thread and
// step: s_out[r][j] = q_r . k_j * scale, dp_out[r][j] = g_r . v_j.  Rows of
// q/g have stride HD, rows of k/v stride HD + 1 (conflict-free columns).
template <int HD>
__device__ __forceinline__ void scores(const float* qs, const float* gs,
                                       const float* ks, const float* vs,
                                       float* s_out, float* dp_out,
                                       float scale) {
  for (int e = threadIdx.x; e < BQ * BK; e += THREADS) {
    const int r = e / BK, j = e % BK;
    float s = 0.f, dp = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      s = fmaf(qs[r * HD + d], ks[j * (HD + 1) + d], s);
      dp = fmaf(gs[r * HD + d], vs[j * (HD + 1) + d], dp);
    }
    s_out[e] = s * scale;
    dp_out[e] = dp;
  }
}

// Shared-memory floats of either kernel's carve-up: q and dO tiles, k and v
// tiles, two score tiles, lse and delta.
template <int HD>
constexpr int smem_floats() {
  return 2 * BQ * HD + 2 * BK * (HD + 1) + 2 * BQ * BK + 2 * BQ;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq,
    const int* __restrict__ qoff, const int* __restrict__ kvlen, Strides st,
    Geometry geo) {
  extern __shared__ float smem[];
  float* Qs = smem;                       // [BQ][HD]
  float* Gs = Qs + BQ * HD;               // [BQ][HD]
  float* Ks = Gs + BQ * HD;               // [BK][HD + 1]
  float* Vs = Ks + BK * (HD + 1);         // [BK][HD + 1]
  float* Ss = Vs + BK * (HD + 1);         // [BQ][BK]: S, then dS
  float* Ps = Ss + BQ * BK;               // [BQ][BK]: dP
  float* lse_s = Ps + BQ * BK;            // [BQ]
  float* delta_s = lse_s + BQ;            // [BQ]

  const int tid = threadIdx.x;
  const int bi = blockIdx.x / geo.h, hi = blockIdx.x % geo.h;
  const int kvhi = hi / (geo.h / geo.kvh);
  const int q0 = blockIdx.y * BQ;
  const int lane_row = bi / (geo.b / geo.rows);
  const int qo = qoff ? qoff[lane_row] : 0;
  const int kl = kvlen ? min(max(kvlen[lane_row], 0), geo.sk) : geo.sk;

  const T* qb = q + bi * st.q[0] + hi * st.q[2];
  const T* gb = g + bi * st.g[0] + hi * st.g[2];
  const T* kb = k + bi * st.k[0] + kvhi * st.k[2];
  const T* vb = v + bi * st.v[0] + kvhi * st.v[2];
  const long long row = ((long long)bi * geo.h + hi) * geo.sq;

  load_rows<T, HD, BQ, HD>(Qs, qb, st.q[1], q0, geo.sq);
  load_rows<T, HD, BQ, HD>(Gs, gb, st.g[1], q0, geo.sq);
  if (tid < BQ) {
    const bool in = q0 + tid < geo.sq;
    lse_s[tid] = in ? lse[row + q0 + tid] : 0.f;
    delta_s[tid] = in ? delta[row + q0 + tid] : 0.f;
  }

  constexpr int RSTEP = THREADS / HD;           // dq rows per pass
  constexpr int ACC = (BQ + RSTEP - 1) / RSTEP;  // dq entries per thread
  float acc[ACC];
#pragma unroll
  for (int j = 0; j < ACC; ++j) acc[j] = 0.f;

  // the KV range this query tile can see
  const int q_first = qo + q0;
  const int q_last = qo + min(q0 + BQ, geo.sq) - 1;
  const int kv_end = geo.causal ? min(kl, q_last + 1) : kl;
  int kv_begin = geo.window > 0 ? max(0, q_first - geo.window + 1) : 0;
  kv_begin = (kv_begin / BK) * BK;

  __syncthreads();
  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    load_rows<T, HD, BK, HD + 1>(Ks, kb, st.k[1], k0, geo.sk);
    load_rows<T, HD, BK, HD + 1>(Vs, vb, st.v[1], k0, geo.sk);
    __syncthreads();
    scores<HD>(Qs, Gs, Ks, Vs, Ss, Ps, geo.scale);
    __syncthreads();
    for (int e = tid; e < BQ * BK; e += THREADS) {
      const int r = e / BK, j = e % BK;
      const bool ok = q0 + r < geo.sq && visible(q_first + r, k0 + j, kl, geo);
      const float p = ok ? expf(Ss[e] - lse_s[r]) : 0.f;
      Ss[e] = p * (Ps[e] - delta_s[r]) * geo.scale;  // dS
    }
    __syncthreads();
    const int d = tid % HD;
#pragma unroll
    for (int j = 0; j < ACC; ++j) {
      const int r = tid / HD + j * RSTEP;
      if (r < BQ) {
        float a = acc[j];
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk)
          a = fmaf(Ss[r * BK + kk], Ks[kk * (HD + 1) + d], a);
        acc[j] = a;
      }
    }
    __syncthreads();
  }

  const int d = tid % HD;
#pragma unroll
  for (int j = 0; j < ACC; ++j) {
    const int r = tid / HD + j * RSTEP;
    if (r < BQ && q0 + r < geo.sq)
      dq[(((long long)bi * geo.sq + q0 + r) * geo.h + hi) * HD + d] =
          from_f32<T>(acc[j]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    const int* __restrict__ qoff, const int* __restrict__ kvlen, Strides st,
    Geometry geo) {
  extern __shared__ float smem[];
  float* Qs = smem;                       // [BQ][HD]
  float* Gs = Qs + BQ * HD;               // [BQ][HD]
  float* Ks = Gs + BQ * HD;               // [BK][HD + 1]
  float* Vs = Ks + BK * (HD + 1);         // [BK][HD + 1]
  float* Ss = Vs + BK * (HD + 1);         // [BQ][BK]: S, then P
  float* Ds = Ss + BQ * BK;               // [BQ][BK]: dP, then dS
  float* lse_s = Ds + BQ * BK;            // [BQ]
  float* delta_s = lse_s + BQ;            // [BQ]

  const int tid = threadIdx.x;
  const int bi = blockIdx.x / geo.kvh, kvhi = blockIdx.x % geo.kvh;
  const int n_rep = geo.h / geo.kvh;
  const int k0 = blockIdx.y * BK;
  const int lane_row = bi / (geo.b / geo.rows);
  const int qo = qoff ? qoff[lane_row] : 0;
  const int kl = kvlen ? min(max(kvlen[lane_row], 0), geo.sk) : geo.sk;

  const T* kb = k + bi * st.k[0] + kvhi * st.k[2];
  const T* vb = v + bi * st.v[0] + kvhi * st.v[2];

  // dk/dv rows j = tid / HD + t * RSTEP of the tile, column d = tid % HD
  constexpr int RSTEP = THREADS / HD;
  constexpr int ACC = (BK + RSTEP - 1) / RSTEP;
  float dk_acc[ACC], dv_acc[ACC];
#pragma unroll
  for (int t = 0; t < ACC; ++t) dk_acc[t] = dv_acc[t] = 0.f;

  // the query rows that can see this tile: [q_begin, q_end)
  int q_begin = 0, q_end = 0;
  if (k0 < kl) {
    const int k_last = min(k0 + BK, kl) - 1;
    q_begin = geo.causal ? max(0, k0 - qo) : 0;
    q_begin = (q_begin / BQ) * BQ;
    q_end = geo.window > 0 ? min(geo.sq, max(0, k_last + geo.window - qo))
                           : geo.sq;
  }
  if (q_begin < q_end) {
    load_rows<T, HD, BK, HD + 1>(Ks, kb, st.k[1], k0, geo.sk);
    load_rows<T, HD, BK, HD + 1>(Vs, vb, st.v[1], k0, geo.sk);
  }

  for (int rep = 0; rep < n_rep; ++rep) {
    const int hi = kvhi * n_rep + rep;
    const T* qb = q + bi * st.q[0] + hi * st.q[2];
    const T* gb = g + bi * st.g[0] + hi * st.g[2];
    const long long row = ((long long)bi * geo.h + hi) * geo.sq;
    for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
      __syncthreads();  // the previous tile's readers are done
      load_rows<T, HD, BQ, HD>(Qs, qb, st.q[1], q0, geo.sq);
      load_rows<T, HD, BQ, HD>(Gs, gb, st.g[1], q0, geo.sq);
      if (tid < BQ) {
        const bool in = q0 + tid < geo.sq;
        lse_s[tid] = in ? lse[row + q0 + tid] : 0.f;
        delta_s[tid] = in ? delta[row + q0 + tid] : 0.f;
      }
      __syncthreads();
      scores<HD>(Qs, Gs, Ks, Vs, Ss, Ds, geo.scale);
      __syncthreads();
      for (int e = tid; e < BQ * BK; e += THREADS) {
        const int r = e / BK, j = e % BK;
        const bool ok =
            q0 + r < geo.sq && visible(qo + q0 + r, k0 + j, kl, geo);
        const float p = ok ? expf(Ss[e] - lse_s[r]) : 0.f;
        Ss[e] = p;
        Ds[e] = p * (Ds[e] - delta_s[r]) * geo.scale;
      }
      __syncthreads();
      const int d = tid % HD;
#pragma unroll
      for (int t = 0; t < ACC; ++t) {
        const int j = tid / HD + t * RSTEP;
        if (j < BK) {
          float a = dv_acc[t], c = dk_acc[t];
#pragma unroll 8
          for (int r = 0; r < BQ; ++r) {
            a = fmaf(Ss[r * BK + j], Gs[r * HD + d], a);
            c = fmaf(Ds[r * BK + j], Qs[r * HD + d], c);
          }
          dv_acc[t] = a;
          dk_acc[t] = c;
        }
      }
    }
  }

  const int d = tid % HD;
#pragma unroll
  for (int t = 0; t < ACC; ++t) {
    const int j = tid / HD + t * RSTEP;
    if (j < BK && k0 + j < geo.sk) {
      const long long o =
          (((long long)bi * geo.sk + k0 + j) * geo.kvh + kvhi) * HD + d;
      dk[o] = from_f32<T>(dk_acc[t]);
      dv[o] = from_f32<T>(dv_acc[t]);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* g,
           const float* lse, const float* delta, void* dq, void* dk, void* dv,
           const int* qoff, const int* kvlen, const Strides& st,
           const Geometry& geo, cudaStream_t stream) {
  const int bytes = smem_floats<HD>() * (int)sizeof(float);
  // raise the blocks' shared-memory limit once per instantiation, so that a
  // launch captured in a CUDA graph makes no attribute call
  static bool limits_set = false;
  cudaError_t err;
  if (!limits_set) {
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    limits_set = true;
  }

  const dim3 dq_grid(geo.b * geo.h, (geo.sq + BQ - 1) / BQ);
  flash_bwd_dq_kernel<T, HD><<<dq_grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,
      static_cast<T*>(dq), qoff, kvlen, st, geo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 dkv_grid(geo.b * geo.kvh, (geo.sk + BK - 1) / BK);
  flash_bwd_dkv_kernel<T, HD><<<dkv_grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), qoff, kvlen, st, geo);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              const void* g, const float* lse, const float* delta, void* dq,
              void* dk, void* dv, const int* qoff, const int* kvlen,
              const Strides& st, const Geometry& geo, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, g, lse, delta, dq, dk, dv, qoff, kvlen, st,
                           geo, stream);
    case 32:
      return launch<T, 32>(q, k, v, g, lse, delta, dq, dk, dv, qoff, kvlen, st,
                           geo, stream);
    case 64:
      return launch<T, 64>(q, k, v, g, lse, delta, dq, dk, dv, qoff, kvlen, st,
                           geo, stream);
    case 128:
      return launch<T, 128>(q, k, v, g, lse, delta, dq, dk, dv, qoff, kvlen,
                            st, geo, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, g: (b, sq, h, hd); k, v: (b, sk, kvh, hd), each with unit stride on hd
// and the (batch, seq, head) element strides in `strides` (12 values: q, k,
// v, g).  lse, delta: contiguous f32 (b, h, sq).  dq: contiguous
// (b, sq, h, hd); dk, dv: contiguous (b, sk, kvh, hd), every element
// written.  qoff / kvlen: int32 device vectors of `rows` entries, or null.
// dtype: 0 = float32, 1 = bfloat16.  Returns the first CUDA error of the two
// launches (cudaErrorInvalidValue for an unsupported hd), else 0.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    const void* qoff, const void* kvlen, int rows, int b, int sq, int sk,
    int h, int kvh, int hd, const long long* strides, int causal, int window,
    int dtype, void* stream) {
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.g[i] = strides[9 + i];
  }
  const Geometry geo{rows, b, sq, sk, h, kvh, causal, window,
                     1.0f / sqrtf((float)hd)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* qo = static_cast<const int*>(qoff);
  const int* kl = static_cast<const int*>(kvlen);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, g, l, dl, dq, dk, dv, qo, kl,
                                    st, geo, s);
  return launch_hd<float>(hd, q, k, v, g, l, dl, dq, dk, dv, qo, kl, st, geo,
                          s);
}
