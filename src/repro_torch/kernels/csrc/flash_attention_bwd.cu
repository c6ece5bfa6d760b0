// K3, flash_attention backward: dq, dk, dv of online-softmax attention,
// recomputing the probabilities from the forward's f32 LSE, with native GQA,
// per-row lanes and causal / window / kv_len masks.
//
// Replaces src/repro/kernels/flash_attention.py:_bwd_dq_kernel (call :416)
// and :_bwd_dkv_kernel (call :459), launched by _bwd_call.  As there, two
// passes: one writes dq, the other dk and dv; each output element has one
// writer and no atomics are used, so the gradients are the same bits run to
// run.  delta = rowsum(dO * O): the bf16 instance's dq pass computes it for
// its rows (f32 from bf16, read from the staged dO and from O) and writes it
// for the dk/dv pass; the f32 instance takes it from the wrapper (a plain
// reduction, as the JAX package computes it outside Pallas).
//
// What bounds it on the H100 at the training path's shape (4 x 128
// queries, 16 query heads over 8 KV heads, hd 128, causal): ~10 MB in and
// out and ~0.17 GFLOP of small products, a bound of ~3 us; a call is a few
// microseconds of work, so latency (serial chains per block, blocks in
// flight) decides.  Two instances:
//   * bf16 (the *_mma kernels): every product on the tensor cores,
//     mma.sync m16n8k16 (bf16 in, f32 accumulate) on ldmatrix fragments
//     (mma_bf16.cuh).  Tiles stay bf16 in shared memory, rows padded to
//     hd + 8 (conflict-free ldmatrix), filled by 16-byte cp.async with zero
//     fill at the ragged edges and double-buffered, so the next tile loads
//     while this one is multiplied.  P = exp(S - lse) (__expf) and
//     dS = P * (dP - delta) * scale stay in registers in the accumulator
//     layout and are re-packed to A fragments where they feed the next
//     product, each as hi + lo bf16 (two mma): one bf16 rounding of P and
//     dS moved dv two bf16 ulps off the f32 reference at the training shape,
//     past chip_smoke.py's bf16 gate, as dv sums P dO over up to 2 x 128
//     query rows; hi + lo carries 16 bits.  So bf16 rounding happens at the outputs
//     only, plus the ~2^-17 of the split; S, dP, lse, delta and every sum
//     are f32.
//       - dq pass: the forward's grid (mma_bf16.cuh, query_grid), spread
//         to two blocks per SM: a block is a KV head's rg query heads times
//         qg 16-row groups, one warp per (head, 16 rows), sharing 32-key K/V
//         tiles; each warp first forms delta for its rows, then per tile
//         S = Q K^T and dP = dO V^T, and dq += dS K, accumulated in
//         registers.  Training shape: 32 x 8 = 256 blocks of 2 warps.
//       - dk/dv pass: one block per (batch row, KV head, 16 keys), 4 warps
//         that share the key tile and split its query loop: warp w takes
//         the (query head of the group, 16-row query tile) tasks w, w + 4,
//         ..., each warp double-buffering its own Q / dO / lse / delta
//         tiles (no block barrier inside the loop).  A warp computes
//         S^T = K Q^T and dP^T = V dO^T for its 16 keys and accumulates
//         dV += P^T dO and dK += dS^T Q in f32 registers (the GQA group sum
//         happens there); the four warps' partial sums then meet in shared
//         memory and are added in warp order, a fixed order, before the
//         bf16 write.  Training shape: 32 x 8 = 256 blocks of 4 warps, two
//         per SM of the 132.  A tile past kv_len, or one no query sees,
//         writes zeros: every slot of dk/dv is written.
//       - hd 256 (gemma3-1b): dk and dv of 16 keys x 256 columns in f32 are
//         256 registers a warp, dq 128.  Both passes then split the columns
//         in halves over the grid's z (col_slice): each block recomputes S
//         and dP over the full hd and accumulates its 128 columns, so its
//         accumulators are hd 128's (dq pass 194 registers, dk/dv 252, no
//         spill); the dq pass's z = 0 block writes delta.  One writer per
//         element still.
//   * f32 (flash_bwd_dq_kernel, flash_bwd_dkv_kernel): f32 FMA out of
//     shared memory, kept where the f32 gates leave no room for TF32 or
//     bf16 rounding.  dq: one block per (batch row, query head, BQ queries)
//     walking the KV tiles; dk/dv: one block per (batch row, KV head, BK
//     keys) walking the group's query heads and tiles.  Tiles live in
//     dynamic shared memory as f32 (52.4 KB at hd 128, 102.8 KB at hd 256,
//     where each thread owns two columns of every row).
// Both read q, k, v and dO in the model's (b, s, heads, hd) layout through
// their strides (unit stride on hd); query head hi of batch row bi uses KV
// head hi / n_rep; lanes as in K1 (lane = bi / (b / rows)).  Masked
// probabilities are zeroed explicitly, never left to underflow: a fully
// masked row has lse ~ NEG_INF, where exp(S - lse) would be 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_bf16.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int BQ = 16;   // query rows per tile
constexpr int BK = 32;   // keys per tile

// the FMA template's element conversions; it is instantiated for f32 only
// (bf16 runs the tensor-core kernels below)
template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

// Element strides of q, k, v, dO and O: (batch, seq, head) for each, unit
// on hd.
struct Strides {
  long long q[3], k[3], v[3], g[3], o[3];
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

  // a thread owns column tid % HD of dq rows tid / HD + j * RSTEP, and past
  // hd 128 columns tid + c * THREADS of every row
  constexpr int RSTEP = HD > THREADS ? 1 : THREADS / HD;  // dq rows per pass
  constexpr int CPT = HD > THREADS ? HD / THREADS : 1;    // dq columns per thread
  constexpr int ACC = (BQ + RSTEP - 1) / RSTEP;           // dq rows per thread
  float acc[ACC][CPT];
#pragma unroll
  for (int j = 0; j < ACC; ++j)
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) acc[j][cc] = 0.f;

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
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) {
          float a = acc[j][cc];
#pragma unroll 8
          for (int kk = 0; kk < BK; ++kk)
            a = fmaf(Ss[r * BK + kk], Ks[kk * (HD + 1) + d + cc * THREADS], a);
          acc[j][cc] = a;
        }
      }
    }
    __syncthreads();
  }

  const int d = tid % HD;
#pragma unroll
  for (int j = 0; j < ACC; ++j) {
    const int r = tid / HD + j * RSTEP;
    if (r < BQ && q0 + r < geo.sq)
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc)
        dq[(((long long)bi * geo.sq + q0 + r) * geo.h + hi) * HD + d + cc * THREADS] =
            from_f32<T>(acc[j][cc]);
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
  // (past hd 128 columns tid + c * THREADS of every row)
  constexpr int RSTEP = HD > THREADS ? 1 : THREADS / HD;
  constexpr int CPT = HD > THREADS ? HD / THREADS : 1;
  constexpr int ACC = (BK + RSTEP - 1) / RSTEP;
  float dk_acc[ACC][CPT], dv_acc[ACC][CPT];
#pragma unroll
  for (int t = 0; t < ACC; ++t)
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) dk_acc[t][cc] = dv_acc[t][cc] = 0.f;

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
#pragma unroll
          for (int cc = 0; cc < CPT; ++cc) {
            float a = dv_acc[t][cc], c = dk_acc[t][cc];
#pragma unroll 8
            for (int r = 0; r < BQ; ++r) {
              a = fmaf(Ss[r * BK + j], Gs[r * HD + d + cc * THREADS], a);
              c = fmaf(Ds[r * BK + j], Qs[r * HD + d + cc * THREADS], c);
            }
            dv_acc[t][cc] = a;
            dk_acc[t][cc] = c;
          }
        }
      }
    }
  }

  const int d = tid % HD;
#pragma unroll
  for (int t = 0; t < ACC; ++t) {
    const int j = tid / HD + t * RSTEP;
    if (j < BK && k0 + j < geo.sk) {
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const long long o =
            (((long long)bi * geo.sk + k0 + j) * geo.kvh + kvhi) * HD + d + cc * THREADS;
        dk[o] = from_f32<T>(dk_acc[t][cc]);
        dv[o] = from_f32<T>(dv_acc[t][cc]);
      }
    }
  }
}

// ---- the tensor-core instance: bf16 q, k, v, dO ----------------------------

// keys per K/V tile of the dq pass: with 64, ptxas spilled the hd-16
// instance and held hd 128 at 244 registers; 32 keeps every instance
// spill-free at <= 168
constexpr int DQ_BK = 32;
constexpr int DKV_KEYS = 16;   // keys per block of the dk/dv pass
constexpr int DKV_WARPS = 4;   // warps splitting its query loop

// Columns of dq (dq pass) and of dk and dv (dk/dv pass) that one block
// accumulates in registers: all of them up to hd 128; at hd 256 half, so
// that a warp's f32 accumulators stay at hd 128's (dq 64 registers, dk and
// dv 128).  The grid's z then takes the column slice, and each slice's
// block recomputes S and dP over the full hd.
template <int HD>
__host__ __device__ constexpr int col_slice() { return HD > 128 ? 128 : HD; }

template <int HD>
constexpr int dq_mma_smem_bytes(int warps) {
  return (2 * warps * 16 + 4 * DQ_BK) * mma_bf16::pad_ld<HD>() * 2;
}

// K and V tiles; per warp two stages of Q and dO tiles and of lse and delta.
// After the loop the Q / dO region holds the warps' f32 partial dk and dv.
template <int HD>
constexpr int dkv_mma_smem_bytes() {  // the partials are [2][DKV_WARPS][DKV_KEYS][col_slice]
  return (2 * DKV_KEYS + DKV_WARPS * 4 * 16) * mma_bf16::pad_ld<HD>() * 2 +
         DKV_WARPS * 4 * 16 * 4;
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int kl, int causal, int window) {
  return kpos < kl && (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
}

// (THREADS, 1): without the bound of one block per SM, ptxas held the hd-16
// and hd-32 instances to 72 and 96 registers and spilled
template <int HD>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ g,
    const __nv_bfloat16* __restrict__ o, const float* __restrict__ lse,
    float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, const int* __restrict__ qoff,
    const int* __restrict__ kvlen, Strides st, Geometry geo, int rg, int qg) {
  using namespace mma_bf16;
  constexpr int LD = pad_ld<HD>();
  constexpr int KS = HD / 16;    // k-steps of Q K^T and dO V^T
  constexpr int NB = DQ_BK / 8;  // 8-key column blocks of S and dP
  constexpr int DB = col_slice<HD>() / 8;  // 8-column blocks of this block's dq slice
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = rg * qg;
  // the dq columns this block accumulates (all of them up to hd 128)
  const int col0 = HD > col_slice<HD>() ? (int)blockIdx.z * col_slice<HD>() : 0;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [warps * 16][LD]
  bf16* Gs = Qs + warps * 16 * LD;                // [warps * 16][LD]
  bf16* Ks = Gs + warps * 16 * LD;                // [2][DQ_BK][LD]
  bf16* Vs = Ks + 2 * DQ_BK * LD;                 // [2][DQ_BK][LD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_rep = geo.h / geo.kvh, groups = n_rep / rg;
  const int gi = blockIdx.x % groups;
  const int kvhi = (blockIdx.x / groups) % geo.kvh;
  const int bi = blockIdx.x / (groups * geo.kvh);
  const int q0 = blockIdx.y * qg * 16;
  const int lane_row = bi / (geo.b / geo.rows);
  const int qo = qoff ? qoff[lane_row] : 0;
  const int kl = kvlen ? min(max(kvlen[lane_row], 0), geo.sk) : geo.sk;
  const int sq = geo.sq;

  const int hi = kvhi * n_rep + gi * rg + warp % rg;
  const int wq0 = q0 + (warp / rg) * 16;
  const bf16* kb = k + bi * st.k[0] + kvhi * st.k[2];
  const bf16* vb = v + bi * st.v[0] + kvhi * st.v[2];
  bf16* Qw = Qs + warp * 16 * LD;
  bf16* Gw = Gs + warp * 16 * LD;
  stage_rows<HD>(Qw, q + bi * st.q[0] + hi * st.q[2], st.q[1], wq0, 16, sq, lane, 32);
  stage_rows<HD>(Gw, g + bi * st.g[0] + hi * st.g[2], st.g[1], wq0, 16, sq, lane, 32);

  const int q_last = min(q0 + qg * 16, sq) - 1;
  const int kv_end = geo.causal ? min(kl, qo + q_last + 1) : kl;
  int kv_begin = geo.window > 0 ? max(0, qo + q0 - geo.window + 1) : 0;
  kv_begin = (kv_begin / DQ_BK) * DQ_BK;
  const bool w_rows = wq0 < sq;
  const int w_end = geo.causal ? min(kl, qo + min(wq0 + 16, sq)) : kl;
  const int w_begin = geo.window > 0 ? max(0, qo + wq0 - geo.window + 1) : 0;

  auto load_kv = [&](int k0, int sb) {
    stage_rows<HD>(Ks + sb * DQ_BK * LD, kb, st.k[1], k0, DQ_BK, geo.sk, tid, blockDim.x);
    stage_rows<HD>(Vs + sb * DQ_BK * LD, vb, st.v[1], k0, DQ_BK, geo.sk, tid, blockDim.x);
  };
  cp_async_commit();  // the warp's Q and dO rows
  if (kv_begin < kv_end) load_kv(kv_begin, 0);
  cp_async_commit();

  // delta = rowsum(dO * O) of the warp's 16 rows, in f32 from bf16, two
  // lanes per row (dO from the staged tile, O from device memory); written
  // for the dk/dv pass, which runs next on the stream
  const long long row = ((long long)bi * geo.h + hi) * sq;
  cp_async_wait<1>();
  __syncwarp();
  float dsum = 0.f;
  {
    const int rr = lane / 2, half = (lane % 2) * (HD / 2);
    if (wq0 + rr < sq) {
      const bf16* orow = o + bi * st.o[0] + hi * st.o[2] + (wq0 + rr) * st.o[1] + half;
      const bf16* grow = Gw + rr * LD + half;
#pragma unroll
      for (int d = 0; d < HD / 2; d += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + d);
        const uint4 gv = *reinterpret_cast<const uint4*>(grow + d);
        const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 a = __bfloat1622float2(op[i]), b = __bfloat1622float2(gp[i]);
          dsum = fmaf(a.x, b.x, dsum);
          dsum = fmaf(a.y, b.y, dsum);
        }
      }
    }
    dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
    if (lane % 2 == 0 && wq0 + rr < sq && col0 == 0) delta[row + wq0 + rr] = dsum;
  }

  // rows r and r + 8 of the warp: their lse and delta (row i's sum is in
  // lane 2 i)
  const int r = lane / 4, c = 2 * (lane % 4);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qrow = wq0 + r + 8 * i;
    lse_r[i] = qrow < sq ? lse[row + qrow] : 0.f;
    delta_r[i] = __shfl_sync(0xffffffffu, dsum, 2 * (r + 8 * i));
  }
  float acc[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  int t = 0;
  for (int k0 = kv_begin; k0 < kv_end; k0 += DQ_BK, ++t) {
    const int sb = t & 1;
    if (k0 + DQ_BK < kv_end) load_kv(k0 + DQ_BK, sb ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (w_rows && k0 < w_end && k0 + DQ_BK > w_begin) {
      const bf16* Kt = Ks + sb * DQ_BK * LD;
      const bf16* Vt = Vs + sb * DQ_BK * LD;
      float s[NB][4], dp[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t qa[4], ga[4];
        load_a(qa, Qw, LD, ks * 16, lane);
        load_a(ga, Gw, LD, ks * 16, lane);
#pragma unroll
        for (int j = 0; j < NB; j += 2) {
          uint32_t bb[4];
          load_b_rows(bb, Kt, LD, j * 8, ks * 16, lane);
          mma(s[j], qa, bb[0], bb[1]);
          mma(s[j + 1], qa, bb[2], bb[3]);
          load_b_rows(bb, Vt, LD, j * 8, ks * 16, lane);
          mma(dp[j], ga, bb[0], bb[1]);
          mma(dp[j + 1], ga, bb[2], bb[3]);
        }
      }
      // dS = P * (dP - delta) * scale, P = exp(S * scale - lse), in place of S
#pragma unroll
      for (int j = 0; j < NB; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e / 2;
          const bool ok = wq0 + r + 8 * i < sq &&
                          visible(qo + wq0 + r + 8 * i, k0 + j * 8 + c + (e % 2), kl,
                                  geo.causal, geo.window);
          const float p = ok ? __expf(s[j][e] * geo.scale - lse_r[i]) : 0.f;
          s[j][e] = p * (dp[j][e] - delta_r[i]) * geo.scale;
        }
      }
      // dq += dS K, dS re-packed from the accumulators as hi + lo bf16 A
      // fragments (two products)
#pragma unroll
      for (int kk = 0; kk < NB / 2; ++kk) {
        uint32_t a_hi[4], a_lo[4];
        pack_a_split(a_hi, a_lo, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int j = 0; j < DB; j += 2) {
          uint32_t bb[4];
          load_b_cols(bb, Kt, LD, kk * 16, col0 + j * 8, lane);
          mma(acc[j], a_hi, bb[0], bb[1]);
          mma(acc[j + 1], a_hi, bb[2], bb[3]);
          mma(acc[j], a_lo, bb[0], bb[1]);
          mma(acc[j + 1], a_lo, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qrow = wq0 + r + 8 * i;
    if (!w_rows || qrow >= sq) continue;
    bf16* drow = dq + (((long long)bi * sq + qrow) * geo.h + hi) * HD + col0;
#pragma unroll
    for (int j = 0; j < DB; ++j)
      *reinterpret_cast<__nv_bfloat162*>(drow + j * 8 + c) =
          __floats2bfloat162_rn(acc[j][2 * i], acc[j][2 * i + 1]);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    const int* __restrict__ qoff, const int* __restrict__ kvlen, Strides st, Geometry geo) {
  using namespace mma_bf16;
  constexpr int LD = pad_ld<HD>();
  constexpr int KS = HD / 16;  // k-steps of K Q^T and V dO^T
  constexpr int DW = col_slice<HD>();  // dk and dv columns of this block
  constexpr int DB = DW / 8;   // 8-column blocks of dk and dv
  static_assert(2 * DKV_WARPS * DKV_KEYS * DW * 4 <= DKV_WARPS * 4 * 16 * LD * 2,
                "the partial sums must fit in the Q / dO region");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [DKV_KEYS][LD]
  bf16* Vs = Ks + DKV_KEYS * LD;                  // [DKV_KEYS][LD]
  bf16* Ws = Vs + DKV_KEYS * LD;                  // per warp: Q [2][16][LD], dO [2][16][LD]
  float* Ls = reinterpret_cast<float*>(Ws + DKV_WARPS * 4 * 16 * LD);  // per warp: lse, delta [2][16]
  float* part = reinterpret_cast<float*>(Ws);     // after the loop: [2][DKV_WARPS][DKV_KEYS][DW]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bi = blockIdx.x / geo.kvh, kvhi = blockIdx.x % geo.kvh;
  const int n_rep = geo.h / geo.kvh, sq = geo.sq;
  const int k0 = blockIdx.y * DKV_KEYS;
  const int col0 = HD > DW ? (int)blockIdx.z * DW : 0;  // this block's dk/dv columns
  const int lane_row = bi / (geo.b / geo.rows);
  const int qo = qoff ? qoff[lane_row] : 0;
  const int kl = kvlen ? min(max(kvlen[lane_row], 0), geo.sk) : geo.sk;

  stage_rows<HD>(Ks, k + bi * st.k[0] + kvhi * st.k[2], st.k[1], k0, DKV_KEYS, geo.sk, tid,
                 blockDim.x);
  stage_rows<HD>(Vs, v + bi * st.v[0] + kvhi * st.v[2], st.v[1], k0, DKV_KEYS, geo.sk, tid,
                 blockDim.x);
  cp_async_commit();

  // the query rows that can see this key tile: [q_begin, q_end), in tiles
  // of 16 rows, for each of the group's n_rep query heads
  int q_begin = 0, q_end = 0;
  if (k0 < kl) {
    const int k_last = min(k0 + DKV_KEYS, kl) - 1;
    q_begin = geo.causal ? max(0, k0 - qo) : 0;
    q_end = geo.window > 0 ? min(sq, max(0, k_last + geo.window - qo)) : sq;
  }
  const int n_qt = q_begin < q_end ? (q_end - q_begin + 15) / 16 : 0;
  const int n_tasks = n_rep * n_qt;

  bf16* Qw = Ws + warp * 4 * 16 * LD;  // [2][16][LD]
  bf16* Gw = Qw + 2 * 16 * LD;          // [2][16][LD]
  float* Lw = Ls + warp * 4 * 16;       // [2][16]
  float* Dw = Lw + 2 * 16;              // [2][16]
  auto issue = [&](int task, int sb) {
    const int hi = kvhi * n_rep + task / n_qt;
    const int qt0 = q_begin + (task % n_qt) * 16;
    stage_rows<HD>(Qw + sb * 16 * LD, q + bi * st.q[0] + hi * st.q[2], st.q[1], qt0, 16, sq,
                   lane, 32);
    stage_rows<HD>(Gw + sb * 16 * LD, g + bi * st.g[0] + hi * st.g[2], st.g[1], qt0, 16, sq,
                   lane, 32);
    const long long row = ((long long)bi * geo.h + hi) * sq;
    const int i = lane % 16;
    const bool in = qt0 + i < sq;
    const float* src = lane < 16 ? lse : delta;
    float* dst = lane < 16 ? Lw : Dw;
    cp_async4(dst + sb * 16 + i, src + row + (in ? qt0 + i : 0), in);
  };
  int task = warp;
  if (task < n_tasks) issue(task, 0);
  cp_async_commit();
  cp_async_wait<1>();  // this thread's K / V copies have landed
  __syncthreads();     // ... and every thread's

  const int r = lane / 4, c = 2 * (lane % 4);
  float dka[DB][4], dva[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int it = 0; task < n_tasks; ++it, task += DKV_WARPS) {
    const int sb = it & 1;
    if (task + DKV_WARPS < n_tasks) issue(task + DKV_WARPS, sb ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const int qt0 = q_begin + (task % n_qt) * 16;
    const bf16* Qt = Qw + sb * 16 * LD;
    const bf16* Gt = Gw + sb * 16 * LD;
    const float* Lt = Lw + sb * 16;
    const float* Dt = Dw + sb * 16;
    // S^T = K Q^T and dP^T = V dO^T: rows are this block's keys, columns
    // the task's 16 query rows
    float s[2][4], dp[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4], bb[4];
      load_a(a, Ks, LD, ks * 16, lane);
      load_b_rows(bb, Qt, LD, 0, ks * 16, lane);
      mma(s[0], a, bb[0], bb[1]);
      mma(s[1], a, bb[2], bb[3]);
      load_a(a, Vs, LD, ks * 16, lane);
      load_b_rows(bb, Gt, LD, 0, ks * 16, lane);
      mma(dp[0], a, bb[0], bb[1]);
      mma(dp[1], a, bb[2], bb[3]);
    }
    // P^T and dS^T = P^T * (dP^T - delta) * scale, in place
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + c + (e % 2);
        const int ql = qt0 + col;
        const bool ok = ql < sq && visible(qo + ql, k0 + r + (e / 2) * 8, kl, geo.causal,
                                           geo.window);
        const float p = ok ? __expf(s[j][e] * geo.scale - Lt[col]) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - Dt[col]) * geo.scale;
      }
    }
    // dV += P^T dO and dK += dS^T Q, both A operands re-packed as hi + lo
    // bf16 (two products each)
    uint32_t p_hi[4], p_lo[4], d_hi[4], d_lo[4];
    pack_a_split(p_hi, p_lo, s[0], s[1]);
    pack_a_split(d_hi, d_lo, dp[0], dp[1]);
#pragma unroll
    for (int j = 0; j < DB; j += 2) {
      uint32_t bb[4];
      load_b_cols(bb, Gt, LD, 0, col0 + j * 8, lane);
      mma(dva[j], p_hi, bb[0], bb[1]);
      mma(dva[j + 1], p_hi, bb[2], bb[3]);
      mma(dva[j], p_lo, bb[0], bb[1]);
      mma(dva[j + 1], p_lo, bb[2], bb[3]);
      load_b_cols(bb, Qt, LD, 0, col0 + j * 8, lane);
      mma(dka[j], d_hi, bb[0], bb[1]);
      mma(dka[j + 1], d_hi, bb[2], bb[3]);
      mma(dka[j], d_lo, bb[0], bb[1]);
      mma(dka[j + 1], d_lo, bb[2], bb[3]);
    }
    __syncwarp();  // every lane is done with stage sb before it is refilled
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its tiles: the region takes the partials

#pragma unroll
  for (int j = 0; j < DB; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int o = (warp * DKV_KEYS + r + 8 * i) * DW + j * 8 + c;
      *reinterpret_cast<float2*>(part + o) = make_float2(dka[j][2 * i], dka[j][2 * i + 1]);
      *reinterpret_cast<float2*>(part + DKV_WARPS * DKV_KEYS * DW + o) =
          make_float2(dva[j][2 * i], dva[j][2 * i + 1]);
    }
  }
  __syncthreads();
  // the warps' partial sums added in warp order (fixed), written as bf16
  for (int e = 2 * tid; e < DKV_KEYS * DW; e += 2 * blockDim.x) {
    const int key = e / DW;
    if (k0 + key >= geo.sk) continue;
    float2 sk_ = make_float2(0.f, 0.f), sv = make_float2(0.f, 0.f);
#pragma unroll
    for (int w = 0; w < DKV_WARPS; ++w) {
      const float2 a = *reinterpret_cast<const float2*>(part + w * DKV_KEYS * DW + e);
      const float2 b = *reinterpret_cast<const float2*>(
          part + (DKV_WARPS + w) * DKV_KEYS * DW + e);
      sk_.x += a.x;
      sk_.y += a.y;
      sv.x += b.x;
      sv.y += b.y;
    }
    const long long o =
        (((long long)bi * geo.sk + k0 + key) * geo.kvh + kvhi) * HD + col0 + e % DW;
    *reinterpret_cast<__nv_bfloat162*>(dk + o) = __floats2bfloat162_rn(sk_.x, sk_.y);
    *reinterpret_cast<__nv_bfloat162*>(dv + o) = __floats2bfloat162_rn(sv.x, sv.y);
  }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, const void* g, const void* o,
               const float* lse, float* delta, void* dq, void* dk, void* dv,
               const int* qoff, const int* kvlen, const Strides& st, const Geometry& geo,
               cudaStream_t stream) {
  typedef __nv_bfloat16 bf16;
  mma_bf16::QueryGrid qgrid = mma_bf16::query_grid(geo.b, geo.sq, geo.h, geo.kvh, true);
  constexpr unsigned slices = HD / col_slice<HD>();  // the grids' z: column slices
  qgrid.grid.z = slices;
  // raise the blocks' shared-memory limits once per instantiation (to the
  // largest dq block), so that a launch captured in a CUDA graph makes no
  // attribute call
  static bool limits_set = false;
  cudaError_t err;
  if (!limits_set) {
    err = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dq_mma_smem_bytes<HD>(THREADS / 32));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(flash_bwd_dkv_mma_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dkv_mma_smem_bytes<HD>());
    if (err != cudaSuccess) return static_cast<int>(err);
    limits_set = true;
  }
  flash_bwd_dq_mma_kernel<HD><<<qgrid.grid, 32 * qgrid.warps(),
                                dq_mma_smem_bytes<HD>(qgrid.warps()), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), static_cast<const bf16*>(o), lse, delta,
      static_cast<bf16*>(dq), qoff, kvlen, st, geo, qgrid.rg, qgrid.qg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 dkv_grid(geo.b * geo.kvh, (geo.sk + DKV_KEYS - 1) / DKV_KEYS, slices);
  flash_bwd_dkv_mma_kernel<HD><<<dkv_grid, 32 * DKV_WARPS, dkv_mma_smem_bytes<HD>(), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      qoff, kvlen, st, geo);
  return static_cast<int>(cudaGetLastError());
}

int launch_mma_hd(int hd, const void* q, const void* k, const void* v, const void* g,
                  const void* o, const float* lse, float* delta, void* dq, void* dk, void* dv,
                  const int* qoff, const int* kvlen, const Strides& st, const Geometry& geo,
                  cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch_mma<16>(q, k, v, g, o, lse, delta, dq, dk, dv, qoff, kvlen, st, geo,
                            stream);
    case 32:
      return launch_mma<32>(q, k, v, g, o, lse, delta, dq, dk, dv, qoff, kvlen, st, geo,
                            stream);
    case 64:
      return launch_mma<64>(q, k, v, g, o, lse, delta, dq, dk, dv, qoff, kvlen, st, geo,
                            stream);
    case 128:
      return launch_mma<128>(q, k, v, g, o, lse, delta, dq, dk, dv, qoff, kvlen, st, geo,
                             stream);
    case 256:
      return launch_mma<256>(q, k, v, g, o, lse, delta, dq, dk, dv, qoff, kvlen, st, geo,
                             stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
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
    case 256:
      return launch<T, 256>(q, k, v, g, lse, delta, dq, dk, dv, qoff, kvlen,
                            st, geo, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, g, o (the forward's output): (b, sq, h, hd); k, v: (b, sk, kvh, hd),
// each with unit stride on hd and the (batch, seq, head) element strides in
// `strides` (15 values: q, k, v, g, o).  lse, delta: contiguous f32
// (b, h, sq).  dtype 0 = float32: delta = rowsum(dO * O) is an input, o is
// not read.  dtype 1 = bfloat16 (the tensor-core kernels; every pointer
// 16-byte aligned, every stride a multiple of 8 elements): the dq pass
// computes delta from g and o and writes it.  dq: contiguous (b, sq, h, hd);
// dk, dv: contiguous (b, sk, kvh, hd), every element written.  qoff / kvlen:
// int32 device vectors of `rows` entries, or null.  Returns the first CUDA
// error of the two launches (cudaErrorInvalidValue for an unsupported hd),
// else 0.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* g, const void* o,
    const void* lse, void* delta, void* dq, void* dk, void* dv,
    const void* qoff, const void* kvlen, int rows, int b, int sq, int sk,
    int h, int kvh, int hd, const long long* strides, int causal, int window,
    int dtype, void* stream) {
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.g[i] = strides[9 + i];
    st.o[i] = strides[12 + i];
  }
  const Geometry geo{rows, b, sq, sk, h, kvh, causal, window,
                     1.0f / sqrtf((float)hd)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const int* qo = static_cast<const int*>(qoff);
  const int* kl = static_cast<const int*>(kvlen);
  if (dtype == 1)
    return launch_mma_hd(hd, q, k, v, g, o, l, dl, dq, dk, dv, qo, kl, st, geo, s);
  return launch_hd<float>(hd, q, k, v, g, l, dl, dq, dk, dv, qo, kl, st, geo,
                          s);
}
