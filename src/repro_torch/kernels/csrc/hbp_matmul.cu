// K2, hbp_matmul: C = A @ B with an f32 accumulator, for sm_90a.
//
// Replaces src/repro/kernels/hbp_matmul.py:_mm_kernel (entry hbp_matmul).
//
// Bound on the H100: at the serving path's shapes it is bytes.  A decode
// step multiplies 4 rows by every weight matrix, so each weight byte is read
// once and used for 4 rows (8 flop/byte, far below the card's ~295 flop/byte
// ridge); a 256-row prefill is still below the ridge.  The design therefore
// puts its effort into keeping enough loads in flight:
//   * a 64 x 64 output tile per block, or 16 x 64 when A has at most 16 rows,
//     so a skinny A wastes little of each tensor-core tile;
//   * split-K over blockIdx.z when the output tiles alone cannot fill the
//     SMs: each split writes f32 partials to a workspace, and a second kernel
//     sums the splits in a fixed order (deterministic, no atomics);
//   * 16-byte vector loads where the operand's row stride and base allow,
//     masked scalar loads on ragged edges (no divisor snapping);
//   * B is read either as a row-major (k, n) matrix or as the transpose of a
//     row-major (n, k) matrix (the tied logits table), never copied; A the
//     same way, as a row-major (m, k) matrix or as the transpose of a
//     row-major (k, m) one (the activation in the backward's dB = A^T g).
// The backward's products run on this kernel too (training: 512 token rows
// against d_model 2048, d_ff 6144 and the 151936-row vocabulary); there the
// bf16 products sit at or above the card's ridge, and this kernel, with no
// software pipeline, is bound by its own instruction rate, not by either roof.
// bf16 inputs go through WMMA 16x16x16 bf16 -> f32; f32 inputs through plain
// FMA so that they stay full f32.  Output tiles are visited in plain
// row-major blockIdx order: the TPU kernel's Morton order is a schedule for a
// sequential grid and buys nothing for blocks that run in parallel.
// A simple, correct kernel: no TMA, no wgmma, no software pipeline yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 128;

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Copy the ROWS x COLS tile at (r0, c0) of a row-major matrix (R x C, row
// stride ld) into shared memory (row stride LDS), zero-filling outside it.
template <typename T, int ROWS, int COLS, int LDS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long ld,
                                          int r0, int c0, int R, int C,
                                          bool vec_ok) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = COLS / VEC;  // vectors per tile row
  static_assert(COLS % VEC == 0, "tile width must hold whole vectors");
  static_assert((LDS * sizeof(T)) % 16 == 0, "smem rows must stay 16B aligned");
  for (int i = threadIdx.x; i < ROWS * VPR; i += THREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * VEC;
    const int gr = r0 + r;
    const int gc = c0 + c;
    T* d = dst + r * LDS + c;
    if (vec_ok && gr < R && gc + VEC <= C) {
      *reinterpret_cast<uint4*>(d) =
          *reinterpret_cast<const uint4*>(src + (long long)gr * ld + gc);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        d[e] = (gr < R && gc + e < C) ? src[(long long)gr * ld + gc + e]
                                      : from_f32<T>(0.f);
      }
    }
  }
}

// One (BM x BN) output tile over the K range of split blockIdx.z.
template <typename T, typename TO, bool TRANS_A, bool TRANS_B, int BM>
__global__ void __launch_bounds__(THREADS)
    mm_kernel(const T* __restrict__ A, const T* __restrict__ B,
              TO* __restrict__ C, float* __restrict__ ws, int M, int N, int K,
              long long lda, long long ldb, long long ldc, int kchunk,
              bool vec_a, bool vec_b) {
  constexpr int PAD = 16 / sizeof(T);
  constexpr int LDA = TRANS_A ? BM + PAD : BK + PAD;  // As: [BM][LDA] or [BK][LDA]
  constexpr int LDB = TRANS_B ? BK + PAD : BN + PAD;  // Bs: [BK][LDB] or [BN][LDB]
  constexpr int A_ROWS = TRANS_A ? BK : BM;
  constexpr int B_ROWS = TRANS_B ? BN : BK;
  __shared__ __align__(128) T As[A_ROWS * LDA];
  __shared__ __align__(128) T Bs[B_ROWS * LDB];

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * kchunk;
  const int k_end = min(K, k_begin + kchunk);
  const bool split = gridDim.z > 1;

  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // 4 warps: 2 x 2 of 32 x 32 for BM = 64, 1 x 4 of 16 x 16 for BM = 16
    constexpr int WARPS_M = BM >= 64 ? 2 : 1;
    constexpr int WARPS_N = 4 / WARPS_M;
    constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
    constexpr int FM = WM / 16, FN = WN / 16;
    using ALayout = typename std::conditional<TRANS_A, wmma::col_major,
                                              wmma::row_major>::type;
    using BLayout = typename std::conditional<TRANS_B, wmma::col_major,
                                              wmma::row_major>::type;
    constexpr int LDC = BN + 4;
    __shared__ __align__(128) float Cs[BM * LDC];

    const int warp = threadIdx.x / 32;
    const int wm = warp / WARPS_N, wn = warp % WARPS_N;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    for (int k0 = k_begin; k0 < k_end; k0 += BK) {
      if constexpr (TRANS_A)
        load_tile<T, BK, BM, LDA>(As, A, lda, k0, m0, K, M, vec_a);
      else
        load_tile<T, BM, BK, LDA>(As, A, lda, m0, k0, M, K, vec_a);
      if constexpr (TRANS_B)
        load_tile<T, BN, BK, LDB>(Bs, B, ldb, n0, k0, N, K, vec_b);
      else
        load_tile<T, BK, BN, LDB>(Bs, B, ldb, k0, n0, K, N, vec_b);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout>
            fa[FM];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout>
            fb[FN];
#pragma unroll
        for (int i = 0; i < FM; ++i) {
          const int mm = wm * WM + i * 16;
          if constexpr (TRANS_A)
            wmma::load_matrix_sync(fa[i], As + kk * LDA + mm, LDA);
          else
            wmma::load_matrix_sync(fa[i], As + mm * LDA + kk, LDA);
        }
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          const int nn = wn * WN + j * 16;
          if constexpr (TRANS_B)
            wmma::load_matrix_sync(fb[j], Bs + nn * LDB + kk, LDB);
          else
            wmma::load_matrix_sync(fb[j], Bs + kk * LDB + nn, LDB);
        }
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int j = 0; j < FN; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::store_matrix_sync(Cs + (wm * WM + i * 16) * LDC + wn * WN + j * 16,
                                acc[i][j], LDC, wmma::mem_row_major);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int gr = m0 + r, gc = n0 + c;
      if (gr < M && gc < N) {
        const float val = Cs[r * LDC + c];
        if (split)
          ws[((long long)blockIdx.z * M + gr) * N + gc] = val;
        else
          C[(long long)gr * ldc + gc] = from_f32<TO>(val);
      }
    }
  } else {
    // f32: plain FMA, 16 x 8 threads, each TM rows x 8 strided columns
    constexpr int TN = 8;
    constexpr int TM = BM / (THREADS / (BN / TN));
    const int tr = threadIdx.x / (BN / TN);
    const int tc = threadIdx.x % (BN / TN);
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int k0 = k_begin; k0 < k_end; k0 += BK) {
      if constexpr (TRANS_A)
        load_tile<T, BK, BM, LDA>(As, A, lda, k0, m0, K, M, vec_a);
      else
        load_tile<T, BM, BK, LDA>(As, A, lda, m0, k0, M, K, vec_a);
      if constexpr (TRANS_B)
        load_tile<T, BN, BK, LDB>(Bs, B, ldb, n0, k0, N, K, vec_b);
      else
        load_tile<T, BK, BN, LDB>(Bs, B, ldb, k0, n0, K, N, vec_b);
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          a[i] = TRANS_A ? As[kk * LDA + tr * TM + i] : As[(tr * TM + i) * LDA + kk];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int nn = tc + j * (BN / TN);
          b[j] = TRANS_B ? Bs[nn * LDB + kk] : Bs[kk * LDB + nn];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gr = m0 + tr * TM + i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gc = n0 + tc + j * (BN / TN);
        if (gr < M && gc < N) {
          if (split)
            ws[((long long)blockIdx.z * M + gr) * N + gc] = acc[i][j];
          else
            C[(long long)gr * ldc + gc] = from_f32<TO>(acc[i][j]);
        }
      }
    }
  }
}

// Sum the split-K partials in split order and cast to the output type.
template <typename TO>
__global__ void splitk_reduce(const float* __restrict__ ws, TO* __restrict__ C,
                              int M, int N, long long ldc, int splits) {
  const long long mn = (long long)M * N;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[z * mn + i];
    C[(i / N) * ldc + i % N] = from_f32<TO>(s);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, typename TO, bool TRANS_A, bool TRANS_B, int BM>
void launch(const void* a, const void* b, void* c, void* ws, int m, int n,
            int k, long long lda, long long ldb, long long ldc, int splits,
            int kchunk, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec_a = lda % VEC == 0 && aligned16(a);
  const bool vec_b = ldb % VEC == 0 && aligned16(b);
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, splits);
  mm_kernel<T, TO, TRANS_A, TRANS_B, BM><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<TO*>(c),
      static_cast<float*>(ws), m, n, k, lda, ldb, ldc, kchunk, vec_a, vec_b);
  if (splits > 1) {
    const long long mn = (long long)m * n;
    const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
    splitk_reduce<TO><<<blocks, 256, 0, stream>>>(
        static_cast<const float*>(ws), static_cast<TO*>(c), m, n, ldc, splits);
  }
}

template <typename T, typename TO, bool TRANS_A, bool TRANS_B>
void launch_bm(int bm, const void* a, const void* b, void* c, void* ws, int m,
               int n, int k, long long lda, long long ldb, long long ldc,
               int splits, int kchunk, cudaStream_t stream) {
  if (bm == 16)
    launch<T, TO, TRANS_A, TRANS_B, 16>(a, b, c, ws, m, n, k, lda, ldb, ldc,
                                        splits, kchunk, stream);
  else
    launch<T, TO, TRANS_A, TRANS_B, 64>(a, b, c, ws, m, n, k, lda, ldb, ldc,
                                        splits, kchunk, stream);
}

template <typename T, typename TO, bool TRANS_A>
void launch_trans_b(int trans_b, int bm, const void* a, const void* b, void* c,
                    void* ws, int m, int n, int k, long long lda,
                    long long ldb, long long ldc, int splits, int kchunk,
                    cudaStream_t stream) {
  if (trans_b)
    launch_bm<T, TO, TRANS_A, true>(bm, a, b, c, ws, m, n, k, lda, ldb, ldc,
                                    splits, kchunk, stream);
  else
    launch_bm<T, TO, TRANS_A, false>(bm, a, b, c, ws, m, n, k, lda, ldb, ldc,
                                     splits, kchunk, stream);
}

template <typename T, typename TO>
void launch_trans(int trans_a, int trans_b, int bm, const void* a,
                  const void* b, void* c, void* ws, int m, int n, int k,
                  long long lda, long long ldb, long long ldc, int splits,
                  int kchunk, cudaStream_t stream) {
  if (trans_a)
    launch_trans_b<T, TO, true>(trans_b, bm, a, b, c, ws, m, n, k, lda, ldb,
                                ldc, splits, kchunk, stream);
  else
    launch_trans_b<T, TO, false>(trans_b, bm, a, b, c, ws, m, n, k, lda, ldb,
                                 ldc, splits, kchunk, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  trans_a: a is stored as a
// row-major (k, m) matrix with row stride lda (else row-major (m, k));
// trans_b likewise for b ((n, k) vs (k, n)).  bm is 16 or 64.  ws holds
// splits * m * n floats when splits > 1 (unused otherwise).  Returns the
// launch's cudaGetLastError().
extern "C" int hbp_matmul(const void* a, const void* b, void* c, void* ws,
                          int m, int n, int k, long long lda, long long ldb,
                          long long ldc, int trans_a, int trans_b,
                          int in_dtype, int out_dtype, int bm, int splits,
                          int kchunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 1 && out_dtype == 1)
    launch_trans<__nv_bfloat16, __nv_bfloat16>(trans_a, trans_b, bm, a, b, c,
                                               ws, m, n, k, lda, ldb, ldc,
                                               splits, kchunk, s);
  else if (in_dtype == 1 && out_dtype == 0)
    launch_trans<__nv_bfloat16, float>(trans_a, trans_b, bm, a, b, c, ws, m,
                                       n, k, lda, ldb, ldc, splits, kchunk, s);
  else if (in_dtype == 0 && out_dtype == 1)
    launch_trans<float, __nv_bfloat16>(trans_a, trans_b, bm, a, b, c, ws, m,
                                       n, k, lda, ldb, ldc, splits, kchunk, s);
  else
    launch_trans<float, float>(trans_a, trans_b, bm, a, b, c, ws, m, n, k,
                               lda, ldb, ldc, splits, kchunk, s);
  return static_cast<int>(cudaGetLastError());
}
