// K7, bi_fft: the DFT along the last axis of x (rows, n), n = n1 * n2 a power
// of two, into complex64 X (rows, n), for sm_90a.
//
// Replaces src/repro/kernels/bi_fft.py:bi_fft and :_cmatmul.  The TPU
// version is the four-step (Bailey) split, the paper's Type 2 HBP recursion
// unrolled one level: view a row as A[j1, j2] = x[j1 n2 + j2], DFT each column
// (length n1), twiddle by exp(-2 pi i k1 j2 / n), DFT each row (length n2),
// read out transposed, X[k2 n1 + k1] = C[k1, k2].  There every small DFT is a
// dense product on the MXU (four real K2 products per complex one), which is
// O(n^1.5) work.  Here the split stays, and each small DFT is an O(L log L)
// Stockham FFT held in shared memory: radix-4 butterflies in registers (one
// radix-2 stage first where log2 L is odd), one exchange through shared
// memory per stage, output in natural order.
//
// Bound on the H100: bytes.  The function reads x once and writes X once,
// 2 rows n 8 bytes; its 5 n log2 n f32 operations a row (1.3e9 in all at
// (256, 65536)) need a quarter of the bytes' time at 67 TFLOP/s.
// The two passes each read and write the data once, 4 rows n 8 bytes, twice
// the bound's traffic (one pass over rows held in a thread-block cluster is
// the way to the bound).  What the design does about the bytes:
//   * pass 1, fft_cols_kernel: a block takes W consecutive columns
//     (r, j2) -> c = r n2 + j2 and all n1 rows j1 of them, a [n1][W] tile,
//     loaded with 16-byte accesses, W 8-byte elements of a row contiguous
//     (W >= 16, whole 128-byte lines, for n1 <= 512); it runs the length-n1
//     FFT down each column, multiplies by the inter-pass twiddle in the
//     epilogue, and stores B[r, k1, j2] laid out like x, so both sides are
//     whole row segments;
//   * pass 2, fft_lines_kernel: a block takes W consecutive lines
//     l = r n1 + k1 (B's lines are contiguous, so its input is one block of
//     W n2 elements), loads them with 16-byte accesses into the same [n2][W]
//     tile layout (the transpose happens on the way in), runs the length-n2
//     FFT, and writes X[r, k2 n1 + k1] row by row of the tile: W consecutive
//     k1 of one k2, whole 128-byte segments where n1 >= W; where n1 < W the
//     tile is W / n1 whole rows of X, one contiguous block;
//   * a degenerate split (n1 or n2 is 1) is one fft_lines_kernel pass of
//     length n over the rows of x, with n1 = 1 in its readout;
//   * past a pass's MAX_PASS lines (n2 > 4096: n past 2^24 at plan_fft's
//     split) the C entry bi_fft_cols runs pass 1 alone, and the wrapper runs
//     pass 2 as a bi_fft of length n2 over the rows n1 lines of B and reads
//     it out transposed through K6 (bi_transpose).
// The tile keeps element (j, w) of row j and line (column) w with its
// 16-byte chunk w / 2 at chunk (w / 2) ^ ((j / 2) & min(7, W / 2 - 1)): each
// row is a permutation of its own chunks, so the butterflies (lanes on
// consecutive w of a row) and the row-wise loads and stores stay
// conflict-free, and a half warp that moves two elements (j, w), (j + 1, w)
// for eight chunks of two lines w, w + 1 (the transposed loads and stores)
// meets sixteen different bank pairs.  Tiles: 4096 elements (32 KB, 256
// threads) for lines of up to 256, 8192 (64 KB, 512 threads) up to MAX_PASS;
// each thread moves eight 16-byte chunks, its loads issued before any is
// stored (in two batches of four in pass 2, whose transposed stores need
// more registers).  Every twiddle comes from a table
// the wrapper builds in f64 and rounds to f32: the length-L roots of unity
// for each pass (read through the read-only cache, one address per half
// warp) and the n1 x n2 inter-pass table (read in 16-byte pairs,
// L2-resident across rows).
// Products are rounded as the plain version rounds them (__fmul_rn and
// friends: no FMA contraction), so the two agree to the last bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LOG_MAX_PASS = 12;  // MAX_PASS = 4096, bi_fft.MAX_PASS

__host__ __device__ constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v / 2); }

// ---- complex arithmetic, each product and sum rounded once ----------------

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
// a * (-i), exact
__device__ __forceinline__ float2 cmul_neg_i(float2 a) { return make_float2(a.y, -a.x); }
__device__ __forceinline__ float2 cmul(float2 a, float2 t) {
  return make_float2(__fsub_rn(__fmul_rn(a.x, t.x), __fmul_rn(a.y, t.y)),
                     __fadd_rn(__fmul_rn(a.x, t.y), __fmul_rn(a.y, t.x)));
}

// the length-R DFT of v in place, R = 2 or 4
template <int R>
__device__ __forceinline__ void dft(float2 (&v)[R]) {
  if constexpr (R == 2) {
    const float2 a = v[0];
    v[0] = cadd(a, v[1]);
    v[1] = csub(a, v[1]);
  } else {
    const float2 t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
    const float2 t2 = cadd(v[1], v[3]), t3 = cmul_neg_i(csub(v[1], v[3]));
    v[0] = cadd(t0, t2);
    v[1] = cadd(t1, t3);
    v[2] = csub(t0, t2);
    v[3] = csub(t1, t3);
  }
}

// ---- the tile -------------------------------------------------------------

// element (j, w) of the [L][W] tile; see the header for the swizzle
__device__ __forceinline__ int at(int j, int w, int log_w, int gmask) {
  return (j << log_w) | ((((w >> 1) ^ ((j >> 1) & gmask)) << 1) | (w & 1));
}

// One Stockham stage of radix R over every column of the tile, stage input
// in natural order with ns = R^(stages before): butterfly b of a column
// takes rows b + r m (m = L / R), multiplies row r by w_{ns R}^{r (b mod ns)},
// and writes rows (b - b mod ns) R + b mod ns + r ns.  Thread item i is
// column i mod W of butterfly i / W: the lanes of a half warp share a row.
template <int R, int TILE, int T>
__device__ __forceinline__ void stage(float2* s, int log_l, int log_w, int gmask, int ns,
                                      const float2* __restrict__ roots) {
  constexpr int ITEMS = TILE / (R * T);
  const int m = (1 << log_l) / R, step = (1 << log_l) / (ns * R);
  float2 v[ITEMS][R];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int i = threadIdx.x + it * T, w = i & ((1 << log_w) - 1), b = i >> log_w;
#pragma unroll
    for (int r = 0; r < R; ++r) v[it][r] = s[at(b + r * m, w, log_w, gmask)];
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int i = threadIdx.x + it * T, w = i & ((1 << log_w) - 1), b = i >> log_w;
    const int k = b & (ns - 1);
    if (ns > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r) v[it][r] = cmul(v[it][r], __ldg(roots + r * k * step));
    }
    dft<R>(v[it]);
    const int base = (b - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) s[at(base + r * ns, w, log_w, gmask)] = v[it][r];
  }
  __syncthreads();
}

// the length-L FFT down every column of the tile, L = 2^log_l
template <int TILE, int T>
__device__ __forceinline__ void fft_tile(float2* s, int log_l, int log_w, int gmask,
                                         const float2* __restrict__ roots) {
  int ns = 1;
  if (log_l & 1) {
    stage<2, TILE, T>(s, log_l, log_w, gmask, ns, roots);
    ns = 2;
  }
  for (; ns < (1 << log_l); ns *= 4) stage<4, TILE, T>(s, log_l, log_w, gmask, ns, roots);
}

__device__ __forceinline__ int swizzle_mask(int log_w) { return min(7, (1 << (log_w - 1)) - 1); }

// Chunk q of a block's W lines of 2^log_c 16-byte chunks each -> (line w,
// chunk c): eight lanes take eight consecutive chunks of line w and the next
// eight the same chunks of line w + 1, where a line has eight chunks or more.
__device__ __forceinline__ void line_chunk(int q, int log_c, int& w, int& c) {
  if (log_c >= 3) {
    const int rest = q >> 4;
    c = ((rest & ((1 << (log_c - 3)) - 1)) << 3) | (q & 7);
    w = ((rest >> (log_c - 3)) << 1) | ((q >> 3) & 1);
  } else {
    c = q & ((1 << log_c) - 1);
    w = q >> log_c;
  }
}

// ---- pass 1: the columns --------------------------------------------------

// x (rows, n1 n2) -> b (rows, n1, n2): column
// c = r n2 + j2 of cols = rows n2, its FFT over j1 times w_n^{k1 j2}.  The
// block's W columns start in row r0 at column cb; an element's offset from
// row r0 is below max(n, TILE), so offsets are 32-bit.
template <int TILE, int T>
__global__ void __launch_bounds__(T, 1024 / T)
    fft_cols_kernel(const float2* __restrict__ x, float2* __restrict__ b, long long cols,
                    int log_n1, int log_n2, const float2* __restrict__ roots,
                    const float2* __restrict__ tw) {
  constexpr int CH = TILE / (2 * T);
  extern __shared__ __align__(16) unsigned char smem[];
  float2* s = reinterpret_cast<float2*>(smem);
  const int log_w = ilog2(TILE) - log_n1, gmask = swizzle_mask(log_w);
  const int half_w = 1 << (log_w - 1), n2 = 1 << log_n2, log_n = log_n1 + log_n2;
  const long long c0 = (long long)blockIdx.x << log_w, r0 = c0 >> log_n2;
  const int cb = (int)(c0 & (n2 - 1)), left = (int)min(cols - c0, (long long)TILE);
  const float2* xb = x + (r0 << log_n);
  float2* bb = b + (r0 << log_n);
  float4 v[CH];
#pragma unroll
  for (int it = 0; it < CH; ++it) {  // chunk q: row j, columns c0 + 2p, + 1
    const int q = threadIdx.x + it * T, j = q >> (log_w - 1), p = q & (half_w - 1);
    const int cr = cb + 2 * p;
    v[it] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (2 * p < left)
      v[it] = *reinterpret_cast<const float4*>(
          xb + ((cr >> log_n2) << log_n) + (j << log_n2) + (cr & (n2 - 1)));
  }
#pragma unroll
  for (int it = 0; it < CH; ++it) {
    const int q = threadIdx.x + it * T, j = q >> (log_w - 1), p = q & (half_w - 1);
    *reinterpret_cast<float4*>(s + at(j, 2 * p, log_w, gmask)) = v[it];
  }
  __syncthreads();
  fft_tile<TILE, T>(s, log_n1, log_w, gmask, roots);
#pragma unroll 4
  for (int it = 0; it < CH; ++it) {  // row k1 = j, twiddled, into b laid out like x
    const int q = threadIdx.x + it * T, j = q >> (log_w - 1), p = q & (half_w - 1);
    if (2 * p >= left) continue;
    const int cr = cb + 2 * p, j2 = cr & (n2 - 1);
    const float4 a = *reinterpret_cast<const float4*>(s + at(j, 2 * p, log_w, gmask));
    const float4 t = __ldg(reinterpret_cast<const float4*>(tw + (j << log_n2) + j2));
    const float2 lo = cmul(make_float2(a.x, a.y), make_float2(t.x, t.y));
    const float2 hi = cmul(make_float2(a.z, a.w), make_float2(t.z, t.w));
    *reinterpret_cast<float4*>(bb + ((cr >> log_n2) << log_n) + (j << log_n2) + j2) =
        make_float4(lo.x, lo.y, hi.x, hi.y);
  }
}

// ---- pass 2: the lines, and the transposed readout -------------------------

// x: lines l = r n1 + k1 of L = 2^log_l contiguous elements -> out X
// (rows, n1 L), X[r, k2 n1 + k1] = FFT(line l)[k2].
// n1 = 1 is the degenerate split's one pass over the rows of x.  The block's
// W lines start at line l0; offsets from its bases are below max(n, TILE).
template <int TILE, int T>
__global__ void __launch_bounds__(T, 1024 / T)
    fft_lines_kernel(const float2* __restrict__ x, float2* __restrict__ out, long long lines,
                     int log_l, int log_n1, const float2* __restrict__ roots) {
  constexpr int CH = TILE / (2 * T);
  extern __shared__ __align__(16) unsigned char smem[];
  float2* s = reinterpret_cast<float2*>(smem);
  const int log_w = ilog2(TILE) - log_l, gmask = swizzle_mask(log_w);
  const int half_w = 1 << (log_w - 1), log_c = log_l - 1, log_n = log_l + log_n1;
  const long long l0 = (long long)blockIdx.x << log_w;
  const int left = (int)min(lines - l0, (long long)TILE);  // the block's lines that exist
  if (log_l == 0) {  // n == 1: the DFT of one element is the element
    for (int e = threadIdx.x; e < left && e < (1 << log_w); e += T)
      out[l0 + e] = x[l0 + e];
    return;
  }
  const float2* xb = x + (l0 << log_l);
  // chunks in two batches of four: all eight, with the transposed stores'
  // addresses, do not fit in 64 registers
  constexpr int BATCH = CH / 2;
#pragma unroll
  for (int first = 0; first < CH; first += BATCH) {
    float4 v[BATCH];
#pragma unroll
    for (int it = 0; it < BATCH; ++it) {
      int w, c;
      line_chunk(threadIdx.x + (first + it) * T, log_c, w, c);
      v[it] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (w < left) v[it] = *reinterpret_cast<const float4*>(xb + (w << log_l) + 2 * c);
    }
#pragma unroll
    for (int it = 0; it < BATCH; ++it) {
      int w, c;
      line_chunk(threadIdx.x + (first + it) * T, log_c, w, c);
      s[at(2 * c, w, log_w, gmask)] = make_float2(v[it].x, v[it].y);
      s[at(2 * c + 1, w, log_w, gmask)] = make_float2(v[it].z, v[it].w);
    }
  }
  __syncthreads();
  fft_tile<TILE, T>(s, log_l, log_w, gmask, roots);
  if (log_n1 >= log_w) {
    // the W lines are W consecutive k1 of one row r: tile row k2 is a run of
    // W elements of X
    float2* ob = out + ((l0 >> log_n1) << log_n) + (l0 & ((1LL << log_n1) - 1));
#pragma unroll 4
    for (int it = 0; it < CH; ++it) {
      const int q = threadIdx.x + it * T, k2 = q >> (log_w - 1), p = q & (half_w - 1);
      *reinterpret_cast<float4*>(ob + (k2 << log_n1) + 2 * p) =
          *reinterpret_cast<const float4*>(s + at(k2, 2 * p, log_w, gmask));
    }
  } else if (log_n1 > 0) {
    // the tile is W / n1 whole rows of X, one contiguous block; element e of
    // it is row e / n, k2 = (e mod n) / n1, k1 = e mod n1
    float2* ob = out + ((l0 >> log_n1) << log_n);
#pragma unroll 4
    for (int it = 0; it < CH; ++it) {
      const int e = 2 * (threadIdx.x + it * T), mm = e & ((1 << log_n) - 1);
      const int w = ((e >> log_n) << log_n1) | (mm & ((1 << log_n1) - 1));
      if (w < left)
        *reinterpret_cast<float4*>(ob + e) =
            *reinterpret_cast<const float4*>(s + at(mm >> log_n1, w, log_w, gmask));
    }
  } else {
    // n1 == 1: the lines of X are the lines of x
    float2* ob = out + (l0 << log_l);
#pragma unroll 4
    for (int it = 0; it < CH; ++it) {
      int w, c;
      line_chunk(threadIdx.x + it * T, log_c, w, c);
      if (w >= left) continue;
      const float2 a = s[at(2 * c, w, log_w, gmask)], z = s[at(2 * c + 1, w, log_w, gmask)];
      *reinterpret_cast<float4*>(ob + (w << log_l) + 2 * c) = make_float4(a.x, a.y, z.x, z.y);
    }
  }
}

// ---- launches -------------------------------------------------------------

// Tile of 4096 elements and 256 threads for lines of up to 256, else 8192
// and 512; every instance's shared memory limit is raised once, on the
// first call, before any launch (so a launch captured in a CUDA graph makes
// no attribute call once a call has warmed up).
template <int TILE, int T>
cudaError_t raise_smem_limit() {
  static bool done = false;
  if (done) return cudaSuccess;
  const int bytes = TILE * 8;
  cudaError_t err = cudaSuccess;
  for (const void* f : {(const void*)fft_cols_kernel<TILE, T>,
                        (const void*)fft_lines_kernel<TILE, T>}) {
    err = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  done = true;
  return cudaSuccess;
}

template <int TILE, int T>
int launch_cols(const float2* x, float2* b, long long cols, int log_n1, int log_n2,
                const float2* roots, const float2* tw, cudaStream_t s) {
  const cudaError_t err = raise_smem_limit<TILE, T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int log_w = ilog2(TILE) - log_n1;
  const long long blocks = (cols + (1LL << log_w) - 1) >> log_w;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = (unsigned)blocks;
  fft_cols_kernel<TILE, T><<<grid, T, TILE * 8, s>>>(x, b, cols, log_n1, log_n2, roots, tw);
  return static_cast<int>(cudaGetLastError());
}

template <int TILE, int T>
int launch_lines(const float2* x, float2* out, long long lines, int log_l, int log_n1,
                 const float2* roots, cudaStream_t s) {
  const cudaError_t err = raise_smem_limit<TILE, T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int log_w = ilog2(TILE) - log_l;
  const long long blocks = (lines + (1LL << log_w) - 1) >> log_w;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = (unsigned)blocks;
  fft_lines_kernel<TILE, T><<<grid, T, TILE * 8, s>>>(x, out, lines, log_l, log_n1, roots);
  return static_cast<int>(cudaGetLastError());
}

int cols(const float2* x, float2* b, long long n_cols, int log_n1, int log_n2,
         const float2* roots, const float2* tw, cudaStream_t s) {
  return log_n1 <= 8 ? launch_cols<4096, 256>(x, b, n_cols, log_n1, log_n2, roots, tw, s)
                     : launch_cols<8192, 512>(x, b, n_cols, log_n1, log_n2, roots, tw, s);
}

int lines(const float2* x, float2* out, long long n_lines, int log_l, int log_n1,
          const float2* roots, cudaStream_t s) {
  return log_l <= 8 ? launch_lines<4096, 256>(x, out, n_lines, log_l, log_n1, roots, s)
                    : launch_lines<8192, 512>(x, out, n_lines, log_l, log_n1, roots, s);
}

}  // namespace

// x (rows, n) row-major complex64, n = 2^(log_n1 + log_n2), 16-byte aligned;
// out (rows, n) complex64.
// With log_n1 and log_n2 both > 0: scratch (rows, n) complex64, t1 the n1
// roots of unity, t2 the n2 roots, tw the n1 x n2 inter-pass twiddles; two
// launches.  Else (a degenerate split) t2 holds the n roots and one launch
// runs; scratch, t1 and tw are not read.  Each pass takes at most
// 2^LOG_MAX_PASS.  Returns the launches' cudaGetLastError(), or
// cudaErrorInvalidValue for a length past the limit.
extern "C" int bi_fft(const void* x, void* scratch, void* out, long long rows,
                      int log_n1, int log_n2, const void* t1, const void* t2, const void* tw,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (log_n1 < 0 || log_n2 < 0 || rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  const float2* in = static_cast<const float2*>(x);
  float2* o = static_cast<float2*>(out);
  if (log_n1 == 0 || log_n2 == 0) {
    const int log_n = log_n1 + log_n2;
    if (log_n > LOG_MAX_PASS) return static_cast<int>(cudaErrorInvalidValue);
    return lines(in, o, rows, log_n, 0, static_cast<const float2*>(t2), s);
  }
  if (log_n1 > LOG_MAX_PASS || log_n2 > LOG_MAX_PASS) return static_cast<int>(cudaErrorInvalidValue);
  float2* b = static_cast<float2*>(scratch);
  const int err = cols(in, b, rows << log_n2, log_n1, log_n2,
                       static_cast<const float2*>(t1), static_cast<const float2*>(tw), s);
  if (err != 0) return err;
  return lines(b, o, rows << log_n1, log_n2, log_n1, static_cast<const float2*>(t2), s);
}

// Pass 1 alone, for a split whose n2 is longer than a pass (the wrapper runs
// pass 2 as a bi_fft of its own and reads it out through K6): x (rows, n)
// as above into b (rows, n1, n2), each column's FFT times the inter-pass
// twiddle.  n1 = 2^log_n1 at most 2^LOG_MAX_PASS; n below 2^31.
extern "C" int bi_fft_cols(const void* x, void* b, long long rows, int log_n1, int log_n2,
                           const void* t1, const void* tw, void* stream) {
  if (log_n1 < 1 || log_n1 > LOG_MAX_PASS || log_n2 < 1 || log_n1 + log_n2 > 30 || rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return cols(static_cast<const float2*>(x), static_cast<float2*>(b), rows << log_n2, log_n1,
              log_n2, static_cast<const float2*>(t1), static_cast<const float2*>(tw),
              static_cast<cudaStream_t>(stream));
}
