// K6, bi_transpose: out (n, m) = x (m, n)^T for row-major matrices of any
// element type (moved as raw 1-, 2-, 4- or 8-byte words, so the result is
// exact), for sm_90a.
//
// Replaces src/repro/kernels/bi_transpose.py:_transpose_kernel (entry
// bi_transpose).  The TPU kernel visits (bt x bt) tiles of a grid in Morton
// order (the paper's BI layout applied to the schedule) and writes each
// tile's transpose.  Here the planner's bt tiles are too large for one
// block, so each bt tile is cut into sub-tiles, one CUDA block each:
// blockIdx.x = g * (sub-tiles per bt tile) + s, where g is decoded into the
// bt tile (I, J) through the same Morton decode as
// repro_torch/kernels/morton.py's grid_decode (compact1by1 of the odd and
// even bits) when the tile grid is square and a power of two, else
// row-major, and s into the sub-tile row-major inside it.  Blocks with
// neighbouring indices thus work in the same bt tile, whose input rows and
// output rows share L2 lines, in the BI order of the tiles.
//
// Bound on the H100: bytes (each element read once and written once, no
// arithmetic).  Streaming HBM takes about 25 KB in flight per SM, few
// memory instructions per byte, and whole 32-byte sectors on both sides.
// Two instances (bi_transpose.path in the wrapper picks one by layout):
//   * transpose_vec_kernel<ES>, where the base, both row pitches and both
//     bt tile edges are whole 16-byte steps: every global and shared access
//     is 16 bytes.  A block of 256 threads moves a T x T sub-tile, T = 16 V
//     with V = 16 / ES elements in 16 bytes (64^2 f32, 128^2 bf16, 256^2
//     int8, 32^2 f64: 16, 32, 64 and 8 KB, every input row segment 256
//     bytes).  Thread (i, j) loads a V x V micro-block (V rows of 16 bytes,
//     a warp reading two 256-byte row segments per instruction), transposes
//     it in registers (byte permutes for 1- and 2-byte elements, renaming
//     for 4 and 8), and writes its V output rows' 16-byte pieces to a shared
//     tile in the output's layout, chunk i of row V j + k at chunk
//     i ^ (j & 7): that XOR swizzle puts the eight 16-byte stores of a
//     quarter warp, and the eight loads of the write-out, in eight
//     different bank groups without a pad.  After one barrier each warp
//     stores two whole 256-byte output row segments per instruction.  All
//     of a thread's V loads are issued before any is used, so a block keeps
//     its whole tile in flight.
//   * transpose_kernel<T, TS>, the scalar instance, for the rest (odd
//     widths, unaligned views): one element per thread access through a
//     TS x TS shared tile (32 x 32 for 4- and 8-byte elements, 64 x 64 for
//     1- and 2-byte ones) padded by one 32-bit word per row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ unsigned compact1by1(unsigned x) {
  x &= 0x55555555u;
  x = (x | (x >> 1)) & 0x33333333u;
  x = (x | (x >> 2)) & 0x0F0F0F0Fu;
  x = (x | (x >> 4)) & 0x00FF00FFu;
  x = (x | (x >> 8)) & 0x0000FFFFu;
  return x;
}

constexpr int TX = 32;
constexpr int TY = 8;

template <typename T, int TS>
__global__ void __launch_bounds__(TX * TY)
    transpose_kernel(const T* __restrict__ x, T* __restrict__ out, int m,
                     int n, int bt_m, int bt_n, int nn, int sm, int sn,
                     int morton) {
  constexpr int PAD = sizeof(T) >= 4 ? 1 : 4 / (int)sizeof(T);
  __shared__ T tile[TS][TS + PAD];
  const unsigned per_tile = (unsigned)(sm * sn);
  const unsigned g = blockIdx.x / per_tile;
  const int s = (int)(blockIdx.x % per_tile);
  unsigned ti, tj;
  if (morton) {
    ti = compact1by1(g >> 1);
    tj = compact1by1(g);
  } else {
    ti = g / (unsigned)nn;
    tj = g % (unsigned)nn;
  }
  const int r0 = (int)ti * bt_m + (s / sn) * TS;
  const int c0 = (int)tj * bt_n + (s % sn) * TS;
  const int r_end = min(r0 + TS, ((int)ti + 1) * bt_m);
  const int c_end = min(c0 + TS, ((int)tj + 1) * bt_n);
  for (int y = threadIdx.y; y < TS; y += TY)
    for (int xx = threadIdx.x; xx < TS; xx += TX)
      if (r0 + y < r_end && c0 + xx < c_end)
        tile[y][xx] = x[(long long)(r0 + y) * n + c0 + xx];
  __syncthreads();
  // out row c0 + y holds input column c0 + y; out column r0 + xx input row
  for (int y = threadIdx.y; y < TS; y += TY)
    for (int xx = threadIdx.x; xx < TS; xx += TX)
      if (c0 + y < c_end && r0 + xx < r_end)
        out[(long long)(c0 + y) * m + r0 + xx] = tile[xx][y];
}

template <typename T, int TS>
int launch(const void* x, void* out, int m, int n, int bt_m, int bt_n,
           int morton, cudaStream_t s) {
  const int nm = m / bt_m, nn = n / bt_n;
  const int sm = (bt_m + TS - 1) / TS, sn = (bt_n + TS - 1) / TS;
  const long long blocks = (long long)nm * nn * sm * sn;
  transpose_kernel<T, TS><<<(unsigned)blocks, dim3(TX, TY), 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), m, n, bt_m, bt_n, nn,
      sm, sn, morton);
  return static_cast<int>(cudaGetLastError());
}

// ---- the vector instance ---------------------------------------------------

constexpr int VEC_THREADS = 256;

template <int ES>
__host__ __device__ constexpr int vec_tile() { return 16 * (16 / ES); }

// The V x V micro-block a (row r: words a[r][0..3]) transposed into t
// (column k of a as row k: t[k][0..3]), for V = 16 / ES.
template <int ES>
__device__ __forceinline__ void transpose_regs(const uint32_t (&a)[16 / ES][4],
                                               uint32_t (&t)[16 / ES][4]) {
  if constexpr (ES == 8) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      t[k][0] = a[0][2 * k];
      t[k][1] = a[0][2 * k + 1];
      t[k][2] = a[1][2 * k];
      t[k][3] = a[1][2 * k + 1];
    }
  } else if constexpr (ES == 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int r = 0; r < 4; ++r) t[k][r] = a[r][k];
  } else if constexpr (ES == 2) {
    // word w of column k: rows 2w (low half) and 2w + 1 (high half)
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int w = 0; w < 4; ++w)
        t[k][w] = __byte_perm(a[2 * w][k / 2], a[2 * w + 1][k / 2], (k & 1) ? 0x7632 : 0x5410);
  } else {
    // 4 x 4 byte blocks: rows 4w .. 4w + 3 of word q hold columns 4q .. 4q + 3
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const uint32_t ab_lo = __byte_perm(a[4 * w][q], a[4 * w + 1][q], 0x5140);
        const uint32_t ab_hi = __byte_perm(a[4 * w][q], a[4 * w + 1][q], 0x7362);
        const uint32_t cd_lo = __byte_perm(a[4 * w + 2][q], a[4 * w + 3][q], 0x5140);
        const uint32_t cd_hi = __byte_perm(a[4 * w + 2][q], a[4 * w + 3][q], 0x7362);
        t[4 * q][w] = __byte_perm(ab_lo, cd_lo, 0x5410);
        t[4 * q + 1][w] = __byte_perm(ab_lo, cd_lo, 0x7632);
        t[4 * q + 2][w] = __byte_perm(ab_hi, cd_hi, 0x5410);
        t[4 * q + 3][w] = __byte_perm(ab_hi, cd_hi, 0x7632);
      }
  }
}

template <int ES>
__global__ void __launch_bounds__(VEC_THREADS)
    transpose_vec_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out, int m,
                         int n, int bt_m, int bt_n, int nn, int sm, int sn, int morton) {
  constexpr int V = 16 / ES, T = vec_tile<ES>();
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* tile = reinterpret_cast<uint4*>(smem);  // [T output rows][16 chunks]
  const unsigned per_tile = (unsigned)(sm * sn);
  const unsigned g = blockIdx.x / per_tile;
  const int s = (int)(blockIdx.x % per_tile);
  unsigned ti, tj;
  if (morton) {
    ti = compact1by1(g >> 1);
    tj = compact1by1(g);
  } else {
    ti = g / (unsigned)nn;
    tj = g % (unsigned)nn;
  }
  const int r0 = (int)ti * bt_m + (s / sn) * T;
  const int c0 = (int)tj * bt_n + (s % sn) * T;
  // the bt tile's edges are whole micro-blocks, so each is in or out whole
  const int r_end = min(r0 + T, ((int)ti + 1) * bt_m);
  const int c_end = min(c0 + T, ((int)tj + 1) * bt_n);
  const int j = threadIdx.x % 16, i = threadIdx.x / 16;

  uint32_t a[V][4] = {};
  const bool in = r0 + V * i < r_end && c0 + V * j < c_end;
  if (in) {
    const uint8_t* src = x + ((long long)(r0 + V * i) * n + c0 + V * j) * ES;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const uint4 w = *reinterpret_cast<const uint4*>(src + (long long)k * n * ES);
      a[k][0] = w.x;
      a[k][1] = w.y;
      a[k][2] = w.z;
      a[k][3] = w.w;
    }
  }
  uint32_t t[V][4];
  transpose_regs<ES>(a, t);
  if (in) {
#pragma unroll
    for (int k = 0; k < V; ++k)
      tile[(V * j + k) * 16 + (i ^ (j & 7))] = make_uint4(t[k][0], t[k][1], t[k][2], t[k][3]);
  }
  __syncthreads();
  // output-tile row R is input column c0 + R; its chunk j holds input rows
  // r0 + V j .. r0 + V j + V - 1
#pragma unroll
  for (int p = 0; p < V; ++p) {
    const int R = p * 16 + i;
    if (c0 + R < c_end && r0 + V * j < r_end)
      *reinterpret_cast<uint4*>(out + ((long long)(c0 + R) * m + r0 + V * j) * ES) =
          tile[R * 16 + (j ^ ((R / V) & 7))];
  }
}

template <int ES>
int launch_vec(const void* x, void* out, int m, int n, int bt_m, int bt_n, int morton,
               cudaStream_t s) {
  constexpr int T = vec_tile<ES>(), SMEM = T * 256;
  // above 48 KB (int8's 64 KB tile) the limit is raised once, before any
  // launch, so that a launch captured in a CUDA graph makes no attribute call
  static bool limit_set = false;
  if (!limit_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        transpose_vec_kernel<ES>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    limit_set = true;
  }
  const int nm = m / bt_m, nn = n / bt_n;
  const int sm = (bt_m + T - 1) / T, sn = (bt_n + T - 1) / T;
  const long long blocks = (long long)nm * nn * sm * sn;
  transpose_vec_kernel<ES><<<(unsigned)blocks, VEC_THREADS, SMEM, s>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out), m, n, bt_m, bt_n, nn, sm,
      sn, morton);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x row-major (m, n), out row-major (n, m), elements of `itemsize` bytes
// (1, 2, 4 or 8).  bt_m divides m and bt_n divides n; morton = 1 only for a
// square power-of-two grid of bt tiles.  instance 0: the scalar kernel;
// 1: the vector kernel, which needs x and out 16-byte aligned and m, n,
// bt_m and bt_n whole 16-byte steps (multiples of 16 / itemsize).  Returns
// the launch's cudaGetLastError(), or cudaErrorInvalidValue for another
// itemsize or instance.
extern "C" int bi_transpose(const void* x, void* out, int m, int n, int bt_m, int bt_n,
                            int morton, int itemsize, int instance, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (instance == 1) {
    switch (itemsize) {
      case 1: return launch_vec<1>(x, out, m, n, bt_m, bt_n, morton, s);
      case 2: return launch_vec<2>(x, out, m, n, bt_m, bt_n, morton, s);
      case 4: return launch_vec<4>(x, out, m, n, bt_m, bt_n, morton, s);
      case 8: return launch_vec<8>(x, out, m, n, bt_m, bt_n, morton, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (instance != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (itemsize) {
    case 1: return launch<uint8_t, 64>(x, out, m, n, bt_m, bt_n, morton, s);
    case 2: return launch<uint16_t, 64>(x, out, m, n, bt_m, bt_n, morton, s);
    case 4: return launch<uint32_t, 32>(x, out, m, n, bt_m, bt_n, morton, s);
    case 8: return launch<uint64_t, 32>(x, out, m, n, bt_m, bt_n, morton, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
