// K6, bi_transpose: out (n, m) = x (m, n)^T for row-major matrices of any
// element type (moved as raw 1-, 2-, 4- or 8-byte words, so the result is
// exact), for sm_90a.
//
// Replaces src/repro/kernels/bi_transpose.py:_transpose_kernel (entry
// bi_transpose).  The TPU kernel visits (bt x bt) tiles of a grid in Morton
// order (the paper's BI layout applied to the schedule) and writes each
// tile's transpose.  Here the planner's bt tiles are too large for one
// block, so each bt tile is cut into TS x TS sub-tiles (32 x 32 for 4- and
// 8-byte elements, 64 x 64 for 1- and 2-byte ones), one CUDA block each:
// blockIdx.x = g * (sub-tiles per bt tile) + s, where g is decoded into the
// bt tile (I, J) through the same Morton decode as
// repro_torch/kernels/morton.py's grid_decode (compact1by1 of the odd and
// even bits) when the tile grid is square and a power of two, else
// row-major, and s into the sub-tile row-major inside it.  Blocks with
// neighbouring indices thus work in the same bt tile, whose input rows and
// output rows share L2 lines, in the BI order of the tiles.
//
// Bound on the H100: bytes (each element read once and written once, no
// arithmetic).  Each block stages its sub-tile in shared memory, padded by
// one 32-bit word per row so that the column reads of the write-out fall
// in distinct banks, and both the reads and the writes are coalesced along
// rows.  A simple, correct kernel: no vector loads, no TMA yet.

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

}  // namespace

// x row-major (m, n), out row-major (n, m), elements of `itemsize` bytes
// (1, 2, 4 or 8).  bt_m divides m and bt_n divides n; morton = 1 only for a
// square power-of-two grid of bt tiles.  Returns the launch's
// cudaGetLastError(), or cudaErrorInvalidValue for another itemsize.
extern "C" int bi_transpose(const void* x, void* out, int m, int n, int bt_m,
                            int bt_n, int morton, int itemsize, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (itemsize) {
    case 1: return launch<uint8_t, 64>(x, out, m, n, bt_m, bt_n, morton, s);
    case 2: return launch<uint16_t, 64>(x, out, m, n, bt_m, bt_n, morton, s);
    case 4: return launch<uint32_t, 32>(x, out, m, n, bt_m, bt_n, morton, s);
    case 8: return launch<uint64_t, 32>(x, out, m, n, bt_m, bt_n, morton, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
