// Tensor-core helpers shared by the attention kernels' mma instances (K1
// and K1q in flash_attention.cu, K3 in flash_attention_bwd.cu): 16-byte
// cp.async with zero fill, ldmatrix, mma.sync m16n8k16 (bf16 or f16 in, f32
// accumulate), the repacking of an f32 accumulator into a bf16 or f16
// operand, and the exact widening of int8 to bf16 and to f16.
//
// Fragment layouts of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32,
// for lane l of the warp, with r = l / 4 and c = 2 * (l % 4):
//   A (16 x 16, row-major): a[0] = A[r][c, c+1], a[1] = A[r+8][c, c+1],
//                           a[2] = A[r][c+8, c+9], a[3] = A[r+8][c+8, c+9]
//   B (16 x 8, k x n):      b[0] = B[c, c+1][r],  b[1] = B[c+8, c+9][r]
//   C (16 x 8, f32):        c[0..1] = C[r][c, c+1], c[2..3] = C[r+8][c, c+1]
// So the C tiles of two neighbouring 8-column blocks hold exactly the A
// operand of a product over those 16 columns (pack_a), which lets a
// probability tile feed the next product from registers; pack_a_split
// gives it as hi + lo bf16 operands where one bf16 rounding is too coarse.
//
// Shared tiles are bf16 rows of HD values padded to HD + 8 (pad_ld): the
// row pitch is then 16 bytes past a multiple of 128, so the eight 16-byte
// row segments that one ldmatrix 8x8 matrix reads fall in eight different
// bank groups, for every HD in {16, 32, 64, 128, 256}.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_bf16 {

typedef __nv_bfloat16 bf16;

template <int HD>
__host__ __device__ constexpr int pad_ld() { return HD + 8; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with pred false the 16 bytes are zero-filled
// and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, zero-filled when pred is false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b on the tensor cores
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b with f16 operands (K1q's P V: P in [0, 1] keeps three more bits
// in f16 than in bf16, and an int8 V is exact in either)
__device__ __forceinline__ void mma_f16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16 (lo in the low half), rounded to nearest
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A operand over columns 16j..16j+15 from the C tiles of column blocks
// 2j (left) and 2j+1 (right), rounded to bf16
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&left)[4],
                                       const float (&right)[4]) {
  a[0] = pack2(left[0], left[1]);
  a[1] = pack2(left[2], left[3]);
  a[2] = pack2(right[0], right[1]);
  a[3] = pack2(right[2], right[3]);
}

// pack_a with f16 operands
__device__ __forceinline__ void pack_a_f16(uint32_t (&a)[4], const float (&left)[4],
                                           const float (&right)[4]) {
  const __half2 h[4] = {__floats2half2_rn(left[0], left[1]), __floats2half2_rn(left[2], left[3]),
                        __floats2half2_rn(right[0], right[1]),
                        __floats2half2_rn(right[2], right[3])};
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const uint32_t*>(&h[i]);
}

// Four int8 (one 32-bit word) widened exactly, without the conversion units
// (I2F runs at a quarter of the integer rate).  x ^ 0x80 is x + 128 as an
// unsigned byte u.  bf16: the f32 with bits 0x4B0000uu is 2^23 + u, so
// subtracting 2^23 + 128 leaves x exactly, and an f32 integer of at most
// 8 bits has zero low halves, so its bf16 is its high half.  f16: the f16
// with bits 0x64uu is 1024 + u (spacing 1 in [1024, 2048)), and
// subtracting 1152 leaves x exactly.  lo gets elements 0, 1, hi 2, 3.
__device__ __forceinline__ void widen_i8x4_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

__device__ __forceinline__ void widen_i8x4_f16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const __half2 bias = __halves2half2(__ushort_as_half(0x6480), __ushort_as_half(0x6480));
  uint32_t p[2] = {__byte_perm(u, 0x64646464u, 0x5140), __byte_perm(u, 0x64646464u, 0x5342)};
  const __half2 a = __hsub2(*reinterpret_cast<const __half2*>(&p[0]), bias);
  const __half2 b = __hsub2(*reinterpret_cast<const __half2*>(&p[1]), bias);
  lo = *reinterpret_cast<const uint32_t*>(&a);
  hi = *reinterpret_cast<const uint32_t*>(&b);
}

// two f32 as hi + lo, each a bf16 pair: hi rounded to nearest, lo the
// rounded remainder, so hi + lo carries 16 bits of each value
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// pack_a as hi + lo operands: a product over them (two mma) carries the f32
// accumulator values to 16 bits instead of bf16's 8
__device__ __forceinline__ void pack_a_split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                             const float (&left)[4],
                                             const float (&right)[4]) {
  split2(left[0], left[1], hi[0], lo[0]);
  split2(left[2], left[3], hi[1], lo[1]);
  split2(right[0], right[1], hi[2], lo[2]);
  split2(right[2], right[3], hi[3], lo[3]);
}

// The A operand (16 rows x 16 columns from column col0) of a row-major tile
// with row pitch ld: matrices (rows 0-7 | 8-15) x (cols 0-7 | 8-15).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int ld, int col0,
                                       int lane) {
  ldsm_x4(a, tile + (lane % 16) * ld + col0 + (lane / 16) * 8);
}

// B operands of two 8-column blocks where B[k][n] = T[n0 + n][k0 + k] for a
// row-major tile T (S = Q K^T reads K so): r[0], r[1] are block n0..n0+7,
// r[2], r[3] block n0+8..n0+15.
__device__ __forceinline__ void load_b_rows(uint32_t (&r)[4], const bf16* tile, int ld, int n0,
                                            int k0, int lane) {
  ldsm_x4(r, tile + (n0 + (lane / 16) * 8 + lane % 8) * ld + k0 + ((lane / 8) % 2) * 8);
}

// B operands of two 8-column blocks where B[k][n] = T[k0 + k][n0 + n] (P V
// reads V so): r[0], r[1] are block n0..n0+7, r[2], r[3] block n0+8..n0+15.
__device__ __forceinline__ void load_b_cols(uint32_t (&r)[4], const bf16* tile, int ld, int k0,
                                            int n0, int lane) {
  ldsm_x4_trans(r, tile + (k0 + ((lane / 8) % 2) * 8 + lane % 8) * ld + n0 + (lane / 16) * 8);
}

// Stage rows r0 .. r0 + rows - 1 of HD bf16 each (row i at base + i *
// stride; rows at or past `limit` zero-filled, reading nothing) into a tile
// of pitch pad_ld<HD>(), 16 bytes per cp.async, by threads t of nt.
template <int HD>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* base, long long stride,
                                           int r0, int rows, int limit, int t, int nt) {
  constexpr int CH = HD / 8;
  for (int i = t; i < rows * CH; i += nt) {
    const int r = i / CH, ch = i % CH;
    const bool in = r0 + r < limit;
    cp_async16(dst + r * pad_ld<HD>() + ch * 8,
               in ? base + (r0 + r) * stride + ch * 8 : base, in);
  }
}

// The grid of a forward or dq pass: one block per (batch row, KV head, group
// of rg of its n_rep query heads, qg * 16 query rows), one warp per (query
// head, 16 rows).  rg is the largest of 4, 2, 1 dividing n_rep; qg starts at
// 4 / rg with no more 16-row groups than sq has.  With `spread`, qg is
// halved while the grid has fewer than two blocks per SM.
struct QueryGrid {
  int rg, qg;
  dim3 grid;
  int warps() const { return rg * qg; }
};

inline int sm_count() {
  static int n = 0;
  if (n <= 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

inline QueryGrid query_grid(int b, int sq, int h, int kvh, bool spread) {
  const int n_rep = h / kvh;
  const int rg = n_rep % 4 == 0 ? 4 : n_rep % 2 == 0 ? 2 : 1;
  const int tiles = (sq + 15) / 16;
  const long long heads = (long long)b * kvh * (n_rep / rg);
  int qg = 4 / rg;
  while (qg > 1 && qg > tiles) qg /= 2;
  while (spread && qg > 1 && heads * ((tiles + qg - 1) / qg) < 2LL * sm_count()) qg /= 2;
  return {rg, qg, dim3((unsigned)heads, (unsigned)((tiles + qg - 1) / qg))};
}

}  // namespace mma_bf16
