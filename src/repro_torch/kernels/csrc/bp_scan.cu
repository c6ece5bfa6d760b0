// K5, bp_scan: inclusive prefix sum along the last axis of a (rows, n)
// matrix, f32 or bf16, with an f32 accumulator, for sm_90a.
//
// Replaces src/repro/kernels/bp_scan.py:_scan_block_kernel and
// :_add_offset_kernel (entry bp_scan).  It keeps the TPU kernel's leaf
// structure, not just a cumsum: the row is cut into leaves of `block`
// elements (the planner's BP leaf); inside a leaf the prefix runs in f32 and
// is rounded to the input dtype; the exclusive f32 sum of the earlier
// leaves' f32 totals (computed as inclusive sum minus own total, as the JAX
// code does) is then added in f32 and the result rounded again.
//
// Bound on the H100: bytes.  The function reads each input once and writes
// each output once (one add per element, far below the ridge).  On the TPU a
// leaf was one grid step; here a leaf of the planner's size (up to 2^20
// elements at the H100's 50 MiB L2) spans many CUDA blocks.  The design is
// one pass, a chained scan:
//   * each (row, leaf) is a segment, cut into tiles of TILE = 256 threads x
//     R chunks of 16 bytes (R = 16: 16K f32 or 32K bf16 elements, 64 KB);
//   * a block takes the next tile index from a global counter (atomicAdd),
//     tile t of every segment before tile t + 1 of any, so the rows' chains
//     advance side by side and a block only ever waits on a tile that an
//     earlier, running block holds;
//   * it loads its tile straight into registers, 16 bytes a load (4 f32 or
//     8 bf16), warp-striped: warp w owns a contiguous 32 R-chunk stretch of
//     the tile, and in round q lane j loads its chunk 32 q + j, so each warp
//     load is 512 contiguous bytes;
//   * it scans in registers: each chunk's sum in element order, a shuffle
//     scan of the 32 chunk sums of each round, the rounds' totals in order,
//     then the 8 warp totals in order (the tile's aggregate);
//   * the chain: tile t's inclusive prefix is tile t - 1's inclusive prefix
//     plus its own aggregate, published as one 64-bit word (a flag in the
//     high half, the f32 in the low half).  Unlike Merrill and Garland's
//     decoupled look-back, which adds whichever predecessors have published
//     and so changes the f32 association from run to run, the association
//     is fixed: two calls give the same bits.  The chain costs one L2 round
//     trip per tile; at 64 KB a tile a 2^20-element f32 row is 64 hops;
//   * it writes each element's prefix, rounded to the dtype, 16 bytes a
//     store.
// A row of one leaf is then done: its leaf offset, total minus total, is 0.
// With several leaves a row, the last tile of each leaf also carries the
// running f32 sum of the leaf totals down a second chain (leaf l - 1's last
// tile publishes it before leaf l's last tile, which waits on it) and
// writes the leaf's offset, inclusive sum minus own total; a second launch,
// add_offsets, adds each leaf's offset to its elements and rounds again (the
// first tiles of a leaf are written before its total exists, so the offset
// cannot join the single pass).
// Two instances: vec (16-byte accesses) where the pointer, the row pitch and
// the leaf edge are whole 16-byte steps, scalar (element accesses, the same
// chunks and association, so the same bits) for the rest.
// The status words and the tile counter are zeroed by a cudaMemsetAsync in
// the C entry, so a call can be captured in a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// element e of a 16-byte chunk of BYTES-wide elements, as f32
template <int BYTES>
__device__ __forceinline__ float elem(const uint4& c, int e) {
  const uint32_t w = (&c.x)[BYTES == 4 ? e : e / 2];
  if constexpr (BYTES == 4) return __uint_as_float(w);
  return __uint_as_float((e & 1 ? w >> 16 : w & 0xffffu) << 16);
}

// the bits of f32 v rounded to the element type (round to nearest even, as
// torch's .to())
template <int BYTES>
__device__ __forceinline__ uint32_t round_bits(float v) {
  if constexpr (BYTES == 4) return __float_as_uint(v);
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <int BYTES>
__device__ __forceinline__ void put(uint4& c, int e, uint32_t bits) {
  if constexpr (BYTES == 4) {
    (&c.x)[e] = bits;
  } else {
    uint32_t& w = (&c.x)[e / 2];
    w = e & 1 ? (w & 0xffffu) | (bits << 16) : (w & 0xffff0000u) | bits;
  }
}

// the chunk of elements [off, off + E) of a segment of L elements at p
// (zeros past L)
template <int BYTES, bool VEC>
__device__ __forceinline__ uint4 load_chunk(const unsigned char* p, int off, int L) {
  constexpr int E = 16 / BYTES;
  uint4 c = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (VEC) {
    if (off < L) c = __ldcs(reinterpret_cast<const uint4*>(p + (long long)off * BYTES));
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (off + e < L) {
        const unsigned char* q = p + (long long)(off + e) * BYTES;
        put<BYTES>(c, e, BYTES == 4 ? *reinterpret_cast<const uint32_t*>(q)
                                    : *reinterpret_cast<const uint16_t*>(q));
      }
    }
  }
  return c;
}

template <int BYTES, bool VEC>
__device__ __forceinline__ void store_chunk(unsigned char* p, int off, int L, const uint4& c) {
  constexpr int E = 16 / BYTES;
  if constexpr (VEC) {
    if (off < L) __stcs(reinterpret_cast<uint4*>(p + (long long)off * BYTES), c);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (off + e < L) {
        unsigned char* q = p + (long long)(off + e) * BYTES;
        const uint32_t w = (&c.x)[BYTES == 4 ? e : e / 2];
        if constexpr (BYTES == 4)
          *reinterpret_cast<uint32_t*>(q) = w;
        else
          *reinterpret_cast<uint16_t*>(q) = (uint16_t)(e & 1 ? w >> 16 : w & 0xffffu);
      }
    }
  }
}

// the chain's words: flag in the high half, an f32 in the low half
__device__ __forceinline__ void publish(unsigned long long* p, float v) {
  const unsigned long long w = (1ull << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
}

__device__ __forceinline__ float wait_for(const unsigned long long* p) {
  unsigned long long w;
  for (;;) {
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
    if (w >> 32) break;
    __nanosleep(32);
  }
  return __uint_as_float((uint32_t)w);
}

// Segment s = r * nleaves + l is row r's leaf l: L elements at x + r x_pitch
// + l L, written to out + r out_pitch + l L.  tps tiles a segment.
template <int BYTES, bool VEC, int R>
__global__ void __launch_bounds__(THREADS)
    scan_chain_kernel(const void* __restrict__ x, void* __restrict__ out,
                      unsigned* __restrict__ counter, unsigned long long* status,
                      unsigned long long* leaf_status, float* __restrict__ offs, long long nseg,
                      int nleaves, int L, long long x_pitch, long long out_pitch, int tps) {
  constexpr int E = 16 / BYTES;
  constexpr int TILE = THREADS * R * E;
  __shared__ unsigned s_tile;
  __shared__ float s_warp[WARPS];
  __shared__ float s_pred;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(counter, 1u);
  __syncthreads();
  const long long id = s_tile, s = id % nseg;
  const int t = (int)(id / nseg);
  const long long r = s / nleaves, l = s % nleaves;
  const unsigned char* xs =
      static_cast<const unsigned char*>(x) + (r * x_pitch + l * L) * BYTES;
  unsigned char* os = static_cast<unsigned char*>(out) + (r * out_pitch + l * L) * BYTES;
  const int wbase = t * TILE + warp * 32 * R * E + lane * E;

  uint4 v[R];
#pragma unroll
  for (int q = 0; q < R; ++q) v[q] = load_chunk<BYTES, VEC>(xs, wbase + q * 32 * E, L);

  // c[q]: the sum of the warp's chunks before this lane's chunk of round q
  float c[R], run = 0.f;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    float sum = elem<BYTES>(v[q], 0);
#pragma unroll
    for (int e = 1; e < E; ++e) sum += elem<BYTES>(v[q], e);
    float incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    const float total = __shfl_sync(0xffffffffu, incl, 31);
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    c[q] = run + excl;
    run += total;
  }
  if (lane == 0) s_warp[warp] = run;
  __syncthreads();
  float before = 0.f, agg = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    if (w == warp) before = agg;
    agg += s_warp[w];
  }

  if (threadIdx.x == 0) {
    const float pred = t == 0 ? 0.f : wait_for(status + s * tps + t - 1);
    const float incl = t == 0 ? agg : pred + agg;
    publish(status + s * tps + t, incl);
    s_pred = pred;
    if (nleaves > 1 && t == tps - 1) {  // the leaf's total: the leaves' chain
      const float sum = l == 0 ? incl : wait_for(leaf_status + s - 1) + incl;
      publish(leaf_status + s, sum);
      offs[s] = sum - incl;  // cumsum(totals) - totals
    }
  }
  __syncthreads();
  const float base = s_pred + before;

#pragma unroll
  for (int q = 0; q < R; ++q) {
    float acc = base + c[q];
    uint4 o = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      acc += elem<BYTES>(v[q], e);
      put<BYTES>(o, e, round_bits<BYTES>(acc));
    }
    store_chunk<BYTES, VEC>(os, wbase + q * 32 * E, L, o);
  }
}

// Several leaves a row: out += its leaf's offset, rounded again.  Block b
// takes tile b % tps of segment b / tps.
template <int BYTES, bool VEC, int R>
__global__ void __launch_bounds__(THREADS)
    add_offsets_kernel(void* __restrict__ out, const float* __restrict__ offs, int nleaves,
                       int L, long long out_pitch, int tps) {
  constexpr int E = 16 / BYTES;
  constexpr int TILE = THREADS * R * E;
  const long long s = blockIdx.x / tps;
  const int t = blockIdx.x % tps;
  const float off = offs[s];
  unsigned char* os =
      static_cast<unsigned char*>(out) + ((s / nleaves) * out_pitch + (s % nleaves) * L) * BYTES;
#pragma unroll 4
  for (int q = 0; q < R; ++q) {
    const int at = t * TILE + (q * THREADS + threadIdx.x) * E;
    const uint4 in = load_chunk<BYTES, VEC>(os, at, L);
    uint4 o = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int e = 0; e < E; ++e) put<BYTES>(o, e, round_bits<BYTES>(elem<BYTES>(in, e) + off));
    store_chunk<BYTES, VEC>(os, at, L, o);
  }
}

template <int BYTES, bool VEC, int R>
int launch(const void* x, void* out, unsigned char* ws, long long rows, int n, int L,
           long long x_pitch, cudaStream_t s) {
  constexpr int TILE = THREADS * R * (16 / BYTES);
  const int nleaves = n / L, tps = (L + TILE - 1) / TILE;
  const long long nseg = rows * nleaves, tiles = nseg * tps;
  if (tiles >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  // ws: the counter (8 bytes), a status word per tile, one per segment for
  // the leaves' chain, then an f32 offset per segment
  unsigned* counter = reinterpret_cast<unsigned*>(ws);
  unsigned long long* status = reinterpret_cast<unsigned long long*>(ws + 8);
  unsigned long long* leaf_status = status + tiles;
  float* offs = reinterpret_cast<float*>(leaf_status + nseg);
  cudaError_t err = cudaMemsetAsync(ws, 0, 8 + 8 * (tiles + nseg), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_chain_kernel<BYTES, VEC, R><<<(unsigned)tiles, THREADS, 0, s>>>(
      x, out, counter, status, leaf_status, offs, nseg, nleaves, L, x_pitch, n, tps);
  err = cudaGetLastError();
  if (err != cudaSuccess || nleaves == 1) return static_cast<int>(err);
  add_offsets_kernel<BYTES, VEC, R><<<(unsigned)tiles, THREADS, 0, s>>>(out, offs, nleaves, L,
                                                                       n, tps);
  return static_cast<int>(cudaGetLastError());
}

template <int BYTES, bool VEC>
int launch_rounds(int rounds, const void* x, void* out, unsigned char* ws, long long rows, int n,
                  int L, long long x_pitch, cudaStream_t s) {
  switch (rounds) {
    case 4: return launch<BYTES, VEC, 4>(x, out, ws, rows, n, L, x_pitch, s);
    case 8: return launch<BYTES, VEC, 8>(x, out, ws, rows, n, L, x_pitch, s);
    case 16: return launch<BYTES, VEC, 16>(x, out, ws, rows, n, L, x_pitch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  x is (rows, n) with unit column
// stride and row pitch x_pitch elements; out is a contiguous (rows, n); the
// leaf edge `block` divides n.  vec: pointer, pitch and leaf edge are whole
// 16-byte steps (else the scalar instance); rounds: 16-byte chunks per thread
// (4, 8 or 16).  ws holds 8 + 8 * (tiles + segments) + 4 * segments bytes,
// tiles = rows * (n / block) * ceil(block / (256 * rounds * 16 / size)),
// segments = rows * (n / block).  Returns the first CUDA error, 0 if none.
extern "C" int bp_scan(const void* x, void* out, void* ws, long long rows, int n, int block,
                       long long x_pitch, int dtype, int vec, int rounds, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* w = static_cast<unsigned char*>(ws);
  if (block <= 0 || n % block != 0 || rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    return vec ? launch_rounds<2, true>(rounds, x, out, w, rows, n, block, x_pitch, s)
               : launch_rounds<2, false>(rounds, x, out, w, rows, n, block, x_pitch, s);
  return vec ? launch_rounds<4, true>(rounds, x, out, w, rows, n, block, x_pitch, s)
             : launch_rounds<4, false>(rounds, x, out, w, rows, n, block, x_pitch, s);
}
