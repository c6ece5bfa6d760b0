// K5, bp_scan: inclusive prefix sum along the last axis of a row-major
// (rows, n) matrix, f32 or bf16, with an f32 accumulator, for sm_90a.
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
// elements at the H100's 50 MiB L2) spans many CUDA blocks, so the design
// is three launches:
//   1. tile_totals: each block reduces a TILE-element piece of one leaf
//      (256 threads x 16 consecutive elements, staged through shared memory
//      with one pad word per 32 against bank conflicts) to its f32 total;
//   2. tile_offsets: one thread per row walks that row's tile totals in
//      order: each tile's exclusive f32 offset within its leaf, and each
//      leaf's f32 offset among the leaves;
//   3. tile_scan: each block rescans its piece in f32 from its offset
//      (thread sums, a warp-shuffle scan, a scan of the 8 warp totals; the
//      same order as launch 1), rounds to the dtype, adds the leaf offset
//      and rounds again.
// That reads the input twice and writes it once (3 passes against the
// bound's 2).  A simple, correct kernel; a single-pass decoupled look-back
// scan is the way to the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 16;
constexpr int TILE = THREADS * ITEMS;  // elements per block; bp_scan.py's TILE
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Round an f32 to T (round to nearest even, as torch's .to()).
template <typename T>
__device__ __forceinline__ T round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 round_to<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// Which piece of which leaf of which row block b covers.
struct Piece {
  long long start;  // first element, as an offset into the matrix
  int count;        // elements in the piece (<= TILE)
  long long row;
  int leaf;
};

__device__ __forceinline__ Piece locate(long long b, int n, int block,
                                        int tiles_per_leaf, int nleaves) {
  const long long per_row = (long long)nleaves * tiles_per_leaf;
  Piece p;
  p.row = b / per_row;
  const int rem = (int)(b % per_row);
  p.leaf = rem / tiles_per_leaf;
  const int tile = rem % tiles_per_leaf;
  p.start = p.row * n + (long long)p.leaf * block + (long long)tile * TILE;
  p.count = min(TILE, block - tile * TILE);
  return p;
}

// Stage the piece in shared memory as f32 (zeros past `count`), give each
// thread the exclusive f32 prefix of the thread sums before it, and return
// the piece's f32 total.  Launches 1 and 3 both call this, so the two sum in
// the same order.
template <typename T>
__device__ float stage_and_scan(const T* src, int count, float* sh,
                                float* warp_sums, float* thread_excl) {
  for (int i = threadIdx.x; i < TILE; i += THREADS)
    sh[pad(i)] = i < count ? to_f32(src[i]) : 0.f;
  __syncthreads();
  const int first = threadIdx.x * ITEMS;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) s += sh[pad(first + j)];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  float before = 0.f, total = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const float ws = warp_sums[w];
    if (w < warp) before += ws;
    total += ws;
  }
  *thread_excl = before + excl;
  return total;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    tile_totals(const T* __restrict__ x, float* __restrict__ tile_tot, int n,
                int block, int tiles_per_leaf, int nleaves) {
  __shared__ float sh[TILE + TILE / 32];
  __shared__ float warp_sums[WARPS];
  const long long b = blockIdx.x;
  const Piece p = locate(b, n, block, tiles_per_leaf, nleaves);
  float excl;
  const float total = stage_and_scan(x + p.start, p.count, sh, warp_sums, &excl);
  if (threadIdx.x == 0) tile_tot[b] = total;
}

__global__ void tile_offsets(const float* __restrict__ tile_tot,
                             float* __restrict__ tile_off,
                             float* __restrict__ leaf_off, long long rows,
                             int tiles_per_leaf, int nleaves) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const long long per_row = (long long)nleaves * tiles_per_leaf;
  const float* t = tile_tot + r * per_row;
  float* o = tile_off + r * per_row;
  float* lo = leaf_off + r * nleaves;
  float run = 0.f;  // inclusive f32 sum of the leaf totals so far
  for (int l = 0; l < nleaves; ++l) {
    float local = 0.f;
    for (int i = 0; i < tiles_per_leaf; ++i) {
      o[l * tiles_per_leaf + i] = local;
      local += t[l * tiles_per_leaf + i];
    }
    run += local;
    lo[l] = run - local;  // cumsum(totals) - totals, as bp_scan.py:66
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    tile_scan(const T* __restrict__ x, T* __restrict__ out,
              const float* __restrict__ tile_off,
              const float* __restrict__ leaf_off, int n, int block,
              int tiles_per_leaf, int nleaves) {
  __shared__ float sh[TILE + TILE / 32];
  __shared__ float warp_sums[WARPS];
  const long long b = blockIdx.x;
  const Piece p = locate(b, n, block, tiles_per_leaf, nleaves);
  float excl;
  stage_and_scan(x + p.start, p.count, sh, warp_sums, &excl);
  const float off = leaf_off[p.row * nleaves + p.leaf];
  float run = tile_off[b] + excl;
  const int first = threadIdx.x * ITEMS;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    run += sh[pad(first + j)];
    const T local = round_to<T>(run);
    sh[pad(first + j)] = to_f32(round_to<T>(to_f32(local) + off));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < p.count; i += THREADS)
    out[p.start + i] = round_to<T>(sh[pad(i)]);
}

template <typename T>
int launch(const void* x, void* out, float* ws, long long rows, int n,
           int block, cudaStream_t s) {
  const int tiles_per_leaf = (block + TILE - 1) / TILE;
  const int nleaves = n / block;
  const long long pieces = rows * nleaves * tiles_per_leaf;
  float* tile_tot = ws;
  float* tile_off = ws + pieces;
  float* leaf_off = ws + 2 * pieces;
  const T* xt = static_cast<const T*>(x);
  tile_totals<T><<<(unsigned)pieces, THREADS, 0, s>>>(xt, tile_tot, n, block,
                                                     tiles_per_leaf, nleaves);
  tile_offsets<<<(unsigned)((rows + 127) / 128), 128, 0, s>>>(
      tile_tot, tile_off, leaf_off, rows, tiles_per_leaf, nleaves);
  tile_scan<T><<<(unsigned)pieces, THREADS, 0, s>>>(
      xt, static_cast<T*>(out), tile_off, leaf_off, n, block, tiles_per_leaf,
      nleaves);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  x and out are row-major
// (rows, n); block divides n.  ws holds 2 * rows * (n / block) *
// ceil(block / 4096) + rows * (n / block) floats.  Returns the launches'
// cudaGetLastError().
extern "C" int bp_scan(const void* x, void* out, void* ws, long long rows,
                       int n, int block, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if (dtype == 1) return launch<__nv_bfloat16>(x, out, w, rows, n, block, s);
  return launch<float>(x, out, w, rows, n, block, s);
}
