// K2, hbp_matmul: C = A @ B with an f32 accumulator, for sm_90a.
//
// Replaces src/repro/kernels/hbp_matmul.py:_mm_kernel (entry hbp_matmul).
//
// Four instances; hbp_matmul.path() in the wrapper picks one from the dtype,
// the row count of A and whether TMA can describe both operands (a 16-byte
// aligned base, a row pitch of whole 16-byte steps):
//
//   wgmma   bf16, M > 16 (training, prefill).  At 512 rows the products sit
//           at or above the card's ~295 flop/byte ridge, so they are bound by
//           the tensor cores.  128 x BN output tiles (BN 64-256, picked by the
//           wrapper against wave quantisation on the SMs), K steps of 64, on
//           a persistent grid of at most one block per SM: one producer
//           warp keeps a ring of four stages of TMA loads in flight
//           (128-byte swizzle, mbarrier completion) across tile boundaries,
//           so the next tile's loads overlap this one's epilogue; two
//           consumer warpgroups each issue wgmma.mma_async (64 x BN x 16,
//           bf16 in, f32 accumulate) on their 64 rows and free a stage as
//           soon as its products retire.  Each operand is loaded in its
//           stored layout: wgmma's transpose bits cover the four layouts (A
//           row-major or the transposed view dW = A^T g reads; B row-major
//           or embed.T / W^T), so nothing is copied.  TMA zero-fills ragged
//           M, N and K;
//           the epilogue masks its stores, and writes bf16 outputs through
//           shared memory in 64 x 64 chunks so that each warp store covers
//           whole 128-byte rows.  setmaxnreg moves registers from the
//           producer warpgroup to the consumers.
//   stream  bf16, M <= 16 (decode).  Bound by the bytes of B: each weight
//           byte is read once and used for at most 16 rows.  A 16 x 64
//           output tile per block streams B (and A's 16 rows) through a
//           four-stage cp.async ring, 32 KB of B in flight per block, into
//           mma.sync m16n8k16 fed by ldmatrix (.trans for row-major B).
//           K is split over a thread-block cluster of up to 8 blocks so
//           that every SM streams; the cluster sums its partials through
//           distributed shared memory in rank order, in the same launch.
//   wmma    bf16 operands that TMA cannot describe (a misaligned base or a
//           row pitch that is not a whole 16-byte step).  The first port's
//           kernel: 64 x 64 (16 x 64 for M <= 16) tiles, WMMA 16x16x16.
//           No operand of the model paths takes it.
//   fma     f32, any M: exact f32 FMA (no TF32), since the f32 smoke runs
//           compare card and CPU tokens.  128 x 128 tiles of 128 threads,
//           each 16 x 8 outputs in 4 x 4 sub-tiles; A and B staged K-major
//           in shared memory by double-buffered cp.async and read with
//           float4 loads.  K4 and K7 run on it.
//
// Tile order (wgmma, fma): a grouped-M raster.  Consecutive block indices
// walk `group` M tiles before the next N tile, so the blocks resident
// together on the SMs share each B panel through the 50 MB L2 (the paper's
// block sharing, for blocks that run at once).  The wrapper sets the group
// to every M tile when A is small, so the tied-logits products stream the
// 622 MB table from HBM once, not once per M tile.  The TPU kernel's Morton
// order is a schedule for a sequential grid; a grouped raster gives the
// same sharing to a parallel one with a single division.
//
// Batched products (the MoE experts' FFN: C[e] = A[e] @ B[e] for e < batch,
// one launch).  Every instance takes the slab index as one more grid
// dimension: blockIdx.z for stream, fma and wmma, one more factor of the
// persistent wgmma grid's work units (split, slab, tile; the raster walks
// the tiles of one slab, so its groups never straddle two).  Each operand is
// a stack of matrices a fixed stride apart, each read in its stored layout as
// above; the output is a contiguous (batch, M, N) stack.  wgmma reads the
// slabs through 3-D tensor maps with boxes of depth 1, so a 40-row slab's
// 128-row tile reads zeros past the slab, never the next slab's rows; the
// other instances mask their loads per slab as they mask a ragged M.  Split-K
// through the workspace is off for batched calls (stream's, summed inside
// its cluster, stays): batch x tiles blocks fill the SMs anyway.
//
// Split-K (wgmma, fma, wmma) only where the output tiles cannot fill the
// SMs (dH has 64 tiles of 128 x 128): each split writes f32 partials to a
// workspace from the wrapper, and splitk_reduce sums the splits in a fixed
// order.  Every instance is deterministic; nothing accumulates by atomics.
//
// Launch: the wgmma, stream and fma kernels are programmatic dependents of
// the kernel before them on the stream (launch_dependent), which hides a
// launch's latency behind the previous kernel's tail: a decode product is a
// few microseconds of streaming, so that latency is a large share of it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

// -- shared pieces ---------------------------------------------------------------

// C[i] (or ws[i]) = v, as f32 or rounded to bf16
__device__ __forceinline__ void store1(void* C, bool out_f32, long long i, float v) {
  if (out_f32)
    static_cast<float*>(C)[i] = v;
  else
    static_cast<bf16*>(C)[i] = __float2bfloat16(v);
}

// C[i], C[i + 1] = v0, v1 (i even, the row pitch even)
__device__ __forceinline__ void store2(void* C, bool out_f32, long long i, float v0,
                                       float v1) {
  if (out_f32)
    *reinterpret_cast<float2*>(static_cast<float*>(C) + i) = make_float2(v0, v1);
  else
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(C) + i) =
        __floats2bfloat162_rn(v0, v1);
}

// Two neighbouring outputs (row, col), (row, col + 1) of an M x N result:
// to split `split`'s slice of the f32 workspace (ws not null), or to C.
__device__ __forceinline__ void store_pair(void* C, float* ws, int split, bool out_f32, int M,
                                           int N, int row, int col, float v0, float v1) {
  if (row >= M || col >= N) return;
  void* dst = ws ? static_cast<void*>(ws) : C;
  const bool f32 = ws ? true : out_f32;
  const long long base = ws ? (long long)split * M * N : 0;
  const long long i = base + (long long)row * N + col;
  if (col + 1 < N && N % 2 == 0) {
    store2(dst, f32, i, v0, v1);
  } else {
    store1(dst, f32, i, v0);
    if (col + 1 < N) store1(dst, f32, i + 1, v1);
  }
}

struct Tile {
  int m, n;
};

// Launch `kernel` as a programmatic dependent of the previous kernel on the
// stream: its blocks are placed while that kernel drains.  The kernel must
// call wait_prior_grid before it touches global memory.  `cluster` > 0
// also launches clusters of that many blocks along x.
template <typename... Params, typename... Args>
int launch_dependent(void (*kernel)(Params...), dim3 grid, int threads, int smem, int cluster,
                     cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = cluster;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 0 ? 2 : 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Grouped-M raster: block `id` of a tiles_m x tiles_n grid, `group` M tiles
// per column of the walk (see the header).
__device__ __forceinline__ Tile raster(int id, int tiles_m, int tiles_n, int group) {
  const int per_group = group * tiles_n;
  const int first_m = (id / per_group) * group;
  const int size = min(tiles_m - first_m, group);
  const int r = id % per_group;
  return {first_m + r % size, r / size};
}

// -- wgmma: bf16, M > 16 ------------------------------------------------------------

constexpr int WG_BM = 128;
constexpr int WG_BK = 64;
constexpr int WG_STAGES = 4;
constexpr int WG_THREADS = 384;  // one producer and two consumer warpgroups
constexpr int BOX_BYTES = 64 * 128;  // a 64-row box of 128-byte rows

constexpr int EPI_LD = 64 + 8;  // a consumer's 64 x 64 bf16 output chunk, padded rows

template <int BN>
struct WgSmem {
  static constexpr int A_BYTES = WG_BM * WG_BK * 2;
  static constexpr int B_BYTES = BN * WG_BK * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int EPI_BYTES = 2 * 64 * EPI_LD * 2;  // one chunk per consumer
  // 1024 bytes of slack to start the ring on a 1024-byte boundary, then
  // the ring, the consumers' output chunks, and a full and an empty
  // barrier per stage
  static constexpr int BYTES = 1024 + WG_STAGES * STAGE + EPI_BYTES + 2 * WG_STAGES * 8;
};

// barrier over the 128 threads of consumer warpgroup c only
__device__ __forceinline__ void wg_sync(int c) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
}

// A_MN: A is stored (K, M), the transposed view (wgmma's A transpose bit);
// B_MN: B is stored (K, N), row-major (B transpose bit).  Otherwise the
// operand is K-major: A row-major (M, K), B the view of a row-major (N, K).
//
// Persistent: block b takes work units b, b + gridDim.x, ... of the
// tiles x splits units (split u / tiles, tile u % tiles through the raster),
// so at each step the resident blocks hold consecutive units, as a wave of
// one block per unit would.  The ring runs on across units: the producer
// loads the next unit's first stages while the consumers write this one's
// outputs.
template <int A_MN, int B_MN, int BN>
__global__ void __launch_bounds__(WG_THREADS, 1)
    mm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b, void* __restrict__ C,
                    float* __restrict__ ws, int M, int N, int K, int kchunk, int splits,
                    int group, int batch, int out_f32) {
  using S = WgSmem<BN>;
  wait_prior_grid();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  bf16* epi = reinterpret_cast<bf16*>(smem + WG_STAGES * S::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + WG_STAGES * S::STAGE + S::EPI_BYTES);
  uint64_t* empty = full + WG_STAGES;

  const int tiles_m = (M + WG_BM - 1) / WG_BM, tiles_n = (N + BN - 1) / BN;
  const int tiles = tiles_m * tiles_n;
  const int per_split = tiles * batch;  // a split's units: every slab's tiles
  const int units = per_split * splits;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);   // the producer's arrive + the TMA bytes
      hopper::mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every copy
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int g = 0;  // stages issued so far: the ring position
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int r = u % per_split, e = r / tiles;
        const Tile t = raster(r % tiles, tiles_m, tiles_n, group);
        const int m0 = t.m * WG_BM, n0 = t.n * BN;
        const int k_begin = (u / per_split) * kchunk;
        // a box of slab e: 3-D maps for a batch, 2-D for one product
        auto load = [&](void* dst, const CUtensorMap* map, int s, int c0, int c1) {
          if (batch > 1)
            hopper::tma_load_3d(dst, map, &full[s], c0, c1, e);
          else
            hopper::tma_load_2d(dst, map, &full[s], c0, c1);
        };
        const int iters = (min(K, k_begin + kchunk) - k_begin + WG_BK - 1) / WG_BK;
        for (int it = 0; it < iters; ++it, ++g) {
          const int s = g % WG_STAGES;
          hopper::mbar_wait(&empty[s], ((g / WG_STAGES) & 1) ^ 1);
          uint8_t* a_tile = smem + s * S::STAGE;
          uint8_t* b_tile = a_tile + S::A_BYTES;
          const int k = k_begin + it * WG_BK;
          hopper::mbar_arrive_expect_tx(&full[s], S::STAGE);
          if (A_MN) {  // two boxes of 64 M values x 64 K rows
            load(a_tile, &map_a, s, m0, k);
            load(a_tile + BOX_BYTES, &map_a, s, m0 + 64, k);
          } else {  // one box of 64 K values x 128 M rows
            load(a_tile, &map_a, s, k, m0);
          }
          if (B_MN) {  // BN / 64 boxes of 64 N values x 64 K rows
#pragma unroll
            for (int j = 0; j < BN / 64; ++j) load(b_tile + j * BOX_BYTES, &map_b, s, n0 + 64 * j, k);
          } else {  // one box of 64 K values x BN N rows
            load(b_tile, &map_b, s, k, n0);
          }
        }
      }
    }
  } else {
    // consumer warpgroup c: rows 64c .. 64c + 63 of each tile
    hopper::setmaxnreg_inc<232>();
    const int c = threadIdx.x / 128 - 1;
    const int lt = threadIdx.x % 128;
    int g = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int r = u % per_split, e = r / tiles;
      const Tile t = raster(r % tiles, tiles_m, tiles_n, group);
      const int m0 = t.m * WG_BM, n0 = t.n * BN;
      const int split = u / per_split;
      const int k_begin = split * kchunk;
      // slab e of the (batch, M, N) output
      void* Ce = static_cast<uint8_t*>(C) + (long long)e * M * N * (out_f32 ? 4 : 2);
      const int iters = (min(K, k_begin + kchunk) - k_begin + WG_BK - 1) / WG_BK;
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

      for (int it = 0; it < iters; ++it, ++g) {
        const int s = g % WG_STAGES;
        hopper::mbar_wait(&full[s], (g / WG_STAGES) & 1);
        // both A layouts put this warpgroup's 64 rows 8192 bytes apart
        const uint8_t* a_tile = smem + s * S::STAGE + c * BOX_BYTES;
        const uint8_t* b_tile = smem + s * S::STAGE + S::A_BYTES;
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WG_BK / 16; ++kk) {
          // a 16-deep slice: 16 rows on in an MN-major tile, 32 bytes on in
          // a K-major one (see hopper.cuh)
          const uint64_t da = A_MN ? hopper::desc_sw128(a_tile + kk * 2048, BOX_BYTES, 1024)
                                   : hopper::desc_sw128(a_tile + kk * 32, 16, 1024);
          const uint64_t db = B_MN ? hopper::desc_sw128(b_tile + kk * 2048, BOX_BYTES, 1024)
                                   : hopper::desc_sw128(b_tile + kk * 32, 16, 1024);
          hopper::wgmma_k16<BN, A_MN, B_MN>(acc, da, db, 1);
        }
        hopper::wgmma_commit();
        hopper::fence_regs(acc);
        // the previous stage's products have retired: free its buffers
        hopper::wgmma_wait<1>();
        if (it > 0 && lt % 32 == 0) hopper::mbar_arrive(&empty[(g - 1) % WG_STAGES]);
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (iters > 0 && lt % 32 == 0) hopper::mbar_arrive(&empty[(g - 1) % WG_STAGES]);

      const int r0 = 16 * (lt / 32) + (lt % 32) / 4;  // the fragment's rows r0, r0 + 8
      const int c0 = 2 * (lt % 4);
      if (out_f32 || splits > 1) {  // f32 out, or the split's slice of the workspace
        float* split_ws = splits > 1 ? ws : nullptr;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          store_pair(Ce, split_ws, split, out_f32, M, N, m0 + 64 * c + r0, n0 + c0 + 8 * j,
                     acc[4 * j], acc[4 * j + 1]);
          store_pair(Ce, split_ws, split, out_f32, M, N, m0 + 64 * c + r0 + 8, n0 + c0 + 8 * j,
                     acc[4 * j + 2], acc[4 * j + 3]);
        }
      } else {
        // bf16 out: each 64 x 64 chunk of this warpgroup's rows goes through
        // shared memory, so that every warp store writes whole 128-byte rows
        bf16* chunk = epi + c * 64 * EPI_LD;
        bf16* out = static_cast<bf16*>(Ce);
#pragma unroll
        for (int q = 0; q < BN / 64; ++q) {
          wg_sync(c);  // the previous chunk's reads are done
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int a = 4 * (8 * q + j);
            *reinterpret_cast<__nv_bfloat162*>(chunk + r0 * EPI_LD + 8 * j + c0) =
                __floats2bfloat162_rn(acc[a], acc[a + 1]);
            *reinterpret_cast<__nv_bfloat162*>(chunk + (r0 + 8) * EPI_LD + 8 * j + c0) =
                __floats2bfloat162_rn(acc[a + 2], acc[a + 3]);
          }
          wg_sync(c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {  // 64 rows x 8 pieces of 16 bytes
            const int rr = 16 * i + lt / 8, piece = lt % 8;
            const int row = m0 + 64 * c + rr, col = n0 + 64 * q + 8 * piece;
            if (row >= M || col >= N) continue;
            const bf16* src = chunk + rr * EPI_LD + 8 * piece;
            bf16* dst = out + (long long)row * N + col;
            if (N % 8 == 0 && col + 8 <= N) {
              *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
            } else {
              for (int e = 0; e < 8 && col + e < N; ++e) dst[e] = src[e];
            }
          }
        }
      }
    }
  }
}

template <int A_MN, int B_MN, int BN>
int launch_wgmma(const void* a, const void* b, void* c, float* ws, int m, int n, int k,
                 long long lda, long long ldb, int splits, int kchunk, int group, int batch,
                 long long sa, long long sb, int out_f32, cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  int err = A_MN ? hopper::encode_bf16_sw128(&map_a, a, k, m, lda, 64, batch, sa)
                 : hopper::encode_bf16_sw128(&map_a, a, m, k, lda, WG_BM, batch, sa);
  if (err) return err;
  err = B_MN ? hopper::encode_bf16_sw128(&map_b, b, k, n, ldb, 64, batch, sb)
             : hopper::encode_bf16_sw128(&map_b, b, n, k, ldb, BN, batch, sb);
  if (err) return err;
  // the dynamic shared memory limit, raised once per instantiation (the
  // first call runs eagerly, before any graph capture)
  static bool limit_set = false;
  if (!limit_set) {
    const cudaError_t e = cudaFuncSetAttribute(mm_wgmma_kernel<A_MN, B_MN, BN>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               WgSmem<BN>::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    limit_set = true;
  }
  const long long units = (long long)((m + WG_BM - 1) / WG_BM) * ((n + BN - 1) / BN) * batch *
                          splits;
  if (units > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = units < mma_bf16::sm_count() ? (int)units : mma_bf16::sm_count();
  return launch_dependent(mm_wgmma_kernel<A_MN, B_MN, BN>, dim3(blocks), WG_THREADS,
                          WgSmem<BN>::BYTES, 0, stream, map_a, map_b, c, ws, m, n, k, kchunk,
                          splits, group, batch, out_f32);
}

template <int A_MN, int B_MN>
int launch_wgmma_bn(int bn, const void* a, const void* b, void* c, float* ws, int m, int n,
                    int k, long long lda, long long ldb, int splits, int kchunk, int group,
                    int batch, long long sa, long long sb, int out_f32, cudaStream_t stream) {
  switch (bn) {
    case 64:
      return launch_wgmma<A_MN, B_MN, 64>(a, b, c, ws, m, n, k, lda, ldb, splits, kchunk,
                                          group, batch, sa, sb, out_f32, stream);
    case 128:
      return launch_wgmma<A_MN, B_MN, 128>(a, b, c, ws, m, n, k, lda, ldb, splits, kchunk,
                                           group, batch, sa, sb, out_f32, stream);
    case 192:
      return launch_wgmma<A_MN, B_MN, 192>(a, b, c, ws, m, n, k, lda, ldb, splits, kchunk,
                                           group, batch, sa, sb, out_f32, stream);
    case 256:
      return launch_wgmma<A_MN, B_MN, 256>(a, b, c, ws, m, n, k, lda, ldb, splits, kchunk,
                                           group, batch, sa, sb, out_f32, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// -- stream: bf16, M <= 16 ------------------------------------------------------------

constexpr int ST_BN = 64;
constexpr int ST_BK = 64;
constexpr int ST_STAGES = 4;
constexpr int ST_THREADS = 128;
constexpr int ST_LD = ST_BK + 8;  // padded rows: ldmatrix reads no bank twice
constexpr int ST_A = 16 * ST_LD;  // A: 16 rows x 64 K
constexpr int ST_B = 64 * ST_LD;  // B: 64 K rows x 64 N, or 64 N rows x 64 K
constexpr int ST_PLD = ST_BN + 4;  // the f32 partial tile's row pitch

// 16 bytes global -> shared, of which the first `bytes` are read and the
// rest zero-filled (bytes 0: nothing is read); L2 fetches the 256 bytes
// around them, so the neighbouring tile's or the next stage's bytes of the
// same rows arrive in one burst
__device__ __forceinline__ void cp_async_part(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ int chunk_bytes(int valid) {
  return valid <= 0 ? 0 : (valid >= 8 ? 16 : 2 * valid);
}

// B_KM: B is the view of a row-major (N, K) matrix (embed.T); else row-major
// (K, N).  A is row-major (M, K), M <= 16.  Block (x, y, z): split x of the K
// range (x is the cluster's rank), output columns 64 y .. 64 y + 63 of slab
// z (A and B sa and sb elements on per slab).
template <int B_KM>
__global__ void __launch_bounds__(ST_THREADS)
    mm_stream_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                     void* __restrict__ C, int M, int N, int K, long long lda, long long ldb,
                     long long sa, long long sb, int kchunk, int out_f32) {
  __shared__ __align__(128) bf16 smem[ST_STAGES * (ST_A + ST_B)];
  A += blockIdx.z * sa;
  B += blockIdx.z * sb;
  C = static_cast<uint8_t*>(C) + (long long)blockIdx.z * M * N * (out_f32 ? 4 : 2);
  wait_prior_grid();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.y * ST_BN;
  const int k_begin = blockIdx.x * kchunk;
  const int iters = (min(K, k_begin + kchunk) - k_begin + ST_BK - 1) / ST_BK;

  auto stage = [&](int s, int k0) {
    bf16* sa = smem + s * (ST_A + ST_B);
    bf16* sb = sa + ST_A;
    {  // A: 16 rows x 8 chunks, one per thread; rows past M are zeros
      const int r = tid / 8, kk = k0 + (tid % 8) * 8;
      const int bytes = r < M ? chunk_bytes(K - kk) : 0;
      cp_async_part(sa + r * ST_LD + (tid % 8) * 8, bytes ? A + r * lda + kk : A, bytes);
    }
#pragma unroll
    for (int j = 0; j < 64 * 8 / ST_THREADS; ++j) {  // B: 64 rows x 8 chunks
      const int i = tid + j * ST_THREADS;
      const int r = i / 8, ch = (i % 8) * 8;
      int bytes;
      const bf16* src;
      if (B_KM) {  // row r is output column n0 + r
        const int nn = n0 + r, kk = k0 + ch;
        bytes = nn < N ? chunk_bytes(K - kk) : 0;
        src = B + nn * ldb + kk;
      } else {  // row r is K index k0 + r
        const int kk = k0 + r, nn = n0 + ch;
        bytes = kk < K ? chunk_bytes(N - nn) : 0;
        src = B + kk * ldb + nn;
      }
      cp_async_part(sb + r * ST_LD + ch, bytes ? src : B, bytes);
    }
  };

  // each warp owns 16 output columns: two 8-column mma blocks.  Every
  // stage of the ring is in flight from the start (a short split's whole
  // K range at once); a stage is refilled as soon as it is consumed.
  float acc[2][4] = {};
#pragma unroll
  for (int s = 0; s < ST_STAGES; ++s) {
    if (s < iters) stage(s, k_begin + s * ST_BK);
    mma_bf16::cp_async_commit();
  }
  for (int it = 0; it < iters; ++it) {
    mma_bf16::cp_async_wait<ST_STAGES - 1>();
    __syncthreads();  // stage `it` landed for all threads
    const bf16* sa = smem + (it % ST_STAGES) * (ST_A + ST_B);
    const bf16* sb = sa + ST_A;
#pragma unroll
    for (int kk = 0; kk < ST_BK; kk += 16) {
      uint32_t a[4], b[4];
      mma_bf16::load_a(a, sa, ST_LD, kk, lane);
      if (B_KM)
        mma_bf16::load_b_rows(b, sb, ST_LD, warp * 16, kk, lane);
      else
        mma_bf16::load_b_cols(b, sb, ST_LD, kk, warp * 16, lane);
      mma_bf16::mma(acc[0], a, b[0], b[1]);
      mma_bf16::mma(acc[1], a, b[2], b[3]);
    }
    __syncthreads();  // every warp has read stage `it`: refill it
    if (it + ST_STAGES < iters) stage(it % ST_STAGES, k_begin + (it + ST_STAGES) * ST_BK);
    mma_bf16::cp_async_commit();
  }
  mma_bf16::cp_async_wait<0>();

  // this split's 16 x 64 partial, in the ring's first bytes
  float* part = reinterpret_cast<float*>(smem);
  {
    const int r = lane / 4, cc = warp * 16 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      part[r * ST_PLD + cc + 8 * j] = acc[j][0];
      part[r * ST_PLD + cc + 8 * j + 1] = acc[j][1];
      part[(r + 8) * ST_PLD + cc + 8 * j] = acc[j][2];
      part[(r + 8) * ST_PLD + cc + 8 * j + 1] = acc[j][3];
    }
  }
  // the cluster's blocks sum the splits' partials in rank order, each block
  // a share of the tile's elements, through distributed shared memory
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  for (int e = rank * ST_THREADS + tid; e < 16 * ST_BN; e += splits * ST_THREADS) {
    const int r = e / ST_BN, cc = e % ST_BN;
    if (r < M && n0 + cc < N) {
      float v = 0.f;
      for (int q = 0; q < splits; ++q) v += cluster.map_shared_rank(part, q)[r * ST_PLD + cc];
      store1(C, out_f32, (long long)r * N + n0 + cc, v);
    }
  }
  cluster.sync();  // no block leaves while another still reads its partial
}

template <int B_KM>
int launch_stream(const void* a, const void* b, void* c, int m, int n, int k, long long lda,
                  long long ldb, int splits, int kchunk, int batch, long long sa, long long sb,
                  int out_f32, cudaStream_t stream) {
  return launch_dependent(mm_stream_kernel<B_KM>, dim3(splits, (n + ST_BN - 1) / ST_BN, batch),
                          ST_THREADS, 0, splits, stream, static_cast<const bf16*>(a),
                          static_cast<const bf16*>(b), c, m, n, k, lda, ldb, sa, sb, kchunk,
                          out_f32);
}

// -- fma: f32 ----------------------------------------------------------------------

constexpr int F_BM = 128;
constexpr int F_BN = 128;
constexpr int F_BK = 16;
constexpr int F_THREADS = 128;
constexpr int F_LD = F_BM + 4;  // K-major rows of 128 values, padded

// TRANS_A: A is stored (K, M); TRANS_B: B is stored (N, K).  Both tiles are
// staged K-major (As[k][m], Bs[k][n]).  Thread (ty, tx) of 8 x 16 owns the
// 16 rows 4 ty + 32 g + {0..3} (g < 4) and the 8 columns 4 tx + 64 h +
// {0..3} (h < 2): each K step reads six float4 from shared memory for 128
// FMAs.  An 8 x 8 thread tile would read 64 bytes per 64 FMAs, which on
// Hopper (128 bytes of shared memory and 128 FMAs per clock per SM) makes
// shared memory as slow as the FMA units.
template <bool TRANS_A, bool TRANS_B>
__global__ void __launch_bounds__(F_THREADS, 2)
    mm_fma_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  void* __restrict__ C, float* __restrict__ ws, int M, int N, int K,
                  long long lda, long long ldb, long long sa, long long sb, int kchunk,
                  int group, int out_f32) {
  __shared__ __align__(16) float As[2][F_BK][F_LD];
  __shared__ __align__(16) float Bs[2][F_BK][F_LD];
  A += blockIdx.z * sa;  // slab z of a batched product
  B += blockIdx.z * sb;
  C = static_cast<uint8_t*>(C) + (long long)blockIdx.z * M * N * (out_f32 ? 4 : 2);
  wait_prior_grid();
  const int tiles_m = (M + F_BM - 1) / F_BM, tiles_n = (N + F_BN - 1) / F_BN;
  const Tile t = raster(blockIdx.x, tiles_m, tiles_n, group);
  const int m0 = t.m * F_BM, n0 = t.n * F_BN;
  const int k_begin = blockIdx.y * kchunk;
  const int iters = (min(K, k_begin + kchunk) - k_begin + F_BK - 1) / F_BK;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  // 2048 values of each tile, 16 per thread; 4-byte cp.async writes each
  // where its K-major tile wants it (zero-filled outside the matrix), with
  // neighbouring threads on neighbouring global addresses.  A thread's
  // copies share one K index (or one row) and step the other by a fixed
  // stride, so it keeps one base offset, not sixteen addresses.
  auto stage_one = [&](float (*dst)[F_LD], const float* X, long long ld, int o0, int O,
                       bool k_fast, int k0) {
    if (k_fast) {  // X stored (rows, K): row o0 + tid / 16 + 8 i, column tid % 16
      const int kk = tid % F_BK, o = tid / F_BK;
      const bool k_in = k0 + kk < K;
      const long long base = (long long)(o0 + o) * ld + k0 + kk;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const bool in = k_in && o0 + o + 8 * i < O;
        mma_bf16::cp_async4(&dst[kk][o + 8 * i], in ? X + base + 8 * i * ld : X, in);
      }
    } else {  // X stored (K, cols): K row i, column tid
      const bool o_in = o0 + tid < O;
      const long long base = (long long)k0 * ld + o0 + tid;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const bool in = o_in && k0 + i < K;
        mma_bf16::cp_async4(&dst[i][tid], in ? X + base + i * ld : X, in);
      }
    }
  };
  auto stage = [&](int buf, int k0) {
    stage_one(As[buf], A, lda, m0, M, !TRANS_A, k0);
    stage_one(Bs[buf], B, ldb, n0, N, TRANS_B, k0);
  };

  float acc[16][8];
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (iters > 0) stage(0, k_begin);
  mma_bf16::cp_async_commit();
  for (int it = 0; it < iters; ++it) {
    if (it + 1 < iters) stage((it + 1) & 1, k_begin + (it + 1) * F_BK);
    mma_bf16::cp_async_commit();
    mma_bf16::cp_async_wait<1>();
    __syncthreads();
    const int buf = it & 1;
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      float a[16], b[8];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(&As[buf][kk][4 * ty + 32 * g]);
        a[4 * g] = v.x, a[4 * g + 1] = v.y, a[4 * g + 2] = v.z, a[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(&Bs[buf][kk][4 * tx + 64 * h]);
        b[4 * h] = v.x, b[4 * h + 1] = v.y, b[4 * h + 2] = v.z, b[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the buffer is refilled next iteration
  }

  float* split_ws = gridDim.y > 1 ? ws : nullptr;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int row = m0 + 4 * ty + 32 * (i / 4) + i % 4;
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const int col = n0 + 4 * tx + 64 * (j / 4) + j % 4;
      store_pair(C, split_ws, blockIdx.y, out_f32, M, N, row, col, acc[i][j], acc[i][j + 1]);
    }
  }
}

template <bool TRANS_A, bool TRANS_B>
int launch_fma(const void* a, const void* b, void* c, float* ws, int m, int n, int k,
               long long lda, long long ldb, int splits, int kchunk, int group, int batch,
               long long sa, long long sb, int out_f32, cudaStream_t stream) {
  const int tiles = ((m + F_BM - 1) / F_BM) * ((n + F_BN - 1) / F_BN);
  return launch_dependent(mm_fma_kernel<TRANS_A, TRANS_B>, dim3(tiles, splits, batch), F_THREADS,
                          0, 0, stream, static_cast<const float*>(a), static_cast<const float*>(b),
                          c, ws, m, n, k, lda, ldb, sa, sb, kchunk, group, out_f32);
}

// -- wmma: bf16 operands that TMA cannot describe ---------------------------------------

using namespace nvcuda;

constexpr int WM_BN = 64;
constexpr int WM_BK = 32;
constexpr int WM_THREADS = 128;

// Copy the ROWS x COLS tile at (r0, c0) of a row-major matrix (R x C, row
// stride ld) into shared memory (row stride LDS), zero-filling outside it.
template <int ROWS, int COLS, int LDS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long ld, int r0,
                                          int c0, int R, int Cn, bool vec_ok) {
  constexpr int VEC = 8;
  constexpr int VPR = COLS / VEC;  // vectors per tile row
  for (int i = threadIdx.x; i < ROWS * VPR; i += WM_THREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * VEC;
    const int gr = r0 + r;
    const int gc = c0 + c;
    bf16* d = dst + r * LDS + c;
    if (vec_ok && gr < R && gc + VEC <= Cn) {
      *reinterpret_cast<uint4*>(d) =
          *reinterpret_cast<const uint4*>(src + (long long)gr * ld + gc);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        d[e] = (gr < R && gc + e < Cn) ? src[(long long)gr * ld + gc + e]
                                       : __float2bfloat16(0.f);
    }
  }
}

// One (BM x 64) output tile over the K range of split blockIdx.y, blockIdx.x
// walking N, then M, of slab blockIdx.z.
template <bool TRANS_A, bool TRANS_B, int BM>
__global__ void __launch_bounds__(WM_THREADS)
    mm_wmma_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                   void* __restrict__ C, float* __restrict__ ws, int M, int N, int K,
                   long long lda, long long ldb, long long sa, long long sb, int kchunk,
                   bool vec_a, bool vec_b, int out_f32) {
  A += blockIdx.z * sa;
  B += blockIdx.z * sb;
  C = static_cast<uint8_t*>(C) + (long long)blockIdx.z * M * N * (out_f32 ? 4 : 2);
  constexpr int PAD = 8;
  constexpr int LDA = TRANS_A ? BM + PAD : WM_BK + PAD;  // As: [BK][LDA] or [BM][LDA]
  constexpr int LDB = TRANS_B ? WM_BK + PAD : WM_BN + PAD;  // Bs: [BN][LDB] or [BK][LDB]
  constexpr int A_ROWS = TRANS_A ? WM_BK : BM;
  constexpr int B_ROWS = TRANS_B ? WM_BN : WM_BK;
  __shared__ __align__(128) bf16 As[A_ROWS * LDA];
  __shared__ __align__(128) bf16 Bs[B_ROWS * LDB];
  // 4 warps: 2 x 2 of 32 x 32 for BM = 64, 1 x 4 of 16 x 16 for BM = 16
  constexpr int WARPS_M = BM >= 64 ? 2 : 1;
  constexpr int WARPS_N = 4 / WARPS_M;
  constexpr int WM = BM / WARPS_M, WN = WM_BN / WARPS_N;
  constexpr int FM = WM / 16, FN = WN / 16;
  using ALayout = typename std::conditional<TRANS_A, wmma::col_major, wmma::row_major>::type;
  using BLayout = typename std::conditional<TRANS_B, wmma::col_major, wmma::row_major>::type;
  constexpr int LDC = WM_BN + 4;
  __shared__ __align__(128) float Cs[BM * LDC];

  const int tiles_n = (N + WM_BN - 1) / WM_BN;
  const int n0 = (blockIdx.x % tiles_n) * WM_BN;
  const int m0 = (blockIdx.x / tiles_n) * BM;
  const int k_begin = blockIdx.y * kchunk;
  const int k_end = min(K, k_begin + kchunk);

  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = k_begin; k0 < k_end; k0 += WM_BK) {
    if constexpr (TRANS_A)
      load_tile<WM_BK, BM, LDA>(As, A, lda, k0, m0, K, M, vec_a);
    else
      load_tile<BM, WM_BK, LDA>(As, A, lda, m0, k0, M, K, vec_a);
    if constexpr (TRANS_B)
      load_tile<WM_BN, WM_BK, LDB>(Bs, B, ldb, n0, k0, N, K, vec_b);
    else
      load_tile<WM_BK, WM_BN, LDB>(Bs, B, ldb, k0, n0, K, N, vec_b);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < WM_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb[FN];
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
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(Cs + (wm * WM + i * 16) * LDC + wn * WN + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  float* split_ws = gridDim.y > 1 ? ws : nullptr;
  for (int i = threadIdx.x; i < BM * WM_BN / 2; i += WM_THREADS) {
    const int r = i / (WM_BN / 2), c = 2 * (i % (WM_BN / 2));
    store_pair(C, split_ws, blockIdx.y, out_f32, M, N, m0 + r, n0 + c, Cs[r * LDC + c],
               Cs[r * LDC + c + 1]);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <bool TRANS_A, bool TRANS_B, int BM>
int launch_wmma(const void* a, const void* b, void* c, float* ws, int m, int n, int k,
                long long lda, long long ldb, int splits, int kchunk, int batch, long long sa,
                long long sb, int out_f32, cudaStream_t stream) {
  // 16-byte loads need every slab's rows on 16-byte steps too
  const bool vec_a = lda % 8 == 0 && sa % 8 == 0 && aligned16(a);
  const bool vec_b = ldb % 8 == 0 && sb % 8 == 0 && aligned16(b);
  const dim3 grid(((n + WM_BN - 1) / WM_BN) * ((m + BM - 1) / BM), splits, batch);
  mm_wmma_kernel<TRANS_A, TRANS_B, BM><<<grid, WM_THREADS, 0, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), c, ws, m, n, k, lda, ldb, sa,
      sb, kchunk, vec_a, vec_b, out_f32);
  return static_cast<int>(cudaGetLastError());
}

template <bool TRANS_A, bool TRANS_B>
int launch_wmma_bm(int bm, const void* a, const void* b, void* c, float* ws, int m, int n,
                   int k, long long lda, long long ldb, int splits, int kchunk, int batch,
                   long long sa, long long sb, int out_f32, cudaStream_t stream) {
  if (bm == 16)
    return launch_wmma<TRANS_A, TRANS_B, 16>(a, b, c, ws, m, n, k, lda, ldb, splits, kchunk,
                                             batch, sa, sb, out_f32, stream);
  return launch_wmma<TRANS_A, TRANS_B, 64>(a, b, c, ws, m, n, k, lda, ldb, splits, kchunk,
                                           batch, sa, sb, out_f32, stream);
}

// -- split-K reduction -------------------------------------------------------------

// Sum the split-K partials in split order and store them in the output type.
__global__ void splitk_reduce(const float* __restrict__ ws, void* __restrict__ C, int M, int N,
                              int splits, int out_f32) {
  const long long mn = (long long)M * N;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[z * mn + i];
    store1(C, out_f32, i, s);
  }
}

enum Instance { WGMMA = 0, STREAM = 1, WMMA = 2, FMA = 3 };

}  // namespace

// One K2 call.  dtype codes: 0 = float32, 1 = bfloat16.  trans_a: a is
// stored as a row-major (k, m) matrix with row stride lda (else row-major
// (m, k)); trans_b: b is stored as a row-major (n, k) matrix (else (k, n)).
// c is a contiguous (m, n) matrix.  instance: 0 wgmma, 1 stream, 2 wmma,
// 3 fma (hbp_matmul.path); tile_m (wmma: 16 or 64) and tile_n (wgmma: 64,
// 128, 192 or 256) pick the template, `splits` K ranges of `kchunk` each,
// `group` M tiles per column of the raster.  ws holds splits * m * n floats
// when splits > 1 (the stream instance reduces in its cluster instead).
// batch > 1: `batch` such products in one launch, slab e of a at a + e * sa
// and of b at b + e * sb (elements), c a contiguous (batch, m, n) stack;
// splits must be 1 then, but for the stream instance.
// Returns the first CUDA error code of the launch, 0 if none.
extern "C" int hbp_matmul(const void* a, const void* b, void* c, void* ws, int m, int n, int k,
                          long long lda, long long ldb, int trans_a, int trans_b,
                          int in_dtype, int out_dtype, int instance, int tile_m, int tile_n,
                          int splits, int kchunk, int group, int batch, long long sa,
                          long long sb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = splits > 1 ? static_cast<float*>(ws) : nullptr;
  const int out_f32 = out_dtype == 0;
  if (batch < 1 || batch > 65535 || (batch > 1 && splits > 1 && instance != STREAM))
    return static_cast<int>(cudaErrorInvalidValue);
  int err;
  switch (instance) {
    case WGMMA:
      if (in_dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
      // wgmma's transpose bits: A is MN-major when stored (k, m), B when
      // stored (k, n)
      if (trans_a && trans_b)
        err = launch_wgmma_bn<1, 0>(tile_n, a, b, c, w, m, n, k, lda, ldb, splits, kchunk,
                                    group, batch, sa, sb, out_f32, s);
      else if (trans_a)
        err = launch_wgmma_bn<1, 1>(tile_n, a, b, c, w, m, n, k, lda, ldb, splits, kchunk,
                                    group, batch, sa, sb, out_f32, s);
      else if (trans_b)
        err = launch_wgmma_bn<0, 0>(tile_n, a, b, c, w, m, n, k, lda, ldb, splits, kchunk,
                                    group, batch, sa, sb, out_f32, s);
      else
        err = launch_wgmma_bn<0, 1>(tile_n, a, b, c, w, m, n, k, lda, ldb, splits, kchunk,
                                    group, batch, sa, sb, out_f32, s);
      break;
    case STREAM:
      if (in_dtype != 1 || trans_a || m > 16 || splits > 8)
        return static_cast<int>(cudaErrorInvalidValue);
      return trans_b ? launch_stream<1>(a, b, c, m, n, k, lda, ldb, splits, kchunk, batch, sa,
                                        sb, out_f32, s)
                     : launch_stream<0>(a, b, c, m, n, k, lda, ldb, splits, kchunk, batch, sa,
                                        sb, out_f32, s);
    case WMMA:
      if (in_dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
      if (trans_a && trans_b)
        err = launch_wmma_bm<true, true>(tile_m, a, b, c, w, m, n, k, lda, ldb, splits,
                                         kchunk, batch, sa, sb, out_f32, s);
      else if (trans_a)
        err = launch_wmma_bm<true, false>(tile_m, a, b, c, w, m, n, k, lda, ldb, splits,
                                          kchunk, batch, sa, sb, out_f32, s);
      else if (trans_b)
        err = launch_wmma_bm<false, true>(tile_m, a, b, c, w, m, n, k, lda, ldb, splits,
                                          kchunk, batch, sa, sb, out_f32, s);
      else
        err = launch_wmma_bm<false, false>(tile_m, a, b, c, w, m, n, k, lda, ldb, splits,
                                           kchunk, batch, sa, sb, out_f32, s);
      break;
    case FMA:
      if (in_dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
      if (trans_a && trans_b)
        err = launch_fma<true, true>(a, b, c, w, m, n, k, lda, ldb, splits, kchunk, group,
                                     batch, sa, sb, out_f32, s);
      else if (trans_a)
        err = launch_fma<true, false>(a, b, c, w, m, n, k, lda, ldb, splits, kchunk, group,
                                      batch, sa, sb, out_f32, s);
      else if (trans_b)
        err = launch_fma<false, true>(a, b, c, w, m, n, k, lda, ldb, splits, kchunk, group,
                                      batch, sa, sb, out_f32, s);
      else
        err = launch_fma<false, false>(a, b, c, w, m, n, k, lda, ldb, splits, kchunk, group,
                                       batch, sa, sb, out_f32, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err || splits <= 1) return err;
  const long long mn = (long long)m * n;
  const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
  splitk_reduce<<<blocks, 256, 0, s>>>(w, c, m, n, splits, out_f32);
  return static_cast<int>(cudaGetLastError());
}
