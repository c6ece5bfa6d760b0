// K4, strassen_matmul: C = A @ B through up to two levels of Strassen's
// recursion in one kernel, f32, for sm_90a.
//
// Replaces src/repro/kernels/strassen_matmul.py:strassen_matmul and :matmul,
// whose leaves were the Pallas hbp_matmul (_mm_kernel) and whose operand and
// output combinations were separate elementwise passes.  The design is the
// "ABC" fused Strassen of Huang, Smith, Henry and van de Geijn (SC16) and
// Huang, Yu and van de Geijn (ACM TOMS 2020): every leaf product forms its
// operand sums while it loads them and adds its result into its C targets
// in the epilogue, so neither the sums nor the products exist in memory.
//
// The wrapper's table (strassen_matmul.leaf_plan) lists the 7^levels leaf
// products in a fixed order (7 at one level, 49 at two): for each, its A
// terms and B terms (up to 2^levels sub-blocks of the leaf edge e, each an
// element offset and a sign) and its C targets (up to 2^levels sub-blocks,
// a sign each, and whether this leaf is the target's first writer).
//
// Bound on the H100: operations.  At 8192^2 and two levels the leaves are
// 49 x 2 x 2048^3 = 842 GFLOP of f32 FMA (no TF32: the f32 paths compare card
// and CPU results), 12.6 ms at 67 TFLOP/s.  What the design does about it:
//   * a 128 x 128 output tile for 256 threads, 8 x 8 outputs a thread (warp
//     tiles of 64 x 32, lanes 8 x 4), K steps of 16 from K-major shared
//     tiles: per K index two float4 of A and two of B for 64 FMAs, each a
//     single shared-memory wavefront (eight or four lanes' distinct 16
//     bytes, the rest broadcast).  K2's fma instance holds 16 x 8 outputs a
//     thread; here the staging needs the registers that holds;
//   * the operand terms come in raw, by TMA: one thread issues a 128 x 16
//     box of the stored matrix for each term of the step two steps ahead
//     (STAGES = 2), completing on the stage's mbarrier, so the copies cost the
//     threads no registers and no load instructions (register-staged
//     16-byte loads and 16-byte cp.async were slower: the loads' issue and
//     L2 round trips, not their bytes, held the leaves back).  A scalar
//     instance (4-byte cp.async, masked) takes operands
//     TMA cannot describe or whose leaf edge is no multiple of 16;
//   * operand sums are formed on the way from the raw stage to the compute
//     tile, one step ahead, spread over the current step's FMAs (each
//     thread reads every term of a float4 at K index 4 g and sums and stores
//     it at 4 g + 2, with no branch in the FMA stream, which would split
//     its schedule): signed f32 adds in the plain version's association
//     (level one's pair first, then level two's: ((t0 + t1) + (t2 + t3)),
//     the bits of the plain version's combinations); 16-byte stores, or
//     4-byte ones for an operand stored with its K index contiguous (A
//     row-major, B a transposed view) through an XOR swizzle that keeps them
//     off each other's banks;
//   * block (i, j) owns output tile (i, j) of the leaf edge and walks all
//     leaves in the table's order, adding its tile into the same tile
//     position of each target: the first writer stores, the others add.
//     Where the leaf edge is a whole number of tiles the tile is staged in
//     shared memory and one thread issues a TMA store or f32 reduce-add
//     (performed at L2) a target, asynchronously, so the next leaf's FMAs
//     run while it lands; each leaf's TMA groups complete before the next
//     leaf's are issued.  (Else each thread reads, adds and stores.)  No
//     two blocks touch one C element and the order is fixed, so no zeroing
//     pass, no atomics from two writers, and two calls give the same bits.
//     The resident blocks move through the leaves together, so each term's
//     K slice is read from HBM about once and shared through the 50 MB L2;
//   * one block a SM (225 KB of shared memory: two raw stages of 64 KB, the
//     compute tiles, the 64 KB output tile; at most 255 registers a
//     thread); a leaf edge of 2048 is 256 tiles, two rounds on 132 SMs.
//     (Two blocks a SM, at 128 registers, spilled; PERF.md has the designs
//     tried.)
// Ragged edges (an odd leaf edge such as 65) are masked by the scalar
// instance.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 16, THREADS = 256;
constexpr int LD = BM + 4;  // K-major rows of 128 values, padded
constexpr int MAX_LEAVES = 49;  // two levels

// One leaf product; strassen_matmul.py's _LEAF has the same layout (160 bytes).
struct Leaf {
  long long a[4], b[4], c[4];  // element offsets of the terms and targets
  float sa[4], sb[4], sc[4];   // their signs (+1 or -1)
  int na, nb, nc;              // terms of A, of B (1, 2 or 4), targets (1-4)
  int first;                   // bit i: this leaf is target i's first writer
};
static_assert(sizeof(Leaf) == 160, "Leaf layout");

// Column o of K row k of a shared tile: 16-byte groups XOR-swizzled by
// (k / 4) mod 4, so a K-contiguous operand's scalar stores (eight rows,
// four K groups a warp) meet 32 banks, while every 16-byte group stays
// whole for the float4 reads.
__device__ __forceinline__ int swz(int k, int o) { return o ^ ((k << 1) & 24); }

// One operand of the leaves: X stored with its tile index o (M for A, N for
// B) contiguous (DIRECT) or its K index contiguous.  Thread t's share of a
// BK x 128 tile is two float4: DIRECT, K row warp + 8 i and values 4 lane ..
// + 3; else row 8 warp + lane / 4 + 64 i and K values 4 (lane % 4) .. + 3
// (a quarter warp's reads of the raw box meet eight 16-byte bank groups).
// The thread's offsets within a term and the bounds of its float4 are fixed,
// so the scalar instance's copies of a step only add the step's K offset.
template <bool DIRECT, bool VEC>
struct Operand {
  long long ld, kstep;  // kstep: the offset of one K step, BK ld or BK
  long long toff[2];    // float4 i's offset from a term's origin at k0 = 0
  int o[2], k[2];       // its tile index and its first K index at k0 = 0
  int e;

  __device__ Operand(long long ld_, int o0, int e_) : ld(ld_), e(e_) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    kstep = DIRECT ? BK * ld : BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      k[i] = DIRECT ? warp + 8 * i : 4 * (lane % 4);
      o[i] = DIRECT ? 4 * lane : 8 * warp + lane / 4 + 64 * i;
      toff[i] = DIRECT ? (long long)k[i] * ld + o0 + o[i] : (long long)(o0 + o[i]) * ld + k[i];
      o[i] += o0;
    }
  }

  // float4 i of the term at p (its origin plus the step's K offset; k0 the
  // step's first K index) into dst by 4-byte cp.async (the scalar instance),
  // zeros outside the e x e block
  __device__ __forceinline__ void copy(float* dst, const float* p, const float* any, int i,
                                       int k0) const {
    p += toff[i];
    const int kk = k0 + k[i], oo = o[i];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool in = DIRECT ? kk < e && oo + c < e : oo < e && kk + c < e;
      mma_bf16::cp_async4(dst + c, in ? p + c : any, in);
    }
  }

  // where float4 i sits in a raw box: DIRECT [16 k][128 o], else [128 o][16 k]
  __device__ __forceinline__ int raw_at(int i) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    return DIRECT ? (warp + 8 * i) * 128 + 4 * lane
                  : (8 * warp + lane / 4 + 64 * i) * 16 + 4 * (lane % 4);
  }

  // float4 i's sum into the K-major tile s (tile coordinates, swizzled)
  __device__ __forceinline__ void store(float (*s)[LD], int i, float4 v) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int kk = DIRECT ? warp + 8 * i : 4 * (lane % 4);
    const int oo = DIRECT ? 4 * lane : 8 * warp + lane / 4 + 64 * i;
    if (DIRECT) {
      *reinterpret_cast<float4*>(&s[kk][swz(kk, oo)]) = v;
    } else {
      s[kk][swz(kk, oo)] = v.x;
      s[kk + 1][swz(kk + 1, oo)] = v.y;
      s[kk + 2][swz(kk + 2, oo)] = v.z;
      s[kk + 3][swz(kk + 3, oo)] = v.w;
    }
  }
};

__device__ __forceinline__ float4 axpy4(float s, float4 t, float4 u) {
  return make_float4(u.x + s * t.x, u.y + s * t.y, u.z + s * t.z, u.w + s * t.w);
}

// the signed sum of a float4's terms, ((t0 + t1) + (t2 + t3)); absent terms
// are zero, which leaves the sum's bits as they are
__device__ __forceinline__ float4 term_sum(const float4* t, const float* s) {
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 u = axpy4(s[1], t[1], axpy4(s[0], t[0], z));
  const float4 v = axpy4(s[3], t[3], axpy4(s[2], t[2], z));
  return make_float4(u.x + v.x, u.y + v.y, u.z + v.z, u.w + v.w);
}

// Shared memory (225 KB): the raw ring (STAGES stages; a stage holds every
// term's 128 x 16 box, A's four then B's, each laid out as Operand::raw_at
// says), the two K-major compute tiles of each operand, the output tile of
// the TMA epilogue, and a barrier a stage for the TMA instance.  The leaf table stays in global memory
// (uniform loads, cached).
constexpr int STAGES = 2;
constexpr int RAW_TERM = 2 * THREADS;  // float4 of one term's box
constexpr int RAW_STAGE = 8 * RAW_TERM;
constexpr int BOX_BYTES = RAW_TERM * 16;
struct Smem {
  float4 raw[STAGES][RAW_STAGE];
  float as[2][BK][LD];
  float bs[2][BK][LD];
  float cs[BM][BN];  // a leaf's output tile, for the TMA epilogue
  uint64_t bar[STAGES];
};

// Warp w computes the 64 x 32 sub-tile (64 (w % 2), 32 (w / 2)); lane
// (lane % 8, lane / 8) owns rows 4 (lane % 8) + {0..3} and 32 + 4 (lane %
// 8) + {0..3}, columns 4 (lane / 8) + {0..3} and 16 + 4 (lane / 8) + {0..3}
// of it: per K index two float4 of A and two of B, each one shared-memory
// wavefront (eight and four distinct addresses a warp), for 64 FMAs.
//
// Step s (one K step of one leaf; the step after a leaf's last is the next
// leaf's first): wait for step s + 1's raw terms and sync; start step s +
// STAGES's copies into the stage step s's terms left (VEC: one thread
// issues a TMA box a term, completing on the stage's barrier; else every
// thread its cp.async); then the 16 K indices of step s's FMAs, with step s
// + 1's four float4 a thread (two of A, two of B; every term) read from the
// raw stage at K indices 0, 4, 8 and 12, summed and stored into the other
// compute tile two K indices later.
template <bool TA, bool TB, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
    strassen_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    const __grid_constant__ CUtensorMap map_c, const float* __restrict__ A,
                    const float* __restrict__ B, float* __restrict__ C,
                    const Leaf* __restrict__ table, int nleaves, int e, long long lda,
                    long long ldb, long long ldc) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  if (VEC && threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) hopper::mbar_init(&sm.bar[st], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int tiles_n = (e + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * BM, n0 = (blockIdx.x % tiles_n) * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = 64 * (warp % 2) + 4 * (lane % 8), col0 = 32 * (warp / 2) + 4 * (lane / 8);
  const int total = nleaves * ((e + BK - 1) / BK);
  // whole 128 x 128 tiles of every target: the epilogue goes by TMA
  const bool tma_epi = VEC && e % BM == 0;
  // A is DIRECT when stored (K, M) (TA), B when stored (K, N) (not TB)
  const Operand<TA, VEC> opa(lda, m0, e);
  const Operand<!TB, VEC> opb(ldb, n0, e);

  // the copy side, STAGES steps ahead: its step and its leaf's terms: counts
  // and origins (cp.async: pointers plus the step's K offset; TMA: the
  // origin's (inner, outer) coordinates in the stored matrix)
  int cp_leaf = 0, cp_k0 = 0, cna = 0, cnb = 0;
  const float* pa[4];
  const float* pb[4];
  int ca[4][2], cb[4][2];
  auto copy_leaf = [&]() {
    const Leaf& lf = table[cp_leaf];
    cna = lf.na;
    cnb = lf.nb;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (VEC) {
        ca[j][0] = (int)(lf.a[j] % lda), ca[j][1] = (int)(lf.a[j] / lda);
        cb[j][0] = (int)(lf.b[j] % ldb), cb[j][1] = (int)(lf.b[j] / ldb);
      } else {
        pa[j] = A + lf.a[j];
        pb[j] = B + lf.b[j];
      }
    }
  };
  // the copy side's step into raw stage `stage`, then on to the next step
  auto copy_step = [&](int stage) {
    float4* raw = sm.raw[stage];
    if (VEC) {
      if (tid == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        hopper::mbar_arrive_expect_tx(&sm.bar[stage], (cna + cnb) * BOX_BYTES);
        // box coordinates (inner, outer): DIRECT stores (K, o), else (o, K)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < cna)
            hopper::tma_load_2d(raw + j * RAW_TERM, &map_a, &sm.bar[stage],
                                ca[j][0] + (TA ? m0 : cp_k0), ca[j][1] + (TA ? cp_k0 : m0));
          if (j < cnb)
            hopper::tma_load_2d(raw + (4 + j) * RAW_TERM, &map_b, &sm.bar[stage],
                                cb[j][0] + (TB ? cp_k0 : n0), cb[j][1] + (TB ? n0 : cp_k0));
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (j < cna)
            opa.copy(reinterpret_cast<float*>(raw + j * RAW_TERM) + opa.raw_at(i), pa[j], A, i,
                     cp_k0);
          if (j < cnb)
            opb.copy(reinterpret_cast<float*>(raw + (4 + j) * RAW_TERM) + opb.raw_at(i), pb[j],
                     B, i, cp_k0);
        }
    }
    cp_k0 += BK;
    if (cp_k0 >= e) {
      cp_k0 = 0;
      if (++cp_leaf < nleaves) copy_leaf();
    } else if (!VEC) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pa[j] += opa.kstep;
        pb[j] += opb.kstep;
      }
    }
  };
  // wait until step `st`'s terms are in raw stage `stage` (this thread's
  // cp.async, or the stage's TMA barrier; a __syncthreads follows)
  auto wait_step = [&](int st, int stage) {
    if (VEC)
      hopper::mbar_wait(&sm.bar[stage], (st / STAGES) & 1);
    else
      mma_bf16::cp_async_wait<STAGES - 2>();
  };
  // the combine side, one step ahead: its leaf's counts and signs
  int nx_leaf = 0, nx_k0 = 0, mna = 0, mnb = 0;
  float msa[4], msb[4];
  auto combine_leaf = [&]() {
    const Leaf& lf = table[nx_leaf];
    mna = lf.na;
    mnb = lf.nb;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      msa[j] = lf.sa[j];
      msb[j] = lf.sb[j];
    }
  };
  // float4 g (g < 2: A's float4 g, else B's float4 g - 2) of the combine
  // side's step, every term read from raw stage `stage` into t ...
  auto combine_load = [&](int stage, int g, float4 (&t)[4]) {
    const bool is_a = g < 2;
    const int nt = is_a ? mna : mnb;
    const float* raw = reinterpret_cast<const float*>(sm.raw[stage] + (is_a ? 0 : 4) * RAW_TERM) +
                       (is_a ? opa.raw_at(g & 1) : opb.raw_at(g & 1));
#pragma unroll
    for (int j = 0; j < 4; ++j)
      t[j] = j < nt ? *reinterpret_cast<const float4*>(raw + j * 4 * RAW_TERM)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  // ... and their signed sum into compute tile `buf`
  auto combine_store = [&](int buf, int g, const float4 (&t)[4]) {
    if (g < 2)
      opa.store(sm.as[buf], g & 1, term_sum(t, msa));
    else
      opb.store(sm.bs[buf], g & 1, term_sum(t, msb));
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // step st's raw stage is st % STAGES; one cp.async commit a stage, empty
  // past the end
  copy_leaf();
  for (int st = 0; st < STAGES; ++st) {
    if (st < total) copy_step(st);
    if (!VEC) mma_bf16::cp_async_commit();
  }
  combine_leaf();
  if (VEC)
    hopper::mbar_wait(&sm.bar[0], 0);
  else
    mma_bf16::cp_async_wait<STAGES - 1>();
  __syncthreads();
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    float4 t[4];
    combine_load(0, g, t);
    combine_store(0, g, t);
  }
  nx_k0 += BK;  // the combine side on to step 1
  if (nx_k0 >= e) nx_k0 = 0, ++nx_leaf;
  if (nx_leaf < nleaves) combine_leaf();

  int cur_leaf = 0, cur_k0 = 0;
  for (int st = 0, stage = 0; st < total; ++st) {
    const int buf = st & 1, next_stage = stage + 1 == STAGES ? 0 : stage + 1;
    const bool more = st + 1 < total;
    if (more) wait_step(st + 1, next_stage);  // step st + 1's terms ...
    __syncthreads();  // ... for every thread; step st - 1's tile and stage st's are free
    // step st + STAGES into the stage step st's terms leave
    if (st + STAGES < total) copy_step(stage);
    if (!VEC) mma_bf16::cp_async_commit();
    float4 t[4];
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      // step st + 1's float4 g: its terms read at kk = 4 g, summed and
      // stored at 4 g + 2
      // (unconditional: past the last step they fill the unused tile, and
      // a branch here would split the FMA stream)
      if (kk % 4 == 0) combine_load(next_stage, kk / 4, t);
      if (kk % 4 == 2) combine_store(buf ^ 1, kk / 4, t);
      float a[8], b[8];
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(&sm.as[buf][kk][swz(kk, row0 + 32 * g)]);
        a[4 * g] = v.x, a[4 * g + 1] = v.y, a[4 * g + 2] = v.z, a[4 * g + 3] = v.w;
        const float4 w = *reinterpret_cast<const float4*>(&sm.bs[buf][kk][swz(kk, col0 + 16 * g)]);
        b[4 * g] = w.x, b[4 * g + 1] = w.y, b[4 * g + 2] = w.z, b[4 * g + 3] = w.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {  // the combine side on to step st + 2
      nx_k0 += BK;
      if (nx_k0 >= e) {
        nx_k0 = 0;
        if (++nx_leaf < nleaves) combine_leaf();
      }
    }

    if (cur_k0 + BK >= e && tma_epi) {
      // the leaf's tile into each of its targets by TMA, staged in cs: +acc
      // for the targets of sign +1, then -acc for the rest; a first writer
      // stores, the others reduce-add at L2.  The previous leaf's groups
      // complete first, so each element's adds keep the leaves' order.
      const Leaf& lf = table[cur_leaf];
#pragma unroll 1
      for (int pass = 0; pass < 2; ++pass) {
        const float sg = pass == 0 ? 1.f : -1.f;
        bool any = false;
        for (int t = 0; t < lf.nc; ++t) any |= lf.sc[t] == sg;
        if (!any) continue;
        if (tid == 0) hopper::bulk_wait_all();
        __syncthreads();  // cs is free
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float* r = &acc[i][4 * h];
            *reinterpret_cast<float4*>(&sm.cs[row0 + 32 * (i / 4) + i % 4][col0 + 16 * h]) =
                make_float4(sg * r[0], sg * r[1], sg * r[2], sg * r[3]);
          }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        if (tid == 0) {
          for (int t = 0; t < lf.nc; ++t) {
            if (lf.sc[t] != sg) continue;
            const int c0 = (int)(lf.c[t] % ldc) + n0, c1 = (int)(lf.c[t] / ldc) + m0;
            if ((lf.first >> t) & 1)
              hopper::tma_store_2d(&map_c, &sm.cs[0][0], c0, c1);
            else
              hopper::tma_reduce_add_2d(&map_c, &sm.cs[0][0], c0, c1);
          }
          hopper::bulk_commit();
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    } else if (cur_k0 + BK >= e) {  // the leaf's tile into each of its targets
      const Leaf& lf = table[cur_leaf];
#pragma unroll 1
      for (int t = 0; t < lf.nc; ++t) {
        float* ct = C + lf.c[t];
        const float sg = lf.sc[t];
        const bool first = (lf.first >> t) & 1;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int row = m0 + row0 + 32 * (i / 4) + i % 4;
          if (row >= e) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int col = n0 + col0 + 16 * h;
            float* p = ct + (long long)row * ldc + col;
            const float* r = &acc[i][4 * h];
            if (VEC) {
              if (col >= e) continue;
              float4 v = make_float4(sg * r[0], sg * r[1], sg * r[2], sg * r[3]);
              if (!first) {
                const float4 o = *reinterpret_cast<const float4*>(p);
                v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
              }
              *reinterpret_cast<float4*>(p) = v;
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (col + j < e) p[j] = first ? sg * r[j] : p[j] + sg * r[j];
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    cur_k0 += BK;
    if (cur_k0 >= e) cur_k0 = 0, ++cur_leaf;
    stage = next_stage;
  }
  if (tma_epi && tid == 0) hopper::bulk_wait_all();
}

template <bool TA, bool TB, bool VEC>
int launch(const float* a, const float* b, float* c, const Leaf* table, int nleaves, int e,
           int n, long long lda, long long ldb, long long ldc, cudaStream_t s) {
  // the tensor maps of the stored n x n operands in 128 x 16 boxes: DIRECT
  // (o contiguous) 128 wide and 16 deep, else 16 wide and 128 deep
  CUtensorMap map_a = {}, map_b = {}, map_c = {};
  if (VEC) {
    int err = hopper::encode_f32(&map_a, a, n, n, lda, TA ? BM : BK, TA ? BK : BM);
    if (err) return err;
    err = hopper::encode_f32(&map_b, b, n, n, ldb, TB ? BK : BN, TB ? BN : BK);
    if (err) return err;
    err = hopper::encode_f32(&map_c, c, n, n, ldc, BN, BM);  // the output tiles
    if (err) return err;
  }
  // raised once, on the first call, so that a launch captured in a CUDA
  // graph makes no attribute call once a call has warmed up
  static cudaError_t raised = cudaFuncSetAttribute(
      strassen_kernel<TA, TB, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      sizeof(Smem));
  if (raised != cudaSuccess) return static_cast<int>(raised);
  const long long tiles = (long long)((e + BM - 1) / BM) * ((e + BN - 1) / BN);
  if (tiles >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  strassen_kernel<TA, TB, VEC><<<(unsigned)tiles, THREADS, sizeof(Smem), s>>>(
      map_a, map_b, map_c, a, b, c, table, nleaves, e, lda, ldb, ldc);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC>
int launch_layout(int trans_a, int trans_b, const float* a, const float* b, float* c,
                  const Leaf* t, int nl, int e, int n, long long lda, long long ldb,
                  long long ldc, cudaStream_t s) {
  if (trans_a && trans_b) return launch<true, true, VEC>(a, b, c, t, nl, e, n, lda, ldb, ldc, s);
  if (trans_a) return launch<true, false, VEC>(a, b, c, t, nl, e, n, lda, ldb, ldc, s);
  if (trans_b) return launch<false, true, VEC>(a, b, c, t, nl, e, n, lda, ldb, ldc, s);
  return launch<false, false, VEC>(a, b, c, t, nl, e, n, lda, ldb, ldc, s);
}

}  // namespace

// One fused Strassen product of f32 operands.  trans_a: a is stored as a
// row-major (k, m) matrix with row stride lda (else row-major (m, k));
// trans_b: b is stored as a row-major (n, k) matrix (else (k, n)); c is f32
// with row stride ldc.  table: nleaves (at most 49) Leaf records on the
// device, in order; e: the leaf edge.  vec: every pointer 16-byte aligned,
// and e, lda, ldb, ldc and every offset multiples of 4.  Returns the
// launch's CUDA error code, 0 if none.
extern "C" int strassen_matmul(const void* a, const void* b, void* c, const void* table,
                               int nleaves, int e, int n, long long lda, long long ldb,
                               long long ldc, int trans_a, int trans_b, int vec, void* stream) {
  if (nleaves < 1 || nleaves > MAX_LEAVES || e < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  float* fc = static_cast<float*>(c);
  const Leaf* t = static_cast<const Leaf*>(table);
  return vec ? launch_layout<true>(trans_a, trans_b, fa, fb, fc, t, nleaves, e, n, lda, ldb,
                                   ldc, s)
             : launch_layout<false>(trans_a, trans_b, fa, fb, fc, t, nleaves, e, n, lda, ldb,
                                    ldc, s);
}
