// Matrix-unit probe for Hopper (sm_90a): how far the wgmma path that
// kernels A, C and D run gets at the flagship's conv shapes, with both
// operands in shared memory and nothing loaded from device memory; and the
// cost of the slab-build pattern in shared memory.
//
// Replaces the three Pallas kernels of scripts/mxu_probe.py:
//   mxu_dot    <- `dot_kernel`   (scripts/mxu_probe.py:24, pallas_call :38)
//   mxu_rdot   <- `rdot_kernel`  (scripts/mxu_probe.py:56, pallas_call :71)
//   slab_build <- `build_kernel` (scripts/mxu_probe.py:89, pallas_call :103)
//
// What each computes (every operand is a constant made on chip; nothing is
// read from device memory):
//   mxu_dot(k, n, ps, reps): a (ps, k) and b (k, n) bf16, all 0.5; reps
//     times o[0, :] += sum over rows of (a @ b), f32 accumulation; o is
//     (8, n) f32 and rows 1-7 stay 0.
//   mxu_rdot(m, n, ps, reps): a (ps, m) and b (ps, n) bf16, all 0.5; reps
//     times o[0, 0] += sum of (a^T @ b), the weight-gradient-style row
//     contraction; o is (8, 128) f32.
//   slab_build(cs, copies, ps, reps): a slab s (ps, copies * cs) bf16 that
//     starts at 0.25; each rep norm = bf16(s[:, :cs] * 1.0001), then
//     `copies` shifted stores s[1:, c*cs:(c+1)*cs] = norm[:-1], and
//     o += norm[0, 0]; o is (1, 1) f32. With `slab_out` set (the check
//     launch) the final slab is also written to device memory.
//
// The TPU grid `grid=(REPS,)` runs in order on one core, and its first
// step fills the VMEM scratch. Here every block fills its own shared-memory
// operands once, and the reps are work items that a persistent grid splits.
//
// What bounds it on this card. mxu_dot and mxu_rdot: operations, 2 * ps *
// k * n (or m * n) FLOP per rep at the bf16 tensor-core rate; they move no
// operand bytes. Inside the SM, an m64nNk16 wgmma with both operands in
// shared memory reads A (64 x 16, 2 KB) and B (16 x N, 32 N bytes) for N / 2
// clocks of tensor work (4096 bf16 operations a clock per SM): 128 bytes a
// clock at N = 64, the whole of what shared memory gives, 96 at N = 128 and
// 85 at N = 192. So at N = 64 the operand reads bound the dot as much as
// the operations do. slab_build: shared-memory bandwidth, per rep ps * cs
// * 2 bytes read and copies * ps * cs * 2 bytes written, at 128 bytes a
// clock on each SM.
//
// Design of the dot kernels. Two warpgroups per block, one block per SM,
// each warpgroup one chain of raw-PTX wgmma.mma_async (csrc/wgmma.cuh) with
// both operands read from 128-byte-swizzled shared memory through
// descriptors:
//   - Operands made once. Since every element of an operand is the same
//     constant, a block fills one 64-deep K chunk of each operand (whole
//     128-byte rows, so the swizzle does not change what a row holds), then
//     one fence.proxy.async and one barrier. A rep walks K by issuing k / 16
//     (mxu_rdot: its rows / 16) wgmmas that cycle over the chunk's four k16
//     sub-tiles: the products and sums are those of the full operands.
//     Inside the work loop there is no barrier, no copy and no load; each
//     item's wgmmas are one commit group, and wgmma_wait<1> keeps one group
//     in flight.
//   - The conv kernels' operand layouts. mxu_dot: A and B K-major, A's rows
//     the plane's (as A's and C's staged runs), B's the n columns (as their
//     packed weights). mxu_rdot: A = a^T and B both MN-major, rows of the
//     plane (as kernel D reads xn^T and dconv); B wider than 64 is stored as
//     64-column atoms (desc_sw128_mn).
//   - Each wgmma as wide as the combination allows: N = the widest of 192,
//     128 and 64 that divides n (so n = 384 runs as two column tiles of 192).
//   - A persistent, evenly split grid: blocks = SMs (never more than the
//     items), and block b takes items [b * items / blocks, (b + 1) * items /
//     blocks). mxu_dot's items are (128-row tile of the plane, N-column
//     tile, rep), warpgroup w taking the tile's rows 64 w ..; mxu_rdot's are
//     (64 x N output tile, 256-row chunk of the plane, rep), warpgroup 0
//     taking the chunk's first half of k16 steps and warpgroup 1 the rest
//     (both issue the same count, the last of an odd count on zero rows,
//     so that no control flow depends on the warpgroup: ptxas serializes
//     the wgmmas of a warpgroup-dependent loop); reps innermost. A
//     warpgroup keeps its accumulators in registers while consecutive items
//     share an output tile and folds them into o when the tile changes:
//     mxu_dot sums its valid rows (rows past ps are computed and not
//     folded) into one f32 atomicAdd per column, mxu_rdot its whole tile
//     into one atomicAdd, each through a named barrier of its own
//     warpgroup.
// kernels/layout.py mirrors the plan (mxu_probe_tile) and the library
// loader compares the two.
//
// Design of slab_build. The shift only ever moves column block 0 of row r
// into row r + 1 of each block, so the data a lane needs is private to it:
//   - A block holds its slab rows in shared memory (block b the rows
//     [b ps / B, (b + 1) ps / B); B = SMs, fewer where the strips would be
//     shorter than BUILD_MIN_STRIP rows, more where a block's rows do not
//     fit or would make strips longer than 4 BUILD_ROWS), split evenly
//     into BUILD_STRIPS strips. A row's cs / 8 column vectors are split
//     into segments of BUILD_SEG (128 bytes); one warp per (strip,
//     segment) unit (four warps at cs = 64, eight at cs = 128).
//   - In a unit, lane (q, i) (quarter-warp q, lane i of it) owns column
//     vector i of the segment over the strip's rows first + q + 4 e (e <
//     BUILD_ROWS), so each 16-byte access of a quarter-warp is one 128-byte
//     row segment, without bank conflicts. A build is straight-line code:
//     the lane loads all its rows of block 0 into registers, a __syncwarp
//     (other lanes of the warp read the rows it is about to write), then it
//     stores each row's norm one row down into every copy (the copies
//     unrolled for the probe's 1, 3 and 9), and a second __syncwarp (the
//     next build reads rows that other lanes wrote). No other warp touches
//     the unit's addresses, so a build needs no block-wide barrier: the rep
//     loop has none. Measured alternatives (PERF.md §6): a bottom-up
//     walk in steps of 8 rows with the next step's loads in flight, and
//     quarters owning consecutive rows with the one value that crosses
//     quarters passed by __shfl_up_sync (no __syncwarp at all), both ran
//     slower; a block must stay at 256 threads or fewer, or the register
//     cap spills the loop.
//   - A strip's first row is never written, and its last row's norm is not
//     stored: that row belongs to the next strip, and it keeps the value
//     it holds. That gives the TPU kernel's exact result: the slab is a
//     fixed point, since bf16(0.25 * 1.0001) = 0.25 (the bf16 spacing at
//     0.25 is 2^-9), so the first row of a strip holds the value it would
//     receive from the strip above. The launch leaves out one row's stores
//     per strip, 528 of 10976 rows at ps 10976 (4.8%).
//   - o: the lane that holds row 0, vector 0 adds norm[0, 0] each build.
//
// Exactness. Every product is exact (0.5 * 0.5 in bf16), and an f32 sum
// stays exact while each partial is a multiple of the f32 spacing at its
// own size, which holds for values that are multiples of 2^s below
// 2^(24 + s). Per accumulator element: each wgmma adds (rows of its k16
// step) x 0.25, so an element is a multiple of 0.25 below reps * ps / 4 <
// 2^20 at the probe's shapes. Per warpgroup: all the elements of a tile
// run hold one value E; mxu_dot adds rows r and r + 8 in each thread, then
// the eight row groups by a shuffle tree, then the four warps pairwise, so
// each partial is q x E for q valid rows (q <= 64); mxu_rdot sums a
// thread's N / 2 elements as a pairwise tree, then the 32 lanes and the
// four warps likewise, so each partial is 2^i E or 3 x 2^i E. Across
// blocks: mxu_dot's terms are (valid rows, a multiple of 32 at ps 10976) x
// reps done x k / 4, multiples of 2^8; mxu_rdot's are 64 N x (rows done) /
// 4 with rows done a multiple of 16 (256-row chunks, a 224-row last one,
// split in whole k16 steps), multiples of 2^14, and its largest total
// (1152 x 128) is below 2^37. So at the probe's shapes (ps 10976, reps 200,
// the JAX script's 11 + 6 combinations) every sum is exact in any order of
// the atomics, and the kernels agree with their plain versions exactly;
// tests/test_torch_probe_plan.py replays the plan's summation order in
// float32 for each combination.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using namespace hopper;

constexpr int BLOCKS_PER_SM = 1;
constexpr int WG = 2;                 // warpgroups per block
constexpr int THREADS = 128 * WG;
constexpr int CHUNK_K = 64;           // depth of each operand's chunk
constexpr int DOT_ROWS = 64 * WG;     // plane rows of a mxu_dot item
constexpr int RDOT_CHUNK = 256;       // plane rows of a mxu_rdot item

// slab_build: strips per block, 16-byte vectors of a segment (a
// quarter-warp's 128 bytes of one row), rows of each lane at most (a strip
// has at most 4 BUILD_ROWS rows), the rows a strip gets at least where the
// plane allows, warps per block at most (mirrored by kernels/layout.py);
// shared memory a block may use
constexpr int BUILD_STRIPS = 4;
constexpr int BUILD_SEG = 8;
constexpr int BUILD_ROWS = 8;
constexpr int BUILD_MIN_STRIP = 16;
constexpr int BUILD_MAX_WARPS = 8;
constexpr int SMEM_MAX = 232448;

// The N of each wgmma: the widest of 192, 128 and 64 that divides n.
__host__ __device__ int tile_n(int n) {
  return n % 192 == 0 ? 192 : (n % 128 == 0 ? 128 : 64);
}

// 128-byte rows at s: rows [0, valid) hold bf16 0.5, rows [valid, rows) 0
__device__ void fill_rows(unsigned char* s, int rows, int valid) {
  __nv_bfloat162 q = __float2bfloat162_rn(0.5f);
  const uint32_t w = *reinterpret_cast<uint32_t*>(&q);
  const uint4 half = make_uint4(w, w, w, w);
  const uint4 zero = make_uint4(0, 0, 0, 0);
  uint4* v = reinterpret_cast<uint4*>(s);
  for (int i = threadIdx.x; i < rows * 8; i += blockDim.x)
    v[i] = (i >> 3) < valid ? half : zero;
}

// named barrier of warpgroup wg's 128 threads (barrier 0 is __syncthreads)
__device__ __forceinline__ void wg_bar(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// pairwise sum of a[LO, LO + LEN), fixed order (see "Exactness")
template <int LO, int LEN, int S>
__device__ __forceinline__ float tree_sum(const float (&a)[S]) {
  if constexpr (LEN == 1)
    return a[LO];
  else
    return tree_sum<LO, LEN / 2>(a) + tree_sum<LO + LEN / 2, LEN - LEN / 2>(a);
}

// Accumulator fragment of m64nNk16 (f32): register 4 j + 2 h + e of a
// thread holds row 16 * warp + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e.
template <int N>
__global__ void __launch_bounds__(THREADS, 1)
    mxu_dot_kernel(int k, int n, int ps, int reps, long long items,
                   float* __restrict__ o) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const s = smem_raw + (base - raw);
  // A: DOT_ROWS rows of CHUNK_K (warpgroup w's 64 at 8 KB w), then B: N
  // rows of CHUNK_K, then the fold's scratch
  float* const red = reinterpret_cast<float*>(s + (DOT_ROWS + N) * 128);
  fill_rows(s, DOT_ROWS + N, DOT_ROWS + N);
  fence_proxy_async();
  __syncthreads();

  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid >> 7, wi = (tid >> 5) & 3;
  const int ctiles = n / N;
  const int ksteps = k / 16;
  // sub-tile j (K 16 j ..) of a K-major operand starts 32 j bytes into its
  // rows: 2 j in the descriptor's start address
  const uint64_t da = desc_sw128(base + wg * 64 * 128);
  const uint64_t db = desc_sw128(base + DOT_ROWS * 128);
  long long i = blockIdx.x * items / gridDim.x;
  const long long i1 = (blockIdx.x + 1) * items / gridDim.x;
  float acc[N / 2];
  while (i < i1) {
    // the output tile: row tile t / ctiles, column tile t % ctiles
    const long long t = i / reps;
    const long long end = min(i1, (t + 1) * reps);
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[e] = 0.0f;
    wgmma_fence();
    for (; i < end; ++i) {
      for (int j = 0; j + 4 <= ksteps; j += 4) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_m64k16<N, 0, 0>(acc, da + 2 * kk, db + 2 * kk);
      }
      if (ksteps & 2) {  // k = 32 (2 mod 4): sub-tiles 0 and 1
        wgmma_ss_m64k16<N, 0, 0>(acc, da, db);
        wgmma_ss_m64k16<N, 0, 0>(acc, da + 2, db + 2);
      }
      wgmma_commit();
      wgmma_wait<1>();
    }
    wgmma_wait<0>();

    // fold: the warpgroup's valid rows of each column, into o
    const int row = (int)(t / ctiles) * DOT_ROWS + wg * 64 + wi * 16 +
                    (lane >> 2);
    const bool v0 = row < ps, v1 = row + 8 < ps;
    float* const mine = red + (wg * 4 + wi) * N;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = (v0 ? acc[4 * j + e] : 0.0f) +
                  (v1 ? acc[4 * j + 2 + e] : 0.0f);
        x += __shfl_xor_sync(0xffffffffu, x, 4);
        x += __shfl_xor_sync(0xffffffffu, x, 8);
        x += __shfl_xor_sync(0xffffffffu, x, 16);
        if (lane < 4) mine[8 * j + 2 * lane + e] = x;
      }
    }
    wg_bar(wg);
    const float* const q = red + wg * 4 * N;
    float* const col = o + (t % ctiles) * N;
    for (int c = tid & 127; c < N; c += 128)
      atomicAdd(col + c, (q[c] + q[N + c]) + (q[2 * N + c] + q[3 * N + c]));
    wg_bar(wg);
  }
}

template <int N>
__global__ void __launch_bounds__(THREADS, 1)
    mxu_rdot_kernel(int m, int n, int ps, int reps, long long items,
                    float* __restrict__ o) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const s = smem_raw + (base - raw);
  // rows of the plane, 128 bytes each: A's chunk (CHUNK_K rows of 64 M),
  // B's chunk (N / 64 atoms of CHUNK_K rows of 64 N), A's tail (16 rows,
  // the first ps % 16 of them 0.5: the last k16 step of a plane whose rows
  // are not a multiple of 16), 16 rows of zeros, then the fold's scratch
  const int tail = ps & 15;
  fill_rows(s, CHUNK_K + N + 32, CHUNK_K + N + tail);
  float* const red = reinterpret_cast<float*>(s + (CHUNK_K + N + 32) * 128);
  fence_proxy_async();
  __syncthreads();

  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid >> 7, wi = (tid >> 5) & 3;
  const int chunks = (ps + RDOT_CHUNK - 1) / RDOT_CHUNK;
  const long long per_tile = (long long)chunks * reps;
  // sub-tile j (rows 16 j ..) of an MN-major operand starts 2048 j bytes
  // in: 128 j in the descriptor's start address
  const uint64_t da = desc_sw128(base);
  const uint64_t dt = desc_sw128(base + (CHUNK_K + N) * 128);
  const uint64_t dz = desc_sw128(base + (CHUNK_K + N + 16) * 128);
  const uint64_t db = desc_sw128_mn(base + CHUNK_K * 128, CHUNK_K * 128);
  long long i = blockIdx.x * items / gridDim.x;
  const long long i1 = (blockIdx.x + 1) * items / gridDim.x;
  float acc[N / 2];
  while (i < i1) {
    const long long t = i / per_tile;  // the output tile (all tiles are alike)
    const long long end = min(i1, (t + 1) * per_tile);
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[e] = 0.0f;
    wgmma_fence();
    for (; i < end; ++i) {
      const int c = (int)((i % per_tile) / reps);  // the chunk
      const int rows = min(RDOT_CHUNK, ps - c * RDOT_CHUNK);
      const int steps = (rows + 15) >> 4;
      const int half = (steps + 1) >> 1;
      const int gt = (rows & 15) ? steps - 1 : -1;  // the step on A's tail
      // both warpgroups issue `half` wgmmas, warpgroup w steps w * half ..,
      // so that the control flow is the same in both (a warpgroup-dependent
      // trip count makes ptxas serialize the wgmmas); the step past an odd
      // count reads the zero rows and adds nothing
      for (int j = 0; j < half; ++j) {
        const int g = wg * half + j;
        const uint64_t off = (uint64_t)((g & 3) * 128);
        const uint64_t a = g >= steps ? dz : (g == gt ? dt : da + off);
        wgmma_ss_m64k16<N, 1, 1>(acc, a, db + off);
      }
      wgmma_commit();
      wgmma_wait<1>();
    }
    wgmma_wait<0>();

    // fold: the warpgroup's whole tile, into o[0, 0]
    float x = tree_sum<0, N / 2>(acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_xor_sync(0xffffffffu, x, off);
    if (lane == 0) red[wg * 4 + wi] = x;
    wg_bar(wg);
    if ((tid & 127) == 0)
      atomicAdd(o, (red[wg * 4] + red[wg * 4 + 1]) +
                       (red[wg * 4 + 2] + red[wg * 4 + 3]));
    wg_bar(wg);
  }
}

// The launch plan of slab_build (kernels/layout.py build_plan)
struct BuildPlan {
  int blocks;  // B
  int warps;   // warps per block
  int segs;    // segments of a row
  int rows;    // rows of a block, at most
};

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// blocks 0 where a slab row does not fit in a block's shared memory
BuildPlan build_plan(int cs, int copies, int ps, int sms) {
  BuildPlan p{0, 0, 0, 0};
  if (cs <= 0 || cs % 8 || copies <= 0 || ps <= 0 || sms <= 0) return p;
  const long long fit = SMEM_MAX / (2LL * copies * cs);
  if (fit < 1) return p;
  p.segs = (int)ceil_div(cs / 8, BUILD_SEG);
  p.warps = BUILD_STRIPS * p.segs < BUILD_MAX_WARPS ? BUILD_STRIPS * p.segs
                                                    : BUILD_MAX_WARPS;
  long long b = ceil_div(ps, BUILD_STRIPS * BUILD_MIN_STRIP);
  if (b > sms) b = sms;
  const long long longest = ceil_div(ps, BUILD_STRIPS * 4 * BUILD_ROWS);
  if (b < longest) b = longest;
  if (b < ceil_div(ps, fit)) b = ceil_div(ps, fit);
  p.blocks = (int)b;
  p.rows = (int)ceil_div(ps, b);
  return p;
}

// bf16(f32(v) * 1.0001) of the two bf16 in w
__device__ __forceinline__ uint32_t norm2(uint32_t w) {
  const float lo = __uint_as_float(w << 16);
  const float hi = __uint_as_float(w & 0xffff0000u);
  const __nv_bfloat162 r =
      __floats2bfloat162_rn(__fmul_rn(lo, 1.0001f), __fmul_rn(hi, 1.0001f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ uint4 norm8(uint4 v) {
  return make_uint4(norm2(v.x), norm2(v.y), norm2(v.z), norm2(v.w));
}

// COPIES: the copies, known at compile time for the probe's 1, 3 and 9
// (their stores unrolled), 0 for any other count (a loop)
template <int COPIES>
__global__ void __launch_bounds__(32 * BUILD_MAX_WARPS)
    slab_build_kernel(int cs, int copies_rt, int ps, int reps, BuildPlan pl,
                      float* __restrict__ o,
                      __nv_bfloat16* __restrict__ slab_out) {
  const int copies = COPIES > 0 ? COPIES : copies_rt;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* sv = reinterpret_cast<uint4*>(smem);
  const int cv = cs / 8;        // 16-byte vectors of a row of the plane
  const int wv = copies * cv;   // 16-byte vectors of a slab row
  const int row0 = (int)((long long)blockIdx.x * ps / pl.blocks);
  const int rows = (int)((long long)(blockIdx.x + 1) * ps / pl.blocks) - row0;
  const int threads = 32 * pl.warps;

  {
    __nv_bfloat162 h = __float2bfloat162_rn(0.25f);
    uint32_t w = *reinterpret_cast<uint32_t*>(&h);
    const uint4 v = make_uint4(w, w, w, w);
    for (int i = threadIdx.x; i < rows * wv; i += threads) sv[i] = v;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q = lane / 8, i = lane % 8;
  float acc = 0.0f;
  bool owner = false;  // this lane holds row 0, vector 0 of the slab
  for (int u = warp; u < BUILD_STRIPS * pl.segs; u += pl.warps) {
    const int seg = u % pl.segs, strip = u / pl.segs;
    const int k = seg * BUILD_SEG + i;
    const int s0 = strip * rows / BUILD_STRIPS;
    const int s1 = (strip + 1) * rows / BUILD_STRIPS;
    // the lane's rows s0 + q + 4 e: which it loads, and which it stores
    // one row down (not the strip's last)
    bool ld[BUILD_ROWS], st[BUILD_ROWS];
    uint4* col = sv + (s0 + q) * wv + k;
#pragma unroll
    for (int e = 0; e < BUILD_ROWS; ++e) {
      const int r = s0 + q + 4 * e;
      ld[e] = k < cv && r < s1;
      st[e] = ld[e] && r + 1 < s1;
    }
    const bool mine = k == 0 && row0 + s0 + q == 0;
    for (int t = 0; t < reps; ++t) {
      uint4 v[BUILD_ROWS];
#pragma unroll
      for (int e = 0; e < BUILD_ROWS; ++e)
        v[e] = ld[e] ? col[4 * e * wv] : make_uint4(0u, 0u, 0u, 0u);
      // every lane's loads before any lane's stores
      __syncwarp();
#pragma unroll
      for (int e = 0; e < BUILD_ROWS; ++e) {
        const uint4 nv = norm8(v[e]);
        uint4* dst = col + (4 * e + 1) * wv;
        if constexpr (COPIES > 0) {
#pragma unroll
          for (int c = 0; c < COPIES; ++c)
            if (st[e]) dst[c * cv] = nv;
        } else {
          if (st[e])
            for (int c = 0; c < copies; ++c) dst[c * cv] = nv;
        }
        if (e == 0 && mine) acc = __fadd_rn(acc, __uint_as_float(nv.x << 16));
      }
      // every lane's stores before the next build's loads
      __syncwarp();
    }
    owner = owner || (mine && reps > 0);
  }

  if (owner) o[0] = acc;
  if (slab_out != nullptr) {
    __syncthreads();
    uint4* dst = reinterpret_cast<uint4*>(slab_out) + (long long)row0 * wv;
    for (int j = threadIdx.x; j < rows * wv; j += threads) dst[j] = sv[j];
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;
  return sms;
}

long long dot_items(int n, int ps, int reps) {
  return (long long)((ps + DOT_ROWS - 1) / DOT_ROWS) * (n / tile_n(n)) * reps;
}

long long rdot_items(int m, int n, int ps, int reps) {
  return (long long)(m / 64) * (n / tile_n(n)) *
         ((ps + RDOT_CHUNK - 1) / RDOT_CHUNK) * reps;
}

int plan_blocks(long long items, int sms) {
  const long long cap = (long long)sms * BLOCKS_PER_SM;
  return (int)(items < cap ? items : cap);
}

template <int N>
int launch_dot(int k, int n, int ps, int reps, long long items, int blocks,
               float* o, cudaStream_t stream) {
  const int smem = 1024 + (DOT_ROWS + N) * 128 + WG * 4 * N * 4;
  cudaError_t err = cudaFuncSetAttribute(
      mxu_dot_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  mxu_dot_kernel<N><<<blocks, THREADS, smem, stream>>>(k, n, ps, reps, items,
                                                       o);
  return (int)cudaGetLastError();
}

template <int N>
int launch_rdot(int m, int n, int ps, int reps, long long items, int blocks,
                float* o, cudaStream_t stream) {
  const int smem = 1024 + (CHUNK_K + N + 32) * 128 + WG * 4 * 4;
  cudaError_t err = cudaFuncSetAttribute(
      mxu_rdot_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  mxu_rdot_kernel<N><<<blocks, THREADS, smem, stream>>>(m, n, ps, reps,
                                                        items, o);
  return (int)cudaGetLastError();
}

template <int COPIES>
int launch_build(int cs, int copies, int ps, int reps, const BuildPlan& p,
                 float* o, void* slab_out, void* stream) {
  const int smem = p.rows * copies * cs * 2;
  const cudaError_t err = cudaFuncSetAttribute(
      slab_build_kernel<COPIES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  slab_build_kernel<COPIES><<<p.blocks, 32 * p.warps, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      cs, copies, ps, reps, p, o, static_cast<__nv_bfloat16*>(slab_out));
  return (int)cudaGetLastError();
}

}  // namespace

// The probe kernels' plan, mirrored by kernels/layout.py: what 0 blocks
// per SM, 1 plane rows of a mxu_dot item, 2 plane rows of a mxu_rdot
// chunk, 3 the wgmma N for n, 4 mxu_dot's items (a = k), 5 mxu_rdot's
// items (a = m), 6 mxu_dot's blocks and 7 mxu_rdot's blocks on `sms` SMs;
// slab_build's 8 BUILD_STRIPS, 9 BUILD_SEG, 10 BUILD_ROWS, 11
// BUILD_MIN_STRIP, and for (a = cs, n = copies, ps) on `sms` SMs 12
// blocks, 13 warps per block, 14 segments, 15 rows of a block at most;
// -1 for any other `what`.
extern "C" int mxu_probe_tile(int what, int a, int n, int ps, int reps,
                              int sms) {
  switch (what) {
    case 8: return BUILD_STRIPS;
    case 9: return BUILD_SEG;
    case 10: return BUILD_ROWS;
    case 11: return BUILD_MIN_STRIP;
    case 12: return build_plan(a, n, ps, sms).blocks;
    case 13: return build_plan(a, n, ps, sms).warps;
    case 14: return build_plan(a, n, ps, sms).segs;
    case 15: return build_plan(a, n, ps, sms).rows;
    case 0: return BLOCKS_PER_SM;
    case 1: return DOT_ROWS;
    case 2: return RDOT_CHUNK;
    case 3: return tile_n(n);
    case 4: return (int)dot_items(n, ps, reps);
    case 5: return (int)rdot_items(a, n, ps, reps);
    case 6: return plan_blocks(dot_items(n, ps, reps), sms);
    case 7: return plan_blocks(rdot_items(a, n, ps, reps), sms);
    default: return -1;
  }
}

// o: (8, n) f32, zeroed by the caller. k a multiple of 32, n of 64.
extern "C" int mxu_dot(int k, int n, int ps, int reps, float* o,
                       void* stream) {
  if (k <= 0 || k % 32 || n <= 0 || n % 64 || ps <= 0 || reps < 0)
    return (int)cudaErrorInvalidValue;
  const long long items = dot_items(n, ps, reps);
  const int blocks = plan_blocks(items, sm_count());
  if (blocks == 0) return (int)cudaSuccess;  // reps 0: o stays 0
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile_n(n)) {
    case 192: return launch_dot<192>(k, n, ps, reps, items, blocks, o, st);
    case 128: return launch_dot<128>(k, n, ps, reps, items, blocks, o, st);
    default: return launch_dot<64>(k, n, ps, reps, items, blocks, o, st);
  }
}

// o: (8, 128) f32, zeroed by the caller. m and n multiples of 64.
extern "C" int mxu_rdot(int m, int n, int ps, int reps, float* o,
                        void* stream) {
  if (m <= 0 || m % 64 || n <= 0 || n % 64 || ps <= 0 || reps < 0)
    return (int)cudaErrorInvalidValue;
  const long long items = rdot_items(m, n, ps, reps);
  const int blocks = plan_blocks(items, sm_count());
  if (blocks == 0) return (int)cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile_n(n)) {
    case 192: return launch_rdot<192>(m, n, ps, reps, items, blocks, o, st);
    case 128: return launch_rdot<128>(m, n, ps, reps, items, blocks, o, st);
    default: return launch_rdot<64>(m, n, ps, reps, items, blocks, o, st);
  }
}

// o: (1, 1) f32, zeroed by the caller. slab_out: (ps, copies * cs) bf16 or
// null (the timed launch).
extern "C" int slab_build(int cs, int copies, int ps, int reps, float* o,
                          void* slab_out, void* stream) {
  const BuildPlan p = build_plan(cs, copies, ps, sm_count());
  if (p.blocks == 0 || reps < 0) return (int)cudaErrorInvalidValue;
  switch (copies) {
    case 1: return launch_build<1>(cs, 1, ps, reps, p, o, slab_out, stream);
    case 3: return launch_build<3>(cs, 3, ps, reps, p, o, slab_out, stream);
    case 9: return launch_build<9>(cs, 9, ps, reps, p, o, slab_out, stream);
    default:
      return launch_build<0>(cs, copies, ps, reps, p, o, slab_out, stream);
  }
}
