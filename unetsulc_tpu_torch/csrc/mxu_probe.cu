// Matrix-unit probe for Hopper (sm_90a): how far the bf16 wmma path of
// kernel A (and of kernels C and D before their wgmma designs) gets at the
// flagship's conv shapes, apart from their loads and pipeline; and the
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
// step fills the VMEM scratch. Here the reps are a loop inside each block,
// after the block has filled its own shared-memory operands, and blocks
// split the rows of the plane.
//
// What bounds it on this card. mxu_dot and mxu_rdot: operations, 2 * ps *
// k * n (or m * n) FLOP per rep at the bf16 tensor-core rate; they move
// no operand bytes. slab_build: shared-memory bandwidth, per rep ps * cs
// * 2 bytes read and copies * ps * cs * 2 bytes written, at 128 bytes a
// clock on each SM.
//
// Design. The dot kernels run kernel A's instruction path and nothing
// else: a 64 x 64 block tile, four warps of 32 x 32, nvcuda::wmma 16x16x16
// bf16 fragments loaded from shared memory, f32 accumulators, one
// __syncthreads per 32-deep K step (where kernel A restages its tiles).
// The TPU probe holds its operands whole in VMEM (up to 25 MB of `a`); a
// Hopper block has 227 KB. Since every element of an operand is the same
// constant, a block holds one 32-deep chunk of `a` and one of `b` and
// walks K by re-reading them: the products and sums are those of the
// full operands, and the timed loop loads nothing from device memory. The
// accumulators carry over the reps, so every rep feeds o and the rep loop
// cannot be folded; the rows are summed once, after the last rep, and
// each block adds its sums into o with f32 atomicAdd. mxu_dot's grid is
// (row blocks of the plane, column blocks of n); mxu_rdot's is (64 x 64
// tiles of the (m, n) output, splits of the ps rows), since its output is
// small and its contraction long. A wgmma mode is later work.
//
// slab_build keeps its block's rows of the slab in shared memory (rows
// per block chosen so that one wave of blocks covers the plane). Each rep
// converts its rows' first cs columns into registers, waits, stores them
// shifted by one row into each of the `copies` column blocks, and waits.
// A block shifts rows only within its own rows, so its first row is never
// written. That gives the TPU kernel's exact result: the slab is a fixed
// point, since bf16(0.25 * 1.0001) = 0.25 (the bf16 spacing at 0.25 is
// 2^-9), so the row a block's first row would receive from the block
// above holds the value it already has.
//
// Exactness. Every product is exact (0.5 * 0.5 in bf16, summed in f32),
// and a sum stays exact while each term added to it is a multiple of the
// f32 spacing at its running total. At the probe's shapes (ps 10976, reps
// 200, k and n and m multiples of 64) every per-element, per-block and
// cross-block sum of both dot kernels meets that, whatever the order of
// the atomics, so the kernels agree with their plain versions exactly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int BM = 64;  // rows of the output tile
constexpr int BN = 64;  // columns of the output tile
constexpr int BK = 32;  // contraction depth per step
constexpr int THREADS = 128;
constexpr int LDA_ROW = BK + 8;  // mxu_dot: a chunk (BM x BK), row-major
constexpr int LDA_COL = BM + 8;  // mxu_rdot: a chunk (BK x BM), read as a^T
constexpr int LDB = BN + 8;      // b chunk (BK x BN)
constexpr int LDC = BN + 4;      // f32 tile for the epilogue
constexpr int TARGET_BLOCKS = 132 * 4;

constexpr int BUILD_THREADS = 256;
constexpr int BUILD_VECS = 8;  // 16-byte vectors of norm per thread, at most

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// s[r * ld + c] = (r < valid_rows ? v : 0) for r < rows, c < cols
__device__ void fill(__nv_bfloat16* s, int rows, int cols, int ld,
                     int valid_rows, float v) {
  const __nv_bfloat16 val = __float2bfloat16(v);
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols, c = i % cols;
    s[r * ld + c] = r < valid_rows ? val : zero;
  }
}

// One 32-deep K step of the warp's 32 x 32 tile: A row-major (mxu_dot) or
// A^T read col-major from a (BK x BM) chunk (mxu_rdot).
template <bool TRANSPOSED_A>
__device__ __forceinline__ void k_step(const __nv_bfloat16* sA,
                                       const __nv_bfloat16* sB, int wm,
                                       int wn, Acc (&acc)[2][2]) {
  using LayoutA =
      typename std::conditional<TRANSPOSED_A, wmma::col_major,
                                wmma::row_major>::type;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LayoutA> fa[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major>
        fb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if constexpr (TRANSPOSED_A)
        wmma::load_matrix_sync(fa[i], sA + kk * LDA_COL + wm + i * 16,
                               LDA_COL);
      else
        wmma::load_matrix_sync(fa[i], sA + (wm + i * 16) * LDA_ROW + kk,
                               LDA_ROW);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::load_matrix_sync(fb[j], sB + kk * LDB + wn + j * 16, LDB);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
  }
}

__device__ __forceinline__ void store_tile(float* sC, int wm, int wn,
                                           Acc (&acc)[2][2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sC + (wm + i * 16) * LDC + wn + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
}

__global__ void __launch_bounds__(THREADS)
    mxu_dot_kernel(int k, int n, int ps, int reps, float* __restrict__ o) {
  __shared__ __align__(32) __nv_bfloat16 sA[BM * LDA_ROW];
  __shared__ __align__(32) __nv_bfloat16 sB[BK * LDB];
  __shared__ __align__(32) float sC[BM * LDC];
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int rows = min(BM, ps - row0);
  // rows past the plane's end are 0 in this block's chunk of a
  fill(sA, BM, BK, LDA_ROW, rows, 0.5f);
  fill(sB, BK, BN, LDB, BK, 0.5f);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;
  Acc acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int steps = k / BK;
  for (int r = 0; r < reps; ++r) {
    for (int s = 0; s < steps; ++s) {
      k_step<false>(sA, sB, wm, wn, acc);
      __syncthreads();
    }
  }

  store_tile(sC, wm, wn, acc);
  __syncthreads();
  for (int c = threadIdx.x; c < BN; c += THREADS) {
    float sum = 0.0f;
    for (int i = 0; i < rows; ++i) sum += sC[i * LDC + c];
    atomicAdd(o + col0 + c, sum);
  }
}

__global__ void __launch_bounds__(THREADS)
    mxu_rdot_kernel(int m, int n, int ps, int reps, int chunk,
                    float* __restrict__ o) {
  __shared__ __align__(32) __nv_bfloat16 sA[BK * LDA_COL];
  __shared__ __align__(32) __nv_bfloat16 sAtail[BK * LDA_COL];
  __shared__ __align__(32) __nv_bfloat16 sB[BK * LDB];
  __shared__ __align__(32) float sC[BM * LDC];
  __shared__ float warp_sums[THREADS / 32];
  const long long r0 = (long long)blockIdx.y * chunk;
  const int rows = (int)min((long long)chunk, (long long)ps - r0);
  const int full = rows / BK;
  const int tail = rows % BK;
  fill(sA, BK, BM, LDA_COL, BK, 0.5f);
  // the last step of a chunk that is not a multiple of BK: rows (voxels)
  // past the chunk's end are 0
  fill(sAtail, BK, BM, LDA_COL, tail, 0.5f);
  fill(sB, BK, BN, LDB, BK, 0.5f);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;
  Acc acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int r = 0; r < reps; ++r) {
    for (int s = 0; s < full; ++s) {
      k_step<true>(sA, sB, wm, wn, acc);
      __syncthreads();
    }
    if (tail) {
      k_step<true>(sAtail, sB, wm, wn, acc);
      __syncthreads();
    }
  }

  store_tile(sC, wm, wn, acc);
  __syncthreads();
  float sum = 0.0f;
  for (int i = threadIdx.x; i < BM * BN; i += THREADS)
    sum += sC[(i / BN) * LDC + i % BN];
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_down_sync(0xffffffffu, sum, off);
  if ((threadIdx.x & 31) == 0) warp_sums[warp] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int w = 0; w < THREADS / 32; ++w) total += warp_sums[w];
    atomicAdd(o, total);
  }
}

__global__ void __launch_bounds__(BUILD_THREADS)
    slab_build_kernel(int cs, int copies, int ps, int reps, int rows_per,
                      float* __restrict__ o,
                      __nv_bfloat16* __restrict__ slab_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s = reinterpret_cast<__nv_bfloat16*>(smem);
  const int W = copies * cs;  // slab width
  const int wv = W / 8;       // 16-byte vectors per slab row
  const int cv = cs / 8;      // 16-byte vectors per row of the plane
  const int row0 = blockIdx.x * rows_per;
  const int rows = min(rows_per, ps - row0);
  const int items = rows * cv;
  uint4* sv = reinterpret_cast<uint4*>(s);

  {
    __nv_bfloat162 q = __float2bfloat162_rn(0.25f);
    uint32_t w = *reinterpret_cast<uint32_t*>(&q);
    const uint4 v = make_uint4(w, w, w, w);
    for (int i = threadIdx.x; i < rows * wv; i += BUILD_THREADS) sv[i] = v;
  }
  __syncthreads();

  float acc = 0.0f;
  const bool first = blockIdx.x == 0 && threadIdx.x == 0;
  for (int r = 0; r < reps; ++r) {
    uint4 norm[BUILD_VECS];
#pragma unroll
    for (int j = 0; j < BUILD_VECS; ++j) {
      const int i = threadIdx.x + j * BUILD_THREADS;
      if (i < items) {
        const uint4 raw = sv[(i / cv) * wv + i % cv];
        const __nv_bfloat16* in = reinterpret_cast<const __nv_bfloat16*>(&raw);
        __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(&norm[j]);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          out[e] = __float2bfloat16(__fmul_rn(__bfloat162float(in[e]),
                                              1.0001f));
      }
    }
    if (first) acc += __bfloat162float(
        reinterpret_cast<const __nv_bfloat16*>(&norm[0])[0]);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < BUILD_VECS; ++j) {
      const int i = threadIdx.x + j * BUILD_THREADS;
      const int row = i / cv;
      if (i < items && row + 1 < rows) {
        uint4* dst = sv + (row + 1) * wv + i % cv;
        for (int c = 0; c < copies; ++c) dst[c * cv] = norm[j];
      }
    }
    __syncthreads();
  }

  if (first) o[0] = acc;
  if (slab_out != nullptr) {
    uint4* dst = reinterpret_cast<uint4*>(slab_out) + (long long)row0 * wv;
    for (int i = threadIdx.x; i < rows * wv; i += BUILD_THREADS)
      dst[i] = sv[i];
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

}  // namespace

// o: (8, n) f32, zeroed by the caller. k a multiple of 32, n of 64.
extern "C" int mxu_dot(int k, int n, int ps, int reps, float* o,
                       void* stream) {
  if (k <= 0 || k % BK || n <= 0 || n % BN || ps <= 0 || reps < 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((ps + BM - 1) / BM, n / BN);
  mxu_dot_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      k, n, ps, reps, o);
  return (int)cudaGetLastError();
}

// o: (8, 128) f32, zeroed by the caller. m and n multiples of 64.
extern "C" int mxu_rdot(int m, int n, int ps, int reps, float* o,
                        void* stream) {
  if (m <= 0 || m % BM || n <= 0 || n % BN || ps <= 0 || reps < 0)
    return (int)cudaErrorInvalidValue;
  const int tiles = (m / BM) * (n / BN);
  const int steps = (ps + BK - 1) / BK;
  int splits = (TARGET_BLOCKS + tiles - 1) / tiles;
  splits = splits < 1 ? 1 : (splits > steps ? steps : splits);
  const int chunk = ((steps + splits - 1) / splits) * BK;
  splits = (ps + chunk - 1) / chunk;
  // blockIdx.x walks the tiles of the output, which all hold the same
  // values, so the kernel reads only blockIdx.y (its rows)
  const dim3 grid(tiles, splits);
  mxu_rdot_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      m, n, ps, reps, chunk, o);
  return (int)cudaGetLastError();
}

// Rows of the slab each block of slab_build holds, or 0 if a row does not
// fit in shared memory or cs is not a multiple of 8.
extern "C" int slab_build_rows(int cs, int copies, int ps) {
  if (cs <= 0 || cs % 8 || copies <= 0 || ps <= 0) return 0;
  const long long row_bytes = (long long)copies * cs * 2;
  const long long smem_max = 232448;
  int rows = (ps + sm_count() - 1) / sm_count();
  const long long fit = smem_max / row_bytes;
  const int per_thread = BUILD_VECS * BUILD_THREADS / (cs / 8);
  if (rows > fit) rows = (int)fit;
  if (rows > per_thread) rows = per_thread;
  return rows < 1 ? 0 : rows;
}

// o: (1, 1) f32, zeroed by the caller. slab_out: (ps, copies * cs) bf16 or
// null (the timed launch).
extern "C" int slab_build(int cs, int copies, int ps, int reps, float* o,
                          void* slab_out, void* stream) {
  const int rows_per = slab_build_rows(cs, copies, ps);
  if (rows_per == 0 || reps < 0) return (int)cudaErrorInvalidValue;
  const int smem = rows_per * copies * cs * 2;
  cudaError_t err = cudaFuncSetAttribute(
      slab_build_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (ps + rows_per - 1) / rows_per;
  slab_build_kernel<<<blocks, BUILD_THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      cs, copies, ps, reps, rows_per, o,
      static_cast<__nv_bfloat16*>(slab_out));
  return (int)cudaGetLastError();
}
