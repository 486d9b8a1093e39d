// The launch plan of kernels A (conv3x3x3_fwd.cu) and C (conv3x3x3_dx.cu):
// implicit GEMMs on wgmma whose rows (M) are flat positions of a padded
// (X+2, Y+2, Z+2) buffer. A block owns a range of rows and an N tile, and
// for each 64-channel K chunk and each dx stages once in shared memory the
// run of input rows that the taps read: the block's rows plus Zp + 1 on
// each side, so that one run serves the nine (dy, dz), or plus one on each
// side where two such runs do not fit (very deep Z), so that one run
// serves the three dz of one dy. Two runs are in flight, beside a ring of
// weight tiles. kernels/layout.py mirrors every function here.

#pragma once

#include <stdint.h>

namespace hopper {

constexpr int BKC = 64;              // K channels per chunk: one 128-byte row
constexpr int THREADS = 256;         // two consumer warpgroups
constexpr int STAGES = 5;            // weight-tile ring
constexpr int LEAD = STAGES - 2;     // taps loaded ahead of the math
constexpr int SMEM_LIMIT = 232448;   // a block's dynamic shared memory
constexpr int MIN_BLOCKS = 132 * 2;  // blocks a launch keeps, if it can

// N tile for `cout` output channels (the wgmma width): 32, 64 or 128
__host__ __device__ constexpr int tile_n(int cout) {
  return cout <= 32 ? 32 : (cout <= 64 ? 64 : 128);
}

__host__ __device__ constexpr uint32_t align1024(uint32_t n) {
  return (n + 1023u) & ~1023u;
}

// rows of one staged run for a bm-row block that serves `dyg` values of
// dy (3 or 1) in a Zp-deep buffer
__host__ __device__ constexpr int run_rows(int bm, int zp, int dyg) {
  return bm + (dyg - 1) * zp + 2;
}

// bytes of one staged run
__host__ __device__ constexpr uint32_t run_bytes(int bm, int zp, int dyg) {
  return align1024((uint32_t)run_rows(bm, zp, dyg) * 128u);
}

// dynamic shared memory of a launch: two runs and the weight ring
__host__ __device__ constexpr uint32_t smem_bytes(int bm, int nt, int zp,
                                                  int dyg) {
  return 1024u + 2u * run_bytes(bm, zp, dyg) + (uint32_t)STAGES * nt * 128u;
}

// dy values per staged run: all 3 where two such runs fit beside the
// ring, else 1 (very deep Z)
__host__ __device__ constexpr int dy_group(int bm, int nt, int zp) {
  return smem_bytes(bm, nt, zp, 3) <= (uint32_t)SMEM_LIMIT ? 3 : 1;
}

// Rows per block: 128 per wgmma M half of 64 that each warpgroup runs, as
// many as still give MIN_BLOCKS blocks and a run that serves all three
// dy: 512 (four halves, N tiles up to 64 only: their accumulators fit),
// 256, else 128.
__host__ __device__ constexpr bool rows_fit(long long rows, int ntiles,
                                            int nt, int zp, int bm) {
  return (bm < 512 || nt <= 64) &&
         (rows + bm - 1) / bm * ntiles >= MIN_BLOCKS &&
         smem_bytes(bm, nt, zp, 3) <= (uint32_t)SMEM_LIMIT;
}

__host__ __device__ constexpr int rows_per_block(long long rows, int ntiles,
                                                 int nt, int zp) {
  return rows_fit(rows, ntiles, nt, zp, 512)   ? 512
         : rows_fit(rows, ntiles, nt, zp, 256) ? 256
                                               : 128;
}

}  // namespace hopper
