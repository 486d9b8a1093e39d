// Deterministic sums of the kernels' partial sums.
//
// fold_cols: out[c] += sum over r < rows of in[r * cols + c], each column
// summed in a fixed order (no atomics), so the result is the same in every
// run. A kernel writes one row of partials per block (or per split) and the
// fold adds them up: in segments of rows first when there are too few
// columns to fill the card, then the segments' sums. The order depends only
// on rows and cols.
//
// The in-kernel fold of the one-wave kernels (group_norm.cu,
// max_pool_buf_bwd.cu): every block writes its partial and takes a ticket;
// the last blocks wait for all tickets (wait_tickets) and fold in parallel,
// each folded sum a pairwise tree (tree_rows) over strided segments.

#pragma once

#include <cuda_runtime.h>

namespace fold {

constexpr int TX = 32;  // columns per block
constexpr int TY = 8;   // row lanes per block
constexpr long long TARGET_BLOCKS = 132 * 4;
constexpr long long MIN_SEGMENT = 64;  // rows per segment, at least

// part[s * cols + c] = the sum of rows [s * seg, min(rows, (s + 1) * seg))
// of column c; with `accumulate`, out[c] += the sum of all rows (one
// segment, gridDim.y == 1).
__global__ void __launch_bounds__(TX * TY)
    fold_cols_kernel(const float* __restrict__ in, long long rows,
                     long long cols, long long seg, float* __restrict__ out,
                     int accumulate) {
  __shared__ float s[TY][TX + 1];
  const long long c = (long long)blockIdx.x * TX + threadIdx.x;
  const long long r0 = (long long)blockIdx.y * seg;
  const long long r1 = r0 + seg < rows ? r0 + seg : rows;
  float acc = 0.0f;
  if (c < cols)
    for (long long r = r0 + threadIdx.y; r < r1; r += TY)
      acc += in[r * cols + c];
  s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    float t = 0.0f;
#pragma unroll
    for (int i = 0; i < TY; ++i) t += s[i][threadIdx.x];
    if (accumulate)
      out[c] += t;
    else
      out[(long long)blockIdx.y * cols + c] = t;
  }
}

inline long long segments(long long rows, long long cols) {
  const long long colblocks = (cols + TX - 1) / TX;
  long long segs = (TARGET_BLOCKS + colblocks - 1) / colblocks;
  const long long most = (rows + MIN_SEGMENT - 1) / MIN_SEGMENT;
  if (segs > most) segs = most;
  return segs < 1 ? 1 : segs;
}

// f32 scratch that fold_cols needs beside `in` (0 for one segment)
inline long long scratch_floats(long long rows, long long cols) {
  const long long segs = segments(rows, cols);
  return segs > 1 ? segs * cols : 0;
}

// out (cols) += the column sums of in (rows x cols); scratch holds
// scratch_floats(rows, cols) floats.
inline cudaError_t fold_cols(const float* in, long long rows, long long cols,
                             float* scratch, float* out, cudaStream_t st) {
  const dim3 block(TX, TY);
  const unsigned colblocks = (unsigned)((cols + TX - 1) / TX);
  const long long segs = segments(rows, cols);
  if (segs == 1) {
    fold_cols_kernel<<<dim3(colblocks, 1), block, 0, st>>>(in, rows, cols,
                                                           rows, out, 1);
  } else {
    const long long seg = (rows + segs - 1) / segs;
    const long long used = (rows + seg - 1) / seg;
    fold_cols_kernel<<<dim3(colblocks, (unsigned)used), block, 0, st>>>(
        in, rows, cols, seg, scratch, 0);
    fold_cols_kernel<<<dim3(colblocks, 1), block, 0, st>>>(
        scratch, used, cols, used, out, 1);
  }
  return cudaGetLastError();
}

// A wait that cannot end traps (a launch error) instead of hanging the
// card: far more polls than any launch needs.
constexpr unsigned MAX_POLLS = 1u << 26;

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Thread 0 of a folding block returns once all `total` blocks have taken
// their tickets of `counter`.
__device__ __forceinline__ void wait_tickets(const int* counter, int total) {
  if (threadIdx.x == 0)
    for (unsigned i = 0; ld_acquire(counter) < total; ++i)
      if (i == MAX_POLLS) __trap();
}

// Pairwise tree over `count` rows of `width` floats at `buf` (row k at
// buf + k * width): row 0 ends up with ((r0 + r1) + (r2 + r3)) + ...; the
// calling thread adds COLS columns from col0 + p * stride of row k, for
// each of PARTS parts p. Every thread of the block calls it (it
// synchronises).
template <int COLS, int PARTS>
__device__ __forceinline__ void tree_rows(float* buf, int width, int count,
                                          int k, int col0, int stride,
                                          bool mine) {
  for (int st = 1; st < count; st *= 2) {
    if (mine && k % (2 * st) == 0 && k + st < count) {
      float* to = buf + k * width + col0;
      const float* from = buf + (k + st) * width + col0;
      float a[PARTS][COLS], b[PARTS][COLS];
#pragma unroll
      for (int p = 0; p < PARTS; ++p)
#pragma unroll
        for (int i = 0; i < COLS; ++i) {
          a[p][i] = to[p * stride + i];
          b[p][i] = from[p * stride + i];
        }
#pragma unroll
      for (int p = 0; p < PARTS; ++p)
#pragma unroll
        for (int i = 0; i < COLS; ++i)
          to[p * stride + i] = __fadd_rn(a[p][i], b[p][i]);
    }
    __syncthreads();
  }
}

}  // namespace fold
