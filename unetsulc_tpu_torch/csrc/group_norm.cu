// GroupNorm forward and backward on a contiguous channels-last (N, S, C)
// slab, bf16 or f32, with f32 statistics: four kernels.
//
// Replaces: unetsulc_tpu/ops/groupnorm_pallas.py `_gn_kernel` (one sample's
// whole (S, C) slab in VMEM) and the chunked kernels of
// unetsulc_tpu/ops/attic/groupnorm_pallas_chunked.py: `_stats_kernel`,
// `_normalize_kernel`, `_bwd_reduce_kernel` (gn_bwd_reduce) and
// `_bwd_dx_kernel` (gn_bwd_dx).
//
//   gn_stats       (N, S, C) -> mean_g, inv_g (N, G) f32, with
//                  mean = sum x / D, var = sum x^2 / D - mean^2,
//                  inv = rsqrt(var + eps), D = S * C / G;
//   gn_apply       out = (x - mean_c) * (inv_c * scale) + bias, x's dtype;
//   gn_bwd_reduce  dscale = sum_n,s g * xhat, dbias = sum_n,s g (C,), and
//                  per (n, group) sdx = sum dxhat, sdxx = sum dxhat * xhat
//                  with xhat = (x - mean_c) * inv_c, dxhat = g * scale;
//   gn_bwd_dx      dx = inv/D * (D * dxhat - sdx - xhat * sdxx), x's dtype.
//
// What bounds them on this card: bytes. Stats read x once; apply reads x
// and writes out; the backward reduce reads x and g; dx reads x and g and
// writes dx. A few operations per byte; at 96^3 x 64 bf16 one pass over x
// is 113 MB, ~34 us at 3.35 TB/s. Elementwise arithmetic uses the _rn
// intrinsics in the order of the JAX formulas, so no multiply-add is
// contracted. Group sums of the backward are taken as scale_c * sum(g) and
// scale_c * sum(g * xhat) per channel, the same sums as sum(dxhat) and
// sum(dxhat * xhat) in another rounding order.
//
// gn_stats and gn_apply. The TPU grid runs in order, so its chunked
// kernels carry the channel sums in scratch from one chunk to the next.
// Here the blocks of one sample run in parallel: each block sums its own
// voxel range per channel (one thread owns a 16-byte vector of channels
// and walks rows; a fixed-order shared memory reduction combines the rows)
// and writes its partial sums to an f32 workspace (N, B, 2, C); the last
// block of a sample to finish (an atomic ticket) folds the B partials in
// a fixed order. gn_apply is a grid-stride loop over 16-byte vectors.
//
// gn_bwd_reduce and gn_bwd_dx. Bytes bound both (reduce: x and g read
// once; dx: x and g read, dx written), so the design keeps many bytes in
// flight on every SM, folds the partial sums in parallel, and leaves
// little work per byte. Both follow a one-wave plan, mirrored by
// kernels/layout.py (gn_bwd_tile, checked when the library is
// loaded): a launch has N * Bs blocks, Bs = min(S, max(1, SMs * k / N))
// with k = 1 (reduce) or 2 (dx), so every block is resident at once;
// block j of sample n owns rows [j S / Bs, (j + 1) S / Bs), so blocks
// differ by at most one row and a block's rows of x, and of g, are each
// one contiguous byte range. Rows alone fill the card down to N * S >=
// SMs rows, far below any GroupNorm of the model (13^3 = 2197 rows), so
// channels are not split. Each thread owns one 16-byte channel vector and
// one of R = 256 / (vectors per row) row lanes, fixed for the launch.
//
// gn_bwd_reduce. (1) A producer warp streams the block's rows of x and of
// g through a ring of 4 stages in shared memory, each stage two 1-D TMA
// bulk copies (cp.async.bulk ... mbarrier::complete_tx::bytes, no tensor
// map) of up to 8 KB, completing on one mbarrier per stage; eight
// consumer warps wait on it, accumulate g * xhat and g per channel in f32
// in row order (lane r takes rows r, r + R, ...), and release the stage on
// a second mbarrier. Rows that are not whole 16-byte vectors (C % V, or
// an unaligned pointer) are read straight from device memory in the same
// order. (2) A pairwise tree over the row lanes gives the block's partial
// (2, C). (3) Every block takes a ticket; the last F = min(2 G, max(1,
// min(B, SMs) / 2)) blocks wait until all B have taken theirs, then fold
// in parallel, block f the units f, f + F, ... (unit u: the sums of g *
// xhat, u even, or of g, u odd, of group u / 2): each of the unit's C / G
// columns summed over the sample's Bs partials by T = 256 / columns
// threads in strides, then a pairwise tree over the T; per sample the
// group sum (sdxx or sdx) in channel order; dscale or dbias over the
// samples in order. No block walks the partials alone, and the order
// depends only on the shapes: two launches give the same bits. Waiting is
// safe: at most half the resident blocks wait, and every other block
// finishes without waiting. A wait that cannot end traps.
//
// gn_bwd_dx. Each thread computes its channel vector's mean, inv, scale,
// sdx, sdxx and inv / D once, in registers (inv / D hoisted out of the
// loop gives the bits of the division per element), then walks its rows
// four at a time: eight 16-byte loads in flight (the first four rows'
// issued before those values are fetched), kept packed until their turn,
// pointer increments and no division in the loop, 16-byte stores;
// the arithmetic is in the JAX order, with nothing reassociated.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SMS = 132;  // H100 SXM

// gn_bwd_reduce and gn_bwd_dx (mirrored by kernels/layout.py): threads
// that own channel vectors (a reduce block adds one producer warp), the
// reduce's ring stages, row sweeps per stage and blocks per SM, dx's
// blocks per SM and rows per thread per iteration
constexpr int BWD_THREADS = 256;
constexpr int REDUCE_STAGES = 4;
constexpr int REDUCE_SWEEPS = 2;
constexpr int REDUCE_BLOCKS_PER_SM = 1;
constexpr int DX_BLOCKS_PER_SM = 2;
constexpr int DX_UNROLL = 4;
constexpr int STAGE_BYTES = REDUCE_SWEEPS * BWD_THREADS * 16;  // per tensor
constexpr int REDUCE_SMEM = 128 + REDUCE_STAGES * 2 * STAGE_BYTES;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// V channels of one row: a 16-byte vector when `vec`, else nc scalars
// (zeros past nc).
template <typename T>
__device__ __forceinline__ void load_vec(const T* src, int nc, bool vec,
                                         float* out) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    __align__(16) T v[V];
    *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(src);
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = to_f(v[j]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = j < nc ? to_f(src[j]) : 0.0f;
  }
}

template <typename T>
__device__ __forceinline__ void store_vec(T* dst, int nc, bool vec,
                                          const float* in) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    __align__(16) T v[V];
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = from_f<T>(in[j]);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
  } else {
    for (int j = 0; j < nc; ++j) dst[j] = from_f<T>(in[j]);
  }
}

struct Slab {
  int n;        // samples
  long long s;  // voxels per sample
  int c;        // channels
  int groups;   // G
  bool vec;     // 16-byte vectors (c % V == 0 and aligned pointers)
};

// Sums x and x^2 per channel over rows [s0, s1) of sample n, combines the
// block's rows in a fixed order in shared memory `red` (2 * THREADS * V
// floats) and writes them to partial[n][b] (2, c).
template <typename T>
__device__ void block_partials(const T* __restrict__ x, const Slab& sl,
                               int n, int b, int nblocks, float* red,
                               float* __restrict__ partial) {
  constexpr int V = 16 / sizeof(T);
  const int cvs = (sl.c + V - 1) / V;  // channel vectors per row
  const int rows = THREADS / cvs;      // rows walked together
  const int cpad = cvs * V;
  const int tid = threadIdx.x;
  const int cv = tid % cvs, r = tid / cvs;
  const int c0 = cv * V, nc = sl.c - c0 < V ? sl.c - c0 : V;
  const long long chunk = (sl.s + nblocks - 1) / nblocks;
  const long long s0 = (long long)b * chunk;
  const long long s1 = s0 + chunk < sl.s ? s0 + chunk : sl.s;

  float acc0[V], acc1[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    acc0[j] = 0.0f;
    acc1[j] = 0.0f;
  }
  if (r < rows) {
    const long long base = (long long)n * sl.s;
    for (long long s = s0 + r; s < s1; s += rows) {
      float xv[V];
      load_vec(x + (base + s) * sl.c + c0, nc, sl.vec, xv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        acc0[j] = __fadd_rn(acc0[j], xv[j]);
        acc1[j] = __fadd_rn(acc1[j], __fmul_rn(xv[j], xv[j]));
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      red[r * cpad + c0 + j] = acc0[j];
      red[rows * cpad + r * cpad + c0 + j] = acc1[j];
    }
  }
  __syncthreads();
  float* out = partial + ((long long)n * nblocks + b) * 2 * sl.c;
  for (int c = tid; c < sl.c; c += THREADS) {
    float t0 = 0.0f, t1 = 0.0f;
    for (int i = 0; i < rows; ++i) {
      t0 += red[i * cpad + c];
      t1 += red[rows * cpad + i * cpad + c];
    }
    out[c] = t0;
    out[sl.c + c] = t1;
  }
}

// True in every thread of the block that takes the last ticket of
// counter: all other blocks' writes before their tickets are visible.
__device__ bool last_block(int* counter, int expected) {
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(counter, 1) == expected - 1;
  __syncthreads();
  if (s_last) __threadfence();
  return s_last;
}

// The last block of sample n: folds partial[n][0..B) (2, c) into
// red[0..2c) (row 0 = first quantity, row 1 = second), in a fixed order:
// P = THREADS / c pieces of consecutive blocks each summed in block
// order, then the pieces in order. `red` holds 2 * max(THREADS, c)
// floats.
__device__ void fold_partials(const float* partial, int n, int nblocks,
                              int c, float* red) {
  const int tid = threadIdx.x;
  const int pieces = c < THREADS ? THREADS / c : 1;
  const int per = (nblocks + pieces - 1) / pieces;
  const float* p = partial + (long long)n * nblocks * 2 * c;
  for (int i = tid; i < pieces * c; i += THREADS) {
    const int ch = i % c, piece = i / c;
    const int b0 = piece * per, b1 = b0 + per < nblocks ? b0 + per : nblocks;
    float t0 = 0.0f, t1 = 0.0f;
    for (int b = b0; b < b1; ++b) {
      t0 += __ldcg(p + (long long)b * 2 * c + ch);
      t1 += __ldcg(p + (long long)b * 2 * c + c + ch);
    }
    red[piece * c + ch] = t0;
    red[pieces * c + piece * c + ch] = t1;
  }
  __syncthreads();
  for (int ch = tid; ch < c; ch += THREADS) {
    float t0 = 0.0f, t1 = 0.0f;
    for (int piece = 0; piece < pieces; ++piece) {
      t0 += red[piece * c + ch];
      t1 += red[pieces * c + piece * c + ch];
    }
    // red[ch] and red[c + ch] hold values of column ch, which this thread
    // alone reads, and has read: it may overwrite them
    red[ch] = t0;
    red[c + ch] = t1;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    gn_stats_kernel(const T* __restrict__ x, Slab sl, float eps, float denom,
                    int nblocks, float* __restrict__ partial,
                    int* __restrict__ counters, float* __restrict__ mean,
                    float* __restrict__ inv) {
  extern __shared__ float red[];
  const int n = blockIdx.y, b = blockIdx.x;
  block_partials<T>(x, sl, n, b, nblocks, red, partial);
  if (!last_block(counters + n, nblocks)) return;
  fold_partials(partial, n, nblocks, sl.c, red);
  const int cg = sl.c / sl.groups;
  for (int g = threadIdx.x; g < sl.groups; g += THREADS) {
    float s = 0.0f, q = 0.0f;
    for (int ch = g * cg; ch < (g + 1) * cg; ++ch) {
      s += red[ch];
      q += red[sl.c + ch];
    }
    const float mu = __fdiv_rn(s, denom);
    const float var = __fsub_rn(__fdiv_rn(q, denom), __fmul_rn(mu, mu));
    mean[n * sl.groups + g] = mu;
    inv[n * sl.groups + g] = rsqrtf(__fadd_rn(var, eps));
  }
}

// One thread per 16-byte channel vector of one row, grid-stride.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                    const float* __restrict__ inv,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, Slab sl,
                    T* __restrict__ out) {
  constexpr int V = 16 / sizeof(T);
  const int cvs = (sl.c + V - 1) / V;
  const int cg = sl.c / sl.groups;
  const long long total = (long long)sl.n * sl.s * cvs;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (long long)gridDim.x * THREADS) {
    const int cv = (int)(i % cvs);
    const long long row = i / cvs;
    const int n = (int)(row / sl.s);
    const int c0 = cv * V, nc = sl.c - c0 < V ? sl.c - c0 : V;
    const long long off = row * sl.c + c0;
    float v[V];
    load_vec(x + off, nc, sl.vec, v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (j < nc) {
        const int c = c0 + j, g = n * sl.groups + c / cg;
        const float a = __fmul_rn(inv[g], scale[c]);
        v[j] = __fadd_rn(__fmul_rn(__fsub_rn(v[j], mean[g]), a), bias[c]);
      }
    }
    store_vec(out + off, nc, sl.vec, v);
  }
}

// ---------------------------------------------------------------------------
// gn_bwd_reduce and gn_bwd_dx
// ---------------------------------------------------------------------------

// The launch plan of gn_bwd_reduce (kernels/layout.py gn_reduce_plan)
struct BwdPlan {
  int bs;       // blocks per sample
  int lanes;    // row lanes R: rows walked together
  int chunk;    // rows per ring stage (REDUCE_SWEEPS * R)
  int folders;  // blocks that fold, F
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// A wait that cannot end traps (a launch error) instead of hanging the
// card: far more polls than any launch needs.
constexpr unsigned MAX_POLLS = 1u << 26;

// returns once the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (unsigned i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.b32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (i == MAX_POLLS) __trap();
  }
}

// 1-D TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// One row of the reduce: a0 += g * xhat, a1 += g per channel.
template <int V>
__device__ __forceinline__ void reduce_row(const float* xv, const float* gv,
                                           const float* m, const float* iv,
                                           float* a0, float* a1) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float xh = __fmul_rn(__fsub_rn(xv[j], m[j]), iv[j]);
    a0[j] = __fadd_rn(a0[j], __fmul_rn(gv[j], xh));
    a1[j] = __fadd_rn(a1[j], gv[j]);
  }
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

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS + 32, 1)
    gn_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ gr,
                         const float* __restrict__ mean,
                         const float* __restrict__ inv,
                         const float* __restrict__ scale, Slab sl, BwdPlan pl,
                         float* __restrict__ partial, int* __restrict__ counter,
                         float* __restrict__ dscale,
                         float* __restrict__ dbias, float* __restrict__ sdx,
                         float* __restrict__ sdxx) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + REDUCE_STAGES;
  int* ticket = reinterpret_cast<int*>(empty + REDUCE_STAGES);
  unsigned char* ring = smem + 128;
  // once the ring is drained: the row lanes' sums, then the fold's
  float* red = reinterpret_cast<float*>(ring);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n = blockIdx.x / pl.bs, j = blockIdx.x % pl.bs;
  const long long r0 = (long long)j * sl.s / pl.bs;
  const long long rows = (long long)(j + 1) * sl.s / pl.bs - r0;
  const int cvs = (sl.c + V - 1) / V, cpad = cvs * V;
  const int cv = tid % cvs, r = tid / cvs;
  const bool active = tid < BWD_THREADS && r < pl.lanes;
  const int c0 = cv * V, nc = sl.c - c0 < V ? sl.c - c0 : V;
  const int cg = sl.c / sl.groups;
  const T* xb = x + ((long long)n * sl.s + r0) * sl.c;
  const T* gb = gr + ((long long)n * sl.s + r0) * sl.c;

  if (sl.vec && tid == 0) {
    for (int st = 0; st < REDUCE_STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], BWD_THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc0[V], acc1[V], m[V], iv[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    acc0[i] = 0.0f;
    acc1[i] = 0.0f;
    m[i] = 0.0f;
    iv[i] = 0.0f;
    if (active && i < nc) {
      m[i] = mean[n * sl.groups + (c0 + i) / cg];
      iv[i] = inv[n * sl.groups + (c0 + i) / cg];
    }
  }

  // (1) stream the block's rows
  const int nchunks = (int)((rows + pl.chunk - 1) / pl.chunk);
  if (warp == BWD_THREADS / 32) {
    if (sl.vec && lane == 0) {
      const uint32_t row_bytes = (uint32_t)(sl.c * sizeof(T));
      for (int i = 0; i < nchunks; ++i) {
        const int st = i % REDUCE_STAGES;
        if (i >= REDUCE_STAGES) mbar_wait(&empty[st], (i / REDUCE_STAGES - 1) & 1);
        const long long first = (long long)i * pl.chunk;
        const long long left = rows - first;
        const uint32_t bytes =
            (uint32_t)(left < pl.chunk ? left : pl.chunk) * row_bytes;
        mbar_expect_tx(&full[st], 2 * bytes);
        bulk_load(ring + (2 * st) * STAGE_BYTES, xb + first * sl.c, bytes,
                  &full[st]);
        bulk_load(ring + (2 * st + 1) * STAGE_BYTES, gb + first * sl.c, bytes,
                  &full[st]);
      }
    }
  } else if (sl.vec) {
    for (int i = 0; i < nchunks; ++i) {
      const int st = i % REDUCE_STAGES;
      mbar_wait(&full[st], (i / REDUCE_STAGES) & 1);
      if (active) {
        const long long left = rows - (long long)i * pl.chunk;
        const int nr = (int)(left < pl.chunk ? left : pl.chunk);
        const T* xs = reinterpret_cast<const T*>(ring + (2 * st) * STAGE_BYTES);
        const T* gs =
            reinterpret_cast<const T*>(ring + (2 * st + 1) * STAGE_BYTES);
        for (int rr = r; rr < nr; rr += pl.lanes) {
          float xv[V], gv[V];
          load_vec(xs + rr * sl.c + c0, nc, true, xv);
          load_vec(gs + rr * sl.c + c0, nc, true, gv);
          reduce_row<V>(xv, gv, m, iv, acc0, acc1);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
  } else if (active) {
    const long long step = (long long)pl.lanes * sl.c;
    const T* xp = xb + (long long)r * sl.c + c0;
    const T* gp = gb + (long long)r * sl.c + c0;
    for (long long s = r; s < rows; s += pl.lanes, xp += step, gp += step) {
      float xv[V], gv[V];
      load_vec(xp, nc, false, xv);
      load_vec(gp, nc, false, gv);
      reduce_row<V>(xv, gv, m, iv, acc0, acc1);
    }
  }
  // every bulk copy has completed (each stage was waited on): the ring is
  // free
  __syncthreads();

  // (2) the block's partial: a pairwise tree over the row lanes, lane r's
  // row holding its g * xhat sums, then its g sums
  const int width = 2 * cpad;
  if (active) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      red[r * width + c0 + i] = acc0[i];
      red[r * width + cpad + c0 + i] = acc1[i];
    }
  }
  __syncthreads();
  tree_rows<V, 2>(red, width, pl.lanes, r, c0, cpad, active);
  float* out = partial + (long long)blockIdx.x * 2 * sl.c;
  for (int c = tid; c < sl.c; c += blockDim.x) {
    out[c] = red[c];
    out[sl.c + c] = red[cpad + c];
  }

  // (3) tickets: the last F blocks fold. The fence of thread 0 after the
  // barrier publishes the whole block's partial.
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    *ticket = atomicAdd(counter, 1);
  }
  __syncthreads();
  const int total = gridDim.x;
  const int role = *ticket - (total - pl.folders);
  if (role < 0) return;

  // (4) the fold: unit u is quantity u % 2 (0: g * xhat, 1: g) of group
  // u / 2, its cg columns per sample. The first unit's scale is fetched
  // while the other blocks finish.
  float* fold = red;                // BWD_THREADS floats
  float* nsum = red + BWD_THREADS;  // cg: one sample's channel sums
  float* ds = nsum + cg;            // cg: their sums over the samples
  float* sc = ds + cg;              // cg: the group's scale
  for (int u = role; u < 2 * sl.groups; u += pl.folders) {
    const int gi = u / 2, q = u % 2;
    for (int col = tid; col < cg; col += blockDim.x) {
      ds[col] = 0.0f;
      sc[col] = scale[gi * cg + col];
    }
    if (u == role && tid == 0)
      for (unsigned i = 0; ld_acquire(counter) < total; ++i)
        if (i == MAX_POLLS) __trap();
    __syncthreads();
    for (int nn = 0; nn < sl.n; ++nn) {
      const float* p =
          partial + (long long)nn * pl.bs * 2 * sl.c + q * sl.c + gi * cg;
      for (int cc = 0; cc < cg; cc += BWD_THREADS) {
        const int w = cg - cc < BWD_THREADS ? cg - cc : BWD_THREADS;
        const int segs = BWD_THREADS / w;
        const int col = tid % w, k = tid / w;
        const bool mine = tid < BWD_THREADS && k < segs;
        if (mine) {
          float t = 0.0f;
#pragma unroll 8
          for (int b = k; b < pl.bs; b += segs)
            t = __fadd_rn(t, __ldcg(p + (long long)b * 2 * sl.c + cc + col));
          fold[k * w + col] = t;
        }
        __syncthreads();
        tree_rows<1, 1>(fold, w, segs, k, col, 0, mine);
        if (tid < w) nsum[cc + tid] = fold[tid];
        __syncthreads();
      }
      if (tid == 0) {
        // sdx from the sums of g, sdxx from those of g * xhat
        float t = 0.0f;
        for (int ch = 0; ch < cg; ++ch)
          t = __fadd_rn(t, __fmul_rn(sc[ch], nsum[ch]));
        (q ? sdx : sdxx)[nn * sl.groups + gi] = t;
      }
      for (int col = tid; col < cg; col += blockDim.x)
        ds[col] = __fadd_rn(ds[col], nsum[col]);
      __syncthreads();
    }
    for (int col = tid; col < cg; col += blockDim.x)
      (q ? dbias : dscale)[gi * cg + col] = ds[col];
    __syncthreads();
  }
}

// dx of one channel vector, into xv: inv/D * (D * dxhat - sdx - xhat *
// sdxx) with a = inv / D
template <int V>
__device__ __forceinline__ void dx_vec(float* xv, const float* gv,
                                       const float* m, const float* iv,
                                       const float* sc, const float* s1,
                                       const float* s2, const float* a,
                                       float denom) {
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float xh = __fmul_rn(__fsub_rn(xv[e], m[e]), iv[e]);
    const float dxh = __fmul_rn(gv[e], sc[e]);
    const float t = __fsub_rn(__fsub_rn(__fmul_rn(denom, dxh), s1[e]),
                              __fmul_rn(xh, s2[e]));
    xv[e] = __fmul_rn(a[e], t);
  }
}

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS, DX_BLOCKS_PER_SM)
    gn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ gr,
                     const float* __restrict__ mean,
                     const float* __restrict__ inv,
                     const float* __restrict__ scale,
                     const float* __restrict__ sdx,
                     const float* __restrict__ sdxx, Slab sl, float denom,
                     int bs, int lanes, T* __restrict__ dx) {
  constexpr int V = 16 / sizeof(T);
  const int tid = threadIdx.x;
  const int cvs = (sl.c + V - 1) / V;
  const int cv = tid % cvs, r = tid / cvs;
  if (r >= lanes) return;
  const int n = blockIdx.x / bs, j = blockIdx.x % bs;
  const long long r0 = (long long)j * sl.s / bs;
  const long long rows = (long long)(j + 1) * sl.s / bs - r0;
  if (r >= rows) return;
  const int c0 = cv * V, nc = sl.c - c0 < V ? sl.c - c0 : V;
  const int cg = sl.c / sl.groups;
  const int count = (int)((rows - r + lanes - 1) / lanes);  // this lane's rows
  const long long step = (long long)lanes * sl.c;
  const long long base = ((long long)n * sl.s + r0 + r) * sl.c + c0;
  const T* xp = x + base;
  const T* gp = gr + base;
  T* dp = dx + base;
  // whole 16-byte vectors: DX_UNROLL rows' loads in flight, kept packed
  // until their turn; the first rows' go out before the per-channel values
  // are fetched
  uint4 xq[DX_UNROLL], gq[DX_UNROLL];
  if (sl.vec) {
#pragma unroll
    for (int u = 0; u < DX_UNROLL; ++u) {
      if (u < count) {
        xq[u] = *reinterpret_cast<const uint4*>(xp + u * step);
        gq[u] = *reinterpret_cast<const uint4*>(gp + u * step);
      }
    }
  }

  float m[V], iv[V], sc[V], s1[V], s2[V], a[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    m[i] = iv[i] = sc[i] = s1[i] = s2[i] = a[i] = 0.0f;
    if (i < nc) {
      const int gi = n * sl.groups + (c0 + i) / cg;
      m[i] = mean[gi];
      iv[i] = inv[gi];
      sc[i] = scale[c0 + i];
      s1[i] = sdx[gi];
      s2[i] = sdxx[gi];
      a[i] = __fdiv_rn(iv[i], denom);
    }
  }
  if (!sl.vec) {
    for (int i = 0; i < count; ++i, xp += step, gp += step, dp += step) {
      float xv[V], gv[V];
      load_vec(xp, nc, false, xv);
      load_vec(gp, nc, false, gv);
      dx_vec<V>(xv, gv, m, iv, sc, s1, s2, a, denom);
      store_vec(dp, nc, false, xv);
    }
    return;
  }
  for (int i = 0; i < count; i += DX_UNROLL) {
    if (i > 0) {
#pragma unroll
      for (int u = 0; u < DX_UNROLL; ++u) {
        if (i + u < count) {
          xq[u] = *reinterpret_cast<const uint4*>(xp + u * step);
          gq[u] = *reinterpret_cast<const uint4*>(gp + u * step);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < DX_UNROLL; ++u) {
      if (i + u < count) {
        const T* xs = reinterpret_cast<const T*>(&xq[u]);
        const T* gs = reinterpret_cast<const T*>(&gq[u]);
        float xv[V], gv[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          xv[e] = to_f(xs[e]);
          gv[e] = to_f(gs[e]);
        }
        dx_vec<V>(xv, gv, m, iv, sc, s1, s2, a, denom);
        store_vec(dp + u * step, nc, true, xv);
      }
    }
    xp += DX_UNROLL * step;
    gp += DX_UNROLL * step;
    dp += DX_UNROLL * step;
  }
}

int vec_width(int dtype) { return dtype == 0 ? 8 : 4; }

Slab make_slab(int n, long long s, int c, int groups, int dtype,
               const void* const* ptrs, int nptrs) {
  bool vec = c % vec_width(dtype) == 0;
  for (int i = 0; i < nptrs; ++i)
    vec = vec && (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0);
  return Slab{n, s, c, groups, vec};
}

bool shape_ok(int n, long long s, int c, int groups, int dtype) {
  return n > 0 && s > 0 && c > 0 && groups > 0 && c % groups == 0 &&
         (dtype == 0 || dtype == 1) &&
         (c + vec_width(dtype) - 1) / vec_width(dtype) <= THREADS;
}

size_t reduce_smem(int c, int dtype) {
  const size_t a = 2 * (size_t)THREADS * vec_width(dtype);
  const size_t b = 2 * (size_t)(c > THREADS ? c : THREADS);
  return (a > b ? a : b) * sizeof(float);
}

unsigned elementwise_blocks(int n, long long s, int c, int dtype) {
  const long long vecs =
      (long long)n * s * ((c + vec_width(dtype) - 1) / vec_width(dtype));
  const long long b = (vecs + THREADS - 1) / THREADS;
  return (unsigned)(b < SMS * 16 ? b : SMS * 16);
}

// Blocks per sample of a backward launch with `per_sm` blocks on each of
// `sms` SMs: the whole wave split over the samples, at most one per row.
int bwd_blocks_per_sample(int n, long long s, int sms, int per_sm) {
  long long b = (long long)sms * per_sm / n;
  if (b < 1) b = 1;
  if (b > s) b = s;
  return (int)b;
}

int bwd_lanes(int c, int dtype) {
  return BWD_THREADS / ((c + vec_width(dtype) - 1) / vec_width(dtype));
}

BwdPlan reduce_plan(int n, long long s, int c, int groups, int dtype,
                    int sms) {
  BwdPlan p;
  p.bs = bwd_blocks_per_sample(n, s, sms, REDUCE_BLOCKS_PER_SM);
  p.lanes = bwd_lanes(c, dtype);
  p.chunk = REDUCE_SWEEPS * p.lanes;
  const int blocks = n * p.bs;
  int f = (blocks < sms ? blocks : sms) / 2;
  if (f < 1) f = 1;
  p.folders = 2 * groups < f ? 2 * groups : f;
  return p;
}

}  // namespace

// Blocks per sample of gn_stats: enough for ~8 blocks per SM over the
// whole slab, each walking at least 8 row sweeps. The caller sizes the
// (N, B, 2, C) f32 workspace with it.
extern "C" int gn_partial_blocks(int n, long long s, int c, int dtype) {
  if (!shape_ok(n, s, c, 1, dtype)) return 0;
  const int cvs = (c + vec_width(dtype) - 1) / vec_width(dtype);
  const long long rows = THREADS / cvs;
  long long b = (s + rows * 8 - 1) / (rows * 8);
  const long long cap = (SMS * 8 + n - 1) / n;
  if (b > cap) b = cap;
  if (b < 1) b = 1;
  const long long chunk = (s + b - 1) / b;
  return (int)((s + chunk - 1) / chunk);  // every block owns >= 1 row
}

// The backward kernels' plan, mirrored by kernels/layout.py: what 0
// BWD_THREADS, 1 REDUCE_STAGES, 2 REDUCE_SWEEPS, 3 REDUCE_BLOCKS_PER_SM, 4
// DX_BLOCKS_PER_SM, 5 DX_UNROLL, 6 STAGE_BYTES; for the slab (n, s, c,
// groups, dtype) on `sms` SMs: 7 the reduce's blocks per sample, 8 row
// lanes, 9 rows per ring stage, 10 folding blocks, 11 dx's blocks per
// sample; -1 for another `what` or a slab the kernels do not take.
extern "C" int gn_bwd_tile(int what, int n, long long s, int c, int groups,
                           int dtype, int sms) {
  switch (what) {
    case 0: return BWD_THREADS;
    case 1: return REDUCE_STAGES;
    case 2: return REDUCE_SWEEPS;
    case 3: return REDUCE_BLOCKS_PER_SM;
    case 4: return DX_BLOCKS_PER_SM;
    case 5: return DX_UNROLL;
    case 6: return STAGE_BYTES;
  }
  if (!shape_ok(n, s, c, groups, dtype) || sms < 1) return -1;
  const BwdPlan p = reduce_plan(n, s, c, groups, dtype, sms);
  switch (what) {
    case 7: return p.bs;
    case 8: return p.lanes;
    case 9: return p.chunk;
    case 10: return p.folders;
    case 11: return bwd_blocks_per_sample(n, s, sms, DX_BLOCKS_PER_SM);
    default: return -1;
  }
}

// dtype: 0 bf16, 1 f32. counters: n ints, zeroed by the caller.
extern "C" int gn_stats(const void* x, int dtype, int n, long long s, int c,
                        int groups, float eps, int nblocks, float* partial,
                        int* counters, float* mean, float* inv,
                        void* stream) {
  if (!shape_ok(n, s, c, groups, dtype) ||
      nblocks != gn_partial_blocks(n, s, c, dtype))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {x};
  const Slab sl = make_slab(n, s, c, groups, dtype, ptrs, 1);
  const float denom = (float)((double)s * (c / groups));
  const dim3 grid(nblocks, n);
  const size_t smem = reduce_smem(c, dtype);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    gn_stats_kernel<__nv_bfloat16><<<grid, THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(x), sl, eps, denom, nblocks,
        partial, counters, mean, inv);
  else
    gn_stats_kernel<float><<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(x), sl, eps, denom, nblocks, partial,
        counters, mean, inv);
  return (int)cudaGetLastError();
}

extern "C" int gn_apply(const void* x, int dtype, int n, long long s, int c,
                        int groups, const float* mean, const float* inv,
                        const float* scale, const float* bias, void* out,
                        void* stream) {
  if (!shape_ok(n, s, c, groups, dtype)) return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {x, out};
  const Slab sl = make_slab(n, s, c, groups, dtype, ptrs, 2);
  const unsigned blocks = elementwise_blocks(n, s, c, dtype);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    gn_apply_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), mean, inv, scale, bias, sl,
        static_cast<__nv_bfloat16*>(out));
  else
    gn_apply_kernel<float><<<blocks, THREADS, 0, st>>>(
        static_cast<const float*>(x), mean, inv, scale, bias, sl,
        static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// partial: (N, Bs, 2, C) f32 (Bs = gn_bwd_tile(7, ...)); counter: one int,
// zeroed by the caller; sms: the device's SMs.
extern "C" int gn_bwd_reduce(const void* x, const void* g, int dtype, int n,
                             long long s, int c, int groups,
                             const float* mean, const float* inv,
                             const float* scale, int sms, float* partial,
                             int* counter, float* dscale, float* dbias,
                             float* sdx, float* sdxx, void* stream) {
  if (!shape_ok(n, s, c, groups, dtype) || sms < 1)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {x, g};
  const Slab sl = make_slab(n, s, c, groups, dtype, ptrs, 2);
  const BwdPlan p = reduce_plan(n, s, c, groups, dtype, sms);
  const unsigned blocks = (unsigned)(n * p.bs);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = cudaFuncSetAttribute(gn_bwd_reduce_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               REDUCE_SMEM);
    if (err != cudaSuccess) return (int)err;
    gn_bwd_reduce_kernel<__nv_bfloat16>
        <<<blocks, BWD_THREADS + 32, REDUCE_SMEM, st>>>(
            static_cast<const __nv_bfloat16*>(x),
            static_cast<const __nv_bfloat16*>(g), mean, inv, scale, sl, p,
            partial, counter, dscale, dbias, sdx, sdxx);
  } else {
    err = cudaFuncSetAttribute(gn_bwd_reduce_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               REDUCE_SMEM);
    if (err != cudaSuccess) return (int)err;
    gn_bwd_reduce_kernel<float><<<blocks, BWD_THREADS + 32, REDUCE_SMEM, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), mean, inv,
        scale, sl, p, partial, counter, dscale, dbias, sdx, sdxx);
  }
  return (int)cudaGetLastError();
}

extern "C" int gn_bwd_dx(const void* x, const void* g, int dtype, int n,
                         long long s, int c, int groups, const float* mean,
                         const float* inv, const float* scale,
                         const float* sdx, const float* sdxx, int sms,
                         void* dx, void* stream) {
  if (!shape_ok(n, s, c, groups, dtype) || sms < 1)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {x, g, dx};
  const Slab sl = make_slab(n, s, c, groups, dtype, ptrs, 3);
  const float denom = (float)((double)s * (c / groups));
  const int bs = bwd_blocks_per_sample(n, s, sms, DX_BLOCKS_PER_SM);
  const int lanes = bwd_lanes(c, dtype);
  const unsigned blocks = (unsigned)(n * bs);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    gn_bwd_dx_kernel<__nv_bfloat16><<<blocks, BWD_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(g), mean, inv, scale, sdx, sdxx, sl,
        denom, bs, lanes, static_cast<__nv_bfloat16*>(dx));
  else
    gn_bwd_dx_kernel<float><<<blocks, BWD_THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), mean, inv,
        scale, sdx, sdxx, sl, denom, bs, lanes, static_cast<float*>(dx));
  return (int)cudaGetLastError();
}
