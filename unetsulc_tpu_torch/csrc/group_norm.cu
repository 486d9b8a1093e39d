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
// Two modes and one small kernel serve a GroupNorm whose volume is split
// along X over shards (parallel/halo.py, the sharded non-fused step; the
// TPU package leaves that case to XLA's all-reduced statistics):
//
//   gn_stats_sums  gn_stats' launch and fold with its finalize left out:
//                  per (n, group) the sums of x and of x^2 (N, G) f32, the
//                  same bits in every run;
//   gn_finalize    one block: the shards' added sums and the global count
//                  D -> mean_g, inv_g with gn_stats' own tail arithmetic;
//   gn_bwd_dx_denom  gn_bwd_dx with D given (the global count) instead of
//                  S * C / G of the shard.
//
// Sums and not (mean, inv) leave a shard, because rebuilding the sums from
// rsqrt is lossy and cancels where var << mean^2.
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
// The four kernels follow one one-wave plan, mirrored by
// kernels/layout.py (gn_tile, checked when the library is loaded): a
// launch has N * Bs blocks, Bs = min(S, max(1, SMs * k / N)) with k = 1
// (the two reductions, gn_stats and gn_bwd_reduce) or 2 (the two
// elementwise passes, gn_apply and gn_bwd_dx), so every block is resident
// at once; block j of sample n owns rows [j S / Bs, (j + 1) S / Bs), so
// blocks differ by at most one row and a block's rows of each tensor are
// one contiguous byte range. Rows alone fill the card down to N * S >=
// SMs rows, far below any GroupNorm of the model (13^3 = 2197 rows), so
// channels are not split. Each thread owns one 16-byte channel vector and
// one of R = 256 / (vectors per row) row lanes, fixed for the launch.
//
// gn_stats and gn_bwd_reduce share one streaming reduction. (1) A producer
// warp streams the block's rows through a ring of 4 stages in shared
// memory, each stage 16 KB of 1-D TMA bulk copies (cp.async.bulk ...
// mbarrier::complete_tx::bytes, no tensor map) completing on one mbarrier
// per stage: 4 row sweeps of x (stats), or 2 of x and 2 of g (reduce).
// Eight consumer warps wait on it, accumulate per channel in f32 in row
// order (lane r takes rows r, r + R, ...): x and x^2 (stats), g * xhat
// and g (reduce); they release the stage on a second mbarrier. Rows that
// are not whole 16-byte vectors (C % V, or an unaligned pointer) are read
// straight from device memory in the same order. (2) A pairwise tree over
// the row lanes gives the block's partial (2, C). (3) Every block takes a
// ticket; the last F blocks wait until all B have taken theirs, then fold
// in parallel, block f the units f, f + F, ...: each of a unit's columns
// summed over its sample's Bs partials by T = 256 / columns threads in
// strides, then a pairwise tree over the T. No block walks the partials
// alone, and the order depends only on the shapes: two launches give the
// same bits. Waiting is safe: at most half the resident blocks wait, and
// every other block finishes without waiting. A wait that cannot end
// traps. The ticket counter is zeroed by the caller (a memset per launch:
// a counter the kernel reset itself would be shared by CUDA graphs
// replayed on other streams).
//
// gn_stats folds F = min(N G, max(1, min(B, SMs) / 2)) units, unit u the
// sums of x and of x^2 of group u % G of sample u / G (2 C / G columns);
// then per unit the group sums in channel order, mean = sum x / D and
// inv = rsqrt(sum x^2 / D - mean^2 + eps) (gn_stats_sums: the two sums
// themselves). gn_finalize is that tail alone, one thread per unit.
//
// gn_bwd_reduce folds F = min(2 G, max(1, min(B, SMs) / 2)) units, unit u
// the sums of g * xhat (u even) or of g (u odd) of group u / 2 (C / G
// columns per sample); per sample the group sum (sdxx or sdx) in channel
// order; dscale or dbias over the samples in order.
//
// gn_apply and gn_bwd_dx. Each thread computes its channel vector's
// per-channel values once, in registers (apply: mean, a = inv * scale,
// bias; dx: mean, inv, scale, sdx, sdxx and inv / D, hoisted out of the
// loop with the bits of the division per element), then walks its rows
// four at a time: 16-byte loads of four rows in flight (of x and of g for
// dx; the first four rows' issued before those values are fetched), kept
// packed until their turn, pointer increments and no division in the
// loop, 16-byte stores; the arithmetic is in the JAX order, with nothing
// reassociated.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fold.cuh"

namespace {

using fold::MAX_POLLS;
using fold::tree_rows;
using fold::wait_tickets;

// threads that own channel vectors (a reduction block adds one producer
// warp), the reductions' ring stages, row sweeps of each tensor per stage
// of the backward reduce (gn_stats: twice as many, of x alone) and blocks
// per SM; the elementwise passes' blocks per SM and rows per thread per
// iteration (mirrored by kernels/layout.py)
constexpr int THREADS = 256;
constexpr int REDUCE_STAGES = 4;
constexpr int REDUCE_SWEEPS = 2;
constexpr int REDUCE_BLOCKS_PER_SM = 1;
constexpr int DX_BLOCKS_PER_SM = 2;
constexpr int DX_UNROLL = 4;
constexpr int STAGE_BYTES = REDUCE_SWEEPS * THREADS * 16;  // per tensor
constexpr int REDUCE_SMEM = 128 + REDUCE_STAGES * 2 * STAGE_BYTES;
constexpr int FOLD_BATCH = 4;  // partials a folding thread loads at once

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

// The launch plan of a reduction (kernels/layout.py gn_stats_plan,
// gn_reduce_plan)
struct RedPlan {
  int bs;       // blocks per sample
  int lanes;    // row lanes R: rows walked together
  int chunk;    // rows per ring stage
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

// One row of a reduction: a0 += g * xhat, a1 += g per channel (BWD), else
// a0 += x, a1 += x^2.
template <bool BWD, int V>
__device__ __forceinline__ void reduce_row(const float* xv, const float* gv,
                                           const float* m, const float* iv,
                                           float* a0, float* a1) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if constexpr (BWD) {
      const float xh = __fmul_rn(__fsub_rn(xv[j], m[j]), iv[j]);
      a0[j] = __fadd_rn(a0[j], __fmul_rn(gv[j], xh));
      a1[j] = __fadd_rn(a1[j], gv[j]);
    } else {
      a0[j] = __fadd_rn(a0[j], xv[j]);
      a1[j] = __fadd_rn(a1[j], __fmul_rn(xv[j], xv[j]));
    }
  }
}

// Steps (1)-(3) of a reduction for block blockIdx.x of plan `pl`: stream
// its rows of x (and of g when BWD) through the ring, accumulate per
// channel in row-lane order, a pairwise tree over the row lanes, the
// block's partial (2, C) to partial[blockIdx.x], then a ticket of
// `counter`. Returns the block's place among the F folding blocks, or -1
// when it does not fold. smem: 128 bytes of barriers and ticket, then the
// ring (REDUCE_STAGES stages of 2 * STAGE_BYTES), which the partial's tree
// and then the fold reuse.
template <typename T, bool BWD>
__device__ __forceinline__ int stream_partial(
    const T* __restrict__ x, const T* __restrict__ gr,
    const float* __restrict__ mean, const float* __restrict__ inv,
    const Slab& sl, const RedPlan& pl, unsigned char* smem,
    float* __restrict__ partial, int* __restrict__ counter) {
  constexpr int V = 16 / sizeof(T);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + REDUCE_STAGES;
  int* ticket = reinterpret_cast<int*>(empty + REDUCE_STAGES);
  unsigned char* ring = smem + 128;
  float* red = reinterpret_cast<float*>(ring);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n = blockIdx.x / pl.bs, j = blockIdx.x % pl.bs;
  const long long r0 = (long long)j * sl.s / pl.bs;
  const long long rows = (long long)(j + 1) * sl.s / pl.bs - r0;
  const int cvs = (sl.c + V - 1) / V, cpad = cvs * V;
  const int cv = tid % cvs, r = tid / cvs;
  const bool active = tid < THREADS && r < pl.lanes;
  const int c0 = cv * V, nc = sl.c - c0 < V ? sl.c - c0 : V;
  const T* xb = x + ((long long)n * sl.s + r0) * sl.c;
  const T* gb = xb;
  if constexpr (BWD) gb = gr + ((long long)n * sl.s + r0) * sl.c;

  if (sl.vec && tid == 0) {
    for (int st = 0; st < REDUCE_STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc0[V], acc1[V], m[V], iv[V], gv[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    acc0[i] = 0.0f;
    acc1[i] = 0.0f;
    m[i] = 0.0f;
    iv[i] = 0.0f;
    gv[i] = 0.0f;
    if constexpr (BWD) {
      if (active && i < nc) {
        const int cg = sl.c / sl.groups;
        m[i] = mean[n * sl.groups + (c0 + i) / cg];
        iv[i] = inv[n * sl.groups + (c0 + i) / cg];
      }
    }
  }

  // (1) stream the block's rows
  const int nchunks = (int)((rows + pl.chunk - 1) / pl.chunk);
  if (warp == THREADS / 32) {
    if (sl.vec && lane == 0) {
      const uint32_t row_bytes = (uint32_t)(sl.c * sizeof(T));
      for (int i = 0; i < nchunks; ++i) {
        const int st = i % REDUCE_STAGES;
        if (i >= REDUCE_STAGES) mbar_wait(&empty[st], (i / REDUCE_STAGES - 1) & 1);
        const long long first = (long long)i * pl.chunk;
        const long long left = rows - first;
        const uint32_t bytes =
            (uint32_t)(left < pl.chunk ? left : pl.chunk) * row_bytes;
        mbar_expect_tx(&full[st], (BWD ? 2 : 1) * bytes);
        bulk_load(ring + (2 * st) * STAGE_BYTES, xb + first * sl.c, bytes,
                  &full[st]);
        if constexpr (BWD)
          bulk_load(ring + (2 * st + 1) * STAGE_BYTES, gb + first * sl.c,
                    bytes, &full[st]);
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
          float xv[V];
          load_vec(xs + rr * sl.c + c0, nc, true, xv);
          if constexpr (BWD) load_vec(gs + rr * sl.c + c0, nc, true, gv);
          reduce_row<BWD, V>(xv, gv, m, iv, acc0, acc1);
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
      float xv[V];
      load_vec(xp, nc, false, xv);
      if constexpr (BWD) load_vec(gp, nc, false, gv);
      reduce_row<BWD, V>(xv, gv, m, iv, acc0, acc1);
    }
  }
  // every bulk copy has completed (each stage was waited on): the ring is
  // free
  __syncthreads();

  // (2) the block's partial: a pairwise tree over the row lanes, lane r's
  // row holding its first sums, then its second
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
  const int role = *ticket - ((int)gridDim.x - pl.folders);
  return role < 0 ? -1 : role;
}

// The fold of one unit's `ncol` columns over a sample's `bs` partials
// (each 2 * c floats apart): column k at p[(k / cg) * c + k % cg]; in
// passes of at most THREADS columns, thread k * w + i sums column i of
// the pass over partials k, k + T, ... in order (its loads issued
// FOLD_BATCH at a time before it adds them: the fold waits on L2), then a
// pairwise tree over the T segments; nsum[k] gets column k's sum. `fold`:
// THREADS floats. Every thread of the block calls it (it synchronises).
__device__ __forceinline__ void fold_columns(const float* p, int bs, int c,
                                             int cg, int ncol, float* fold,
                                             float* nsum) {
  const int tid = threadIdx.x;
  for (int cc = 0; cc < ncol; cc += THREADS) {
    const int w = ncol - cc < THREADS ? ncol - cc : THREADS;
    const int segs = THREADS / w;
    const int col = tid % w, k = tid / w;
    const bool mine = tid < THREADS && k < segs;
    if (mine) {
      const int kk = cc + col;
      const float* q = p + (kk / cg) * c + kk % cg;
      float t = 0.0f;
      for (int b0 = k; b0 < bs; b0 += FOLD_BATCH * segs) {
        float v[FOLD_BATCH];
#pragma unroll
        for (int i = 0; i < FOLD_BATCH; ++i) {
          const int b = b0 + i * segs;
          v[i] = b < bs ? __ldcg(q + (long long)b * 2 * c) : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < FOLD_BATCH; ++i)
          if (b0 + i * segs < bs) t = __fadd_rn(t, v[i]);
      }
      fold[k * w + col] = t;
    }
    __syncthreads();
    tree_rows<1, 1>(fold, w, segs, k, col, 0, mine);
    if (tid < w) nsum[cc + tid] = fold[tid];
    __syncthreads();
  }
}

// mean and inv of one unit from its sums: gn_stats' tail, and gn_finalize
__device__ __forceinline__ void finalize_unit(float s, float q, float denom,
                                              float eps, float* mean,
                                              float* inv) {
  const float mu = __fdiv_rn(s, denom);
  const float var = __fsub_rn(__fdiv_rn(q, denom), __fmul_rn(mu, mu));
  *mean = mu;
  *inv = rsqrtf(__fadd_rn(var, eps));
}

// SUMS (gn_stats_sums): out0, out1 get the sums of x and of x^2; else
// (gn_stats) mean and inv
template <typename T, bool SUMS>
__global__ void __launch_bounds__(THREADS + 32, 1)
    gn_stats_kernel(const T* __restrict__ x, Slab sl, RedPlan pl, float eps,
                    float denom, float* __restrict__ partial,
                    int* __restrict__ counter, float* __restrict__ out0,
                    float* __restrict__ out1) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int role = stream_partial<T, false>(x, nullptr, nullptr, nullptr, sl,
                                            pl, smem, partial, counter);
  if (role < 0) return;

  // (4) the fold: unit u is group u % G of sample u / G, its sums of x
  // (columns 0 .. cg) and of x^2 (cg .. 2 cg)
  const int cg = sl.c / sl.groups;
  float* fold = reinterpret_cast<float*>(smem + 128);  // THREADS floats
  float* nsum = fold + THREADS;                         // 2 cg
  for (int u = role; u < sl.n * sl.groups; u += pl.folders) {
    const int nn = u / sl.groups, gi = u % sl.groups;
    if (u == role) wait_tickets(counter, gridDim.x);
    __syncthreads();
    fold_columns(partial + (long long)nn * pl.bs * 2 * sl.c + gi * cg, pl.bs,
                 sl.c, cg, 2 * cg, fold, nsum);
    if (threadIdx.x == 0) {
      float s = 0.0f, q = 0.0f;
      for (int ch = 0; ch < cg; ++ch) {
        s = __fadd_rn(s, nsum[ch]);
        q = __fadd_rn(q, nsum[cg + ch]);
      }
      if constexpr (SUMS) {
        out0[u] = s;
        out1[u] = q;
      } else {
        finalize_unit(s, q, denom, eps, &out0[u], &out1[u]);
      }
    }
  }
}

// One block, thread u the units u, u + THREADS, ...
__global__ void __launch_bounds__(THREADS, 1)
    gn_finalize_kernel(const float* __restrict__ sum,
                       const float* __restrict__ sq, int units, float denom,
                       float eps, float* __restrict__ mean,
                       float* __restrict__ inv) {
  for (int u = threadIdx.x; u < units; u += blockDim.x)
    finalize_unit(sum[u], sq[u], denom, eps, &mean[u], &inv[u]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS + 32, 1)
    gn_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ gr,
                         const float* __restrict__ mean,
                         const float* __restrict__ inv,
                         const float* __restrict__ scale, Slab sl, RedPlan pl,
                         float* __restrict__ partial, int* __restrict__ counter,
                         float* __restrict__ dscale,
                         float* __restrict__ dbias, float* __restrict__ sdx,
                         float* __restrict__ sdxx) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int role = stream_partial<T, true>(x, gr, mean, inv, sl, pl, smem,
                                           partial, counter);
  if (role < 0) return;

  // (4) the fold: unit u is quantity u % 2 (0: g * xhat, 1: g) of group
  // u / 2, its cg columns per sample. The first unit's scale is fetched
  // while the other blocks finish.
  const int tid = threadIdx.x;
  const int cg = sl.c / sl.groups;
  float* fold = reinterpret_cast<float*>(smem + 128);  // THREADS floats
  float* nsum = fold + THREADS;  // cg: one sample's channel sums
  float* ds = nsum + cg;         // cg: their sums over the samples
  float* sc = ds + cg;           // cg: the group's scale
  for (int u = role; u < 2 * sl.groups; u += pl.folders) {
    const int gi = u / 2, q = u % 2;
    for (int col = tid; col < cg; col += blockDim.x) {
      ds[col] = 0.0f;
      sc[col] = scale[gi * cg + col];
    }
    if (u == role) wait_tickets(counter, gridDim.x);
    __syncthreads();
    for (int nn = 0; nn < sl.n; ++nn) {
      fold_columns(
          partial + (long long)nn * pl.bs * 2 * sl.c + q * sl.c + gi * cg,
          pl.bs, sl.c, cg, cg, fold, nsum);
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

template <typename T>
__global__ void __launch_bounds__(THREADS, DX_BLOCKS_PER_SM)
    gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                    const float* __restrict__ inv,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, Slab sl, int bs,
                    int lanes, T* __restrict__ out) {
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
  const int count = (int)((rows - r + lanes - 1) / lanes);  // this lane's rows
  const long long step = (long long)lanes * sl.c;
  const long long base = ((long long)n * sl.s + r0 + r) * sl.c + c0;
  const T* xp = x + base;
  T* op = out + base;
  // whole 16-byte vectors: DX_UNROLL rows' loads in flight, kept packed
  // until their turn; the first rows' go out before the per-channel values
  // are fetched
  uint4 xq[DX_UNROLL];
  if (sl.vec) {
#pragma unroll
    for (int u = 0; u < DX_UNROLL; ++u)
      if (u < count) xq[u] = *reinterpret_cast<const uint4*>(xp + u * step);
  }

  const int cg = sl.c / sl.groups;
  float m[V], a[V], b[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    m[i] = a[i] = b[i] = 0.0f;
    if (i < nc) {
      const int gi = n * sl.groups + (c0 + i) / cg;
      m[i] = mean[gi];
      a[i] = __fmul_rn(inv[gi], scale[c0 + i]);
      b[i] = bias[c0 + i];
    }
  }
  if (!sl.vec) {
    for (int i = 0; i < count; ++i, xp += step, op += step) {
      float v[V];
      load_vec(xp, nc, false, v);
#pragma unroll
      for (int e = 0; e < V; ++e)
        v[e] = __fadd_rn(__fmul_rn(__fsub_rn(v[e], m[e]), a[e]), b[e]);
      store_vec(op, nc, false, v);
    }
    return;
  }
  for (int i = 0; i < count; i += DX_UNROLL) {
    if (i > 0) {
#pragma unroll
      for (int u = 0; u < DX_UNROLL; ++u)
        if (i + u < count)
          xq[u] = *reinterpret_cast<const uint4*>(xp + u * step);
    }
#pragma unroll
    for (int u = 0; u < DX_UNROLL; ++u) {
      if (i + u < count) {
        const T* xs = reinterpret_cast<const T*>(&xq[u]);
        float v[V];
#pragma unroll
        for (int e = 0; e < V; ++e)
          v[e] = __fadd_rn(__fmul_rn(__fsub_rn(to_f(xs[e]), m[e]), a[e]),
                           b[e]);
        store_vec(op + u * step, nc, true, v);
      }
    }
    xp += DX_UNROLL * step;
    op += DX_UNROLL * step;
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
__global__ void __launch_bounds__(THREADS, DX_BLOCKS_PER_SM)
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

bool shape_ok(int n, long long s, int c, int groups, int dtype, int sms) {
  return n > 0 && s > 0 && c > 0 && groups > 0 && c % groups == 0 &&
         (dtype == 0 || dtype == 1) && sms > 0 &&
         (c + vec_width(dtype) - 1) / vec_width(dtype) <= THREADS;
}

// Blocks per sample of a launch with `per_sm` blocks on each of `sms`
// SMs: the whole wave split over the samples, at most one per row.
int blocks_per_sample(int n, long long s, int sms, int per_sm) {
  long long b = (long long)sms * per_sm / n;
  if (b < 1) b = 1;
  if (b > s) b = s;
  return (int)b;
}

int row_lanes(int c, int dtype) {
  return THREADS / ((c + vec_width(dtype) - 1) / vec_width(dtype));
}

// The plan of gn_bwd_reduce (bwd) or gn_stats: their folds take 2 G
// units, or N G.
RedPlan reduce_plan(int n, long long s, int c, int groups, int dtype,
                    int sms, bool bwd) {
  RedPlan p;
  p.bs = blocks_per_sample(n, s, sms, REDUCE_BLOCKS_PER_SM);
  p.lanes = row_lanes(c, dtype);
  p.chunk = (bwd ? REDUCE_SWEEPS : 2 * REDUCE_SWEEPS) * p.lanes;
  const int blocks = n * p.bs;
  int f = (blocks < sms ? blocks : sms) / 2;
  if (f < 1) f = 1;
  const int units = bwd ? 2 * groups : n * groups;
  p.folders = units < f ? units : f;
  return p;
}

// gn_stats' or gn_bwd_reduce's kernel for dtype T may take the ring's
// shared memory
template <typename K>
cudaError_t allow_ring(K kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, REDUCE_SMEM);
}

}  // namespace

// The four kernels' plan, mirrored by kernels/layout.py: what 0 THREADS,
// 1 REDUCE_STAGES, 2 REDUCE_SWEEPS, 3 REDUCE_BLOCKS_PER_SM, 4
// DX_BLOCKS_PER_SM, 5 DX_UNROLL, 6 STAGE_BYTES; for the slab (n, s, c,
// groups, dtype) on `sms` SMs: 7 gn_bwd_reduce's blocks per sample, 8 row
// lanes, 9 rows per ring stage, 10 folding blocks, 11 gn_apply's and
// gn_bwd_dx's blocks per sample, 12-15 gn_stats' as 7-10; -1 for another
// `what` or a slab the kernels do not take.
extern "C" int gn_tile(int what, int n, long long s, int c, int groups,
                       int dtype, int sms) {
  switch (what) {
    case 0: return THREADS;
    case 1: return REDUCE_STAGES;
    case 2: return REDUCE_SWEEPS;
    case 3: return REDUCE_BLOCKS_PER_SM;
    case 4: return DX_BLOCKS_PER_SM;
    case 5: return DX_UNROLL;
    case 6: return STAGE_BYTES;
  }
  if (!shape_ok(n, s, c, groups, dtype, sms)) return -1;
  if (what == 11) return blocks_per_sample(n, s, sms, DX_BLOCKS_PER_SM);
  if (what < 7 || what > 15) return -1;
  const RedPlan p = reduce_plan(n, s, c, groups, dtype, sms, what < 11);
  switch (what < 11 ? what - 7 : what - 12) {
    case 0: return p.bs;
    case 1: return p.lanes;
    case 2: return p.chunk;
    default: return p.folders;
  }
}

template <bool SUMS>
static int launch_stats(const void* x, int dtype, int n, long long s,
                        int c, int groups, float eps, int sms, float* partial,
                        int* counter, float* out0, float* out1,
                        void* stream) {
  if (!shape_ok(n, s, c, groups, dtype, sms))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {x};
  const Slab sl = make_slab(n, s, c, groups, dtype, ptrs, 1);
  const RedPlan p = reduce_plan(n, s, c, groups, dtype, sms, false);
  const float denom = (float)((double)s * (c / groups));
  const unsigned blocks = (unsigned)(n * p.bs);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = allow_ring(gn_stats_kernel<__nv_bfloat16, SUMS>);
    if (err != cudaSuccess) return (int)err;
    gn_stats_kernel<__nv_bfloat16, SUMS>
        <<<blocks, THREADS + 32, REDUCE_SMEM, st>>>(
            static_cast<const __nv_bfloat16*>(x), sl, p, eps, denom, partial,
            counter, out0, out1);
  } else {
    err = allow_ring(gn_stats_kernel<float, SUMS>);
    if (err != cudaSuccess) return (int)err;
    gn_stats_kernel<float, SUMS><<<blocks, THREADS + 32, REDUCE_SMEM, st>>>(
        static_cast<const float*>(x), sl, p, eps, denom, partial, counter,
        out0, out1);
  }
  return (int)cudaGetLastError();
}

// dtype: 0 bf16, 1 f32. partial: (N, Bs, 2, C) f32 (Bs = gn_tile(12,
// ...)); counter: one int, zeroed by the caller; sms: the device's SMs.
extern "C" int gn_stats(const void* x, int dtype, int n, long long s, int c,
                        int groups, float eps, int sms, float* partial,
                        int* counter, float* mean, float* inv, void* stream) {
  return launch_stats<false>(x, dtype, n, s, c, groups, eps, sms, partial,
                             counter, mean, inv, stream);
}

// gn_stats' launch and plan (its workspace too), writing the sums of x and
// of x^2 per (n, group) instead of mean and inv.
extern "C" int gn_stats_sums(const void* x, int dtype, int n, long long s,
                             int c, int groups, int sms, float* partial,
                             int* counter, float* sum, float* sq,
                             void* stream) {
  return launch_stats<true>(x, dtype, n, s, c, groups, 0.0f, sms, partial,
                            counter, sum, sq, stream);
}

// sum, sq, mean, inv: `units` floats each (N * G); count: the elements of
// each unit over every shard, D.
extern "C" int gn_finalize(const float* sum, const float* sq, int units,
                           long long count, float eps, float* mean,
                           float* inv, void* stream) {
  if (units < 1 || count < 1) return (int)cudaErrorInvalidValue;
  gn_finalize_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      sum, sq, units, (float)(double)count, eps, mean, inv);
  return (int)cudaGetLastError();
}

extern "C" int gn_apply(const void* x, int dtype, int n, long long s, int c,
                        int groups, const float* mean, const float* inv,
                        const float* scale, const float* bias, int sms,
                        void* out, void* stream) {
  if (!shape_ok(n, s, c, groups, dtype, sms))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {x, out};
  const Slab sl = make_slab(n, s, c, groups, dtype, ptrs, 2);
  const int bs = blocks_per_sample(n, s, sms, DX_BLOCKS_PER_SM);
  const int lanes = row_lanes(c, dtype);
  const unsigned blocks = (unsigned)(n * bs);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    gn_apply_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), mean, inv, scale, bias, sl, bs,
        lanes, static_cast<__nv_bfloat16*>(out));
  else
    gn_apply_kernel<float><<<blocks, THREADS, 0, st>>>(
        static_cast<const float*>(x), mean, inv, scale, bias, sl, bs, lanes,
        static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// partial: (N, Bs, 2, C) f32 (Bs = gn_tile(7, ...)); counter: one int,
// zeroed by the caller; sms: the device's SMs.
extern "C" int gn_bwd_reduce(const void* x, const void* g, int dtype, int n,
                             long long s, int c, int groups,
                             const float* mean, const float* inv,
                             const float* scale, int sms, float* partial,
                             int* counter, float* dscale, float* dbias,
                             float* sdx, float* sdxx, void* stream) {
  if (!shape_ok(n, s, c, groups, dtype, sms))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {x, g};
  const Slab sl = make_slab(n, s, c, groups, dtype, ptrs, 2);
  const RedPlan p = reduce_plan(n, s, c, groups, dtype, sms, true);
  const unsigned blocks = (unsigned)(n * p.bs);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = allow_ring(gn_bwd_reduce_kernel<__nv_bfloat16>);
    if (err != cudaSuccess) return (int)err;
    gn_bwd_reduce_kernel<__nv_bfloat16>
        <<<blocks, THREADS + 32, REDUCE_SMEM, st>>>(
            static_cast<const __nv_bfloat16*>(x),
            static_cast<const __nv_bfloat16*>(g), mean, inv, scale, sl, p,
            partial, counter, dscale, dbias, sdx, sdxx);
  } else {
    err = allow_ring(gn_bwd_reduce_kernel<float>);
    if (err != cudaSuccess) return (int)err;
    gn_bwd_reduce_kernel<float><<<blocks, THREADS + 32, REDUCE_SMEM, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), mean, inv,
        scale, sl, p, partial, counter, dscale, dbias, sdx, sdxx);
  }
  return (int)cudaGetLastError();
}

static int launch_dx(const void* x, const void* g, int dtype, int n,
                     long long s, int c, int groups, const float* mean,
                     const float* inv, const float* scale, const float* sdx,
                     const float* sdxx, float denom, int sms, void* dx,
                     void* stream) {
  if (!shape_ok(n, s, c, groups, dtype, sms))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {x, g, dx};
  const Slab sl = make_slab(n, s, c, groups, dtype, ptrs, 3);
  const int bs = blocks_per_sample(n, s, sms, DX_BLOCKS_PER_SM);
  const int lanes = row_lanes(c, dtype);
  const unsigned blocks = (unsigned)(n * bs);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    gn_bwd_dx_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(g), mean, inv, scale, sdx, sdxx, sl,
        denom, bs, lanes, static_cast<__nv_bfloat16*>(dx));
  else
    gn_bwd_dx_kernel<float><<<blocks, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), mean, inv,
        scale, sdx, sdxx, sl, denom, bs, lanes, static_cast<float*>(dx));
  return (int)cudaGetLastError();
}

extern "C" int gn_bwd_dx(const void* x, const void* g, int dtype, int n,
                         long long s, int c, int groups, const float* mean,
                         const float* inv, const float* scale,
                         const float* sdx, const float* sdxx, int sms,
                         void* dx, void* stream) {
  return launch_dx(x, g, dtype, n, s, c, groups, mean, inv, scale, sdx, sdxx,
                   (float)((double)s * (c / groups)), sms, dx, stream);
}

// gn_bwd_dx with D = count, the elements of each (n, group) over every
// shard of a volume split along X (the shard's own S * C / G otherwise).
extern "C" int gn_bwd_dx_denom(const void* x, const void* g, int dtype,
                               int n, long long s, int c, int groups,
                               const float* mean, const float* inv,
                               const float* scale, const float* sdx,
                               const float* sdxx, long long count, int sms,
                               void* dx, void* stream) {
  if (count < 1) return (int)cudaErrorInvalidValue;
  return launch_dx(x, g, dtype, n, s, c, groups, mean, inv, scale, sdx, sdxx,
                   (float)(double)count, sms, dx, stream);
}
