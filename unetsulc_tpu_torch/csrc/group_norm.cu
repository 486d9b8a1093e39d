// GroupNorm forward and backward on a contiguous channels-last (N, S, C)
// slab, bf16 or f32, with f32 statistics: four kernels.
//
// Replaces: unetsulc_tpu/ops/groupnorm_pallas.py `_gn_kernel` (one sample's
// whole (S, C) slab in VMEM) and the chunked kernels of
// unetsulc_tpu/ops/attic/groupnorm_pallas_chunked.py: `_stats_kernel`,
// `_normalize_kernel`, `_bwd_reduce_kernel`, `_bwd_dx_kernel`.
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
// The TPU grid runs in order, so its chunked kernels carry the channel sums
// in scratch from one chunk to the next. Here the blocks of one sample run
// in parallel: each block sums its own voxel range per channel (one thread
// owns a 16-byte vector of channels and walks rows; a fixed-order shared
// memory reduction combines the rows) and writes its partial sums to an
// f32 workspace (N, B, 2, C). The last block of a sample to finish (an
// atomic ticket) folds the B partials in a fixed order, so the result does
// not depend on timing, and reduces the channels of each group. In the
// backward the last sample to finish also folds the per-sample channel sums
// over n, in order, into dscale and dbias. Group sums of the backward are
// taken as scale_c * sum(g) and scale_c * sum(g * xhat) per channel, the
// same sums as sum(dxhat) and sum(dxhat * xhat) in another rounding order.
// Elementwise arithmetic uses the _rn intrinsics in the order of the
// JAX formulas, so no multiply-add is contracted.
//
// What bounds them on this card: bytes. Stats read x once; apply reads x
// and writes out; the backward reduce reads x and g; dx reads x and g and
// writes dx. A few operations per byte; at 96^3 x 64 bf16 one pass over x
// is 113 MB, ~34 us at 3.35 TB/s. This first version uses plain vector
// loads (no cp.async or TMA) and one read of x per kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SMS = 132;  // H100 SXM

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

// Sums two per-channel quantities over rows [s0, s1) of sample n, combines
// the block's rows in a fixed order in shared memory `red` (2 * THREADS * V
// floats) and writes them to partial[n][b] (2, c). kBwd: the quantities
// are (sum g * xhat, sum g); else (sum x, sum x^2).
template <typename T, bool kBwd>
__device__ void block_partials(const T* __restrict__ x,
                               const T* __restrict__ gr, const float* mean,
                               const float* inv, const Slab& sl, int n, int b,
                               int nblocks, float* red,
                               float* __restrict__ partial) {
  constexpr int V = 16 / sizeof(T);
  const int cvs = (sl.c + V - 1) / V;  // channel vectors per row
  const int rows = THREADS / cvs;      // rows walked together
  const int cpad = cvs * V;
  const int tid = threadIdx.x;
  const int cv = tid % cvs, r = tid / cvs;
  const int c0 = cv * V, nc = sl.c - c0 < V ? sl.c - c0 : V;
  const int cg = sl.c / sl.groups;
  const long long chunk = (sl.s + nblocks - 1) / nblocks;
  const long long s0 = (long long)b * chunk;
  const long long s1 = s0 + chunk < sl.s ? s0 + chunk : sl.s;

  float acc0[V], acc1[V], m[V], iv[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    acc0[j] = 0.0f;
    acc1[j] = 0.0f;
    m[j] = 0.0f;
    iv[j] = 0.0f;
    if (kBwd && r < rows && j < nc) {
      m[j] = mean[n * sl.groups + (c0 + j) / cg];
      iv[j] = inv[n * sl.groups + (c0 + j) / cg];
    }
  }
  if (r < rows) {
    const long long base = (long long)n * sl.s;
    for (long long s = s0 + r; s < s1; s += rows) {
      const long long off = (base + s) * sl.c + c0;
      float xv[V];
      load_vec(x + off, nc, sl.vec, xv);
      if (kBwd) {
        float gv[V];
        load_vec(gr + off, nc, sl.vec, gv);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xh = __fmul_rn(__fsub_rn(xv[j], m[j]), iv[j]);
          acc0[j] = __fadd_rn(acc0[j], __fmul_rn(gv[j], xh));
          acc1[j] = __fadd_rn(acc1[j], gv[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          acc0[j] = __fadd_rn(acc0[j], xv[j]);
          acc1[j] = __fadd_rn(acc1[j], __fmul_rn(xv[j], xv[j]));
        }
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
  block_partials<T, false>(x, nullptr, nullptr, nullptr, sl, n, b, nblocks,
                           red, partial);
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
    gn_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ gr,
                         const float* __restrict__ mean,
                         const float* __restrict__ inv,
                         const float* __restrict__ scale, Slab sl,
                         int nblocks, float* __restrict__ partial,
                         float* __restrict__ nsum, int* __restrict__ counters,
                         float* __restrict__ dscale,
                         float* __restrict__ dbias, float* __restrict__ sdx,
                         float* __restrict__ sdxx) {
  extern __shared__ float red[];
  const int n = blockIdx.y, b = blockIdx.x;
  block_partials<T, true>(x, gr, mean, inv, sl, n, b, nblocks, red, partial);
  if (!last_block(counters + n, nblocks)) return;
  fold_partials(partial, n, nblocks, sl.c, red);
  const int cg = sl.c / sl.groups;
  for (int ch = threadIdx.x; ch < sl.c; ch += THREADS) {
    nsum[(long long)n * 2 * sl.c + ch] = red[ch];
    nsum[(long long)n * 2 * sl.c + sl.c + ch] = red[sl.c + ch];
  }
  for (int g = threadIdx.x; g < sl.groups; g += THREADS) {
    float s = 0.0f, q = 0.0f;
    for (int ch = g * cg; ch < (g + 1) * cg; ++ch) {
      s += __fmul_rn(scale[ch], red[sl.c + ch]);  // sum dxhat
      q += __fmul_rn(scale[ch], red[ch]);         // sum dxhat * xhat
    }
    sdx[n * sl.groups + g] = s;
    sdxx[n * sl.groups + g] = q;
  }
  if (!last_block(counters + sl.n, sl.n)) return;
  for (int ch = threadIdx.x; ch < sl.c; ch += THREADS) {
    float t0 = 0.0f, t1 = 0.0f;
    for (int i = 0; i < sl.n; ++i) {
      t0 += __ldcg(nsum + (long long)i * 2 * sl.c + ch);
      t1 += __ldcg(nsum + (long long)i * 2 * sl.c + sl.c + ch);
    }
    dscale[ch] = t0;
    dbias[ch] = t1;
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
    gn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ gr,
                     const float* __restrict__ mean,
                     const float* __restrict__ inv,
                     const float* __restrict__ scale,
                     const float* __restrict__ sdx,
                     const float* __restrict__ sdxx, Slab sl, float denom,
                     T* __restrict__ dx) {
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
    float xv[V], gv[V];
    load_vec(x + off, nc, sl.vec, xv);
    load_vec(gr + off, nc, sl.vec, gv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (j < nc) {
        const int c = c0 + j, g = n * sl.groups + c / cg;
        const float xh = __fmul_rn(__fsub_rn(xv[j], mean[g]), inv[g]);
        const float dxh = __fmul_rn(gv[j], scale[c]);
        const float t = __fsub_rn(__fsub_rn(__fmul_rn(denom, dxh), sdx[g]),
                                  __fmul_rn(xh, sdxx[g]));
        xv[j] = __fmul_rn(__fdiv_rn(inv[g], denom), t);
      }
    }
    store_vec(dx + off, nc, sl.vec, xv);
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

}  // namespace

// Blocks per sample of gn_stats and gn_bwd_reduce: enough for ~8 blocks
// per SM over the whole slab, each walking at least 8 row sweeps. The
// caller sizes the (N, B, 2, C) f32 workspace with it.
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

// partial: (N, B, 2, C) f32; nsum: (N, 2, C) f32; counters: n + 1 ints,
// zeroed by the caller.
extern "C" int gn_bwd_reduce(const void* x, const void* g, int dtype, int n,
                             long long s, int c, int groups,
                             const float* mean, const float* inv,
                             const float* scale, int nblocks, float* partial,
                             float* nsum, int* counters, float* dscale,
                             float* dbias, float* sdx, float* sdxx,
                             void* stream) {
  if (!shape_ok(n, s, c, groups, dtype) ||
      nblocks != gn_partial_blocks(n, s, c, dtype))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {x, g};
  const Slab sl = make_slab(n, s, c, groups, dtype, ptrs, 2);
  const dim3 grid(nblocks, n);
  const size_t smem = reduce_smem(c, dtype);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    gn_bwd_reduce_kernel<__nv_bfloat16><<<grid, THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(g), mean, inv, scale, sl, nblocks,
        partial, nsum, counters, dscale, dbias, sdx, sdxx);
  else
    gn_bwd_reduce_kernel<float><<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), mean,
        inv, scale, sl, nblocks, partial, nsum, counters, dscale, dbias, sdx,
        sdxx);
  return (int)cudaGetLastError();
}

extern "C" int gn_bwd_dx(const void* x, const void* g, int dtype, int n,
                         long long s, int c, int groups, const float* mean,
                         const float* inv, const float* scale,
                         const float* sdx, const float* sdxx, void* dx,
                         void* stream) {
  if (!shape_ok(n, s, c, groups, dtype)) return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {x, g, dx};
  const Slab sl = make_slab(n, s, c, groups, dtype, ptrs, 3);
  const float denom = (float)((double)s * (c / groups));
  const unsigned blocks = elementwise_blocks(n, s, c, dtype);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    gn_bwd_dx_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(g), mean, inv, scale, sdx, sdxx, sl,
        denom, static_cast<__nv_bfloat16*>(dx));
  else
    gn_bwd_dx_kernel<float><<<blocks, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), mean, inv,
        scale, sdx, sdxx, sl, denom, static_cast<float*>(dx));
  return (int)cudaGetLastError();
}
