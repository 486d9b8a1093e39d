// Backward of the torch-padded MaxPool3d(kernel 2, stride 2, padding 1) on
// a padded channels-last buffer with a pending GroupNorm affine: routes
// the pooled cotangent to the first window position that held the max,
// scales it by the affine's a, and reduces the affine's gradient.
//
// Replaces: unetsulc_tpu/ops/conv_pallas.py `_pool_bwd_kernel` (launched by
// `_max_pool_buf_bwd`, the VJP of `max_pool_buf`).
//
// Inputs: x (X+2, Y+2, Z+2, C) bf16 with a zero ring, the forward's input;
// ab (2, C) f32 or null; out (X//2+3, Y//2+3, Z//2+3, C) bf16, the
// forward's output (kernel B's); cot, its cotangent, same shape. Outputs:
// dx, x's shape, bf16, zeroed by the caller; dab (2, C) f32, zeroed by the
// caller, untouched when ab is null.
//
// One thread owns one pooled voxel o and a group of 8 channels, as kernel
// B does. It recomputes the 8 window values bf16(f32(x) * a + b) at padded
// coordinates 2o, 2o+1 per axis in (x, y, z) lexicographic order, skipping
// positions outside the input interior (the forward's -inf pads), and
// gives cot[o] to the FIRST position whose value equals out[o] (exact bf16
// compare: torch's tie rule, conv_pallas.py:1746-1757). It writes
// bf16(d * a) (bf16(d) without an affine) at every interior position of
// its window, 0 where not selected. Each interior coordinate lies in
// exactly one window, so the writes are disjoint and need no atomics; the
// ring stays as the caller zeroed it. da = sum f32(x) * d and db = sum d
// per channel: each thread's sums go to shared memory, the block adds its
// threads' sums per channel in thread order into its row of the caller's
// (blocks, 2, C) f32 workspace, and a fold (fold.cuh) adds the rows in a
// fixed order: no atomics, so dab is the same in every run; dx is exact.
//
// What bounds it on this card: bytes. It reads x's interior and the
// pooled out and cot once, and writes dx once, with a few operations per
// byte; at 96^3 x 64 that is ~0.27 GB, ~80 us at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fold.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ void load8(const __nv_bfloat16* src, int nc,
                                      bool vec, __nv_bfloat16* v) {
  if (vec) {
    *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(src);
  } else {
    for (int j = 0; j < nc; ++j) v[j] = src[j];
  }
}

__global__ void __launch_bounds__(THREADS)
    max_pool_buf_bwd_kernel(const __nv_bfloat16* __restrict__ x,
                            const float* __restrict__ ab,
                            const __nv_bfloat16* __restrict__ out,
                            const __nv_bfloat16* __restrict__ cot, int c,
                            int X, int Y, int Z, __nv_bfloat16* __restrict__ dx,
                            float* __restrict__ partial) {
  // each thread's da (columns 0-7) and db (8-15) of its 8 channels
  __shared__ float s_sums[THREADS][17];
  const bool has_ab = ab != nullptr;

  const int OX = X / 2 + 1, OY = Y / 2 + 1, OZ = Z / 2 + 1;
  const int groups = (c + 7) / 8;
  const long long total = (long long)OX * OY * OZ * groups;
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx < total) {
    const int g = (int)(idx % groups);
    long long t = idx / groups;
    const int oz = (int)(t % OZ);
    t /= OZ;
    const int oy = (int)(t % OY);
    const int ox = (int)(t / OY);
    const int c0 = g * 8;
    const int nc = c - c0 < 8 ? c - c0 : 8;
    const bool vec = (c % 8) == 0;
    const int Yp = Y + 2, Zp = Z + 2;
    const int OYp = OY + 2, OZp = OZ + 2;

    const long long o_off =
        ((long long)((ox + 1) * OYp + oy + 1) * OZp + oz + 1) * c + c0;
    __align__(16) __nv_bfloat16 ov[8], dv[8];
    load8(out + o_off, nc, vec, ov);
    load8(cot + o_off, nc, vec, dv);
    float a[8], b[8], best[8], d[8], da[8], db[8];
    bool taken[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      a[j] = (has_ab && j < nc) ? ab[c0 + j] : 1.0f;
      b[j] = (has_ab && j < nc) ? ab[c + c0 + j] : 0.0f;
      best[j] = j < nc ? __bfloat162float(ov[j]) : 0.0f;
      d[j] = j < nc ? __bfloat162float(dv[j]) : 0.0f;
      da[j] = 0.0f;
      db[j] = 0.0f;
      taken[j] = false;
    }
    for (int wx = 0; wx < 2; ++wx) {
      const int px = 2 * ox + wx;
      if (px < 1 || px > X) continue;
      for (int wy = 0; wy < 2; ++wy) {
        const int py = 2 * oy + wy;
        if (py < 1 || py > Y) continue;
        for (int wz = 0; wz < 2; ++wz) {
          const int pz = 2 * oz + wz;
          if (pz < 1 || pz > Z) continue;
          const long long off = ((long long)(px * Yp + py) * Zp + pz) * c + c0;
          __align__(16) __nv_bfloat16 v[8], o[8];
          load8(x + off, nc, vec, v);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float xf = __bfloat162float(v[j]);
            // the forward's value: as kernel B, one rounded affine
            const float f =
                has_ab ? __bfloat162float(__float2bfloat16(
                             __fadd_rn(__fmul_rn(xf, a[j]), b[j])))
                       : xf;
            const bool hit = j < nc && !taken[j] && f == best[j];
            taken[j] = taken[j] || hit;
            const float dj = hit ? d[j] : 0.0f;
            o[j] = __float2bfloat16(has_ab ? __fmul_rn(dj, a[j]) : dj);
            da[j] += xf * dj;
            db[j] += dj;
          }
          if (vec) {
            *reinterpret_cast<uint4*>(dx + off) =
                *reinterpret_cast<const uint4*>(o);
          } else {
            for (int j = 0; j < nc; ++j) dx[off + j] = o[j];
          }
        }
      }
    }
    if (has_ab) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s_sums[threadIdx.x][j] = da[j];
        s_sums[threadIdx.x][8 + j] = db[j];
      }
    }
  } else if (has_ab) {
#pragma unroll
    for (int j = 0; j < 16; ++j) s_sums[threadIdx.x][j] = 0.0f;
  }
  if (!has_ab) return;
  __syncthreads();
  // row i of the block's partials: channel ch of da (i < c) or of db; the
  // threads that own ch's group of 8 are every `groups`-th thread from the
  // first of them, summed in thread order
  const int base = (int)(((long long)blockIdx.x * THREADS) % groups);
  float* row = partial + (long long)blockIdx.x * 2 * c;
  for (int i = threadIdx.x; i < 2 * c; i += THREADS) {
    const int which = i / c, ch = i % c;
    const int g = ch / 8, j = which * 8 + ch % 8;
    float t = 0.0f;
    for (int k = (g - base + groups) % groups; k < THREADS; k += groups)
      t += s_sums[k][j];
    row[i] = t;
  }
}

long long blocks_of(int c, int X, int Y, int Z) {
  const long long total =
      (long long)(X / 2 + 1) * (Y / 2 + 1) * (Z / 2 + 1) * ((c + 7) / 8);
  return (total + THREADS - 1) / THREADS;
}

}  // namespace

// f32 workspace of one launch with an affine (none without); -1 if it does
// not fit an int.
extern "C" int max_pool_buf_bwd_ws(int c, int X, int Y, int Z) {
  const long long rows = blocks_of(c, X, Y, Z), cols = 2LL * c;
  const long long n = rows * cols + fold::scratch_floats(rows, cols);
  return n > 0x7fffffffLL ? -1 : (int)n;
}

// ws: max_pool_buf_bwd_ws(c, X, Y, Z) f32 when ab is given, else unused.
extern "C" int max_pool_buf_bwd(const void* x, const float* ab,
                                const void* out, const void* cot, int c,
                                int X, int Y, int Z, void* dx, float* dab,
                                float* ws, void* stream) {
  const long long blocks = blocks_of(c, X, Y, Z);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  max_pool_buf_bwd_kernel<<<(unsigned)blocks, THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), ab,
      static_cast<const __nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(cot), c, X, Y, Z,
      static_cast<__nv_bfloat16*>(dx), ws);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ab == nullptr) return (int)err;
  const long long cols = 2LL * c;
  return (int)fold::fold_cols(ws, blocks, cols, ws + blocks * cols, dab, st);
}
