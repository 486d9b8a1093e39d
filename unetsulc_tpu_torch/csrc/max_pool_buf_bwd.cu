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
// dx, x's shape, bf16, every element written here (ring included: the
// caller allocates it uninitialised); dab (2, C) f32 = (sum f32(x) * d,
// sum d) per channel, written by the fold, untouched when ab is null.
//
// What bounds it on this card: bytes. It reads x's interior and the
// pooled out and cot once, and writes dx once with its ring, a few
// operations per byte; at 96^3 x 64 that is ~264 MB, ~79 us at 3.35 TB/s.
//
// Design: one wave of blocks, mirrored by kernels/layout.py (pool_bwd_plan,
// checked against max_pool_buf_bwd_tile when the library is loaded).
//   - B = min(V, SMs * BLOCKS_PER_SM) blocks over the V = OX * OY * OZ
//     pooled voxels in (x, y, z) order: block b owns voxels [b V / B,
//     (b + 1) V / B), so blocks differ by at most one voxel and a block's
//     windows are runs of whole (Zp, C) rows of x and dx.
//   - Each thread owns one 16-byte channel vector cv of 8 channels and one
//     of R = THREADS / (C / 8) voxel lanes, fixed for the launch; lane r
//     takes the block's voxels r, r + R, ... Per voxel it issues its eight
//     window loads (the interior ones) and out's and cot's up front, then
//     resolves the first match in registers in (x, y, z) window order with
//     the forward's arithmetic (bf16(f32(x) * a + b), __fmul_rn /
//     __fadd_rn: kernel B's values, compared exactly, torch's tie rule,
//     conv_pallas.py:1746-1757) and stores bf16(d * a) (bf16(d) without an
//     affine) at the hit and 0 at the other seven positions.
//   - Along each axis a pooled index o owns the padded coordinates
//     [2o, 2o + 2), the last one [2o, E + 2): its window, and for an odd
//     extent E the ring plane that no window covers. So the voxels' boxes
//     tile the whole padded buffer: every dx element, ring included, is
//     written exactly once, and the caller needs no zero fill.
//   - Channels that are not whole 16-byte vectors (C % 8) take the same
//     order through scalar loads and stores.
//   - d(affine), only with an affine: each thread adds its voxels' f32(x)
//     * d and d in voxel order; a pairwise tree over the R lanes gives the
//     block's partial (2, C); every block takes a ticket, and the last F =
//     min(units, max(1, min(B, SMs) / 2)) blocks wait for all tickets and
//     fold in parallel, unit u (columns [8u, 8u + 8) of the partials) by
//     block u % F: column i summed over partials k, k + 32, ... by thread
//     8k + i, then a pairwise tree over the 32 segments (fold.cuh), written
//     into dab. The order depends only on the shapes, so dab is the same in
//     every run, and dx is exact. The ticket counter, one int after the
//     partials in the caller's workspace, is zeroed by a memset ahead of
//     the kernel (a counter the kernel reset itself would be shared by CUDA
//     graphs replayed on other streams). Waiting is safe: at most half the
//     resident blocks wait, and every other block finishes without waiting.
// A call is the memset (with an affine) and this kernel: no zero fill of
// dx or dab, no second launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fold.cuh"

namespace {

// threads per block, blocks per SM, partial columns per fold unit, and
// partials a folding thread loads at once (mirrored by kernels/layout.py)
constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 2;
constexpr int FOLD_COLS = 8;
constexpr int FOLD_SEGS = THREADS / FOLD_COLS;
constexpr int FOLD_BATCH = 4;

using bf16 = __nv_bfloat16;

struct Geo {
  int c;               // channels
  int X, Y, Z;         // interior extents of x
  int OX, OY, OZ;      // interior extents of the pooled output
  long long voxels;    // OX * OY * OZ
};

// The launch plan (kernels/layout.py pool_bwd_plan)
struct Plan {
  int blocks;   // B
  int lanes;    // R: voxels a block walks together
  int folders;  // F: blocks that fold dab
};

__host__ __device__ int vectors(int c) { return (c + 7) / 8; }

bool shape_ok(int c, int X, int Y, int Z, int sms) {
  return c > 0 && vectors(c) <= THREADS && X > 0 && Y > 0 && Z > 0 &&
         sms > 0;
}

Geo make_geo(int c, int X, int Y, int Z) {
  Geo g{c, X, Y, Z, X / 2 + 1, Y / 2 + 1, Z / 2 + 1, 0};
  g.voxels = (long long)g.OX * g.OY * g.OZ;
  return g;
}

__host__ __device__ int fold_units(int c) {
  return (2 * c + FOLD_COLS - 1) / FOLD_COLS;
}

Plan make_plan(const Geo& g, int sms) {
  const long long cap = (long long)sms * BLOCKS_PER_SM;
  Plan p;
  p.blocks = (int)(g.voxels < cap ? g.voxels : cap);
  p.lanes = THREADS / vectors(g.c);
  int f = (p.blocks < sms ? p.blocks : sms) / 2;
  if (f < 1) f = 1;
  p.folders = fold_units(g.c) < f ? fold_units(g.c) : f;
  return p;
}

// f32 workspace of a launch with an affine: the (B, 2, C) partials, then
// the ticket counter
long long workspace_floats(const Geo& g, const Plan& p) {
  return (long long)p.blocks * 2 * g.c + 1;
}

// 8 channels of one position: a 16-byte vector (VEC), else nc scalars and
// zeros past them
template <bool VEC>
__device__ __forceinline__ uint4 load8(const bf16* src, int nc) {
  if constexpr (VEC) {
    return __ldg(reinterpret_cast<const uint4*>(src));
  } else {
    __align__(16) bf16 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = j < nc ? src[j] : __float2bfloat16(0.0f);
    return *reinterpret_cast<const uint4*>(v);
  }
}

template <bool VEC>
__device__ __forceinline__ void store8(bf16* dst, int nc, uint4 v) {
  if constexpr (VEC) {
    *reinterpret_cast<uint4*>(dst) = v;
  } else {
    const bf16* e = reinterpret_cast<const bf16*>(&v);
    for (int j = 0; j < nc; ++j) dst[j] = e[j];
  }
}

__device__ __forceinline__ float elem(const uint4& v, int j) {
  return __bfloat162float(reinterpret_cast<const bf16*>(&v)[j]);
}

template <bool VEC, bool AB>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    max_pool_buf_bwd_kernel(const bf16* __restrict__ x,
                            const float* __restrict__ ab,
                            const bf16* __restrict__ out,
                            const bf16* __restrict__ cot, Geo g, Plan pl,
                            bf16* __restrict__ dx, float* __restrict__ partial,
                            int* __restrict__ counter,
                            float* __restrict__ dab) {
  // the lanes' (da, db) of every channel, then the fold's segments
  __shared__ float red[THREADS * 16];
  __shared__ int ticket;
  const int tid = threadIdx.x;
  const int cvs = vectors(g.c), cpad = cvs * 8;
  const int cv = tid % cvs, r = tid / cvs;
  const bool active = r < pl.lanes;
  const int c0 = cv * 8, nc = g.c - c0 < 8 ? g.c - c0 : 8;
  const int Yp = g.Y + 2, Zp = g.Z + 2;
  const long long sy = (long long)Zp * g.c, sx = (long long)Yp * sy;
  const long long v0 = (long long)blockIdx.x * g.voxels / pl.blocks;
  const long long v1 = (long long)(blockIdx.x + 1) * g.voxels / pl.blocks;

  float a[8], b[8], da[8], db[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a[j] = (AB && active && j < nc) ? ab[c0 + j] : 1.0f;
    b[j] = (AB && active && j < nc) ? ab[g.c + c0 + j] : 0.0f;
    da[j] = 0.0f;
    db[j] = 0.0f;
  }

  long long v = v0 + r;
  if (active && v < v1) {
    int oz = (int)(v % g.OZ);
    long long t = v / g.OZ;
    int oy = (int)(t % g.OY), ox = (int)(t / g.OY);
    for (; v < v1; v += pl.lanes) {
      // the window's corner and the pooled voxel, at channel c0
      const long long base =
          (((long long)(2 * ox) * Yp + 2 * oy) * Zp + 2 * oz) * g.c + c0;
      const long long ob =
          (((long long)(ox + 1) * (g.OY + 2) + oy + 1) * (g.OZ + 2) + oz + 1) *
              g.c + c0;
      // every load of the voxel in flight before any is used
      uint4 xv[8];
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        const int px = 2 * ox + (w >> 2), py = 2 * oy + ((w >> 1) & 1),
                  pz = 2 * oz + (w & 1);
        const bool in = px >= 1 && px <= g.X && py >= 1 && py <= g.Y &&
                        pz >= 1 && pz <= g.Z;
        xv[w] = in ? load8<VEC>(x + base + (w >> 2) * sx +
                                    ((w >> 1) & 1) * sy + (w & 1) * g.c,
                                nc)
                   : make_uint4(0u, 0u, 0u, 0u);
      }
      const uint4 ov = load8<VEC>(out + ob, nc), dv = load8<VEC>(cot + ob, nc);

      bool taken[8];
      float hx[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        taken[j] = false;
        hx[j] = 0.0f;
      }
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        const int px = 2 * ox + (w >> 2), py = 2 * oy + ((w >> 1) & 1),
                  pz = 2 * oz + (w & 1);
        const bool in = px >= 1 && px <= g.X && py >= 1 && py <= g.Y &&
                        pz >= 1 && pz <= g.Z;
        __align__(16) bf16 res[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xf = elem(xv[w], j);
          // the forward's value: as kernel B, one rounded affine
          const float f =
              AB ? __bfloat162float(__float2bfloat16(
                       __fadd_rn(__fmul_rn(xf, a[j]), b[j])))
                 : xf;
          const bool hit = in && j < nc && !taken[j] && f == elem(ov, j);
          taken[j] = taken[j] || hit;
          hx[j] = hit ? xf : hx[j];
          const float d = elem(dv, j);
          res[j] = __float2bfloat16(hit ? (AB ? __fmul_rn(d, a[j]) : d)
                                        : 0.0f);
        }
        store8<VEC>(dx + base + (w >> 2) * sx + ((w >> 1) & 1) * sy +
                        (w & 1) * g.c,
                    nc, *reinterpret_cast<const uint4*>(res));
      }
      if constexpr (AB) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float d = taken[j] ? elem(dv, j) : 0.0f;
          da[j] = __fadd_rn(da[j], __fmul_rn(hx[j], d));
          db[j] = __fadd_rn(db[j], d);
        }
      }
      // the ring planes past the last window of an odd extent
      const int nx = ox == g.OX - 1 ? g.X + 2 - 2 * ox : 2;
      const int ny = oy == g.OY - 1 ? g.Y + 2 - 2 * oy : 2;
      const int nz = oz == g.OZ - 1 ? g.Z + 2 - 2 * oz : 2;
      if (nx > 2 || ny > 2 || nz > 2) {
        for (int wx = 0; wx < nx; ++wx)
          for (int wy = 0; wy < ny; ++wy)
            for (int wz = 0; wz < nz; ++wz)
              if (wx == 2 || wy == 2 || wz == 2)
                store8<VEC>(dx + base + wx * sx + wy * sy + wz * g.c, nc,
                            make_uint4(0u, 0u, 0u, 0u));
      }
      // the next voxel of the lane: pl.lanes further in (x, y, z) order
      oz += pl.lanes;
      if (oz >= g.OZ) {
        const int q = oz / g.OZ;
        oz -= q * g.OZ;
        oy += q;
        if (oy >= g.OY) {
          const int q2 = oy / g.OY;
          oy -= q2 * g.OY;
          ox += q2;
        }
      }
    }
  }
  if constexpr (!AB) return;

  // the block's partial: a pairwise tree over the lanes, lane r's row
  // holding its da, then its db
  const int width = 2 * cpad;
  if (active) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      red[r * width + c0 + j] = da[j];
      red[r * width + cpad + c0 + j] = db[j];
    }
  }
  __syncthreads();
  fold::tree_rows<8, 2>(red, width, pl.lanes, r, c0, cpad, active);
  float* row = partial + (long long)blockIdx.x * 2 * g.c;
  for (int i = tid; i < g.c; i += THREADS) {
    row[i] = red[i];
    row[g.c + i] = red[cpad + i];
  }

  // tickets: the last F blocks fold. The fence of thread 0 after the
  // barrier publishes the whole block's partial.
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    ticket = atomicAdd(counter, 1);
  }
  __syncthreads();
  const int role = ticket - (pl.blocks - pl.folders);
  if (role < 0) return;

  const int col = tid % FOLD_COLS, k = tid / FOLD_COLS;
  const int cols = 2 * g.c;
  for (int u = role; u < fold_units(g.c); u += pl.folders) {
    if (u == role) fold::wait_tickets(counter, pl.blocks);
    __syncthreads();
    const int cc = u * FOLD_COLS + col;
    float t = 0.0f;
    if (cc < cols) {
      for (int b0 = k; b0 < pl.blocks; b0 += FOLD_BATCH * FOLD_SEGS) {
        float pv[FOLD_BATCH];
#pragma unroll
        for (int i = 0; i < FOLD_BATCH; ++i) {
          const int bb = b0 + i * FOLD_SEGS;
          pv[i] = bb < pl.blocks ? __ldcg(partial + (long long)bb * cols + cc)
                                 : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < FOLD_BATCH; ++i)
          if (b0 + i * FOLD_SEGS < pl.blocks) t = __fadd_rn(t, pv[i]);
      }
    }
    red[k * FOLD_COLS + col] = t;
    __syncthreads();
    fold::tree_rows<1, 1>(red, FOLD_COLS, FOLD_SEGS, k, col, 0, true);
    if (tid < FOLD_COLS && u * FOLD_COLS + tid < cols)
      dab[u * FOLD_COLS + tid] = red[tid];
    __syncthreads();
  }
}

template <bool VEC, bool AB>
void launch(const void* x, const float* ab, const void* out, const void* cot,
            const Geo& g, const Plan& p, void* dx, float* partial,
            int* counter, float* dab, cudaStream_t st) {
  max_pool_buf_bwd_kernel<VEC, AB><<<p.blocks, THREADS, 0, st>>>(
      static_cast<const bf16*>(x), ab, static_cast<const bf16*>(out),
      static_cast<const bf16*>(cot), g, p, static_cast<bf16*>(dx), partial,
      counter, dab);
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// The plan, mirrored by kernels/layout.py: what 0 THREADS, 1
// BLOCKS_PER_SM, 2 FOLD_COLS, 3 FOLD_BATCH; for (c, X, Y, Z) on `sms` SMs:
// 4 blocks, 5 voxel lanes, 6 folding blocks, 7 the f32 workspace of a
// launch with an affine; -1 for another `what` or a shape the kernel does
// not take.
extern "C" int max_pool_buf_bwd_tile(int what, int c, int X, int Y, int Z,
                                     int sms) {
  switch (what) {
    case 0: return THREADS;
    case 1: return BLOCKS_PER_SM;
    case 2: return FOLD_COLS;
    case 3: return FOLD_BATCH;
  }
  if (!shape_ok(c, X, Y, Z, sms)) return -1;
  const Geo g = make_geo(c, X, Y, Z);
  const Plan p = make_plan(g, sms);
  switch (what) {
    case 4: return p.blocks;
    case 5: return p.lanes;
    case 6: return p.folders;
    case 7: {
      const long long n = workspace_floats(g, p);
      return n > 0x7fffffffLL ? -1 : (int)n;
    }
    default: return -1;
  }
}

// sms: the device's SMs; ws: max_pool_buf_bwd_tile(7, ...) f32 when ab is
// given, else unused. dx and dab need no initial value.
extern "C" int max_pool_buf_bwd(const void* x, const float* ab,
                                const void* out, const void* cot, int c,
                                int X, int Y, int Z, int sms, void* dx,
                                float* dab, float* ws, void* stream) {
  if (!shape_ok(c, X, Y, Z, sms)) return (int)cudaErrorInvalidValue;
  const Geo g = make_geo(c, X, Y, Z);
  const Plan p = make_plan(g, sms);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = c % 8 == 0 && aligned(x) && aligned(out) &&
                   aligned(cot) && aligned(dx);
  int* counter = nullptr;
  if (ab != nullptr) {
    counter = reinterpret_cast<int*>(ws + (long long)p.blocks * 2 * c);
    const cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
  }
  if (vec && ab != nullptr)
    launch<true, true>(x, ab, out, cot, g, p, dx, ws, counter, dab, st);
  else if (vec)
    launch<true, false>(x, ab, out, cot, g, p, dx, ws, counter, dab, st);
  else if (ab != nullptr)
    launch<false, true>(x, ab, out, cot, g, p, dx, ws, counter, dab, st);
  else
    launch<false, false>(x, ab, out, cot, g, p, dx, ws, counter, dab, st);
  return (int)cudaGetLastError();
}
