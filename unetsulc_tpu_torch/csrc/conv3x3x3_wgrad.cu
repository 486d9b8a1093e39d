// Weight gradient of one input branch of the fused 'crg' conv block, for
// Hopper (sm_90a): dW[tap][ci][co] = sum over interior voxels v of
// xn[v + off(tap)][ci] * dconv[v][co], with xn recomputed from the raw
// buffer and its pending GroupNorm affine.
//
// Replaces: unetsulc_tpu/ops/conv_pallas.py `_wgrad_kernel` (launched by
// `conv_wgrad_shards`, reached through `_fused_bwd`) as
// `conv3x3x3_wgrad`, and its spatial-parallel mode (`halo`, `valid_in`,
// conv_pallas.py:1136-1145 and :1197-1240) as `conv3x3x3_wgrad_halo`.
//
// Layout. x: the branch's forward input, a padded channels-last buffer
// (X+2, Y+2, Z+2, cin) bf16 with a zero ring; ab: its (2, cin) f32 affine
// (row 0 = a, row 1 = b). xn = bf16(f32(x) * a + b) on the interior and 0
// on the ring, exactly kernel A's prologue. dconv: (X+2, Y+2, Z+2, cout)
// bf16, the cotangent of the conv's pre-activation, exactly 0 on the ring,
// so only interior voxels contribute. dW: (27, cin, cout) f32, zeroed by
// the caller; tap = dx*9 + dy*3 + dz, off(tap) = (dx-1, dy-1, dz-1).
//
// Halo mode (a shard's slab of the volume along X,
// `unetsulc_tpu_torch/parallel/sp_fused.py`): x's planes 0 and X+1 are the
// neighbours' boundary planes, passed as the separate (Y+2, Z+2, cin)
// operands lo and hi, and valid ((X+2,) f32) says which planes hold data:
// xn on a ring plane is normalized as an interior plane where valid is 1
// and is 0 where it is 0 (the global volume's edge), as kernel A reads it.
// dconv's ring is still 0, so only interior voxels v contribute.
//
// GEMM view, per tap: M = cin, N = cout, K = interior voxels (884,736 at
// 96^3) — a small output over a very long contraction. A block owns one
// (tap, 64-channel cin tile, 64-channel cout tile) and one contiguous
// range of voxels (split-K): the grid is (27 x cin tiles x cout tiles,
// splits), with the split count chosen so that ~8 blocks per SM are in
// flight. Each K step stages 32 voxels of xn (as the transposed A tile,
// read col-major by wmma) and of dconv in shared memory and runs
// 16x16x16 bf16 wmma fragments with f32 accumulation. Each block adds its
// f32 tile into dW with one atomicAdd per element: the split partial sums
// meet in an order that varies from run to run, so the result is not
// bitwise deterministic (its f32 rounding differs by a few ulps between
// runs).
//
// What bounds it on this card: operations, 2 * voxels * 27 * cin * cout
// FLOP, as the branch's forward conv; the bytes (x and dconv once, dW
// once) are ~0.3 GB at the flagship's largest launch. This first version
// has no cp.async/TMA pipeline and no wgmma; it reaches a fraction of the
// tensor-core rate (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64;  // input channels (rows of dW) per block
constexpr int BN = 64;  // output channels per block
constexpr int BK = 32;  // voxels per K step
constexpr int THREADS = 128;
constexpr int LDA = BM + 8;  // smem leading dims, padded against bank conflicts
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;
constexpr int TARGET_BLOCKS = 132 * 8;
constexpr long long MIN_SPLIT = 1024;  // voxels per block, at least

constexpr int SMEM_AB = (BK * LDA + BK * LDB) * 2;
constexpr int SMEM_C = BM * LDC * 4;
constexpr int SMEM_BYTES = SMEM_AB > SMEM_C ? SMEM_AB : SMEM_C;

__device__ __forceinline__ __nv_bfloat16 norm_bf16(__nv_bfloat16 v, float a,
                                                   float b) {
  // as kernel A: (f32(x) * a) + b with explicit roundings, one bf16 cast
  return __float2bfloat16(__fadd_rn(__fmul_rn(__bfloat162float(v), a), b));
}

// Loads 16 channels [c0, c0 + 16) of one voxel's row into dst, zero past c
// or when !ok, normalizing with (a, b) when `norm`.
__device__ __forceinline__ void load16(const __nv_bfloat16* __restrict__ src,
                                       bool ok, int c0, int c, bool vec,
                                       bool norm, const float* a,
                                       const float* b, __nv_bfloat16* dst) {
  __align__(16) __nv_bfloat16 vals[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) vals[j] = __float2bfloat16(0.0f);
  if (ok) {
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int cg = c0 + g * 8;
      if (vec && cg + 8 <= c) {
        const uint4 u = *reinterpret_cast<const uint4*>(src + g * 8);
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          vals[g * 8 + j] =
              norm ? norm_bf16(h[j], a[g * 8 + j], b[g * 8 + j]) : h[j];
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (cg + j < c)
            vals[g * 8 + j] =
                norm ? norm_bf16(src[g * 8 + j], a[g * 8 + j], b[g * 8 + j])
                     : src[g * 8 + j];
      }
    }
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = reinterpret_cast<const uint4*>(vals)[0];
  d[1] = reinterpret_cast<const uint4*>(vals)[1];
}

__global__ void __launch_bounds__(THREADS)
    conv3x3x3_wgrad_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ lo,
                           const __nv_bfloat16* __restrict__ hi,
                           const float* __restrict__ valid,
                           const float* __restrict__ ab, int cin,
                           const __nv_bfloat16* __restrict__ dconv, int cout,
                           int X, int Y, int Z, long long chunk,
                           float* __restrict__ dw) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);  // [BK][LDA]
  __nv_bfloat16* sB = sA + BK * LDA;                            // [BK][LDB]
  float* sC = reinterpret_cast<float*>(smem);                   // [BM][LDC]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int mt = (cin + BM - 1) / BM, nt = (cout + BN - 1) / BN;
  const int tap = blockIdx.x / (mt * nt);
  const int rem = blockIdx.x % (mt * nt);
  const int m0 = (rem / nt) * BM;  // first cin channel
  const int n0 = (rem % nt) * BN;  // first cout channel
  const int dx = tap / 9, dy = (tap / 3) % 3, dz = tap % 3;
  const long long M = (long long)X * Y * Z;
  const long long k0 = (long long)blockIdx.y * chunk;
  const long long k1 = k0 + chunk < M ? k0 + chunk : M;
  const int Yp = Y + 2, Zp = Z + 2;

  // loaders: one voxel row (of BK) and 16 channels (of 64) per thread
  const int kr = tid >> 2;
  const int kc = (tid & 3) * 16;
  const bool vec_x = (cin % 8) == 0, vec_d = (cout % 8) == 0;
  float a[16], b[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const bool ok = m0 + kc + j < cin;
    a[j] = ok ? ab[m0 + kc + j] : 0.0f;
    b[j] = ok ? ab[cin + m0 + kc + j] : 0.0f;
  }

  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (long long k = k0; k < k1; k += BK) {
    const long long m = k + kr;
    bool in_x = false, in_d = false;
    const __nv_bfloat16* srcx = x;
    const __nv_bfloat16* srcd = dconv;
    if (m < k1) {
      const int vz = (int)(m % Z);
      const long long t = m / Z;
      const int vy = (int)(t % Y), vx = (int)(t / Y);
      // interior voxel v sits at padded v + 1; its tap reads padded v + d
      const int px = vx + dx, py = vy + dy, pz = vz + dz;
      const bool plane_ok =
          valid != nullptr ? px >= 0 && px <= X + 1 && valid[px] != 0.0f
                           : px >= 1 && px <= X;
      in_x = plane_ok && py >= 1 && py <= Y && pz >= 1 && pz <= Z;
      const long long yz = (long long)py * Zp + pz;
      if (valid != nullptr && px == 0)
        srcx = lo + yz * cin + m0 + kc;
      else if (valid != nullptr && px == X + 1)
        srcx = hi + yz * cin + m0 + kc;
      else
        srcx = x + ((long long)px * Yp * Zp + yz) * cin + m0 + kc;
      srcd = dconv +
             ((long long)((vx + 1) * Yp + vy + 1) * Zp + vz + 1) * cout + n0 +
             kc;
      in_d = true;
    }
    load16(srcx, in_x, m0 + kc, cin, vec_x, true, a, b, sA + kr * LDA + kc);
    load16(srcd, in_d, n0 + kc, cout, vec_d, false, a, b, sB + kr * LDB + kc);
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // A = xn^T (cin x voxels): sA holds it voxel-major, i.e. col-major
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major>
          fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], sA + kk * LDA + wm + i * 16, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], sB + kk * LDB + wn + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: fragments -> smem (aliases the A/B tiles; every warp is past
  // the K loop's last __syncthreads) -> one atomicAdd per element
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sC + (wm + i * 16) * LDC + wn + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  float* out = dw + (long long)tap * cin * cout;
  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, n = idx % BN;
    if (m0 + r < cin && n0 + n < cout)
      atomicAdd(out + (long long)(m0 + r) * cout + n0 + n, sC[r * LDC + n]);
  }
}

int launch_wgrad(const void* x, const void* lo, const void* hi,
                 const float* valid, const float* ab, int cin,
                 const void* dconv, int cout, int X, int Y, int Z, float* dw,
                 void* stream) {
  const long long M = (long long)X * Y * Z;
  const int tiles = 27 * ((cin + BM - 1) / BM) * ((cout + BN - 1) / BN);
  long long splits = (TARGET_BLOCKS + tiles - 1) / tiles;
  const long long most = (M + MIN_SPLIT - 1) / MIN_SPLIT;
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  long long chunk = (M + splits - 1) / splits;
  chunk = (chunk + BK - 1) / BK * BK;
  splits = (M + chunk - 1) / chunk;
  const dim3 grid((unsigned)tiles, (unsigned)splits);
  conv3x3x3_wgrad_kernel<<<grid, THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(lo),
      static_cast<const __nv_bfloat16*>(hi), valid, ab, cin,
      static_cast<const __nv_bfloat16*>(dconv), cout, X, Y, Z, chunk, dw);
  return (int)cudaGetLastError();
}

}  // namespace

// x (X+2, Y+2, Z+2, cin) bf16, ab (2, cin) f32, dconv (X+2, Y+2, Z+2, cout)
// bf16 -> dw (27, cin, cout) f32, which the caller zeroes.
extern "C" int conv3x3x3_wgrad(const void* x, const float* ab, int cin,
                               const void* dconv, int cout, int X, int Y,
                               int Z, float* dw, void* stream) {
  return launch_wgrad(x, nullptr, nullptr, nullptr, ab, cin, dconv, cout, X,
                      Y, Z, dw, stream);
}

// Halo mode: as conv3x3x3_wgrad, with x's planes 0 and X+1 read from lo and
// hi ((Y+2, Z+2, cin) bf16; may be null where valid marks the plane
// invalid) and valid (X+2,) f32 the plane validity.
extern "C" int conv3x3x3_wgrad_halo(const void* x, const void* lo,
                                    const void* hi, const float* valid,
                                    const float* ab, int cin,
                                    const void* dconv, int cout, int X, int Y,
                                    int Z, float* dw, void* stream) {
  return launch_wgrad(x, lo, hi, valid, ab, cin, dconv, cout, X, Y, Z, dw,
                      stream);
}
