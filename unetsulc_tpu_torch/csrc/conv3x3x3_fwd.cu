// Fused 'crg' conv block forward for Hopper (sm_90a): lazy-GroupNorm
// prologue -> 3x3x3 conv (implicit GEMM on bf16 tensor cores) -> bias ->
// ReLU -> per-channel stat sums, over a padded channels-last buffer; and,
// from the same tile loop, the block's input-gradient (dx) pass.
//
// Replaces: unetsulc_tpu/ops/conv_pallas.py `_fwd_kernel` in forward mode
// (launched by `conv_shards`, reached through `fused_conv_block`) as
// `conv3x3x3_fwd` (kernel A), and `_fwd_kernel` in post (dx) mode
// (`conv_shards(post_ab=..., post_x=...)` from `_fused_bwd`) as
// `conv3x3x3_dx` (kernel C).
//
// Layout. Each input is a padded channels-last buffer (X+2, Y+2, Z+2, C)
// bf16 whose 1-voxel ring is the conv's zero padding; `ab` is the pending
// GroupNorm affine of that input, (2, C) f32 (row 0 = a, row 1 = b). The
// output y has the same geometry with Cout channels; the caller zeroes it,
// and the kernel writes only the interior, so the ring stays exactly 0.
// `sums` is (2, Cout) f32, zeroed by the caller: per-channel sum and sum
// of squares of the f32 output before its bf16 cast.
//
// GEMM view. M = interior output voxels in (x, y, z) row-major order,
// N = Cout, K = 27 taps x Cin. A block computes a BM x BN tile; its K loop
// runs over the inputs (one or two: the decoder's skip and upsampled
// tensors, each with its own affine and weight rows, accumulated in the
// same f32 fragments, so the channel concat never exists), then over
// BK-channel chunks, then over the 27 taps. While it stages an A tile in
// shared memory it applies the affine exactly as `_norm_plane` does:
// bf16((f32(x) * a + b) * interior_mask), with the ring read as 0 (never
// +b). Weights arrive packed by the wrapper as (27, Ktot, Npad) bf16, each
// input's channel rows zero-padded to a multiple of BK and Cout to a
// multiple of BN, so B tiles load without bounds checks.
//
// dx mode (kernel C, template flag DX). The input is the conv's cotangent
// dconv = 1[y > 0] * (dy + ds0 + 2 y ds1) in bf16, whose ring is exactly
// 0, read without an affine; the weights are one branch's mirrored and
// transposed taps, Wt[tap][co][ci] = W[ci][co][26 - tap] (packed by the
// wrapper in the same layout), so the tile loop computes the transposed
// conv dxn = conv^T(dconv, W) for that branch's Cin channels. No bias and
// no ReLU. The epilogue takes the f32 dxn of each interior voxel and adds
// sum(post_x * dxn) and sum(dxn) per channel into `sums` (post_x: the
// branch's raw bf16 forward input), then writes bf16(dxn * a) (a: row 0
// of the branch's forward affine): the gradients of x and of its affine,
// as conv_pallas.py:519-545 does.
//
// What bounds it on this card: operations. At the flagship 96^3 shapes a
// launch does 2 * voxels * 27 * Cin * Cout FLOP (0.59 TFLOP for decoder
// 2's 192->64 pair conv) against ~0.3 GB of traffic, far above the
// ~295 FLOP/byte ridge of the H100, so the floor is the bf16 tensor-core
// rate; the dx pass does the same FLOP as its branch's forward. This
// first version is the simple one: nvcuda::wmma 16x16x16 bf16
// fragments fed from shared memory, one K step per __syncthreads pair, no
// cp.async/TMA pipeline and no wgmma; it reaches a fraction of that rate
// (PERF.md). The sums reduce over the block's rows in shared memory
// and take one atomicAdd per channel per block, so their summation order
// varies from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64;    // output voxels per block
constexpr int BN = 64;    // output channels per block
constexpr int BK = 32;    // input channels per K step
constexpr int THREADS = 128;
constexpr int LDA = BK + 8;  // smem leading dims, padded against bank conflicts
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;

constexpr int SMEM_AB = (BM * LDA + BK * LDB) * 2;
constexpr int SMEM_C = BM * LDC * 4;
constexpr int SMEM_BYTES = SMEM_AB > SMEM_C ? SMEM_AB : SMEM_C;

struct Input {
  const __nv_bfloat16* x;  // (X+2, Y+2, Z+2, c)
  const float* ab;         // (2, c)
  int c;                   // channels
  int cpad;                // c rounded up to BK
  int kbase;               // first packed weight row of this input
};

__device__ __forceinline__ __nv_bfloat16 norm_bf16(__nv_bfloat16 v, float a,
                                                   float b) {
  // explicit roundings: no FMA contraction, so the value is the plain
  // version's (f32(x) * a) + b, rounded to bf16 once
  return __float2bfloat16(__fadd_rn(__fmul_rn(__bfloat162float(v), a), b));
}

// DX = false: kernel A (bias, ReLU, stat sums). DX = true: kernel C
// (`bias` unused; `post_a`, `post_x` give the cross-stats and the scale).
template <bool DX>
__global__ void __launch_bounds__(THREADS)
    conv3x3x3_kernel(Input in0, Input in1, int n_inputs,
                     const __nv_bfloat16* __restrict__ w, int ktot, int npad,
                     const float* __restrict__ bias,
                     const float* __restrict__ post_a,
                     const __nv_bfloat16* __restrict__ post_x, int cout,
                     int X, int Y, int Z, __nv_bfloat16* __restrict__ y,
                     float* __restrict__ sums) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sB = sA + BM * LDA;
  float* sC = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const long long M = (long long)X * Y * Z;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int Yp = Y + 2, Zp = Z + 2;

  // A loader: one output row (voxel) and 16 of the BK channels per thread
  const int ar = tid >> 1;
  const int ah = (tid & 1) * 16;
  const long long am = m0 + ar;
  const bool row_ok = am < M;
  int vx = 0, vy = 0, vz = 0;
  if (row_ok) {
    vz = (int)(am % Z);
    const long long t = am / Z;
    vy = (int)(t % Y);
    vx = (int)(t / Y);
  }
  // B loader: one K row and 16 of the BN columns per thread
  const int bk = tid >> 2;
  const int bn = (tid & 3) * 16;

  // warp tile: 32 x 32 of the 64 x 64 block tile
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int inp = 0; inp < n_inputs; ++inp) {
    const Input in = inp == 0 ? in0 : in1;
    const bool vec = (in.c % 8) == 0;
    for (int c0 = 0; c0 < in.cpad; c0 += BK) {
      const int cb = c0 + ah;
      float a[16], b[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const bool ok = !DX && cb + j < in.c;
        a[j] = ok ? in.ab[cb + j] : 0.0f;
        b[j] = ok ? in.ab[in.c + cb + j] : 0.0f;
      }
      for (int tap = 0; tap < 27; ++tap) {
        const int dx = tap / 9, dy = (tap / 3) % 3, dz = tap % 3;
        // interior voxel v sits at padded v + 1; its tap reads padded v + d
        const int px = vx + dx, py = vy + dy, pz = vz + dz;
        const bool inside = row_ok && px >= 1 && px <= X && py >= 1 &&
                            py <= Y && pz >= 1 && pz <= Z;
        __align__(16) __nv_bfloat16 vals[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) vals[j] = __float2bfloat16(0.0f);
        if (inside) {
          const __nv_bfloat16* src =
              in.x + ((long long)(px * Yp + py) * Zp + pz) * in.c + cb;
#pragma unroll
          for (int g = 0; g < 2; ++g) {
            const int cg = cb + g * 8;
            if (vec && cg + 8 <= in.c) {
              const uint4 u = *reinterpret_cast<const uint4*>(src + g * 8);
              const __nv_bfloat16* h =
                  reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
              for (int j = 0; j < 8; ++j)
                vals[g * 8 + j] =
                    DX ? h[j] : norm_bf16(h[j], a[g * 8 + j], b[g * 8 + j]);
            } else {
#pragma unroll
              for (int j = 0; j < 8; ++j)
                if (cg + j < in.c)
                  vals[g * 8 + j] =
                      DX ? src[g * 8 + j]
                         : norm_bf16(src[g * 8 + j], a[g * 8 + j],
                                     b[g * 8 + j]);
            }
          }
        }
        uint4* dA = reinterpret_cast<uint4*>(sA + ar * LDA + ah);
        dA[0] = reinterpret_cast<const uint4*>(vals)[0];
        dA[1] = reinterpret_cast<const uint4*>(vals)[1];

        const uint4* srcB = reinterpret_cast<const uint4*>(
            w + ((long long)tap * ktot + in.kbase + c0 + bk) * npad + n0 + bn);
        uint4* dB = reinterpret_cast<uint4*>(sB + bk * LDB + bn);
        dB[0] = srcB[0];
        dB[1] = srcB[1];
        __syncthreads();

#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              fa[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              fb[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(fa[i], sA + (wm + i * 16) * LDA + kk, LDA);
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
    }
  }

  // epilogue: accumulators -> smem (aliases the A/B tiles; all warps are
  // past the last __syncthreads of the K loop)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sC + (wm + i * 16) * LDC + wn + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  // bias + ReLU (kernel A) or the raw dxn (kernel C); rows past the
  // volume and columns past Cout become 0 so they add nothing to the sums
  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, n = idx % BN;
    float v = 0.0f;
    if (m0 + r < M && n0 + n < cout)
      v = DX ? sC[r * LDC + n] : fmaxf(sC[r * LDC + n] + bias[n0 + n], 0.0f);
    sC[r * LDC + n] = v;
  }
  __syncthreads();

  if (tid < BN && n0 + tid < cout) {
    float s0 = 0.0f, s1 = 0.0f;
    for (int r = 0; r < BM; ++r) {
      const float v = sC[r * LDC + tid];
      if (DX) {
        const long long m = m0 + r;
        if (m >= M) break;
        const int oz = (int)(m % Z);
        const long long t = m / Z;
        const int oy = (int)(t % Y), ox = (int)(t / Y);
        const float px = __bfloat162float(
            post_x[((long long)((ox + 1) * Yp + oy + 1) * Zp + oz + 1) * cout +
                   n0 + tid]);
        s0 += v * px;
        s1 += v;
      } else {
        s0 += v;
        s1 += v * v;
      }
    }
    atomicAdd(sums + n0 + tid, s0);
    atomicAdd(sums + cout + n0 + tid, s1);
  }

  // store y: 8 channels per thread
  const bool vec_out = (cout % 8) == 0;
  for (int idx = tid; idx < BM * (BN / 8); idx += THREADS) {
    const int r = idx / (BN / 8);
    const int n = n0 + (idx % (BN / 8)) * 8;
    const long long m = m0 + r;
    if (m >= M || n >= cout) continue;
    const int oz = (int)(m % Z);
    const long long t = m / Z;
    const int oy = (int)(t % Y), ox = (int)(t / Y);
    __nv_bfloat16* dst =
        y + ((long long)((ox + 1) * Yp + oy + 1) * Zp + oz + 1) * cout + n;
    const float* s = sC + r * LDC + (n - n0);
    if (vec_out && n + 8 <= cout) {
      __align__(16) __nv_bfloat16 o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        o[j] = __float2bfloat16(DX ? s[j] * post_a[n + j] : s[j]);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
    } else {
      for (int j = 0; j < 8 && n + j < cout; ++j)
        dst[j] = __float2bfloat16(DX ? s[j] * post_a[n + j] : s[j]);
    }
  }
}

}  // namespace

extern "C" int conv3x3x3_fwd(const void* x1, const float* ab1, int c1,
                             const void* x2, const float* ab2, int c2,
                             int n_inputs, const void* w, int npad,
                             const float* bias, int cout, int X, int Y, int Z,
                             void* y, float* sums, void* stream) {
  Input in0{static_cast<const __nv_bfloat16*>(x1), ab1, c1,
            (c1 + BK - 1) / BK * BK, 0};
  Input in1{static_cast<const __nv_bfloat16*>(x2), ab2, c2,
            (c2 + BK - 1) / BK * BK, in0.cpad};
  if (n_inputs < 2) in1 = in0;
  const int ktot = in0.cpad + (n_inputs > 1 ? in1.cpad : 0);
  const long long M = (long long)X * Y * Z;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)(npad / BN));
  conv3x3x3_kernel<false>
      <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          in0, in1, n_inputs, static_cast<const __nv_bfloat16*>(w), ktot,
          npad, bias, nullptr, nullptr, cout, X, Y, Z,
          static_cast<__nv_bfloat16*>(y), sums);
  return (int)cudaGetLastError();
}

// Kernel C: dconv (X+2, Y+2, Z+2, c) bf16 -> dx (X+2, Y+2, Z+2, cout) bf16
// = bf16(conv^T(dconv, W_branch) * post_a), sums (2, cout) f32 =
// (sum post_x * dxn, sum dxn). w: the branch's mirrored, transposed
// weights packed as (27, round_up(c, BK), npad) bf16.
extern "C" int conv3x3x3_dx(const void* dconv, int c, const void* w,
                            int npad, const float* post_a, const void* post_x,
                            int cout, int X, int Y, int Z, void* dx,
                            float* sums, void* stream) {
  Input in0{static_cast<const __nv_bfloat16*>(dconv), nullptr, c,
            (c + BK - 1) / BK * BK, 0};
  const long long M = (long long)X * Y * Z;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)(npad / BN));
  conv3x3x3_kernel<true>
      <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          in0, in0, 1, static_cast<const __nv_bfloat16*>(w), in0.cpad, npad,
          nullptr, post_a, static_cast<const __nv_bfloat16*>(post_x), cout, X,
          Y, Z, static_cast<__nv_bfloat16*>(dx), sums);
  return (int)cudaGetLastError();
}

extern "C" int conv3x3x3_fwd_tile_k() { return BK; }
extern "C" int conv3x3x3_fwd_tile_n() { return BN; }
