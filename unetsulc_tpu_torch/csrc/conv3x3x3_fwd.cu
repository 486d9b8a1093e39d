// Fused 'crg' conv block forward for Hopper (sm_90a): lazy-GroupNorm
// prologue -> 3x3x3 conv (implicit GEMM on bf16 tensor cores) -> bias ->
// ReLU -> per-channel stat sums, over a padded channels-last buffer.
//
// Replaces: unetsulc_tpu/ops/conv_pallas.py `_fwd_kernel` in forward mode
// (launched by `conv_shards`, reached through `fused_conv_block`) as
// `conv3x3x3_fwd` (kernel A), and its spatial-parallel modes
// (`conv_shards`'s `halo`, `valid_in` and `valid_out`) as
// `conv3x3x3_fwd_halo`. The post (dx) mode of `_fwd_kernel` is kernel C,
// `conv3x3x3_dx.cu`.
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
// Spatial-parallel (halo) modes, for a shard's slab of the volume along X
// (`unetsulc_tpu_torch/parallel/sp_fused.py`). The two X ring planes of an
// input are its neighbours' boundary planes, passed as two separate
// (Y+2, Z+2, C) operands `lo` and `hi` (the buffer's own ring planes are
// never read, and no (X+2)-plane copy of the slab is made); `valid`
// ((X+2,) f32) says which planes hold real data. Kernel A
// (`conv3x3x3_fwd_halo`) normalizes plane p only where valid[p] != 0 and
// reads 0 elsewhere (the zero ring at the global volume's edges, never
// +b: `_norm_plane`'s runtime-valid path, conv_pallas.py:293-315); output
// planes where `valid_out` is 0 (a duplicated neighbour plane that
// another shard owns) are written as 0 and left out of the sums, once, in
// the epilogue of the one launch that takes both decoder inputs.
//
// What bounds it on this card: operations. At the flagship 96^3 shapes a
// launch does 2 * voxels * 27 * Cin * Cout FLOP (0.59 TFLOP for decoder
// 2's 192->64 pair conv) against ~0.3 GB of traffic, far above the
// ~295 FLOP/byte ridge of the H100, so the floor is the bf16 tensor-core
// rate. This first version is the simple one: nvcuda::wmma 16x16x16 bf16
// fragments fed from shared memory, one K step per __syncthreads pair, no
// cp.async/TMA pipeline and no wgmma; it reaches a fraction of that rate
// (PERF.md). The sums reduce over the block's rows in shared memory into
// one row of partials per block (the caller's f32 workspace, `partial`),
// and a fold (fold.cuh) adds the rows up in a fixed order: no atomics, so
// the sums, and every step built on them, are the same in every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "fold.cuh"

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

// A padded channels-last buffer (X+2, Y+2, Z+2, c). With `valid` set (halo
// mode) its planes 0 and X+1 live in the separate (Y+2, Z+2, c) planes lo
// and hi, and plane p holds data only where valid[p] != 0.
template <typename T>
struct Buf {
  T* x;
  T* lo;
  T* hi;
  const float* valid;
  int c;

  __device__ __forceinline__ T* at(int px, int py, int pz, int X, int Yp,
                                   int Zp) const {
    const long long yz = (long long)py * Zp + pz;
    if (valid != nullptr) {
      if (px == 0) return lo + yz * c;
      if (px == X + 1) return hi + yz * c;
    }
    return x + ((long long)px * Yp * Zp + yz) * c;
  }

  // whether plane px is read: the interior, or a valid halo plane
  __device__ __forceinline__ bool has_plane(int px, int X) const {
    if (valid != nullptr) return px >= 0 && px <= X + 1 && valid[px] != 0.0f;
    return px >= 1 && px <= X;
  }
};

struct Input {
  Buf<const __nv_bfloat16> b;  // (X+2, Y+2, Z+2, c)
  const float* ab;             // (2, c)
  int cpad;                    // c rounded up to BK
  int kbase;                   // first packed weight row of this input
};

__device__ __forceinline__ __nv_bfloat16 norm_bf16(__nv_bfloat16 v, float a,
                                                   float b) {
  // explicit roundings: no FMA contraction, so the value is the plain
  // version's (f32(x) * a) + b, rounded to bf16 once
  return __float2bfloat16(__fadd_rn(__fmul_rn(__bfloat162float(v), a), b));
}

// Kernel A: bias, ReLU, stat sums. `row_valid` (or nullptr): rows whose
// padded output plane p has row_valid[p] == 0 (valid_out) are not written
// and add nothing to the sums. Block (bx, by) writes its channels' two
// sums to partial[bx][0][n] and partial[bx][1][n], a (gridDim.x, 2, cout)
// array that the launcher folds into the sums.
__global__ void __launch_bounds__(THREADS)
    conv3x3x3_kernel(Input in0, Input in1, int n_inputs,
                     const __nv_bfloat16* __restrict__ w, int ktot, int npad,
                     const float* __restrict__ bias, int cout, int X, int Y,
                     int Z, const float* __restrict__ row_valid,
                     Buf<__nv_bfloat16> out,
                     float* __restrict__ partial) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __shared__ int s_plane[BM];  // each row's padded output plane, -1: none
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sB = sA + BM * LDA;
  float* sC = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const long long YZ = (long long)Y * Z;
  const long long M = (long long)X * YZ;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int Yp = Y + 2, Zp = Z + 2;

  // A loader: one output row (voxel) and 16 of the BK channels per thread;
  // the row's output sits at padded (vx + 1, vy + 1, vz + 1)
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
    const int c = in.b.c;
    const bool vec = (c % 8) == 0;
    for (int c0 = 0; c0 < in.cpad; c0 += BK) {
      const int cb = c0 + ah;
      float a[16], b[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const bool ok = cb + j < c;
        a[j] = ok ? in.ab[cb + j] : 0.0f;
        b[j] = ok ? in.ab[c + cb + j] : 0.0f;
      }
      for (int tap = 0; tap < 27; ++tap) {
        const int dx = tap / 9, dy = (tap / 3) % 3, dz = tap % 3;
        // output voxel v sits at padded v + 1; its tap reads padded v + d
        const int px = vx + dx, py = vy + dy, pz = vz + dz;
        const bool inside = row_ok && in.b.has_plane(px, X) && py >= 1 &&
                            py <= Y && pz >= 1 && pz <= Z;
        __align__(16) __nv_bfloat16 vals[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) vals[j] = __float2bfloat16(0.0f);
        if (inside) {
          const __nv_bfloat16* src = in.b.at(px, py, pz, X, Yp, Zp) + cb;
#pragma unroll
          for (int g = 0; g < 2; ++g) {
            const int cg = cb + g * 8;
            if (vec && cg + 8 <= c) {
              const uint4 u = *reinterpret_cast<const uint4*>(src + g * 8);
              const __nv_bfloat16* h =
                  reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
              for (int j = 0; j < 8; ++j)
                vals[g * 8 + j] = norm_bf16(h[j], a[g * 8 + j], b[g * 8 + j]);
            } else {
#pragma unroll
              for (int j = 0; j < 8; ++j)
                if (cg + j < c)
                  vals[g * 8 + j] =
                      norm_bf16(src[g * 8 + j], a[g * 8 + j], b[g * 8 + j]);
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
  if (tid < BM) {
    const long long m = m0 + tid;
    int p = -1;
    if (m < M) {
      p = (int)(m / YZ) + 1;
      if (row_valid != nullptr && row_valid[p] == 0.0f) p = -1;
    }
    s_plane[tid] = p;
  }
  __syncthreads();

  // bias + ReLU; rows past the volume or masked out, and columns past
  // Cout, become 0 so they add nothing to the sums
  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, n = idx % BN;
    float v = 0.0f;
    if (s_plane[r] >= 0 && n0 + n < cout)
      v = fmaxf(sC[r * LDC + n] + bias[n0 + n], 0.0f);
    sC[r * LDC + n] = v;
  }
  __syncthreads();

  if (tid < BN && n0 + tid < cout) {
    float s0 = 0.0f, s1 = 0.0f;
    for (int r = 0; r < BM; ++r) {
      const float v = sC[r * LDC + tid];
      s0 += v;
      s1 += v * v;
    }
    float* row = partial + (long long)blockIdx.x * 2 * cout;
    row[n0 + tid] = s0;
    row[cout + n0 + tid] = s1;
  }

  // store: 8 channels per thread
  const bool vec_out = (cout % 8) == 0;
  for (int idx = tid; idx < BM * (BN / 8); idx += THREADS) {
    const int r = idx / (BN / 8);
    const int n = n0 + (idx % (BN / 8)) * 8;
    const int p = s_plane[r];
    if (p < 0 || n >= cout) continue;
    const long long yz = (m0 + r) % YZ;
    const int oy = (int)(yz / Z), oz = (int)(yz % Z);
    __nv_bfloat16* dst = out.at(p, oy + 1, oz + 1, X, Yp, Zp) + n;
    const float* s = sC + r * LDC + (n - n0);
    if (vec_out && n + 8 <= cout) {
      __align__(16) __nv_bfloat16 o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        o[j] = __float2bfloat16(s[j]);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
    } else {
      for (int j = 0; j < 8 && n + j < cout; ++j)
        dst[j] = __float2bfloat16(s[j]);
    }
  }
}

Input make_input(const void* x, const float* ab, int c, const void* lo,
                 const void* hi, const float* valid, int kbase) {
  Input in;
  in.b = Buf<const __nv_bfloat16>{
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(lo),
      static_cast<const __nv_bfloat16*>(hi), valid, c};
  in.ab = ab;
  in.cpad = (c + BK - 1) / BK * BK;
  in.kbase = kbase;
  return in;
}

// Rows of partial sums (one per block row of the grid) for M output rows.
long long sum_rows(long long M) { return (M + BM - 1) / BM; }

// The (rows, 2, cout) partials, then the fold's scratch, in one workspace.
long long sums_ws_floats(long long M, int cout) {
  const long long rows = sum_rows(M), cols = 2LL * cout;
  return rows * cols + fold::scratch_floats(rows, cols);
}

cudaError_t fold_sums(float* ws, long long M, int cout, float* sums,
                      cudaStream_t st) {
  const long long rows = sum_rows(M), cols = 2LL * cout;
  return fold::fold_cols(ws, rows, cols, ws + rows * cols, sums, st);
}

int launch_fwd(const void* x1, const float* ab1, int c1, const void* lo1,
               const void* hi1, const float* v1, const void* x2,
               const float* ab2, int c2, const void* lo2, const void* hi2,
               const float* v2, int n_inputs, const void* w, int npad,
               const float* bias, int cout, int X, int Y, int Z,
               const float* valid_out, void* y, float* sums, float* ws,
               void* stream) {
  Input in0 = make_input(x1, ab1, c1, lo1, hi1, v1, 0);
  Input in1 = make_input(x2, ab2, c2, lo2, hi2, v2, in0.cpad);
  if (n_inputs < 2) in1 = in0;
  const int ktot = in0.cpad + (n_inputs > 1 ? in1.cpad : 0);
  const long long M = (long long)X * Y * Z;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)(npad / BN));
  const Buf<__nv_bfloat16> out{static_cast<__nv_bfloat16*>(y), nullptr,
                               nullptr, nullptr, cout};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  conv3x3x3_kernel<<<grid, THREADS, 0, st>>>(
      in0, in1, n_inputs, static_cast<const __nv_bfloat16*>(w), ktot, npad,
      bias, cout, X, Y, Z, valid_out, out, ws);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)fold_sums(ws, M, cout, sums, st);
}

}  // namespace

// f32 workspace of one launch of kernel A (either mode) over an X x Y x Z
// interior with cout output channels. -1 if it does not fit an int.
extern "C" int conv3x3x3_sums_ws(int cout, int X, int Y, int Z) {
  const long long M = (long long)X * Y * Z;
  const long long n = sums_ws_floats(M, cout);
  return n > 0x7fffffffLL ? -1 : (int)n;
}

// Kernel A: x1 (and x2 when n_inputs == 2) (X+2, Y+2, Z+2, c_i) bf16 with
// their (2, c_i) f32 affines -> y (X+2, Y+2, Z+2, cout) bf16, sums (2,
// cout) f32 (zeroed by the caller); w: (27, Ktot, npad) bf16 packed by the
// wrapper; ws: conv3x3x3_sums_ws(cout, X, Y, Z, 0) f32.
extern "C" int conv3x3x3_fwd(const void* x1, const float* ab1, int c1,
                             const void* x2, const float* ab2, int c2,
                             int n_inputs, const void* w, int npad,
                             const float* bias, int cout, int X, int Y, int Z,
                             void* y, float* sums, float* ws, void* stream) {
  return launch_fwd(x1, ab1, c1, nullptr, nullptr, nullptr, x2, ab2, c2,
                    nullptr, nullptr, nullptr, n_inputs, w, npad, bias, cout,
                    X, Y, Z, nullptr, y, sums, ws, stream);
}

// Kernel A in halo mode: as conv3x3x3_fwd, with each input's planes 0 and
// X+1 read from lo_i and hi_i ((Y+2, Z+2, c_i) bf16; may be null where
// v_i marks the plane invalid), v_i (X+2,) f32 its plane validity, and
// valid_out (X+2,) f32 the planes this shard writes and counts.
extern "C" int conv3x3x3_fwd_halo(
    const void* x1, const float* ab1, int c1, const void* lo1,
    const void* hi1, const float* v1, const void* x2, const float* ab2,
    int c2, const void* lo2, const void* hi2, const float* v2, int n_inputs,
    const void* w, int npad, const float* bias, int cout, int X, int Y, int Z,
    const float* valid_out, void* y, float* sums, float* ws, void* stream) {
  return launch_fwd(x1, ab1, c1, lo1, hi1, v1, x2, ab2, c2, lo2, hi2, v2,
                    n_inputs, w, npad, bias, cout, X, Y, Z, valid_out, y, sums,
                    ws, stream);
}

extern "C" int conv3x3x3_fwd_tile_k() { return BK; }
extern "C" int conv3x3x3_fwd_tile_n() { return BN; }
