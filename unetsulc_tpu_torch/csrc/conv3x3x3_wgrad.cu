// Kernel D: the weight gradient of one input branch of the fused 'crg' conv
// block, for Hopper (sm_90a), on wgmma.mma_async: dW[tap][ci][co] = sum
// over interior voxels v of xn[v + off(tap)][ci] * dconv[v][co], with xn
// recomputed from the raw buffer and its pending GroupNorm affine.
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
// bf16, the cotangent of the conv's pre-activation; only its interior is
// read. dW: (27, cin, cout) f32; tap = dx*9 + dy*3 + dz, off(tap) =
// (dx-1, dy-1, dz-1).
//
// Halo mode (a shard's slab of the volume along X,
// `unetsulc_tpu_torch/parallel/sp_fused.py`): x's planes 0 and X+1 are the
// neighbours' boundary planes, the separate (Y+2, Z+2, cin) operands lo
// and hi, each loaded by its own guarded copies (no (X+2)-plane copy is
// made), and valid ((X+2,) f32) says which planes hold data: xn on a ring
// plane is normalized where valid is nonzero and is 0 elsewhere, as kernel
// A reads it.
//
// GEMM view, per tap: M = cin, N = cout, K = voxels, a small output over a
// very long contraction. K runs over flat positions of the padded buffer,
// (px * Yp + py) * Zp + pz, over planes 1..X (ring positions hold dconv =
// 0 and add nothing); a tap shifts a position by a constant. A block owns
// a 64-channel cin tile, a 64-channel cout tile, one dx (the 9 taps of
// that plane offset, three per consumer warpgroup: warpgroup dy takes dz =
// 0, 1, 2) and a contiguous range of positions (split-K). Per step of 256
// positions (128 for Z beyond 189; beyond 317 the launch is refused, as
// two stages no longer fit in shared memory) it stages once, with cp.async
// into a ring of 3 or 2 stages: the dconv tile (the wgmma B operand: K =
// the step's positions x N = 64 channels, N-contiguous, i.e. MN-major,
// 128-byte swizzle) and the run of raw x rows that the 9 taps read (the
// step's rows plus Zp + 1 on each side, shifted by the block's dx). Each
// thread normalizes in shared memory the pieces it copied, ring and
// invalid planes as 0, for the next step while the tensor cores run this
// one. Each tap's A operand, xn^T at its shifted rows (MN-major: rows are
// K), is read by wgmma from shared memory through a descriptor that starts
// at the shifted row (the swizzle is applied to absolute address bits;
// wgmma.cuh), so one staged run serves all 9 taps; a step's wgmmas go out
// as one group, and the three 64 x 64 f32 accumulators of a warpgroup stay
// in registers over the whole range. x and dconv are read 3 times (once
// per dx) instead of 27.
//
// Each block writes its 9 f32 tiles into its split's slice of the caller's
// workspace, a (splits, 27, cin, cout) f32 array, and a fold (fold.cuh)
// adds the splits into dW in a fixed order: no atomics, so dW is the same
// in every run.
//
// What bounds it on this card: operations, 2 * voxels * 27 * cin * cout
// FLOP at the bf16 tensor-core rate, as the branch's forward conv; the
// bytes (x and dconv once, dW once) are ~0.3 GB at the flagship's largest
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fold.cuh"
#include "wgmma.cuh"

namespace {

using namespace hopper;

constexpr int TCI = 64;         // cin channels per block (wgmma M)
constexpr int TCO = 64;         // cout channels per block (wgmma N)
constexpr int TAP_GROUPS = 3;   // one block per dx: 9 taps each
constexpr int THREADS = 384;    // three consumer warpgroups: dy = 0, 1, 2
constexpr int TARGET_BLOCKS = 132 * 2;
constexpr int MIN_STEPS = 8;    // K steps per split, at least
constexpr int SMEM_LIMIT = 232448 - 1024;  // beside the static affine

__host__ __device__ constexpr uint32_t align1024(uint32_t n) {
  return (n + 1023u) & ~1023u;
}

// bytes of a stage's x run (a step's bk rows and their halo) for Zp
__host__ __device__ constexpr uint32_t run_bytes(int bk, int zp) {
  return align1024((uint32_t)(bk + 2 * zp + 2) * 128u);
}

__host__ __device__ constexpr uint32_t stage_bytes(int bk, int zp) {
  return run_bytes(bk, zp) + bk * 128u;  // + the dconv tile
}

// stages of a ring of bk-position steps that fit: 3, 2 or 0
__host__ __device__ constexpr int stages_for(int bk, int zp) {
  return 1024u + 3u * stage_bytes(bk, zp) <= (uint32_t)SMEM_LIMIT   ? 3
         : 1024u + 2u * stage_bytes(bk, zp) <= (uint32_t)SMEM_LIMIT ? 2
                                                                    : 0;
}

// Positions per K step: 256 where two stages fit (Z up to 189), else 128
// (Z up to 317; deeper is refused); a longer step halves the halo rows
// staged and normalized per position.
__host__ __device__ constexpr int step_for(int zp) {
  return stages_for(256, zp) >= 2 ? 256 : 128;
}

struct WgradArgs {
  const __nv_bfloat16* x;      // (X+2, Y+2, Z+2, cin)
  const __nv_bfloat16* lo;     // (Y+2, Z+2, cin) or null (halo mode)
  const __nv_bfloat16* hi;
  const float* valid;          // (X+2,) in halo mode, else null
  const float* ab;             // (2, cin)
  const __nv_bfloat16* dconv;  // (X+2, Y+2, Z+2, cout)
  float* part;                 // (splits, 27, cin, cout)
  int cin, cout, X, Y, Z, chunk;
};

// A thread's walk over the rows of a run that it copies (every
// THREADS / 8-th row): the padded coordinates of its current row.
struct Walk {
  int px, py, pz;
  bool on;
};

template <int BK, int ST>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3x3_wgrad_kernel(const WgradArgs p) {
  constexpr int KK = BK / 16;  // wgmma K steps per K step
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int dy = tid >> 7;          // warpgroup
  const int wi = (tid >> 5) & 3;    // warp in the warpgroup: cin rows 16 wi
  const int Yp = p.Y + 2, Zp = p.Z + 2;
  const int YZp = Yp * Zp;
  const int total = (p.X + 2) * YZp;
  const float inv_yz = 1.0f / (float)YZp, inv_z = 1.0f / (float)Zp;
  const bool halo = p.valid != nullptr;
  const int cot = (p.cout + TCO - 1) / TCO;
  const int dxo = blockIdx.x % TAP_GROUPS;
  const int ci0 = (blockIdx.x / TAP_GROUPS / cot) * TCI;
  const int co0 = (blockIdx.x / TAP_GROUPS % cot) * TCO;
  const int kbeg = YZp + blockIdx.y * p.chunk;
  const int kend = min(kbeg + p.chunk, (p.X + 1) * YZp);
  const int nsteps = (kend - kbeg + BK - 1) / BK;
  const int run_items = (BK + 2 * Zp + 2) * 8;  // 16-byte pieces of a run
  const uint32_t sbytes = stage_bytes(BK, Zp);
  const uint32_t rbytes = run_bytes(BK, Zp);
  const bool vec_x = (p.cin % 8) == 0, vec_d = (p.cout % 8) == 0;
  // a thread copies and normalizes piece tid % 8 of rows tid / 8 + RSTEP i
  constexpr int RSTEP = THREADS / 8;
  const int prow = tid >> 3, ppc = tid & 7;
  const int items = (BK + 2 * Zp + 2 - prow + RSTEP - 1) / RSTEP;
  const int per_kk = ((BK + 2 * Zp + 2 + RSTEP - 1) / RSTEP + KK - 1) / KK;
  const int step_y = RSTEP / Zp, step_z = RSTEP % Zp;  // RSTEP rows on
  float fa[8], fb[8];  // the affine of the thread's 8 channels
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int ch = ci0 + ppc * 8 + j;
    fa[j] = ch < p.cin ? p.ab[ch] : 0.0f;
    fb[j] = ch < p.cin ? p.ab[p.cin + ch] : 0.0f;
  }

  // (y, z) interior of a position q >= 0
  auto yz_inner = [&](int q) {
    const int rem = q - div_pos(q, YZp, inv_yz) * YZp;
    const int py = div_pos(rem, Zp, inv_z), pz = rem - py * Zp;
    return py >= 1 && py <= p.Y && pz >= 1 && pz <= p.Z;
  };

  // one 16-byte piece (8 channels from ch) of a row -> dst; zeros where
  // the row is null or past c
  auto piece = [&](uint32_t dst, const __nv_bfloat16* row, int ch, int c,
                   bool vec) {
    if (vec) {
      const bool in = row != nullptr && ch < c;
      cp_async16(dst, in ? row + ch : p.dconv, in ? 16 : 0);
    } else {
      __align__(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = (row != nullptr && ch + j < c) ? row[ch + j]
                                              : __float2bfloat16(0.0f);
      st_shared16(dst, *reinterpret_cast<const uint4*>(v));
    }
  };

  // first x position of step s's run
  auto run_q0 = [&](int s) {
    return kbeg + s * BK + (dxo - 1) * YZp - Zp - 1;
  };

  // K step s -> stage st: the x run (raw; its ring rows are masked when
  // normalized) and the dconv tile (rows kbeg + s BK + r, r < BK: none
  // past kend or off the (y, z) interior)
  auto load_stage = [&](int s, int st) {
    const uint32_t sx = base + st * sbytes, sd = sx + rbytes;
    const int q0 = run_q0(s);
    for (int it = tid; it < run_items; it += THREADS) {
      const int r = it >> 3, pc = it & 7;
      const int q = q0 + r;
      const __nv_bfloat16* row = nullptr;
      if (q >= 0 && q < total) {
        if (halo && q < YZp)
          row = p.valid[0] != 0.0f ? p.lo + (long long)q * p.cin : nullptr;
        else if (halo && q >= total - YZp)
          row = p.valid[p.X + 1] != 0.0f
                    ? p.hi + (long long)(q - (total - YZp)) * p.cin
                    : nullptr;
        else
          row = p.x + (long long)q * p.cin;
      }
      piece(sx + swz(r, pc), row, ci0 + pc * 8, p.cin, vec_x);
    }
    const int k = kbeg + s * BK;
    for (int it = tid; it < BK * 8; it += THREADS) {
      const int r = it >> 3, pc = it & 7;
      const int q = k + r;
      const __nv_bfloat16* row =
          (q < kend && yz_inner(q)) ? p.dconv + (long long)q * p.cout
                                    : nullptr;
      piece(sd + swz(r, pc), row, co0 + pc * 8, p.cout, vec_d);
    }
  };

  // item i of step s's run (row prow + RSTEP i, piece ppc, copied by this
  // thread), normalized in place: bf16((f32(x) * a + b) * mask) as kernel
  // A's prologue computes it (explicit roundings, one bf16 cast), the mask
  // 0 off the interior (in halo mode: off the valid planes' (y, z)
  // interior). Items are visited in order; `w` walks their coordinates.
  auto normalize = [&](int s, int i, Walk& w) {
    const int r = prow + RSTEP * i;
    const int q = run_q0(s) + r;
    bool keep = false;
    if (q >= 0 && q < total) {
      if (!w.on) {
        w.px = div_pos(q, YZp, inv_yz);
        const int rem = q - w.px * YZp;
        w.py = div_pos(rem, Zp, inv_z);
        w.pz = rem - w.py * Zp;
        w.on = true;
      }
      keep = w.py >= 1 && w.py <= p.Y && w.pz >= 1 && w.pz <= p.Z &&
             (halo ? p.valid[w.px] != 0.0f : (w.px >= 1 && w.px <= p.X));
      w.pz += step_z;
      w.py += step_y;
      if (w.pz >= Zp) {
        w.pz -= Zp;
        ++w.py;
      }
      while (w.py >= Yp) {
        w.py -= Yp;
        ++w.px;
      }
    }
    const uint32_t addr = base + (s % ST) * sbytes + swz(r, ppc);
    uint4 u = ld_shared16(addr);
    uint32_t* u32 = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u32[k]));
      const __nv_bfloat162 o = __floats2bfloat162_rn(
          __fadd_rn(__fmul_rn(f.x, fa[2 * k]), fb[2 * k]),
          __fadd_rn(__fmul_rn(f.y, fa[2 * k + 1]), fb[2 * k + 1]));
      u32[k] = keep ? *reinterpret_cast<const uint32_t*>(&o) : 0u;
    }
    st_shared16(addr, u);
  };

#pragma unroll 1
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nsteps) load_stage(s, s);
    cp_async_commit();
  }
  cp_async_wait<ST - 2>();  // this thread's copies of step 0
  {
    Walk w{0, 0, 0, false};
    for (int i = 0; i < items; ++i) normalize(0, i, w);
  }
  fence_proxy_async();
  __syncthreads();

  float acc[3][TCO / 2];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int e = 0; e < TCO / 2; ++e) acc[d][e] = 0.0f;
  // the first row of this warpgroup's taps (dz = 0) in a run
  const int arow = dy * Zp;

#pragma unroll 1
  for (int s = 0; s < nsteps; ++s) {
    // refill the stage that held step s - 1: every warpgroup finished it
    // (wgmma_wait<0>) before the barrier that ended step s - 1
    if (s + ST - 1 < nsteps) load_stage(s + ST - 1, (s + ST - 1) % ST);
    cp_async_commit();
    cp_async_wait<ST - 2>();  // this thread's copies of step s + 1
    const bool next = s + 1 < nsteps;
    Walk w{0, 0, 0, false};

    // each tap's A, xn^T at the tap's rows of the run: the descriptor starts
    // at the shifted row (see wgmma_ss_m64k16); all of the step's wgmmas go
    // out before the waits, step s + 1's normalization between them
    const uint32_t sx = base + (s % ST) * sbytes, sd = sx + rbytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const uint64_t db = desc_sw128(sd + kk * 2048);
#pragma unroll
      for (int dz = 0; dz < 3; ++dz)
        wgmma_ss_m64k16<TCO, 1, 1>(
            acc[dz], desc_sw128(sx + (arow + kk * 16 + dz) * 128), db);
      if (next)
        for (int i = kk * per_kk; i < min(items, (kk + 1) * per_kk); ++i)
          normalize(s + 1, i, w);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_proxy_async();
    __syncthreads();
  }

  // this split's partial tiles: rows ci0 + 16 wi + g (+8), columns co0 +
  // 8 j + 2 t (+1)
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int dz = 0; dz < 3; ++dz) {
    const int tap = dxo * 9 + dy * 3 + dz;
    float* out = p.part + ((long long)blockIdx.y * 27 + tap) * p.cin * p.cout;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ci = ci0 + 16 * wi + g + 8 * h;
      if (ci >= p.cin) continue;
#pragma unroll
      for (int jn = 0; jn < TCO / 8; ++jn) {
        const int co = co0 + 8 * jn + 2 * t;
        const float v0 = acc[dz][4 * jn + 2 * h];
        const float v1 = acc[dz][4 * jn + 2 * h + 1];
        float* o = out + (long long)ci * p.cout + co;
        if (co + 1 < p.cout && (p.cout & 1) == 0) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          if (co < p.cout) o[0] = v0;
          if (co + 1 < p.cout) o[1] = v1;
        }
      }
    }
  }
}

int tiles_of(int cin, int cout) {
  return ((cin + TCI - 1) / TCI) * ((cout + TCO - 1) / TCO) * TAP_GROUPS;
}

// Positions per split (a multiple of the K step) and the number of splits
// of the K range (X planes of Yp x Zp positions).
void split_k(int X, int Y, int Z, int tiles, long long* chunk,
             long long* splits) {
  const int BK = step_for(Z + 2);
  const long long K = (long long)X * (Y + 2) * (Z + 2);
  const long long steps = (K + BK - 1) / BK;
  long long s = (TARGET_BLOCKS + tiles - 1) / tiles;
  const long long most = (steps + MIN_STEPS - 1) / MIN_STEPS;
  if (s > most) s = most;
  if (s < 1) s = 1;
  const long long per = (steps + s - 1) / s;
  *chunk = per * BK;
  *splits = (K + *chunk - 1) / *chunk;
}

// The (splits, 27, cin, cout) partials, then the fold's scratch.
long long wgrad_ws_floats(int cin, int cout, int X, int Y, int Z) {
  long long chunk, splits;
  split_k(X, Y, Z, tiles_of(cin, cout), &chunk, &splits);
  const long long cols = 27LL * cin * cout;
  return splits * cols + fold::scratch_floats(splits, cols);
}

template <int BK, int ST>
cudaError_t launch_st(const WgradArgs& a, dim3 grid, uint32_t smem,
                      cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3x3_wgrad_kernel<BK, ST>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  conv3x3x3_wgrad_kernel<BK, ST><<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

int launch_wgrad(const void* x, const void* lo, const void* hi,
                 const float* valid, const float* ab, int cin,
                 const void* dconv, int cout, int X, int Y, int Z, float* dw,
                 float* ws, void* stream) {
  const int bk = step_for(Z + 2), st_n = stages_for(bk, Z + 2);
  const uint32_t smem = 1024u + st_n * stage_bytes(bk, Z + 2);
  if (st_n == 0 ||
      (long long)(X + 2) * (Y + 2) * (Z + 2) * (cin > cout ? cin : cout) >
          0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int tiles = tiles_of(cin, cout);
  long long chunk, splits;
  split_k(X, Y, Z, tiles, &chunk, &splits);
  WgradArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.lo = static_cast<const __nv_bfloat16*>(lo);
  a.hi = static_cast<const __nv_bfloat16*>(hi);
  a.valid = valid;
  a.ab = ab;
  a.dconv = static_cast<const __nv_bfloat16*>(dconv);
  a.part = ws;
  a.cin = cin;
  a.cout = cout;
  a.X = X;
  a.Y = Y;
  a.Z = Z;
  a.chunk = (int)chunk;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)tiles, (unsigned)splits);
  cudaError_t err =
      bk == 256 ? (st_n == 3 ? launch_st<256, 3>(a, grid, smem, st)
                             : launch_st<256, 2>(a, grid, smem, st))
                : (st_n == 3 ? launch_st<128, 3>(a, grid, smem, st)
                             : launch_st<128, 2>(a, grid, smem, st));
  if (err != cudaSuccess) return (int)err;
  const long long cols = 27LL * cin * cout;
  return (int)fold::fold_cols(ws, splits, cols, ws + splits * cols, dw, st);
}

}  // namespace

// Constants that the wrapper's plan mirrors: what = 0 the cin tile, 1 the
// cout tile, 2 the positions per K step for a Z-deep interior, 3 the tap
// groups (blocks per (cin, cout) tile and split), 4 the target block
// count, 5 the least K steps per split, 6 the ring's stages for Z (0: the
// launch is refused).
extern "C" int conv3x3x3_wgrad_tile(int what, int Z) {
  switch (what) {
    case 0: return TCI;
    case 1: return TCO;
    case 2: return step_for(Z + 2);
    case 3: return TAP_GROUPS;
    case 4: return TARGET_BLOCKS;
    case 5: return MIN_STEPS;
    case 6: return stages_for(step_for(Z + 2), Z + 2);
    default: return -1;
  }
}

// f32 workspace of one launch (either mode); -1 if it does not fit an int.
extern "C" int conv3x3x3_wgrad_ws(int cin, int cout, int X, int Y, int Z) {
  const long long n = wgrad_ws_floats(cin, cout, X, Y, Z);
  return n > 0x7fffffffLL ? -1 : (int)n;
}

// x (X+2, Y+2, Z+2, cin) bf16, ab (2, cin) f32, dconv (X+2, Y+2, Z+2, cout)
// bf16 -> dw (27, cin, cout) f32, which the caller zeroes; ws:
// conv3x3x3_wgrad_ws(cin, cout, X, Y, Z) f32.
extern "C" int conv3x3x3_wgrad(const void* x, const float* ab, int cin,
                               const void* dconv, int cout, int X, int Y,
                               int Z, float* dw, float* ws, void* stream) {
  return launch_wgrad(x, nullptr, nullptr, nullptr, ab, cin, dconv, cout, X,
                      Y, Z, dw, ws, stream);
}

// Halo mode: as conv3x3x3_wgrad, with x's planes 0 and X+1 read from lo and
// hi ((Y+2, Z+2, cin) bf16; may be null where valid marks the plane
// invalid) and valid (X+2,) f32 the plane validity.
extern "C" int conv3x3x3_wgrad_halo(const void* x, const void* lo,
                                    const void* hi, const float* valid,
                                    const float* ab, int cin,
                                    const void* dconv, int cout, int X, int Y,
                                    int Z, float* dw, float* ws,
                                    void* stream) {
  return launch_wgrad(x, lo, hi, valid, ab, cin, dconv, cout, X, Y, Z, dw,
                      ws, stream);
}
