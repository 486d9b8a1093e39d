// Kernel A: the fused 'crg' conv block forward for Hopper (sm_90a), as an
// implicit GEMM on wgmma.mma_async: the pending GroupNorm affine of each
// input -> 3x3x3 conv -> bias -> ReLU -> per-channel stat sums, over padded
// channels-last buffers.
//
// Replaces: unetsulc_tpu/ops/conv_pallas.py `_fwd_kernel` in forward mode
// (launched by `conv_shards`, reached through `fused_conv_block`) as
// `conv3x3x3_fwd`, and its spatial-parallel modes (`conv_shards`'s `halo`,
// `valid_in` and `valid_out`, conv_pallas.py:816-845) as
// `conv3x3x3_fwd_halo`. The post (dx) mode of `_fwd_kernel` is kernel C,
// `conv3x3x3_dx.cu`, whose core this kernel shares.
//
// Layout. Each input is a padded channels-last buffer (X+2, Y+2, Z+2, c)
// bf16 whose 1-voxel ring is the conv's zero padding; `ab` is the pending
// GroupNorm affine of that input, (2, c) f32 (row 0 = a, row 1 = b). The
// output y has the same geometry with cout channels; the caller zeroes it
// and the kernel writes only the interior, so the ring stays exactly 0.
// `sums` (2, cout) f32: per-channel sum and sum of squares of the f32
// output before its bf16 cast.
//
// GEMM view. Rows (M) are flat positions of the padded buffer, (px * Yp +
// py) * Zp + pz, over the output planes 1..X, ring positions included and
// dropped in the epilogue; N is cout; K is each input's channels x 27
// taps. A tap (dx, dy, dz) shifts a row by the constant (dx - 1) Yp Zp +
// (dy - 1) Zp + (dz - 1). The plan is kernel C's (row_plan.cuh): a block
// owns 512, 256 or 128 rows (two consumer warpgroups, one to four wgmma M
// halves of 64 each) and an N tile of 32, 64 or 128 channels, and runs K
// over input 0's 64-channel chunks, then input 1's (the decoder's skip and
// upsampled buffers, each with its own affine and its own packed weight
// columns, into the same f32 accumulators, so the concat never exists),
// then the three dx, then the nine (dy, dz). For each (chunk, dx) it
// stages once, with cp.async into a 128-byte-swizzled buffer, the run of
// input rows the nine taps read (its rows plus Zp + 1 on each side; where
// two runs do not fit, very deep Z, one run per dy with one row on each
// side), ring and out-of-range positions as zero fill. Each thread then
// normalizes in shared memory the 16-byte pieces it copied, bf16(f32(x) *
// a + b) with explicit roundings (no FMA contraction: the plain version's
// value, rounded once), at the same swizzled address; pieces off the
// interior (in halo mode: off the valid planes' (y, z) interior) stay 0
// and are never normalized to +b, `_norm_plane`'s rule
// (conv_pallas.py:293-315). The next run is loaded and normalized while
// the tensor cores run this one (for one-dy runs, just before its first
// tap), and a fence.proxy.async before the barrier that releases a run
// orders the normalized writes before wgmma's async-proxy reads. A tap's A
// operand is the run at the tap's shifted rows, read by wgmma through a
// descriptor that starts at the shifted row (the swizzle is applied to
// absolute address bits; wgmma.cuh); B, the tap's weight tile (N rows x 64
// K, K-major), comes from a 5-stage cp.async ring 3 taps ahead. The packed
// weight is (27, npad, ktot): ktot the sum of each input's channels
// rounded up to 64, npad cout rounded up to the N tile; a 32-channel input
// leaves half of its chunk zero (both its staged rows and its weights).
//
// Epilogue, on the f32 accumulators in registers: bias, ReLU, the stat
// sums over the block's interior rows (in halo mode only planes where
// valid_out != 0), then bf16 into y. Every load (bias, valid_out) comes
// before the first store. Each block writes one row of partial sums, which
// fold.cuh adds in a fixed order: no atomics, so y and the sums are the
// same in every run.
//
// Halo mode, a shard's slab of the volume along X
// (`unetsulc_tpu_torch/parallel/sp_fused.py`): an input's planes 0 and X+1
// are its neighbours' boundary planes, the separate (Y+2, Z+2, c) operands
// lo and hi (the buffer's own ring planes are never read, and no
// (X+2)-plane copy is made): the staging picks each row piece's source.
// `valid` ((X+2,) f32) says which planes hold data; a plane where it is 0
// reads as 0. Output planes where `valid_out` is 0 (a duplicated
// neighbour plane that another shard owns) are not written and add
// nothing to the sums.
//
// What bounds it on this card: operations, 2 * voxels * 27 * cin * cout
// FLOP at the bf16 tensor-core rate; the bytes (the inputs and y once,
// the weights) are far below the H100's ~295 FLOP/byte ridge at the
// flagship's widths.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fold.cuh"
#include "row_plan.cuh"
#include "wgmma.cuh"

namespace {

using namespace hopper;

// rows of a run that one thread stages (every THREADS / 8-th, one 16-byte
// piece each): at most 32, one bit each of a mask
constexpr int ROW_STEP = THREADS / 8;
constexpr int MAX_RUN_ROWS = 32 * ROW_STEP;

// One input of the conv: a padded channels-last buffer, its affine and, in
// halo mode, its two neighbour planes and its planes' validity.
struct Input {
  const __nv_bfloat16* x;   // (X+2, Y+2, Z+2, c)
  const __nv_bfloat16* lo;  // (Y+2, Z+2, c) or null (halo mode)
  const __nv_bfloat16* hi;
  const float* valid;       // (X+2,) in halo mode, else null
  const float* ab;          // (2, c)
  int c;
  int chunks;               // ceil(c / BKC)
};

struct FwdArgs {
  Input in0, in1;
  const __nv_bfloat16* w;   // (27, npad, ktot)
  const float* bias;        // (cout,)
  const float* valid_out;   // (X+2,) or null
  __nv_bfloat16* y;         // (X+2, Y+2, Z+2, cout), zeroed
  float* partial;           // (gridDim.x, 2, cout)
  int chunks, npad, ktot, cout, X, Y, Z;
};

template <int NT, int HALVES>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3x3_fwd_kernel(const FwdArgs p) {
  constexpr int BM = 128 * HALVES;  // rows per block
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* red = reinterpret_cast<float*>(smem_raw + (base - raw));

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;          // warpgroup: rows BM / 2 wg + ...
  const int wi = (tid >> 5) & 3;    // warp in the warpgroup
  const int Yp = p.Y + 2, Zp = p.Z + 2;
  const int YZp = Yp * Zp;
  const int total = (p.X + 2) * YZp;  // positions of the buffer
  const float inv_yz = 1.0f / (float)YZp, inv_z = 1.0f / (float)Zp;
  const bool halo = p.in0.valid != nullptr;
  const int rows_end = (p.X + 1) * YZp;  // output rows: planes 1..X
  const int m0 = YZp + blockIdx.x * BM;
  const int n0 = blockIdx.y * NT;
  const int dyg = dy_group(BM, NT, Zp);   // dy per run
  const int groups = 3 / dyg;             // runs per (chunk, dx)
  const int tpr = 3 * dyg;                // taps per run
  const int nrows = run_rows(BM, Zp, dyg);
  const uint32_t rbytes = run_bytes(BM, Zp, dyg);
  const uint32_t ring = base + 2 * rbytes;  // weight-tile ring
  const int ntaps = p.chunks * 27;
  const int nruns = p.chunks * 3 * groups;
  // this thread stages piece pc of rows r0 + ROW_STEP i, i < items
  const int pc = tid & 7, r0 = tid >> 3;
  const int items = (nrows - r0 + ROW_STEP - 1) / ROW_STEP;

  // the input of run i's chunk, and the first of its channels that this
  // thread stages
  auto run_input = [&](int i, int& ch) {
    const int k = i / (3 * groups);
    const bool second = k >= p.in0.chunks;
    ch = (second ? k - p.in0.chunks : k) * BKC + pc * 8;
    return second ? p.in1 : p.in0;
  };

  // the affine of this thread's 8 channels from ch (0 past c)
  auto affine = [&](const Input& in, int ch, float* fa, float* fb) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool ok = ch + j < in.c;
      fa[j] = ok ? in.ab[ch + j] : 0.0f;
      fb[j] = ok ? in.ab[in.c + ch + j] : 0.0f;
    }
  };

  // run i -> buffer b: the input rows m0 + (dx - 1) Yp Zp + (dy0 - 1) Zp
  // - 1 + r, r < nrows, of the chunk's 64 channels, raw, zero off the
  // interior and on invalid planes. Returns the mask of this thread's
  // pieces that hold data (bit i: row r0 + ROW_STEP i), which normalize
  // then transforms. Inputs whose channels are not a multiple of 8 are
  // loaded element by element and normalized here (mask bit 0).
  auto load_run = [&](int i, int b) {
    int ch;
    const Input in = run_input(i, ch);
    const int gi = i % groups, dxi = (i / groups) % 3;
    const int q0 = m0 + (dxi - 1) * YZp + (gi * dyg - 1) * Zp - 1;
    const uint32_t dst0 = base + b * rbytes;
    const bool vec = (in.c % 8) == 0;
    float fa[8], fb[8];
    if (!vec) affine(in, ch, fa, fb);
    uint32_t mask = 0;
    for (int it = 0; it < items; ++it) {
      const int r = r0 + ROW_STEP * it;
      const int q = q0 + r;
      const __nv_bfloat16* row = nullptr;  // the position's channels
      if (ch < in.c && q >= 0 && q < total) {
        const int px = div_pos(q, YZp, inv_yz), rem = q - px * YZp;
        const int py = div_pos(rem, Zp, inv_z), pz = rem - py * Zp;
        if (py >= 1 && py <= p.Y && pz >= 1 && pz <= p.Z) {
          if (!halo) {
            if (px >= 1 && px <= p.X) row = in.x + (long long)q * in.c;
          } else if (in.valid[px] != 0.0f) {
            row = px == 0       ? in.lo + (long long)rem * in.c
                  : px == p.X + 1 ? in.hi + (long long)rem * in.c
                                  : in.x + (long long)q * in.c;
          }
        }
      }
      const uint32_t dst = dst0 + swz(r, pc);
      if (vec) {
        cp_async16(dst, row != nullptr ? row + ch : in.x,
                   row != nullptr ? 16 : 0);
        mask |= (row != nullptr ? 1u : 0u) << it;
      } else {
        __align__(16) __nv_bfloat16 v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = (row != nullptr && ch + j < in.c)
                     ? __float2bfloat16(__fadd_rn(
                           __fmul_rn(__bfloat162float(row[ch + j]), fa[j]),
                           fb[j]))
                     : __float2bfloat16(0.0f);
        st_shared16(dst, *reinterpret_cast<const uint4*>(v));
      }
    }
    return mask;
  };

  // items [lo, hi) of run i (in buffer b) that this thread copied and that
  // hold data (mask), normalized in place: bf16(f32(x) * a + b), explicit
  // roundings, one bf16 cast
  auto normalize = [&](int i, int b, uint32_t mask, int lo, int hi) {
    if (lo >= 32) return;
    mask &= (hi >= 32 ? ~0u : (1u << hi) - 1u) & ~((1u << lo) - 1u);
    if (mask == 0) return;
    int ch;
    const Input in = run_input(i, ch);
    float fa[8], fb[8];
    affine(in, ch, fa, fb);
    const uint32_t dst0 = base + b * rbytes;
    while (mask != 0) {
      const int it = __ffs(mask) - 1;
      mask &= mask - 1;
      const uint32_t addr = dst0 + swz(r0 + ROW_STEP * it, pc);
      uint4 u = ld_shared16(addr);
      uint32_t* u32 = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&u32[k]));
        const __nv_bfloat162 o = __floats2bfloat162_rn(
            __fadd_rn(__fmul_rn(f.x, fa[2 * k]), fb[2 * k]),
            __fadd_rn(__fmul_rn(f.y, fa[2 * k + 1]), fb[2 * k + 1]));
        u32[k] = *reinterpret_cast<const uint32_t*>(&o);
      }
      st_shared16(addr, u);
    }
  };

  // the tap of the j-th step (runs in order, taps of a run in order)
  auto tap_of = [&](int j) {
    const int i = j / tpr, t = j % tpr;
    return ((i / groups) % 3) * 9 + ((i % groups) * dyg + t / 3) * 3 + t % 3;
  };

  // weight tile j (chunk j / 27) -> ring stage s: NT rows (cout) of 64
  // packed K columns, K-major
  auto load_w = [&](int j, int s) {
    const __nv_bfloat16* src0 =
        p.w + ((long long)tap_of(j) * p.npad + n0) * p.ktot + (j / 27) * BKC;
    const uint32_t dst0 = ring + s * (NT * 128);
    for (int it = tid; it < NT * 8; it += THREADS) {
      const int r = it >> 3, c = it & 7;
      cp_async16(dst0 + swz(r, c), src0 + (long long)r * p.ktot + c * 8, 16);
    }
  };

  uint32_t mnext = 0;  // the mask of the run staged ahead
#pragma unroll 1
  for (int j = 0; j < LEAD; ++j) {
    if (j == 0) mnext = load_run(0, 0);
    if (j < ntaps) load_w(j, j % STAGES);
    cp_async_commit();
  }
  cp_async_wait<LEAD - 1>();  // this thread's copies of run 0
  normalize(0, 0, mnext, 0, 32);

  float acc[HALVES][NT / 2];
#pragma unroll
  for (int h = 0; h < HALVES; ++h)
#pragma unroll
    for (int e = 0; e < NT / 2; ++e) acc[h][e] = 0.0f;
  // the first row of this warpgroup's rows in a run
  const int arow = wg * (BM / 2);
  // a nine-tap run's successor is normalized over its taps 4..8, in parts
  const int per = (items + 4) / 5;

#pragma unroll 1
  for (int j = 0; j < ntaps; ++j) {
    const int i = j / tpr, t = j % tpr;
    cp_async_wait<LEAD - 1>();  // tile j (and, where it was due, a run)
    // a three-tap run is normalized just before its first tap: it lands
    // only then
    if (tpr == 3 && t == 0 && i > 0) normalize(i, i & 1, mnext, 0, 32);
    fence_proxy_async();
    __syncthreads();
    // The stage refilled here held tile j - 2, whose wgmmas every
    // warpgroup has finished (wgmma_wait<1> after tile j - 1). The next
    // run goes into the buffer of the run before last, once the wgmmas
    // that read it are done: at the second tap of a 9-tap run, and at the
    // first of a 3-tap run (its last tile waited for with wgmma_wait<0>).
    if (j + LEAD < ntaps) load_w(j + LEAD, (j + LEAD) % STAGES);
    if (t == (tpr == 9 ? 1 : 0) && i + 1 < nruns)
      mnext = load_run(i + 1, (i + 1) & 1);
    cp_async_commit();

    // the tap's A: the warpgroup's rows of the run, shifted by the tap;
    // the descriptor starts at the shifted row (see wgmma_ss_m64k16)
    const uint32_t a0 =
        base + (i & 1) * rbytes + (arow + (t / 3) * Zp + t % 3) * 128;
    const uint32_t wt = ring + (j % STAGES) * (NT * 128);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKC / 16; ++kk) {
      const uint64_t db = desc_sw128(wt + kk * 32);
#pragma unroll
      for (int h = 0; h < HALVES; ++h)
        wgmma_ss_m64k16<NT, 0, 0>(
            acc[h], desc_sw128(a0 + h * 64 * 128 + kk * 32), db);
    }
    wgmma_commit();
    // while they run: a part of the next run, which landed by tap 4 (its
    // copies went out at tap 1, in the group of tile j + LEAD)
    if (tpr == 9 && t >= 4 && i + 1 < nruns) {
      normalize(i + 1, (i + 1) & 1, mnext, (t - 4) * per, (t - 3) * per);
      fence_proxy_async();
    }
    if (tpr == 3 && t == 2)
      wgmma_wait<0>();
    else
      wgmma_wait<1>();
  }
  wgmma_wait<0>();
  cp_async_wait<0>();
  __syncthreads();  // the runs' memory becomes the reduction scratch

  // epilogue: each thread holds, in each half, rows g and g + 8 of its
  // warp's 16, columns 8 j + 2 t and + 1 (j < NT / 8)
  const int g = lane >> 2, t = lane & 3;
  // every load before the first store: a load issued after a store that
  // it might alias waits for it. Bias and ReLU first, in place, so that
  // the bias is dead before the sums are live.
#pragma unroll
  for (int jn = 0; jn < NT / 8; ++jn)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + 8 * jn + 2 * t + e;
      const float bn = n < p.cout ? p.bias[n] : 0.0f;
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& v = acc[hf][4 * jn + 2 * h + e];
          v = fmaxf(v + bn, 0.0f);
        }
    }
  // bit 2 hf + h: this thread's row h of half hf is an output (in the
  // interior, before the rows' end, on a plane valid_out keeps)
  uint32_t keep = 0;
#pragma unroll
  for (int hf = 0; hf < HALVES; ++hf)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int P = m0 + wg * (BM / 2) + hf * 64 + wi * 16 + g + 8 * h;
      if (P >= rows_end) continue;
      const int px = div_pos(P, YZp, inv_yz), rem = P - px * YZp;
      const int py = div_pos(rem, Zp, inv_z), pz = rem - py * Zp;
      if (py < 1 || py > p.Y || pz < 1 || pz > p.Z) continue;
      if (p.valid_out != nullptr && p.valid_out[px] == 0.0f) continue;
      keep |= 1u << (2 * hf + h);
    }

  float s0[NT / 4], s1[NT / 4];
#pragma unroll
  for (int e = 0; e < NT / 4; ++e) s0[e] = s1[e] = 0.0f;
  const bool pairs = (p.cout & 1) == 0;  // channel pairs are 4-byte aligned
#pragma unroll
  for (int hf = 0; hf < HALVES; ++hf)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!(keep >> (2 * hf + h) & 1u)) continue;
      const int P = m0 + wg * (BM / 2) + hf * 64 + wi * 16 + g + 8 * h;
      __nv_bfloat16* out = p.y + (long long)P * p.cout;
#pragma unroll
      for (int jn = 0; jn < NT / 8; ++jn) {
        const int n = n0 + 8 * jn + 2 * t;
        const float v0 = acc[hf][4 * jn + 2 * h];
        const float v1 = acc[hf][4 * jn + 2 * h + 1];
        if (n < p.cout) {
          s0[2 * jn] += v0;
          s1[2 * jn] += v0 * v0;
        }
        if (n + 1 < p.cout) {
          s0[2 * jn + 1] += v1;
          s1[2 * jn + 1] += v1 * v1;
        }
        if (pairs && n < p.cout) {
          *reinterpret_cast<__nv_bfloat162*>(out + n) =
              __halves2bfloat162(__float2bfloat16(v0), __float2bfloat16(v1));
        } else {
          if (n < p.cout) out[n] = __float2bfloat16(v0);
          if (n + 1 < p.cout) out[n + 1] = __float2bfloat16(v1);
        }
      }
    }
  // over the 8 row groups of the warp (lanes of equal t), then the 8 warps
#pragma unroll
  for (int e = 0; e < NT / 4; ++e) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      s0[e] += __shfl_xor_sync(0xffffffffu, s0[e], o);
      s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], o);
    }
  }
  const int warp = tid >> 5;
  if (g == 0) {
#pragma unroll
    for (int jn = 0; jn < NT / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * jn + 2 * t + e;
        red[(warp * 2 + 0) * NT + col] = s0[2 * jn + e];
        red[(warp * 2 + 1) * NT + col] = s1[2 * jn + e];
      }
  }
  __syncthreads();
  if (tid < NT && n0 + tid < p.cout) {
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      a0 += red[(w * 2 + 0) * NT + tid];
      a1 += red[(w * 2 + 1) * NT + tid];
    }
    float* row = p.partial + (long long)blockIdx.x * 2 * p.cout;
    row[n0 + tid] = a0;
    row[p.cout + n0 + tid] = a1;
  }
}

// Output rows of one launch (the positions of planes 1..X, either mode),
// its N tiles and rows per block, and its rows of partials (one per block
// row).
long long out_rows(int X, int Y, int Z) {
  return (long long)X * (Y + 2) * (Z + 2);
}

int n_tiles(int cout) {
  return (cout + tile_n(cout) - 1) / tile_n(cout);
}

int block_rows(int cout, int X, int Y, int Z) {
  return rows_per_block(out_rows(X, Y, Z), n_tiles(cout), tile_n(cout),
                        Z + 2);
}

long long sum_rows(int cout, int X, int Y, int Z) {
  const int bm = block_rows(cout, X, Y, Z);
  return (out_rows(X, Y, Z) + bm - 1) / bm;
}

template <int NT, int HALVES>
cudaError_t launch_nt(const FwdArgs& a, dim3 grid, uint32_t smem,
                      cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3x3_fwd_kernel<NT, HALVES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  conv3x3x3_fwd_kernel<NT, HALVES><<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

template <int HALVES>
cudaError_t launch_bm(int nt, const FwdArgs& a, dim3 grid, uint32_t smem,
                      cudaStream_t st) {
  if constexpr (HALVES == 4) {  // N tiles up to 64 only
    return nt == 32 ? launch_nt<32, 4>(a, grid, smem, st)
                    : launch_nt<64, 4>(a, grid, smem, st);
  } else {
    return nt == 32   ? launch_nt<32, HALVES>(a, grid, smem, st)
           : nt == 64 ? launch_nt<64, HALVES>(a, grid, smem, st)
                      : launch_nt<128, HALVES>(a, grid, smem, st);
  }
}

Input make_input(const void* x, const float* ab, int c, const void* lo,
                 const void* hi, const float* valid) {
  Input in;
  in.x = static_cast<const __nv_bfloat16*>(x);
  in.lo = static_cast<const __nv_bfloat16*>(lo);
  in.hi = static_cast<const __nv_bfloat16*>(hi);
  in.valid = valid;
  in.ab = ab;
  in.c = c;
  in.chunks = (c + BKC - 1) / BKC;
  return in;
}

int launch_fwd(const void* x1, const float* ab1, int c1, const void* lo1,
               const void* hi1, const float* v1, const void* x2,
               const float* ab2, int c2, const void* lo2, const void* hi2,
               const float* v2, int n_inputs, const void* w, int npad,
               const float* bias, int cout, int X, int Y, int Z,
               const float* valid_out, void* y, float* sums, float* ws,
               void* stream) {
  const int nt = tile_n(cout);
  const int bm = block_rows(cout, X, Y, Z);
  const int dyg = dy_group(bm, nt, Z + 2);
  const uint32_t smem = smem_bytes(bm, nt, Z + 2, dyg);
  const int cmax = c1 > c2 ? c1 : c2;
  if (npad % nt != 0 || npad < cout || smem > (uint32_t)SMEM_LIMIT ||
      run_rows(bm, Z + 2, dyg) > MAX_RUN_ROWS || n_inputs < 1 ||
      n_inputs > 2 ||
      out_rows(X + 2, Y, Z) * (long long)(cmax > cout ? cmax : cout) >
          0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  FwdArgs a;
  a.in0 = make_input(x1, ab1, c1, lo1, hi1, v1);
  a.in1 = n_inputs > 1 ? make_input(x2, ab2, c2, lo2, hi2, v2) : a.in0;
  a.chunks = a.in0.chunks + (n_inputs > 1 ? a.in1.chunks : 0);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = bias;
  a.valid_out = valid_out;
  a.y = static_cast<__nv_bfloat16*>(y);
  a.partial = ws;
  a.npad = npad;
  a.ktot = a.chunks * BKC;
  a.cout = cout;
  a.X = X;
  a.Y = Y;
  a.Z = Z;
  const long long rows = sum_rows(cout, X, Y, Z);
  const dim3 grid((unsigned)rows, (unsigned)(npad / nt));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = bm == 512   ? launch_bm<4>(nt, a, grid, smem, st)
                    : bm == 256 ? launch_bm<2>(nt, a, grid, smem, st)
                                : launch_bm<1>(nt, a, grid, smem, st);
  if (err != cudaSuccess) return (int)err;
  const long long cols = 2LL * cout;
  return (int)fold::fold_cols(ws, rows, cols, ws + rows * cols, sums, st);
}

}  // namespace

// Tile widths that the wrapper's packer and plan mirror: what = 0 the K
// chunk (input channels), 1 the weight-ring stages, 2 the N tile for
// `cout` output channels, 3 the rows per block and 4 the dy per staged run
// of a launch of `cout` output channels over an X x Y x Z interior (either
// mode: the output rows are the same).
extern "C" int conv3x3x3_fwd_tile(int what, int cout, int X, int Y, int Z) {
  switch (what) {
    case 0: return BKC;
    case 1: return STAGES;
    case 2: return tile_n(cout);
    case 3: return block_rows(cout, X, Y, Z);
    case 4: return dy_group(block_rows(cout, X, Y, Z), tile_n(cout), Z + 2);
    default: return -1;
  }
}

// f32 workspace of one launch of kernel A (either mode) over an X x Y x Z
// interior with cout output channels. -1 if it does not fit an int.
extern "C" int conv3x3x3_fwd_ws(int cout, int X, int Y, int Z) {
  const long long rows = sum_rows(cout, X, Y, Z), cols = 2LL * cout;
  const long long n = rows * cols + fold::scratch_floats(rows, cols);
  return n > 0x7fffffffLL ? -1 : (int)n;
}

// Kernel A: x1 (and x2 when n_inputs == 2) (X+2, Y+2, Z+2, c_i) bf16 with
// their (2, c_i) f32 affines -> y (X+2, Y+2, Z+2, cout) bf16 (zeroed by the
// caller), sums (2, cout) f32; w: the packed weight (27, npad, ktot) bf16,
// npad = cout rounded up to conv3x3x3_fwd_tile(2, cout), ktot = the sum of
// the c_i rounded up to 64; ws: conv3x3x3_fwd_ws(cout, X, Y, Z) f32.
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
// valid_out (X+2,) f32 (or null) the planes this shard writes and counts.
extern "C" int conv3x3x3_fwd_halo(
    const void* x1, const float* ab1, int c1, const void* lo1,
    const void* hi1, const float* v1, const void* x2, const float* ab2,
    int c2, const void* lo2, const void* hi2, const float* v2, int n_inputs,
    const void* w, int npad, const float* bias, int cout, int X, int Y, int Z,
    const float* valid_out, void* y, float* sums, float* ws, void* stream) {
  if (v1 == nullptr || (n_inputs > 1 && v2 == nullptr))
    return (int)cudaErrorInvalidValue;
  return launch_fwd(x1, ab1, c1, lo1, hi1, v1, x2, ab2, c2, lo2, hi2, v2,
                    n_inputs, w, npad, bias, cout, X, Y, Z, valid_out, y, sums,
                    ws, stream);
}
