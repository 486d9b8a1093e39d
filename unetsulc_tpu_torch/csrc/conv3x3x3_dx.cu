// Kernel C: the input gradient of one input branch of the fused 'crg' conv
// block, for Hopper (sm_90a), as an implicit GEMM on wgmma.mma_async.
//
// Replaces: unetsulc_tpu/ops/conv_pallas.py `_fwd_kernel` in post (dx)
// mode (`conv_shards(post_ab=..., post_x=...)` from `_fused_bwd`) as
// `conv3x3x3_dx`, and its `edge_outputs` spatial-parallel mode
// (conv_pallas.py:504-510 with `_fused_bwd`'s halo branch, :1405-1425) as
// `conv3x3x3_dx_halo`.
//
// What it computes. dconv: (X+2, Y+2, Z+2, c) bf16, the cotangent of the
// conv's pre-activation (only its interior is read). w: the branch's
// mirrored, transposed taps Wt[tap][ci][co] = W[co][ci][26 - tap], packed
// by the wrapper as (27, npad, kpad) bf16: ci (the GEMM's N) padded to the
// N tile, co (the GEMM's K) padded to 64. dxn = conv^T(dconv, W) for the
// branch's cout channels (cout here is the branch's forward Cin). The
// epilogue adds sum(post_x * dxn) and sum(dxn) per channel (post_x: the
// branch's raw bf16 forward input) and writes dx = bf16(dxn * a) (a = row
// 0 of the branch's forward affine) into a zeroed buffer, interior only,
// as conv_pallas.py:519-545 does.
//
// Halo mode (a shard's slab of the volume along X,
// `unetsulc_tpu_torch/parallel/sp_fused.py`): dxn is also computed at the
// two X ring planes (the gradients of the neighbours' planes), written to
// the separate (Y+2, Z+2, cout) outputs dlo and dhi; post_x's ring planes
// are the forward's halo planes post_lo and post_hi; valid ((X+2,) f32)
// zeroes dx on invalid planes and leaves them out of the sums.
//
// GEMM view. Rows (M) are flat positions of the padded buffer, (px * Yp +
// py) * Zp + pz, over the output planes (1..X, or 0..X+1 in halo mode),
// ring positions included and dropped in the epilogue. A tap (dx, dy, dz)
// shifts a row by a constant, (dx - 1) Yp Zp + (dy - 1) Zp + (dz - 1). A
// block owns 512, 256 or 128 consecutive rows (two consumer warpgroups,
// each one to four wgmma M halves of 64, by launch shape) and an N tile
// of 32, 64 or 128 channels, and runs K over 64-channel chunks of dconv,
// then the three dx, then the nine
// (dy, dz). For each (chunk, dx) it stages once in shared memory, with
// cp.async, the run of dconv rows that the nine taps read: its rows plus
// Zp + 1 on each side (the halo), ring and out-of-range positions as 0;
// two runs are in flight. (Where two such runs and the weight ring do not
// fit even in 128-row blocks, for Z beyond 225 to 345, a run serves the
// three taps of one (dx, dy) and its halo is one row on each side.) A
// tap's A operand is the run at the tap's shifted rows, read by wgmma
// from shared memory through a descriptor that starts at the shifted row:
// the 128-byte swizzle is applied to absolute address bits, so a whole-row
// shift keeps the layout the descriptor expects (wgmma.cuh). B, the tap's
// weight tile (N rows x 64 channels, K-major), comes the same way from a
// ring of 5 stages that cp.async keeps 3 taps ahead of the math. A tap's
// wgmmas (4 K steps x the M halves) go out as one group; f32 accumulators
// stay in registers across all taps.
//
// The sums reduce over the block's rows into one row of partials per block
// (the caller's f32 workspace), which fold.cuh adds up in a fixed order:
// no atomics, so dx and the sums are the same in every run.
//
// What bounds it on this card: operations, 2 * voxels * 27 * c * cout
// FLOP at the bf16 tensor-core rate (its branch's forward conv's FLOP);
// the bytes (dconv, post_x and dx once, the weights) are far below the
// H100's ~295 FLOP/byte ridge at the flagship's widths.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fold.cuh"
#include "row_plan.cuh"
#include "wgmma.cuh"

namespace {

using namespace hopper;

struct DxArgs {
  const __nv_bfloat16* dconv;  // (X+2, Y+2, Z+2, c)
  const __nv_bfloat16* w;      // (27, npad, kpad)
  const float* post_a;         // (cout,)
  const __nv_bfloat16* post_x; // (X+2, Y+2, Z+2, cout)
  const __nv_bfloat16* post_lo;
  const __nv_bfloat16* post_hi;
  const float* valid;          // (X+2,) in halo mode, else null
  __nv_bfloat16* dx;           // (X+2, Y+2, Z+2, cout), zeroed
  __nv_bfloat16* dlo;          // (Y+2, Z+2, cout), zeroed (halo mode)
  __nv_bfloat16* dhi;
  float* partial;              // (gridDim.x, 2, cout)
  int c, npad, kpad, cout, X, Y, Z;
};

template <int NT, int HALVES>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3x3_dx_kernel(const DxArgs p) {
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
  const float inv_yz = 1.0f / (float)YZp, inv_z = 1.0f / (float)Zp;
  const bool halo = p.valid != nullptr;
  const int row0 = halo ? 0 : YZp;                      // first output row
  const int rows = (halo ? p.X + 2 : p.X) * YZp;        // output rows
  const int m0 = row0 + blockIdx.x * BM;
  const int n0 = blockIdx.y * NT;
  const int dyg = dy_group(BM, NT, Zp);   // dy per run
  const int tpr = 3 * dyg;                // taps per run
  const int nrows = run_rows(BM, Zp, dyg);
  const uint32_t rbytes = run_bytes(BM, Zp, dyg);
  const uint32_t ring = base + 2 * rbytes;  // weight-tile ring
  const int ntaps = (p.kpad / BKC) * 27;
  const bool vec = (p.c % 8) == 0;

  // run i = (chunk, dx, dy group) -> buffer b: the dconv rows
  // m0 + (dx - 1) Yp Zp + (dy0 - 1) Zp - 1 + r, r < nrows, of the
  // chunk's 64 channels; positions off the interior are 0
  auto load_run = [&](int i, int b) {
    const int groups = 3 / dyg;
    const int gi = i % groups, dxi = (i / groups) % 3, ch0 = i / groups / 3 * BKC;
    const int q0 = m0 + (dxi - 1) * YZp + (gi * dyg - 1) * Zp - 1;
    const uint32_t dst0 = base + b * rbytes;
    for (int it = tid; it < nrows * 8; it += THREADS) {
      const int r = it >> 3, pc = it & 7;
      const int q = q0 + r;
      const int ch = ch0 + pc * 8;
      bool in = q >= YZp && ch < p.c;
      if (in) {
        const int px = div_pos(q, YZp, inv_yz), rem = q - px * YZp;
        const int py = div_pos(rem, Zp, inv_z), pz = rem - py * Zp;
        in = px <= p.X && py >= 1 && py <= p.Y && pz >= 1 && pz <= p.Z;
      }
      const __nv_bfloat16* src = p.dconv + (long long)q * p.c + ch;
      const uint32_t dst = dst0 + swz(r, pc);
      if (vec) {
        cp_async16(dst, in ? src : p.dconv, in ? 16 : 0);
      } else {
        __align__(16) __nv_bfloat16 v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = (in && ch + j < p.c) ? src[j] : __float2bfloat16(0.0f);
        st_shared16(dst, *reinterpret_cast<const uint4*>(v));
      }
    }
  };

  // the tap of the j-th step (runs in order, taps of a run in order)
  auto tap_of = [&](int j) {
    const int i = j / tpr, t = j % tpr;
    const int groups = 3 / dyg;
    return ((i / groups) % 3) * 9 + ((i % groups) * dyg + t / 3) * 3 + t % 3;
  };

  // weight tile j (chunk j / 27) -> ring stage s: NT rows (ci) of 64
  // channels (co), K-major
  auto load_w = [&](int j, int s) {
    const __nv_bfloat16* src0 =
        p.w + ((long long)tap_of(j) * p.npad + n0) * p.kpad + (j / 27) * BKC;
    const uint32_t dst0 = ring + s * (NT * 128);
    for (int it = tid; it < NT * 8; it += THREADS) {
      const int r = it >> 3, pc = it & 7;
      cp_async16(dst0 + swz(r, pc), src0 + (long long)r * p.kpad + pc * 8,
                 16);
    }
  };

#pragma unroll 1
  for (int j = 0; j < LEAD; ++j) {
    if (j == 0) load_run(0, 0);
    if (j < ntaps) load_w(j, j % STAGES);
    cp_async_commit();
  }

  float acc[HALVES][NT / 2];
#pragma unroll
  for (int h = 0; h < HALVES; ++h)
#pragma unroll
    for (int e = 0; e < NT / 2; ++e) acc[h][e] = 0.0f;
  // the first row of this warpgroup's rows in a run
  const int arow = wg * (BM / 2);

#pragma unroll 1
  for (int j = 0; j < ntaps; ++j) {
    cp_async_wait<LEAD - 1>();  // tile j (and, at a run's first tap, the run)
    fence_proxy_async();
    __syncthreads();
    // The stage refilled here held tile j - 2, whose wgmmas every
    // warpgroup has finished (wgmma_wait<1> after tile j - 1). The next
    // run goes into the buffer of the run before last, once the wgmmas
    // that read it are done: at the second tap of a 9-tap run (after
    // tile j - 1, that run's last, is waited for), and at the first of a
    // 3-tap run (its last tile waited for with wgmma_wait<0>), so that it
    // lands LEAD taps later, in time.
    if (j + LEAD < ntaps) load_w(j + LEAD, (j + LEAD) % STAGES);
    if (j % tpr == (tpr == 9 ? 1 : 0) && j - j % tpr + tpr < ntaps)
      load_run(j / tpr + 1, (j / tpr + 1) & 1);
    cp_async_commit();

    // the tap's A: the warpgroup's rows of the run, shifted by the tap;
    // the descriptor starts at the shifted row (see wgmma_ss_m64k16)
    const int t = j % tpr;
    const uint32_t a0 = base + ((j / tpr) & 1) * rbytes +
                        (arow + (t / 3) * Zp + t % 3) * 128;
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
    if (tpr == 3 && (j + 1) % tpr == 0)
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
  float s0[NT / 4], s1[NT / 4];
#pragma unroll
  for (int e = 0; e < NT / 4; ++e) s0[e] = s1[e] = 0.0f;
  const bool pairs = (p.cout & 1) == 0;  // channel pairs are 4-byte aligned
  // the affine's scale of this thread's columns, read once: a read after
  // a store it might alias would wait for it
  float pa[NT / 4];
#pragma unroll
  for (int jn = 0; jn < NT / 8; ++jn)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + 8 * jn + 2 * t + e;
      pa[2 * jn + e] = n < p.cout ? p.post_a[n] : 0.0f;
    }
#pragma unroll
  for (int hf = 0; hf < HALVES; ++hf) {
    // the half's two rows of this thread: their post_x and dx rows (null:
    // not an output: off the interior, past the rows, an invalid plane)
    const __nv_bfloat16* post[2];
    __nv_bfloat16* out[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      post[h] = nullptr;
      out[h] = nullptr;
      const int P = m0 + wg * (BM / 2) + hf * 64 + wi * 16 + g + 8 * h;
      if (P >= row0 + rows) continue;
      const int px = div_pos(P, YZp, inv_yz), rem = P - px * YZp;
      const int py = div_pos(rem, Zp, inv_z), pz = rem - py * Zp;
      if (py < 1 || py > p.Y || pz < 1 || pz > p.Z) continue;
      if (halo && p.valid[px] == 0.0f) continue;
      const long long yz = (long long)py * Zp + pz;
      if (halo && px == 0) {
        post[h] = p.post_lo + yz * p.cout;
        out[h] = p.dlo + yz * p.cout;
      } else if (halo && px == p.X + 1) {
        post[h] = p.post_hi + yz * p.cout;
        out[h] = p.dhi + yz * p.cout;
      } else {
        post[h] = p.post_x + (long long)P * p.cout;
        out[h] = p.dx + (long long)P * p.cout;
      }
    }
    if (pairs) {
      // all loads first: a load issued after a store it might alias would
      // wait for it
      __nv_bfloat162 xv[2][NT / 8];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int jn = 0; jn < NT / 8; ++jn) {
          const int n = n0 + 8 * jn + 2 * t;
          xv[h][jn] = (post[h] != nullptr && n < p.cout)
                          ? *reinterpret_cast<const __nv_bfloat162*>(post[h] + n)
                          : __floats2bfloat162_rn(0.0f, 0.0f);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int jn = 0; jn < NT / 8; ++jn) {
          const int n = n0 + 8 * jn + 2 * t;
          if (out[h] == nullptr || n >= p.cout) continue;
          const float v0 = acc[hf][4 * jn + 2 * h];
          const float v1 = acc[hf][4 * jn + 2 * h + 1];
          s0[2 * jn] += v0 * __low2float(xv[h][jn]);
          s0[2 * jn + 1] += v1 * __high2float(xv[h][jn]);
          s1[2 * jn] += v0;
          s1[2 * jn + 1] += v1;
          *reinterpret_cast<__nv_bfloat162*>(out[h] + n) = __halves2bfloat162(
              __float2bfloat16(v0 * pa[2 * jn]),
              __float2bfloat16(v1 * pa[2 * jn + 1]));
        }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (out[h] == nullptr) continue;
#pragma unroll
        for (int jn = 0; jn < NT / 8; ++jn)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + 8 * jn + 2 * t + e;
            if (n >= p.cout) continue;
            const float v = acc[hf][4 * jn + 2 * h + e];
            s0[2 * jn + e] += v * __bfloat162float(post[h][n]);
            s1[2 * jn + e] += v;
            out[h][n] = __float2bfloat16(v * pa[2 * jn + e]);
          }
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

// Output rows of one launch, its N tiles and rows per block, and its rows
// of partial sums (one per block row).
long long out_rows(int X, int Y, int Z, int edge) {
  return (long long)(X + 2 * edge) * (Y + 2) * (Z + 2);
}

int n_tiles(int cout) {
  return (cout + tile_n(cout) - 1) / tile_n(cout);
}

int block_rows(int cout, int X, int Y, int Z, int edge) {
  return rows_per_block(out_rows(X, Y, Z, edge), n_tiles(cout),
                        tile_n(cout), Z + 2);
}

long long sum_rows(int cout, int X, int Y, int Z, int edge) {
  const int bm = block_rows(cout, X, Y, Z, edge);
  return (out_rows(X, Y, Z, edge) + bm - 1) / bm;
}

template <int NT, int HALVES>
cudaError_t launch_nt(const DxArgs& a, dim3 grid, uint32_t smem,
                      cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3x3_dx_kernel<NT, HALVES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  conv3x3x3_dx_kernel<NT, HALVES><<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

template <int HALVES>
cudaError_t launch_bm(int nt, const DxArgs& a, dim3 grid, uint32_t smem,
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

int launch_dx(const void* dconv, int c, const void* w, int npad,
              const float* post_a, const void* post_x, const void* post_lo,
              const void* post_hi, const float* valid, int cout, int X, int Y,
              int Z, void* dx, void* dlo, void* dhi, float* sums, float* ws,
              void* stream) {
  const int nt = tile_n(cout);
  const int edge = valid != nullptr ? 1 : 0;
  const int bm = block_rows(cout, X, Y, Z, edge);
  const uint32_t smem = smem_bytes(bm, nt, Z + 2, dy_group(bm, nt, Z + 2));
  if (npad % nt != 0 || npad < cout || smem > (uint32_t)SMEM_LIMIT ||
      out_rows(X, Y, Z, 1) * (long long)(c > cout ? c : cout) >
          0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  DxArgs a;
  a.dconv = static_cast<const __nv_bfloat16*>(dconv);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.post_a = post_a;
  a.post_x = static_cast<const __nv_bfloat16*>(post_x);
  a.post_lo = static_cast<const __nv_bfloat16*>(post_lo);
  a.post_hi = static_cast<const __nv_bfloat16*>(post_hi);
  a.valid = valid;
  a.dx = static_cast<__nv_bfloat16*>(dx);
  a.dlo = static_cast<__nv_bfloat16*>(dlo);
  a.dhi = static_cast<__nv_bfloat16*>(dhi);
  a.partial = ws;
  a.c = c;
  a.npad = npad;
  a.kpad = (c + BKC - 1) / BKC * BKC;
  a.cout = cout;
  a.X = X;
  a.Y = Y;
  a.Z = Z;
  const long long rows = sum_rows(cout, X, Y, Z, edge);
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
// chunk (dconv channels), 1 the weight-ring stages, 2 the N tile for
// `cout` output channels, 3 the rows per block of a launch of `cout`
// output channels over an X x Y x Z interior (`edge`: halo mode).
extern "C" int conv3x3x3_dx_tile(int what, int cout, int X, int Y, int Z,
                                 int edge) {
  switch (what) {
    case 0: return BKC;
    case 1: return STAGES;
    case 2: return tile_n(cout);
    case 3: return block_rows(cout, X, Y, Z, edge);
    default: return -1;
  }
}

// f32 workspace of one launch of kernel C over an X x Y x Z interior with
// cout output channels; `edge`: halo mode. -1 if it does not fit an int.
extern "C" int conv3x3x3_dx_ws(int cout, int X, int Y, int Z, int edge) {
  const long long rows = sum_rows(cout, X, Y, Z, edge), cols = 2LL * cout;
  const long long n = rows * cols + fold::scratch_floats(rows, cols);
  return n > 0x7fffffffLL ? -1 : (int)n;
}

// Kernel C: dconv (X+2, Y+2, Z+2, c) bf16 -> dx (X+2, Y+2, Z+2, cout) bf16
// = bf16(conv^T(dconv, W_branch) * post_a), zeroed by the caller, and sums
// (2, cout) f32 += (sum post_x * dxn, sum dxn). w: the branch's mirrored,
// transposed weights packed as (27, npad, round_up(c, 64)) bf16, npad =
// cout rounded up to conv3x3x3_dx_tile(2, cout); ws: conv3x3x3_dx_ws(cout,
// X, Y, Z, 0) f32.
extern "C" int conv3x3x3_dx(const void* dconv, int c, const void* w,
                            int npad, const float* post_a, const void* post_x,
                            int cout, int X, int Y, int Z, void* dx,
                            float* sums, float* ws, void* stream) {
  return launch_dx(dconv, c, w, npad, post_a, post_x, nullptr, nullptr,
                   nullptr, cout, X, Y, Z, dx, nullptr, nullptr, sums, ws,
                   stream);
}

// Kernel C in halo mode (`edge_outputs`): as conv3x3x3_dx, with dxn also at
// padded planes 0 and X+1, written to dlo and dhi ((Y+2, Z+2, cout) bf16,
// zeroed by the caller); post_x's planes 0 and X+1 are post_lo and post_hi
// (the forward's halo planes, null where invalid); valid (X+2,) f32 keeps
// a plane in the sums and in dx where it is nonzero; ws:
// conv3x3x3_dx_ws(cout, X, Y, Z, 1) f32.
extern "C" int conv3x3x3_dx_halo(const void* dconv, int c, const void* w,
                                 int npad, const float* post_a,
                                 const void* post_x, const void* post_lo,
                                 const void* post_hi, const float* valid,
                                 int cout, int X, int Y, int Z, void* dx,
                                 void* dlo, void* dhi, float* sums,
                                 float* ws, void* stream) {
  return launch_dx(dconv, c, w, npad, post_a, post_x, post_lo, post_hi, valid,
                   cout, X, Y, Z, dx, dlo, dhi, sums, ws, stream);
}
