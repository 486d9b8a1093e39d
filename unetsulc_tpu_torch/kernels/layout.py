"""Host-side layout of kernels A (``csrc/conv3x3x3_fwd.cu``), C
(``csrc/conv3x3x3_dx.cu``) and D (``csrc/conv3x3x3_wgrad.cu``): their tile
constants, A's and C's weight packing and the three kernels' launch plans;
the plan of kernel E (``csrc/max_pool_buf_bwd.cu``), of the probe's
kernels (``csrc/mxu_probe.cu``) and of the four GroupNorm kernels
(``csrc/group_norm.cu``); in plain Python so that the CPU tests reach
them. Each constant mirrors one that its library exports
(``conv3x3x3_fwd_tile``, ``conv3x3x3_dx_tile``, ``conv3x3x3_wgrad_tile``,
``max_pool_buf_bwd_tile``, ``mxu_probe_tile``, ``gn_tile``); the library
loader in :mod:`unetsulc_tpu_torch.kernels` compares them when it loads the
library and raises on a mismatch.

Positions. The kernels index the padded (X+2, Y+2, Z+2) buffer by its
flat position ``(px * Yp + py) * Zp + pz``; a tap (dx, dy, dz) shifts a
position by ``(dx - 1) Yp Zp + (dy - 1) Zp + (dz - 1)``. Kernel A's output
rows are the positions of planes 1..X and kernel C's those of planes 1..X
(halo mode: 0..X+1), ring positions included and dropped in their
epilogues; A and C share one plan (``csrc/row_plan.cuh``). Kernel D's K
range is the positions of planes 1..X, where dconv's ring adds nothing.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import torch

# kernels A and C (csrc/row_plan.cuh): K channels per chunk (one 128-byte
# shared-memory row), stages of the weight ring, and the blocks a launch
# keeps when it picks its rows per block (two per SM of an H100)
TILE_K = 64
STAGES = 5
MIN_BLOCKS = 132 * 2
# dynamic shared memory a block may use on an H100
SMEM_LIMIT = 232448
# kernel A: rows of a staged run at most (a thread stages one 16-byte
# piece of every 32nd row, 32 rows at most, one bit of a mask each)
FWD_MAX_RUN_ROWS = 32 * 32

# kernel D: cin and cout channels per block (wgmma M and N), tap groups
# (one block per dx: 9 taps), the blocks a launch aims at (two per SM of
# an H100) and the least K steps per split; its positions per K step are
# wgrad_step(Z)
WGRAD_TILE_CI = 64
WGRAD_TILE_CO = 64
WGRAD_TAP_GROUPS = 3
WGRAD_TARGET_BLOCKS = 132 * 2
WGRAD_MIN_STEPS = 8


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def tile_n(cout: int) -> int:
    """Kernels A's and C's N tile (their wgmma width) for ``cout`` output
    channels."""
    return 32 if cout <= 32 else (64 if cout <= 64 else 128)


def run_rows(bm: int, zp: int, dyg: int) -> int:
    """Rows of a staged run of a bm-row block that serves ``dyg`` values
    of dy (3, or 1 for very deep Z): the rows and their halo."""
    return bm + (dyg - 1) * zp + 2


def smem_bytes(bm: int, nt: int, zp: int, dyg: int) -> int:
    """Kernels A's and C's dynamic shared memory: two staged runs and the
    weight ring."""
    run = -(-run_rows(bm, zp, dyg) * 128 // 1024) * 1024
    return 1024 + 2 * run + STAGES * nt * 128


def dy_group(bm: int, nt: int, zp: int) -> int:
    """dy values per staged run: 3 where two such runs fit beside the
    ring, else 1."""
    return 3 if smem_bytes(bm, nt, zp, 3) <= SMEM_LIMIT else 1


def rows_per_block(rows: int, cout: int, Z: int) -> int:
    """Rows per block of a launch of ``rows`` output rows and ``cout``
    output channels: 128 per wgmma M half of 64 that each of the two
    warpgroups runs, as many as still give MIN_BLOCKS blocks and a run
    that serves all three dy: 512 (N tiles up to 64 only), 256, else
    128."""
    nt = tile_n(cout)
    ntiles = -(-cout // nt)
    for bm in (512, 256):
        if ((nt <= 64 or bm < 512) and -(-rows // bm) * ntiles >= MIN_BLOCKS
                and smem_bytes(bm, nt, Z + 2, 3) <= SMEM_LIMIT):
            return bm
    return 128


def _plan_blocks(row0: int, rows: int, cout: int, Z: int
                 ) -> Iterator[Tuple[range, range]]:
    """(output rows, output channels) of each block of a launch."""
    nt = tile_n(cout)
    bm = rows_per_block(rows, cout, Z)
    for bx in range(-(-rows // bm)):
        r0 = row0 + bx * bm
        for by in range(-(-cout // nt)):
            yield (range(r0, min(r0 + bm, row0 + rows)),
                   range(by * nt, min((by + 1) * nt, cout)))


# ---------------------------------------------------------------------------
# kernel A
# ---------------------------------------------------------------------------


def fwd_packed_shape(cins: Sequence[int], cout: int) -> Tuple[int, int, int]:
    """(27, npad, ktot): kernel A's packed weights for inputs of ``cins``
    channels and ``cout`` output channels."""
    return (27, round_up(cout, tile_n(cout)),
            sum(round_up(int(c), TILE_K) for c in cins))


def fwd_k_offsets(cins: Sequence[int]) -> List[int]:
    """The first packed K column of each input: input i's channel ch sits
    at column ``fwd_k_offsets(cins)[i] + ch``."""
    out, k = [], 0
    for c in cins:
        out.append(k)
        k += round_up(int(c), TILE_K)
    return out


def pack_conv_weights(weight: torch.Tensor, cins: Sequence[int]) -> torch.Tensor:
    """(Cout, sum(cins), 3, 3, 3) -> (27, npad, ktot) bf16, the layout
    kernel A reads: P[tap][co][k_i + ci] = W[co][c0_i + ci][tap] (tap =
    dx*9 + dy*3 + dz, k_i the input's first packed column), each input's
    channels zero-padded to the K chunk and Cout to the N tile, so each
    (tap, chunk) tile is npad rows of 64 contiguous K values (its wgmma B
    operand, K-major)."""
    cout, cin_t = int(weight.shape[0]), int(weight.shape[1])
    if cin_t != sum(int(c) for c in cins) or tuple(weight.shape[2:]) != (3, 3, 3):
        raise ValueError(f"weight {tuple(weight.shape)} does not match "
                         f"inputs of {list(cins)} channels")
    taps = weight.to(torch.bfloat16).permute(2, 3, 4, 0, 1).reshape(
        27, cout, cin_t)
    out = taps.new_zeros(fwd_packed_shape(cins, cout))
    c0 = 0
    for ci, k0 in zip(cins, fwd_k_offsets(cins)):
        out[:, :cout, k0:k0 + ci] = taps[:, :, c0:c0 + ci]
        c0 += ci
    return out


def unpack_conv_weights(packed: torch.Tensor, cins: Sequence[int],
                        cout: int) -> torch.Tensor:
    """Inverse of :func:`pack_conv_weights`: (Cout, sum(cins), 3, 3, 3)."""
    cols = torch.cat([torch.arange(k0, k0 + int(c))
                      for c, k0 in zip(cins, fwd_k_offsets(cins))])
    return packed[:, :cout, cols].reshape(3, 3, 3, cout, -1).permute(
        3, 4, 0, 1, 2)


def fwd_rows(X: int, Y: int, Z: int) -> Tuple[int, int]:
    """(first output row, output rows) of a kernel A launch: the positions
    of planes 1..X, in either mode."""
    yzp = (Y + 2) * (Z + 2)
    return yzp, X * yzp


def fwd_rows_per_block(cout: int, X: int, Y: int, Z: int) -> int:
    """Kernel A's output rows per block (:func:`rows_per_block`)."""
    return rows_per_block(fwd_rows(X, Y, Z)[1], cout, Z)


def fwd_dy_group(cout: int, X: int, Y: int, Z: int) -> int:
    """dy values per staged run of a kernel A launch: 3, or 1 where two
    runs of the nine taps' halo do not fit (very deep Z)."""
    return dy_group(fwd_rows_per_block(cout, X, Y, Z), tile_n(cout), Z + 2)


def fwd_runs(cins: Sequence[int], cout: int, X: int, Y: int, Z: int
             ) -> List[Tuple[int, range, Tuple[int, ...]]]:
    """The staged runs of every kernel A block, in the kernel's order: for
    each input, each of its 64-channel chunks, each dx and each dy group,
    (the input, its channels in the chunk, the taps that the run serves:
    tap = dx*9 + dy*3 + dz)."""
    dyg = fwd_dy_group(cout, X, Y, Z)
    out = []
    for i, c in enumerate(cins):
        for ch in range(0, int(c), TILE_K):
            for dx in range(3):
                for gi in range(3 // dyg):
                    taps = tuple(dx * 9 + (gi * dyg + t // 3) * 3 + t % 3
                                 for t in range(3 * dyg))
                    out.append((i, range(ch, min(ch + TILE_K, int(c))), taps))
    return out


def fwd_grid(cout: int, X: int, Y: int, Z: int) -> Tuple[int, int]:
    """Kernel A's grid: (row blocks, N tiles)."""
    _, rows = fwd_rows(X, Y, Z)
    bm = fwd_rows_per_block(cout, X, Y, Z)
    return -(-rows // bm), -(-cout // tile_n(cout))


def fwd_blocks(cins: Sequence[int], cout: int, X: int, Y: int, Z: int
               ) -> Iterator[Tuple[range, range, list]]:
    """Each block of a kernel A launch: (its output rows, its output
    channels, its staged runs (:func:`fwd_runs`)), clipped to the real
    extents."""
    runs = fwd_runs(cins, cout, X, Y, Z)
    row0, rows = fwd_rows(X, Y, Z)
    for r, n in _plan_blocks(row0, rows, cout, Z):
        yield r, n, runs


# ---------------------------------------------------------------------------
# kernel C
# ---------------------------------------------------------------------------


def mirror_transpose(weight: torch.Tensor, cins: Sequence[int],
                     branch: int) -> torch.Tensor:
    """One input branch's weights as the transposed conv reads them:
    (Cout, sum(cins), 3, 3, 3) -> (cins[branch], Cout, 3, 3, 3) with the
    taps mirrored, Wt[ci][co][tap] = W[co][ci][26 - tap] — the counterpart
    of ``mirror_transpose_shards`` (conv_pallas.py:198). A forward conv with
    Wt is the transposed conv with W: the dx pass of that branch."""
    c0 = sum(int(c) for c in cins[:branch])
    wb = weight[:, c0:c0 + int(cins[branch])]
    return wb.transpose(0, 1).flip(2, 3, 4)


def dx_packed_shape(c: int, cin: int) -> Tuple[int, int, int]:
    """(27, npad, kpad): kernel C's packed weights for a branch of ``cin``
    channels under a conv of ``c`` output channels (dconv's)."""
    return 27, round_up(cin, tile_n(cin)), round_up(c, TILE_K)


def pack_conv_weights_dx(weight: torch.Tensor, cins: Sequence[int],
                         branch: int) -> torch.Tensor:
    """Branch ``branch``'s mirrored, transposed weights as kernel C reads
    them: (27, npad, kpad) bf16, P[tap][ci][co] = Wt[ci][co][tap] (tap =
    dx*9 + dy*3 + dz), ci (the GEMM's N) zero-padded to the N tile and co
    (its K, dconv's channels) to the K chunk, so each (tap, chunk) tile is
    npad rows of 64 contiguous K values."""
    cout = int(weight.shape[0])
    wt = mirror_transpose(weight, cins, branch)
    cin = int(wt.shape[0])
    _, npad, kpad = dx_packed_shape(cout, cin)
    taps = wt.to(torch.bfloat16).permute(2, 3, 4, 0, 1).reshape(27, cin, cout)
    out = taps.new_zeros((27, npad, kpad))
    out[:, :cin, :cout] = taps
    return out


def unpack_conv_weights_dx(packed: torch.Tensor, cin: int,
                           cout: int) -> torch.Tensor:
    """Inverse of :func:`pack_conv_weights_dx`: (cin, cout, 3, 3, 3), the
    layout of :func:`mirror_transpose`."""
    return packed[:, :cin, :cout].reshape(3, 3, 3, cin, cout).permute(
        3, 4, 0, 1, 2)


def dx_rows(X: int, Y: int, Z: int, halo: bool) -> Tuple[int, int]:
    """(first output row, output rows) of a kernel C launch."""
    yzp = (Y + 2) * (Z + 2)
    return (0, (X + 2) * yzp) if halo else (yzp, X * yzp)


def dx_rows_per_block(cin: int, X: int, Y: int, Z: int, halo: bool) -> int:
    """Kernel C's output rows per block (:func:`rows_per_block`)."""
    return rows_per_block(dx_rows(X, Y, Z, halo)[1], cin, Z)


def dx_grid(cin: int, X: int, Y: int, Z: int, halo: bool) -> Tuple[int, int]:
    """Kernel C's grid: (row blocks, N tiles)."""
    _, rows = dx_rows(X, Y, Z, halo)
    bm = dx_rows_per_block(cin, X, Y, Z, halo)
    return -(-rows // bm), -(-cin // tile_n(cin))


def dx_blocks(cin: int, c: int, X: int, Y: int, Z: int, halo: bool
              ) -> Iterator[Tuple[range, range, range, range]]:
    """Each block of a kernel C launch: (its output rows, its dx channels,
    the taps it runs, the dconv channels it contracts), clipped to the
    real extents."""
    row0, rows = dx_rows(X, Y, Z, halo)
    for r, n in _plan_blocks(row0, rows, cin, Z):
        yield r, n, range(27), range(0, c)


# ---------------------------------------------------------------------------
# kernel D
# ---------------------------------------------------------------------------


def _wgrad_stages(bk: int, Z: int, runs: int = 1) -> int:
    """Stages of a ring of bk-position steps that fit in a block's shared
    memory beside the static affine: 3, 2 or 0. A stage holds the dconv
    tile and the x rows of ``runs`` runs: one run of the step and its Zp + 1
    halo rows on each side, or three (one per dy) of the step and one halo
    row on each side, SR = bk + 8 rows apart."""
    zp = Z + 2
    rows = bk + 2 * zp + 2 if runs == 1 else 3 * (bk + 8)
    stage = -(-rows * 128 // 1024) * 1024 + bk * 128
    for n in (3, 2):
        if 1024 + n * stage <= SMEM_LIMIT - 1024:
            return n
    return 0


def wgrad_step(Z: int) -> int:
    """Kernel D's positions per K step for a Z-deep interior: 256 where two
    stages of one run fit, else 128."""
    return 256 if _wgrad_stages(256, Z) >= 2 else 128


def wgrad_runs(Z: int) -> int:
    """Kernel D's x runs per stage: 1 (one run serves the three dy) where
    two stages of it fit (Z up to 317), else 3 (one per dy), which fit at
    any depth."""
    return 1 if _wgrad_stages(wgrad_step(Z), Z) >= 2 else 3


def wgrad_stages(Z: int) -> int:
    """Stages of kernel D's ring for a Z-deep interior."""
    return _wgrad_stages(wgrad_step(Z), Z, wgrad_runs(Z))


def wgrad_split(cin: int, cout: int, X: int, Y: int, Z: int
                ) -> Tuple[int, int]:
    """(positions per split, splits) of kernel D's K range, as the
    library's ``split_k`` computes them."""
    tiles = (-(-cin // WGRAD_TILE_CI) * -(-cout // WGRAD_TILE_CO)
             * WGRAD_TAP_GROUPS)
    step = wgrad_step(Z)
    k = X * (Y + 2) * (Z + 2)
    steps = -(-k // step)
    s = -(-WGRAD_TARGET_BLOCKS // tiles)
    s = max(1, min(s, -(-steps // WGRAD_MIN_STEPS)))
    chunk = -(-steps // s) * step
    return chunk, -(-k // chunk)


def wgrad_blocks(cin: int, cout: int, X: int, Y: int, Z: int
                 ) -> Iterator[Tuple[range, range, range, range]]:
    """Each block of a kernel D launch: (its cin channels, its cout
    channels, its taps, its K positions), clipped to the real extents."""
    chunk, splits = wgrad_split(cin, cout, X, Y, Z)
    yzp = (Y + 2) * (Z + 2)
    kbeg, kend = yzp, (X + 1) * yzp
    for split in range(splits):
        k0 = kbeg + split * chunk
        for ci in range(0, cin, WGRAD_TILE_CI):
            for co in range(0, cout, WGRAD_TILE_CO):
                for dxo in range(WGRAD_TAP_GROUPS):
                    yield (range(ci, min(ci + WGRAD_TILE_CI, cin)),
                           range(co, min(co + WGRAD_TILE_CO, cout)),
                           range(dxo * 9, dxo * 9 + 9),
                           range(k0, min(k0 + chunk, kend)))


# ---------------------------------------------------------------------------
# kernel E, the pool backward
# ---------------------------------------------------------------------------

# threads per block, blocks per SM, partial columns of a fold unit, and
# partials a folding thread loads at once
POOL_BWD_THREADS = 256
POOL_BWD_BLOCKS_PER_SM = 2
POOL_BWD_FOLD_COLS = 8
POOL_BWD_FOLD_BATCH = 4


def pool_bwd_voxels(X: int, Y: int, Z: int) -> Tuple[int, int, int]:
    """Interior extents of the pooled output of an (X, Y, Z) interior."""
    return X // 2 + 1, Y // 2 + 1, Z // 2 + 1


def pool_bwd_plan(c: int, X: int, Y: int, Z: int, sms: int
                  ) -> Tuple[int, int, int]:
    """(blocks B, voxel lanes R, folding blocks F) of a kernel E launch on
    ``sms`` SMs: B = min(V, sms * POOL_BWD_BLOCKS_PER_SM) over the V pooled
    voxels, block b owning voxels ``block_items(V, B, b)`` in (x, y, z)
    order; thread t owns channel vector t % (C / 8) and lane t // (C / 8) <
    R, lane r walking the block's voxels r, r + R, ...; the last F = min(
    ceil(2 C / 8), max(1, min(B, sms) // 2)) blocks to take a ticket fold
    dab's units f, f + F, ... (unit u: columns [8 u, 8 u + 8) of the (B,
    2 C) partials)."""
    ox, oy, oz = pool_bwd_voxels(X, Y, Z)
    blocks = min(ox * oy * oz, sms * POOL_BWD_BLOCKS_PER_SM)
    units = -(-2 * c // POOL_BWD_FOLD_COLS)
    folders = min(units, max(1, min(blocks, sms) // 2))
    return blocks, POOL_BWD_THREADS // -(-c // 8), folders


def pool_bwd_workspace(c: int, X: int, Y: int, Z: int, sms: int) -> int:
    """f32 workspace of a kernel E launch with an affine: the (B, 2 C)
    partials, then one int, the ticket counter."""
    return pool_bwd_plan(c, X, Y, Z, sms)[0] * 2 * c + 1


def pool_bwd_owned(o: int, extent: int) -> range:
    """The padded coordinates along one axis whose dx the pooled index o
    writes: its window [2 o, 2 o + 2), and for the last index everything up
    to the ring's far plane (the plane no window covers when the extent is
    odd)."""
    last = o == extent // 2
    return range(2 * o, extent + 2 if last else 2 * o + 2)


# ---------------------------------------------------------------------------
# the probe: the dot kernels mxu_dot and mxu_rdot, and slab_build
# ---------------------------------------------------------------------------

# blocks per SM (two warpgroups each), plane rows of a mxu_dot item (64 per
# warpgroup) and of a mxu_rdot chunk (8 k16 steps per warpgroup)
PROBE_BLOCKS_PER_SM = 1
PROBE_DOT_ROWS = 128
PROBE_RDOT_CHUNK = 256


def probe_tile_n(n: int) -> int:
    """The N of each probe wgmma for n columns (a multiple of 64): the
    widest of 192, 128 and 64 that divides n."""
    return 192 if n % 192 == 0 else (128 if n % 128 == 0 else 64)


def _probe_blocks(items: int, sms: int) -> int:
    return min(items, sms * PROBE_BLOCKS_PER_SM)


def dot_plan(k: int, n: int, ps: int, reps: int, sms: int
             ) -> Tuple[int, int]:
    """(blocks, items) of a mxu_dot launch on ``sms`` SMs. An item is
    (128-row tile of the plane, N-column tile, rep), reps innermost; k
    sets each item's work (k / 16 wgmmas per warpgroup), not the plan."""
    items = -(-ps // PROBE_DOT_ROWS) * (n // probe_tile_n(n)) * reps
    return _probe_blocks(items, sms), items


def rdot_plan(m: int, n: int, ps: int, reps: int, sms: int
              ) -> Tuple[int, int, int]:
    """(blocks, items, chunk rows) of a mxu_rdot launch on ``sms`` SMs. An
    item is (64 x N output tile, chunk of the plane's rows, rep), reps
    innermost."""
    items = ((m // 64) * (n // probe_tile_n(n)) * -(-ps // PROBE_RDOT_CHUNK)
             * reps)
    return _probe_blocks(items, sms), items, PROBE_RDOT_CHUNK


def block_items(items: int, blocks: int, b: int) -> range:
    """The items of block b: an even split, within one item per block."""
    return range(b * items // blocks, (b + 1) * items // blocks)


def dot_item(i: int, n: int, ps: int, reps: int
             ) -> Tuple[int, range, range, int]:
    """(output tile, plane rows that its fold adds, columns, rep) of
    mxu_dot item i; warpgroup w runs the tile's rows 64 w .. 64 w + 63,
    past ps included."""
    nt = probe_tile_n(n)
    t, rep = divmod(i, reps)
    rt, ct = divmod(t, n // nt)
    r0 = rt * PROBE_DOT_ROWS
    return (t, range(r0, min(r0 + PROBE_DOT_ROWS, ps)),
            range(ct * nt, (ct + 1) * nt), rep)


def rdot_item(i: int, m: int, n: int, ps: int, reps: int
              ) -> Tuple[int, range, range, Tuple[range, range], int]:
    """(output tile, its m rows, its n columns, (plane rows of warpgroup
    0, of warpgroup 1), rep) of mxu_rdot item i: the chunk's k16 steps,
    the first half (rounded up) to warpgroup 0."""
    nt = probe_tile_n(n)
    per_tile = -(-ps // PROBE_RDOT_CHUNK) * reps
    t, rest = divmod(i, per_tile)
    c = rest // reps
    mt, ct = divmod(t, n // nt)
    r0 = c * PROBE_RDOT_CHUNK
    r1 = min(r0 + PROBE_RDOT_CHUNK, ps)
    split = min(r0 + 16 * ((-(-(r1 - r0) // 16) + 1) // 2), r1)
    return (t, range(mt * 64, mt * 64 + 64), range(ct * nt, (ct + 1) * nt),
            (range(r0, split), range(split, r1)), rest % reps)


# the probe's slab build: strips per block, 16-byte vectors of a segment (a
# quarter-warp's 128 bytes of one row), rows of each lane at most (a strip
# has at most 4 PROBE_BUILD_ROWS rows), the rows a strip gets at least
# where the plane allows, and warps per block at most
PROBE_BUILD_STRIPS = 4
PROBE_BUILD_SEG = 8
PROBE_BUILD_ROWS = 8
PROBE_BUILD_MIN_STRIP = 16
PROBE_BUILD_MAX_WARPS = 8


def build_plan(cs: int, copies: int, ps: int, sms: int
               ) -> Tuple[int, int, int, int]:
    """(blocks, warps per block, segments, most rows of a block) of a
    slab_build launch on ``sms`` SMs, or (0, 0, 0, 0) where one slab row
    does not fit in a block's shared memory. Block b holds slab rows
    ``block_items(ps, blocks, b)``, split evenly into PROBE_BUILD_STRIPS
    strips; a row's cs / 8 vectors are split into segments of
    PROBE_BUILD_SEG; warp w of a block takes units w, w + warps, ... (unit
    u: segment u % segs of strip u // segs). At most ``sms`` blocks, fewer
    where the strips would get fewer than PROBE_BUILD_MIN_STRIP rows, more
    where they would get more than 4 PROBE_BUILD_ROWS or a block's rows do
    not fit."""
    fit = SMEM_LIMIT // (2 * copies * cs)
    if fit < 1:
        return 0, 0, 0, 0
    segs = -(-(cs // 8) // PROBE_BUILD_SEG)
    warps = min(PROBE_BUILD_STRIPS * segs, PROBE_BUILD_MAX_WARPS)
    blocks = max(1, min(sms, -(-ps // (PROBE_BUILD_STRIPS
                                       * PROBE_BUILD_MIN_STRIP))),
                 -(-ps // (PROBE_BUILD_STRIPS * 4 * PROBE_BUILD_ROWS)),
                 -(-ps // fit))
    return blocks, warps, segs, -(-ps // blocks)


def build_units(cs: int, copies: int, ps: int, sms: int
                ) -> List[Tuple[int, int, range, range]]:
    """(block, warp, its vectors of a row, its strip's slab rows) of every
    unit of a slab_build launch; a warp walks its units in order."""
    blocks, warps, segs, _ = build_plan(cs, copies, ps, sms)
    out = []
    for b in range(blocks):
        rows = block_items(ps, blocks, b)
        n = len(rows)
        for u in range(PROBE_BUILD_STRIPS * segs):
            seg, j = u % segs, u // segs
            out.append((b, u % warps,
                        range(seg * PROBE_BUILD_SEG,
                              min((seg + 1) * PROBE_BUILD_SEG, cs // 8)),
                        range(rows.start + j * n // PROBE_BUILD_STRIPS,
                              rows.start + (j + 1) * n // PROBE_BUILD_STRIPS)))
    return out


def build_lane_rows(strip: range, q: int) -> List[int]:
    """The strip's rows that lane (q, i) of a unit's warp holds: start + q
    + 4 e for e < PROBE_BUILD_ROWS, within the strip."""
    return [r for r in range(strip.start + q,
                             strip.start + 4 * PROBE_BUILD_ROWS, 4)
            if r < strip.stop]


def build_schedule(strip: range, reps: int
                   ) -> Iterator[Tuple[str, List[int]]]:
    """A unit's shared-memory operations over ``reps`` builds, in program
    order: per build ("load", rows), every lane's rows of segment 0's
    columns into registers, a __syncwarp, then ("store", rows), each row's
    norm one row down into each copy, but for the strip's last row, whose
    norm would go to the next strip's first row: that row keeps its value
    (the slab's fixed point, bf16(0.25 * 1.0001) = 0.25), and a second
    __syncwarp."""
    rows = sorted(r for q in range(4) for r in build_lane_rows(strip, q))
    for _ in range(reps):
        yield "load", rows
        yield "store", rows


# ---------------------------------------------------------------------------
# the GroupNorm kernels: the reductions gn_stats and gn_bwd_reduce, the
# elementwise passes gn_apply and gn_bwd_dx
# ---------------------------------------------------------------------------

# threads that own channel vectors (a reduction block adds a producer
# warp), the reductions' ring stages, row sweeps of x and of g per stage of
# gn_bwd_reduce (a stage holds at most GN_STAGE_BYTES of each; gn_stats'
# stage holds twice the sweeps of x alone) and blocks per SM, the
# elementwise passes' blocks per SM and rows per thread per loop iteration
GN_THREADS = 256
GN_REDUCE_STAGES = 4
GN_REDUCE_SWEEPS = 2
GN_REDUCE_BLOCKS_PER_SM = 1
GN_DX_BLOCKS_PER_SM = 2
GN_DX_UNROLL = 4
GN_STAGE_BYTES = GN_REDUCE_SWEEPS * GN_THREADS * 16


def gn_vec(dtype: int) -> int:
    """Channels per 16-byte vector: dtype 0 bf16, 1 f32."""
    return 8 if dtype == 0 else 4


def gn_lanes(c: int, dtype: int) -> int:
    """Row lanes R of a GroupNorm block: rows its threads walk together,
    one thread per 16-byte channel vector of each."""
    return GN_THREADS // -(-c // gn_vec(dtype))


def gn_blocks_per_sample(n: int, s: int, sms: int, per_sm: int) -> int:
    """Blocks of each sample: the wave (``per_sm`` on each of ``sms`` SMs)
    split over the n samples, at least one, at most one per row."""
    return max(1, min(s, sms * per_sm // n))


def gn_block_rows(s: int, bs: int, j: int) -> range:
    """The rows of a sample that block j of its ``bs`` owns: an even split,
    within one row of each other."""
    return range(j * s // bs, (j + 1) * s // bs)


def _reduction_plan(n, s, c, units, sweeps, dtype, sms):
    bs = gn_blocks_per_sample(n, s, sms, GN_REDUCE_BLOCKS_PER_SM)
    lanes = gn_lanes(c, dtype)
    folders = min(units, max(1, min(n * bs, sms) // 2))
    return bs, lanes, sweeps * lanes, folders


def gn_stats_plan(n: int, s: int, c: int, groups: int, dtype: int,
                  sms: int) -> Tuple[int, int, int, int]:
    """(blocks per sample, row lanes, rows per ring stage, folding blocks)
    of a gn_stats launch on ``sms`` SMs: block n * Bs + j owns rows
    ``gn_block_rows(s, Bs, j)`` of sample n; a stage holds 2 *
    GN_REDUCE_SWEEPS sweeps of x; the last F = min(N G, max(1, min(N Bs,
    sms) // 2)) blocks to finish fold units f, f + F, ... (unit u: the sums
    of x and of x^2 of group u % G of sample u // G)."""
    return _reduction_plan(n, s, c, n * groups, 2 * GN_REDUCE_SWEEPS, dtype,
                           sms)


def gn_reduce_plan(n: int, s: int, c: int, groups: int, dtype: int,
                   sms: int) -> Tuple[int, int, int, int]:
    """(blocks per sample, row lanes, rows per ring stage, folding blocks)
    of a gn_bwd_reduce launch on ``sms`` SMs: block n * Bs + j owns rows
    ``gn_block_rows(s, Bs, j)`` of sample n; the last F = min(2 G, max(1,
    min(N Bs, sms) // 2)) blocks to finish fold units f, f + F, ... (unit
    u: quantity u % 2 of group u // 2)."""
    return _reduction_plan(n, s, c, 2 * groups, GN_REDUCE_SWEEPS, dtype, sms)


def gn_dx_blocks(n: int, s: int, sms: int) -> int:
    """Blocks per sample of a gn_apply or gn_bwd_dx launch (rows split as
    the reductions')."""
    return gn_blocks_per_sample(n, s, sms, GN_DX_BLOCKS_PER_SM)


def gn_workspace(kernel: str, n: int, s: int, c: int, groups: int,
                 dtype: int, sms: int) -> Tuple[int, int]:
    """(f32 partial sums (N, Bs, 2, C), zeroed int32 tickets) that a
    ``kernel`` launch needs: ``"gn_stats"`` or ``"gn_bwd_reduce"``."""
    plan = {"gn_stats": gn_stats_plan, "gn_bwd_reduce": gn_reduce_plan}
    bs = plan[kernel](n, s, c, groups, dtype, sms)[0]
    return n * bs * 2 * c, 1


def gn_fold_columns(ncol: int) -> List[Tuple[int, int, int]]:
    """How a folding block covers a unit's ``ncol`` columns (per sample):
    (first column, columns, segments T) of each pass; in a pass, thread k *
    columns + i sums column i over the partials k, k + T, ... in order, then
    a pairwise tree over the T segments (:func:`gn_tree_pairs`)."""
    out = []
    for cc in range(0, ncol, GN_THREADS):
        w = min(GN_THREADS, ncol - cc)
        out.append((cc, w, GN_THREADS // w))
    return out


def gn_tree_pairs(count: int) -> List[Tuple[int, int]]:
    """The kernels' pairwise tree over ``count`` rows, as (into, from)
    pairs in the order they are added (pairs of one level are
    independent): row 0 ends up with ((r0 + r1) + (r2 + r3)) + ..."""
    pairs, st = [], 1
    while st < count:
        pairs += [(k, k + st) for k in range(0, count - st, 2 * st)]
        st *= 2
    return pairs
