"""Host-side layout of kernels C (``csrc/conv3x3x3_dx.cu``) and D
(``csrc/conv3x3x3_wgrad.cu``): their tile constants, kernel C's weight
packing and both kernels' launch plans, in plain Python so that the CPU
tests reach them. Each constant mirrors one that its library exports
(``conv3x3x3_dx_tile``, ``conv3x3x3_wgrad_tile``); the library loader in
:mod:`unetsulc_tpu_torch.kernels` compares them when it loads the library
and raises on a mismatch.

Positions. Both kernels index the padded (X+2, Y+2, Z+2) buffer by its
flat position ``(px * Yp + py) * Zp + pz``; a tap (dx, dy, dz) shifts a
position by ``(dx - 1) Yp Zp + (dy - 1) Zp + (dz - 1)``. Kernel C's output
rows are the positions of planes 1..X (halo mode: 0..X+1), ring positions
included and dropped in its epilogue; kernel D's K range is the positions
of planes 1..X, where dconv's ring adds nothing.
"""

from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import torch

# kernel C: dconv channels per K chunk (one 128-byte shared-memory row),
# stages of the weight ring, and the blocks a launch keeps when it picks
# its rows per block (two per SM of an H100)
DX_TILE_K = 64
DX_STAGES = 5
DX_MIN_BLOCKS = 132 * 2
# dynamic shared memory a block may use on an H100
SMEM_LIMIT = 232448

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


def dx_tile_n(cout: int) -> int:
    """Kernel C's N tile (its wgmma width) for ``cout`` output channels."""
    return 32 if cout <= 32 else (64 if cout <= 64 else 128)


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
    return 27, round_up(cin, dx_tile_n(cin)), round_up(c, DX_TILE_K)


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


def dx_smem_bytes(bm: int, nt: int, zp: int, dyg: int) -> int:
    """Kernel C's dynamic shared memory: two staged runs of dconv rows (a
    run serves ``dyg`` values of dy) and the weight ring."""
    run = -(-(bm + (dyg - 1) * zp + 2) * 128 // 1024) * 1024
    return 1024 + 2 * run + DX_STAGES * nt * 128


def dx_rows_per_block(cin: int, X: int, Y: int, Z: int, halo: bool) -> int:
    """Kernel C's output rows per block: 128 per wgmma M half of 64 that
    each of its two warpgroups runs, as many as still give DX_MIN_BLOCKS
    blocks and a run that serves all three dy: 512 (N tiles up to 64
    only), 256, else 128."""
    _, rows = dx_rows(X, Y, Z, halo)
    nt = dx_tile_n(cin)
    ntiles = -(-cin // nt)
    for bm in (512, 256):
        if ((nt <= 64 or bm < 512) and -(-rows // bm) * ntiles >= DX_MIN_BLOCKS
                and dx_smem_bytes(bm, nt, Z + 2, 3) <= SMEM_LIMIT):
            return bm
    return 128


def dx_grid(cin: int, X: int, Y: int, Z: int, halo: bool) -> Tuple[int, int]:
    """Kernel C's grid: (row blocks, N tiles)."""
    _, rows = dx_rows(X, Y, Z, halo)
    bm = dx_rows_per_block(cin, X, Y, Z, halo)
    return -(-rows // bm), -(-cin // dx_tile_n(cin))


def dx_blocks(cin: int, c: int, X: int, Y: int, Z: int, halo: bool
              ) -> Iterator[Tuple[range, range, range, range]]:
    """Each block of a kernel C launch: (its output rows, its dx channels,
    the taps it runs, the dconv channels it contracts), clipped to the
    real extents."""
    row0, rows = dx_rows(X, Y, Z, halo)
    nt = dx_tile_n(cin)
    bm = dx_rows_per_block(cin, X, Y, Z, halo)
    gm, gn = dx_grid(cin, X, Y, Z, halo)
    for bx in range(gm):
        r0 = row0 + bx * bm
        for by in range(gn):
            yield (range(r0, min(r0 + bm, row0 + rows)),
                   range(by * nt, min((by + 1) * nt, cin)), range(27),
                   range(0, c))


def _wgrad_stages(bk: int, Z: int) -> int:
    """Stages of a ring of bk-position steps that fit in a block's shared
    memory beside the static affine: 3, 2 or 0."""
    zp = Z + 2
    stage = -(-(bk + 2 * zp + 2) * 128 // 1024) * 1024 + bk * 128
    for n in (3, 2):
        if 1024 + n * stage <= SMEM_LIMIT - 1024:
            return n
    return 0


def wgrad_step(Z: int) -> int:
    """Kernel D's positions per K step for a Z-deep interior: 256 where two
    stages of them fit, else 128."""
    return 256 if _wgrad_stages(256, Z) >= 2 else 128


def wgrad_stages(Z: int) -> int:
    """Stages of kernel D's ring for a Z-deep interior (0: too deep, the
    launch is refused)."""
    return _wgrad_stages(wgrad_step(Z), Z)


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
