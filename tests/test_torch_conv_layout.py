"""The host-side layout of kernels C and D (``unetsulc_tpu_torch/kernels/
layout.py``) on the CPU: kernel C's weight packing against
``mirror_transpose`` (which ``test_torch_grads.py`` holds to JAX's
``mirror_transpose_shards``), the two kernels' launch plans at the
flagship's and the spatial-parallel slabs' shapes, the shared-memory limit
of kernel D, and the loader's check of the libraries' tile constants.
Everything here is exact: integers, and bf16 values moved, not computed.
"""

import numpy as np
import pytest
import torch

from unetsulc_tpu_torch import kernels
from unetsulc_tpu_torch.kernels import layout
from torch_threads import torch_one_thread  # noqa: F401,E402

# (channels of the forward conv's inputs, its output channels, interior
# extent, halo mode): the flagship's launches at 96^3 and its levels, the
# sp slabs at space 2 and 4 (level 0, and level 1's slab+E layout of 13
# planes), and the edges: channels that are not multiples of the tiles,
# the decoder's two-branch split, Y/Z = 49, a narrow and a tiny volume
SHAPES = [
    ([32], 64, (96, 96, 96), False),
    ([64, 128], 64, (96, 96, 96), False),
    ([64], 128, (49, 49, 49), False),
    ([128, 256], 128, (49, 49, 49), False),
    ([256, 512], 256, (25, 25, 25), False),
    ([256], 512, (13, 13, 13), False),
    ([32], 64, (48, 96, 96), True),
    ([64, 128], 64, (24, 96, 96), True),
    ([128, 256], 128, (13, 49, 49), True),
    ([96, 160], 48, (13, 49, 49), False),
    ([96, 160], 48, (13, 49, 49), True),
    ([12, 20], 10, (7, 9, 5), False),
    ([4], 8, (9, 8, 10), True),
]


def _ids(shape):
    cins, cout, ext, halo = shape
    return f"{'+'.join(map(str, cins))}-{cout}@{'x'.join(map(str, ext))}" + (
        "-halo" if halo else "")


def _partition(ranges, lo, hi):
    """Whether ``ranges`` (Python ranges) tile [lo, hi) exactly once."""
    spans = sorted((r.start, r.stop) for r in ranges if len(r))
    if not spans or spans[0][0] != lo or spans[-1][1] != hi:
        return False
    return all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("cins,branch", [([12, 20], 0), ([12, 20], 1),
                                         ([32], 0), ([64, 128], 1),
                                         ([96, 160], 0)])
def test_dx_weights_unpack_to_mirror_transpose(cins, branch):
    """Kernel C's packed weights unpack to ``mirror_transpose`` of the
    branch in bf16, with zeros in the padding, in the shape the wrapper
    checks."""
    rng = np.random.default_rng(3)
    cout = 48
    w = torch.from_numpy(rng.standard_normal(
        (cout, sum(cins), 3, 3, 3)).astype(np.float32))
    packed = layout.pack_conv_weights_dx(w, cins, branch)
    cin = cins[branch]
    assert tuple(packed.shape) == layout.dx_packed_shape(cout, cin)
    assert packed.dtype == torch.bfloat16
    _, npad, kpad = packed.shape
    assert npad % layout.dx_tile_n(cin) == 0 and kpad % layout.DX_TILE_K == 0
    want = kernels.mirror_transpose(w, cins, branch).to(torch.bfloat16)
    assert torch.equal(layout.unpack_conv_weights_dx(packed, cin, cout), want)
    pad = packed.clone()
    pad[:, :cin, :cout] = 0
    assert not pad.any()
    # the wrapper's packer is this one
    assert torch.equal(kernels.pack_conv_weights_dx(w, cins, branch), packed)


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_dx_plan_covers_each_output_once(shape):
    """Kernel C's blocks cover every output row (the positions of the
    output planes, whose (y, z) interior holds the interior voxels) and
    every dx channel exactly once, each block running all 27 taps over all
    of dconv's channels."""
    cins, c, (X, Y, Z), halo = shape
    row0, rows = layout.dx_rows(X, Y, Z, halo)
    yzp = (Y + 2) * (Z + 2)
    assert (row0, rows) == ((0, (X + 2) * yzp) if halo else (yzp, X * yzp))
    for cin in cins:
        blocks = list(layout.dx_blocks(cin, c, X, Y, Z, halo))
        gm, gn = layout.dx_grid(cin, X, Y, Z, halo)
        assert len(blocks) == gm * gn
        by_rows = {}
        for r, n, taps, k in blocks:
            assert taps == range(27) and k == range(c)
            by_rows.setdefault((r.start, r.stop), []).append(n)
        assert _partition([range(*s) for s in by_rows], row0, row0 + rows)
        assert all(_partition(ns, 0, cin) for ns in by_rows.values())
        bm = layout.dx_rows_per_block(cin, X, Y, Z, halo)
        assert bm in (128, 256, 512)
        assert bm == 128 or gm * gn >= layout.DX_MIN_BLOCKS
        assert layout.dx_smem_bytes(bm, layout.dx_tile_n(cin), Z + 2, 3) \
            <= layout.SMEM_LIMIT


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_wgrad_plan_covers_each_term_once(shape):
    """Kernel D's blocks cover every (tap, cin, cout, voxel) term of dW
    exactly once: per (cin, cout) tile the tap groups tile the 27 taps, per
    tap group the splits tile the K range of the interior planes'
    positions, and the tiles tile the channels."""
    cins, cout, (X, Y, Z), _ = shape
    yp, zp = Y + 2, Z + 2
    kbeg, kend = yp * zp, (X + 1) * yp * zp
    # the first and the last interior voxel lie in the K range
    assert kbeg <= (yp + 1) * zp + 1 and (X * yp + Y) * zp + Z < kend
    for cin in cins:
        chunk, splits = layout.wgrad_split(cin, cout, X, Y, Z)
        assert chunk % layout.wgrad_step(Z) == 0
        groups = {}
        for ci, co, taps, k in layout.wgrad_blocks(cin, cout, X, Y, Z):
            groups.setdefault((ci.start, co.start), {}).setdefault(
                (taps.start, taps.stop), []).append(k)
        cis = {ci for ci, _ in groups}
        cos = {co for _, co in groups}
        assert _partition([range(a, min(a + layout.WGRAD_TILE_CI, cin))
                           for a in cis], 0, cin)
        assert _partition([range(a, min(a + layout.WGRAD_TILE_CO, cout))
                           for a in cos], 0, cout)
        for by_taps in groups.values():
            assert _partition([range(*t) for t in by_taps], 0, 27)
            for ks in by_taps.values():
                assert len(ks) == splits and _partition(ks, kbeg, kend)


def test_wgrad_step_stages_and_depth_limit():
    """Kernel D's K step and ring: 256 positions a step up to Z = 189 (3
    stages up to Z = 41, then 2), 128 (2 stages) up to Z = 317, and deeper
    runs do not fit in a block's shared memory (the wrapper refuses
    them)."""
    zs = (13, 41, 42, 96, 189, 190, 317, 318)
    assert [layout.wgrad_step(z) for z in zs] == [256] * 5 + [128] * 3
    assert [layout.wgrad_stages(z) for z in zs] == [3, 3, 2, 2, 2, 2, 2, 0]


class _FakeLib:
    """A library whose exported tile constants are layout.py's, but for
    one."""

    def __init__(self, off_by):
        self.off_by = off_by

    def conv3x3x3_dx_tile(self, what, cout, X, Y, Z, edge):
        v = {0: layout.DX_TILE_K, 1: layout.DX_STAGES,
             2: layout.dx_tile_n(cout),
             3: layout.dx_rows_per_block(cout, X, Y, Z, bool(edge))}[what]
        return v + (self.off_by if what == 3 else 0)

    def conv3x3x3_wgrad_tile(self, what, Z):
        return [layout.WGRAD_TILE_CI, layout.WGRAD_TILE_CO,
                layout.wgrad_step(Z), layout.WGRAD_TAP_GROUPS,
                layout.WGRAD_TARGET_BLOCKS, layout.WGRAD_MIN_STEPS,
                layout.wgrad_stages(Z)][what] + (self.off_by if what == 2
                                                 else 0)


@pytest.mark.parametrize("name", ["conv3x3x3_dx", "conv3x3x3_wgrad"])
def test_loader_checks_tile_constants(name):
    """Loading kernel C's or D's library compares its exported tile
    constants with layout.py's and raises on a mismatch."""
    kernels._check_tiles(name, _FakeLib(0))
    with pytest.raises(RuntimeError, match="tile constants"):
        kernels._check_tiles(name, _FakeLib(128))
