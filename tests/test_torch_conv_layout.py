"""The host-side layout of kernels A, C and D (``unetsulc_tpu_torch/
kernels/layout.py``) on the CPU: kernel A's weight packing against the
(Cout, sum Cin, 3, 3, 3) weight and kernel C's against ``mirror_transpose``
(which ``test_torch_grads.py`` holds to JAX's ``mirror_transpose_shards``),
the three kernels' launch plans at the flagship's and the
spatial-parallel slabs' shapes and at a very deep Z, kernel D's staging
across depths, and the loader's check of the libraries' tile constants.
Everything here is exact: integers, and bf16 values moved, not computed.
"""

import collections

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
    # a volume rounded up past the largest bucket (320 deep): kernel C's
    # one-dy runs, kernel D's one run per dy
    ([64, 128], 64, (6, 7, 320), False),
]

# kernel A's launches: the flagship forward's 13 (encoder, then decoder),
# the space-2 slabs of levels 0-2 and the space-4 ones (level 1 in the
# slab+E layout), the edges, and a very deep Z (one-dy runs)
FWD_SHAPES = [
    ([32], 64, (96, 96, 96)), ([64], 64, (49, 49, 49)),
    ([64], 128, (49, 49, 49)), ([128], 128, (25, 25, 25)),
    ([128], 256, (25, 25, 25)), ([256], 256, (13, 13, 13)),
    ([256], 512, (13, 13, 13)), ([256, 512], 256, (25, 25, 25)),
    ([256], 256, (25, 25, 25)), ([128, 256], 128, (49, 49, 49)),
    ([128], 128, (49, 49, 49)), ([64, 128], 64, (96, 96, 96)),
    ([64], 64, (96, 96, 96)),
    ([32], 64, (48, 96, 96)), ([64, 128], 64, (48, 96, 96)),
    ([128, 256], 128, (25, 49, 49)), ([256, 512], 256, (13, 25, 25)),
    ([32], 64, (24, 96, 96)), ([128, 256], 128, (13, 49, 49)),
    ([256, 512], 256, (8, 25, 25)),
    ([96, 160], 48, (13, 49, 49)), ([12, 20], 10, (7, 9, 5)),
    ([4], 8, (9, 8, 10)), ([64, 128], 64, (6, 7, 320)),
]


def _ids(shape):
    cins, cout, ext = shape[:3]
    return f"{'+'.join(map(str, cins))}-{cout}@{'x'.join(map(str, ext))}" + (
        "-halo" if shape[3:] and shape[3] else "")


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
    assert npad % layout.tile_n(cin) == 0 and kpad % layout.TILE_K == 0
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
        assert bm == 128 or gm * gn >= layout.MIN_BLOCKS
        nt = layout.tile_n(cin)
        assert layout.smem_bytes(bm, nt, Z + 2,
                                 layout.dy_group(bm, nt, Z + 2)) \
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
    """Kernel D's K step and staging at every depth: up to Z = 317 the
    plan is unchanged, one run serving the three dy (256 positions a step
    up to Z = 189, with 3 stages up to Z = 41, then 2; 128 positions and 2
    stages up to 317); deeper, where two stages of that run no longer fit
    in a block's shared memory, a stage holds one run per dy (128
    positions, 3 stages) and the launch is planned, not refused."""
    for z in range(13, 318):
        assert layout.wgrad_step(z) == (256 if z <= 189 else 128), z
        assert layout.wgrad_stages(z) == (3 if z <= 41 else 2), z
        assert layout.wgrad_runs(z) == 1, z
    for z in (318, 320, 352, 512):
        assert (layout.wgrad_step(z), layout.wgrad_runs(z),
                layout.wgrad_stages(z)) == (128, 3, 3), z
        chunk, splits = layout.wgrad_split(64, 64, 6, 7, z)
        assert chunk % 128 == 0 and splits >= 1
        assert len(list(layout.wgrad_blocks(64, 64, 6, 7, z))) \
            == splits * layout.WGRAD_TAP_GROUPS


@pytest.mark.parametrize("cins", [[32], [64, 128], [12, 20], [4], [96, 160],
                                  [256, 512]], ids=lambda c: "+".join(map(str, c)))
def test_fwd_weights_unpack_to_weight(cins):
    """Kernel A's packed weights unpack to the (Cout, sum Cin, 3, 3, 3)
    weight in bf16, every pad is 0, each input's channels start at its K
    offset, and the shape is the one the wrapper checks."""
    rng = np.random.default_rng(5)
    for cout in (10, 64, 256):
        w = torch.from_numpy(rng.standard_normal(
            (cout, sum(cins), 3, 3, 3)).astype(np.float32))
        packed = layout.pack_conv_weights(w, cins)
        assert tuple(packed.shape) == layout.fwd_packed_shape(cins, cout)
        assert packed.dtype == torch.bfloat16
        _, npad, ktot = packed.shape
        assert npad % layout.tile_n(cout) == 0 and ktot % layout.TILE_K == 0
        assert torch.equal(layout.unpack_conv_weights(packed, cins, cout),
                           w.to(torch.bfloat16))
        # tap dx*9 + dy*3 + dz, output channel co, input i's channel ci
        k0s, c0 = layout.fwd_k_offsets(cins), 0
        for i, ci in enumerate(cins):
            assert k0s[i] % layout.TILE_K == 0
            assert torch.equal(packed[5, cout - 1, k0s[i] + ci - 1],
                               w[cout - 1, c0 + ci - 1, 0, 1, 2].to(
                                   torch.bfloat16))
            c0 += ci
        pad = packed.clone()
        for ci, k0 in zip(cins, k0s):
            pad[:, :cout, k0:k0 + ci] = 0
        assert not pad.any()
        # the wrapper's packer is this one
        assert torch.equal(kernels.pack_conv_weights(w, cins), packed)


@pytest.mark.parametrize("shape", FWD_SHAPES, ids=_ids)
def test_fwd_plan_covers_each_output_and_term_once(shape):
    """Kernel A's blocks cover every output row (the positions of planes
    1..X, whose (y, z) interior holds the interior output voxels) and every
    output channel exactly once, and each block's staged runs serve each
    (input, channel, tap) term exactly once, within one 64-channel chunk
    of its input's packed K columns; the runs and the weight ring fit in
    a block's shared memory, and a run's rows in kernel A's masks."""
    cins, cout, (X, Y, Z) = shape
    row0, rows = layout.fwd_rows(X, Y, Z)
    yzp = (Y + 2) * (Z + 2)
    assert (row0, rows) == (yzp, X * yzp)
    blocks = list(layout.fwd_blocks(cins, cout, X, Y, Z))
    gm, gn = layout.fwd_grid(cout, X, Y, Z)
    assert len(blocks) == gm * gn
    by_rows = {}
    for r, n, runs in blocks:
        by_rows.setdefault((r.start, r.stop), []).append(n)
    assert _partition([range(*s) for s in by_rows], row0, row0 + rows)
    assert all(_partition(ns, 0, cout) for ns in by_rows.values())
    terms = collections.Counter()
    k0s = layout.fwd_k_offsets(cins)
    _, _, ktot = layout.fwd_packed_shape(cins, cout)
    for i, chans, taps in blocks[0][2]:
        assert chans.start % layout.TILE_K == 0 and len(chans) <= layout.TILE_K
        assert k0s[i] + chans.stop <= ktot
        terms.update((i, c, t) for c in chans for t in taps)
    want = {(i, c, t) for i, ci in enumerate(cins) for c in range(ci)
            for t in range(27)}
    assert set(terms) == want and set(terms.values()) == {1}
    assert all(b[2] is blocks[0][2] for b in blocks)
    bm = layout.fwd_rows_per_block(cout, X, Y, Z)
    nt, dyg = layout.tile_n(cout), layout.fwd_dy_group(cout, X, Y, Z)
    assert bm in (128, 256, 512) and (bm == 128 or gm * gn >= layout.MIN_BLOCKS)
    assert layout.smem_bytes(bm, nt, Z + 2, dyg) <= layout.SMEM_LIMIT
    assert layout.run_rows(bm, Z + 2, dyg) <= layout.FWD_MAX_RUN_ROWS
    assert dyg == (1 if Z >= 300 else 3)


class _FakeLib:
    """A library whose exported tile constants are layout.py's, but for
    one."""

    def __init__(self, off_by):
        self.off_by = off_by

    def conv3x3x3_fwd_tile(self, what, cout, X, Y, Z):
        v = [layout.TILE_K, layout.STAGES, layout.tile_n(cout),
             layout.fwd_rows_per_block(cout, X, Y, Z),
             layout.fwd_dy_group(cout, X, Y, Z)][what]
        return v + (self.off_by if what == 3 else 0)

    def conv3x3x3_dx_tile(self, what, cout, X, Y, Z, edge):
        v = {0: layout.TILE_K, 1: layout.STAGES,
             2: layout.tile_n(cout),
             3: layout.dx_rows_per_block(cout, X, Y, Z, bool(edge))}[what]
        return v + (self.off_by if what == 3 else 0)

    def conv3x3x3_wgrad_tile(self, what, Z):
        return [layout.WGRAD_TILE_CI, layout.WGRAD_TILE_CO,
                layout.wgrad_step(Z), layout.WGRAD_TAP_GROUPS,
                layout.WGRAD_TARGET_BLOCKS, layout.WGRAD_MIN_STEPS,
                layout.wgrad_stages(Z), layout.wgrad_runs(Z)][what] + (
                    self.off_by if what == 2 else 0)

    def mxu_probe_tile(self, what, a, n, ps, reps, sms):
        if what >= 12:
            return layout.build_plan(a, n, ps, sms)[what - 12]
        if what >= 8:
            return [layout.PROBE_BUILD_STRIPS, layout.PROBE_BUILD_SEG,
                    layout.PROBE_BUILD_ROWS,
                    layout.PROBE_BUILD_MIN_STRIP][what - 8]
        dot, rdot = (layout.dot_plan(a, n, ps, reps, sms),
                     layout.rdot_plan(a, n, ps, reps, sms))
        return [layout.PROBE_BLOCKS_PER_SM, layout.PROBE_DOT_ROWS,
                layout.PROBE_RDOT_CHUNK, layout.probe_tile_n(n), dot[1],
                rdot[1], dot[0], rdot[0]][what] + (
                    self.off_by if what == 6 else 0)

    def max_pool_buf_bwd_tile(self, what, c, X, Y, Z, sms):
        if what < 4:
            return [layout.POOL_BWD_THREADS, layout.POOL_BWD_BLOCKS_PER_SM,
                    layout.POOL_BWD_FOLD_COLS,
                    layout.POOL_BWD_FOLD_BATCH][what]
        if what == 7:
            return layout.pool_bwd_workspace(c, X, Y, Z, sms)
        return layout.pool_bwd_plan(c, X, Y, Z, sms)[what - 4] + (
            self.off_by if what == 4 else 0)

    def gn_tile(self, what, n, s, c, groups, dtype, sms):
        if what < 7:
            return [layout.GN_THREADS, layout.GN_REDUCE_STAGES,
                    layout.GN_REDUCE_SWEEPS, layout.GN_REDUCE_BLOCKS_PER_SM,
                    layout.GN_DX_BLOCKS_PER_SM, layout.GN_DX_UNROLL,
                    layout.GN_STAGE_BYTES][what]
        if what == 11:
            return layout.gn_dx_blocks(n, s, sms)
        plan = layout.gn_reduce_plan if what < 11 else layout.gn_stats_plan
        return plan(n, s, c, groups, dtype, sms)[(what - 7) % 5] + (
            self.off_by if what == 15 else 0)


@pytest.mark.parametrize("name", ["conv3x3x3_fwd", "conv3x3x3_dx",
                                  "conv3x3x3_wgrad", "mxu_probe",
                                  "group_norm", "max_pool_buf_bwd"])
def test_loader_checks_tile_constants(name):
    """Loading kernel A's, C's, D's or E's library, the probe's or the
    GroupNorm kernels', compares its exported tile constants with
    layout.py's and raises on a mismatch."""
    kernels._check_tiles(name, _FakeLib(0))
    with pytest.raises(RuntimeError, match="tile constants"):
        kernels._check_tiles(name, _FakeLib(128))
