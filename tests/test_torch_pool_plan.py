"""The plan of kernel E (the pool backward) on the CPU, with numpy and torch
only.

``kernels/layout.py`` (``pool_bwd_plan``, ``pool_bwd_owned``,
``pool_bwd_workspace``) mirrors the one-wave launch of
``csrc/max_pool_buf_bwd.cu``. Here the plan owns every pooled voxel once
(blocks within one voxel of each other, each block's lanes covering its
voxels once) and writes every element of dx exactly once, ring included,
at the flagship's three pools, at odd extents and with channel tails, on
an H100's 132 SMs and on 7; and the kernel's f32 summation order of
d(affine) (per lane in voxel order, a pairwise tree over the lanes, the
fold's strided segments and their tree) is replayed in float32 against
``max_pool_buf_bwd_plain``.
"""

import numpy as np
import pytest
import torch

from unetsulc_tpu_torch.kernels import layout
from unetsulc_tpu_torch.ops import conv_fused as cf
from torch_threads import torch_one_thread  # noqa: F401,E402

H100_SMS = 132
# (C, X, Y, Z): the flagship's three pools, odd extents with channel tails
SHAPES = [(64, 96, 96, 96), (128, 49, 49, 49), (256, 25, 25, 25),
          (12, 9, 8, 11), (10, 7, 9, 5)]
CASES = [(*s, sms) for s in SHAPES for sms in (H100_SMS, 7)]
IDS = ["{}x{}x{}x{}-{}sm".format(*c) for c in CASES]
# the replays: odd extents, and the flagship's two smaller pools
REPLAY = [(12, 9, 8, 11, H100_SMS), (12, 9, 8, 11, 7), (10, 7, 9, 5, 7),
          (128, 49, 49, 49, H100_SMS), (256, 25, 25, 25, H100_SMS)]
REPLAY_IDS = ["{}x{}x{}x{}-{}sm".format(*c) for c in REPLAY]


def _lane_voxels(c, X, Y, Z, sms):
    """(block, lane, voxel) of every voxel a lane walks, as arrays."""
    ox, oy, oz = layout.pool_bwd_voxels(X, Y, Z)
    v = ox * oy * oz
    blocks, lanes, _ = layout.pool_bwd_plan(c, X, Y, Z, sms)
    out = []
    for b in range(blocks):
        rng = layout.block_items(v, blocks, b)
        for r in range(lanes):
            vs = np.arange(rng.start + r, rng.stop, lanes)
            out.append(np.stack([np.full(len(vs), b), np.full(len(vs), r),
                                 vs]))
    return np.concatenate(out, axis=1), v, blocks


@pytest.mark.parametrize("c,X,Y,Z,sms", CASES, ids=IDS)
def test_pool_bwd_plan_owns_each_pooled_voxel_once(c, X, Y, Z, sms):
    blocks, lanes, folders = layout.pool_bwd_plan(c, X, Y, Z, sms)
    assert blocks <= sms * layout.POOL_BWD_BLOCKS_PER_SM
    assert lanes * -(-c // 8) <= layout.POOL_BWD_THREADS
    assert 1 <= folders <= max(1, min(blocks, sms) // 2)
    (bs, _, vs), v, _ = _lane_voxels(c, X, Y, Z, sms)
    assert np.array_equal(np.sort(vs), np.arange(v))
    sizes = np.bincount(bs, minlength=blocks)
    assert sizes.max() - sizes.min() <= 1
    # a block's voxels are one run, and the blocks follow each other
    starts = np.array([layout.block_items(v, blocks, b).start
                       for b in range(blocks)])
    assert np.array_equal(starts, np.concatenate([[0], np.cumsum(sizes)[:-1]]))
    # each 16-byte channel vector's channels, once per lane
    vecs = [range(8 * k, min(8 * k + 8, c)) for k in range(-(-c // 8))]
    assert [ch for r in vecs for ch in r] == list(range(c))


@pytest.mark.parametrize("c,X,Y,Z,sms", CASES, ids=IDS)
def test_pool_bwd_plan_covers_dx_once(c, X, Y, Z, sms):
    """Every padded position of dx lies in exactly one pooled voxel's box
    (the owned ranges of its three indices); the box is the voxel's window
    and ring positions only; with the voxels' single owners and the channel
    vectors above, every dx element, ring included, is written once."""
    for o_n, e in zip(layout.pool_bwd_voxels(X, Y, Z), (X, Y, Z)):
        cnt = np.zeros(e + 2, dtype=np.int64)
        for o in range(o_n):
            own = layout.pool_bwd_owned(o, e)
            cnt[own.start:own.stop] += 1
            # the window, then ring positions that no window covers
            assert own.start == 2 * o and len(own) in (2, 3)
            assert all(p == e + 1 for p in own[2:])
        assert (cnt == 1).all()
    (_, _, vs), _, _ = _lane_voxels(c, X, Y, Z, sms)
    if len(vs) <= 20000:
        # the boxes of the voxels the lanes walk, position by position
        ox_n, oy_n, oz_n = layout.pool_bwd_voxels(X, Y, Z)
        grid = np.zeros((X + 2, Y + 2, Z + 2), dtype=np.int64)
        for v in vs:
            ox, rest = divmod(int(v), oy_n * oz_n)
            oy, oz = divmod(rest, oz_n)
            grid[np.ix_(layout.pool_bwd_owned(ox, X),
                        layout.pool_bwd_owned(oy, Y),
                        layout.pool_bwd_owned(oz, Z))] += 1
        assert (grid == 1).all()


@pytest.mark.parametrize("c,X,Y,Z,sms", CASES, ids=IDS)
def test_pool_bwd_workspace(c, X, Y, Z, sms):
    blocks = layout.pool_bwd_plan(c, X, Y, Z, sms)[0]
    assert layout.pool_bwd_workspace(c, X, Y, Z, sms) == blocks * 2 * c + 1


def _contributions(buf, aff, out, cot, g):
    """Per pooled voxel (x, y, z order) and channel, float32: the raw x at
    the first window position equal to the max, times d; and d (0 where no
    position matches), as kernel E adds them."""
    go = cf.pool_geom(g)
    mask = cf.interior_mask(g, buf.device)
    v = torch.where(mask, cf.apply_affine(buf, aff), float("-inf"))
    w = cf._pool_windows(v, go)
    o = cf.unpad_from_geom(out, go)[0]
    match = w == o[..., None, :]
    first = match.to(torch.uint8).argmax(3, keepdim=True)
    hx = cf._pool_windows(buf.float(), go).gather(3, first)[..., 0, :]
    d = torch.where(match.any(3), cf.unpad_from_geom(cot, go)[0].float(), 0.0)
    c = buf.shape[-1]
    hx = hx.reshape(-1, c).numpy().astype(np.float32)
    d = d.reshape(-1, c).numpy().astype(np.float32)
    return hx * d, d


def _tree(rows, axis):
    """The kernels' pairwise tree over ``axis`` (gn_tree_pairs' order)."""
    rows = np.moveaxis(rows, axis, 0).copy()
    for i, j in layout.gn_tree_pairs(rows.shape[0]):
        rows[i] = rows[i] + rows[j]
    return rows[0]


def _replay_dab(ta, tb, c, X, Y, Z, sms):
    """Kernel E's d(affine) from the per-voxel terms, in its order:
    per lane in voxel order, the lanes' tree, then the fold."""
    v = ta.shape[0]
    blocks, lanes, _ = layout.pool_bwd_plan(c, X, Y, Z, sms)
    terms = np.concatenate([ta, tb], axis=1)  # (V, 2C): da's, then db's
    starts = np.array([layout.block_items(v, blocks, b).start
                       for b in range(blocks)])
    stops = np.array([layout.block_items(v, blocks, b).stop
                      for b in range(blocks)])
    acc = np.zeros((blocks, lanes, 2 * c), dtype=np.float32)
    r = np.arange(lanes)
    for k in range(-(-int((stops - starts).max()) // lanes)):
        vox = starts[:, None] + r[None, :] + k * lanes
        live = vox < stops[:, None]
        add = terms[np.where(live, vox, 0)]
        acc = np.where(live[..., None], acc + add, acc)
    partial = _tree(acc, 1)  # (B, 2C)
    segs = layout.POOL_BWD_THREADS // layout.POOL_BWD_FOLD_COLS
    seg = np.zeros((segs, 2 * c), dtype=np.float32)
    for k in range(segs):
        for b in range(k, blocks, segs):
            seg[k] = seg[k] + partial[b]
    return _tree(seg, 0).reshape(2, c)


@pytest.mark.parametrize("c,X,Y,Z,sms", REPLAY, ids=REPLAY_IDS)
def test_pool_bwd_order_gives_the_plain_result(c, X, Y, Z, sms):
    rng = np.random.default_rng(c * 1000 + X)
    g = cf.make_geom(X, Y, Z)
    x = np.maximum(rng.standard_normal((1, X, Y, Z, c)), 0)
    buf = cf.pad_to_geom(torch.from_numpy(x).to(torch.bfloat16), g)
    aff = torch.from_numpy(np.stack([
        0.5 + rng.random(c), 0.2 * rng.standard_normal(c)]).astype(np.float32))
    out = cf.max_pool_buf_plain(buf, aff, g)
    go = cf.pool_geom(g)
    cot = cf.pad_to_geom(torch.from_numpy(
        1e-2 * rng.standard_normal((1, go.X, go.Y, go.Z, c))).to(torch.bfloat16),
        go)
    _, want = cf.max_pool_buf_bwd_plain(buf, aff, out, cot, g)
    ta, tb = _contributions(buf, aff, out, cot, g)
    got = _replay_dab(ta, tb, c, X, Y, Z, sms)
    again = _replay_dab(ta, tb, c, X, Y, Z, sms)
    assert got.dtype == np.float32 and got.tobytes() == again.tobytes()
    # d has both signs, so a channel's sum can cancel far below its terms;
    # there the two f32 orders differ by an ulp of the terms, not of the
    # sum (as test_reduce_order_gives_the_plain_result allows for)
    want = want.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))
