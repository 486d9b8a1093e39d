"""The plan of the four GroupNorm kernels on the CPU, numpy and torch only.

``kernels/layout.py`` (``gn_stats_plan``, ``gn_reduce_plan``,
``gn_dx_blocks``, ``gn_block_rows``, ``gn_fold_columns``,
``gn_tree_pairs``) mirrors the one-wave plan of ``gn_stats``,
``gn_apply``, ``gn_bwd_reduce`` and ``gn_bwd_dx`` in
``csrc/group_norm.cu``. Here each plan covers every (sample, row, channel)
of the slab exactly once with blocks within one row of each other, at the
flagship non-fused model's 14 GroupNorm slabs, the f32 and odd slabs of
``chip_smoke.py`` phase 12, on an H100's 132 SMs and on 7; the workspace
that the wrappers of the two reductions allocate is the plan's; and each
reduction's fixed summation order (each row lane's sum in row order, a
pairwise tree over the lanes, each folded column in strided segments over
the blocks and a pairwise tree over the segments, the group sums in
channel order; for the backward reduce dscale and dbias over the samples in
order) replayed in float32 on small slabs gives the plain version's result:
``gn_stats_plain``'s mean and inv within rtol 1e-5, ``gn_bwd_reduce_plain``'s
within rtol 1e-5 and atol 1e-6 of the largest magnitude (two float32
orders of the same sums), the same bits in two runs. The sharded
GroupNorm's modes run the same plan: ``gn_stats_sums``' replayed sums are
``gn_sums_plain``'s within rtol 1e-5, and a slab's three uneven row
ranges, each on its own plan, added in shard order and finalized over the
global count as ``gn_finalize`` does, give ``gn_stats_plain`` of the
whole slab within rtol 1e-5.
"""

import numpy as np
import pytest
import torch

from unetsulc_tpu_torch import kernels
from unetsulc_tpu_torch.kernels import layout
from unetsulc_tpu_torch.ops import groupnorm as gn
from torch_threads import torch_one_thread  # noqa: F401,E402

H100_SMS = 132
# (name, extent, channels) of the flagship non-fused model's GroupNorms
# (chip_smoke.py GN_LAYERS), bf16, 32 groups
LAYERS = [("enc0.norm1", 96, 32), ("enc0.norm2", 96, 64),
          ("enc1.norm1", 49, 64), ("enc1.norm2", 49, 128),
          ("enc2.norm1", 25, 128), ("enc2.norm2", 25, 256),
          ("enc3.norm1", 13, 256), ("enc3.norm2", 13, 512),
          ("dec0.norm1", 25, 256), ("dec0.norm2", 25, 256),
          ("dec1.norm1", 49, 128), ("dec1.norm2", 49, 128),
          ("dec2.norm1", 96, 64), ("dec2.norm2", 96, 64)]
# (n, s, c, groups, dtype code: 0 bf16, 1 f32)
SLABS = ([(1, e ** 3, c, 32, 0) for _, e, c in LAYERS]
         + [(1, 49 ** 3, 128, 32, 1), (2, 9 * 7 * 5, 36, 12, 0)])
CASES = [(*slab, sms) for slab in SLABS for sms in (H100_SMS, 7)]
IDS = [f"{n}x{s}x{c}-g{g}-{'bf16' if d == 0 else 'f32'}-{sms}sm"
       for n, s, c, g, d, sms in CASES]


def _both(first, second):
    """CASES for each of two kernels sharing a plan: the first keeps IDS
    (its tests' ids before the second joined them), the second's are
    prefixed with its name."""
    return dict(argvalues=[(k, *c) for k in (first, second) for c in CASES],
                ids=IDS + [f"{second}-{i}" for i in IDS])


def _check_blocks(n, s, bs, sms, per_sm):
    """The N * Bs blocks: at most a wave, each sample's rows split into Bs
    contiguous ranges, within one row of each other."""
    assert n * bs <= max(n, sms * per_sm)
    assert bs == min(s, max(1, sms * per_sm // n))
    ranges = [layout.gn_block_rows(s, bs, j) for j in range(bs)]
    assert ranges[0].start == 0 and ranges[-1].stop == s
    assert all(a.stop == b.start for a, b in zip(ranges, ranges[1:]))
    sizes = [len(r) for r in ranges]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    return ranges


def _check_threads(c, dtype, lanes):
    """The threads' fixed (row lane, channel vector): every channel of
    every row of a block once."""
    v = layout.gn_vec(dtype)
    cvs = -(-c // v)
    assert lanes == layout.GN_THREADS // cvs and lanes >= 1
    owner = np.full((lanes, c), -1)
    for t in range(lanes * cvs):
        r, cv = divmod(t, cvs)
        cols = slice(cv * v, min(cv * v + v, c))
        assert (owner[r, cols] == -1).all()
        owner[r, cols] = t
    assert (owner >= 0).all()


@pytest.mark.parametrize("kernel,n,s,c,groups,dtype,sms",
                         **_both("gn_bwd_reduce", "gn_stats"))
def test_reduce_plan_covers_each_row_and_channel_once(kernel, n, s, c, groups,
                                                      dtype, sms):
    stats = kernel == "gn_stats"
    plan = layout.gn_stats_plan if stats else layout.gn_reduce_plan
    bs, lanes, chunk, folders = plan(n, s, c, groups, dtype, sms)
    _check_blocks(n, s, bs, sms, layout.GN_REDUCE_BLOCKS_PER_SM)
    _check_threads(c, dtype, lanes)
    # a ring stage: whole row sweeps of each tensor (gn_stats: twice as
    # many, of x alone), within its bytes, and (rows of whole 16-byte
    # vectors) a multiple of 16 bytes for each bulk copy
    esize = 2 if dtype == 0 else 4
    tensors = 1 if stats else 2
    assert chunk == layout.GN_REDUCE_SWEEPS * lanes * (2 if stats else 1)
    assert tensors * chunk * c * esize <= 2 * layout.GN_STAGE_BYTES
    if c % layout.gn_vec(dtype) == 0:
        assert (chunk * c * esize) % 16 == 0
    # the folding blocks: at most half the resident blocks, each unit
    # folded by one of them (gn_stats: both sums of one (sample, group);
    # gn_bwd_reduce: a group's sums of g * xhat, or of g)
    nunits = n * groups if stats else 2 * groups
    assert 1 <= folders <= max(1, min(n * bs, sms) // 2)
    assert folders == min(nunits, max(1, min(n * bs, sms) // 2))
    units = sorted(u for f in range(folders)
                   for u in range(f, nunits, folders))
    assert units == list(range(nunits))
    # the fold's passes: each of a unit's columns once, segments filling
    # at most the block
    ncol = (2 if stats else 1) * (c // groups)
    passes = layout.gn_fold_columns(ncol)
    assert sum(w for _, w, _ in passes) == ncol
    assert [p[0] for p in passes] == list(range(0, ncol, layout.GN_THREADS))
    assert all(1 <= w * t <= layout.GN_THREADS for _, w, t in passes)


@pytest.mark.parametrize("kernel,n,s,c,groups,dtype,sms",
                         **_both("gn_bwd_dx", "gn_apply"))
def test_dx_plan_covers_each_row_and_channel_once(kernel, n, s, c, groups,
                                                  dtype, sms):
    # gn_apply runs gn_bwd_dx's plan (gn_tile's code 11 is both)
    bs = layout.gn_dx_blocks(n, s, sms)
    ranges = _check_blocks(n, s, bs, sms, layout.GN_DX_BLOCKS_PER_SM)
    lanes = layout.gn_lanes(c, dtype)
    _check_threads(c, dtype, lanes)
    # each lane's rows of a block: r, r + R, ... once each
    for rows in (ranges[0], ranges[-1]):
        seen = sorted(i for r in range(lanes)
                      for i in range(rows.start + r, rows.stop, lanes))
        assert seen == list(rows)


@pytest.mark.parametrize("kernel,n,s,c,groups,dtype,sms",
                         **_both("gn_bwd_reduce", "gn_stats"))
def test_workspace_is_the_plans(kernel, n, s, c, groups, dtype, sms):
    ws, counter = kernels._gn_workspace(kernel, n, s, c, groups, dtype, sms,
                                        "cpu")
    bs = min(s, max(1, sms * layout.GN_REDUCE_BLOCKS_PER_SM // n))
    assert ws.dtype == torch.float32 and ws.numel() == n * bs * 2 * c
    assert counter.dtype == torch.int32 and counter.numel() == 1
    assert int(counter[0]) == 0


# ---------------------------------------------------------------------------
# the reductions' summation order, replayed in float32
# ---------------------------------------------------------------------------


def _tree(rows):
    """The kernels' pairwise tree over the first axis, in place; row 0."""
    for a, b in layout.gn_tree_pairs(len(rows)):
        rows[a] = rows[a] + rows[b]
    return rows[0]


def _partials(first, second, bs, lanes):
    """(N, Bs, 2, C): each block's per-channel sums of the (N, S, C)
    float32 values ``first`` and ``second`` (each row lane's rows in
    order, then the pairwise tree over the lanes)."""
    n, s, c = first.shape
    partial = np.zeros((n, bs, 2, c), np.float32)
    for nn in range(n):
        for j in range(bs):
            rows = layout.gn_block_rows(s, bs, j)
            acc = np.zeros((2, lanes, c), np.float32)
            for f in range(rows.start, rows.stop, lanes):
                k = min(lanes, rows.stop - f)
                acc[0, :k] = acc[0, :k] + first[nn, f:f + k]
                acc[1, :k] = acc[1, :k] + second[nn, f:f + k]
            partial[nn, j, 0] = _tree(acc[0])
            partial[nn, j, 1] = _tree(acc[1])
    return partial


def _fold(cols):
    """The (ncol,) sums of a unit's (Bs, ncol) partial columns, added as a
    folding block adds them."""
    bs, ncol = cols.shape
    out = np.zeros(ncol, np.float32)
    for cc, w, segs in layout.gn_fold_columns(ncol):
        seg = np.zeros((segs, w), np.float32)
        for k in range(segs):
            for b in range(k, bs, segs):
                seg[k] = seg[k] + cols[b, cc:cc + w]
        out[cc:cc + w] = _tree(seg)
    return out


def _replay_sums(x, groups, sms, dtype):
    """(sum x, sum x^2) in float32, added in the order that gn_stats and
    its sums mode (gn_stats_sums) add them."""
    n, s, c = x.shape
    cg = c // groups
    bs, lanes, _, _ = layout.gn_stats_plan(n, s, c, groups, dtype, sms)
    partial = _partials(x, x * x, bs, lanes)
    sums = np.zeros((n, groups), np.float32)
    sq = np.zeros((n, groups), np.float32)
    for u in range(n * groups):
        # unit u: both sums of group u % G of sample u // G
        nn, gi = divmod(u, groups)
        chans = slice(gi * cg, (gi + 1) * cg)
        nsum = _fold(np.concatenate([partial[nn][:, 0, chans],
                                     partial[nn][:, 1, chans]], axis=1))
        tx = tq = np.float32(0)
        for ch in range(cg):
            tx = np.float32(tx + nsum[ch])
            tq = np.float32(tq + nsum[cg + ch])
        sums[nn, gi], sq[nn, gi] = tx, tq
    return sums, sq


def _replay_finalize(sums, sq, count, eps):
    """(mean, inv) from the sums over ``count`` elements: gn_stats' tail,
    and gn_finalize's."""
    denom = np.float32(count)
    mean = (sums / denom).astype(np.float32)
    var = ((sq / denom).astype(np.float32)
           - (mean * mean).astype(np.float32)).astype(np.float32)
    return mean, (np.float32(1) / np.sqrt(var + np.float32(eps))).astype(
        np.float32)


def _replay_stats(x, groups, eps, sms, dtype):
    """(mean, inv) in float32, added in the order that gn_stats adds
    them."""
    _, s, c = x.shape
    return _replay_finalize(*_replay_sums(x, groups, sms, dtype),
                            s * (c // groups), eps)


def _replay_reduce(x, g, mean, inv, scale, sms, dtype):
    """(dscale, dbias, sdx, sdxx) in float32, added in the order that
    gn_bwd_reduce adds them."""
    n, s, c = x.shape
    groups = mean.shape[1]
    cg = c // groups
    bs, lanes, _, _ = layout.gn_reduce_plan(n, s, c, groups, dtype, sms)
    xh = (x - np.repeat(mean, cg, axis=1)[:, None]) * np.repeat(
        inv, cg, axis=1)[:, None]
    partial = _partials(g * xh, g, bs, lanes)
    dscale = np.zeros(c, np.float32)
    dbias = np.zeros(c, np.float32)
    sdx = np.zeros((n, groups), np.float32)
    sdxx = np.zeros((n, groups), np.float32)
    for u in range(2 * groups):
        # unit u: quantity u % 2 (0: g * xhat, 1: g) of group u // 2
        gi, q = divmod(u, 2)
        chans = np.arange(gi * cg, (gi + 1) * cg)
        ds = np.zeros(cg, np.float32)
        for nn in range(n):
            nsum = _fold(partial[nn][:, q, chans])
            t = np.float32(0)
            for ch in range(cg):
                t = np.float32(t + scale[chans[ch]] * nsum[ch])
            (sdx if q else sdxx)[nn, gi] = t
            ds = ds + nsum
        (dbias if q else dscale)[chans] = ds
    return dscale, dbias, sdx, sdxx


# (n, s, c, groups, dtype, sms): several blocks, lanes and fold segments,
# vectors filled and not, more folders than units and fewer
REPLAY_CASES = [(1, 343, 32, 32, 0, 7), (2, 315, 36, 12, 0, 7),
                (1, 125, 128, 32, 1, 7), (2, 60, 16, 8, 1, 132),
                (3, 40, 24, 2, 0, 5), (1, 1000, 64, 32, 0, 132)]
REPLAY_IDS = ["x".join(map(str, k)) for k in REPLAY_CASES]


def _replay_inputs(n, s, c, dtype):
    r = np.random.default_rng(s + c)
    tdtype = torch.bfloat16 if dtype == 0 else torch.float32
    x = torch.from_numpy(np.maximum(r.normal(size=(n, s, c)), 0)
                         .astype(np.float32)).to(tdtype)
    g = torch.from_numpy((1e-3 * r.normal(size=(n, s, c)))
                         .astype(np.float32)).to(tdtype)
    scale = torch.from_numpy((1 + 0.1 * r.normal(size=c)).astype(np.float32))
    return x, g, scale


@pytest.mark.parametrize("n,s,c,groups,dtype,sms", REPLAY_CASES,
                         ids=REPLAY_IDS)
def test_stats_order_gives_the_plain_result(n, s, c, groups, dtype, sms):
    x, _, _ = _replay_inputs(n, s, c, dtype)
    want = gn.gn_stats_plain(x, groups, 1e-5)
    xf = x.float().numpy()
    got = _replay_stats(xf, groups, 1e-5, sms, dtype)
    again = _replay_stats(xf, groups, 1e-5, sms, dtype)
    for a, b, w in zip(got, again, want):
        assert a.dtype == np.float32
        assert a.tobytes() == b.tobytes()
        np.testing.assert_allclose(a, w.numpy(), rtol=1e-5)


@pytest.mark.parametrize("n,s,c,groups,dtype,sms", REPLAY_CASES,
                         ids=REPLAY_IDS)
def test_reduce_order_gives_the_plain_result(n, s, c, groups, dtype, sms):
    x, g, scale = _replay_inputs(n, s, c, dtype)
    mean, inv = gn.gn_stats_plain(x, groups, 1e-5)
    want = gn.gn_bwd_reduce_plain(x, g, mean, inv, scale)
    args = [t.float().numpy() for t in (x, g, mean, inv, scale)]
    got = _replay_reduce(*args, sms, dtype)
    again = _replay_reduce(*args, sms, dtype)
    for a, b, w in zip(got, again, want):
        assert a.dtype == np.float32
        assert a.tobytes() == b.tobytes()
        w = w.numpy()
        np.testing.assert_allclose(a, w, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(w).max()))


@pytest.mark.parametrize("n,s,c,groups,dtype,sms", REPLAY_CASES,
                         ids=REPLAY_IDS)
def test_sums_mode_order_gives_the_plain_sums(n, s, c, groups, dtype, sms):
    """gn_stats_sums: gn_stats' plan and fold with the finalize left out,
    its sums within rtol 1e-5 of ``gn_sums_plain``'s, the same bits in
    two runs."""
    x, _, _ = _replay_inputs(n, s, c, dtype)
    want = gn.gn_sums_plain(x, groups)
    xf = x.float().numpy()
    got = _replay_sums(xf, groups, sms, dtype)
    again = _replay_sums(xf, groups, sms, dtype)
    for a, b, w in zip(got, again, want):
        assert a.dtype == np.float32 and a.tobytes() == b.tobytes()
        np.testing.assert_allclose(a, w.numpy(), rtol=1e-5)


@pytest.mark.parametrize("n,s,c,groups,dtype,sms", REPLAY_CASES,
                         ids=REPLAY_IDS)
def test_sharded_sums_finalize_to_the_whole_slab(n, s, c, groups, dtype, sms):
    """A slab cut into three uneven row ranges (the sharded GroupNorm's
    shards): each range's sums on its own plan, added in shard order in
    float32 and finalized over the global count (gn_finalize), give
    ``gn_stats_plain`` of the whole slab within rtol 1e-5."""
    x, _, _ = _replay_inputs(n, s, c, dtype)
    xf = x.float().numpy()
    cuts = [0, s // 3, s // 3 + s // 2, s]
    parts = [_replay_sums(xf[:, a:b], groups, sms, dtype)
             for a, b in zip(cuts, cuts[1:])]
    sums, sq = parts[0]
    for ps, pq in parts[1:]:
        sums, sq = (sums + ps).astype(np.float32), (sq + pq).astype(np.float32)
    got = _replay_finalize(sums, sq, s * (c // groups), 1e-5)
    for a, w in zip(got, gn.gn_stats_plain(x, groups, 1e-5)):
        np.testing.assert_allclose(a, w.numpy(), rtol=1e-5)
