"""The plan of the probe's dot kernels on the CPU, with numpy and torch only.

``kernels/layout.py`` (``dot_plan``, ``rdot_plan``, ``block_items``,
``dot_item``, ``rdot_item``) mirrors the persistent grid of ``mxu_dot`` and
``mxu_rdot`` in ``csrc/mxu_probe.cu``. Here every plan covers each (output
tile, plane rows, rep) item exactly once with its blocks balanced to within
one item, at the JAX probe's 11 + 6 combinations (ps 10976, 200 reps) and at
the small shapes of ``test_torch_probe.py``; and the kernels' f32 summation
order (the source's "Exactness" note) is replayed in float32, per
accumulator element over a block's items, per warpgroup as the kernel folds,
and across blocks in forward and reversed order: it must give ``dot_value``
and ``rdot_value`` exactly, as phase 19 of ``chip_smoke.py`` requires of the
kernels on the card.

``slab_build``'s plan (``build_plan``, ``build_units``) splits the plane's
rows into strips and a row's vectors into segments: every (row, vector)
has one owner at the JAX probe's six combinations and at ps 40; and each
strip's bottom-up schedule (``build_schedule``), replayed on distinct
values, gives the plain shift restricted to the strip.
"""

import collections

import numpy as np
import pytest

from unetsulc_tpu_torch.kernels import layout
from unetsulc_tpu_torch.tools import mxu_probe as mp
from torch_threads import torch_one_thread  # noqa: F401,E402

H100_SMS = 132
# (k or m, n, ps, reps) at small sizes: test_torch_probe.py's shapes whose n
# and m the kernels take, and shapes with a ragged last tile, chunk or k16
# step
SMALL_DOTS = [(64, 64, 40, 2), (64, 128, 96, 2), (192, 64, 200, 2),
              (32, 384, 300, 3)]
SMALL_RDOTS = [(64, 64, 128, 2), (64, 64, 40, 2), (128, 192, 200, 3),
               (64, 576, 520, 2)]
DOT_CASES = ([(k, n, mp.PS, mp.REPS, H100_SMS) for k, n in mp.DOT_COMBOS]
             + [(*c, sms) for c in SMALL_DOTS for sms in (H100_SMS, 7)])
RDOT_CASES = ([(m, n, mp.PS, mp.REPS, H100_SMS) for m, n in mp.RDOT_COMBOS]
              + [(*c, sms) for c in SMALL_RDOTS for sms in (H100_SMS, 7)])


def _ids(cases):
    return ["x".join(map(str, c)) for c in cases]


def _blocks(items, blocks):
    """Each block's items, after checking the even split."""
    ranges = [layout.block_items(items, blocks, b) for b in range(blocks)]
    sizes = [len(r) for r in ranges]
    assert sum(sizes) == items and max(sizes) - min(sizes) <= 1
    assert all(a.stop == b.start for a, b in zip(ranges, ranges[1:]))
    return ranges


def _partition(spans, stop):
    """The (start, stop) spans tile [0, stop) without overlap."""
    spans = sorted(spans)
    assert spans[0][0] == 0 and spans[-1][1] == stop
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


def _runs(rng, per_tile):
    """(tile, first item, items) of each run of consecutive items of one
    output tile in a block's range."""
    i = rng.start
    while i < rng.stop:
        t = i // per_tile
        end = min(rng.stop, (t + 1) * per_tile)
        yield t, i, end - i
        i = end


def _seq_sum(terms):
    """float32 sum of ``terms`` in order, after checking that every
    partial is exact (equal to the float64 partial)."""
    t32 = np.asarray(terms, dtype=np.float32)
    part = np.cumsum(t32, dtype=np.float32)
    np.testing.assert_array_equal(part, np.cumsum(t32.astype(np.float64)))
    return part[-1]


def _cross_blocks(terms, want):
    """The atomics' sum in forward and reversed order, each exact."""
    for order in (terms, terms[::-1]):
        assert float(_seq_sum(order)) == want


# ---------------------------------------------------------------------------
# coverage and balance
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,n,ps,reps,sms", DOT_CASES, ids=_ids(DOT_CASES))
def test_dot_plan_covers_each_item_once(k, n, ps, reps, sms):
    blocks, items = layout.dot_plan(k, n, ps, reps, sms)
    assert blocks == min(items, sms * layout.PROBE_BLOCKS_PER_SM)
    nt = layout.probe_tile_n(n)
    assert nt in (64, 128, 192) and n % nt == 0 and (n <= 192) == (nt == n)
    cells = []
    for rng in _blocks(items, blocks):
        for i in rng:
            _, rows, cols, rep = layout.dot_item(i, n, ps, reps)
            cells.append((rows.start, rows.stop, cols.start, cols.stop, rep))
    # each cell once, and the cells are (row tile) x (column tile) x rep
    assert len(set(cells)) == len(cells)
    row_spans = {c[:2] for c in cells}
    col_spans = {c[2:4] for c in cells}
    assert {a % layout.PROBE_DOT_ROWS for a, _ in row_spans} == {0}
    assert {b - a for a, b in col_spans} == {nt}
    _partition(row_spans, ps)
    _partition(col_spans, n)
    assert set(cells) == {(*r, *c, rep) for r in row_spans for c in col_spans
                          for rep in range(reps)}


@pytest.mark.parametrize("m,n,ps,reps,sms", RDOT_CASES, ids=_ids(RDOT_CASES))
def test_rdot_plan_covers_each_item_once(m, n, ps, reps, sms):
    blocks, items, chunk = layout.rdot_plan(m, n, ps, reps, sms)
    assert blocks == min(items, sms * layout.PROBE_BLOCKS_PER_SM)
    assert chunk % 32 == 0
    cells, splits = [], set()
    for rng in _blocks(items, blocks):
        for i in rng:
            _, ms, ns, (w0, w1), rep = layout.rdot_item(i, m, n, ps, reps)
            cells.append((ms.start, ms.stop, ns.start, ns.stop, w0.start,
                          w1.stop, rep))
            splits.add((w0.start, w0.stop, w1.start, w1.stop))
    # warpgroup 0 takes the chunk's first half of k16 steps (rounded up),
    # warpgroup 1 the rest
    for a0, a1, b0, b1 in splits:
        assert a0 % chunk == 0 and a1 == b0 and b1 - a0 <= chunk
        assert a1 % 16 == 0 or a1 == ps
        assert 0 <= -(-(a1 - a0) // 16) - -(-(b1 - b0) // 16) <= 1
    assert len(set(cells)) == len(cells)
    spans = [{c[j:j + 2] for c in cells} for j in (0, 2, 4)]
    for s, stop in zip(spans, (m, n, ps)):
        _partition(s, stop)
    assert set(cells) == {(*a, *b, *c, rep) for a in spans[0]
                          for b in spans[1] for c in spans[2]
                          for rep in range(reps)}


# ---------------------------------------------------------------------------
# the kernels' summation order, replayed in float32
# ---------------------------------------------------------------------------


def _dot_fold(e, valid):
    """mxu_dot's fold of one column of a warpgroup's 64 rows, each element
    e, ``valid`` (4 warps, 8 row groups, 2 halves) the rows it adds: rows r
    and r + 8 in each thread, the row groups by shuffles (lane ^ 4, ^ 8,
    ^ 16), then the four warps pairwise."""
    x = np.where(valid, np.float32(e), np.float32(0))
    x = x[:, :, 0] + x[:, :, 1]
    for _ in range(3):
        x = x[:, 0::2] + x[:, 1::2]
    x = x[:, 0]
    return (x[0] + x[1]) + (x[2] + x[3])


def _tree(e, length):
    """csrc/mxu_probe.cu's tree_sum of ``length`` elements, each e."""
    if length == 1:
        return e
    return _tree(e, length // 2) + _tree(e, length - length // 2)


def _rdot_fold(e, nt):
    """mxu_rdot's fold of a warpgroup's 64 x nt tile, every element e: each
    thread's nt / 2 as a pairwise tree, then the 32 lanes and the four warps
    pairwise."""
    x = _tree(np.float32(e), nt // 2)
    for _ in range(5):
        x = x + x
    return (x + x) + (x + x)


@pytest.mark.parametrize("k,n,ps,reps,sms", DOT_CASES, ids=_ids(DOT_CASES))
def test_dot_summation_is_exact(k, n, ps, reps, sms):
    blocks, items = layout.dot_plan(k, n, ps, reps, sms)
    g = np.arange(8)[None, :, None] + 8 * np.arange(2)[None, None, :]
    rows_in_wg = 16 * np.arange(4)[:, None, None] + g
    terms = collections.defaultdict(list)  # column tile -> atomics
    for rng in _blocks(items, blocks):
        for _, first, count in _runs(rng, reps):
            _, rows, cols, _ = layout.dot_item(first, n, ps, reps)
            # every element: count reps of k / 16 wgmmas, each adding 16
            # products of 0.25
            e = _seq_sum(np.full(count * (k // 16), 4.0))
            for w in range(2):
                valid = rows.start + 64 * w + rows_in_wg < rows.stop
                terms[cols.start].append(_dot_fold(e, valid))
    want = mp.dot_value(k, ps, reps)
    assert len(terms) == n // layout.probe_tile_n(n)
    for col_terms in terms.values():
        _cross_blocks(col_terms, want)
        if ps == mp.PS:
            # every term a multiple of the f32 spacing at the total: the
            # atomics are exact in any order
            spacing = float(np.spacing(np.float32(want)))
            assert all(float(t) % spacing == 0 for t in col_terms)


@pytest.mark.parametrize("m,n,ps,reps,sms", RDOT_CASES, ids=_ids(RDOT_CASES))
def test_rdot_summation_is_exact(m, n, ps, reps, sms):
    blocks, items, _ = layout.rdot_plan(m, n, ps, reps, sms)
    nt = layout.probe_tile_n(n)
    per_tile = -(-ps // layout.PROBE_RDOT_CHUNK) * reps
    terms = []
    for rng in _blocks(items, blocks):
        for _, first, count in _runs(rng, per_tile):
            # the run's items in groups of one chunk (consecutive reps)
            parts = [[], []]
            i = first
            while i < first + count:
                end = min(first + count, (i // reps + 1) * reps)
                _, _, _, wgs, _ = layout.rdot_item(i, m, n, ps, reps)
                for w, rows in enumerate(wgs):
                    # one wgmma per k16 step of the warpgroup's rows, each
                    # adding (its rows) products of 0.25
                    step = [min(16, rows.stop - r) * 0.25
                            for r in range(rows.start, rows.stop, 16)]
                    parts[w].append(np.tile(step, end - i))
                i = end
            for p in parts:
                e = _seq_sum(np.concatenate(p)) if sum(map(len, p)) else 0.0
                terms.append(_rdot_fold(e, nt))
    want = mp.rdot_value(m, n, ps, reps)
    _cross_blocks(terms, want)
    if ps == mp.PS:
        spacing = float(np.spacing(np.float32(want)))
        assert all(float(t) % spacing == 0 for t in terms)


# ---------------------------------------------------------------------------
# slab_build: strips and their schedule
# ---------------------------------------------------------------------------

BUILD_CASES = ([(cs, c, mp.PS, H100_SMS) for cs, c in mp.BUILD_COMBOS]
               + [(cs, c, 40, sms) for cs, c in mp.BUILD_COMBOS
                  for sms in (H100_SMS, 7)]
               + [(8, 2, 200, H100_SMS), (2048, 1, 600, H100_SMS)])


@pytest.mark.parametrize("cs,copies,ps,sms", BUILD_CASES,
                         ids=_ids(BUILD_CASES))
def test_build_strips_partition_the_plane(cs, copies, ps, sms):
    blocks, warps, segs, rows = layout.build_plan(cs, copies, ps, sms)
    assert rows == -(-ps // blocks)
    assert rows * copies * cs * 2 <= layout.SMEM_LIMIT
    assert warps <= layout.PROBE_BUILD_MAX_WARPS
    units = layout.build_units(cs, copies, ps, sms)
    assert len(units) == blocks * layout.PROBE_BUILD_STRIPS * segs
    owners = collections.Counter()
    per_warp = collections.Counter()
    for b, warp, vecs, strip in units:
        block_rows = layout.block_items(ps, blocks, b)
        assert block_rows.start <= strip.start <= strip.stop <= block_rows.stop
        assert len(vecs) <= layout.PROBE_BUILD_SEG
        # the warp's four quarters hold every row of the strip once
        lane_rows = [r for q in range(4)
                     for r in layout.build_lane_rows(strip, q)]
        assert sorted(lane_rows) == list(strip)
        owners.update((r, k) for r in strip for k in vecs)
        per_warp[b, warp] += 1
    assert set(owners.values()) == {1}
    assert set(owners) == {(r, k) for r in range(ps) for k in range(cs // 8)}
    # the warps of a block share its units evenly
    assert max(per_warp.values()) - min(per_warp.values()) <= 1
    if ps == mp.PS:
        # at the probe's plane: one block per SM, strips of at least the
        # minimum (the rows whose stores a strip leaves out, one per strip)
        assert blocks == sms
        assert min(len(u[3]) for u in units) >= layout.PROBE_BUILD_MIN_STRIP


def _replay_strip(strip, reps):
    """One unit's column over ``reps`` builds in the kernel's schedule, on
    distinct values, with an injective stand-in for the norm (2 v + 1)."""
    col = {r: float(1000 + r) for r in strip}
    loaded = []
    for op, rows in layout.build_schedule(strip, reps):
        if op == "load":
            loaded.append([(r, col[r]) for r in rows])
        else:
            got = loaded.pop(0)
            assert [r for r, _ in got] == rows
            for r, v in got:
                if r + 1 < strip.stop:
                    col[r + 1] = 2 * v + 1
    assert not loaded
    return [col[r] for r in strip]


def _plain_strip(strip, reps):
    col = [float(1000 + r) for r in strip]
    for _ in range(reps):
        col = col[:1] + [2 * v + 1 for v in col[:-1]]
    return col


@pytest.mark.parametrize("length", [1, 2, 7, 8, 9, 15, 16, 17, 20, 21, 24,
                                    25, 31, 32])
@pytest.mark.parametrize("reps", [0, 1, 2, 5])
def test_build_schedule_gives_the_plain_shift(length, reps):
    strip = range(100, 100 + length)
    assert _replay_strip(strip, reps) == _plain_strip(strip, reps)
