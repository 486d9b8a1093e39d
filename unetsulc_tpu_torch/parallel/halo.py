"""Spatial parallelism without the fused pipeline: the non-fused model's
ops on a volume split along X over shards, with explicit halo exchange.

The counterpart of ``unetsulc_tpu/parallel/halo.py`` and of what XLA's
SPMD partitioner does for the JAX package's ``pjit_auto_spmd`` step (the
plain step with the batch sharded over (data, space) and the parameters
replicated, ``unetsulc_tpu/method/training.py:115-141``). PyTorch has no
partitioner, so this module writes the schedule out, one process driving
every shard (:mod:`unetsulc_tpu_torch.parallel.mesh`: a neighbour's rows
are a slice ``.to()`` the receiving device, and autograd carries their
gradient back).

A *level* is one activation of the network split along X: a list with one
(N, S_k, Y, Z, C) tensor per shard, shard k holding the contiguous rows
:func:`row_ranges` gives. Level 0 is ``shard_x``'s equal slabs; each pool
makes the next level's partition, :func:`level_rows` (balanced: the
extents 96 -> 49 -> 25 -> 13 of the flagship, and 12 -> 7 -> 4 -> 3 at
space 3, do not split evenly, and a deep level may leave a shard without
rows). Every op takes what it needs beyond its own rows through
:func:`gather_rows`, zero-filled (conv) or -inf-filled (pool) beyond the
volume's edges, and computes the single-device op's function on its rows:

* :func:`conv3d_spatial`: JAX's ``conv3d_spatial`` schedule: one plane from
  each neighbour, zero at the global edges, then cuDNN ``F.conv3d`` valid
  along X (padding (0, 1, 1)), as ``models/unet3d.py``'s ``conv3x3x3``
  runs it unsharded (a (skip, upsampled) pair too); the conv stays a
  library call, as the JAX package leaves it to XLA;
* :func:`max_pool_3d_spatial`: MaxPool3d(2, 2, padding 1), output row i
  reading input rows 2i - 1 and 2i; the window is the single-device
  window, so a tie goes to the first match, as there;
* :func:`upsample_transpose_spatial`: the transposed-conv decoder's
  upsampling, trimmed to the skip's extent;
* :func:`resize_trilinear_spatial`: the trilinear decoder's resize (X
  first, on the shard's rows of the X matrix);
* :func:`dropout_spatial`: the mask of the whole level drawn as the
  single-device forward draws it, each shard taking its rows.

GroupNorm over the shards is :func:`~unetsulc_tpu_torch.ops.groupnorm.
group_norm_sharded`. ``spatial_sharding`` of the JAX module has no
counterpart: its job (X over the space axis) is ``shard_x``'s.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from unetsulc_tpu_torch.ops.resize import _contract, interp_matrix

Ranges = List[Tuple[int, int]]


def level_rows(extent: int, n: int) -> Ranges:
    """Rows [lo, hi) of each of ``n`` shards over a level of ``extent``
    rows: contiguous, in shard order, sizes differing by at most one."""
    return [(k * extent // n, (k + 1) * extent // n) for k in range(n)]


def row_ranges(xs: Sequence[torch.Tensor]) -> Ranges:
    """The rows [lo, hi) that each shard of the level ``xs`` holds."""
    out, lo = [], 0
    for x in xs:
        hi = lo + int(x.shape[1])
        out.append((lo, hi))
        lo = hi
    return out


def gather_rows(xs: Sequence[torch.Tensor], lo: int, hi: int, device,
                fill: float) -> torch.Tensor:
    """Rows [lo, hi) of the level ``xs`` on ``device``, rows outside [0, X)
    set to ``fill``: each shard's part is sliced and copied to ``device``
    (a ppermute; autograd sends its gradient back)."""
    x0 = xs[0]
    parts = []
    if lo < 0:
        parts.append(torch.full((x0.shape[0], min(hi, 0) - lo,
                                 *x0.shape[2:]), fill, dtype=x0.dtype,
                                device=device))
    for x, (a, b) in zip(xs, row_ranges(xs)):
        s, e = max(lo, a), min(hi, b)
        if s < e:
            parts.append(x[:, s - a:e - a].to(device))
    total = sum(int(x.shape[1]) for x in xs)
    if hi > total:
        parts.append(torch.full((x0.shape[0], hi - max(lo, total),
                                 *x0.shape[2:]), fill, dtype=x0.dtype,
                                device=device))
    return parts[0] if len(parts) == 1 else torch.cat(parts, 1)


def conv3d_spatial(xs, weight: torch.Tensor, bias: torch.Tensor,
                   dtype: torch.dtype) -> List[torch.Tensor]:
    """3x3x3 same-padding conv of a level, or of a (skip, upsampled) pair
    of levels without their concat: ``xs`` one tensor or one pair per
    shard. Each shard takes one plane from each neighbour (zero at the
    volume's edges), convolves valid along X, sums the pair's convs in
    ``dtype`` on the weight's input slices, then adds the bias in
    ``dtype``, as ``models/unet3d.py``'s ``conv3x3x3``."""
    pairs = [list(x) if isinstance(x, (tuple, list)) else [x] for x in xs]
    levels = [[p[i] for p in pairs] for i in range(len(pairs[0]))]
    ref = levels[0][0]
    cout = int(weight.shape[0])
    outs = []
    for k, (lo, hi) in enumerate(row_ranges(levels[0])):
        dev = levels[0][k].device
        if lo == hi:
            outs.append(torch.empty((ref.shape[0], 0, *ref.shape[2:4], cout),
                                    dtype=dtype, device=dev))
            continue
        w = weight.to(dev, dtype)
        out, c0 = None, 0
        for level in levels:
            v = gather_rows(level, lo - 1, hi + 1, dev, 0.0).to(dtype)
            ci = int(v.shape[-1])
            y = F.conv3d(v.permute(0, 4, 1, 2, 3), w[:, c0:c0 + ci],
                         padding=(0, 1, 1))
            out = y if out is None else out + y
            c0 += ci
        outs.append(out.permute(0, 2, 3, 4, 1) + bias.to(dev, dtype))
    return outs


def max_pool_3d_spatial(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """MaxPool3d(2, 2, padding 1) of a level: extent d -> d // 2 + 1, split
    by :func:`level_rows`; shard k's output rows [lo, hi) read input rows
    [2 lo - 1, 2 hi), -inf beyond the edges (the pool's padding)."""
    d = sum(int(x.shape[1]) for x in xs)
    x0 = xs[0]
    outs = []
    for x, (lo, hi) in zip(xs, level_rows(d // 2 + 1, len(xs))):
        if lo == hi:
            outs.append(torch.empty(
                (x0.shape[0], 0, *(int(e) // 2 + 1 for e in x0.shape[2:4]),
                 x0.shape[-1]), dtype=x0.dtype, device=x.device))
            continue
        v = gather_rows(xs, 2 * lo - 1, 2 * hi, x.device, float("-inf"))
        outs.append(F.max_pool3d(v.permute(0, 4, 1, 2, 3), 2, 2,
                                 padding=(0, 1, 1)).permute(0, 2, 3, 4, 1))
    return outs


def upsample_transpose_spatial(xs: Sequence[torch.Tensor],
                               weight: torch.Tensor, bias: torch.Tensor,
                               dtype: torch.dtype, rows: Ranges,
                               devices, yz: Tuple[int, int]
                               ) -> List[torch.Tensor]:
    """ConvTranspose3d(k 3, stride 2, padding 1, output padding 1) of a
    level, kept at rows ``rows[k]`` of X and the leading ``yz`` of Y and Z
    on shard k (on ``devices[k]``): the skip's partition and extent
    (CONTRACTS.md §5 U2). Output row o takes input rows (o + 1 - t) / 2
    for taps t, so rows [lo, hi) need input rows [lo // 2, hi // 2 + 1),
    zero beyond the edge; the conv runs with padding 0 along X and the
    rows it makes are cut to [lo, hi)."""
    outs = []
    ty, tz = yz
    for (lo, hi), dev in zip(rows, devices):
        if lo == hi:
            outs.append(torch.empty((xs[0].shape[0], 0, ty, tz,
                                     weight.shape[1]), dtype=dtype,
                                    device=dev))
            continue
        a = lo // 2
        v = gather_rows(xs, a, hi // 2 + 1, dev, 0.0)
        y = F.conv_transpose3d(v.to(dtype).permute(0, 4, 1, 2, 3),
                               weight.to(dev, dtype), stride=2,
                               padding=(0, 1, 1), output_padding=(0, 1, 1))
        y = y.permute(0, 2, 3, 4, 1) + bias.to(dev, dtype)
        # local row j is global row j + 2a - 1
        outs.append(y[:, lo - 2 * a + 1:hi - 2 * a + 1, :ty, :tz])
    return outs


def resize_trilinear_spatial(xs: Sequence[torch.Tensor], rows: Ranges,
                             devices, target) -> List[torch.Tensor]:
    """``resize_trilinear`` of a level to ``target`` (X, Y, Z), kept at
    rows ``rows[k]`` on shard k (on ``devices[k]``): X first, with rows
    [lo, hi) of the X matrix and the input rows their weights reach, then
    Y and Z on the shard's rows alone, as the single-device resize."""
    d = sum(int(x.shape[1]) for x in xs)
    tx = int(target[0])
    m = interp_matrix(d, tx) if d != tx else None
    outs = []
    x0 = xs[0]
    for (lo, hi), dev in zip(rows, devices):
        if lo == hi:
            outs.append(torch.empty((x0.shape[0], 0, *map(int, target[1:]),
                                     x0.shape[-1]), dtype=x0.dtype,
                                    device=dev))
            continue
        if m is None:
            v = gather_rows(xs, lo, hi, dev, 0.0)
        else:
            cols = np.flatnonzero(m[lo:hi].any(0))
            a, b = int(cols[0]), int(cols[-1]) + 1
            v = gather_rows(xs, a, b, dev, 0.0)
            v = _contract(v, 1, torch.as_tensor(m[lo:hi, a:b]).to(
                device=dev, dtype=v.dtype))
        for axis in (2, 3):
            out_size = int(target[axis - 1])
            if v.shape[axis] != out_size:
                v = _contract(v, axis, torch.as_tensor(interp_matrix(
                    int(v.shape[axis]), out_size)).to(device=dev,
                                                       dtype=v.dtype))
        outs.append(v)
    return outs


def dropout_spatial(xs: Sequence[torch.Tensor], p: float,
                    generator: torch.Generator) -> List[torch.Tensor]:
    """``models.unet3d.dropout`` of a level: one uniform draw of the whole
    level's shape on the generator's device, as the single-device forward
    draws it, shard k keeping rows ``row_ranges(xs)[k]`` of the mask."""
    x0 = xs[0]
    shape = (x0.shape[0], sum(int(x.shape[1]) for x in xs), *x0.shape[2:])
    keep = torch.rand(shape, generator=generator,
                      device=generator.device) >= p
    return [torch.where(keep[:, lo:hi].to(x.device), x / (1.0 - p), 0)
            for x, (lo, hi) in zip(xs, row_ranges(xs))]
