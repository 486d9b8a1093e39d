"""Spatial-parallel plumbing of the fused pipeline, on lists of per-shard
tensors: the counterpart of ``unetsulc_tpu/parallel/sp_pallas.py``.

The volume's X axis is split over the mesh's ``space`` shards
(:mod:`unetsulc_tpu_torch.parallel.mesh`); shard k's padded buffer
(S+2, Y+2, Z+2, C) holds global planes [k*S, (k+1)*S) at positions 1..S.
Each function here takes and returns one tensor per shard, in slab order,
and does what ``sp_pallas.py`` does inside ``shard_map``, with the same
plane bookkeeping and the same -inf / zero rules; a neighbour's plane
reaches a shard by ``.to()`` its device (``ppermute``), a replicated result
is built on the first shard's device (the mesh's home) by ``torch.cat``
(``all_gather``).

The partition plan (``UNet3D.forward_sp``): level 0 runs on the local
slabs, its convs in the halo modes of kernels A, C and D, which take the
neighbours' boundary planes as two separate operands (:func:`ring_fill`),
so no (S+2)-plane copy of a slab is ever made. The pooled level 1 (and,
when the slab splits twice, level 2) runs sharded too, in the **slab+E
layout** (:func:`sp_mid_geom`): the pooled extent n*S/2 + 1 is odd, so
each shard holds its P = S/2 planes plus one E slot, the real trailing
plane on the last shard and a copy of the right neighbour's first plane
elsewhere, whose conv output the kernels drop (``valid_out``). Only the
deepest levels replicate, on gathered pooled-size volumes; each decoder
resizes them back to its shard's rows (:func:`sp_resize_to_slab`,
:func:`sp_resize_to_slab_mid`). GroupNorm statistics stay global: the
shards' stat sums are added before the affine forms. Sums are taken in
the single-device path's order where the two could differ (the resizes'
axis order, the pools' tie rule), so that a step on shards follows the
single-device step's trajectory, not just its first step.

The sp pools and resizes are plain PyTorch, as the JAX package leaves them
to XLA (``reduce_window``, ``tensordot``): no TPU kernel runs there.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from unetsulc_tpu_torch.ops import conv_fused as cf
from unetsulc_tpu_torch.ops.resize import _contract, _interp_matrix_on

Bufs = List[torch.Tensor]
Halo = Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]


@functools.lru_cache(maxsize=None)
def plane_flags(flags: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """A (len(flags),) f32 plane-validity vector on ``device``, built and
    uploaded once per (flags, device); callers only read it."""
    return torch.tensor(flags, dtype=torch.float32).to(device)


def ring_fill(bufs: Bufs) -> Tuple[List[Halo], List[torch.Tensor]]:
    """The halo of each shard's (S+2, Yp, Zp, C) buffer: (halos, valids)
    with halos[k] = (lo, hi), lo the left neighbour's last interior plane
    S and hi the right neighbour's first plane 1, each (Yp, Zp, C) on
    shard k's device and None at the global volume's edges, where the zero
    ring is the conv's padding; valids[k] the (S+2,) plane validity (ring
    planes 0 at those edges). ``sp_pallas.ring_fill`` concatenates the
    same planes into a copy of the buffer; here they stay where they are,
    for the kernels' halo operands."""
    n, s = len(bufs), int(bufs[0].shape[0]) - 2
    halos, valids = [], []
    for k, b in enumerate(bufs):
        lo = bufs[k - 1][s].to(b.device) if k > 0 else None
        hi = bufs[k + 1][1].to(b.device) if k < n - 1 else None
        halos.append((lo, hi))
        valids.append(plane_flags((int(k > 0),) + (1,) * s + (int(k < n - 1),),
                                  b.device))
    return halos, valids


def ring_planes_5d(x5s: Bufs) -> Bufs:
    """(1, S, Y, Z, C) input slabs -> (1, S+2, Y, Z, C) with the
    neighbours' boundary planes first and last (zeros at the global volume
    edges): the input of the dense entry conv's ``ring`` mode."""
    n, out = len(x5s), []
    for k, x in enumerate(x5s):
        zero = x.new_zeros(x[:, :1].shape)
        lo = x5s[k - 1][:, -1:].to(x.device) if k > 0 else zero
        hi = x5s[k + 1][:, :1].to(x.device) if k < n - 1 else zero
        out.append(torch.cat([lo, x, hi], 1))
    return out


def _pool_values(buf: torch.Tensor, aff, g: cf.Geom) -> torch.Tensor:
    """bf16(f32(x) * a + b) in the buffer's dtype, -inf off the (y, z)
    interior: the values the torch-padded max pool reads, as
    ``max_pool_buf`` normalizes them."""
    yz = torch.zeros((g.Yp, g.Zp, 1), dtype=torch.bool, device=buf.device)
    yz[1:1 + g.Y, 1:1 + g.Z] = True
    return torch.where(yz, cf.apply_affine(buf, aff), float("-inf"))


def _pool_xyz(planes: torch.Tensor, gy: int, gz: int) -> torch.Tensor:
    """2x2x2 / stride-2 max over (2j, 2j+1) of each axis of (X, Yp, Zp, C)
    planes, cut to (X/2, gy, gz, C)."""
    p = F.max_pool3d(planes.permute(3, 0, 1, 2)[None], 2, 2)[0]
    return p.permute(1, 2, 3, 0)[:, :gy, :gz]


def _pool_yz(plane: torch.Tensor, gy: int, gz: int) -> torch.Tensor:
    """2x2 / stride-2 max of one (Yp, Zp, C) plane, cut to (gy, gz, C)."""
    p = F.max_pool2d(plane.permute(2, 0, 1)[None], 2, 2)[0]
    return p.permute(1, 2, 0)[:gy, :gz]


def _pooled_owned(owned: Bufs, gy: int, gz: int) -> Bufs:
    """Each shard's pooled planes: torch pools input pairs (2j-1, 2j) with
    -inf padding, so a shard's first pair takes its left neighbour's last
    owned plane (-inf on shard 0, where it is the global pool padding)."""
    out = []
    for k, o in enumerate(owned):
        left = (owned[k - 1][-1:].to(o.device) if k > 0
                else torch.full_like(o[:1], float("-inf")))
        out.append(_pool_xyz(torch.cat([left, o]), gy, gz))
    return out


def _ring(interior: torch.Tensor) -> torch.Tensor:
    """(X, Y, Z, C) -> the (X+2, Y+2, Z+2, C) buffer with a zero ring."""
    return F.pad(interior, (0, 0, 1, 1, 1, 1, 1, 1))


def sp_pool_gather(bufs: Bufs, affs, g: cf.Geom):
    """Sharded torch-padded max pool of the level-0 slabs (pending affines
    ``affs``, one per shard), then the POOLED volume gathered on the home
    device: (replicated buffer of the pooled geometry gg, gg), gX = n*S/2
    + 1 (``sp_pallas.sp_pool_gather``; the layout without a sharded
    middle). Shard k owns output planes [k*S/2, (k+1)*S/2); the trailing
    plane gX-1, the YZ pool of global plane X-1, comes from the last
    shard. Equal to the single-device pool: max commutes with the split."""
    n, s = len(bufs), g.X
    if s % 2:
        raise ValueError(f"sharded pooling needs even slabs, got S={s}")
    gg = cf.pool_geom(cf.make_geom(n * s, g.Y, g.Z))
    owned = [_pool_values(b, a, g)[1:s + 1] for b, a in zip(bufs, affs)]
    pooled = _pooled_owned(owned, gg.Y, gg.Z)
    home = bufs[0].device
    last = _pool_yz(owned[-1][-1], gg.Y, gg.Z)
    interior = torch.cat([p.to(home) for p in pooled] + [last.to(home)[None]])
    return _ring(interior), gg


def sp_mid_geom(g: cf.Geom, n: int) -> cf.Geom:
    """Local slab+E geometry of the sharded POOLED level over ``n`` shards
    of level-0 slabs ``g``: X = P+1 (P = S/2 owned planes and the E slot),
    Xp = P+3 (odd when P is even, which the halo kernels take), and the
    global pooled level's Y and Z (``sp_pallas.sp_mid_geom``)."""
    s = g.X
    if s % 2:
        raise ValueError(f"mid sharding needs even level-0 slabs, got S={s}")
    gg = cf.pool_geom(cf.make_geom(n * s, g.Y, g.Z))
    return cf.make_geom(s // 2 + 1, gg.Y, gg.Z)


def sp_pool_local(bufs: Bufs, affs, g: cf.Geom):
    """Sharded torch-padded max pool of the level-0 slabs into the LOCAL
    slab+E layout: ((P+3, gYp, gZp, C) buffer per shard, mid geom), P =
    S/2 (``sp_pallas.sp_pool_local``). Positions 1..P hold the shard's
    pooled planes; E (position P+1) holds the global trailing plane on the
    last shard and zeros elsewhere (the next conv's :func:`ring_fill_mid`
    fills the copy); rings are zero. Gathering the slabs gives
    :func:`sp_pool_gather`'s volume."""
    n, s = len(bufs), g.X
    gm = sp_mid_geom(g, n)
    owned = [_pool_values(b, a, g)[1:s + 1] for b, a in zip(bufs, affs)]
    out = []
    for k, (o, p) in enumerate(zip(owned, _pooled_owned(owned, gm.Y, gm.Z))):
        e = (_pool_yz(o[-1], gm.Y, gm.Z) if k == n - 1
             else p.new_zeros(p.shape[1:]))
        out.append(_ring(torch.cat([p, e[None]])))
    return out, gm


def sp_pool_local_mid(bufs: Bufs, affs, g_mid: cf.Geom):
    """Torch-padded max pool from one slab+E layout into the next (level 1
    -> 2, ``sp_pallas.sp_pool_local_mid``): with gX1 = n*P1 + 1, the
    pooled extent gX2 = n*P2 + 1 for P2 = P1/2, so shard k owns level-2
    planes [k*P2, (k+1)*P2) plus an E slot. Its pairs use the left
    neighbour's last owned plane (-inf on shard 0) and its own owned
    planes, never the unowned E; the trailing plane T2 = max(gX1-2, gX1-1)
    lies on the last shard (its last owned plane and its real E),
    YZ-pooled into its E slot. Returns (buffers, mid2 geom)."""
    n, p1 = len(bufs), g_mid.X - 1
    if p1 % 2:
        raise ValueError(f"deep sharding needs an even P1, got {p1}")
    gg2 = cf.pool_geom(cf.make_geom(n * p1 + 1, g_mid.Y, g_mid.Z))
    gm2 = cf.make_geom(p1 // 2 + 1, gg2.Y, gg2.Z)
    vals = [_pool_values(b, a, g_mid) for b, a in zip(bufs, affs)]
    owned = [v[1:p1 + 1] for v in vals]
    out = []
    for k, (v, p) in enumerate(zip(vals, _pooled_owned(owned, gm2.Y, gm2.Z))):
        if k == n - 1:
            # one 2x2x2 window over the two planes, not an elementwise
            # maximum: a tie's gradient goes to the first position, as the
            # single-device pool sends it
            e = _pool_xyz(v[p1:p1 + 2], gm2.Y, gm2.Z)[0]
        else:
            e = p.new_zeros(p.shape[1:])
        out.append(_ring(torch.cat([p, e[None]])))
    return out, gm2


def ring_fill_mid(bufs: Bufs):
    """Ring and E-plane exchange of the slab+E layout
    (``sp_pallas.ring_fill_mid``). ``bufs``: (P+3, Yp, Zp, C) per shard
    (0 = left ring, 1..P = owned, P+1 = E, P+2 = right ring). Returns
    (filled, halos, valid_ins, valid_outs) per shard:

    * halo lo: the left neighbour's plane P (its last owned plane);
    * E: the right neighbour's plane 1 (a copy of the buffer with that one
      plane in place: ``filled``); the last shard keeps its own E, the
      real trailing plane, and its buffer as it is;
    * halo hi: the right neighbour's plane 2, so E's own output is exact
      on the last shard and dropped elsewhere;
    * valid_in: rings 0 at the global volume's edges, E always 1;
    * valid_out: positions 1..P, and E on the last shard only, so each
      global plane is written and counted by exactly one shard."""
    n, p = len(bufs), int(bufs[0].shape[0]) - 3
    filled, halos, vin, vout = [], [], [], []
    for k, b in enumerate(bufs):
        lo = bufs[k - 1][p].to(b.device) if k > 0 else None
        if k < n - 1:
            right = bufs[k + 1][1:3].to(b.device)
            filled.append(torch.cat([b[:p + 1], right[:1], b[p + 2:]]))
            hi = right[1]
        else:
            filled.append(b)
            hi = None
        halos.append((lo, hi))
        vin.append(plane_flags((int(k > 0),) + (1,) * (p + 1)
                               + (int(k < n - 1),), b.device))
        vout.append(plane_flags((0,) + (1,) * p + (int(k == n - 1), 0),
                                b.device))
    return filled, halos, vin, vout


def sp_mid_gather(bufs: Bufs, g_mid: cf.Geom):
    """The slab+E buffers gathered into the replicated pooled volume on the
    home device: ((gXp, Yp, Zp, C) buffer, its geometry), gX = n*P + 1
    (``sp_pallas.sp_mid_gather``). The owned planes of every shard, then
    the last shard's E, the global trailing plane (E is 0 elsewhere)."""
    n, p = len(bufs), g_mid.X - 1
    gg = cf.make_geom(n * p + 1, g_mid.Y, g_mid.Z)
    home = bufs[0].device
    interior = torch.cat([b[1:p + 1].to(home) for b in bufs]
                         + [bufs[-1][p + 1:p + 2].to(home)])
    return F.pad(interior, (0, 0, 0, 0, 0, 0, 1, 1)), gg


def _resize_yz(buf: torch.Tensor, g_in: cf.Geom, g_out: cf.Geom) -> torch.Tensor:
    """The Z, then Y contractions of ``resize_trilinear_buf`` from ``g_in``
    to ``g_out``'s (Y, Z), on the padded buffer."""
    for axis, i_in, i_out in ((2, g_in.Z, g_out.Z), (1, g_in.Y, g_out.Y)):
        if i_in != i_out:
            buf = _contract(buf, axis, _interp_matrix_on(
                i_in, i_out, True, buf.device, buf.dtype))
    return buf


def _resize_x_rows(buf: torch.Tensor, x_in: int, gx: int, start: int,
                   stop: int, device) -> torch.Tensor:
    """Interior rows [start, stop) of the X contraction to extent ``gx``,
    on ``device``, as the shard's buffer with its X ring."""
    buf = buf.to(device)
    m = _interp_matrix_on(x_in, gx, True, device, buf.dtype)[1 + start:1 + stop]
    return F.pad(_contract(buf, 0, m), (0, 0, 0, 0, 0, 0, 1, 1))


def sp_resize_to_slab_mid(buf: torch.Tensor, g_in: cf.Geom, g_mid: cf.Geom,
                          devices: Sequence[torch.device]) -> Bufs:
    """The replicated buffer ``buf`` (geometry ``g_in``) trilinearly
    resized to each shard's slab+E rows of the pooled level: one (P+3, gYp,
    gZp, C) buffer per shard holding rows [k*P, k*P + P] of the gX = n*P +
    1 output; row (k+1)*P is the right neighbour's first plane, and on the
    last shard the real trailing plane (``sp_pallas.sp_resize_to_slab_mid``).
    Z and Y are contracted once on ``buf``'s device and each shard takes
    its rows of the X contraction: the order and matrices of the
    single-device ``resize_trilinear_buf`` (``sp_pallas`` contracts X
    first), so the two paths add the same products."""
    n, p = len(devices), g_mid.X - 1
    yz = _resize_yz(buf, g_in, g_mid)
    return [_resize_x_rows(yz, g_in.X, n * p + 1, k * p, k * p + p + 1, d)
            for k, d in enumerate(devices)]


def sp_resize_to_slab(buf: torch.Tensor, g_in: cf.Geom, g_loc: cf.Geom,
                      devices: Sequence[torch.device]) -> Bufs:
    """The replicated buffer ``buf`` (geometry ``g_in``) trilinearly
    resized to each shard's (S+2, Yp, Zp, C) slab buffer of the
    full-resolution level: rows [k*S, (k+1)*S) of the X contraction
    (``sp_pallas.sp_resize_to_slab``), in :func:`sp_resize_to_slab_mid`'s
    order."""
    n, s = len(devices), g_loc.X
    yz = _resize_yz(buf, g_in, g_loc)
    return [_resize_x_rows(yz, g_in.X, n * s, k * s, (k + 1) * s, d)
            for k, d in enumerate(devices)]


def sp_static_shapes_ok(n: int) -> bool:
    """True iff every volume extent the data layer can produce (X a
    multiple of 16, at least 32) splits into valid slabs over ``n``
    shards: X % n == 0, S = X/n even and S >= 4, which leaves exactly n in
    {2, 4, 8} (``sp_pallas.sp_static_shapes_ok``)."""
    return n in (2, 4, 8)
