"""The port's spatial-parallel plumbing against the JAX package's, on the
CPU (f32): every function of ``parallel/sp_fused.py`` against its twin in
``unetsulc_tpu/parallel/sp_pallas.py`` under ``shard_map`` on the
8-device CPU mesh of ``tests/conftest.py``, at 2 and 4 shards. Copies and
pools are bit-equal; the resizes rtol 1e-6 (the port contracts Z, Y, X as
the single-device resize does, ``sp_pallas`` X, Y, Z). The port's shards
are CPU tensors of one device, in one process (``parallel.mesh``); each
JAX buffer is converted to the port's layout
(``tests/torch_sp_layout.py``) before it is compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

import unetsulc_tpu.ops.conv_pallas as cp
from torch_sp_layout import Y, Z, as_torch, from_jax, jax_affine, jax_geom, to_jax
from unetsulc_tpu.parallel import sp_pallas as jsp
from unetsulc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from unetsulc_tpu_torch.ops import conv_fused as cf
from unetsulc_tpu_torch.parallel import sp_fused as sp


# ---------------------------------------------------------------------------
# (2) the sp plumbing against its JAX twins under shard_map
# ---------------------------------------------------------------------------

C = 8
S = 8  # level-0 slab planes: P1 = 4 and P2 = 2 pooled planes per shard


def _smap(fn, n, in_specs, out_specs):
    mesh = jax_make_mesh(data=1, space=n)
    f = jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs,
                          out_specs=out_specs, check_rep=False))

    def call(*args):
        with mesh:
            return f(*args)
    return call


def _volume(n, seed, c=C):
    """A (1, n*S, Y, Z, c) volume of post-ReLU-like values (exact zeros,
    so pools see ties) and its port slabs as level-0 buffers."""
    r = np.random.default_rng(seed)
    x5 = np.maximum(r.standard_normal((1, n * S, Y, Z, c)), 0).astype(np.float32)
    g = cf.make_geom(S, Y, Z)
    bufs = [cf.pad_to_geom(as_torch(x5[:, k * S:(k + 1) * S]), g) for k in range(n)]
    return x5, bufs, g


def _pool_affine(r, c):
    """A pending affine for the pool twins: a in powers of two, so that
    a * x is exact and XLA's fused multiply-add rounds as the port's
    multiply-then-add does (kernel B's rounding), keeping the comparison
    bit-exact."""
    return as_torch(np.stack([2.0 ** r.integers(-1, 2, c),
                        r.standard_normal(c) * 0.1]).astype(np.float32))


def _split(a, n, axis):
    return np.split(np.asarray(a), n, axis=axis)


@pytest.mark.parametrize("n", [2, 4])
def test_ring_fill_matches_jax(n):
    """ring_fill's halo planes, as the filled buffer JAX concatenates, and
    its valid vectors: bit-equal."""
    x5, bufs, g = _volume(n, 1)
    gj = jax_geom(S)

    def body(local5):
        return jsp.ring_fill(cp.pad_to_geom(local5, gj), "space")

    jf, jv = _smap(body, n, P(None, "space"), (P(None, "space"), P("space")))(
        jnp.asarray(x5))
    halos, valids = sp.ring_fill(bufs)
    for k, (jb, v) in enumerate(zip(_split(jf, n, 1), _split(jv, n, 0))):
        np.testing.assert_array_equal(cf.halo_filled(bufs[k], halos[k]).numpy(),
                                      from_jax(jb, gj))
        np.testing.assert_array_equal(valids[k].numpy(), v)
    assert halos[0][0] is None and halos[-1][1] is None


@pytest.mark.parametrize("n", [2, 4])
def test_ring_planes_5d_matches_jax(n):
    x5, _, _ = _volume(n, 2, c=1)
    j = _smap(lambda v: jsp.ring_planes_5d(v, "space"), n, P(None, "space"),
              P(None, "space"))(jnp.asarray(x5))
    got = sp.ring_planes_5d([as_torch(s) for s in _split(x5, n, 1)])
    for g_, w in zip(got, _split(j, n, 1)):
        np.testing.assert_array_equal(g_.numpy(), w)


@pytest.mark.parametrize("n", [2, 4])
def test_sp_pool_gather_matches_jax(n):
    """The sharded pool gathered on the home device (with a pending
    affine), bit-equal to JAX's replicated result and to the port's
    single-device pool of the whole volume."""
    x5, bufs, g = _volume(n, 3)
    aff = _pool_affine(np.random.default_rng(3), C)
    gj = jax_geom(S)

    def body(local5):
        return jsp.sp_pool_gather(cp.pad_to_geom(local5, gj), jax_affine(aff), gj,
                                  "space")[0]

    j = _smap(body, n, P(None, "space"), P())(jnp.asarray(x5))
    buf, gg = sp.sp_pool_gather(bufs, [aff] * n, g)
    np.testing.assert_array_equal(
        buf.numpy(), from_jax(j, cp.pool_geom(cp.make_geom(n * S, Y, Z))))
    gfull = cf.make_geom(n * S, Y, Z)
    np.testing.assert_array_equal(
        buf.numpy(),
        cf.max_pool_buf_plain(cf.pad_to_geom(as_torch(x5), gfull), aff, gfull).numpy())
    assert gg == cf.pool_geom(gfull)


def _jax_mid_geom(n, g):
    """JAX's sp_mid_geom, read while shard_map traces its body."""
    seen = []

    def body(v):
        seen.append(jsp.sp_mid_geom(g, "space"))
        return v

    _smap(body, n, P(None, "space"), P(None, "space"))(jnp.zeros((1, n)))
    return seen[0]


@pytest.mark.parametrize("n", [2, 4])
def test_sp_mid_geom_matches_jax(n):
    for s in (4, 8, 16):
        gm = sp.sp_mid_geom(cf.make_geom(s, Y, Z), n)
        jm = _jax_mid_geom(n, cp.make_geom(s, Y, Z))
        assert (gm.X, gm.Y, gm.Z, gm.Xp) == (jm.X, jm.Y, jm.Z, jm.Xp)


@pytest.mark.parametrize("n", [2, 4])
def test_sp_pool_local_and_local_mid_match_jax(n):
    """Level 0 -> slab+E (sp_pool_local, with a pending affine) -> the next
    slab+E layout (sp_pool_local_mid, with another): each shard's buffer
    bit-equal to JAX's, and the gathered level-2 volume bit-equal to the
    port's two single-device pools."""
    x5, bufs, g = _volume(n, 5)
    r = np.random.default_rng(5)
    aff0, aff1 = _pool_affine(r, C), _pool_affine(r, C)
    gj = jax_geom(S)

    def body(local5):
        mid, gm = jsp.sp_pool_local(cp.pad_to_geom(local5, gj), jax_affine(aff0),
                                    gj, "space")
        mid2, _ = jsp.sp_pool_local_mid(mid, jax_affine(aff1), gm, "space")
        return mid, mid2

    jm, jm2 = _smap(body, n, P(None, "space"),
                    (P(None, "space"), P(None, "space")))(jnp.asarray(x5))
    mids, gm = sp.sp_pool_local(bufs, [aff0] * n, g)
    mids2, gm2 = sp.sp_pool_local_mid(mids, [aff1] * n, gm)
    gjm = _jax_mid_geom(n, gj)
    pad = cp.make_geom(1, gm2.Y, gm2.Z)
    gjm2 = cp.Geom(gm2.X, gm2.Y, gm2.Z, gm2.Xp, pad.Yp, pad.Zp)
    for k in range(n):
        np.testing.assert_array_equal(mids[k].numpy(),
                                      from_jax(_split(jm, n, 1)[k], gjm))
        np.testing.assert_array_equal(mids2[k].numpy(),
                                      from_jax(_split(jm2, n, 1)[k], gjm2))
    gfull = cf.make_geom(n * S, Y, Z)
    p1 = cf.max_pool_buf_plain(cf.pad_to_geom(as_torch(x5), gfull), aff0, gfull)
    p2 = cf.max_pool_buf_plain(p1, aff1, cf.pool_geom(gfull))
    full, _ = sp.sp_mid_gather(mids2, gm2)
    np.testing.assert_array_equal(full.numpy(), p2.numpy())


def _mid_buffers(n, seed, gm):
    """Random slab+E buffers: zero rings, E zero except on the last shard
    (as a conv's valid_out leaves it)."""
    r = np.random.default_rng(seed)
    out = []
    for k in range(n):
        b = np.zeros((gm.Xp, gm.Yp, gm.Zp, C), np.float32)
        b[1:gm.X + 1, 1:-1, 1:-1] = r.standard_normal((gm.X, gm.Y, gm.Z, C))
        if k < n - 1:
            b[gm.X] = 0
        out.append(as_torch(b))
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_ring_fill_mid_matches_jax(n):
    """The E copy, both halo planes and the valid_in / valid_out vectors
    of the slab+E exchange: bit-equal."""
    gm = sp.sp_mid_geom(cf.make_geom(S, Y, Z), n)
    gjm = _jax_mid_geom(n, jax_geom(S))
    bufs = _mid_buffers(n, 6, gm)
    jin = jnp.concatenate([to_jax(b, gjm) for b in bufs], axis=1)
    jf, jvi, jvo = _smap(lambda b: jsp.ring_fill_mid(b, "space"), n,
                         P(None, "space"),
                         (P(None, "space"), P("space"), P("space")))(jin)
    filled, halos, vin, vout = sp.ring_fill_mid(bufs)
    for k in range(n):
        np.testing.assert_array_equal(
            cf.halo_filled(filled[k], halos[k]).numpy(),
            from_jax(_split(jf, n, 1)[k], gjm))
        np.testing.assert_array_equal(vin[k].numpy(), _split(jvi, n, 0)[k])
        np.testing.assert_array_equal(vout[k].numpy(), _split(jvo, n, 0)[k])


@pytest.mark.parametrize("n", [2, 4])
def test_sp_mid_gather_matches_jax(n):
    gm = sp.sp_mid_geom(cf.make_geom(S, Y, Z), n)
    gjm = _jax_mid_geom(n, jax_geom(S))
    bufs = _mid_buffers(n, 7, gm)
    jin = jnp.concatenate([to_jax(b, gjm) for b in bufs], axis=1)
    j = _smap(lambda b: jsp.sp_mid_gather(b, gjm, "space")[0], n,
              P(None, "space"), P())(jin)
    full, gg = sp.sp_mid_gather(bufs, gm)
    np.testing.assert_array_equal(full.numpy(),
                                  from_jax(j, cp.make_geom(gg.X, gg.Y, gg.Z)))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mid", [False, True], ids=["slab", "slab_e"])
def test_sp_resizes_match_jax(n, mid):
    """sp_resize_to_slab (to level-0 slabs) and sp_resize_to_slab_mid (to
    slab+E rows) from a replicated deeper volume: each shard's interior
    rtol 1e-6 against JAX's (positive values, so the bar is relative to
    magnitudes away from 0), and its ring exactly 0."""
    r = np.random.default_rng(8 + mid)
    if mid:
        g_out = sp.sp_mid_geom(cf.make_geom(S, Y, Z), n)
        jg = _jax_mid_geom(n, jax_geom(S))
        rows = g_out.X  # P + 1 per shard
    else:
        g_out = cf.make_geom(S, Y, Z)
        jg = jax_geom(S)
        rows = S
    src = (3, 4, 4)  # the replicated deeper volume's extent
    x5 = (r.random((1, *src, C)) + 0.5).astype(np.float32)
    fn = jsp.sp_resize_to_slab_mid if mid else jsp.sp_resize_to_slab
    j = _smap(lambda v: fn(v, jg, "space"), n, P(), P(None, "space"))(
        jnp.asarray(x5))
    resize = sp.sp_resize_to_slab_mid if mid else sp.sp_resize_to_slab
    got = resize(cf.pad_to_geom(as_torch(x5), cf.make_geom(*src)), cf.make_geom(*src),
                 g_out, [torch.device("cpu")] * n)
    for k, (b, w) in enumerate(zip(got, _split(j, n, 1))):
        assert tuple(b.shape) == (rows + 2, g_out.Yp, g_out.Zp, C)
        np.testing.assert_allclose(cf.unpad_from_geom(b, g_out).numpy(), w,
                                   rtol=1e-6, atol=0)
        inner = torch.zeros(b.shape[:3], dtype=torch.bool)
        inner[1:-1, 1:-1, 1:-1] = True
        assert not b[~inner].any()
