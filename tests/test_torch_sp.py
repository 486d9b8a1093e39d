"""The halo modes of kernels A, C and D on the CPU (f32): their plain
versions (``ops/conv_fused.py``) against JAX ``conv_shards`` /
``conv_wgrad_shards`` / ``fused_conv_block(halo=True)`` in Pallas
interpret mode, as ``tests/test_pallas.py`` runs them, on one shard's
slab (4 planes, or the slab+E layout's 5 with an odd Xp of 7; Y = Z = 6;
8 and 16 channels). The JAX side reads the slab with its neighbour planes
concatenated into the ring planes; the port passes them as separate
operands. Tolerances are test_pallas.py's: y rtol=atol=1e-4, sums rtol
1e-3 atol 1e-2, gradients rtol=atol=1e-3 (f32 sums over a few hundred
voxels x 27 taps, taken in another order). Buffers differ in layout, so
each JAX buffer is converted (``tests/torch_sp_layout.py``) before it is
compared. The sp plumbing's tests are in ``test_torch_sp_plumbing.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unetsulc_tpu.ops.conv_pallas as cp
from torch_sp_layout import Y, Z, as_torch, from_jax, jax_affine, jax_geom, to_jax
from unetsulc_tpu_torch.ops import conv_fused as cf


# ---------------------------------------------------------------------------
# (1) the halo modes of kernels A, C and D
# ---------------------------------------------------------------------------

# (slab planes X, forced Xp, valid_in, valid_out): a left-edge shard, an
# interior shard, and the slab+E layout on its last and an inner shard
HALO_CASES = {
    "edge": (4, None, [0, 1, 1, 1, 1, 1], None),
    "interior": (4, None, [1, 1, 1, 1, 1, 1], None),
    "mid_last": (5, 7, [1, 1, 1, 1, 1, 1, 0], [0, 1, 1, 1, 1, 1, 0]),
    "mid_inner": (5, 7, [1, 1, 1, 1, 1, 1, 1], [0, 1, 1, 1, 1, 0, 0]),
}


def _halo_inputs(r, x, c):
    """A post-ReLU-like slab buffer with zero ring planes and its two
    neighbour planes, each (Y+2, Z+2, c) with a zero (y, z) ring."""
    g = cf.make_geom(x, Y, Z)
    buf = cf.pad_to_geom(as_torch(np.maximum(r.standard_normal((1, x, Y, Z, c)), 0)
                            .astype(np.float32)), g)
    planes = [torch.nn.functional.pad(
        as_torch(np.maximum(r.standard_normal((Y, Z, c)), 0).astype(np.float32)),
        (0, 0, 1, 1, 1, 1)) for _ in range(2)]
    return buf, planes


def _affine(r, c):
    return as_torch(np.stack([r.standard_normal(c) * 0.5 + 1,
                        r.standard_normal(c) * 0.1]).astype(np.float32))


def _jax_block(xs, affs, k5, bias, valids, valid_out, gj):
    """JAX ``fused_conv_block(halo=True)`` on JAX-layout filled buffers,
    with SplitConv3's second-input dummies for one input."""
    cins = [int(x.shape[0]) * int(x.shape[-1]) for x in xs]
    ws = list(cp.shard_weights(k5, cins, int(k5.shape[-1])))
    xs, affs, valids = list(xs), list(affs), list(valids)
    if len(cins) == 1:
        xs.append(jnp.zeros((1, 2, 16, 8), jnp.float32))
        affs.append(jnp.zeros((1, 2, 8), jnp.float32))
        ws.append(jnp.zeros((1, 1, 27, 8, 8), jnp.float32))
        valids.append(jnp.ones((2,), jnp.float32))
    return cp.fused_conv_block(xs[0], xs[1], affs[0], affs[1], ws[0], ws[1],
                               bias, valids[0], valids[1], valid_out,
                               len(cins), gj, True, True)


@pytest.mark.parametrize("case,cins,cout", [
    ("edge", [8], 16), ("interior", [8, 16], 8), ("mid_last", [16], 8),
    ("mid_inner", [8, 16], 16)])
def test_halo_block_forward_and_vjp_match_jax(case, cins, cout):
    """Kernel A's halo mode (valid_in, valid_out, one launch for the
    decoder's two inputs) and the halo backward of the fused block (kernel
    C's edge_outputs mode and kernel D's halo mode): y and sums, then
    ``jax.vjp`` of ``fused_conv_block(halo=True)`` — dx of the slab and of
    both neighbour planes (the ring planes of JAX's filled buffer),
    d(affine) over the valid planes, dW and dbias (_fused_bwd :1405-1425).
    Edge shards pass None for the invalid plane; its JAX gradient is 0."""
    x, xp, vin, vout = HALO_CASES[case]
    r = np.random.default_rng(sum(map(ord, case)) + sum(cins))
    g, gj = cf.make_geom(x, Y, Z), jax_geom(x, xp)
    ins = [_halo_inputs(r, x, c) for c in cins]
    halos = [(None if vin[0] == 0 else lo, None if vin[-1] == 0 else hi)
             for _, (lo, hi) in ins]
    affs = [_affine(r, c) for c in cins]
    k5 = (r.standard_normal((3, 3, 3, sum(cins), cout)) * 0.2).astype(np.float32)
    bias = (r.standard_normal(cout) * 0.1).astype(np.float32)
    gy = r.standard_normal((x + 2, Y + 2, Z + 2, cout)).astype(np.float32)
    gs = (r.standard_normal((2, cout)) * 0.01).astype(np.float32)
    valid = as_torch(np.asarray(vin, np.float32))
    valid_o = None if vout is None else as_torch(np.asarray(vout, np.float32))

    filled = [cf.halo_filled(b, h) for (b, _), h in zip(ins, halos)]
    jx = [to_jax(f, gj) for f in filled]
    ja = [jax_affine(a) for a in affs]
    jv = jnp.asarray(vin, jnp.float32)
    jvo = None if vout is None else jnp.asarray(vout, jnp.float32)

    def jfn(xs, aff_list, k, b):
        y, s = _jax_block(xs, aff_list, k, b, [jv] * len(cins), jvo, gj)
        return y, s.swapaxes(0, 1).reshape(2, -1)

    (jy, js), vjp = jax.vjp(jfn, jx, ja, jnp.asarray(k5), jnp.asarray(bias))
    jgx, jga, jgk, jgb = vjp((to_jax(gy, jax_geom(x, xp)).astype(jnp.float32)
                              .reshape(jy.shape), jnp.asarray(gs)))

    xs = [b.clone().requires_grad_() for b, _ in ins]
    hs = [tuple(None if t is None else t.clone().requires_grad_() for t in h)
          for h in halos]
    ta = [a.clone().requires_grad_() for a in affs]
    w = as_torch(k5).permute(4, 3, 0, 1, 2).contiguous().requires_grad_()
    tb = as_torch(bias).requires_grad_()
    y, s = cf.fused_conv_block(xs, ta, w, tb, g, halos=hs,
                               valids=[valid] * len(cins), valid_out=valid_o)
    ((y * as_torch(gy)).sum() + (s * as_torch(gs)).sum()).backward()

    inner = (slice(1, x + 1), slice(1, Y + 1), slice(1, Z + 1))
    np.testing.assert_allclose(y.detach().numpy()[inner],
                               from_jax(jy, gj)[inner], rtol=1e-4, atol=1e-4)
    assert bool((y.detach()[0] == 0).all() and (y.detach()[-1] == 0).all())
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(js), rtol=1e-3,
                               atol=1e-2)
    tol = dict(rtol=1e-3, atol=1e-3)
    for i, c in enumerate(cins):
        jd = from_jax(jgx[i], gj)
        np.testing.assert_allclose(xs[i].grad.numpy()[inner], jd[inner], **tol)
        for t, plane in zip(hs[i], (jd[0], jd[-1])):
            if t is None:
                assert not np.any(plane)
            else:
                np.testing.assert_allclose(t.grad.numpy(), plane, **tol)
        np.testing.assert_allclose(
            ta[i].grad.numpy(),
            np.asarray(jga[i]).transpose(1, 0, 2).reshape(2, c), **tol)
    np.testing.assert_allclose(w.grad.permute(2, 3, 4, 1, 0).numpy(),
                               np.asarray(jgk), **tol)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jgb), **tol)


@pytest.mark.parametrize("case", ["edge", "mid_last", "mid_inner"])
def test_dx_edge_outputs_and_wgrad_halo_match_jax(case):
    """Kernel C's edge_outputs mode and kernel D's halo mode, each against
    its JAX kernel call: dxn at every plane, the ring planes included, from
    ``conv_shards(edge_outputs=True)``, with dx = dxn * a zeroed on invalid
    planes and the d(affine) sums over the valid rows formed as _fused_bwd
    forms them; dW from ``conv_wgrad_shards(halo=True, valid_in=...)``."""
    x, xp, vin, _ = HALO_CASES[case]
    cin, cout = 16, 8
    r = np.random.default_rng(11)
    g, gj = cf.make_geom(x, Y, Z), jax_geom(x, xp)
    buf, (lo, hi) = _halo_inputs(r, x, cin)
    halo = (None if vin[0] == 0 else lo, None if vin[-1] == 0 else hi)
    aff = _affine(r, cin)
    k5 = (r.standard_normal((3, 3, 3, cin, cout)) * 0.2).astype(np.float32)
    w = as_torch(k5).permute(4, 3, 0, 1, 2).contiguous()
    dconv = cf.pad_to_geom(as_torch(r.standard_normal((1, x, Y, Z, cout))
                              .astype(np.float32)), g)
    valid = np.asarray(vin, np.float32)

    wt = cp.mirror_transpose_shards(cp.shard_weights(jnp.asarray(k5), [cin],
                                                     cout)[0])
    jdxn, _ = cp.conv_shards(to_jax(dconv, gj), None, wt, None, g=gj,
                             relu=False, stats=False, interpret=True,
                             edge_outputs=True)
    dxn = from_jax(jdxn, gj)[:, 1:Y + 1, 1:Z + 1] * valid[:, None, None, None]
    xf = cf.halo_filled(buf, halo).numpy()[:, 1:Y + 1, 1:Z + 1]
    a = aff.numpy()[0]
    dx, sums, dlo, dhi = cf.conv3x3x3_dx_plain(dconv, w, [cin], 0, aff, buf, g,
                                               halo, as_torch(valid))
    tol = dict(rtol=1e-3, atol=1e-3)
    got = torch.cat([dlo[None], dx[1:-1], dhi[None]]).numpy()
    np.testing.assert_allclose(got[:, 1:Y + 1, 1:Z + 1], dxn * a, **tol)
    assert not (dx[0].any() or dx[-1].any())
    np.testing.assert_allclose(
        sums.numpy(), np.stack([(xf * dxn).sum((0, 1, 2)), dxn.sum((0, 1, 2))]),
        **tol)

    jdw = cp.conv_wgrad_shards(
        to_jax(cf.halo_filled(buf, halo), gj), jax_affine(aff), to_jax(dconv, gj),
        g=gj, interpret=True, halo=True, valid_in=jnp.asarray(valid))
    want = np.asarray(jdw).transpose(2, 0, 3, 1, 4).reshape(27, cin, cout)
    np.testing.assert_allclose(
        cf.conv3x3x3_wgrad_plain(buf, aff, dconv, g, halo, as_torch(valid)).numpy(),
        want, **tol)


def test_dense_entry_ring_matches_jax():
    """The dense entry conv's ring mode: the slab between two halo planes,
    its buffer and sums, against ``conv3d_dense_entry(ring=True)``
    (rtol=atol=1e-5; sums rtol 1e-5, atol 1e-3)."""
    r = np.random.default_rng(4)
    x5 = (r.random((1, 6, Y, Z, 1)) < 0.3).astype(np.float32)
    k5 = r.standard_normal((3, 3, 3, 1, 8)).astype(np.float32)
    bias = (r.standard_normal(8) * 0.1).astype(np.float32)
    jbuf, jsums, jg = cp.conv3d_dense_entry(jnp.asarray(x5), jnp.asarray(k5),
                                            jnp.asarray(bias), jnp.float32,
                                            ring=True)
    buf, sums, g = cf.conv3d_dense_entry(as_torch(x5), as_torch(k5).permute(4, 3, 0, 1, 2),
                                         as_torch(bias), torch.float32, ring=True)
    assert (g.X, g.Y, g.Z) == (jg.X, jg.Y, jg.Z) == (4, Y, Z)
    np.testing.assert_allclose(buf.numpy(), from_jax(jbuf, jg), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(sums.numpy(),
                               np.asarray(jsums).swapaxes(0, 1).reshape(2, -1),
                               rtol=1e-5, atol=1e-3)
