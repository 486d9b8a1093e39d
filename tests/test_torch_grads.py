"""The port's fused-op backwards against the JAX package's custom VJPs, on
the CPU (f32).

The JAX side runs ``conv_pallas.fused_conv_block`` and
``conv_pallas.max_pool_buf`` with their Pallas kernels in interpret mode,
as ``tests/test_pallas.py`` does; the port's ``torch.autograd.Function``
classes take their plain backward versions (CPU tensors: the dx pass of
kernel C, the weight gradient of kernel D, the pool backward of kernel E).
Inputs come from a numpy seed and go to both; gradients are taken with
respect to the interior volumes, affines, weights and biases, and the
port's buffer gradients are checked to be exactly zero on the ring.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unetsulc_tpu.ops.conv_pallas as cp
from unetsulc_tpu_torch import kernels
from unetsulc_tpu_torch.ops import conv_fused as cf
from torch_threads import torch_one_thread  # noqa: F401,E402


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _ring_is_zero(buf):
    inner = torch.zeros(buf.shape[:3], dtype=torch.bool)
    inner[1:-1, 1:-1, 1:-1] = True
    return bool((buf[~inner] == 0).all())


def _jax_affine(a, b):
    """(C,), (C,) -> the JAX package's (K, 2, cs) shard affine."""
    return cp.affine_from_channels(a, b, cp.shard_width(a.shape[0]))


@pytest.mark.parametrize("cins,cout", [([16], 16), ([8, 16], 8), ([32], 16)])
def test_fused_conv_block_grads_match_jax(cins, cout):
    """dx, d(affine), dW and dbias of the fused conv block, with cotangents
    on both y and the stat sums, at test_pallas.py:153-207's shapes and
    inputs: y rtol=atol=1e-4 and sums rtol=1e-3, atol=1e-2 as there; every
    gradient rtol=atol=1e-3, the bar that test sets for dW (f32 sums over
    210 voxels x 27 taps, taken in another order)."""
    r = np.random.default_rng(0)
    X, Y, Z = 6, 5, 7
    xs5 = [r.standard_normal((1, X, Y, Z, ci)).astype(np.float32) for ci in cins]
    cin_t = sum(cins)
    a = (r.standard_normal(cin_t) * 0.5 + 1).astype(np.float32)
    b = (r.standard_normal(cin_t) * 0.1).astype(np.float32)
    k5 = (r.standard_normal((3, 3, 3, cin_t, cout)) * 0.2).astype(np.float32)
    bias = (r.standard_normal(cout) * 0.1).astype(np.float32)
    gy = r.standard_normal((1, X, Y, Z, cout)).astype(np.float32)
    gs = (r.standard_normal((2, cout)) * 0.01).astype(np.float32)
    offs = np.cumsum([0] + cins)
    g = cp.make_geom(X, Y, Z)

    def loss(xs5, a, b, k5, bias):
        xs = [cp.pad_to_geom(v, g) for v in xs5]
        abs_ = [_jax_affine(a[o:o + c], b[o:o + c]) for o, c in zip(offs, cins)]
        ws = list(cp.shard_weights(k5, cins, cout))
        if len(cins) == 1:  # the JAX call's second-input dummies
            xs.append(jnp.zeros((1, 2, 16, 8), jnp.float32))
            abs_.append(jnp.zeros((1, 2, 8), jnp.float32))
            ws.append(jnp.zeros((1, 1, 27, 8, 8), jnp.float32))
        y, s = cp.fused_conv_block(xs[0], xs[1], abs_[0], abs_[1], ws[0],
                                   ws[1], bias, None, None, None, len(cins),
                                   g, True)
        y5 = cp.unpad_from_geom(y, g)
        sflat = s.swapaxes(0, 1).reshape(2, -1)
        return jnp.sum(y5 * gy) + jnp.sum(sflat * gs), (y5, sflat)

    (_, (jy, js)), jg = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4),
                                           has_aux=True)(
        [jnp.asarray(v) for v in xs5], jnp.asarray(a), jnp.asarray(b),
        jnp.asarray(k5), jnp.asarray(bias))
    jdx, jda, jdb, jdk, jdbias = jg

    tg = cf.make_geom(X, Y, Z)
    xs = [cf.pad_to_geom(_t(v), tg).requires_grad_() for v in xs5]
    affs = [torch.stack([_t(a[o:o + c]), _t(b[o:o + c])]).requires_grad_()
            for o, c in zip(offs, cins)]
    w = _t(k5).permute(4, 3, 0, 1, 2).contiguous().requires_grad_()
    tb = _t(bias).requires_grad_()
    y, s = cf.fused_conv_block(xs, affs, w, tb, tg)
    ((y * cf.pad_to_geom(_t(gy), tg)).sum() + (s * _t(gs)).sum()).backward()

    np.testing.assert_allclose(cf.unpad_from_geom(y, tg).detach().numpy(),
                               np.asarray(jy), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(js),
                               rtol=1e-3, atol=1e-2)
    tol = dict(rtol=1e-3, atol=1e-3)
    for x, aff, o, c, jx in zip(xs, affs, offs, cins, jdx):
        np.testing.assert_allclose(cf.unpad_from_geom(x.grad, tg).numpy(),
                                   np.asarray(jx), **tol)
        assert _ring_is_zero(x.grad)
        np.testing.assert_allclose(aff.grad[0].numpy(),
                                   np.asarray(jda)[o:o + c], **tol)
        np.testing.assert_allclose(aff.grad[1].numpy(),
                                   np.asarray(jdb)[o:o + c], **tol)
    np.testing.assert_allclose(w.grad.permute(2, 3, 4, 1, 0).numpy(),
                               np.asarray(jdk), **tol)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jdbias), **tol)


@pytest.mark.parametrize("shape,affine,ties", [
    ((9, 8, 10, 8), True, False),
    ((9, 8, 10, 8), False, False),
    ((7, 9, 5, 4), True, False),
    ((7, 9, 5, 4), False, False),
    ((9, 8, 10, 8), True, True),
])
def test_max_pool_buf_grads_match_jax(shape, affine, ties):
    """dbuf of the buffer max pool equal to JAX's (both route each pooled
    cotangent to the first window position equal to the max and scale it
    by a in f32), d(affine) rtol=atol=1e-4 (test_pallas.py:320's bar), at
    test_pallas.py:320's shapes; the tie case draws integer values, so
    most windows hold several maxima."""
    X, Y, Z, C = shape
    r = np.random.default_rng(0)
    if ties:
        x5 = r.integers(-2, 3, (1, X, Y, Z, C)).astype(np.float32)
    else:
        x5 = r.standard_normal((1, X, Y, Z, C)).astype(np.float32)
    a = (r.standard_normal(C) * 0.5 + 1).astype(np.float32)
    b = (r.standard_normal(C) * 0.2).astype(np.float32)
    g, go = cp.make_geom(X, Y, Z), cp.pool_geom(cp.make_geom(X, Y, Z))
    gy = r.standard_normal((1, go.X, go.Y, go.Z, C)).astype(np.float32)

    def loss(x5, a, b):
        aff = _jax_affine(a, b) if affine else None
        out = cp.max_pool_buf(cp.pad_to_geom(x5, g), aff, g, True)
        return jnp.sum(cp.unpad_from_geom(out, go) * gy)

    jdx, jda, jdb = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x5), jnp.asarray(a), jnp.asarray(b))

    tg = cf.make_geom(X, Y, Z)
    tgo = cf.pool_geom(tg)
    buf = cf.pad_to_geom(_t(x5), tg).requires_grad_()
    aff = torch.stack([_t(a), _t(b)]).requires_grad_() if affine else None
    out = cf.max_pool_buf(buf, aff, tg)
    (out * cf.pad_to_geom(_t(gy), tgo)).sum().backward()

    np.testing.assert_array_equal(cf.unpad_from_geom(buf.grad, tg).numpy(),
                                  np.asarray(jdx))
    assert _ring_is_zero(buf.grad)
    if affine:
        np.testing.assert_allclose(aff.grad.numpy(),
                                   np.stack([np.asarray(jda), np.asarray(jdb)]),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cins,branch", [([16], 0), ([8, 16], 0), ([8, 16], 1)])
def test_mirror_transpose_matches_jax(cins, branch):
    """Kernel C's weights, W^T with mirrored taps per input branch, equal
    the JAX package's ``mirror_transpose_shards`` of the same branch."""
    r = np.random.default_rng(5)
    cout = 8
    k5 = r.standard_normal((3, 3, 3, sum(cins), cout)).astype(np.float32)
    wt = cp.mirror_transpose_shards(
        cp.shard_weights(jnp.asarray(k5), cins, cout)[branch])
    kout, kin, _, cso, csi = wt.shape  # (Kout, Kin, 27, cso, csi)
    want = np.asarray(wt).transpose(2, 0, 3, 1, 4).reshape(
        27, kout * cso, kin * csi)
    got = kernels.mirror_transpose(_t(k5).permute(4, 3, 0, 1, 2), cins, branch)
    assert tuple(got.shape) == (cins[branch], cout, 3, 3, 3)
    np.testing.assert_array_equal(
        got.permute(2, 3, 4, 1, 0).reshape(27, cout, cins[branch]).numpy(), want)


def test_conv_dx_plain_is_the_transposed_conv():
    """The plain dx pass with the mirrored, transposed weights as a forward
    conv equals ``F.conv_transpose3d`` with the weights as they are (the
    identity kernel C computes), and its sums are the cross-stats."""
    g = cf.make_geom(5, 4, 6)
    gen = torch.Generator().manual_seed(0)
    cins, cout = [4, 6], 5
    w = torch.randn((cout, sum(cins), 3, 3, 3), generator=gen)
    dconv = cf.pad_to_geom(torch.randn((1, 5, 4, 6, cout), generator=gen), g)
    x = cf.pad_to_geom(torch.randn((1, 5, 4, 6, 6), generator=gen), g)
    aff = torch.stack([torch.rand(6, generator=gen) + 0.5, torch.zeros(6)])
    dx, sums = cf.conv3x3x3_dx_plain(dconv, w, cins, 1, aff, x, g)
    wt = kernels.mirror_transpose(w, cins, 1)
    dxn = torch.nn.functional.conv3d(dconv.permute(3, 0, 1, 2)[None], wt)[0]
    dxn = dxn.permute(1, 2, 3, 0)
    torch.testing.assert_close(cf.unpad_from_geom(dx, g)[0], dxn * aff[0],
                               rtol=1e-5, atol=1e-5)
    assert _ring_is_zero(dx)
    xi = cf.unpad_from_geom(x, g)[0]
    torch.testing.assert_close(
        sums, torch.stack([(xi * dxn).sum((0, 1, 2)), dxn.sum((0, 1, 2))]),
        rtol=1e-5, atol=1e-4)
