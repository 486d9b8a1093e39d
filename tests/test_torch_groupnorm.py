"""The port's GroupNorm against the JAX package's GroupNorm kernels, on the
CPU.

The JAX side runs ``group_norm_pallas`` (the whole-slab kernel
``_gn_kernel``) and ``group_norm_pallas_chunked`` (the chunked stats,
normalize, backward-reduce and backward-dx kernels) in Pallas interpret
mode, monkeypatched as ``tests/test_pallas.py`` does; the port's
``group_norm`` takes the plain versions of its four CUDA kernels (CPU
tensors). Inputs come from numpy seeds and go to both.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import unetsulc_tpu.ops.attic.groupnorm_pallas_chunked as gnc
import unetsulc_tpu.ops.groupnorm_pallas as gnp
from unetsulc_tpu.ops.groupnorm import group_norm as jax_group_norm
from unetsulc_tpu_torch.ops import groupnorm as tgn
from torch_threads import torch_one_thread  # noqa: F401,E402

SHAPES = [((2, 5, 4, 3, 16), 8), ((1, 7, 7, 7, 32), 32)]
IDS = ["2x5x4x3x16-g8", "1x7x7x7x32-g32"]


@pytest.fixture(autouse=True)
def _interpret_pallas(monkeypatch):
    """Pallas in interpret mode on the CPU backend (test_pallas.py:19-26,
    :88-91)."""
    orig = pl.pallas_call
    for mod in (gnp, gnc):
        monkeypatch.setattr(mod.pl, "pallas_call",
                            functools.partial(orig, interpret=True))


JAX_GN = {
    "whole_slab": gnp.group_norm_pallas,
    "chunked": gnc.group_norm_pallas_chunked,
}


def _inputs(shape, seed):
    r = np.random.default_rng(seed)
    x = r.normal(size=shape).astype(np.float32)
    scale = r.normal(size=shape[-1]).astype(np.float32)
    bias = r.normal(size=shape[-1]).astype(np.float32)
    gy = r.normal(size=shape).astype(np.float32)
    return x, scale, bias, gy


@pytest.mark.parametrize("kernel", sorted(JAX_GN))
@pytest.mark.parametrize("shape,groups", SHAPES, ids=IDS)
def test_group_norm_plain_forward_matches_jax(kernel, shape, groups):
    """The plain forward (gn_stats + gn_apply) against row 7's kernel and
    rows 8-9's chunked kernels: rtol 1e-4, atol 1e-5, test_pallas.py:41-43's
    bar; mean_g and inv_g against the whole-slab kernel's, rtol 1e-5."""
    x, scale, bias, _ = _inputs(shape, 0)
    want = JAX_GN[kernel](jnp.asarray(x), groups, jnp.asarray(scale),
                          jnp.asarray(bias))
    got = tgn.group_norm(torch.from_numpy(x), groups, torch.from_numpy(scale),
                         torch.from_numpy(bias))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    if kernel == "whole_slab":
        n, c = shape[0], shape[-1]
        x3 = jnp.asarray(x).reshape(n, -1, c)
        _, jmean, jinv = gnp._gn_forward_pallas(
            x3, jnp.asarray(gnc._indicator(c, groups)),
            jnp.asarray(scale).reshape(1, c), jnp.asarray(bias).reshape(1, c),
            num_groups=groups, eps=1e-5)
        mean, inv = tgn.gn_stats_plain(torch.from_numpy(x).reshape(n, -1, c),
                                       groups, 1e-5)
        np.testing.assert_allclose(mean.numpy(), np.asarray(jmean)[:, 0],
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(inv.numpy(), np.asarray(jinv)[:, 0],
                                   rtol=1e-5)


@pytest.mark.parametrize("kernel", sorted(JAX_GN))
@pytest.mark.parametrize("shape,groups", SHAPES, ids=IDS)
def test_group_norm_grads_match_jax(kernel, shape, groups):
    """GroupNormFn's gradients of sum(y * gy) in x, scale and bias (the
    plain gn_bwd_reduce and gn_bwd_dx) against jax.grad through the
    whole-slab kernel's custom VJP (``_gn3_bwd``) and through the chunked
    kernels' backward (rows 10-11): rtol 2e-3, atol 2e-4, test_pallas.py:
    64-69's bar."""
    x, scale, bias, gy = _inputs(shape, 1)

    def loss(x, scale, bias):
        return jnp.sum(JAX_GN[kernel](x, groups, scale, bias) * gy)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    (tgn.group_norm(*ts[:1], groups, *ts[1:]) * torch.from_numpy(gy)).sum().backward()
    for t, w in zip(ts, want):
        assert t.grad.dtype == torch.float32
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=2e-3,
                                   atol=2e-4)


def test_group_norm_bf16_keeps_dtype():
    """A bf16 input gives a bf16 output and a bf16 input gradient, f32
    scale and bias gradients; the output is the f32-statistics GroupNorm
    of the bf16 values rounded once (JAX's XLA group_norm of the same bf16
    input, within 1 bf16 ulp: rtol 2^-7, atol 1e-2)."""
    x, scale, bias, gy = _inputs((2, 5, 4, 3, 16), 2)
    xb = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    s, b = torch.from_numpy(scale).requires_grad_(), torch.from_numpy(bias)
    y = tgn.group_norm(xb, 8, s, b)
    assert y.dtype == torch.bfloat16
    want = jax_group_norm(jnp.asarray(x).astype(jnp.bfloat16), 8,
                          jnp.asarray(scale), jnp.asarray(bias),
                          use_pallas=False)
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(y.float().detach().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-2)
    (y.float() * torch.from_numpy(gy)).sum().backward()
    assert xb.grad.dtype == torch.bfloat16 and s.grad.dtype == torch.float32


def test_group_norm_steps_compose():
    """The four steps, called as the dispatchers: gn_bwd_reduce's dscale
    and dbias equal the direct sums, and gn_bwd_dx with its sums equals
    autograd through the f32 formula (rtol 1e-5, atol 1e-6); a group whose
    values are all equal normalizes to its bias (eps keeps it finite)."""
    r = np.random.default_rng(3)
    x = torch.from_numpy(r.normal(size=(2, 30, 12)).astype(np.float32))
    x[1, :, 4:8] = 0.0  # one constant group, as post-ReLU zeros
    g = torch.from_numpy(r.normal(size=(2, 30, 12)).astype(np.float32))
    scale = torch.from_numpy(r.normal(size=12).astype(np.float32))
    bias = torch.from_numpy(r.normal(size=12).astype(np.float32))
    mean, inv = tgn.gn_stats(x, 3, 1e-5)
    y = tgn.gn_apply(x, mean, inv, scale, bias)
    torch.testing.assert_close(y[1, :, 4:8], bias[4:8].expand(30, 4))
    dscale, dbias, sdx, sdxx = tgn.gn_bwd_reduce(x, g, mean, inv, scale)
    xhat = (y - bias) / scale
    torch.testing.assert_close(dbias, g.sum((0, 1)), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dscale, (g * xhat).sum((0, 1)), rtol=1e-5,
                               atol=1e-5)
    dx = tgn.gn_bwd_dx(x, g, mean, inv, scale, sdx, sdxx)

    xr = x.clone().requires_grad_()
    xg = xr.view(2, 30, 3, 4)
    m = xg.mean((1, 3), keepdim=True)
    v = (xg * xg).mean((1, 3), keepdim=True) - m * m
    ((xg - m) * torch.rsqrt(v + 1e-5)).view(2, 30, 12).mul(scale).mul(g).sum().backward()
    torch.testing.assert_close(dx, xr.grad, rtol=1e-5, atol=1e-5)
