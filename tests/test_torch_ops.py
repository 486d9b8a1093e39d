"""The port's pipeline ops against the JAX package's, on the CPU (f32).

The JAX side runs its Pallas kernels in interpret mode, as
``tests/test_pallas.py`` does; the port's ops take their plain PyTorch
versions (CPU tensors). Buffers differ in layout — the JAX package's
``(K, Xp, plane, cs)`` TPU shards against the port's padded channels-last
``(X+2, Y+2, Z+2, C)`` — so interiors are compared, and the port's ring is
checked to be exactly zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unetsulc_tpu.ops.conv_pallas as cp
from unetsulc_tpu.ops.resize import resize_trilinear_buf as jax_resize_buf
from unetsulc_tpu_torch.ops import conv_fused as cf
from unetsulc_tpu_torch.ops.resize import resize_trilinear_buf
from torch_threads import torch_one_thread  # noqa: F401,E402


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _ring_is_zero(buf):
    inner = torch.zeros_like(buf, dtype=torch.bool)
    inner[1:-1, 1:-1, 1:-1] = True
    return bool((buf[~inner.expand_as(buf)] == 0).all())


def _jax_affine(a, b):
    """(C,), (C,) -> the JAX package's (K, 2, cs) shard affine."""
    return cp.affine_from_channels(jnp.asarray(a), jnp.asarray(b),
                                   cp.shard_width(len(a)))


@pytest.mark.parametrize("cins,cout", [([16], 16), ([8, 16], 8), ([32], 16)])
def test_fused_conv_block_matches_jax(cins, cout):
    """Plain fused_conv_block == JAX fused_conv_block (interpret, f32), with
    affines; the bar of test_pallas.py:202-205: interior y rtol=atol=1e-4,
    sums rtol=1e-3, atol=1e-2 (f32, reordered sums over 210 voxels)."""
    r = np.random.default_rng(0)
    X, Y, Z = 6, 5, 7
    xs5 = [r.standard_normal((1, X, Y, Z, ci)).astype(np.float32) for ci in cins]
    cin_t = sum(cins)
    a = (r.standard_normal(cin_t) * 0.5 + 1).astype(np.float32)
    b = (r.standard_normal(cin_t) * 0.1).astype(np.float32)
    k5 = (r.standard_normal((3, 3, 3, cin_t, cout)) * 0.2).astype(np.float32)
    bias = (r.standard_normal(cout) * 0.1).astype(np.float32)
    offs = np.cumsum([0] + cins)

    g = cp.make_geom(X, Y, Z)
    jx = [cp.pad_to_geom(jnp.asarray(v), g) for v in xs5]
    jab = [_jax_affine(a[o:o + c], b[o:o + c]) for o, c in zip(offs, cins)]
    jw = list(cp.shard_weights(jnp.asarray(k5), cins, cout))
    if len(cins) == 1:  # the JAX call's second-input dummies
        jx.append(jnp.zeros((1, 2, 16, 8), jnp.float32))
        jab.append(jnp.zeros((1, 2, 8), jnp.float32))
        jw.append(jnp.zeros((1, 1, 27, 8, 8), jnp.float32))
    jy, jsums = cp.fused_conv_block(jx[0], jx[1], jab[0], jab[1], jw[0], jw[1],
                                    jnp.asarray(bias), None, None, None,
                                    len(cins), g, True)
    jy5 = np.asarray(cp.unpad_from_geom(jy, g))
    jsums = np.asarray(jsums).swapaxes(0, 1).reshape(2, -1)

    tg = cf.make_geom(X, Y, Z)
    ty, tsums = cf.fused_conv_block(
        [cf.pad_to_geom(_t(v), tg) for v in xs5],
        [torch.stack([_t(a[o:o + c]), _t(b[o:o + c])]) for o, c in zip(offs, cins)],
        _t(k5).permute(4, 3, 0, 1, 2), _t(bias), tg,
    )
    np.testing.assert_allclose(cf.unpad_from_geom(ty, tg).numpy(), jy5,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tsums.numpy(), jsums, rtol=1e-3, atol=1e-2)
    assert _ring_is_zero(ty)


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("shape", [(9, 8, 10, 8), (7, 9, 5, 4)])
def test_max_pool_buf_matches_jax(shape, affine):
    """Plain max_pool_buf == JAX max_pool_buf (interpret) and
    max_pool_buf_xla at odd extents, with and without an affine: the max of
    identical f32 values, 1e-6."""
    X, Y, Z, C = shape
    r = np.random.default_rng(0)
    x5 = r.standard_normal((1, X, Y, Z, C)).astype(np.float32)
    a = (r.standard_normal(C) * 0.5 + 1).astype(np.float32)
    b = (r.standard_normal(C) * 0.2).astype(np.float32)
    g = cp.make_geom(X, Y, Z)
    jbuf = cp.pad_to_geom(jnp.asarray(x5), g)
    jaff = _jax_affine(a, b) if affine else None
    go = cp.pool_geom(g)
    want = np.asarray(cp.unpad_from_geom(cp.max_pool_buf(jbuf, jaff, g, True), go))
    want_xla = np.asarray(cp.unpad_from_geom(cp.max_pool_buf_xla(jbuf, jaff, g), go))

    tg = cf.make_geom(X, Y, Z)
    taff = torch.stack([_t(a), _t(b)]) if affine else None
    got = cf.max_pool_buf(cf.pad_to_geom(_t(x5), tg), taff, tg)
    tgo = cf.pool_geom(tg)
    assert tuple(got.shape) == tgo.padded + (C,)
    got5 = cf.unpad_from_geom(got, tgo).numpy()
    np.testing.assert_allclose(got5, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got5, want_xla, rtol=1e-6, atol=1e-6)
    assert _ring_is_zero(got)


def test_gn_affine_from_sums_matches_jax():
    """f32 group statistics -> per-channel affine, 1e-5 relative."""
    r = np.random.default_rng(3)
    C, G, count = 48, 16, 210
    y = np.abs(r.standard_normal((count, C))).astype(np.float32)
    s0, s1 = y.sum(0), (y * y).sum(0)
    scale = (r.standard_normal(C) * 0.5 + 1).astype(np.float32)
    bias = (r.standard_normal(C) * 0.1).astype(np.float32)
    want = cp.gn_affine_from_sums(_jax_affine(s0, s1), jnp.asarray(scale),
                                  jnp.asarray(bias), G, count)
    want = np.asarray(want).swapaxes(0, 1).reshape(2, C)
    got = cf.gn_affine_from_sums(torch.stack([_t(s0), _t(s1)]), _t(scale),
                                 _t(bias), G, count)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cin", [1, 4])
def test_conv3d_dense_entry_matches_jax(cin):
    """The entry conv's buffer and stat sums (f32), 1e-5 / 1e-4."""
    r = np.random.default_rng(4)
    X, Y, Z, cout = 7, 6, 9, 8
    x5 = (r.random((1, X, Y, Z, cin)) < 0.3).astype(np.float32)
    k5 = (r.standard_normal((3, 3, 3, cin, cout)) * 0.3).astype(np.float32)
    bias = (r.standard_normal(cout) * 0.1).astype(np.float32)
    jbuf, jsums, g = cp.conv3d_dense_entry(jnp.asarray(x5), jnp.asarray(k5),
                                           jnp.asarray(bias), jnp.float32)
    buf, sums, tg = cf.conv3d_dense_entry(_t(x5), _t(k5).permute(4, 3, 0, 1, 2),
                                          _t(bias), torch.float32)
    np.testing.assert_allclose(cf.unpad_from_geom(buf, tg).numpy(),
                               np.asarray(cp.unpad_from_geom(jbuf, g)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sums.numpy(),
                               np.asarray(jsums).swapaxes(0, 1).reshape(2, -1),
                               rtol=1e-4, atol=1e-4)
    assert _ring_is_zero(buf)


@pytest.mark.parametrize("src,dst", [((5, 4, 7), (9, 8, 13)), ((3, 3, 3), (5, 6, 5))])
def test_resize_trilinear_buf_matches_jax(src, dst):
    """Buffer-native trilinear resize (same half-pixel weights), 1e-5,
    with an exact-zero ring."""
    r = np.random.default_rng(6)
    C = 6
    x5 = r.standard_normal((1, *src, C)).astype(np.float32)
    gi, go = cp.make_geom(*src), cp.make_geom(*dst)
    want = cp.unpad_from_geom(
        jax_resize_buf(cp.pad_to_geom(jnp.asarray(x5), gi), gi, go), go)
    tgi, tgo = cf.make_geom(*src), cf.make_geom(*dst)
    got = resize_trilinear_buf(cf.pad_to_geom(_t(x5), tgi), tgi, tgo)
    assert tuple(got.shape) == tgo.padded + (C,)
    np.testing.assert_allclose(cf.unpad_from_geom(got, tgo).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    assert _ring_is_zero(got)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers take CUDA tensors only: a CPU tensor raises before
    anything is built — there is no path from them to the CPU."""
    from unetsulc_tpu_torch import kernels

    buf = torch.zeros((5, 5, 5, 8), dtype=torch.bfloat16)
    ab = cf.identity_affine(8, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.max_pool_buf_fwd(buf, ab)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.conv3x3x3_fwd([buf], [ab], torch.zeros((8, 8, 3, 3, 3)),
                              torch.zeros(8))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.conv3x3x3_dx(buf, ab, buf, torch.zeros((27, 32, 64)))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.conv3x3x3_wgrad(buf, ab, buf)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.max_pool_buf_bwd(buf, ab, buf, buf)
    # the halo modes of A, C and D
    plane, valid = buf[0], torch.ones(5)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.conv3x3x3_fwd([buf], [ab], torch.zeros((8, 8, 3, 3, 3)),
                              torch.zeros(8), halos=[(plane, plane)],
                              valids=[valid], valid_out=valid)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.conv3x3x3_dx(buf, ab, buf, torch.zeros((27, 32, 64)),
                             post_halo=(plane, None), valid=valid)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.conv3x3x3_wgrad(buf, ab, buf, halo=(None, plane), valid=valid)
    x3 = torch.zeros((1, 10, 8), dtype=torch.bfloat16)
    st = torch.zeros((1, 2))
    c8 = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.gn_stats(x3, 2, 1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.gn_apply(x3, st, st, c8, c8)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.gn_bwd_reduce(x3, x3, st, st, c8)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.gn_bwd_dx(x3, x3, st, st, c8, st, st)
    # the sharded GroupNorm's modes and finalize
    with pytest.raises(ValueError, match="CUDA"):
        kernels.gn_stats_sums(x3, 2)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.gn_finalize(st, st, 40, 1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.gn_bwd_dx(x3, x3, st, st, c8, st, st, denom=40)
    # the probe kernels take a device, not tensors: the CPU raises
    with pytest.raises(ValueError, match="CUDA"):
        kernels.mxu_dot(64, 64, 40, 2, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.mxu_rdot(64, 64, 40, 2, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.slab_build(16, 2, 40, 2, "cpu")
    assert set(kernels.launch_counts) == {
        "conv3x3x3_fwd", "conv3x3x3_dx", "conv3x3x3_wgrad",
        "conv3x3x3_fwd_halo", "conv3x3x3_dx_halo", "conv3x3x3_wgrad_halo",
        "max_pool_buf_fwd", "max_pool_buf_bwd", "gn_stats", "gn_apply",
        "gn_bwd_reduce", "gn_bwd_dx", "gn_stats_sums", "gn_finalize",
        "gn_bwd_dx_denom", "mxu_dot", "mxu_rdot", "slab_build"}
    assert not any(kernels.launch_counts.values())
