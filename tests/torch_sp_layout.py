"""Layout converters between the JAX package's ``(K, Xp, plane, cs)``
shard buffers and the port's ``(X+2, Y+2, Z+2, C)`` buffers, for the
spatial-parallel tests (``tests/test_torch_sp*.py``), whose slabs have
Y = Z = 6."""

import jax.numpy as jnp
import numpy as np
import torch

import unetsulc_tpu.ops.conv_pallas as cp

Y, Z = 6, 6


def as_torch(a):
    return torch.from_numpy(np.array(a))


def jax_geom(x, xp=None):
    """The JAX Geom of a slab of x planes (Xp forced for slab+E)."""
    g = cp.make_geom(x, Y, Z)
    return g if xp is None else cp.Geom(x, Y, Z, xp, g.Yp, g.Zp)


def to_jax(buf, gj):
    """Port buffer (Xp, y+2, z+2, C) -> the JAX (K, Xp, plane, cs) buffer
    of geometry ``gj`` (its extra Yp/Zp padding zero)."""
    buf = np.asarray(buf)
    xp, yp, zp, c = buf.shape
    full = np.zeros((xp, gj.Yp, gj.Zp, c), np.float32)
    full[:, :yp, :zp] = buf
    cs = cp.shard_width(c)
    return jnp.asarray(
        full.reshape(xp, gj.plane, c // cs, cs).transpose(2, 0, 1, 3))


def from_jax(jbuf, gj):
    """JAX (K, Xp, plane, cs) buffer -> port layout (Xp, Y+2, Z+2, C)."""
    k, xp, _, cs = jbuf.shape
    a = np.asarray(jbuf).transpose(1, 2, 0, 3).reshape(xp, gj.Yp, gj.Zp, k * cs)
    return a[:gj.X + 2, :gj.Y + 2, :gj.Z + 2]


def jax_affine(aff):
    a = np.asarray(aff)
    return cp.affine_from_channels(jnp.asarray(a[0]), jnp.asarray(a[1]),
                                   cp.shard_width(a.shape[1]))
