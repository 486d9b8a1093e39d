"""Trilinear resize, torch ``align_corners=False``.

Counterparts of ``resize_trilinear`` and ``resize_trilinear_buf`` in
``unetsulc_tpu/ops/resize.py``: each axis is contracted with a static
(out, in) interpolation matrix, with the half-pixel source coordinates

    src = clamp((dst + 0.5) * in/out - 0.5, 0, in-1).

:func:`resize_trilinear` resizes a channels-last (N, X, Y, Z, C) volume
(the non-fused decoder); :func:`resize_trilinear_buf` a padded buffer, with
the matrices embedded in the padded extents so the ring rows of the output
are exact zeros and the input's ring columns are never read (the fused
decoder). The matrices are cast to the tensor's dtype, as there. Each
contraction is a plain matmul whose result is already contiguous in the
tensor's layout.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _axis_indices_weights(in_size: int, out_size: int):
    """(idx0, idx1, w1) of one axis's linear interpolation."""
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * (in_size / out_size) - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    idx0 = np.floor(src).astype(np.int64)
    idx1 = np.minimum(idx0 + 1, in_size - 1)
    w1 = (src - idx0).astype(np.float32)
    return idx0, idx1, w1


def interp_matrix(in_size: int, out_size: int, padded: bool = False) -> np.ndarray:
    """(out, in) interpolation matrix of one axis; with ``padded`` the
    (out+2, in+2) matrix on ring-padded axes."""
    idx0, idx1, w1 = _axis_indices_weights(in_size, out_size)
    p = 1 if padded else 0
    m = np.zeros((out_size + 2 * p, in_size + 2 * p), np.float32)
    rows = np.arange(out_size) + p
    np.add.at(m, (rows, idx0 + p), 1.0 - w1)
    np.add.at(m, (rows, idx1 + p), w1)
    return m


@functools.lru_cache(maxsize=None)
def _interp_matrix_on(in_size: int, out_size: int, padded: bool,
                      device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """:func:`interp_matrix` on ``device`` in ``dtype``, built and uploaded
    once per (sizes, padding, device, dtype); callers only read it."""
    return torch.as_tensor(interp_matrix(in_size, out_size, padded)).to(
        device=device, dtype=dtype
    )


def _contract(x: torch.Tensor, axis: int, m: torch.Tensor) -> torch.Tensor:
    """Contract ``axis`` of x with the (out, in) matrix m."""
    lead = int(np.prod(x.shape[:axis]))
    out = torch.matmul(m, x.reshape(lead, x.shape[axis], -1))
    shape = list(x.shape)
    shape[axis] = int(m.shape[0])
    return out.reshape(shape)


def resize_trilinear(x: torch.Tensor, target) -> torch.Tensor:
    """(N, X, Y, Z, C) -> (N, X', Y', Z', C) at spatial ``target``, in x's
    dtype (x, then y, then z, as the JAX function)."""
    if x.dim() != 5:
        raise ValueError(f"expected (N, X, Y, Z, C), got {tuple(x.shape)}")
    for axis, out_size in zip((1, 2, 3), target):
        if x.shape[axis] != int(out_size):
            x = _contract(x, axis, _interp_matrix_on(
                int(x.shape[axis]), int(out_size), False, x.device, x.dtype))
    return x


def resize_trilinear_buf(buf: torch.Tensor, g_in, g_out) -> torch.Tensor:
    """(Xp, Yp, Zp, C) buffer of ``g_in`` -> buffer of ``g_out`` with the
    interior trilinearly resized and an exact-zero ring (z, then y, then x,
    as the JAX function)."""
    x = buf
    for axis, i_in, i_out in ((2, g_in.Z, g_out.Z), (1, g_in.Y, g_out.Y),
                              (0, g_in.X, g_out.X)):
        if i_in != i_out:
            x = _contract(x, axis, _interp_matrix_on(
                i_in, i_out, True, buf.device, buf.dtype))
    return x
