"""MaxPool3d(kernel 2, stride 2, padding 1) on channels-last volumes.

Counterpart of ``unetsulc_tpu/ops/pooling.py``: torch's padded max pooling
(the downsampler of the UNet3D encoders) on (N, X, Y, Z, C), with -inf
padding of 1 on every spatial axis (``iinfo.min`` for an integer dtype),
window and stride 2, so the output extent is ``floor(d/2) + 1`` and odd
extents stay alive through the ladder (96 -> 49 -> 25 -> 13).

Floating inputs go through ``F.max_pool3d`` on the channels-first view,
whose gradient goes to the FIRST maximal element of each window in
row-major (x, y, z) order: the JAX function's custom VJP, ties included.
``F.max_pool3d`` takes no integer dtype, so integer inputs reduce a padded
window view, as the JAX function's ``_window_view``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _out_extent(d: int) -> int:
    return d // 2 + 1


def _window_view(x: torch.Tensor) -> torch.Tensor:
    """(N, X, Y, Z, C) -> padded window view (N, ox, 2, oy, 2, oz, 2, C)."""
    n, dx, dy, dz, c = (int(v) for v in x.shape)
    fill = (float("-inf") if x.is_floating_point()
            else torch.iinfo(x.dtype).min)
    pads = [0, 0]
    for d in (dz, dy, dx):  # F.pad lists the last axis first
        pads += [1, 2 * _out_extent(d) - d - 1]
    xp = F.pad(x, pads, value=fill)
    return xp.reshape(n, _out_extent(dx), 2, _out_extent(dy), 2,
                      _out_extent(dz), 2, c)


def max_pool_3d(x: torch.Tensor) -> torch.Tensor:
    """Padded 2x2x2/stride-2 max pool on (N, X, Y, Z, C): extent d ->
    d//2 + 1, pads count as -inf (``iinfo.min``)."""
    if x.is_floating_point():
        return F.max_pool3d(x.permute(0, 4, 1, 2, 3), 2, 2,
                            padding=1).permute(0, 2, 3, 4, 1)
    return _window_view(x).amax(dim=(2, 4, 6))
