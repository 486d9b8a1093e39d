"""Dense voxelization of sulci point clouds (host side).

Rebuild of the reference's per-item tensor construction
(ref dataset.py:72-88): a binary occupancy volume plus an integer label
volume initialized to background (-1), in the channels-last
``(X, Y, Z, 1)`` layout, with the same cubic shape buckets as the JAX
package so both label the same volumes. A float32 volume is scattered by
the port's C++ voxelizer (:mod:`unetsulc_tpu_torch.runtime`); the numpy
scatter is its plain version (``use_native=False``) and the path of other
dtypes.

Zero-padding semantics: the reference pads with input=0 / label=background
whenever a fixed ``img_size`` is used (ref dataset.py:76-88), and GroupNorm
sees those zeros.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

_BACKGROUND = -1

# Static shape buckets: a sample of extent e is padded up to the smallest
# bucket >= e per axis.
DEFAULT_BUCKET_SIZES = (32, 48, 64, 80, 96, 112, 128, 160, 192, 224, 256)


def bucket_size(extent: int, buckets: Sequence[int] = DEFAULT_BUCKET_SIZES) -> int:
    for b in buckets:
        if extent <= b:
            return b
    # beyond the largest bucket: round up to multiple of 32
    return int(np.ceil(extent / 32) * 32)


def bucket_shape(
    extents: Sequence[int], buckets: Sequence[int] = DEFAULT_BUCKET_SIZES
) -> Tuple[int, int, int]:
    return tuple(bucket_size(int(e), buckets) for e in extents)


def voxelize(
    bck2: np.ndarray,
    label_ids: np.ndarray,
    img_size: Optional[Sequence[int]] = None,
    background: int = _BACKGROUND,
    dtype=np.float32,
    use_native: Optional[bool] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Scatter points into (input, labels) dense volumes.

    ``bck2`` must already be translated to the origin (min coords == 0),
    as the reference guarantees before voxelizing (ref dataset.py:64-69).

    Returns:
      input:  (X, Y, Z, 1) float volume, 1.0 at point coords;
      labels: (X, Y, Z) int32 volume, ``background`` everywhere else.

    Later-scatter-wins on duplicate coords, matching torch index assignment
    (ref dataset.py:85-86): the last point of each voxel is selected
    explicitly, so the result does not rest on numpy's unspecified order
    of repeated-index assignment.

    ``use_native`` (default: for float32) scatters with the C++ voxelizer
    of :mod:`unetsulc_tpu_torch.runtime`, which gives the same volumes.
    """
    bck2 = np.asarray(bck2, dtype=np.int64)
    if img_size is None:
        img_size = np.max(bck2, axis=0) + 1 if len(bck2) else np.ones(3, int)
    sx, sy, sz = (int(s) for s in img_size)
    if use_native is None:
        use_native = np.dtype(dtype) == np.float32
    if use_native:
        from unetsulc_tpu_torch import runtime

        return runtime.voxelize_native(bck2, label_ids, (sx, sy, sz),
                                       background=background)
    vol_in = np.zeros((sx, sy, sz, 1), dtype=dtype)
    vol_lb = np.full((sx, sy, sz), background, dtype=np.int32)
    if len(bck2):
        x, y, z = bck2[:, 0], bck2[:, 1], bck2[:, 2]
        # Clip defensively: a fixed img_size smaller than the cloud would
        # otherwise crash (the reference would crash too).
        inb = (x < sx) & (y < sy) & (z < sz) & (x >= 0) & (y >= 0) & (z >= 0)
        flat = np.ravel_multi_index((x[inb], y[inb], z[inb]), (sx, sy, sz))
        ids = np.asarray(label_ids, dtype=np.int32)[inb]
        # np.unique on the reversed order keeps each voxel's LAST point
        uniq, first_rev = np.unique(flat[::-1], return_index=True)
        last = len(flat) - 1 - first_rev
        vol_in.reshape(-1)[uniq] = 1.0
        vol_lb.reshape(-1)[uniq] = ids[last]
    return vol_in, vol_lb


def names_to_ids(names: np.ndarray, dict_sulci: dict) -> np.ndarray:
    """Vectorized label-name -> id lookup (ref dataset.py:85-86)."""
    return np.asarray([dict_sulci[n] for n in names], dtype=np.int32)
