"""Synthetic subjects from the seed, in numpy: the benchmark's inputs.

A subject is what the training pipeline hands the step for one BrainVISA
graph in the 96³ bucket: an occupancy volume (1.0 at each sulcal voxel,
0 elsewhere) and a label volume (the voxel's sulcus id, ``-1`` elsewhere).
Each of the ``labels`` sulci has ``folds_per_label`` folds, each a random
walk of ``points_per_fold`` voxels from a place fixed per sulcus (the
"anatomy", the same for every seed) jittered per subject, as
``io/graph.make_synthetic_graph`` of the port builds its structured graphs;
where two folds meet, the later fold's label wins, as the voxelizer's
later-scatter-wins. At 2 folds of 350 points a subject has about 35k
labelled voxels, a real graph's 30-40k.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

BACKGROUND = -1


def _rng(seed: int, *words: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % 2 ** 64, *words]))


def make_subject(spec: dict, volume, seed: int,
                 index: int) -> Tuple[np.ndarray, np.ndarray]:
    """Subject ``index`` of ``seed``: (input (X, Y, Z, 1) float32, labels
    (X, Y, Z) int64)."""
    ext = np.asarray(volume, dtype=np.float64)
    n_labels = int(spec["labels"])
    folds = int(spec["folds_per_label"])
    points = int(spec["points_per_fold"])
    anatomy = np.random.default_rng(int(spec["anatomy_seed"])).uniform(
        0.15, 0.85, size=(n_labels, 3)) * ext
    rng = _rng(seed, index)
    nf = n_labels * folds
    starts = np.repeat(anatomy, folds, 0) + rng.normal(
        0.0, 1.0, size=(nf, 3)) * ext * float(spec["jitter"])
    starts = np.clip(np.round(starts), 4, ext - 5)
    steps = rng.integers(-1, 2, size=(nf, points, 3))
    pts = np.clip(np.cumsum(steps, 1) + starts[:, None], 0, ext - 1)
    pts = pts.astype(np.int64).reshape(-1, 3)
    lab = np.repeat(np.arange(n_labels, dtype=np.int64), folds * points)
    shape = tuple(int(v) for v in volume)
    flat = np.ravel_multi_index(pts.T, shape)
    # the last point written to a voxel gives its label
    uniq, first_rev = np.unique(flat[::-1], return_index=True)
    last = len(flat) - 1 - first_rev
    x = np.zeros(int(np.prod(shape)), np.float32)
    y = np.full(int(np.prod(shape)), BACKGROUND, np.int64)
    x[uniq] = 1.0
    y[uniq] = lab[last]
    return x.reshape(*shape, 1), y.reshape(shape)


def make_pool(spec: dict, volume, seed: int,
              size: int) -> Tuple[np.ndarray, np.ndarray]:
    """``size`` distinct subjects of ``seed``: (N, X, Y, Z, 1) float32 and
    (N, X, Y, Z) int64."""
    subjects = [make_subject(spec, volume, seed, i) for i in range(size)]
    return (np.stack([s[0] for s in subjects]),
            np.stack([s[1] for s in subjects]))
