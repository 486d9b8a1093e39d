"""The port's native voxelizer (``unetsulc_tpu_torch.runtime``: its own
``voxelize.cpp``, built with g++ at first use) against the port's numpy
voxelizer and the JAX package's ``runtime.voxelize_native``, bit for bit:
duplicates (a later point wins), points out of bounds, an empty cloud,
the fused affine against ``rotate_points`` + ``voxelize`` (as
``tests/test_runtime.py`` holds the JAX runtime), and four threads at once
against serial calls. A build that fails raises with the compiler's
output."""

import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from unetsulc_tpu import runtime as jax_runtime
from unetsulc_tpu_torch import runtime
from unetsulc_tpu_torch.data.geometry import random_rotation, rotate_points
from unetsulc_tpu_torch.data.voxelize import voxelize
from torch_threads import torch_one_thread  # noqa: F401,E402


def _equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _cloud(seed, n, hi, dup=0):
    r = np.random.default_rng(seed)
    pts = r.integers(0, hi, size=(n, 3))
    labels = r.integers(0, 7, size=n).astype(np.int32)
    if dup:  # the same voxel several times, each with another label
        pts[-dup:] = pts[:dup]
        labels[-dup:] = (labels[:dup] + 1) % 7
    return pts, labels


CASES = {
    "duplicates": (_cloud(0, 600, 12, dup=200), (12, 12, 12)),
    "out_of_bounds": (_cloud(1, 500, 40), (32, 24, 16)),
    "empty": ((np.zeros((0, 3), np.int64), np.zeros(0, np.int32)),
              (5, 6, 7)),
    "flagship_extent": (_cloud(2, 4000, 96, dup=500), (96, 96, 96)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_native_matches_numpy_and_jax(case):
    (pts, labels), size = CASES[case]
    plain = voxelize(pts, labels, img_size=size, use_native=False)
    native = voxelize(pts, labels, img_size=size)
    _equal(native, plain)
    _equal(runtime.voxelize_native(pts, labels, size),
           jax_runtime.voxelize_native(pts, labels, size))
    if case == "duplicates":  # the last point of each voxel wins
        x, y, z = pts[-1]
        assert native[1][x, y, z] == labels[-1]


@pytest.mark.parametrize("background", [-1, 5])
def test_background_fill(background):
    (pts, labels), size = CASES["out_of_bounds"]
    _equal(runtime.voxelize_native(pts, labels, size, background=background),
           voxelize(pts, labels, img_size=size, background=background,
                    use_native=False))


@pytest.mark.parametrize("seed", [1, 4])
def test_fused_affine_matches_rotate_then_voxelize(seed):
    r = np.random.default_rng(seed)
    pts = r.integers(0, 40, size=(300, 3))
    pts -= pts.min(axis=0)
    labels = r.integers(0, 5, size=300).astype(np.int32)
    center = (pts.max(axis=0) - pts.min(axis=0)) / 2
    transrot = random_rotation(center, math.pi / 16,
                               np.random.default_rng(7 + seed))
    ref = rotate_points(pts, transrot)
    ref = ref - ref.min(axis=0)
    plain = voxelize(ref, labels, img_size=(64, 64, 64), use_native=False)
    native = runtime.voxelize_native(pts, labels, (64, 64, 64),
                                     affine=transrot[:3, :])
    _equal(native, plain)
    _equal(native, jax_runtime.voxelize_native(
        pts, labels, (64, 64, 64), affine=transrot[:3, :]))


def test_threads_match_serial_calls():
    clouds = [_cloud(10 + i, 3000, 48, dup=300) for i in range(8)]
    serial = [runtime.voxelize_native(p, lb, (48, 48, 48)) for p, lb in clouds]
    with ThreadPoolExecutor(max_workers=4) as ex:
        threaded = list(ex.map(
            lambda c: runtime.voxelize_native(c[0], c[1], (48, 48, 48)),
            clouds))
    for a, b in zip(threaded, serial):
        _equal(a, b)


def test_failed_build_raises(monkeypatch, tmp_path):
    """A compiler that fails raises RuntimeError with its output; nothing
    falls back to numpy."""
    monkeypatch.setattr(runtime, "CXX", "false")
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(runtime, "_lib", None)
    with pytest.raises(RuntimeError, match="runtime build failed"):
        voxelize(np.zeros((1, 3), np.int64), np.zeros(1, np.int32),
                 img_size=(2, 2, 2))
    assert not list(tmp_path.glob("*.so"))


def test_library_lives_in_the_port():
    """The port builds its own source, into its own build directory."""
    assert runtime.SRC.parent.name == "runtime"
    assert runtime.SRC.parent.parent.name == "unetsulc_tpu_torch"
    assert runtime.library_path().parent == runtime.BUILD_DIR
