"""The port's native host runtime: the C++ voxelizer
(``runtime/voxelize.cpp``, the port's own source) bound with ``ctypes``.

At first use the source is compiled by ``g++ -O3 -shared -fPIC
-ffp-contract=off`` into ``build/runtime/libunetsulc_runtime-<hash>.so``
beside the package, keyed by a hash of the source and the flags, under a
lock: fold threads and prefetch threads may ask for it at once. Nothing is
built when the package is imported. A failed build raises with the
compiler's output; there is no silent fallback (the numpy voxelizer is
``data.voxelize.voxelize(..., use_native=False)``, for a caller that asks
for it).

``ctypes`` releases the GIL for the foreign call, so a scatter in the
prefetch thread overlaps the main thread's step dispatch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "voxelize.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "runtime"
# the compiler; ``CXX`` in the environment overrides it
CXX = os.environ.get("CXX", "g++")
# no FMA contraction: the affine keeps numpy's rounding
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-ffp-contract=off")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_ARGTYPES = [
    _i64p,            # bck (n, 3)
    ctypes.c_void_p,  # affine: 12 doubles or NULL
    _i32p,            # labels (n,)
    ctypes.c_int64,   # n
    ctypes.c_int64,   # sx
    ctypes.c_int64,   # sy
    ctypes.c_int64,   # sz
    ctypes.c_int32,   # background
    ctypes.POINTER(ctypes.c_float),  # vol_in
    _i32p,            # vol_lb
    _i64p,            # out_coords (n, 3) scratch
]


def library_path() -> Path:
    digest = hashlib.sha1(
        SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libunetsulc_runtime-{digest}.so"


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"runtime build failed: cannot run {CXX!r}: {e}")
    if proc.returncode:
        raise RuntimeError(
            f"runtime build failed: {CXX} exited {proc.returncode}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def get_lib() -> ctypes.CDLL:
    """The voxelizer's library, built and loaded at its first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            lib.unetsulc_voxelize.restype = ctypes.c_int64
            lib.unetsulc_voxelize.argtypes = _ARGTYPES
            _lib = lib
    return _lib


def voxelize_native(
    bck2: np.ndarray,
    label_ids: np.ndarray,
    img_size: Sequence[int],
    affine: Optional[np.ndarray] = None,
    background: int = -1,
) -> Tuple[np.ndarray, np.ndarray]:
    """``(vol_in (X, Y, Z, 1) f32, vol_lb (X, Y, Z) i32)`` as
    :func:`unetsulc_tpu_torch.data.voxelize.voxelize` gives them, in one C++
    pass. ``affine``: an optional 3x4 transform applied to each point with
    truncation toward zero, the cloud then re-translated to the origin
    (``data.geometry.augment_points``' rotation). Points out of bounds are
    skipped; a later point wins a voxel."""
    lib = get_lib()
    bck = np.ascontiguousarray(bck2, dtype=np.int64).reshape(-1, 3)
    labels = np.ascontiguousarray(label_ids, dtype=np.int32).reshape(-1)
    n = len(bck)
    if len(labels) != n:
        raise ValueError(f"{n} points and {len(labels)} labels")
    sx, sy, sz = (int(s) for s in img_size)
    vol_in = np.empty((sx, sy, sz, 1), np.float32)
    vol_lb = np.empty((sx, sy, sz), np.int32)
    coords = np.empty((max(n, 1), 3), np.int64)
    aff_ptr = None
    if affine is not None:
        aff = np.ascontiguousarray(affine, dtype=np.float64).reshape(3, 4)
        aff_ptr = aff.ctypes.data_as(ctypes.c_void_p)
    lib.unetsulc_voxelize(
        bck.ctypes.data_as(_i64p), aff_ptr,
        labels.ctypes.data_as(_i32p), n, sx, sy, sz, int(background),
        vol_in.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        vol_lb.ctypes.data_as(_i32p), coords.ctypes.data_as(_i64p))
    return vol_in, vol_lb
