"""The port's hand-written CUDA kernels: build, binding, launch wrappers.

Fourteen kernels in eight sources: A ``conv3x3x3_fwd``
(``conv3x3x3_fwd.cu``), C ``conv3x3x3_dx`` (``conv3x3x3_dx.cu``) and D
``conv3x3x3_wgrad`` (``conv3x3x3_wgrad.cu``), all three on ``wgmma``
(``csrc/wgmma.cuh``) with their tile constants, weight packing and plans
mirrored in :mod:`unetsulc_tpu_torch.kernels.layout`, B
``max_pool_buf_fwd``, E ``max_pool_buf_bwd``, and the GroupNorm kernels
``gn_stats``, ``gn_apply``, ``gn_bwd_reduce`` and ``gn_bwd_dx``
(``group_norm.cu``; their one-wave plan mirrored in :mod:`.layout`; for a
volume split along X over shards also ``gn_stats``' sums mode
``gn_stats_sums``, ``gn_finalize`` and ``gn_bwd_dx``'s global-count mode
``gn_bwd_dx_denom``, each counted under its own name),
and the three probe kernels ``mxu_dot``, ``mxu_rdot`` and ``slab_build``
(``mxu_probe.cu``, driven by
:mod:`unetsulc_tpu_torch.tools.mxu_probe`; the two dot kernels on
``wgmma`` too, their plan mirrored in :mod:`.layout`), and the train
step's masked cross-entropy, argmax and confusion counts over the labelled
rows, ``ce_counts_fwd``, with the loss's gradient ``ce_counts_bwd``
(``ce_counts.cu``). A, C and D also
run in a spatial-parallel halo mode on a shard's slab of the volume (:mod:`unetsulc_tpu_torch.parallel`): the
wrappers take the two halo planes and the plane-validity vectors, launch
the mode's own entry point (``conv3x3x3_fwd_halo``, ``conv3x3x3_dx_halo``,
``conv3x3x3_wgrad_halo``) and count it under that name. Each source in
``unetsulc_tpu_torch/csrc/`` has a plain C interface. At
first use, every source whose library is missing is compiled by its own
``nvcc`` process (all started together) for ``sm_90a`` into
``build/kernels/lib<name>-<hash>.so`` beside the package, keyed by a hash
of the source, the shared headers and the flags, and loaded with
``ctypes``. Nothing is built when the package is imported.

Every kernel is deterministic: where blocks share an output (A's and C's
stat sums, D's split-K, E's d(affine), ``ce_counts_fwd``'s NLL), each
block writes its partials to
an f32 workspace that the wrapper allocates, and a fold adds them up in a
fixed order (``csrc/fold.cuh``); no kernel adds floats with atomics, so a
training step gives the same result in every run.

The wrappers below take CUDA tensors only: they check device, dtype, shape,
contiguity and alignment, allocate the outputs, launch on the current
stream, raise if ``cudaGetLastError()`` reports a failure, and add one to
their entry of :data:`launch_counts` (a train step replayed from CUDA
graphs adds the launches its capture counted: :func:`add_launches`). The plain PyTorch version of each
kernel lives beside its caller in :mod:`unetsulc_tpu_torch.ops.conv_fused`,
:mod:`unetsulc_tpu_torch.ops.groupnorm` or
:mod:`unetsulc_tpu_torch.ops.losses`, which take it for CPU tensors only.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch

from . import layout
from .layout import (  # noqa: F401
    mirror_transpose, pack_conv_weights, pack_conv_weights_dx)

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# library name -> source; each library is one nvcc build
SOURCES = {
    "conv3x3x3_fwd": "conv3x3x3_fwd.cu",
    "conv3x3x3_dx": "conv3x3x3_dx.cu",
    "conv3x3x3_wgrad": "conv3x3x3_wgrad.cu",
    "max_pool_buf_fwd": "max_pool_buf_fwd.cu",
    "max_pool_buf_bwd": "max_pool_buf_bwd.cu",
    "group_norm": "group_norm.cu",
    "mxu_probe": "mxu_probe.cu",
    "ce_counts": "ce_counts.cu",
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# kernel (C entry point) -> (library, argtypes)
KERNELS = {
    # kernel A. x1, ab1, c1, x2, ab2, c2, n_inputs, w, npad, bias, cout,
    # X, Y, Z, y, sums, ws, stream
    "conv3x3x3_fwd": ("conv3x3x3_fwd", [_P, _P, _I, _P, _P, _I, _I, _P, _I,
                                        _P, _I, _I, _I, _I, _P, _P, _P, _P]),
    # kernel C. dconv, c, w, npad, post_a, post_x, cout, X, Y, Z, dx, sums,
    # ws, stream
    "conv3x3x3_dx": ("conv3x3x3_dx", [_P, _I, _P, _I, _P, _P, _I, _I, _I,
                                       _I, _P, _P, _P, _P]),
    # kernel D. x, ab, cin, dconv, cout, X, Y, Z, dw, ws, stream
    "conv3x3x3_wgrad": ("conv3x3x3_wgrad", [_P, _P, _I, _P, _I, _I, _I, _I,
                                            _P, _P, _P]),
    # kernel A, halo mode. x1, ab1, c1, lo1, hi1, v1, x2, ab2, c2, lo2, hi2,
    # v2, n_inputs, w, npad, bias, cout, X, Y, Z, valid_out, y, sums, ws,
    # stream
    "conv3x3x3_fwd_halo": ("conv3x3x3_fwd", [_P, _P, _I, _P, _P, _P, _P, _P,
                                             _I, _P, _P, _P, _I, _P, _I, _P,
                                             _I, _I, _I, _I, _P, _P, _P, _P,
                                             _P]),
    # kernel C, halo (edge_outputs) mode. dconv, c, w, npad, post_a, post_x,
    # post_lo, post_hi, valid, cout, X, Y, Z, dx, dlo, dhi, sums, ws, stream
    "conv3x3x3_dx_halo": ("conv3x3x3_dx", [_P, _I, _P, _I, _P, _P, _P, _P,
                                            _P, _I, _I, _I, _I, _P, _P, _P,
                                            _P, _P, _P]),
    # kernel D, halo mode. x, lo, hi, valid, ab, cin, dconv, cout, X, Y, Z,
    # dw, ws, stream
    "conv3x3x3_wgrad_halo": ("conv3x3x3_wgrad", [_P, _P, _P, _P, _P, _I, _P,
                                                 _I, _I, _I, _I, _P, _P, _P]),
    # kernel B. x, ab, c, X, Y, Z, y, stream
    "max_pool_buf_fwd": ("max_pool_buf_fwd", [_P, _P, _I, _I, _I, _I, _P,
                                              _P]),
    # kernel E. x, ab, out, cot, c, X, Y, Z, sms, dx, dab, ws, stream
    "max_pool_buf_bwd": ("max_pool_buf_bwd", [_P, _P, _P, _P, _I, _I, _I,
                                              _I, _I, _P, _P, _P, _P]),
    # GroupNorm. x, dtype, n, s, c, groups, eps, sms, partial, counter,
    # mean, inv, stream
    "gn_stats": ("group_norm", [_P, _I, _I, _L, _I, _I, _F, _I, _P, _P, _P,
                                _P, _P]),
    # x, dtype, n, s, c, groups, mean, inv, scale, bias, sms, out, stream
    "gn_apply": ("group_norm", [_P, _I, _I, _L, _I, _I, _P, _P, _P, _P, _I,
                                _P, _P]),
    # x, g, dtype, n, s, c, groups, mean, inv, scale, sms, partial,
    # counter, dscale, dbias, sdx, sdxx, stream
    "gn_bwd_reduce": ("group_norm", [_P, _P, _I, _I, _L, _I, _I, _P, _P, _P,
                                     _I, _P, _P, _P, _P, _P, _P, _P]),
    # x, g, dtype, n, s, c, groups, mean, inv, scale, sdx, sdxx, sms, dx,
    # stream
    "gn_bwd_dx": ("group_norm", [_P, _P, _I, _I, _L, _I, _I, _P, _P, _P, _P,
                                 _P, _I, _P, _P]),
    # the sharded GroupNorm. x, dtype, n, s, c, groups, sms, partial,
    # counter, sum, sq, stream
    "gn_stats_sums": ("group_norm", [_P, _I, _I, _L, _I, _I, _I, _P, _P, _P,
                                     _P, _P]),
    # sum, sq, units, count, eps, mean, inv, stream
    "gn_finalize": ("group_norm", [_P, _P, _I, _L, _F, _P, _P, _P]),
    # x, g, dtype, n, s, c, groups, mean, inv, scale, sdx, sdxx, count, sms,
    # dx, stream
    "gn_bwd_dx_denom": ("group_norm", [_P, _P, _I, _I, _L, _I, _I, _P, _P, _P,
                                       _P, _P, _L, _I, _P, _P]),
    # the probe. k, n, ps, reps, o, stream
    "mxu_dot": ("mxu_probe", [_I, _I, _I, _I, _P, _P]),
    # m, n, ps, reps, o, stream
    "mxu_rdot": ("mxu_probe", [_I, _I, _I, _I, _P, _P]),
    # cs, copies, ps, reps, o, slab_out, stream
    "slab_build": ("mxu_probe", [_I, _I, _I, _I, _P, _P, _P]),
    # the train step's loss and counts. logits, labels, rows, c, k,
    # background, sms, out, hist, counts, stream
    "ce_counts_fwd": ("ce_counts", [_P, _P, _L, _I, _I, _L, _I, _P, _P, _P,
                                    _P]),
    # logits, labels, rows, c, background, grad, sms, dx, stream
    "ce_counts_bwd": ("ce_counts", [_P, _P, _L, _I, _L, _P, _I, _P, _P]),
}
# helper (not a kernel) -> (library, argtypes); each returns an int
HELPERS = {
    # f32 workspace of one launch (-1: too large). cout, X, Y, Z
    "conv3x3x3_fwd_ws": ("conv3x3x3_fwd", [_I, _I, _I, _I]),
    # cout, X, Y, Z, edge
    "conv3x3x3_dx_ws": ("conv3x3x3_dx", [_I, _I, _I, _I, _I]),
    # cin, cout, X, Y, Z
    "conv3x3x3_wgrad_ws": ("conv3x3x3_wgrad", [_I, _I, _I, _I, _I]),
    # tile constants that kernels/layout.py mirrors. what, cout, X, Y, Z
    "conv3x3x3_fwd_tile": ("conv3x3x3_fwd", [_I, _I, _I, _I, _I]),
    # what, cout, X, Y, Z, edge
    "conv3x3x3_dx_tile": ("conv3x3x3_dx", [_I, _I, _I, _I, _I, _I]),
    # what, Z
    "conv3x3x3_wgrad_tile": ("conv3x3x3_wgrad", [_I, _I]),
    # kernel E's plan that kernels/layout.py mirrors. what, c, X, Y, Z, sms
    "max_pool_buf_bwd_tile": ("max_pool_buf_bwd", [_I, _I, _I, _I, _I, _I]),
    # the GroupNorm kernels' plan that kernels/layout.py mirrors. what, n,
    # s, c, groups, dtype, sms
    "gn_tile": ("group_norm", [_I, _I, _L, _I, _I, _I, _I]),
    # the probe kernels' plan that kernels/layout.py mirrors. what, k (m,
    # cs), n (copies), ps, reps, sms
    "mxu_probe_tile": ("mxu_probe", [_I, _I, _I, _I, _I, _I]),
    # f32 elements of ce_counts_fwd's out (the NLL, then the blocks'
    # partials). rows, sms
    "ce_counts_fwd_ws": ("ce_counts", [_L, _I]),
}

# launches of each kernel since the last reset_launch_counts(): each
# wrapper adds one where it launches its kernel, and nowhere else
launch_counts: Dict[str, int] = {name: 0 for name in KERNELS}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


_count_lock = threading.Lock()
# CUDA-graph captures in progress: the capture stream's handle -> the
# launches made on it (a graph's launches are counted once, at capture,
# and added again at each replay: ``train/graphs.py``)
_recording: Dict[int, Dict[str, int]] = {}


def reset_launch_counts() -> None:
    with _count_lock:
        for name in launch_counts:
            launch_counts[name] = 0


def _count(name: str) -> None:
    """One launch of ``name``; fold threads launch kernels concurrently.
    During a capture, the launch made on the capture's stream (from the
    capturing thread or autograd's) is also the capture's."""
    with _count_lock:
        launch_counts[name] += 1
        if _recording:
            rec = _recording.get(torch.cuda.current_stream().cuda_stream)
            if rec is not None:
                rec[name] = rec.get(name, 0) + 1


@contextlib.contextmanager
def recording_launches(stream):
    """The launches made on ``stream`` while the block runs, as a dict
    that fills in as they are made."""
    rec: Dict[str, int] = {}
    with _count_lock:
        _recording[stream.cuda_stream] = rec
    try:
        yield rec
    finally:
        with _count_lock:
            del _recording[stream.cuda_stream]


def add_launches(counts: Dict[str, int]) -> None:
    """Add ``counts`` to :data:`launch_counts`: a replayed graph's launches,
    which no wrapper counts."""
    with _count_lock:
        for name, n in counts.items():
            launch_counts[name] += n


def _nvcc() -> str:
    cands = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    if os.environ.get("CUDA_HOME"):
        cands.insert(0, os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_paths() -> Dict[str, Path]:
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    out = {}
    for name, src in SOURCES.items():
        digest = hashlib.sha1(
            (CSRC / src).read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        out[name] = BUILD_DIR / f"lib{name}-{digest}.so"
    return out


def build(ptxas_verbose: bool = False) -> Dict[str, str]:
    """Compile every kernel library that is missing, one ``nvcc`` per
    source, all started together. Returns each compiled source's compiler
    output (empty for a library that was already built); raises with the
    compiler's output if any build fails."""
    logs = {}
    with _lock:
        todo = {n: p for n, p in library_paths().items() if not p.exists()}
        if not todo:
            return logs
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name, out in todo.items():
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
            if ptxas_verbose:
                cmd[1:1] = ["-Xptxas", "-v"]
            procs[name] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True),
                tmp, out,
            )
        errors = []
        for name, (proc, tmp, out) in procs.items():
            logs[name], _ = proc.communicate()
            if proc.returncode:
                errors.append(f"{name}: nvcc exited {proc.returncode}\n"
                              f"{logs[name]}")
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return logs


def _lib(name: str) -> ctypes.CDLL:
    """Library ``name``, built and loaded at its first use, with the
    argument types of each of its kernels set."""
    lib = _libs.get(name)
    if lib is None:
        build()
        lib = ctypes.CDLL(str(library_paths()[name]))
        for kernel, (libname, argtypes) in {**KERNELS, **HELPERS}.items():
            if libname == name:
                fn = getattr(lib, kernel)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _check_tiles(name, lib)
        _libs[name] = lib
    return lib


# (n, s, c, groups, dtype) of the GroupNorm plans compared at load: the
# flagship non-fused model's slabs at batch 1 and 2, one in f32, one whose
# rows are not whole 16-byte vectors, and the widest rows taken
GN_PLAN_SLABS = tuple(
    (n, e ** 3, c, 32, 0) for n in (1, 2)
    for e, c in ((96, 32), (96, 64), (49, 64), (49, 128), (25, 128),
                 (25, 256), (13, 256), (13, 512))
) + ((1, 49 ** 3, 128, 32, 1), (2, 9 * 7 * 5, 36, 12, 0), (3, 5, 2048, 1, 0))


# (c, X, Y, Z) of kernel E's plans compared at load: the flagship's three
# pools, odd extents, channel tails and the widest rows taken
POOL_PLAN_SHAPES = ((64, 96, 96, 96), (128, 49, 49, 49), (256, 25, 25, 25),
                    (12, 9, 8, 11), (10, 7, 9, 5), (36, 3, 1, 2),
                    (2048, 5, 4, 3))


def _check_tiles(name: str, lib: ctypes.CDLL) -> None:
    """Raise if a library's exported tile constants differ from the ones
    that :mod:`.layout` packs and plans with."""
    # the flagship's levels, whole and in slabs, and a very deep Z
    extents = ((96, 96, 96), (49, 49, 49), (25, 25, 25), (13, 13, 13),
               (48, 96, 96), (13, 49, 49), (6, 7, 320))
    couts = (8, 32, 64, 128, 512)
    if name == "conv3x3x3_fwd":
        want = {(0, 1, 1, 1, 1): layout.TILE_K, (1, 1, 1, 1, 1): layout.STAGES}
        want.update({(2, c, 1, 1, 1): layout.tile_n(c)
                     for c in (1, 12, 32, 33, 64, 65, 128, 512)})
        for c in couts:
            for x, y, z in extents:
                want[(3, c, x, y, z)] = layout.fwd_rows_per_block(c, x, y, z)
                want[(4, c, x, y, z)] = layout.fwd_dy_group(c, x, y, z)
        got = {k: lib.conv3x3x3_fwd_tile(*k) for k in want}
    elif name == "conv3x3x3_dx":
        want = {(0, 1, 1, 1, 1, 0): layout.TILE_K,
                (1, 1, 1, 1, 1, 0): layout.STAGES}
        want.update({(2, c, 1, 1, 1, 0): layout.tile_n(c)
                     for c in (1, 12, 32, 33, 64, 65, 128, 512)})
        want.update({(3, c, x, y, z, e): layout.dx_rows_per_block(
            c, x, y, z, bool(e)) for c in couts for x, y, z in extents
            for e in (0, 1)})
        got = {k: lib.conv3x3x3_dx_tile(*k) for k in want}
    elif name == "conv3x3x3_wgrad":
        want = {(0, 1): layout.WGRAD_TILE_CI, (1, 1): layout.WGRAD_TILE_CO,
                (3, 1): layout.WGRAD_TAP_GROUPS,
                (4, 1): layout.WGRAD_TARGET_BLOCKS,
                (5, 1): layout.WGRAD_MIN_STEPS}
        # the step, the ring's stages and the runs per stage across the
        # depths that change them
        for z in (13, 41, 42, 96, 189, 190, 317, 318, 320, 512):
            want[(2, z)] = layout.wgrad_step(z)
            want[(6, z)] = layout.wgrad_stages(z)
            want[(7, z)] = layout.wgrad_runs(z)
        got = {k: lib.conv3x3x3_wgrad_tile(*k) for k in want}
    elif name == "max_pool_buf_bwd":
        want = {(0, 1, 1, 1, 1, 1): layout.POOL_BWD_THREADS,
                (1, 1, 1, 1, 1, 1): layout.POOL_BWD_BLOCKS_PER_SM,
                (2, 1, 1, 1, 1, 1): layout.POOL_BWD_FOLD_COLS,
                (3, 1, 1, 1, 1, 1): layout.POOL_BWD_FOLD_BATCH}
        for k in POOL_PLAN_SHAPES:
            for sms in (132, 7):
                for what, v in zip((4, 5, 6), layout.pool_bwd_plan(*k, sms)):
                    want[(what, *k, sms)] = v
                want[(7, *k, sms)] = layout.pool_bwd_workspace(*k, sms)
        got = {k: lib.max_pool_buf_bwd_tile(*k) for k in want}
    elif name == "mxu_probe":
        want = {(0, 0, 64, 1, 1, 1): layout.PROBE_BLOCKS_PER_SM,
                (1, 0, 64, 1, 1, 1): layout.PROBE_DOT_ROWS,
                (2, 0, 64, 1, 1, 1): layout.PROBE_RDOT_CHUNK,
                (8, 0, 64, 1, 1, 1): layout.PROBE_BUILD_STRIPS,
                (9, 0, 64, 1, 1, 1): layout.PROBE_BUILD_SEG,
                (10, 0, 64, 1, 1, 1): layout.PROBE_BUILD_ROWS,
                (11, 0, 64, 1, 1, 1): layout.PROBE_BUILD_MIN_STRIP}
        want.update({(3, 0, n, 1, 1, 1): layout.probe_tile_n(n)
                     for n in (64, 128, 192, 256, 320, 384, 576)})
        # the probe's shapes and small ones, on an H100's SMs and on few
        for sms in (132, 7):
            for ps, reps in ((10976, 200), (40, 2), (200, 3)):
                for a, n in ((192, 64), (192, 128), (384, 384), (1152, 128),
                             (64, 192), (192, 576)):
                    blocks, items = layout.dot_plan(a, n, ps, reps, sms)
                    want[(4, a, n, ps, reps, sms)] = items
                    want[(6, a, n, ps, reps, sms)] = blocks
                    blocks, items, _ = layout.rdot_plan(a, n, ps, reps, sms)
                    want[(5, a, n, ps, reps, sms)] = items
                    want[(7, a, n, ps, reps, sms)] = blocks
                # slab_build: the probe's combinations, a narrow plane and
                # a row too wide for shared memory
                for cs, copies in ((64, 1), (64, 3), (64, 9), (128, 1),
                                   (128, 3), (128, 9), (8, 2), (2048, 1),
                                   (8192, 16)):
                    for what, v in zip((12, 13, 14, 15),
                                       layout.build_plan(cs, copies, ps, sms)):
                        want[(what, cs, copies, ps, reps, sms)] = v
        got = {k: lib.mxu_probe_tile(*k) for k in want}
    elif name == "group_norm":
        want = {(0, 1, 1, 1, 1, 0, 1): layout.GN_THREADS,
                (1, 1, 1, 1, 1, 0, 1): layout.GN_REDUCE_STAGES,
                (2, 1, 1, 1, 1, 0, 1): layout.GN_REDUCE_SWEEPS,
                (3, 1, 1, 1, 1, 0, 1): layout.GN_REDUCE_BLOCKS_PER_SM,
                (4, 1, 1, 1, 1, 0, 1): layout.GN_DX_BLOCKS_PER_SM,
                (5, 1, 1, 1, 1, 0, 1): layout.GN_DX_UNROLL,
                (6, 1, 1, 1, 1, 0, 1): layout.GN_STAGE_BYTES}
        for n, s, c, groups, dtype in GN_PLAN_SLABS:
            for sms in (132, 7):
                k = (n, s, c, groups, dtype, sms)
                for what, v in zip((7, 8, 9, 10), layout.gn_reduce_plan(*k)):
                    want[(what, *k)] = v
                want[(11, *k)] = layout.gn_dx_blocks(n, s, sms)
                for what, v in zip((12, 13, 14, 15), layout.gn_stats_plan(*k)):
                    want[(what, *k)] = v
        got = {k: lib.gn_tile(*k) for k in want}
    else:
        return
    if got != want:
        raise RuntimeError(f"lib{name}'s tile constants {got} differ from "
                           f"kernels/layout.py's {want}")


def _kernel(name: str):
    """The C entry point of kernel ``name``."""
    return getattr(_lib(KERNELS[name][0]), name)


def _workspace(helper: str, *dims: int, device) -> torch.Tensor:
    """The f32 workspace that ``helper`` sizes for one launch: where the
    kernel's blocks write their partial sums before the fold."""
    n = getattr(_lib(HELPERS[helper][0]), helper)(*dims)
    if n < 0:
        raise ValueError(f"{helper}{dims}: workspace too large")
    return torch.empty(max(n, 1), dtype=torch.float32, device=device)


def _check_buffer(t: torch.Tensor, what: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{what} must be bfloat16, got {t.dtype}")
    if t.dim() != 4 or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous (Xp, Yp, Zp, C) "
                         f"buffer, got shape {tuple(t.shape)}")
    if min(t.shape[:3]) < 3:
        raise ValueError(f"{what} has no interior: {tuple(t.shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"{what} must be 16-byte aligned")


def _check_plane(t: torch.Tensor, shape, device, what: str) -> None:
    """A halo plane (Y+2, Z+2, C) bf16 on ``device``: contiguous, and
    16-byte aligned where the kernels read it in 16-byte vectors."""
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{what} must be a CUDA tensor on {device}, got "
                         f"{t.device}")
    if t.dtype != torch.bfloat16 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} must be a bfloat16 {tuple(shape)} plane, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous() or (shape[-1] % 8 == 0 and t.data_ptr() % 16):
        raise ValueError(f"{what} must be contiguous and 16-byte aligned")


def _check_valid(v: torch.Tensor, xp: int, device, what: str) -> None:
    if (v.device != device or v.dtype != torch.float32
            or tuple(v.shape) != (xp,) or not v.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous float32 ({xp},) tensor "
                         f"on {device}, got {v.dtype} {tuple(v.shape)} on "
                         f"{v.device}")


def _halo_ptrs(halo, valid, buf: torch.Tensor, what: str):
    """(lo, hi, valid) pointers of one input's halo: ``halo`` = (lo, hi),
    each a (Y+2, Z+2, C) plane or None where ``valid`` marks it invalid;
    ``valid`` the (X+2,) plane validity."""
    xp, yp, zp, c = (int(v) for v in buf.shape)
    _check_valid(valid, xp, buf.device, f"{what} valid")
    if halo is None or len(halo) != 2:
        raise ValueError(f"{what}: halo mode takes a (lo, hi) pair of planes")
    lo, hi = halo
    for t, side in ((lo, "lo"), (hi, "hi")):
        if t is not None:
            _check_plane(t, (yp, zp, c), buf.device, f"{what} halo {side}")
    return (None if lo is None else lo.data_ptr(),
            None if hi is None else hi.data_ptr(), valid.data_ptr())


def _check_affine(ab: torch.Tensor, c: int, device, what: str) -> None:
    if ab.device != device or ab.dtype != torch.float32:
        raise ValueError(f"{what} must be float32 on {device}")
    if tuple(ab.shape) != (2, c) or not ab.is_contiguous():
        raise ValueError(f"{what} must be a contiguous (2, {c}) tensor, "
                         f"got {tuple(ab.shape)}")


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def conv3x3x3_fwd(
    xs: Sequence[torch.Tensor],
    abs_: Sequence[torch.Tensor],
    weight: torch.Tensor,
    bias: torch.Tensor,
    packed: Optional[torch.Tensor] = None,
    halos=None,
    valids: Optional[Sequence[torch.Tensor]] = None,
    valid_out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel A: relu(conv3x3x3(concat_i(mask * (a_i * x_i + b_i)), W) +
    bias) with per-channel stat sums, on padded bf16 buffers.

    xs: one or two (Xp, Yp, Zp, C_i) bf16 buffers of one geometry; abs_:
    their (2, C_i) f32 affines; weight: (Cout, sum C_i, 3, 3, 3); bias:
    (Cout,) f32; packed: ``pack_conv_weights(weight, C_i)``, packed here
    when None. Returns (y (Xp, Yp, Zp, Cout) bf16 with a zero ring, sums
    (2, Cout) f32).

    Halo mode (``valids`` given, launched as ``conv3x3x3_fwd_halo``): input
    i's planes 0 and Xp-1 are ``halos[i]`` = (lo, hi), (Yp, Zp, C_i) bf16
    planes (None where invalid), read only where ``valids[i]`` ((Xp,) f32)
    is nonzero; output planes where ``valid_out`` ((Xp,) f32, optional) is
    0 are written as 0 and left out of the sums."""
    if len(xs) not in (1, 2) or len(abs_) != len(xs):
        raise ValueError("conv3x3x3_fwd takes one or two inputs with affines")
    halo = valids is not None
    if halo and (halos is None or len(halos) != len(xs) or len(valids) != len(xs)):
        raise ValueError("halo mode takes one (lo, hi) pair and one valid "
                         "vector per input")
    if valid_out is not None and not halo:
        raise ValueError("valid_out needs halo mode")
    x1 = xs[0]
    for i, (x, ab) in enumerate(zip(xs, abs_)):
        _check_buffer(x, f"input {i}")
        if x.shape[:3] != x1.shape[:3] or x.device != x1.device:
            raise ValueError("inputs differ in geometry or device")
        _check_affine(ab, int(x.shape[3]), x.device, f"affine {i}")
    cins = [int(x.shape[3]) for x in xs]
    cout = int(weight.shape[0])
    if (bias.device != x1.device or bias.dtype != torch.float32
            or tuple(bias.shape) != (cout,) or not bias.is_contiguous()):
        raise ValueError(f"bias must be a contiguous float32 ({cout},) "
                         f"tensor on {x1.device}")
    if weight.device != x1.device:
        raise ValueError(f"weight must be on {x1.device}")
    if packed is None:
        packed = pack_conv_weights(weight, cins)
    shape = layout.fwd_packed_shape(cins, cout)
    if (packed.device != x1.device or packed.dtype != torch.bfloat16
            or tuple(packed.shape) != shape or not packed.is_contiguous()):
        raise ValueError(f"packed weight must be a contiguous bfloat16 "
                         f"{shape} tensor on {x1.device}")
    w = packed
    xp, yp, zp = (int(v) for v in x1.shape[:3])
    y = torch.zeros((xp, yp, zp, cout), dtype=torch.bfloat16, device=x1.device)
    sums = torch.zeros((2, cout), dtype=torch.float32, device=x1.device)
    ws = _workspace("conv3x3x3_fwd_ws", cout, xp - 2, yp - 2, zp - 2,
                    device=x1.device)
    x2, ab2 = (xs[1], abs_[1]) if len(xs) == 2 else (x1, abs_[0])
    stream = torch.cuda.current_stream(x1.device).cuda_stream
    if halo:
        name = "conv3x3x3_fwd_halo"
        h = [_halo_ptrs(hl, v, x, f"input {i}")
             for i, (x, hl, v) in enumerate(zip(xs, halos, valids))]
        h2 = h[1] if len(xs) == 2 else h[0]
        if valid_out is not None:
            _check_valid(valid_out, xp, x1.device, "valid_out")
        args = (x1.data_ptr(), abs_[0].data_ptr(), cins[0], *h[0],
                x2.data_ptr(), ab2.data_ptr(), int(x2.shape[3]), *h2, len(xs),
                w.data_ptr(), int(w.shape[1]), bias.data_ptr(), cout,
                xp - 2, yp - 2, zp - 2,
                None if valid_out is None else valid_out.data_ptr(),
                y.data_ptr(), sums.data_ptr(), ws.data_ptr(), stream)
    else:
        name = "conv3x3x3_fwd"
        args = (x1.data_ptr(), abs_[0].data_ptr(), cins[0],
                x2.data_ptr(), ab2.data_ptr(), int(x2.shape[3]), len(xs),
                w.data_ptr(), int(w.shape[1]), bias.data_ptr(), cout,
                xp - 2, yp - 2, zp - 2, y.data_ptr(), sums.data_ptr(),
                ws.data_ptr(), stream)
    fn = _kernel(name)
    with torch.cuda.device(x1.device):
        err = fn(*args)
    _raise_on(err, name)
    _count(name)
    return y, sums


def max_pool_buf_fwd(buf: torch.Tensor, ab: Optional[torch.Tensor]) -> torch.Tensor:
    """Kernel B: torch-padded 2x2x2 / stride-2 max pool of the normalized
    buffer bf16(a * x + b), pad positions at -inf, into a zero-ringed
    buffer of interior extent X//2 + 1 per axis."""
    _check_buffer(buf, "pool input")
    c = int(buf.shape[3])
    if ab is not None:
        _check_affine(ab, c, buf.device, "pool affine")
    x, y, z = (int(v) - 2 for v in buf.shape[:3])
    out = torch.zeros(
        (x // 2 + 3, y // 2 + 3, z // 2 + 3, c), dtype=buf.dtype,
        device=buf.device,
    )
    fn = _kernel("max_pool_buf_fwd")
    with torch.cuda.device(buf.device):
        err = fn(
            buf.data_ptr(), None if ab is None else ab.data_ptr(), c, x, y, z,
            out.data_ptr(), torch.cuda.current_stream(buf.device).cuda_stream,
        )
    _raise_on(err, "max_pool_buf_fwd")
    _count("max_pool_buf_fwd")
    return out


def conv3x3x3_dx(
    dconv: torch.Tensor,
    post_ab: torch.Tensor,
    post_x: torch.Tensor,
    packed: torch.Tensor,
    post_halo=None,
    valid: Optional[torch.Tensor] = None,
):
    """Kernel C: one input branch's gradients through the fused conv block.

    dconv: (Xp, Yp, Zp, Cout) bf16, the conv's cotangent, exactly 0 on the
    ring; post_ab: the branch's (2, Cin) f32 forward affine; post_x: its
    (Xp, Yp, Zp, Cin) bf16 forward input; packed:
    ``pack_conv_weights_dx(weight, cins, branch)``. Returns (dx (Xp, Yp,
    Zp, Cin) bf16 = bf16(dxn * a) with a zero ring, sums (2, Cin) f32 =
    (sum post_x * dxn, sum dxn) over the interior), where dxn is the
    transposed conv of dconv with the branch's weights.

    Halo mode (``valid`` given, launched as ``conv3x3x3_dx_halo``): the
    forward read post_x's planes 0 and Xp-1 from ``post_halo`` = (lo, hi)
    under ``valid`` ((Xp,) f32). dxn is also computed at those two planes,
    the sums weigh every plane by ``valid`` and dx is 0 where it is 0.
    Returns (dx with zero ring planes, sums, dlo, dhi): dlo and dhi
    (Yp, Zp, Cin) bf16 are the gradients of the two halo planes."""
    _check_buffer(dconv, "dconv")
    _check_buffer(post_x, "post_x")
    if post_x.shape[:3] != dconv.shape[:3] or post_x.device != dconv.device:
        raise ValueError("dconv and post_x differ in geometry or device")
    c, cin = int(dconv.shape[3]), int(post_x.shape[3])
    _check_affine(post_ab, cin, dconv.device, "post affine")
    shape = layout.dx_packed_shape(c, cin)
    if (packed.device != dconv.device or packed.dtype != torch.bfloat16
            or tuple(packed.shape) != shape or not packed.is_contiguous()):
        raise ValueError(f"packed dx weight must be a contiguous bfloat16 "
                         f"{shape} tensor on {dconv.device}")
    xp, yp, zp = (int(v) for v in dconv.shape[:3])
    dx = torch.zeros((xp, yp, zp, cin), dtype=torch.bfloat16,
                     device=dconv.device)
    sums = torch.zeros((2, cin), dtype=torch.float32, device=dconv.device)
    ws = _workspace("conv3x3x3_dx_ws", cin, xp - 2, yp - 2, zp - 2,
                    int(valid is not None), device=dconv.device)
    stream = torch.cuda.current_stream(dconv.device).cuda_stream
    if valid is not None:
        name = "conv3x3x3_dx_halo"
        ptrs = _halo_ptrs(post_halo, valid, post_x, "post_x")
        dlo, dhi = (torch.zeros((yp, zp, cin), dtype=torch.bfloat16,
                                device=dconv.device) for _ in range(2))
        args = (dconv.data_ptr(), c, packed.data_ptr(), int(packed.shape[1]),
                post_ab.data_ptr(), post_x.data_ptr(), *ptrs, cin, xp - 2,
                yp - 2, zp - 2, dx.data_ptr(), dlo.data_ptr(), dhi.data_ptr(),
                sums.data_ptr(), ws.data_ptr(), stream)
    else:
        name = "conv3x3x3_dx"
        args = (dconv.data_ptr(), c, packed.data_ptr(), int(packed.shape[1]),
                post_ab.data_ptr(), post_x.data_ptr(), cin, xp - 2, yp - 2,
                zp - 2, dx.data_ptr(), sums.data_ptr(), ws.data_ptr(), stream)
    fn = _kernel(name)
    with torch.cuda.device(dconv.device):
        err = fn(*args)
    _raise_on(err, name)
    _count(name)
    return (dx, sums, dlo, dhi) if valid is not None else (dx, sums)


def conv3x3x3_wgrad(x: torch.Tensor, ab: torch.Tensor, dconv: torch.Tensor,
                    halo=None, valid: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Kernel D: one input branch's weight gradient, (27, Cin, Cout) f32,
    dW[tap] = sum over the interior of xn[v + off(tap)]^T dconv[v], with
    xn = mask * bf16(f32(x) * a + b) recomputed from the (Xp, Yp, Zp, Cin)
    bf16 buffer x and its (2, Cin) f32 affine ab; dconv: (Xp, Yp, Zp, Cout)
    bf16, exactly 0 on the ring. The split-K partials are added in a fixed
    order, so the result is the same in every run.

    Halo mode (``valid`` given, launched as ``conv3x3x3_wgrad_halo``): x's
    planes 0 and Xp-1 are ``halo`` = (lo, hi), read under ``valid`` as
    kernel A reads them."""
    _check_buffer(x, "wgrad input")
    _check_buffer(dconv, "dconv")
    if x.shape[:3] != dconv.shape[:3] or x.device != dconv.device:
        raise ValueError("wgrad input and dconv differ in geometry or device")
    cin, cout = int(x.shape[3]), int(dconv.shape[3])
    _check_affine(ab, cin, x.device, "wgrad affine")
    xp, yp, zp = (int(v) for v in x.shape[:3])
    dw = torch.zeros((27, cin, cout), dtype=torch.float32, device=x.device)
    ws = _workspace("conv3x3x3_wgrad_ws", cin, cout, xp - 2, yp - 2, zp - 2,
                    device=x.device)
    tail = (ab.data_ptr(), cin, dconv.data_ptr(), cout, xp - 2, yp - 2,
            zp - 2, dw.data_ptr(), ws.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if valid is not None:
        name = "conv3x3x3_wgrad_halo"
        args = (x.data_ptr(), *_halo_ptrs(halo, valid, x, "wgrad input"), *tail)
    else:
        name = "conv3x3x3_wgrad"
        args = (x.data_ptr(), *tail)
    fn = _kernel(name)
    with torch.cuda.device(x.device):
        err = fn(*args)
    _raise_on(err, name)
    _count(name)
    return dw


def max_pool_buf_bwd(
    buf: torch.Tensor,
    ab: Optional[torch.Tensor],
    out: torch.Tensor,
    cot: torch.Tensor,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Kernel E: the backward of :func:`max_pool_buf_fwd`. buf, ab: the
    forward's input buffer and affine (or None); out: its output; cot:
    out's cotangent (bf16, out's shape). Returns (dbuf, buf's shape, bf16:
    each pooled cotangent at the first window position equal to the max,
    times a; dab (2, C) f32 = (sum x * d, sum d), or None without an
    affine)."""
    _check_buffer(buf, "pool input")
    c = int(buf.shape[3])
    x, y, z = (int(v) - 2 for v in buf.shape[:3])
    pooled = (x // 2 + 3, y // 2 + 3, z // 2 + 3, c)
    for t, what in ((out, "pool output"), (cot, "pool cotangent")):
        _check_buffer(t, what)
        if tuple(t.shape) != pooled or t.device != buf.device:
            raise ValueError(f"{what} must be {pooled} on {buf.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if ab is not None:
        _check_affine(ab, c, buf.device, "pool affine")
    if c > 8 * layout.POOL_BWD_THREADS:
        raise ValueError(f"{c} channels exceed kernel E's "
                         f"{8 * layout.POOL_BWD_THREADS}")
    sms = _sm_count(buf.device)
    # kernel E writes every element of dbuf and dab
    dbuf = torch.empty_like(buf)
    dab = None if ab is None else torch.empty(
        (2, c), dtype=torch.float32, device=buf.device)
    ws = None if ab is None else torch.empty(
        layout.pool_bwd_workspace(c, x, y, z, sms), dtype=torch.float32,
        device=buf.device)
    fn = _kernel("max_pool_buf_bwd")
    with torch.cuda.device(buf.device):
        err = fn(
            buf.data_ptr(), None if ab is None else ab.data_ptr(),
            out.data_ptr(), cot.data_ptr(), c, x, y, z, sms, dbuf.data_ptr(),
            None if dab is None else dab.data_ptr(),
            None if ws is None else ws.data_ptr(),
            torch.cuda.current_stream(buf.device).cuda_stream,
        )
    _raise_on(err, "max_pool_buf_bwd")
    _count("max_pool_buf_bwd")
    return dbuf, dab


# ---------------------------------------------------------------------------
# GroupNorm on a contiguous (N, S, C) slab, bf16 or f32
# ---------------------------------------------------------------------------

_GN_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def _check_slab(t: torch.Tensor, what: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if t.dtype not in _GN_DTYPES:
        raise ValueError(f"{what} must be bfloat16 or float32, got {t.dtype}")
    if t.dim() != 3 or not t.is_contiguous() or min(t.shape) < 1:
        raise ValueError(f"{what} must be a contiguous non-empty (N, S, C) "
                         f"slab, got shape {tuple(t.shape)}")


def _check_f32(t: torch.Tensor, shape, device, what: str) -> None:
    if (t.device != device or t.dtype != torch.float32
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous float32 "
                         f"{tuple(shape)} tensor on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _check_gn(x: torch.Tensor, groups: int, g: Optional[torch.Tensor] = None):
    """(n, s, c, dtype code) of a valid slab ``x`` (and cotangent ``g``)."""
    _check_slab(x, "GroupNorm input")
    n, s, c = (int(v) for v in x.shape)
    if groups < 1 or c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    if -(-c // (16 // x.element_size())) > 256:
        raise ValueError(f"{c} channels exceed the GroupNorm kernels' "
                         f"{256 * 16 // x.element_size()}")
    if g is not None:
        _check_slab(g, "GroupNorm cotangent")
        if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
            raise ValueError("GroupNorm cotangent differs from its input in "
                             "shape, dtype or device")
    return n, s, c, _GN_DTYPES[x.dtype]


def _gn_workspace(kernel: str, n: int, s: int, c: int, groups: int,
                  code: int, sms: int, device):
    """The f32 partial sums (N, Bs, 2, C) and zeroed int32 ticket counter
    of a ``kernel`` launch (gn_stats or gn_bwd_reduce), as its plan on
    ``sms`` SMs sizes them."""
    floats, tickets = layout.gn_workspace(kernel, n, s, c, groups, code, sms)
    return (torch.empty(floats, dtype=torch.float32, device=device),
            torch.zeros(tickets, dtype=torch.int32, device=device))


def gn_stats(x: torch.Tensor, num_groups: int,
             eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel ``gn_stats``: (mean_g, inv_g), each (N, G) f32, of the
    (N, S, C) slab x: mean = sum x / D, inv = rsqrt(sum x^2 / D - mean^2 +
    eps), D = S * C / G. One wave of blocks
    (:func:`.layout.gn_stats_plan`), each writing one partial sum that a
    fixed-order fold adds up: the same bits in every run."""
    n, s, c, code = _check_gn(x, num_groups)
    sms = _sm_count(x.device)
    ws, counter = _gn_workspace("gn_stats", n, s, c, num_groups, code, sms,
                                x.device)
    mean = torch.empty((n, num_groups), dtype=torch.float32, device=x.device)
    inv = torch.empty_like(mean)
    fn = _kernel("gn_stats")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), code, n, s, c, num_groups, float(eps), sms,
                 ws.data_ptr(), counter.data_ptr(), mean.data_ptr(),
                 inv.data_ptr(),
                 torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "gn_stats")
    _count("gn_stats")
    return mean, inv


def gn_stats_sums(x: torch.Tensor,
                  num_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel ``gn_stats``' sums mode (``gn_stats_sums``): (sum x, sum
    x^2), each (N, G) f32, of the (N, S, C) slab x, the sums that
    :func:`gn_stats` finalizes, added in its fixed order: a shard's part of
    a GroupNorm over a volume split along X. Same plan and workspace as
    :func:`gn_stats`."""
    n, s, c, code = _check_gn(x, num_groups)
    sms = _sm_count(x.device)
    ws, counter = _gn_workspace("gn_stats", n, s, c, num_groups, code, sms,
                                x.device)
    sums = torch.empty((n, num_groups), dtype=torch.float32, device=x.device)
    sq = torch.empty_like(sums)
    fn = _kernel("gn_stats_sums")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), code, n, s, c, num_groups, sms, ws.data_ptr(),
                 counter.data_ptr(), sums.data_ptr(), sq.data_ptr(),
                 torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "gn_stats_sums")
    _count("gn_stats_sums")
    return sums, sq


def gn_finalize(sums: torch.Tensor, sq: torch.Tensor, count: int,
                eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel ``gn_finalize``, one block: (mean_g, inv_g), each (N, G) f32,
    from the (N, G) f32 sums of x and of x^2 over ``count`` elements per
    (sample, group), with :func:`gn_stats`' own tail: mean = sum / D, inv =
    rsqrt(sq / D - mean^2 + eps), D = count."""
    if sums.dim() != 2 or min(sums.shape) < 1:
        raise ValueError(f"sums must be a non-empty (N, G) tensor, got "
                         f"{tuple(sums.shape)}")
    if not sums.is_cuda:
        raise ValueError(f"sums must be a CUDA tensor, got {sums.device}")
    for t, what in ((sums, "sums"), (sq, "sq")):
        _check_f32(t, sums.shape, sums.device, what)
    if count < 1:
        raise ValueError(f"count must be positive, got {count}")
    mean = torch.empty_like(sums)
    inv = torch.empty_like(sums)
    fn = _kernel("gn_finalize")
    with torch.cuda.device(sums.device):
        err = fn(sums.data_ptr(), sq.data_ptr(), sums.numel(), int(count),
                 float(eps), mean.data_ptr(), inv.data_ptr(),
                 torch.cuda.current_stream(sums.device).cuda_stream)
    _raise_on(err, "gn_finalize")
    _count("gn_finalize")
    return mean, inv


def gn_apply(x: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
             scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Kernel ``gn_apply``: (x - mean_c) * (inv_c * scale) + bias in f32,
    in x's dtype and shape. mean, inv: (N, G) f32; scale, bias: (C,)
    f32."""
    groups = int(mean.shape[1]) if mean.dim() == 2 else 0
    n, s, c, code = _check_gn(x, groups)
    for t, what in ((mean, "mean"), (inv, "inv")):
        _check_f32(t, (n, groups), x.device, what)
    for t, what in ((scale, "scale"), (bias, "bias")):
        _check_f32(t, (c,), x.device, what)
    out = torch.empty_like(x)
    fn = _kernel("gn_apply")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), code, n, s, c, groups, mean.data_ptr(),
                 inv.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                 _sm_count(x.device), out.data_ptr(),
                 torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "gn_apply")
    _count("gn_apply")
    return out


def gn_bwd_reduce(x: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                  inv: torch.Tensor, scale: torch.Tensor):
    """Kernel ``gn_bwd_reduce``: (dscale (C,), dbias (C,), sdx (N, G),
    sdxx (N, G)), all f32: dscale = sum over n, s of g * xhat, dbias = sum
    of g, and per (sample, group) sdx = sum dxhat, sdxx = sum dxhat * xhat,
    with xhat = (x - mean_c) * inv_c and dxhat = g * scale. One wave of
    blocks (:func:`.layout.gn_reduce_plan`), each writing one partial sum
    that a fixed-order fold adds up: the same bits in every run."""
    groups = int(mean.shape[1]) if mean.dim() == 2 else 0
    n, s, c, code = _check_gn(x, groups, g)
    for t, what in ((mean, "mean"), (inv, "inv")):
        _check_f32(t, (n, groups), x.device, what)
    _check_f32(scale, (c,), x.device, "scale")
    sms = _sm_count(x.device)
    ws, counter = _gn_workspace("gn_bwd_reduce", n, s, c, groups, code, sms,
                                x.device)
    dscale = torch.empty(c, dtype=torch.float32, device=x.device)
    dbias = torch.empty_like(dscale)
    sdx = torch.empty((n, groups), dtype=torch.float32, device=x.device)
    sdxx = torch.empty_like(sdx)
    fn = _kernel("gn_bwd_reduce")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), g.data_ptr(), code, n, s, c, groups,
                 mean.data_ptr(), inv.data_ptr(), scale.data_ptr(), sms,
                 ws.data_ptr(), counter.data_ptr(), dscale.data_ptr(),
                 dbias.data_ptr(), sdx.data_ptr(), sdxx.data_ptr(),
                 torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "gn_bwd_reduce")
    _count("gn_bwd_reduce")
    return dscale, dbias, sdx, sdxx


def gn_bwd_dx(x: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
              inv: torch.Tensor, scale: torch.Tensor, sdx: torch.Tensor,
              sdxx: torch.Tensor, denom: Optional[int] = None) -> torch.Tensor:
    """Kernel ``gn_bwd_dx``: dx = inv/D * (D * g * scale - sdx - xhat *
    sdxx) in f32, in x's dtype and shape, D = S * C / G; or, with
    ``denom`` (the elements per (sample, group) of a volume split over
    shards), D = denom, launched as ``gn_bwd_dx_denom``."""
    groups = int(mean.shape[1]) if mean.dim() == 2 else 0
    n, s, c, code = _check_gn(x, groups, g)
    for t, what in ((mean, "mean"), (inv, "inv"), (sdx, "sdx"),
                    (sdxx, "sdxx")):
        _check_f32(t, (n, groups), x.device, what)
    _check_f32(scale, (c,), x.device, "scale")
    name = "gn_bwd_dx" if denom is None else "gn_bwd_dx_denom"
    if denom is not None and denom < 1:
        raise ValueError(f"denom must be positive, got {denom}")
    count = () if denom is None else (int(denom),)
    dx = torch.empty_like(x)
    fn = _kernel(name)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), g.data_ptr(), code, n, s, c, groups,
                 mean.data_ptr(), inv.data_ptr(), scale.data_ptr(),
                 sdx.data_ptr(), sdxx.data_ptr(), *count, _sm_count(x.device),
                 dx.data_ptr(),
                 torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, name)
    _count(name)
    return dx


# ---------------------------------------------------------------------------
# the matrix-unit probe (``mxu_probe.cu``): no tensor inputs, every operand
# a constant made on chip
# ---------------------------------------------------------------------------


def _probe_device(name: str, device, reps: int, **dims) -> torch.device:
    """The CUDA device of a probe launch, after checking its sizes: each
    of ``dims`` is (value, multiple it must be of)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on a CUDA device, got {dev}")
    for what, (v, mult) in dims.items():
        if int(v) <= 0 or int(v) % mult:
            raise ValueError(f"{name}: {what} must be a positive multiple of "
                             f"{mult}, got {v}")
    if int(reps) < 0:
        raise ValueError(f"{name}: reps must be >= 0, got {reps}")
    return dev


def _probe_launch(name: str, dev: torch.device, args, outs) -> None:
    fn = _kernel(name)
    with torch.cuda.device(dev):
        err = fn(*args, *[None if t is None else t.data_ptr() for t in outs],
                 torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, name)
    _count(name)


def mxu_dot(k: int, n: int, ps: int, reps: int, device="cuda") -> torch.Tensor:
    """``dot_kernel``: (8, n) f32, row 0 = reps x the column sums of
    a (ps, k) @ b (k, n), both bf16 0.5; k a multiple of 32, n of 64."""
    dev = _probe_device("mxu_dot", device, reps, k=(k, 32), n=(n, 64),
                        ps=(ps, 1))
    o = torch.zeros((8, n), dtype=torch.float32, device=dev)
    _probe_launch("mxu_dot", dev, (k, n, ps, reps), [o])
    return o


def mxu_rdot(m: int, n: int, ps: int, reps: int, device="cuda") -> torch.Tensor:
    """``rdot_kernel``: (8, 128) f32, o[0, 0] = reps x the sum of a^T @ b
    for a (ps, m) and b (ps, n), both bf16 0.5; m and n multiples of 64."""
    dev = _probe_device("mxu_rdot", device, reps, m=(m, 64), n=(n, 64),
                        ps=(ps, 1))
    o = torch.zeros((8, 128), dtype=torch.float32, device=dev)
    _probe_launch("mxu_rdot", dev, (m, n, ps, reps), [o])
    return o


def slab_build(cs: int, copies: int, ps: int, reps: int, device="cuda",
               return_slab: bool = False):
    """``build_kernel``: o (1, 1) f32 = reps x norm[0, 0] after ``reps``
    slab builds of a (ps, copies * cs) bf16 slab from 0.25; with
    ``return_slab`` also the final slab (written by the launch to device
    memory), as (o, slab). cs a multiple of 8."""
    dev = _probe_device("slab_build", device, reps, cs=(cs, 8),
                        copies=(copies, 1), ps=(ps, 1))
    if layout.build_plan(cs, copies, ps, _sm_count(dev))[0] == 0:
        raise ValueError(f"slab_build: a slab row of {copies} x {cs} bf16 "
                         "does not fit in a block's shared memory")
    o = torch.zeros((1, 1), dtype=torch.float32, device=dev)
    slab = (torch.empty((ps, copies * cs), dtype=torch.bfloat16, device=dev)
            if return_slab else None)
    _probe_launch("slab_build", dev, (cs, copies, ps, reps), [o, slab])
    return (o, slab) if return_slab else o


# ---------------------------------------------------------------------------
# the train step's masked cross-entropy and confusion counts
# (``ce_counts.cu``), over the labelled rows only
# ---------------------------------------------------------------------------

# count bins the forward keeps in shared memory (``MAX_CLASSES``)
CE_MAX_CLASSES = 2048


def _check_ce(logits: torch.Tensor, labels: torch.Tensor) -> Tuple[int, int]:
    """(rows, C) of a contiguous f32 (rows, C) CUDA logits tensor and its
    contiguous int64 (rows,) labels."""
    if not logits.is_cuda:
        raise ValueError(f"logits must be a CUDA tensor, got {logits.device}")
    if (logits.dtype != torch.float32 or logits.dim() != 2
            or not logits.is_contiguous() or logits.shape[1] < 1):
        raise ValueError(f"logits must be a contiguous float32 (rows, C) "
                         f"tensor, got {logits.dtype} {tuple(logits.shape)}")
    rows = int(logits.shape[0])
    if (labels.device != logits.device or labels.dtype != torch.int64
            or tuple(labels.shape) != (rows,) or not labels.is_contiguous()):
        raise ValueError(f"labels must be a contiguous int64 ({rows},) tensor "
                         f"on {logits.device}, got {labels.dtype} "
                         f"{tuple(labels.shape)} on {labels.device}")
    return rows, int(logits.shape[1])


def ce_counts_fwd(logits: torch.Tensor, labels: torch.Tensor,
                  num_classes: int,
                  background: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel ``ce_counts_fwd``: (NLL sum () f32, counts (3, num_classes)
    int32 [TP, FP, FN]) of the rows whose label is not ``background``, the
    prediction each row's argmax: ``ops/losses.py`` ``ce_counts_plain``'s
    numbers. One wave of blocks, one f32 partial each, folded in a fixed
    order: the same bits in every run."""
    rows, c = _check_ce(logits, labels)
    if not 1 <= num_classes <= CE_MAX_CLASSES:
        raise ValueError(f"ce_counts_fwd takes 1 to {CE_MAX_CLASSES} "
                         f"classes, got {num_classes}")
    dev = logits.device
    sms = _sm_count(dev)
    out = _workspace("ce_counts_fwd_ws", rows, sms, device=dev)
    hist = torch.zeros(3 * num_classes + 1, dtype=torch.int32, device=dev)
    counts = torch.empty((3, num_classes), dtype=torch.int32, device=dev)
    fn = _kernel("ce_counts_fwd")
    with torch.cuda.device(dev):
        err = fn(logits.data_ptr(), labels.data_ptr(), rows, c, num_classes,
                 int(background), sms, out.data_ptr(), hist.data_ptr(),
                 counts.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "ce_counts_fwd")
    _count("ce_counts_fwd")
    return out[0], counts


def ce_counts_bwd(logits: torch.Tensor, labels: torch.Tensor,
                  grad: torch.Tensor, background: int) -> torch.Tensor:
    """Kernel ``ce_counts_bwd``: the (rows, C) f32 gradient of
    :func:`ce_counts_fwd`'s NLL sum times ``grad`` (a one-element f32
    tensor on the logits' device): ``grad * (softmax - onehot)`` on the
    labelled rows, 0 on the others, every element written once."""
    rows, c = _check_ce(logits, labels)
    dev = logits.device
    if (grad.device != dev or grad.dtype != torch.float32
            or grad.numel() != 1 or not grad.is_contiguous()):
        raise ValueError(f"grad must be a one-element float32 tensor on "
                         f"{dev}, got {grad.dtype} {tuple(grad.shape)} on "
                         f"{grad.device}")
    dx = torch.empty((rows, c), dtype=torch.float32, device=dev)
    if dx.data_ptr() % 16:
        raise ValueError("the gradient must be 16-byte aligned")
    fn = _kernel("ce_counts_bwd")
    with torch.cuda.device(dev):
        err = fn(logits.data_ptr(), labels.data_ptr(), rows, c,
                 int(background), grad.data_ptr(), _sm_count(dev),
                 dx.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "ce_counts_bwd")
    _count("ce_counts_bwd")
    return dx
