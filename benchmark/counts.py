"""Operations and bytes from shapes, the chip's peaks, and the least time
the work of a step could take.

The peaks are an H100 SXM's (NVIDIA data sheet; dense, at the 700 W
limit), as ``chip_smoke.py`` states them. A bound is the larger of the
operations over the peak for their type and the bytes over the memory's
bandwidth, each input read once and each output written once
(``chip_smoke.conv_bound``, ``dx_bound``, ``wgrad_bound`` and
``gn_bound``, taken over the interior: the ring of the fused buffers is
the implementation's, not the work's).

A layer (from a model file's ``layers``) is a dict: ``kind`` ("conv",
"convT" or "head"), ``vox_in`` and ``vox_out`` (voxels of one volume),
``cins`` (the input channels of each input: a decoder's conv takes its
skip and its upsampled tensor), ``cout``, ``taps`` (27 or 1), ``entry``
(the network's first conv, whose input is data) and ``param`` (the
parameter prefix). A GroupNorm layer has ``vox``, ``c`` and ``groups``.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
BF16 = 2


def trainable(layer: dict, training_layers: Optional[Sequence[str]]) -> bool:
    if training_layers is None:
        return True
    return any(layer["param"].startswith(p) for p in training_layers)


def needs_dx(layers: List[dict], index: int,
             training_layers: Optional[Sequence[str]]) -> bool:
    """Whether the backward computes layer ``index``'s input gradient: not
    for the entry conv, and only where a trainable layer lies before it."""
    if layers[index]["entry"]:
        return False
    return any(trainable(l, training_layers) for l in layers[:index])


def layer_flops(layer: dict, cin: int) -> float:
    """Multiply-adds x 2 of one pass (forward, dx or dW: each the same) of
    one input of one volume: every (input voxel, tap) of a transposed conv,
    every (output voxel, tap) of a conv."""
    vox = layer["vox_in"] if layer["kind"] == "convT" else layer["vox_out"]
    return 2.0 * vox * layer["taps"] * cin * layer["cout"]


def step_flops(layers: List[dict], batch: int,
               training_layers: Optional[Sequence[str]]) -> float:
    """The matrix work of one training step: every conv, transposed conv
    and head forward, dx where the backward needs it, dW where trainable;
    no elementwise work."""
    total = 0.0
    for i, layer in enumerate(layers):
        passes = 1 + needs_dx(layers, i, training_layers) \
            + trainable(layer, training_layers)
        total += passes * sum(layer_flops(layer, c) for c in layer["cins"])
    return batch * total


def _bound(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def conv_pass_bounds(layer: dict, cin: int, per_launch: int):
    """(forward, dx, dW) least seconds of one input's pass over
    ``per_launch`` volumes in one launch: bf16 activations and weights,
    the f32 weight gradient."""
    flops = per_launch * layer_flops(layer, cin)
    act_in = per_launch * layer["vox_in"] * cin * BF16
    act_out = per_launch * layer["vox_out"] * layer["cout"] * BF16
    w = layer["taps"] * cin * layer["cout"]
    return (_bound(flops, act_in + act_out + BF16 * w),
            _bound(flops, act_out + act_in + BF16 * w),
            _bound(flops, act_in + act_out + 4.0 * w))


def conv_bound_s(layers: List[dict], batch: int, per_launch: int,
                 training_layers: Optional[Sequence[str]],
                 kinds: Iterable[str], skip_entry: bool) -> float:
    """Least seconds of one step's passes of the layers of ``kinds`` (the
    work that the kernels counted as convolution run), ``per_launch``
    volumes to a launch; ``skip_entry`` leaves out the entry conv (a
    matmul of plain ops on the fused route)."""
    kinds = set(kinds)
    total = 0.0
    for i, layer in enumerate(layers):
        if layer["kind"] not in kinds or (skip_entry and layer["entry"]):
            continue
        dx = needs_dx(layers, i, training_layers)
        dw = trainable(layer, training_layers)
        for c in layer["cins"]:
            f, d, w = conv_pass_bounds(layer, c, per_launch)
            total += f + dx * d + dw * w
    return total * batch / per_launch


def gn_launch_bound(name: str, n: int, s: int, c: int, groups: int,
                    elem: int = BF16) -> float:
    """Least seconds of one GroupNorm launch over (n, s, c): bytes (each
    input read once, each output written once) over the bandwidth against
    f32 operations (3, 3, 5 and 7 per element for stats, apply, reduce,
    dx) over the f32 peak (``chip_smoke.gn_bound``)."""
    big = float(n * s * c * elem)
    small = 4.0 * n * groups
    nbytes, ops = {
        "gn_stats": (big + 2 * small, 3.0),
        "gn_apply": (2 * big + 2 * small + 8.0 * c, 3.0),
        "gn_bwd_reduce": (2 * big + 4 * small + 12.0 * c, 5.0),
        "gn_bwd_dx": (3 * big + 4 * small + 4.0 * c, 7.0),
    }[name]
    return max(ops * n * s * c / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)


def gn_bound_s(norms: List[dict], batch: int, backward: bool) -> float:
    """Least seconds of one step's GroupNorm launches: stats and apply per
    layer, and the backward pair where gradients flow through it; one
    launch covers the batch."""
    names = ["gn_stats", "gn_apply"] + (
        ["gn_bwd_reduce", "gn_bwd_dx"] if backward else [])
    return sum(gn_launch_bound(k, batch, g["vox"], g["c"], g["groups"])
               for g in norms for k in names)
