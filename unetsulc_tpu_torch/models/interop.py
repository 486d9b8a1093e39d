"""Weights across frameworks: the JAX package's flax parameters and ``.mdsm``
checkpoints into the port's ``state_dict``.

The port's own copy of the mapping in ``unetsulc_tpu/models/torch_interop.py``
(a rename plus a conv-kernel transpose):

    flax ``params['encoders_0']['double_conv']['conv1']['kernel']``
        (kX, kY, kZ, I, O)  ->  ``encoders.0.double_conv.conv1.weight``
        (O, I, kX, kY, kZ)
    flax ``...['norm1_scale']`` / ``...['norm1_bias']``
        ->  ``...norm1.weight`` / ``...norm1.bias``
    flax ``params['final_conv']['conv']`` -> ``final_conv.*``;
    ``params['final_conv']['<n>']`` -> ``final_conv.<n>.*``
    flax ``params['decoders_0']['upsample']['kernel']`` (kX, kY, kZ, I, O)
        ->  ``decoders.0.upsample.weight`` (I, O, kX, kY, kZ), the
        ConvTranspose3d layout, no flip (``interpolate=False``)

An ``.mdsm`` file IS a ``torch.save``d state_dict (ref
pattern_class.py:295-305), so loading one is ``torch.load``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


def _flatten(params: dict, prefix=()) -> List[Tuple[Tuple[str, ...], np.ndarray]]:
    out = []
    for k, v in params.items():
        if isinstance(v, dict):
            out.extend(_flatten(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), np.asarray(v)))
    return out


# flax kernel (kX, kY, kZ, I, O) -> torch weight
_CONV = (4, 3, 0, 1, 2)  # Conv3d (O, I, kX, kY, kZ)
_CONV_TRANSPOSE = (3, 4, 0, 1, 2)  # ConvTranspose3d (I, O, kX, kY, kZ)


def _torch_key(path: Tuple[str, ...]) -> Tuple[str, Optional[Tuple[int, ...]]]:
    """(state_dict key, axis permutation of a kernel or None) of one flax
    parameter path."""
    block = path[0]
    if block.startswith(("encoders_", "decoders_")):
        kind, idx = block.split("_")
        if path[1] == "upsample" and kind == "decoders":
            leaf = "weight" if path[2] == "kernel" else "bias"
            return (f"{kind}.{idx}.upsample.{leaf}",
                    _CONV_TRANSPOSE if leaf == "weight" else None)
        if path[1] != "double_conv":
            raise KeyError(f"unsupported flax param path: {'/'.join(path)}")
        layer = path[2]
        if layer.startswith("conv"):
            leaf = "weight" if path[3] == "kernel" else "bias"
            return (f"{kind}.{idx}.double_conv.{layer}.{leaf}",
                    _CONV if leaf == "weight" else None)
        norm, suffix = layer.rsplit("_", 1)  # norm{p}_{scale|bias}
        leaf = "weight" if suffix == "scale" else "bias"
        return f"{kind}.{idx}.double_conv.{norm}.{leaf}", None
    if block == "final_conv":
        sub = path[1]
        leaf = "weight" if path[2] == "kernel" else "bias"
        key = f"final_conv.{leaf}" if sub == "conv" else f"final_conv.{sub}.{leaf}"
        return key, _CONV if leaf == "weight" else None
    raise KeyError(f"unrecognized flax param block: {block}")


def state_dict_from_jax_params(params: dict) -> Dict[str, torch.Tensor]:
    """Flax UNet3D params (nested dict of numpy arrays) -> the port's f32
    ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(params):
        key, perm = _torch_key(path)
        if perm is not None:
            arr = np.transpose(arr, perm)
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
    return out


def load_mdsm(path: str) -> Dict[str, torch.Tensor]:
    """Read a ``.mdsm`` checkpoint (a ``torch.save``d state_dict) on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)
