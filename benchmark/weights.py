"""Weights from the seed, made on the device in one draw.

The benchmark makes the weights and hands the same values to the program
and to the reference. One ``torch.rand`` on a generator on the device
fills every drawn parameter; each then takes torch's default for its kind
(a conv's weight and bias U(-b, b) with b = fan_in ** -0.5, GroupNorm's
scale 1 and shift 0), so a seed gives the same weights on every run.
"""

from __future__ import annotations

from typing import Dict

import torch


def make(shapes, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device`` for each entry of ``shapes``
    (name -> (shape, init, fan_in), as a reference's ``param_shapes``)."""
    drawn = [(n, s, f) for n, (s, init, f) in shapes.items()
             if init == "uniform"]
    sizes = [_numel(s) for _, s, _ in drawn]
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    flat = torch.rand(sum(sizes), generator=gen, device=device,
                      dtype=torch.float32).mul_(2.0).sub_(1.0)
    bounds = torch.tensor([f ** -0.5 for _, _, f in drawn], device=device)
    flat.mul_(torch.repeat_interleave(
        bounds, torch.tensor(sizes, device=device)))
    out = dict(zip([n for n, _, _ in drawn],
                   (v.view(s) for v, (_, s, _) in
                    zip(flat.split(sizes), drawn))))
    for name, (shape, init, _) in shapes.items():
        if init in ("one", "zero"):
            out[name] = torch.full(shape, 1.0 if init == "one" else 0.0,
                                   device=device)
        elif init != "uniform":
            raise ValueError(f"unknown init {init!r} of {name}")
    return {n: out[n] for n in shapes}


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n
