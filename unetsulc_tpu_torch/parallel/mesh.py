"""The mesh of the port's spatial-parallel steps: the counterpart of
``unetsulc_tpu/parallel/mesh.py``.

JAX's ``shard_map`` is one controller running a per-shard body over a
device mesh. The port keeps that shape: a :class:`Mesh` is an ordered list
of ``torch.device``s along the ``space`` axis (shard k holds the k-th slab
of the volume along X), and one Python process drives every shard, layer
by layer in lockstep (:mod:`unetsulc_tpu_torch.parallel.sp_fused`). Its
collectives are plain tensor code:

* ``ppermute``: slice the neighbour shard's tensor and ``.to()`` it onto
  the receiving shard's device; autograd sends the gradient back to the
  neighbour's buffer, as JAX transposes ``ppermute``;
* ``psum``: add the shards' tensors on the mesh's first device and copy
  the sum back to each shard;
* ``all_gather``: ``torch.cat`` along X.

Why not ``torch.distributed``: NCCL refuses two ranks on one GPU, and a
machine with one card must still run P shards (one after another, on that
card). A process-group backend belongs with the data-parallel step
(ROADMAP.md §1 item 5), which is also where the ``data`` axis comes in: it
is 1 here.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from unetsulc_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Shard devices along ``space``, in slab order. The first is the
    mesh's home: the model's parameters, the summed statistics and the
    replicated deep levels live there."""

    devices: Tuple[torch.device, ...]

    @property
    def space(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        return self.devices[0]


def _indexed(d: torch.device) -> torch.device:
    """``cuda`` as the ``cuda:i`` its tensors report, i the current card."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(data: int = 1, space: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (data, space) mesh with ``data`` = 1. Shard i goes to ``cuda:i``
    when that many cards are visible; with fewer, it raises unless the
    caller passes ``devices`` (a list of ``space`` devices, which may
    repeat one device: ``[torch.device("cuda")] * n`` runs n shards on one
    card, ``[torch.device("cpu")] * n`` on the CPU). Nothing moves to the
    CPU on its own."""
    if data != 1:
        raise ValueError(
            f"data={data}: the data axis is not ported yet, it must be 1 "
            "(data and fold parallelism: ROADMAP.md §1 item 5)")
    if space < 1:
        raise ValueError(f"space must be >= 1, got {space}")
    if devices is None:
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if visible < space:
            raise RuntimeError(
                f"space={space} needs {space} CUDA devices and {visible} are "
                "visible; pass devices=[...] to place several shards on one "
                "device")
        devices = [torch.device("cuda", i) for i in range(space)]
    devices = tuple(_indexed(resolve_device(d)) for d in devices)
    if len(devices) != space:
        raise ValueError(f"space={space} takes {space} devices, got "
                         f"{len(devices)}")
    return Mesh(devices)


def shard_x(t: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """(N, X, ...) -> ``mesh.space`` slabs (N, X/space, ...) along X, slab
    k on the mesh's k-th device: the counterpart of ``batch_sharding``
    plus ``device_put`` along ``space``."""
    n, x = mesh.space, int(t.shape[1])
    if x % n:
        raise ValueError(f"X extent {x} does not split into {n} slabs")
    return [s.to(d) for s, d in zip(torch.split(t, x // n, dim=1),
                                    mesh.devices)]
