"""The mesh of the port's data- and spatial-parallel steps: the counterpart
of ``unetsulc_tpu/parallel/mesh.py``.

JAX's ``shard_map`` is one controller running a per-shard body over a
device mesh. The port keeps that shape: a :class:`Mesh` is a (data, space)
grid of ``torch.device``s, one row per data shard (a slice of the batch)
and, along a row, one device per spatial shard (shard k of the row holds
the k-th slab of its volumes along X). One Python process drives every
shard (:mod:`unetsulc_tpu_torch.train.step`,
:mod:`unetsulc_tpu_torch.parallel.sp_fused`), and the collectives are
plain tensor code:

* ``ppermute``: slice the neighbour shard's tensor and ``.to()`` it onto
  the receiving shard's device; autograd sends the gradient back to the
  neighbour's buffer, as JAX transposes ``ppermute``;
* ``psum``: add the shards' tensors on the mesh's home device (its first),
  and copy the sum back to each shard where they need it;
* ``all_gather``: ``torch.cat`` along X.

The JAX package's sharding objects have no counterpart here, their jobs
went elsewhere: ``batch_sharding`` and ``label_sharding`` (the batch over
``data``, X over ``space``) and ``halo.py``'s ``spatial_sharding`` (X over
``space``) are :func:`shard_batch` and :func:`shard_x`, which place each
piece on its device; ``replicate`` (parameters and
optimizer state on every device) is the model living on the home device,
each shard's forward reading its weights through ``.to(device)``, so that
autograd brings every shard's gradient home, where they meet in ``.grad``
(the gradient psum) before one optimizer update.

Why not ``torch.distributed``: NCCL refuses two ranks on one GPU, and a
machine with one card must still run several shards (one after another,
on that card). A shard list may repeat one device: ``[cpu] * n`` in the
tests, ``[cuda:0] * n`` on one card.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from unetsulc_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``data`` rows of ``space`` shard devices, row-major in ``devices``.
    The first device is the mesh's home: the model's parameters, the summed
    statistics and the replicated deep levels live there. With ``data`` 1,
    ``devices`` are the spatial shards in slab order."""

    devices: Tuple[torch.device, ...]
    data: int = 1

    def __post_init__(self):
        if self.data < 1 or not self.devices or len(self.devices) % self.data:
            raise ValueError(f"{len(self.devices)} devices do not form "
                             f"{self.data} data rows")

    @property
    def space(self) -> int:
        return len(self.devices) // self.data

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    def row(self, i: int) -> "Mesh":
        """Data row ``i`` as a space-only mesh; its home is the row's first
        device."""
        s = self.space
        return Mesh(self.devices[i * s:(i + 1) * s])


def _indexed(d: torch.device) -> torch.device:
    """``cuda`` as the ``cuda:i`` its tensors report, i the current card."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(data: int = 1, space: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (data, space) mesh: ``data`` rows of ``space`` devices, taken
    row-major from ``devices``. ``data=0`` means every remaining device
    (``len(devices) // space`` rows). Without ``devices``, shard i goes to
    ``cuda:i``, and the call raises when fewer cards are visible than the
    mesh needs; with ``devices`` the mesh takes the first ``data * space``
    of them, and a list may repeat one device: ``[torch.device("cuda")] *
    n`` runs n shards on one card, ``[torch.device("cpu")] * n`` on the
    CPU. Nothing moves to the CPU on its own."""
    if space < 1 or data < 0:
        raise ValueError(f"need space >= 1 and data >= 0, got data={data}, "
                         f"space={space}")
    if devices is None:
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        need = space * max(data, 1)
        if data == 0:
            data = visible // space
        if visible < need or data < 1:
            raise RuntimeError(
                f"data={data or 1} x space={space} needs {need} CUDA devices "
                f"and {visible} are visible; pass devices=[...] to place "
                "several shards on one device")
        devices = [torch.device("cuda", i) for i in range(data * space)]
    devices = [_indexed(resolve_device(d)) for d in devices]
    if data == 0:
        data = len(devices) // space
    if data < 1 or len(devices) < data * space:
        raise ValueError(f"data={data} x space={space} takes "
                         f"{max(data, 1) * space} devices, got {len(devices)}")
    return Mesh(tuple(devices[:data * space]), data)


def device_groups(n_groups: int, devices: Optional[Sequence] = None
                  ) -> List[Tuple[torch.device, ...]]:
    """``devices`` (default: every visible card) cut into ``n_groups``
    contiguous groups of equal size: the unit of fold parallelism, each
    concurrent CV fold training on its own group
    (``experiment/driver.py``). Raises when ``n_groups`` does not divide
    the device count."""
    if devices is None:
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(visible)]
    devices = [_indexed(resolve_device(d)) for d in devices]
    n = len(devices)
    if not 1 <= n_groups <= n or n % n_groups:
        raise ValueError(f"fold_parallel={n_groups} must divide the {n} "
                         "devices of the experiment")
    per = n // n_groups
    return [tuple(devices[i * per:(i + 1) * per]) for i in range(n_groups)]


def shard_x(t: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """(N, X, ...) -> ``mesh.space`` slabs (N, X/space, ...) along X, slab
    k on the k-th device of a space-only mesh (``batch_sharding`` plus
    ``device_put`` along ``space``)."""
    if mesh.data != 1:
        raise ValueError("shard_x takes a space-only mesh; use shard_batch "
                         "or mesh.row(i)")
    n, x = mesh.space, int(t.shape[1])
    if x % n:
        raise ValueError(f"X extent {x} does not split into {n} slabs")
    return [s.to(d) for s, d in zip(torch.split(t, x // n, dim=1),
                                    mesh.devices)]


def shard_batch(mesh: Mesh, inputs: torch.Tensor, labels: torch.Tensor):
    """A batch on the mesh (``shard_batch`` of the JAX module): the batch
    axis cut into ``mesh.data`` equal chunks, chunk i on data row i. Returns
    (inputs, labels), each a list over the rows: the chunk on the row's
    device when ``space`` is 1, else the chunk's slabs along X
    (:func:`shard_x` over the row)."""
    n, d = int(inputs.shape[0]), mesh.data
    if n % d or int(labels.shape[0]) != n:
        raise ValueError(f"a batch of {n} inputs and {int(labels.shape[0])} "
                         f"labels does not split over data={d}")

    def place(t: torch.Tensor, i: int):
        row = mesh.row(i)
        if row.space == 1:
            return t.to(row.home)
        return shard_x(t, row)

    xs, ls = torch.split(inputs, n // d), torch.split(labels, n // d)
    return ([place(x, i) for i, x in enumerate(xs)],
            [place(lb, i) for i, lb in enumerate(ls)])
