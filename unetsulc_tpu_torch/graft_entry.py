"""Driver entry points of the port: a forward check of the flagship model
and a dry run of every sharded training step, the counterparts of the
repository root's ``__graft_entry__.py`` (``entry``, ``dryrun_multichip``).

Both run on the card by default and raise without CUDA; ``device="cpu"``
runs them on the CPU through the plain versions, as the tests do. The
dry run's mesh repeats one device when fewer cards are visible than it
has shards, so ``dryrun_multichip(2)`` runs on a machine with one card.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

from unetsulc_tpu_torch.device import resolve_device


def _flagship(device, compute_dtype=torch.bfloat16, init_channel_number=64,
              out_channels=63, fused=False, seed=0):
    """The flagship configuration (1 input channel, init 64, 63 sulci
    classes): the fused pipeline with ``fused``, else the non-fused path
    (``fused_blocks=False``, the JAX ``pallas_blocks=False``)."""
    from unetsulc_tpu_torch.models.unet3d import UNet3D

    return UNet3D(in_channels=1, out_channels=out_channels,
                  init_channel_number=init_channel_number,
                  compute_dtype=compute_dtype, device=device, seed=seed,
                  fused_blocks=fused)


def entry(device="cuda", size: int = 64) -> Tuple[Callable, tuple]:
    """(fn, example_args): the flagship's fused train-mode forward of a
    (1, size, size, size, 1) zero volume, bf16."""
    dev = resolve_device(device)
    model = _flagship(dev, fused=True)
    x = torch.zeros((1, size, size, size, 1), device=dev)

    def fn(x):
        return model(x, train=True)

    return fn, (x,)


def _devices(dev: torch.device, n: int) -> List[torch.device]:
    """n shard devices: cuda:0 .. cuda:n-1 where that many cards are
    visible, else ``dev`` n times."""
    if dev.type == "cuda" and torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [dev] * n


def _batch(rng, n, shape):
    """(inputs, labels): 10% occupied voxels, labels in -1..4."""
    x = (rng.random((n, *shape, 1)) < 0.1).astype(np.float32)
    labels = rng.integers(-1, 5, size=(n, *shape))
    return torch.from_numpy(x), torch.from_numpy(labels)


def _place(mesh, x, labels):
    """A batch as a step on ``mesh`` takes it (``_epoch_pass``): whole
    without a mesh, cut over the data rows, or cut along X."""
    from unetsulc_tpu_torch.parallel import shard_batch, shard_x

    if mesh is None:
        return x, labels
    if mesh.data > 1:
        return shard_batch(mesh, x, labels)
    return shard_x(x, mesh), shard_x(labels, mesh)


def _hold_loss(a, b, rtol, what):
    np.testing.assert_allclose(float(a), float(b), rtol=rtol,
                               err_msg=f"{what} loss != single-device loss")


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One training step of every sharded route on an ``n_devices`` mesh,
    each held to the single-device step on the same batch.

    Mesh axes ``data`` x ``space``: space 2 when ``n_devices`` is even,
    else 1. First, the sharded non-fused step (``method.training``'s
    route for a model off the fused pipeline: ``sp_halo``, or ``dp_mesh``
    at space 1) of the f32 flagship at init 8, 5 classes, 16^3, batch
    ``data * 2``: loss rtol 1e-5, counts equal, every parameter rtol 1e-4,
    atol 1e-5. Then the data-parallel step on ``n_devices`` rows and the
    sharded fused step (at (16, 16, 16), and at (32, 8, 8), where level 2
    is sharded too) of the fused flagship (f32 on the CPU, bf16 on the
    card, the fused pipeline's type there): loss rtol 1e-4 in f32, 1e-2
    in bf16 (a bf16 step's sums in another order move its loss by up to
    ~1%, ``chip_smoke.py``'s bar)."""
    from unetsulc_tpu_torch.method.training import _route_steps
    from unetsulc_tpu_torch.parallel import make_mesh
    from unetsulc_tpu_torch.train.step import (TrainState, make_train_step,
                                               make_train_step_dp,
                                               make_train_step_sp)

    dev = resolve_device(device)
    space = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    data = n_devices // space
    devices = _devices(dev, n_devices)
    rng = np.random.default_rng(0)

    def model(**kw):
        return _flagship(dev, init_channel_number=8, out_channels=5, **kw)

    # the route the JAX package calls pjit_auto_spmd
    batch = data * 2
    x, labels = _batch(rng, batch, (16, 16, 16))
    m1, m2 = (model(compute_dtype=torch.float32) for _ in range(2))
    train, _, mesh, rec = _route_steps(m2, 5, 0.9, dp=data, spatial=space,
                                       devices=devices)
    x, labels = x.to(dev), labels.to(dev)
    loss, counts = train(TrainState.create(m2, lr=0.01),
                         *_place(mesh, x, labels))
    if not np.isfinite(float(loss)):
        raise AssertionError("dryrun produced a non-finite loss")
    ref_loss, ref_counts = make_train_step(m1, 5, momentum=0.9)(
        TrainState.create(m1, lr=0.01), x, labels)
    _hold_loss(loss, ref_loss, 1e-5, "sharded")
    np.testing.assert_array_equal(counts.cpu().numpy(),
                                  ref_counts.cpu().numpy())
    for (k, a), b in zip(m2.named_parameters(), m1.parameters()):
        np.testing.assert_allclose(
            a.detach().cpu().numpy(), b.detach().cpu().numpy(), rtol=1e-4,
            atol=1e-5, err_msg=f"sharded param update != single-device "
            f"update: {k}")
    print(f"dryrun_multichip OK: mesh=(data={data}, space={space}), route "
          f"{rec['step']}, loss={float(loss):.4f} == single-device "
          f"{float(ref_loss):.4f}, params equivalent", flush=True)

    # the data-parallel step and the sharded fused step
    fdt = torch.float32 if dev.type == "cpu" else torch.bfloat16
    rtol = 1e-4 if fdt == torch.float32 else 1e-2
    mesh_dp = make_mesh(data=n_devices, space=1, devices=devices)
    x, labels = (t.to(dev) for t in _batch(rng, n_devices, (16, 16, 16)))
    m1, m2 = (model(compute_dtype=fdt, fused=True) for _ in range(2))
    loss_dp, _ = make_train_step_dp(m2, 5, mesh_dp, momentum=0.9)(
        TrainState.create(m2, lr=0.01), *_place(mesh_dp, x, labels))
    ref, _ = make_train_step(m1, 5, momentum=0.9)(
        TrainState.create(m1, lr=0.01), x, labels)
    _hold_loss(loss_dp, ref, rtol, "dp")
    print(f"dryrun dp OK: data={n_devices}, loss={float(loss_dp):.4f} == "
          f"single-device {float(ref):.4f}", flush=True)
    if space == 1:
        return
    mesh_sp = make_mesh(data=data, space=space, devices=devices)
    for shape, what in (((16, 16, 16), "fused sp"),
                        ((32, 8, 8), "deep fused sp")):
        x, labels = (t.to(dev) for t in _batch(rng, data, shape))
        m1, m2 = (model(compute_dtype=fdt, fused=True) for _ in range(2))
        loss_sp, _ = make_train_step_sp(m2, 5, mesh_sp, momentum=0.9)(
            TrainState.create(m2, lr=0.01), *_place(mesh_sp, x, labels))
        ref, _ = make_train_step(m1, 5, momentum=0.9)(
            TrainState.create(m1, lr=0.01), x, labels)
        _hold_loss(loss_sp, ref, rtol, what)
        print(f"dryrun {what} OK: mesh=(data={data}, space={space}), "
              f"loss={float(loss_sp):.4f} == single-device "
              f"{float(ref):.4f}", flush=True)
