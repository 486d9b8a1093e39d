"""3D CNN classifier for pattern-presence classification.

Counterpart of ``unetsulc_tpu/models/pattern_cnn.py``: the classifier of
the :class:`~unetsulc_tpu_torch.data.dataset.PatternDataset` workflow (ref
dataset.py:94-170, whose model lives outside the reference repo) and a
minimal trainer.

Architecture: a conv stack in the UNet's 'crg' idiom, each stage the
UNet's own :class:`~unetsulc_tpu_torch.models.unet3d.DoubleConv` on its
non-fused path (cuDNN convs, the GroupNorm kernels on the card), the
UNet's MaxPool3d(2, 2, padding 1) between stages, then the global max and
mean over space, taken in f32, and a linear head giving one logit. The
convs run on cuDNN's deterministic algorithms and, in f32, with TF32 off
(:meth:`PatternCNN3D.precision`), backward included.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from unetsulc_tpu_torch.device import resolve_device
from unetsulc_tpu_torch.models.unet3d import DoubleConv, init_parameters
from unetsulc_tpu_torch.ops import conv_fused as cf
from unetsulc_tpu_torch.ops.pooling import max_pool_3d


class PatternCNN3D(nn.Module):
    """Input (N, X, Y, Z, in_channels); output (N,) f32 logits.

    Parameters: ``stages.<i>`` (DoubleConvs: ``conv1``, ``norm1``,
    ``conv2``, ``norm2``) with torch's default init drawn on the CPU from
    ``generator`` (default: seeded with 0), and ``head`` (Linear(2C, 1)),
    whose weight and bias start at zero as the JAX model's: max-pooled
    GroupNorm features have heavy tails, and a random head starts the BCE
    deeply saturated."""

    def __init__(
        self,
        channels: Sequence[int] = (16, 32, 64),
        conv_layer_order: str = "crg",
        compute_dtype: torch.dtype = torch.bfloat16,
        in_channels: int = 1,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        if compute_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"compute_dtype must be bfloat16 or float32, "
                             f"got {compute_dtype}")
        self.compute_dtype = compute_dtype
        meta = torch.device("meta")
        cins = [in_channels, *channels[:-1]]
        self.stages = nn.ModuleList(
            DoubleConv(cin, cout, conv_layer_order, device=meta)
            for cin, cout in zip(cins, channels))
        self.head = nn.Linear(2 * channels[-1], 1, device=meta)
        self.to_empty(device=device)
        init_parameters(self, generator or torch.Generator().manual_seed(0))
        with torch.no_grad():
            self.head.weight.zero_()
            self.head.bias.zero_()

    @property
    def device(self) -> torch.device:
        return self.head.weight.device

    def precision(self):
        """The context the model runs in, backward included
        (:func:`make_pattern_train_step`): TF32 off in f32
        (``Precision.HIGHEST``), and cuDNN's deterministic algorithms, so
        that two steps from one state give the same bits (its default f32
        algorithms for these convs add their partial sums in a varying
        order; ``chip_smoke.py`` phase 24 holds the steps bit-equal)."""
        stack = contextlib.ExitStack()
        if self.compute_dtype == torch.float32:
            stack.enter_context(cf.no_tf32())
        stack.enter_context(torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=True,
            allow_tf32=torch.backends.cudnn.allow_tf32))
        return stack

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        """``train`` changes nothing (no dropout), as in the JAX model."""
        dt = self.compute_dtype
        with self.precision():
            v = x.to(dt)
            for i, stage in enumerate(self.stages):
                if i:
                    v = max_pool_3d(v)
                v = stage.nonfused(v, dt)
            # the global max keeps the "pattern present somewhere" signal
            # (GroupNorm centres each channel over space); amax splits a
            # tied maximum's gradient evenly, as jnp.max does, and ties are
            # common: a channel the ReLU zeroed everywhere normalizes to
            # one value
            vf = v.float()
            pooled = torch.cat([torch.amax(vf, dim=(1, 2, 3)),
                                vf.mean(dim=(1, 2, 3))], dim=-1)
            return self.head(pooled)[..., 0]


def bce_with_logits(logit: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid binary cross-entropy in the JAX trainer's stable form:
    max(l, 0) - l y + log1p(exp(-|l|))."""
    y = y.float()
    return torch.mean(torch.clamp_min(logit, 0) - logit * y
                      + torch.log1p(torch.exp(-torch.abs(logit))))


def make_pattern_train_step(
        model: PatternCNN3D, lr: float
) -> Tuple[torch.optim.Adam, Callable]:
    """(optimizer, ``step(x, y) -> loss``): one sigmoid-BCE Adam step on an
    (x, y) batch that updates the model's parameters in place and returns
    the loss on the device, with no host sync.

    Adam (lr, betas (0.9, 0.999), eps 1e-8) is ``optax.adam(lr)``: both
    add eps outside the square root of the bias-corrected second moment.
    The JAX trainer chose Adam over the U-Net's SGD because binary
    occupancy inputs give GroupNorm tiny variances, so feature scales vary
    over orders of magnitude."""
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)

    def step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        loss = bce_with_logits(model(x, train=True), y)
        with model.precision():
            loss.backward()
        opt.step()
        return loss.detach()

    return opt, step


def train_pattern_classifier(
    dataset,
    num_epochs: int = 10,
    lr: float = 1e-3,
    batch_size: int = 4,
    generator: Optional[torch.Generator] = None,
    channels: Sequence[int] = (16, 32, 64),
    compute_dtype: torch.dtype = torch.float32,
    eval_dataset=None,
    device="cuda",
) -> Tuple[PatternCNN3D, dict]:
    """Train on a PatternDataset; returns (model, history), the trained
    parameters in the model. ``history['loss']`` holds each epoch's mean
    batch loss and, with ``eval_dataset``, ``history['eval_acc']`` each
    epoch's accuracy at p > 0.5. One fetch from the device per epoch."""
    dev = resolve_device(device)
    x0, _ = dataset[0]
    model = PatternCNN3D(channels=channels, compute_dtype=compute_dtype,
                         in_channels=int(x0.shape[-1]), device=dev,
                         generator=generator)
    _, step = make_pattern_train_step(model, lr)

    def upload(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    history = {"loss": [], "eval_acc": []}
    n = len(dataset)
    for epoch in range(num_epochs):
        if hasattr(dataset, "set_epoch"):
            dataset.set_epoch(epoch)
        losses = []
        for start in range(0, n, batch_size):
            items = [dataset[i] for i in range(start, min(start + batch_size, n))]
            x = upload(np.stack([a for a, _ in items]))
            y = upload(np.asarray([b for _, b in items], np.float32))
            losses.append(step(x, y))
        history["loss"].append(float(torch.stack(losses).mean()))
        if eval_dataset is not None:
            correct = torch.zeros((), dtype=torch.int64, device=dev)
            with torch.no_grad():
                for i in range(len(eval_dataset)):
                    x, y = eval_dataset[i]
                    p = torch.sigmoid(model(upload(x[None]), train=False))[0]
                    correct += (p > 0.5) == bool(y)
            history["eval_acc"].append(int(correct) / len(eval_dataset))
    return model, history
