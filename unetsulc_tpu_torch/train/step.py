"""Train, eval and labelling steps (``unetsulc_tpu/train/step.py``):
SGD with momentum on masked cross-entropy, on-device confusion counts,
the labelling forward and the cutting vote.

torch SGD parity (ref training.py:140, ``optim.SGD(lr, momentum, wd=0)``):

    buf   <- momentum * buf + grad
    param <- param - lr * buf

with the model's f32 parameters as the master weights. The reference
rebuilds its optimizer on DivideLr, which resets the momentum buffers
(ref training.py:252): :meth:`TrainState.divide_lr`.

On the fused path a batch of more than one volume runs as one batch-1
forward and backward per volume (the JAX package's ``scan_batch=True``),
each volume's loss being its NLL sum over the batch's total valid count,
which the labels give before any forward: the gradients accumulate to the
exact batch mean, and only one volume's activations live at a time. A
model that takes the non-fused path for a volume (``UNet3D.fused_eligible``)
runs the batch in one forward, as the JAX step does when it does not scan.

Dropout draws from a ``torch.Generator`` on the model's device, seeded
from ``(0, state.step)`` (:func:`dropout_generator`). Its masks are not
JAX's: the two frameworks' random bits differ.

Eval parity quirk: the torch model applies its final activation in eval
mode, so the reference's validation loss is CE(softmax(logits)) while the
train loss is CE(logits); :func:`make_eval_step` reproduces it.

:func:`make_train_step_sp` and :func:`make_eval_step_sp` are the
spatial-parallel steps: each volume split along X over a mesh's shards
(``UNet3D.forward_sp``), the shards' NLL sums, valid counts and confusion
counts added on the mesh's home device, and one backward of the summed
loss, so the gradients of all shards meet in the model's parameters (the
JAX steps' psums) before the same SGD-with-momentum update.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from unetsulc_tpu_torch.ops.esi import confusion_counts
from unetsulc_tpu_torch.ops.losses import cross_entropy_sum
from unetsulc_tpu_torch.parallel.mesh import Mesh
from unetsulc_tpu_torch.train import freeze


def _match_labels(logits: torch.Tensor, labels: torch.Tensor,
                  background: int) -> torch.Tensor:
    """Labels in the logits' layout. The fused pipeline's padded logits
    (X+2, Y+2, Z+2, C) take labels (1, X, Y, Z) ring-padded with
    ``background``, so the ring drops out of the loss and the counts;
    5-D logits take the labels as they are."""
    if logits.dim() != 4:
        return labels
    if labels.shape[0] != 1:
        raise ValueError(f"padded logits need batch 1, got {labels.shape[0]}")
    if tuple(logits.shape[:3]) != tuple(int(s) + 2 for s in labels.shape[1:]):
        raise ValueError(f"labels {tuple(labels.shape)} do not match padded "
                         f"logits {tuple(logits.shape)}")
    return F.pad(labels[0], (1, 1, 1, 1, 1, 1), value=background)


def _volumes(model, inputs: torch.Tensor) -> List[slice]:
    """The batch slices that each take one forward: one per volume on the
    fused path (batch 1 only), the whole batch otherwise."""
    if model.fused_eligible(inputs[:1]):
        return [slice(i, i + 1) for i in range(inputs.shape[0])]
    return [slice(None)]


def dropout_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout stream of one train step: a generator on ``device``
    seeded from (seed, step) (the JAX step folds ``state.step`` into its
    dropout key the same way). The pair is hashed to 32 bits, all that the
    CPU generator reads of a seed."""
    mixed = np.random.SeedSequence([seed, step]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


def _sgd(params, lr: float, momentum: float) -> torch.optim.SGD:
    return torch.optim.SGD(params, lr=lr, momentum=momentum, dampening=0,
                           nesterov=False, weight_decay=0)


class TrainState:
    """The model (its parameters are the master weights, updated in place),
    its trainable set, and the SGD optimizer that holds the lr and the
    momentum buffers. The momentum rate is the train step's, as in the JAX
    package; a buffer that does not exist yet counts as zero."""

    def __init__(self, model: torch.nn.Module, lr: float,
                 training_layers: Optional[Sequence[str]] = None):
        self.model = model
        self.training_layers = training_layers
        self.optimizer = _sgd(
            freeze.apply_training_layers(model, training_layers), lr, 0.9)
        self.step = 0

    @classmethod
    def create(cls, model: torch.nn.Module, lr: float,
               training_layers: Optional[Sequence[str]] = None) -> "TrainState":
        return cls(model, lr, training_layers)

    @property
    def lr(self) -> float:
        return self.optimizer.param_groups[0]["lr"]

    def divide_lr(self, factor: float = 10.0,
                  reset_momentum: bool = True) -> "TrainState":
        """DivideLr (ref training.py:250-252): lr /= factor and, by default,
        momentum reset, as the reference's optimizer rebuild does."""
        for group in self.optimizer.param_groups:
            group["lr"] /= factor
        if reset_momentum:
            self.reset_momentum()
        return self

    def reset_momentum(self) -> "TrainState":
        self.optimizer.state.clear()
        return self

    def repartition(self, training_layers: Optional[Sequence[str]]) -> "TrainState":
        """Change the trainable set (the fine-tuning unfreeze); every
        momentum buffer restarts at zero, as the reference's optimizer
        rebuild does (ref transfer_learning/transfer_learning.py:392)."""
        group = self.optimizer.param_groups[0]
        self.training_layers = training_layers
        self.optimizer = _sgd(
            freeze.apply_training_layers(self.model, training_layers),
            group["lr"], group["momentum"])
        return self


def make_train_step(model: torch.nn.Module, num_classes: int,
                    momentum: float = 0.9, background: int = -1) -> Callable:
    """``step(state, inputs (N, X, Y, Z, Cin), labels (N, X, Y, Z)) ->
    (loss, counts (3, num_classes) int32)``, both on the device; the host
    never waits inside. Forward (train mode; padded logits on the fused
    path), masked cross-entropy, backward through the kernels for the
    trainable parameters only, then one SGD-with-momentum update of
    ``state``'s parameters in place. With dropout, the step's masks come
    from ``dropout_generator(0, state.step)``, as the JAX step folds the
    step into ``jax.random.key(0)``."""

    def step(state: TrainState, inputs: torch.Tensor,
             labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if state.model is not model:
            raise ValueError("state belongs to another model")
        opt = state.optimizer
        for group in opt.param_groups:
            group["momentum"] = momentum
        opt.zero_grad(set_to_none=True)
        denom = (labels != background).sum().clamp_min(1).float()
        loss = torch.zeros((), dtype=torch.float32, device=inputs.device)
        counts = torch.zeros((3, num_classes), dtype=torch.int32,
                             device=inputs.device)
        gen = (dropout_generator(0, state.step, inputs.device)
               if model.dropout > 0 else None)
        for v in _volumes(model, inputs):
            logits = model(inputs[v], train=True, padded_output=True,
                           dropout_generator=gen)
            lbl = _match_labels(logits, labels[v], background)
            nll, _ = cross_entropy_sum(logits, lbl, background)
            part = nll / denom
            if part.requires_grad:
                with model.precision():
                    part.backward()
            loss = loss + part.detach()
            counts = counts + confusion_counts(
                lbl, logits.detach().argmax(-1), num_classes, background)
        opt.step()
        state.step += 1
        return loss, counts

    return step


def _check_slabs(mesh: Mesh, inputs, labels) -> None:
    if len(inputs) != mesh.space or len(labels) != mesh.space:
        raise ValueError(f"expected {mesh.space} input and label slabs (one "
                         f"per shard), got {len(inputs)} and {len(labels)}")
    for k, (x, lb, d) in enumerate(zip(inputs, labels, mesh.devices)):
        if x.device != d or lb.device != d:
            raise ValueError(f"slab {k} is not on its shard's device {d}")


def _sp_volume(model, xs, lbs, num_classes: int, background: int, home,
               train: bool, apply_activation: bool = False,
               final_sigmoid: bool = False):
    """One volume through ``forward_sp``: (NLL sum, valid count, confusion
    counts), each the sum over the shards on ``home``. The counts come
    from the raw logits; with ``apply_activation`` the NLL from the
    activated outputs (the eval-mode quirk)."""
    logits = model.forward_sp(xs, train=train, apply_final_activation=False,
                              padded_output=True)
    nll = torch.zeros((), dtype=torch.float32, device=home)
    cnt = torch.zeros((), dtype=torch.int64, device=home)
    counts = torch.zeros((3, num_classes), dtype=torch.int32, device=home)
    for lg, lb in zip(logits, lbs):
        lbl = _match_labels(lg, lb, background)
        counts = counts + confusion_counts(
            lbl, lg.detach().argmax(-1), num_classes, background).to(home)
        if apply_activation:
            lg = torch.sigmoid(lg) if final_sigmoid else torch.softmax(lg, -1)
        n, c = cross_entropy_sum(lg, lbl, background)
        nll, cnt = nll + n.to(home), cnt + c.to(home)
    return nll, cnt, counts


def make_train_step_sp(model: torch.nn.Module, num_classes: int, mesh: Mesh,
                       momentum: float = 0.9, background: int = -1) -> Callable:
    """The spatial-parallel train step (``train/step.py:506-585`` of the
    JAX package): ``step(state, inputs, labels) -> (loss, counts)`` on the
    mesh's home device, where inputs and labels are the batch's slabs, one
    per shard (``parallel.shard_x`` of each). Each volume of the batch runs
    through ``model.forward_sp`` (one volume at a time, as ``scan_batch``
    does); its loss is the shards' NLL sum over the batch's total valid
    count, summed over the shards before one backward, so the gradient of
    every shard meets in the parameters; then one SGD-with-momentum update
    of ``state``, as :func:`make_train_step`. The model's parameters live
    on the home device."""

    def step(state: TrainState, inputs: Sequence[torch.Tensor],
             labels: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        if state.model is not model:
            raise ValueError("state belongs to another model")
        _check_slabs(mesh, inputs, labels)
        home = mesh.home
        opt = state.optimizer
        for group in opt.param_groups:
            group["momentum"] = momentum
        opt.zero_grad(set_to_none=True)
        denom = sum((lb != background).sum().to(home) for lb in labels)
        denom = denom.clamp_min(1).float()
        loss = torch.zeros((), dtype=torch.float32, device=home)
        counts = torch.zeros((3, num_classes), dtype=torch.int32, device=home)
        for i in range(int(inputs[0].shape[0])):
            nll, _, c = _sp_volume(model, [x[i:i + 1] for x in inputs],
                                   [lb[i:i + 1] for lb in labels], num_classes,
                                   background, home, train=True)
            part = nll / denom
            if part.requires_grad:
                part.backward()
            loss = loss + part.detach()
            counts = counts + c
        opt.step()
        state.step += 1
        return loss, counts

    return step


def make_eval_step_sp(model: torch.nn.Module, num_classes: int, mesh: Mesh,
                      background: int = -1, apply_activation: bool = True,
                      final_sigmoid: bool = False) -> Callable:
    """The spatial-parallel eval step (``make_eval_step_sp`` of the JAX
    package): ``step(inputs, labels) -> (loss, counts)`` on slabs, one
    volume at a time, the shards' sums added as
    :func:`make_train_step_sp` adds them; loss and counts as
    :func:`make_eval_step`."""

    @torch.no_grad()
    def step(inputs: Sequence[torch.Tensor],
             labels: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        _check_slabs(mesh, inputs, labels)
        home = mesh.home
        nll = torch.zeros((), dtype=torch.float32, device=home)
        cnt = torch.zeros((), dtype=torch.int64, device=home)
        counts = torch.zeros((3, num_classes), dtype=torch.int32, device=home)
        for i in range(int(inputs[0].shape[0])):
            n, c, cc = _sp_volume(model, [x[i:i + 1] for x in inputs],
                                  [lb[i:i + 1] for lb in labels], num_classes,
                                  background, home, train=False,
                                  apply_activation=apply_activation,
                                  final_sigmoid=final_sigmoid)
            nll, cnt, counts = nll + n, cnt + c, counts + cc
        return nll / cnt.clamp_min(1), counts

    return step


def make_eval_step(model: torch.nn.Module, num_classes: int,
                   background: int = -1, apply_activation: bool = True,
                   final_sigmoid: bool = False) -> Callable:
    """``step(inputs, labels) -> (loss, counts)`` in eval mode (dropout
    off), one volume at a time on the fused path, the whole batch in one
    forward on the non-fused path: argmax and counts on the raw logits;
    with
    ``apply_activation`` the loss is the cross-entropy of the activated
    outputs (sigmoid or softmax per ``final_sigmoid``), the reference's
    eval-mode quirk (train/step.py:259-300 of the JAX package)."""

    @torch.no_grad()
    def step(inputs: torch.Tensor,
             labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        nll = torch.zeros((), dtype=torch.float32, device=inputs.device)
        cnt = torch.zeros((), dtype=torch.int64, device=inputs.device)
        counts = torch.zeros((3, num_classes), dtype=torch.int32,
                             device=inputs.device)
        for v in _volumes(model, inputs):
            logits = model(inputs[v], train=False,
                           apply_final_activation=False, padded_output=True)
            lbl = _match_labels(logits, labels[v], background)
            counts = counts + confusion_counts(lbl, logits.argmax(-1),
                                               num_classes, background)
            if apply_activation:
                logits = (torch.sigmoid(logits) if final_sigmoid
                          else torch.softmax(logits, -1))
            n, c = cross_entropy_sum(logits, lbl, background)
            nll, cnt = nll + n, cnt + c
        return nll / cnt.clamp_min(1), counts

    return step


def make_label_fn(model, final_sigmoid: bool = False) -> Callable:
    """``label(inputs (1, X, Y, Z, C), coords (3, n) long) -> (ypred (n,),
    yscores (n, classes) f32)`` at the given voxels only, without
    autograd.

    Gathers the logits (padded on the fused path, 5-D on the non-fused
    one) at the voxel coordinates FIRST, then applies
    softmax/sigmoid and argmax: the activation acts per voxel over
    channels, so gather-then-activate equals activate-then-gather, and only
    (n x classes) values are ever activated or fetched. Scores stay f32."""

    @torch.no_grad()
    def label(inputs: torch.Tensor, coords: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        logits = model(inputs, train=False, apply_final_activation=False,
                       padded_output=True)
        if logits.dim() == 4:  # (X+2, Y+2, Z+2, classes)
            picked = logits[coords[0] + 1, coords[1] + 1, coords[2] + 1]
        else:  # (1, X, Y, Z, classes)
            picked = logits[0][coords[0], coords[1], coords[2]]
        yscores = torch.sigmoid(picked) if final_sigmoid else torch.softmax(picked, -1)
        return torch.argmax(yscores, -1), yscores

    return label


def make_predict_fn(model, apply_activation: bool = True,
                    final_sigmoid: bool = False) -> Callable:
    """``predict(inputs (N, X, Y, Z, C)) -> (N, X, Y, Z, classes)`` f32:
    the inference forward without autograd, dropout off, then the model's
    final activation (sigmoid or softmax per ``final_sigmoid``) unless
    ``apply_activation`` is False (the JAX package's ``make_predict_fn``;
    ref pattern_class.py:266 ``self.model.eval()``)."""

    @torch.no_grad()
    def predict(inputs: torch.Tensor) -> torch.Tensor:
        logits = model(inputs, train=False, apply_final_activation=False)
        if apply_activation:
            logits = (torch.sigmoid(logits) if final_sigmoid
                      else torch.softmax(logits, -1))
        return logits

    return predict


def make_vote_fn() -> Callable:
    """``vote(scores (n, C), part_ids (T, n) long, num_parts) -> (T,
    num_parts) long``: for every threshold's re-segmentation
    (``ops.cutting.cut_part_ids_multi``) sum the class scores within each
    part and take the argmax, as one ``index_add_`` over all thresholds
    (each row's part ids offset by ``t * num_parts``). The score matrix
    never leaves the device; ties go to the lowest class, as
    ``np.argmax``."""

    def vote(scores: torch.Tensor, part_ids: torch.Tensor, num_parts: int) -> torch.Tensor:
        t = part_ids.shape[0]
        offs = torch.arange(t, device=part_ids.device)[:, None] * num_parts
        sums = torch.zeros(
            (t * num_parts, scores.shape[1]), dtype=torch.float32,
            device=scores.device,
        ).index_add_(0, (part_ids + offs).reshape(-1),
                     scores.float().repeat(t, 1))
        return torch.argmax(sums.view(t, num_parts, -1), -1)

    return vote
