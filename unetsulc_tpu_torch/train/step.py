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
JAX steps' psums) before the same SGD-with-momentum update. On a mesh
with ``data`` > 1 each data row runs its own volumes so.

:func:`make_train_step_sp_halo` and :func:`make_eval_step_sp_halo` are
the spatially sharded steps of a model the fused pipeline does not take
(the JAX package's ``pjit_auto_spmd`` step): on the same arguments as the
sp steps, each data row runs its whole batch at once through
``UNet3D.forward_sp_nonfused``, whose halo exchanges and shard-added
GroupNorm statistics make it the single-device non-fused forward, then the
loss, counts and update of :func:`make_train_step_sp`.

:func:`make_train_step_dp` and :func:`make_eval_step_dp` are the
data-parallel steps: the batch cut over the mesh's ``data`` rows
(``parallel.shard_batch``), each row running its local batch as
:func:`make_train_step` runs a batch (one volume at a time on the fused
path) with the model's weights read on the row's device; the rows' NLL
sums and valid counts are added on the home device before the division,
so the loss is the global batch mean whatever the number of rows, and the
gradients meet in the home parameters' ``.grad`` before one update. With
every row on one device, a batch of one volume per row takes the very
operations of :func:`make_train_step` on the whole batch, in the same
order.
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
from unetsulc_tpu_torch.utils.profiling import HostSpans, span


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


def dropout_generator(seed: int, step: int, device,
                      shard: Optional[int] = None) -> torch.Generator:
    """The dropout stream of one train step: a generator on ``device``
    seeded from (seed, step) (the JAX step folds ``state.step`` into its
    dropout key the same way), and from the data shard's index in a
    data-parallel step (JAX folds ``axis_index("data")`` in after the
    step; here the sequence's spawn key, since entropy words of 0 at the
    end would not change the hash). The result is hashed to 32 bits, all
    that the CPU generator reads of a seed."""
    seq = np.random.SeedSequence(
        [seed, step], spawn_key=() if shard is None else (shard,))
    mixed = seq.generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


class _Method(torch.nn.Module):
    """``model.<method>`` as a module's forward, for ``functional_call``."""

    def __init__(self, model: torch.nn.Module, method: str):
        super().__init__()
        self.model, self.method = model, method

    def forward(self, *args, **kwargs):
        return getattr(self.model, self.method)(*args, **kwargs)


def _replica(model: torch.nn.Module, device: torch.device,
             method: str = "forward") -> Callable:
    """``model.<method>`` run on ``device``: the model's own where it lives
    on ``device``; elsewhere with its parameters read through
    ``.to(device)`` for each call, so autograd brings their gradients home
    (the JAX steps' replicated parameters and gradient psum)."""
    if device == model.device:
        return getattr(model, method)
    moved = {"model." + n: p.to(device) for n, p in model.named_parameters()}
    wrapped = _Method(model, method)
    return lambda *a, **kw: torch.func.functional_call(wrapped, moved, a, kw)


def _begin(state: "TrainState", model, momentum: float) -> None:
    if state.model is not model:
        raise ValueError("state belongs to another model")
    for group in state.optimizer.param_groups:
        group["momentum"] = momentum
    state.optimizer.zero_grad(set_to_none=True)


def _finish(state: "TrainState") -> None:
    state.optimizer.step()
    state.step += 1


def _zeros(num_classes: int, home):
    """A step's loss and confusion counts before its first volume."""
    return (torch.zeros((), dtype=torch.float32, device=home),
            torch.zeros((3, num_classes), dtype=torch.int32, device=home))


def _train_volumes(forward, model, x, lb, vols: List[slice], denom, home, gen,
                   num_classes: int, background: int, loss, counts,
                   spans: Optional[HostSpans] = None,
                   sid: Optional[int] = None):
    """The forwards and backwards of one chunk of a batch, one per slice of
    ``vols`` (``_volumes``: one per volume on the fused path, one for the
    chunk otherwise), each loss the NLL sum over the whole batch's valid
    count ``denom``, so the gradients add up in the parameters to the
    batch mean's. Returns ``loss`` and ``counts`` (on ``home``) with the
    chunk's added. Each volume's phases are spans of step ``sid`` in
    ``spans``: ``forward``, ``loss`` (labels, cross-entropy, the
    division), ``backward`` and ``counts`` (the loss's sum, the confusion
    counts, and the volume's tensors let go, so that freeing them falls in
    a phase)."""
    dev = x.device
    for v in vols:
        with span(spans, "forward", sid, dev):
            logits = forward(x[v], train=True, padded_output=True,
                             dropout_generator=gen)
        with span(spans, "loss", sid, dev):
            lbl = _match_labels(logits, lb[v], background)
            nll, _ = cross_entropy_sum(logits, lbl, background)
            part = nll.to(home) / denom
        with span(spans, "backward", sid, dev):
            if part.requires_grad:
                with model.precision():
                    part.backward()
        with span(spans, "counts", sid, dev):
            loss = loss + part.detach()
            counts = counts + confusion_counts(
                lbl, logits.detach().argmax(-1), num_classes,
                background).to(home)
            del logits, lbl, nll, part
    return loss, counts


def _eval_volumes(forward, model, x, lb, home, num_classes: int,
                  background: int, apply_activation: bool,
                  final_sigmoid: bool):
    """One chunk's eval forwards: (NLL sum, valid count, confusion counts)
    on ``home``; the counts from the raw logits, the NLL from the
    activated outputs with ``apply_activation`` (the eval-mode quirk)."""
    nll = torch.zeros((), dtype=torch.float32, device=home)
    cnt = torch.zeros((), dtype=torch.int64, device=home)
    counts = torch.zeros((3, num_classes), dtype=torch.int32, device=home)
    for v in _volumes(model, x):
        logits = forward(x[v], train=False, apply_final_activation=False,
                         padded_output=True)
        lbl = _match_labels(logits, lb[v], background)
        counts = counts + confusion_counts(lbl, logits.argmax(-1),
                                           num_classes, background).to(home)
        if apply_activation:
            logits = (torch.sigmoid(logits) if final_sigmoid
                      else torch.softmax(logits, -1))
        n, c = cross_entropy_sum(logits, lbl, background)
        nll, cnt = nll + n.to(home), cnt + c.to(home)
    return nll, cnt, counts


def _sgd(params, lr: float, momentum: float) -> torch.optim.SGD:
    return torch.optim.SGD(params, lr=lr, momentum=momentum, dampening=0,
                           nesterov=False, weight_decay=0)


class TrainState:
    """The model (its parameters are the master weights, updated in place),
    its trainable set, and the SGD optimizer that holds the lr and the
    momentum buffers. The momentum rate is the train step's, as in the JAX
    package; a buffer that does not exist yet counts as zero. ``spans``
    (None: nothing recorded) is where the train steps time their phases
    (:func:`make_train_step`)."""

    def __init__(self, model: torch.nn.Module, lr: float,
                 training_layers: Optional[Sequence[str]] = None):
        self.model = model
        self.training_layers = training_layers
        self.optimizer = _sgd(
            freeze.apply_training_layers(model, training_layers), lr, 0.9)
        self.step = 0
        self.spans: Optional[HostSpans] = None

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
    step into ``jax.random.key(0)``.

    With ``state.spans`` set, the call's phases are its spans, one after
    another with no gap, all of step ``state.step`` as ``prep`` reads it:
    ``prep`` (the gradients' reset, the valid count, the dropout
    generator, the route's volumes, the loss and counts at zero), per
    volume those of
    :func:`_train_volumes`, then ``update`` (SGD and the step count)."""

    def step(state: TrainState, inputs: torch.Tensor,
             labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        spans, sid, dev = state.spans, state.step, inputs.device
        with span(spans, "prep", sid, dev):
            _begin(state, model, momentum)
            denom = (labels != background).sum().clamp_min(1).float()
            gen = (dropout_generator(0, sid, dev)
                   if model.dropout > 0 else None)
            vols = _volumes(model, inputs)
            loss, counts = _zeros(num_classes, dev)
        loss, counts = _train_volumes(model, model, inputs, labels, vols,
                                      denom, dev, gen, num_classes,
                                      background, loss, counts, spans, sid)
        with span(spans, "update", sid, dev):
            _finish(state)
        return loss, counts

    return step


def _check_slabs(mesh: Mesh, inputs, labels) -> None:
    if len(inputs) != mesh.space or len(labels) != mesh.space:
        raise ValueError(f"expected {mesh.space} input and label slabs (one "
                         f"per shard), got {len(inputs)} and {len(labels)}")
    for k, (x, lb, d) in enumerate(zip(inputs, labels, mesh.devices)):
        if x.device != d or lb.device != d:
            raise ValueError(f"slab {k} is not on its shard's device {d}")


def _sp_rows(mesh: Mesh, inputs, labels):
    """[(row mesh, input slabs, label slabs)] of an sp step's arguments:
    the slabs themselves on a mesh with one data row, one list of slabs per
    row (``parallel.shard_batch``) otherwise."""
    if mesh.data == 1:
        inputs, labels = [inputs], [labels]
    if len(inputs) != mesh.data or len(labels) != mesh.data:
        raise ValueError(f"expected {mesh.data} data rows, got "
                         f"{len(inputs)} and {len(labels)}")
    rows = [(mesh.row(i), xs, ls)
            for i, (xs, ls) in enumerate(zip(inputs, labels))]
    for row, xs, ls in rows:
        _check_slabs(row, xs, ls)
    return rows


def _check_rows(mesh: Mesh, inputs, labels) -> None:
    if mesh.space != 1:
        raise ValueError(f"the data-parallel step takes a mesh with space 1, "
                         f"got {mesh.space}: use make_train_step_sp")
    if len(inputs) != mesh.data or len(labels) != mesh.data:
        raise ValueError(f"expected {mesh.data} input and label chunks (one "
                         f"per data row), got {len(inputs)} and {len(labels)}")
    for i, (x, lb) in enumerate(zip(inputs, labels)):
        d = mesh.row(i).home
        if x.device != d or lb.device != d:
            raise ValueError(f"chunk {i} is not on its row's device {d}")


def _sp_volume(run, xs, lbs, num_classes: int, background: int, home,
               train: bool, apply_activation: bool = False,
               final_sigmoid: bool = False, **forward_kw):
    """One volume through ``run`` (the model's ``forward_sp``, on the
    row's device: :func:`_replica`; or a row's batch through
    ``forward_sp_nonfused``): (NLL sum, valid count, confusion counts),
    each the sum over the shards on ``home``. The counts come from the raw
    logits; with ``apply_activation`` the NLL from the activated outputs
    (the eval-mode quirk)."""
    logits = run(xs, train=train, apply_final_activation=False,
                 padded_output=True, **forward_kw)
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
    per shard (``parallel.shard_x`` of each), or on a mesh with ``data`` >
    1 one such list per data row (``parallel.shard_batch``). Each volume
    of a row runs through ``model.forward_sp`` (one volume at a time, as
    ``scan_batch`` does), with the weights read on the row's first device;
    its loss is the shards' NLL sum over the whole batch's valid count,
    summed over the shards before one backward, so the gradient of every
    shard and row meets in the parameters; then one SGD-with-momentum
    update of ``state``, as :func:`make_train_step`. The model's
    parameters live on the home device."""

    def step(state: TrainState, inputs, labels
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        _begin(state, model, momentum)
        rows = _sp_rows(mesh, inputs, labels)
        home = mesh.home
        denom = sum((lb != background).sum().to(home)
                    for _, _, ls in rows for lb in ls)
        denom = denom.clamp_min(1).float()
        loss = torch.zeros((), dtype=torch.float32, device=home)
        counts = torch.zeros((3, num_classes), dtype=torch.int32, device=home)
        for row, xs, ls in rows:
            run = _replica(model, row.home, "forward_sp")
            for i in range(int(xs[0].shape[0])):
                nll, _, c = _sp_volume(run, [x[i:i + 1] for x in xs],
                                       [lb[i:i + 1] for lb in ls],
                                       num_classes, background, home,
                                       train=True)
                part = nll / denom
                if part.requires_grad:
                    part.backward()
                loss = loss + part.detach()
                counts = counts + c
        _finish(state)
        return loss, counts

    return step


def make_eval_step_sp(model: torch.nn.Module, num_classes: int, mesh: Mesh,
                      background: int = -1, apply_activation: bool = True,
                      final_sigmoid: bool = False) -> Callable:
    """The spatial-parallel eval step (``make_eval_step_sp`` of the JAX
    package): ``step(inputs, labels) -> (loss, counts)`` on slabs (per
    data row on a mesh with ``data`` > 1), one volume at a time, the
    shards' and rows' sums added as :func:`make_train_step_sp` adds them;
    loss and counts as :func:`make_eval_step`."""

    @torch.no_grad()
    def step(inputs, labels) -> Tuple[torch.Tensor, torch.Tensor]:
        rows = _sp_rows(mesh, inputs, labels)
        home = mesh.home
        nll = torch.zeros((), dtype=torch.float32, device=home)
        cnt = torch.zeros((), dtype=torch.int64, device=home)
        counts = torch.zeros((3, num_classes), dtype=torch.int32, device=home)
        for row, xs, ls in rows:
            run = _replica(model, row.home, "forward_sp")
            for i in range(int(xs[0].shape[0])):
                n, c, cc = _sp_volume(run, [x[i:i + 1] for x in xs],
                                      [lb[i:i + 1] for lb in ls], num_classes,
                                      background, home, train=False,
                                      apply_activation=apply_activation,
                                      final_sigmoid=final_sigmoid)
                nll, cnt, counts = nll + n, cnt + c, counts + cc
        return nll / cnt.clamp_min(1), counts

    return step


def make_train_step_sp_halo(model: torch.nn.Module, num_classes: int,
                            mesh: Mesh, momentum: float = 0.9,
                            background: int = -1) -> Callable:
    """The spatially sharded non-fused train step (the JAX package's plain
    step under ``pjit`` with the batch over (data, space)): ``step(state,
    inputs, labels) -> (loss, counts)`` on the mesh's home device, on the
    arguments of :func:`make_train_step_sp`. Each data row runs its whole
    batch in one ``model.forward_sp_nonfused`` with the weights read on
    the row's first device; its loss is the shards' NLL sum over the
    whole batch's valid count, then one backward per row and one
    SGD-with-momentum update, as :func:`make_train_step_sp`. With dropout,
    row i draws its masks from ``dropout_generator(0, state.step, device,
    shard=i)`` as :func:`make_train_step_dp` does, or, on a mesh with one
    data row, from the single-device step's ``dropout_generator(0,
    state.step, device)``: the sharded step is then the step it shards."""

    def step(state: TrainState, inputs, labels
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        _begin(state, model, momentum)
        rows = _sp_rows(mesh, inputs, labels)
        home = mesh.home
        denom = sum((lb != background).sum().to(home)
                    for _, _, ls in rows for lb in ls)
        denom = denom.clamp_min(1).float()
        loss = torch.zeros((), dtype=torch.float32, device=home)
        counts = torch.zeros((3, num_classes), dtype=torch.int32, device=home)
        for i, (row, xs, ls) in enumerate(rows):
            gen = (dropout_generator(0, state.step, row.home,
                                     shard=i if mesh.data > 1 else None)
                   if model.dropout > 0 else None)
            nll, _, c = _sp_volume(
                _replica(model, row.home, "forward_sp_nonfused"), xs, ls,
                num_classes, background, home, train=True,
                dropout_generator=gen)
            part = nll / denom
            if part.requires_grad:
                with model.precision():
                    part.backward()
            loss = loss + part.detach()
            counts = counts + c
        _finish(state)
        return loss, counts

    return step


def make_eval_step_sp_halo(model: torch.nn.Module, num_classes: int,
                           mesh: Mesh, background: int = -1,
                           apply_activation: bool = True,
                           final_sigmoid: bool = False) -> Callable:
    """The spatially sharded non-fused eval step: ``step(inputs, labels)
    -> (loss, counts)`` on the arguments of :func:`make_eval_step_sp`,
    each row's batch in one ``model.forward_sp_nonfused``; loss and counts
    as :func:`make_eval_step`."""

    @torch.no_grad()
    def step(inputs, labels) -> Tuple[torch.Tensor, torch.Tensor]:
        rows = _sp_rows(mesh, inputs, labels)
        home = mesh.home
        nll = torch.zeros((), dtype=torch.float32, device=home)
        cnt = torch.zeros((), dtype=torch.int64, device=home)
        counts = torch.zeros((3, num_classes), dtype=torch.int32, device=home)
        for row, xs, ls in rows:
            n, c, cc = _sp_volume(
                _replica(model, row.home, "forward_sp_nonfused"), xs, ls,
                num_classes, background, home, train=False,
                apply_activation=apply_activation,
                final_sigmoid=final_sigmoid)
            nll, cnt, counts = nll + n, cnt + c, counts + cc
        return nll / cnt.clamp_min(1), counts

    return step


def make_train_step_dp(model: torch.nn.Module, num_classes: int, mesh: Mesh,
                       momentum: float = 0.9, background: int = -1) -> Callable:
    """The data-parallel train step (``train/step.py:412-503`` of the JAX
    package): ``step(state, inputs, labels) -> (loss, counts)`` on the
    mesh's home device, where inputs and labels hold one chunk of the batch
    per data row, on the row's device (``parallel.shard_batch``; the mesh
    has space 1). Each row runs its chunk as :func:`make_train_step` runs a
    batch, one volume at a time on the fused path, with the model's
    weights read on the row's device; each forward's loss is its NLL sum
    over the whole batch's valid count, added on the home device, so the
    loss is the global batch mean, and every row's gradient meets in the
    home parameters' ``.grad`` before one SGD-with-momentum update. With
    dropout, row i's masks come from ``dropout_generator(0, state.step,
    device, shard=i)``. The phases of :func:`make_train_step` go into
    ``state.spans``, ``prep`` and ``update`` timed on the home device,
    each row's volumes on the row's; the loss and counts run on through
    the rows, so one volume per row adds them as the single-device step
    does."""

    def step(state: TrainState, inputs: Sequence[torch.Tensor],
             labels: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        spans, sid, home = state.spans, state.step, mesh.home
        with span(spans, "prep", sid, home):
            _begin(state, model, momentum)
            _check_rows(mesh, inputs, labels)
            denom = sum((lb != background).sum().to(home) for lb in labels)
            denom = denom.clamp_min(1).float()
            rows = [(_replica(model, x.device), x, lb, _volumes(model, x),
                     dropout_generator(0, sid, x.device, shard=i)
                     if model.dropout > 0 else None)
                    for i, (x, lb) in enumerate(zip(inputs, labels))]
            loss, counts = _zeros(num_classes, home)
        for forward, x, lb, vols, gen in rows:
            loss, counts = _train_volumes(forward, model, x, lb, vols, denom,
                                          home, gen, num_classes, background,
                                          loss, counts, spans, sid)
        with span(spans, "update", sid, home):
            _finish(state)
        return loss, counts

    return step


def make_eval_step_dp(model: torch.nn.Module, num_classes: int, mesh: Mesh,
                      background: int = -1, apply_activation: bool = True,
                      final_sigmoid: bool = False) -> Callable:
    """The data-parallel eval step (``train/step.py:631-671`` of the JAX
    package): ``step(inputs, labels) -> (loss, counts)`` on the chunks of
    :func:`make_train_step_dp`, each row's NLL sums, valid counts and
    confusion counts added on the home device before the division; loss
    and counts as :func:`make_eval_step`."""

    @torch.no_grad()
    def step(inputs: Sequence[torch.Tensor],
             labels: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        _check_rows(mesh, inputs, labels)
        home = mesh.home
        nll = torch.zeros((), dtype=torch.float32, device=home)
        cnt = torch.zeros((), dtype=torch.int64, device=home)
        counts = torch.zeros((3, num_classes), dtype=torch.int32, device=home)
        for x, lb in zip(inputs, labels):
            n, c, cc = _eval_volumes(_replica(model, x.device), model, x, lb,
                                     home, num_classes, background,
                                     apply_activation, final_sigmoid)
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
        nll, cnt, counts = _eval_volumes(model, model, inputs, labels,
                                         inputs.device, num_classes,
                                         background, apply_activation,
                                         final_sigmoid)
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
