"""Swin UNETR on the port's training path against the benchmark's plain
float32 reference (``benchmark/references/swin_unetr.py``), at a small
size on the CPU: feature size 12 (head dim 4), 32^3 volumes, so
that stages 1 and 2 (16^3 and 8^3 tokens) pad to a multiple of the 7^3
window, roll and mask, and stages 3 and 4 (4^3, 2^3) clip the window to
the grid with no shift. No JAX: the reference is the plain PyTorch one."""

import contextlib
import itertools
import math
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F
from torch_threads import torch_one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from benchmark import weights as bench_weights  # noqa: E402
from benchmark.references import swin_unetr as ref  # noqa: E402
from unetsulc_tpu_torch.config import ModelConfig, TpuConfig  # noqa: E402
from unetsulc_tpu_torch.models.swin_unetr import SwinUNETR  # noqa: E402
from unetsulc_tpu_torch.ops import window_attention as wa  # noqa: E402
from unetsulc_tpu_torch.train import freeze  # noqa: E402
from unetsulc_tpu_torch.train.step import (  # noqa: E402
    TrainState, make_eval_step, make_predict_fn, make_train_step)
from unetsulc_tpu_torch.utils.profiling import HostSpans  # noqa: E402

CLASSES = 5
SMALL = {"feature_size": 12}
CFG = dict(in_channels=1, out_channels=CLASSES, depths=[2, 2, 2, 2],
           num_heads=[3, 6, 12, 24], window_size=7, patch_size=2,
           mlp_ratio=4.0, lr=0.01, momentum=0.9, **SMALL)


def _model(dtype, weights):
    m = SwinUNETR(1, CLASSES, 12, compute_dtype=dtype, device="cpu")
    with torch.no_grad():
        for n, p in m.named_parameters():
            p.copy_(weights[n])
    return m


def _batch(n, seed=5, volume=(32, 32, 32)):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, *volume, 1), generator=g)
    lb = torch.randint(0, CLASSES, (n, *volume), generator=g)
    lb[torch.rand((n, *volume), generator=g) < 0.5] = -1
    return x, lb


@pytest.fixture(scope="module")
def weights():
    return bench_weights.make(ref.param_shapes(CFG), 3, "cpu")


@contextlib.contextmanager
def _leaky_relu_branches(masks: list, replay: bool):
    """LeakyReLU's branch at each input, as the reference took it. A
    pre-activation within f32 rounding of 0 falls on either side when its
    sums run in another order, and its slope (1 or 0.01) then moves every
    gradient upstream of it: one voxel of the 32^3 batch (3e-7 on one
    side, -3e-7 on the other) moves every leaf by ~1e-3. Recording
    (``replay`` False), ``masks`` gets each call's positive inputs, volume
    by volume as the reference runs them; replaying, each call of the
    port's batched forward takes its volumes' branches from ``masks`` in
    that order, and the list yielded gets |x| of every input where the
    port's own branch differed."""
    plain = F.leaky_relu
    flips: list = []
    calls = [0]

    def leaky(x, negative_slope=0.01, inplace=False):
        if not replay:
            masks.append(x.detach() > 0)
            return plain(x, negative_slope)
        per, k = len(masks) // x.shape[0], calls[0]
        calls[0] += 1
        pos = torch.cat([masks[v * per + k].permute(0, 2, 3, 4, 1)
                         for v in range(x.shape[0])])
        flips.extend(x.detach()[pos != (x.detach() > 0)].abs().tolist())
        return torch.where(pos, x, x * negative_slope)

    F.leaky_relu = leaky
    try:
        yield flips
    finally:
        F.leaky_relu = plain


def _reference(weights, x, lb):
    """The reference's logits, one SGD step on the batch, and its
    LeakyReLU branches in that step."""
    with torch.no_grad():
        logits = torch.cat([ref.Net(CFG)(weights, x[i:i + 1].permute(
            0, 4, 1, 2, 3)) for i in range(len(x))]).permute(0, 2, 3, 4, 1)
    masks: list = []
    with _leaky_relu_branches(masks, replay=False):
        steps = ref.train_steps(weights, [(x, lb)], CFG, list(weights))
    return logits, steps, masks


@pytest.fixture(scope="module")
def f32_reference(weights):
    """The reference on a batch of two 32^3 volumes."""
    x, lb = _batch(2)
    return (x, lb, *_reference(weights, x, lb))


def _port_step(model, x, lb):
    state = TrainState.create(model, CFG["lr"])
    loss, counts = make_train_step(model, CLASSES)(state, x, lb)
    names = {id(p): n for n, p in model.named_parameters()}
    grads = {names[id(p)]: s["momentum_buffer"]
             for p, s in state.optimizer.state.items()}
    return float(loss), counts, grads, dict(model.named_parameters())


def _leaf_gaps(mine, theirs):
    """Per leaf, |mine - theirs| over the larger of the leaf's norm and
    the median leaf's."""
    norms = {n: float(t.norm()) for n, t in theirs.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return {n: float((mine[n].float() - theirs[n]).norm()) / max(norms[n], med)
            for n in theirs}


def _check_f32(weights, x, lb, ref_logits, steps, masks, median, worst):
    """The port's f32 logits, loss, counts, every leaf's gradient and the
    parameters after one step against the reference's, on the reference's
    LeakyReLU branches: the gradients' median leaf gap under ``median``,
    the worst under ``worst``. Returns the gradients."""
    model = _model(torch.float32, weights)
    with torch.no_grad():
        logits = model(x, train=True)
    # float32 on both sides, summed in other orders: window attention,
    # 30 LayerNorms and 23 InstanceNorms deep
    scale = float(ref_logits.abs().max())
    assert float((logits - ref_logits).abs().max()) <= 1e-4 * scale
    with _leaky_relu_branches(masks, replay=True) as flips:
        loss, counts, grads, params = _port_step(model, x, lb)
    # the port's own branches differ from the reference's only at inputs
    # within rounding of 0
    assert all(v < 1e-5 for v in flips), flips
    assert loss == pytest.approx(steps["losses"][0], rel=1e-5)
    assert torch.equal(counts.long(), steps["counts"][0].long())
    # every leaf's gradient, as a gap over the larger of its norm and the
    # median leaf's
    assert set(grads) == set(steps["grad1"])
    gaps = sorted(_leaf_gaps(grads, steps["grad1"]).items(),
                  key=lambda kv: kv[1])
    assert gaps[len(gaps) // 2][1] < median, gaps[len(gaps) // 2]
    assert gaps[-1][1] < worst, gaps[-1]
    for n, p in params.items():
        torch.testing.assert_close(p.detach(), steps["params"][n],
                                   rtol=1e-5, atol=1e-6)
    return grads


def test_f32_forward_loss_gradients_and_step_match_reference(weights,
                                                             f32_reference):
    # the same sums in another order: readings 1.1e-6 at the median leaf,
    # 4.7e-6 at the worst, on one thread and on many
    _check_f32(weights, *f32_reference, median=1e-5, worst=1e-4)


def test_f32_deepest_instance_norm_over_three_voxels(weights):
    """At 32 x 32 x 96 ``encoder10`` normalises 1 x 1 x 3 voxels (at 32^3
    one, whose output is 0 and passes no gradient): its InstanceNorms, the
    GroupNorm kernels' formula at one group per channel, against the
    reference's with a gradient through them."""
    x, lb = _batch(1, seed=6, volume=(32, 32, 96))
    # readings 9.2e-6 to 9.7e-6 at the median leaf, 1.3e-4 at the worst
    # (stage 4's attention, upstream of encoder10): the GroupNorm kernels
    # take the variance as E[x^2] - E[x]^2 in f32, which over 3 voxels
    # rounds where the reference's two-pass variance does not (with a
    # two-pass variance in the port: 6e-7 and 2.7e-6)
    grads = _check_f32(weights, x, lb, *_reference(weights, x, lb),
                       median=3e-5, worst=1e-3)
    for k in (1, 2):
        assert grads[f"encoder10.layer.conv{k}.conv.weight"].any()


def _error(logits, grads, ref_logits, ref_grads):
    """(logits' largest gap over their largest magnitude, median leaf gap
    of the first gradient)."""
    lg = float((logits.float() - ref_logits).abs().max()
               / ref_logits.abs().max())
    gaps = sorted(_leaf_gaps(grads, ref_grads).values())
    return lg, gaps[len(gaps) // 2]


# bf16 compute against the f32 reference, on two seeds of weights and
# batch (3 and 5, 4 and 6): the logits' largest gap reads 1.2e-2 and
# 1.0e-2 of their largest magnitude, the median leaf of the first
# gradient 0.127 and 0.126; the fp8 control (e4m3 forward, e5m2
# backward) reads 0.13 and 0.16, 0.53 and 0.52. Each bound lies between
# the two: 3e-2 on the logits, 0.3 on the gradients.
LOGIT_TOL, GRAD_TOL = 3e-2, 0.3


@pytest.mark.parametrize("which", ["bf16_port", "fp8_control"])
def test_bf16_within_tolerance_that_fp8_fails(which, weights, f32_reference):
    x, lb, ref_logits, steps, _ = f32_reference
    if which == "bf16_port":
        model = _model(torch.bfloat16, weights)
        with torch.no_grad():
            logits = model(x, train=True)
        _, _, grads, _ = _port_step(model, x, lb)
    else:
        with torch.no_grad():
            logits = torch.cat([ref.Net(CFG, "fp8")(weights, x[i:i + 1].permute(
                0, 4, 1, 2, 3)) for i in range(2)]).permute(0, 2, 3, 4, 1)
        grads = ref.train_steps(weights, [(x, lb)], CFG, list(weights),
                                "fp8")["grad1"]
    lg, gg = _error(logits, grads, ref_logits, steps["grad1"])
    inside = lg <= LOGIT_TOL and gg <= GRAD_TOL
    assert inside == (which == "bf16_port"), (lg, gg)


def _coords(window):
    return list(itertools.product(*(range(w) for w in window)))


@pytest.mark.parametrize("grid,window,shift", [
    ((16, 16, 16), 7, 3), ((8, 8, 8), 7, 3), ((4, 4, 4), 7, 3),
    ((10, 16, 6), 7, 3), ((8, 8, 8), 7, 0)])
def test_shift_mask_and_bias_index_from_coordinates(grid, window, shift):
    plan = wa.window_plan(grid, (window,) * 3, (shift,) * 3, "cpu",
                          torch.float32)
    ws, ss = plan.window, plan.shift
    assert ws == tuple(min(window, g) for g in grid)
    assert ss == tuple(0 if g <= window else shift for g in grid)
    assert plan.padded == tuple(math.ceil(g / w) * w for g, w in zip(grid, ws))
    # the bias: the module window's (2w-1)^3 table, row of (di, dj, dk)
    # for the first N tokens of the module window, as MONAI's [:n, :n]
    full = _coords((window,) * 3)
    n = math.prod(ws)
    want = torch.tensor([[((a[0] - b[0] + window - 1) * (2 * window - 1)
                           + a[1] - b[1] + window - 1) * (2 * window - 1)
                          + a[2] - b[2] + window - 1
                          for b in full[:n]] for a in full[:n]])
    assert torch.equal(plan.index.view(n, n), want)
    if not any(ss):
        assert plan.mask is None
        return
    # the mask: token (window, position) -> its place in the rolled padded
    # grid -> its region, per axis [0, D-w), [D-w, D-s), [D-s, D)
    counts = [p // w for p, w in zip(plan.padded, ws)]

    def region(place):
        r = 0
        for p, d, w, s in zip(place, plan.padded, ws, ss):
            r = 3 * r + (0 if p < d - w else 1 if p < d - s else 2)
        return r

    wins = list(itertools.product(*(range(c) for c in counts)))
    local = _coords(ws)
    assert plan.mask.shape == (len(wins), len(local), len(local))
    for k, win in enumerate(wins):
        ids = [region([win[a] * ws[a] + t[a] for a in range(3)])
               for t in local]
        want = torch.tensor([[0.0 if i == j else -100.0 for j in ids]
                             for i in ids])
        assert torch.equal(plan.mask[k], want), k


def _labeller(tmp_path, learning="training", **extra):
    from unetsulc_tpu_torch.method.training import TrainingSulciLabeller
    from unetsulc_tpu_torch.method.transfer import TransferSulciLabeller

    cls = (TrainingSulciLabeller if learning == "training"
           else TransferSulciLabeller)
    dict_model = {"name": "Swin", "architecture": "swin_unetr", **SMALL,
                  **extra}
    return cls([], "L", working_path=str(tmp_path), dict_model=dict_model,
               sulci_side_list=[f"S{k}_left" for k in range(CLASSES)],
               tpu=TpuConfig(compute_dtype="float32"), device="cpu")


def test_method_layer_builds_trains_evaluates_predicts_and_saves(tmp_path):
    lab = _labeller(tmp_path)
    lab.load_network(rng_seed=7)
    model = lab.model
    assert isinstance(model, SwinUNETR) and model.feature_size == 12
    assert not model.fused_eligible(torch.zeros(1, 32, 32, 32, 1))
    x, lb = _batch(1, seed=9)
    state = TrainState.create(model, 0.01)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    # the encoder's span, of the step whose forward encloses it
    state.spans = model.spans = HostSpans(timeline=True)
    loss, counts = make_train_step(model, CLASSES)(state, x, lb)
    assert math.isfinite(float(loss)) and state.step == 1
    rec = {r.name: r for r in state.spans.records}
    assert rec["swin_encoder"].step == rec["forward"].step == 0
    assert (rec["forward"].start_ns <= rec["swin_encoder"].start_ns
            <= rec["swin_encoder"].end_ns <= rec["forward"].end_ns)
    state.spans = model.spans = None
    assert int(counts[0].sum() + counts[1].sum()) == int((lb != -1).sum())
    # every parameter got a gradient but encoder10's convs (at 32^3 its
    # InstanceNorm over one voxel gives 0 and passes none), and the head
    # moved
    zero = sorted(n for n, p in model.named_parameters()
                  if not state.optimizer.state[p]["momentum_buffer"].any())
    assert zero == ["encoder10.layer.conv1.conv.weight",
                    "encoder10.layer.conv2.conv.weight"], zero
    assert not torch.equal(model.out.conv.weight, before["out.conv.weight"])
    vloss, vcounts = make_eval_step(model, CLASSES)(x, lb)
    assert math.isfinite(float(vloss))
    probs = make_predict_fn(model)(x)
    assert probs.shape == (1, 32, 32, 32, CLASSES)
    torch.testing.assert_close(probs.sum(-1), torch.ones(1, 32, 32, 32))
    with pytest.raises(ValueError, match="multiples of 32"):
        model(torch.zeros(1, 24, 32, 32, 1))
    # the checkpoint: torch.save's state_dict, loaded strictly by the
    # labelling path into a fresh model of the same architecture
    lab.save_model()
    again = _labeller(tmp_path)
    again.load_saved_model({**again.dict_model, "out_channels": CLASSES,
                            "model_file": lab._model_path(None)})
    for n, p in again.model.named_parameters():
        torch.testing.assert_close(p, dict(model.named_parameters())[n])


def test_transfer_trains_out_only(tmp_path):
    assert ModelConfig.from_dict({"architecture": "swin_unetr"}).training_layers \
        == ["out"]
    lab = _labeller(tmp_path, learning="transfer")
    assert lab.training_layers == ["out"]
    assert lab.fine_tunning_layers == [f"decoder{k}" for k in range(1, 6)]
    lab.load_network(rng_seed=3)
    model = lab.model
    assert freeze.trainable_names(model, lab.training_layers) == [
        "out.conv.bias", "out.conv.weight"]
    state = TrainState.create(model, 0.01, lab.training_layers)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    x, lb = _batch(1, seed=4)
    make_train_step(model, CLASSES)(state, x, lb)
    moved = sorted(n for n, p in model.named_parameters()
                   if not torch.equal(p, before[n]))
    assert moved == ["out.conv.bias", "out.conv.weight"]
