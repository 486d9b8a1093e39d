"""The port's training path against the JAX package's, on the CPU (f32).

Whole-model references run the JAX ``UNet3D``'s XLA path
(``pallas_blocks=False``) under ``jax.jit``: ``test_pallas.py``
(``test_unet_pallas_path_matches_xla``, ``test_pallas_train_step_matches_xla``)
pins that path to the Pallas one, and a whole-model gradient through
interpret-mode Pallas would cost minutes here. The port runs its fused
pipeline with the plain versions of kernels A-E (CPU tensors). Parameters
are the port's seeded init, perturbed from a numpy seed off the ReLU ties
of a zero-bias init (test_pallas.py:221-225), and carried across with
``state_dict_from_jax_params``; inputs and labels come from numpy seeds.
Each JAX reference is computed once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unetsulc_tpu.models.torch_interop import params_from_state_dict
from unetsulc_tpu.models.unet3d import UNet3D as JaxUNet3D
from unetsulc_tpu.models.unet3d import make_apply_fn
from unetsulc_tpu.ops.esi import confusion_counts as jax_confusion_counts
from unetsulc_tpu.ops.losses import cross_entropy_ignore as jax_ce
from unetsulc_tpu.train import step as jax_step
from unetsulc_tpu_torch.models.interop import state_dict_from_jax_params
from unetsulc_tpu_torch.models.unet3d import UNet3D
from unetsulc_tpu_torch.ops import conv_fused as cf
from unetsulc_tpu_torch.ops.esi import confusion_counts
from unetsulc_tpu_torch.ops.losses import cross_entropy_ignore
from unetsulc_tpu_torch.train import freeze
from unetsulc_tpu_torch.train.step import (
    TrainState,
    _match_labels,
    make_eval_step,
    make_train_step,
)
from torch_threads import torch_one_thread  # noqa: F401,E402

MODEL = dict(in_channels=1, out_channels=5, init_channel_number=8)
SHAPE = (9, 8, 10)
LR = 0.05


def _jax_params(num_conv, seed):
    init = UNet3D(**MODEL, num_conv=num_conv, compute_dtype=torch.float32,
                  device="cpu").state_dict()
    params = params_from_state_dict({k: v.numpy() for k, v in init.items()})
    leaves, treedef = jax.tree_util.tree_flatten(params)
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(treedef, [
        (v + 0.03 * r.standard_normal(v.shape)).astype(np.float32)
        for v in leaves
    ])


def _port_model(params, num_conv=1):
    m = UNet3D(**MODEL, num_conv=num_conv, compute_dtype=torch.float32,
               device="cpu")
    m.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return m


def _jax_model(num_conv=1):
    return JaxUNet3D(**MODEL, num_conv=num_conv, compute_dtype=jnp.float32,
                     pallas_blocks=False)


def _batch(seed, n):
    """test_pallas.py:266-270's inputs and labels, ``n`` volumes."""
    r = np.random.default_rng(seed)
    x = (r.random((n, *SHAPE, 1)) < 0.15).astype(np.float32)
    labels = np.where(r.random((n, *SHAPE)) < 0.1,
                      r.integers(0, 5, (n, *SHAPE)), -1).astype(np.int32)
    return x, labels


def _assert_params_close(model, jax_params, rtol=2e-4, atol=2e-4):
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, jax_params))
    got = dict(model.named_parameters())
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), v.numpy(),
                                   rtol=rtol, atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# (c) every parameter gradient of the whole model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[1, 2], ids=["num_conv1", "num_conv2"])
def model_grads(request):
    num_conv = request.param
    r = np.random.default_rng(0)
    x = (r.random((1, *SHAPE, 1)) < 0.1).astype(np.float32)
    gy = r.standard_normal((1, *SHAPE, 5)).astype(np.float32)
    params = _jax_params(num_conv, seed=7)
    mx = _jax_model(num_conv)
    grads = jax.jit(jax.grad(lambda p: jnp.sum(
        mx.apply({"params": p}, jnp.asarray(x), train=True) * gy)))(params)
    return num_conv, x, gy, params, grads


def test_unet_param_grads_match_jax(model_grads):
    """Every parameter's gradient of sum(logits * gy), each scaled by
    max(1, max |g|), rtol=atol=2e-4: test_pallas.py:244-256's bar."""
    num_conv, x, gy, params, grads = model_grads
    m = _port_model(params, num_conv)
    out = m(torch.from_numpy(x), train=True)
    (out * torch.from_numpy(gy)).sum().backward()
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, grads))
    got = dict(m.named_parameters())
    assert got.keys() == want.keys()
    for k, v in want.items():
        scale = max(1.0, float(v.abs().max()))
        np.testing.assert_allclose(got[k].grad.numpy() / scale,
                                   v.numpy() / scale, rtol=2e-4, atol=2e-4,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# (d) train steps, batch 1 and batch 2
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_train_step():
    """One jitted JAX train step shared by the tests: each trainable
    partition compiles once."""
    return jax_step.make_train_step(make_apply_fn(_jax_model()), num_classes=5,
                                    donate=False, scan_batch=True)


@pytest.mark.parametrize("n", [1, 2], ids=["batch1", "batch2"])
def test_train_steps_match_jax(jax_train_step, n):
    """Two make_train_step steps from the same parameters: loss within
    1e-5, confusion counts equal, updated parameters rtol=atol=2e-4
    (test_pallas.py:259-299's bar). Batch 2 runs against the JAX step's
    ``scan_batch=True``: one batch-1 volume at a time, the exact batch
    mean.

    The seeds keep every pre-activation away from 0: with parameter seed
    9 instead, one of decoders.0.conv2's lies within f32 rounding of 0,
    its ReLU gate differs between the two packages' sums, and the
    gradients of the layers below it move by up to 5%."""
    x, labels = _batch(3, n)
    params = _jax_params(1, seed=7)
    jstate = jax_step.TrainState.create(params, lr=LR)
    m = _port_model(params)
    state = TrainState.create(m, lr=LR)
    step = make_train_step(m, num_classes=5)
    xt, lt = torch.from_numpy(x), torch.from_numpy(labels).long()
    for _ in range(2):
        jstate, jloss, jcounts = jax_train_step(jstate, jnp.asarray(x),
                                                jnp.asarray(labels))
        loss, counts = step(state, xt, lt)
        assert abs(float(loss) - float(jloss)) < 1e-5
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    _assert_params_close(m, jstate.params)
    assert state.step == 2


# ---------------------------------------------------------------------------
# (e) freezing, repartition, divide_lr
# ---------------------------------------------------------------------------


def test_freeze_repartition_divide_lr_match_jax(jax_train_step, monkeypatch):
    """A ``["final_conv"]`` step leaves every trunk parameter bit-identical
    and calls no backward of the fused ops (no plain kernel C, D or E:
    the frozen trunk records no graph); ``repartition(None)`` then trains
    everything, and ``divide_lr`` divides the lr by 10 and resets the
    momentum. Each step's loss and the parameters after it match the JAX
    TrainState's same sequence (1e-5; rtol=atol=2e-4)."""
    calls = []

    def counted(name):
        fn = getattr(cf, name)

        def call(*args, **kw):
            calls.append(name)
            return fn(*args, **kw)
        return call

    for name in ("conv_dx", "conv_wgrad", "pool_bwd"):
        monkeypatch.setattr(cf, name, counted(name))
    x, labels = _batch(4, 1)
    xj, lj = jnp.asarray(x), jnp.asarray(labels)
    xt, lt = torch.from_numpy(x), torch.from_numpy(labels).long()
    params = _jax_params(1, seed=13)
    m = _port_model(params)
    trunk0 = {k: v.detach().clone() for k, v in m.named_parameters()
              if not k.startswith("final_conv")}

    jstate = jax_step.TrainState.create(params, lr=LR,
                                        training_layers=["final_conv"])
    state = TrainState.create(m, lr=LR, training_layers=["final_conv"])
    step = make_train_step(m, num_classes=5)
    assert freeze.trainable_names(m, ["final_conv"]) == [
        "final_conv.bias", "final_conv.weight"]

    def both():
        nonlocal jstate
        jstate, jloss, _ = jax_train_step(jstate, xj, lj)
        loss, _ = step(state, xt, lt)
        assert abs(float(loss) - float(jloss)) < 1e-5
        _assert_params_close(m, jstate.params)

    both()
    assert calls == []
    for k, v in m.named_parameters():
        if k in trunk0:
            assert torch.equal(v, trunk0[k]), k
            assert not v.requires_grad and v.grad is None
    jstate = jstate.repartition(None)
    state.repartition(None)
    both()
    assert sorted(set(calls)) == ["conv_dx", "conv_wgrad", "pool_bwd"]
    jstate = jstate.divide_lr()
    state.divide_lr()
    assert state.lr == pytest.approx(LR / 10)
    assert not state.optimizer.state  # momentum reset
    both()


# ---------------------------------------------------------------------------
# eval step, losses, counts, label layout
# ---------------------------------------------------------------------------


def test_eval_step_matches_jax():
    """make_eval_step: the loss on the softmax (the reference's eval-mode
    quirk) within 1e-5, counts equal, over a batch of 2 volumes."""
    x, labels = _batch(5, 2)
    params = _jax_params(1, seed=3)
    jstep = jax_step.make_eval_step(make_apply_fn(_jax_model()), num_classes=5)
    jloss, jcounts = jstep(params, jnp.asarray(x), jnp.asarray(labels))
    loss, counts = make_eval_step(_port_model(params), num_classes=5)(
        torch.from_numpy(x), torch.from_numpy(labels).long())
    assert abs(float(loss) - float(jloss)) < 1e-5
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))


@pytest.mark.parametrize("background_only", [False, True])
def test_cross_entropy_ignore_matches_jax(background_only):
    """Masked mean CE within 1e-6 relative; a batch that is all background
    gives 0, not NaN."""
    r = np.random.default_rng(8)
    logits = r.standard_normal((4, 5, 6, 7)).astype(np.float32) * 3
    labels = np.where(r.random((4, 5, 6)) < 0.3, r.integers(0, 7, (4, 5, 6)),
                      -1).astype(np.int32)
    if background_only:
        labels[:] = -1
    want = float(jax_ce(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(cross_entropy_ignore(torch.from_numpy(logits),
                                     torch.from_numpy(labels).long()))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-7)
    if background_only:
        assert got == 0.0


def test_confusion_counts_match_jax():
    r = np.random.default_rng(9)
    t = np.where(r.random(500) < 0.7, r.integers(0, 6, 500), -1).astype(np.int32)
    p = r.integers(0, 6, 500).astype(np.int32)
    want = np.asarray(jax_confusion_counts(jnp.asarray(t), jnp.asarray(p), 6))
    got = confusion_counts(torch.from_numpy(t), torch.from_numpy(p), 6)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_match_labels_pads_with_background():
    labels = torch.arange(60).reshape(1, 3, 4, 5)
    out = _match_labels(torch.zeros((5, 6, 7, 2)), labels, -1)
    assert tuple(out.shape) == (5, 6, 7)
    assert torch.equal(out[1:-1, 1:-1, 1:-1], labels[0])
    out[1:-1, 1:-1, 1:-1] = -1
    assert bool((out == -1).all())
    with pytest.raises(ValueError, match="batch 1"):
        _match_labels(torch.zeros((5, 6, 7, 2)), labels.repeat(2, 1, 1, 1), -1)
