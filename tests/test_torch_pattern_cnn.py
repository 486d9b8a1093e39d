"""The pattern classifier's port against the JAX package's, on the CPU.

``PatternDataset`` items against JAX's, bit for bit; ``PatternCNN3D``'s
forward, the loss and gradients at the states of three Adam steps, the
Adam update and one whole step, from carried weights (f32, narrow widths,
16^3), against JAX's ``PatternCNN3D`` and ``make_pattern_train_step``
under ``jax.jit``; and the port's ``train_pattern_classifier`` at
``tests/test_pattern_cnn.py``'s size and bars. Each JAX reference is
computed once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unetsulc_tpu.data.dataset import PatternDataset as JaxPatternDataset
from unetsulc_tpu.io.container import save_graph_npz
from unetsulc_tpu.io.graph import Vertex, make_synthetic_graph
from unetsulc_tpu.models.pattern_cnn import PatternCNN3D as JaxPatternCNN3D
from unetsulc_tpu.models.pattern_cnn import make_pattern_train_step as jax_step
from unetsulc_tpu_torch.data.dataset import PatternDataset
from unetsulc_tpu_torch.models.interop import pattern_state_dict_from_jax_params
from unetsulc_tpu_torch.models.pattern_cnn import (
    PatternCNN3D,
    bce_with_logits,
    make_pattern_train_step,
    train_pattern_classifier,
)
from torch_threads import torch_one_thread  # noqa: F401,E402

# the last stage at 64 channels, GroupNorm(32, 64) as in the default
# (16, 32, 64): with one channel per group there, each channel's mean over
# space is its GroupNorm bias exactly, so the head's mean-readout weights
# get a gradient of pure rounding, which Adam's first step turns into
# +-lr in either package
CHANNELS = (8, 16, 64)
SHAPE = (16, 16, 16)
LR = 3e-3


def _pattern_graphs(root, n, extent=30, prefix="L"):
    """``tests/test_pattern_cnn.py``'s graphs: every other one with a dense
    'S.C._left' blob near a corner (the pattern); file names start with
    ``prefix`` (the hemisphere the dataset reads from the name)."""
    files, labels = [], []
    for i in range(n):
        has_pattern = i % 2 == 0
        rng = np.random.default_rng(i)
        g = make_synthetic_graph(rng, ["F.C.M._left"], n_folds_per_label=2,
                                 points_per_fold=60, extent=extent)
        if has_pattern:
            blob = rng.integers(2, 10, size=(80, 3)).astype(np.int32)
            g.add_vertex(Vertex(index=99, name="S.C._left",
                                buckets={"aims_ss": blob}))
        p = str(root / f"{prefix}_subj{i}.npz")
        save_graph_npz(g, p)
        files.append(p)
        labels.append(int(has_pattern))
    return files, labels


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_pattern_dataset_items_match_jax(tmp_path, train):
    """Every item of two epochs bit-equal to JAX's (volume and label),
    with an 'R' file among the 'L' ones (the mirrored extraction)."""
    files, _ = _pattern_graphs(tmp_path, 3)
    rfiles, _ = _pattern_graphs(tmp_path, 2, prefix="R")
    files = files + rfiles[1:]
    bb = [[-12, 20], [2, 29], [0, 33]]  # flipped 'R' x is negative
    want = JaxPatternDataset(files, pattern="S.C.", bb=bb, train=train, seed=4)
    got = PatternDataset(files, pattern="S.C.", bb=bb, train=train, seed=4)
    for epoch in range(2):
        want.set_epoch(epoch)
        got.set_epoch(epoch)
        for i in range(len(files)):
            (wv, wl), (gv, gl) = want[i], got[i]
            assert gv.dtype == wv.dtype and gv.shape == wv.shape
            np.testing.assert_array_equal(gv, wv)
            assert gl == wl
            assert gv.sum() > 0


@pytest.fixture(scope="module")
def reference():
    """JAX's initial parameters with a random head (the zero head would
    hide the trunk from the forward and the first gradient), an input batch
    of 4 and labels, the JAX forward, and three JAX Adam steps: the state
    before each (parameters p_k), its loss and gradient, and p_3."""
    r = np.random.default_rng(0)
    x = (r.random((4, *SHAPE, 1)) < 0.1).astype(np.float32)
    y = np.asarray([1, 0, 1, 0], np.float32)
    model = JaxPatternCNN3D(channels=CHANNELS, compute_dtype=jnp.float32)
    params = jax.tree.map(np.asarray, model.init(
        jax.random.key(0), jnp.asarray(x))["params"])
    params["head"] = {
        k: (0.1 * r.standard_normal(v.shape)).astype(np.float32)
        for k, v in params["head"].items()}
    logits = np.asarray(jax.jit(model.apply)({"params": params},
                                             jnp.asarray(x)))

    def loss_fn(p):
        logit = model.apply({"params": p}, jnp.asarray(x))
        yy = jnp.asarray(y)
        return jnp.mean(jnp.maximum(logit, 0) - logit * yy
                        + jnp.log1p(jnp.exp(-jnp.abs(logit))))

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    tx, step = jax_step(model, LR)
    p, opt = params, tx.init(params)
    states, losses, grads = [params], [], []
    for _ in range(3):
        loss, g = grad_fn(p)
        p, opt, step_loss = step(p, opt, jnp.asarray(x), jnp.asarray(y))
        assert float(step_loss) == float(loss)
        losses.append(float(loss))
        grads.append(jax.tree.map(np.asarray, g))
        states.append(jax.tree.map(np.asarray, p))
    return dict(x=x, y=y, params=params, logits=logits, losses=losses,
                grads=grads, states=states)


def _port_model(params):
    m = PatternCNN3D(channels=CHANNELS, compute_dtype=torch.float32,
                     device="cpu")
    m.load_state_dict(pattern_state_dict_from_jax_params(params), strict=True)
    return m


def test_pattern_cnn_forward_matches_jax(reference):
    """Logits from carried weights at rtol=atol=2e-4 (ROADMAP's f32
    parity bar)."""
    m = _port_model(reference["params"])
    with torch.no_grad():
        got = m(torch.from_numpy(reference["x"]), train=False).numpy()
    assert got.shape == (4,) and got.dtype == np.float32
    np.testing.assert_allclose(got, reference["logits"], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_pattern_step_loss_and_grads_match_jax(reference, k):
    """The state before each of JAX's three Adam steps, carried across:
    the step's loss (``bce_with_logits``, the trainer's stable form) at
    rtol 1e-5, and every parameter's gradient within 1e-4 of its largest
    |g| (f32 sums in another order)."""
    m = _port_model(reference["states"][k])
    loss = bce_with_logits(m(torch.from_numpy(reference["x"])),
                           torch.from_numpy(reference["y"]))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), reference["losses"][k],
                               rtol=1e-5)
    want = pattern_state_dict_from_jax_params(reference["grads"][k])
    got = dict(m.named_parameters())
    assert got.keys() == want.keys()
    for n, v in want.items():
        np.testing.assert_allclose(got[n].grad.numpy(), v.numpy(), rtol=0,
                                   atol=1e-4 * float(v.abs().max()),
                                   err_msg=f"state {k}: {n}")


def test_pattern_adam_matches_optax(reference):
    """``make_pattern_train_step``'s optimizer is ``optax.adam(lr)``: fed
    JAX's three gradients, it gives JAX's parameters after each step at
    rtol 1e-4, atol 3e-5 lr. optax forms its bias corrections from f32
    betas (1 - 0.999 in f32 is 1.3e-5 off), torch from Python floats, so
    each update may differ by ~7e-6 of lr."""
    m = _port_model(reference["states"][0])
    opt, _ = make_pattern_train_step(m, LR)
    for k in range(3):
        grads = pattern_state_dict_from_jax_params(reference["grads"][k])
        for n, p in m.named_parameters():
            p.grad = grads[n].clone()
        opt.step()
        want = pattern_state_dict_from_jax_params(reference["states"][k + 1])
        for n, p in m.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                       rtol=1e-4, atol=3e-5 * LR,
                                       err_msg=f"step {k + 1}: {n}")


def test_pattern_train_step_is_loss_backward_adam(reference):
    """One ``step(x, y)`` from JAX's initial state returns a detached
    device scalar, JAX's first loss at rtol 1e-5, and leaves the
    parameters bit-equal to the sigmoid-BCE backward and one
    ``torch.optim.Adam`` step (lr, betas (0.9, 0.999), eps 1e-8), whose
    parts the two tests above hold to JAX. The whole steps are held apart
    there: Adam scales each entry by its own gradient, so an entry at 1e-7
    of its parameter's largest |g| moves by its rounding, a few % of lr;
    end to end the losses drift to 4.8e-4 relative by step 3 while every
    gradient agrees within 4.4e-6 of its largest |g|."""
    x, y = torch.from_numpy(reference["x"]), torch.from_numpy(reference["y"])
    m = _port_model(reference["states"][0])
    _, step = make_pattern_train_step(m, LR)
    loss = step(x, y)
    assert not loss.requires_grad and loss.shape == ()
    np.testing.assert_allclose(float(loss), reference["losses"][0], rtol=1e-5)
    ref = _port_model(reference["states"][0])
    opt = torch.optim.Adam(ref.parameters(), lr=LR, betas=(0.9, 0.999),
                           eps=1e-8)
    want = bce_with_logits(ref(x), y)
    want.backward()
    opt.step()
    assert torch.equal(loss, want.detach())
    for (n, p), q in zip(m.named_parameters(), ref.parameters()):
        assert torch.equal(p, q), n


def test_pattern_cnn_head_starts_at_zero():
    """The head's weight and bias start at zero (pattern_cnn.py:54-62 of
    the JAX package), so every initial logit is 0; the trunk's init comes
    from the generator."""
    a = PatternCNN3D(device="cpu", generator=torch.Generator().manual_seed(1))
    b = PatternCNN3D(device="cpu", generator=torch.Generator().manual_seed(1))
    assert not a.head.weight.any() and not a.head.bias.any()
    assert all(torch.equal(u, v) for u, v in zip(a.parameters(),
                                                 b.parameters()))
    assert a.compute_dtype == torch.bfloat16
    with torch.no_grad():
        out = a(torch.ones((2, 8, 8, 8, 1)))
    assert torch.equal(out, torch.zeros(2))


def test_train_pattern_classifier_learns(tmp_path):
    """``tests/test_pattern_cnn.py`` on the port: 12 graphs, half with the
    pattern, a 32^3 box, channels (8, 16), 30 epochs at lr 3e-3, batch 4;
    the final loss below the first and an eval accuracy of 0.9."""
    files, labels = _pattern_graphs(tmp_path, 12)
    bb = [[0, 31], [0, 31], [0, 31]]
    train_ds = PatternDataset(files, pattern="S.C.", bb=bb, train=True)
    eval_ds = PatternDataset(files, pattern="S.C.", bb=bb, train=False)
    assert [train_ds[i][1] for i in range(12)] == labels
    model, hist = train_pattern_classifier(
        train_ds, num_epochs=30, lr=3e-3, batch_size=4, channels=(8, 16),
        eval_dataset=eval_ds, device="cpu")
    assert isinstance(model, PatternCNN3D)
    assert len(hist["loss"]) == len(hist["eval_acc"]) == 30
    assert hist["loss"][-1] < hist["loss"][0]
    assert max(hist["eval_acc"]) >= 0.9
