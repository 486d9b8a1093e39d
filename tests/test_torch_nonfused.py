"""The port's non-fused UNet3D path against the JAX package's XLA path, on
the CPU (f32).

The JAX reference is always ``UNet3D(pallas_blocks=False)`` under
``jax.jit``; the port runs its non-fused path, whose GroupNorm takes the
plain versions of its kernels (CPU tensors). Parameters are the port's
seeded init, perturbed from a numpy seed off the ReLU ties of a zero-bias
init (test_pallas.py:221-225), and carried across with
``state_dict_from_jax_params``; inputs and labels come from numpy seeds.
"""

import csv
import importlib.util
import itertools
import json
import os.path as op
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unetsulc_tpu.config import TpuConfig as JaxTpuConfig
from unetsulc_tpu.data.dataset import SulciDataset as JaxDataset
from unetsulc_tpu.io.container import save_graph_npz
from unetsulc_tpu.io.graph import make_synthetic_graph
from unetsulc_tpu.io.mdsm import write_state_dict
from unetsulc_tpu.method.base import SulciLabeller as JaxLabeller
from unetsulc_tpu.models.torch_interop import (
    params_from_state_dict,
    state_dict_from_params,
)
from unetsulc_tpu.models.unet3d import UNet3D as JaxUNet3D
from unetsulc_tpu.models.unet3d import make_apply_fn
from unetsulc_tpu.models.unet3d import max_pool_3d as jax_max_pool_3d
from unetsulc_tpu.train import step as jax_step
from unetsulc_tpu_torch import label as torch_label_cli
from unetsulc_tpu_torch.config import TpuConfig
from unetsulc_tpu_torch.data.extract import extract_data
from unetsulc_tpu_torch.data.voxelize import bucket_size
from unetsulc_tpu_torch.io.container import read_graph
from unetsulc_tpu_torch.method.base import SulciLabeller
from unetsulc_tpu_torch.models.interop import load_mdsm, state_dict_from_jax_params
from unetsulc_tpu_torch.models.unet3d import UNet3D, dropout, max_pool_3d
from unetsulc_tpu_torch.train.step import (
    TrainState,
    dropout_generator,
    make_eval_step,
    make_train_step,
)
from torch_threads import torch_one_thread  # noqa: F401,E402

CLASSES = 7
BASE = dict(out_channels=CLASSES, init_channel_number=8)


def _jax_params(kw, seed=7):
    """Flax params: the port's seeded init of the model ``kw`` mapped to
    the flax tree, every leaf perturbed off its init."""
    init = UNet3D(**kw, compute_dtype=torch.float32, device="cpu").state_dict()
    params = params_from_state_dict({k: v.numpy() for k, v in init.items()})
    leaves, treedef = jax.tree_util.tree_flatten(params)
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(treedef, [
        (v + 0.03 * r.standard_normal(v.shape)).astype(np.float32)
        for v in leaves
    ])


def _port_model(kw, params, **extra):
    m = UNet3D(**kw, compute_dtype=torch.float32, device="cpu", **extra)
    m.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return m


def _jax_model(kw):
    return JaxUNet3D(**kw, compute_dtype=jnp.float32, pallas_blocks=False)


def _input(shape, seed=0):
    r = np.random.default_rng(seed)
    if shape[-1] == 1:  # sparse binary voxels, as the labelling inputs
        return (r.random(shape) < 0.15).astype(np.float32)
    return r.standard_normal(shape).astype(np.float32)


# (model, port-only flags, input shape)
FORWARD_CASES = {
    "transposed-odd": (dict(interpolate=False), {}, (1, 9, 11, 9, 1)),
    "transposed-even": (dict(interpolate=False), {}, (1, 10, 12, 10, 1)),
    "trilinear-unfused": (dict(), dict(fused_blocks=False), (1, 9, 10, 11, 1)),
    "order-cgr": (dict(conv_layer_order="cgr"), {}, (1, 9, 10, 11, 1)),
    "dropout-eval": (dict(dropout=0.2), {}, (1, 9, 10, 11, 1)),
    "batch2": (dict(), {}, (2, 9, 10, 11, 1)),
    "in-channels-10": (dict(), {}, (1, 9, 10, 11, 10)),
    "extent-3": (dict(), {}, (1, 3, 10, 9, 1)),
}


@pytest.mark.parametrize("case", list(FORWARD_CASES))
@torch.no_grad()
def test_nonfused_forward_matches_jax_xla(case):
    """Train-mode logits of the non-fused path within 2e-4 (abs and rel) of
    the JAX XLA path's (the bar of tests/test_model.py against the torch
    oracle); eval-mode probabilities within 1e-5 of its softmax. Each case
    takes the non-fused path; the transposed-conv decoder crops both an
    odd (d+1 rows) and an even (d+2 rows) extent; dropout is off in eval
    mode."""
    change, flags, shape = FORWARD_CASES[case]
    kw = {**BASE, "in_channels": shape[-1], **change}
    params = _jax_params(kw)
    x = _input(shape)
    jm = _jax_model(kw)
    want = np.asarray(jax.jit(lambda p, v: jm.apply(
        {"params": p}, v, train=False, apply_final_activation=False))(
            params, jnp.asarray(x)))
    m = _port_model(kw, params, **flags)
    xt = torch.from_numpy(x)
    assert not m.fused_eligible(xt)
    got = m(xt, train=change.get("dropout", 0) == 0,
            apply_final_activation=False)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape[:4] + (CLASSES,)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    probs = m(xt, train=False).numpy()
    np.testing.assert_allclose(probs, np.asarray(jax.nn.softmax(want, -1)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 7, 6, 5, 3), (1, 8, 9, 4, 2)],
                         ids=["odd", "even"])
def test_max_pool_3d_ties_route_like_jax(shape):
    """MaxPool3d(2, 2, padding 1) on values with exact ties in almost every
    window (three levels, as GroupNorm maps a group's ReLU zeros to one
    value): output equal to JAX's ``max_pool_3d`` and the gradient equal
    too, both routing each window's cotangent to its first maximum."""
    r = np.random.default_rng(9)
    x = r.integers(0, 3, shape).astype(np.float32)
    jx = jnp.asarray(x)
    gy = r.standard_normal(np.asarray(jax_max_pool_3d(jx)).shape).astype(np.float32)
    want, vjp = jax.vjp(jax_max_pool_3d, jx)
    xt = torch.from_numpy(x).requires_grad_()
    got = max_pool_3d(xt)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    got.backward(torch.from_numpy(gy))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(gy))[0]))


def test_nonfused_train_step_matches_jax():
    """One make_train_step step of an interpolate=False model on a batch of
    2 (one batched forward) against the JAX make_train_step on the XLA path
    (no scan): loss rtol 1e-4, confusion counts equal; every parameter's
    gradient rtol 1e-3 with atol 1e-4 x its max |g|. JAX's gradient is read
    off the update p0 - p1 at lr 1 (the momentum buffer starts at 0).
    Parameter seed 7 keeps every pre-activation away from the ReLU's edge
    (ROADMAP.md §3)."""
    kw = dict(BASE, in_channels=1, interpolate=False)
    params = _jax_params(kw, seed=7)
    r = np.random.default_rng(3)
    x = (r.random((2, 9, 8, 10, 1)) < 0.15).astype(np.float32)
    labels = np.where(r.random((2, 9, 8, 10)) < 0.2,
                      r.integers(0, CLASSES, (2, 9, 8, 10)), -1).astype(np.int32)
    jstep = jax_step.make_train_step(make_apply_fn(_jax_model(kw)), CLASSES,
                                     donate=False)
    jstate = jax_step.TrainState.create(params, lr=1.0)
    jstate1, jloss, jcounts = jstep(jstate, jnp.asarray(x), jnp.asarray(labels))

    m = _port_model(kw, params)
    state = TrainState.create(m, lr=1.0)
    calls = []
    fwd = m.forward
    m.forward = lambda v, **k: calls.append(tuple(v.shape)) or fwd(v, **k)
    loss, counts = make_train_step(m, CLASSES)(
        state, torch.from_numpy(x), torch.from_numpy(labels).long())
    assert calls == [x.shape]  # one batched forward
    assert float(loss) == pytest.approx(float(jloss), rel=1e-4)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    p0 = state_dict_from_jax_params(jax.tree.map(np.asarray, params))
    p1 = state_dict_from_jax_params(jax.tree.map(np.asarray, jstate1.params))
    got = dict(m.named_parameters())
    assert got.keys() == p0.keys()
    for k in p0:
        want = (p0[k] - p1[k]).numpy()
        atol = 1e-4 * np.abs(want).max()
        np.testing.assert_allclose(got[k].grad.numpy(), want, rtol=1e-3,
                                   atol=atol, err_msg=k)


def test_nonfused_eval_step_matches_jax():
    """make_eval_step on the non-fused path (one batched forward, dropout
    off) against the JAX eval step: loss within 1e-5, counts equal."""
    kw = dict(BASE, in_channels=1, interpolate=False, dropout=0.1)
    params = _jax_params(kw, seed=5)
    r = np.random.default_rng(6)
    x = (r.random((2, 9, 8, 10, 1)) < 0.15).astype(np.float32)
    labels = np.where(r.random((2, 9, 8, 10)) < 0.2,
                      r.integers(0, CLASSES, (2, 9, 8, 10)), -1).astype(np.int32)
    jloss, jcounts = jax_step.make_eval_step(
        make_apply_fn(_jax_model(kw)), CLASSES)(params, jnp.asarray(x),
                                                jnp.asarray(labels))
    loss, counts = make_eval_step(_port_model(kw, params), CLASSES)(
        torch.from_numpy(x), torch.from_numpy(labels).long())
    assert abs(float(loss) - float(jloss)) < 1e-5
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))


def test_dropout_mask_definition():
    """flax Dropout semantics with a seeded device generator: every value
    is 0 or exactly x / (1 - p); the keep rate is within 4 sigma of 1 - p;
    the same (seed, step) gives the same mask, another step another."""
    p = 0.3
    x = torch.rand((4, 16, 16, 16, 8)) + 0.5  # no zeros of its own
    y = dropout(x, p, dropout_generator(0, 5, "cpu"))
    kept = y != 0
    assert torch.equal(y[kept], x[kept] / (1 - p))
    n = x.numel()
    rate = kept.float().mean().item()
    assert abs(rate - (1 - p)) < 4 * np.sqrt(p * (1 - p) / n)
    assert torch.equal(dropout(x, p, dropout_generator(0, 5, "cpu")), y)
    assert not torch.equal(dropout(x, p, dropout_generator(0, 6, "cpu")), y)
    assert not torch.equal(dropout(x, p, dropout_generator(1, 5, "cpu")), y)


def test_dropout_train_step_runs_and_is_seeded():
    """A non-fused train step with dropout 0.1 on a batch of 2: finite
    loss; the same state and step give the same loss, and train mode
    without a generator raises."""
    kw = dict(BASE, in_channels=1, dropout=0.1)
    params = _jax_params(kw, seed=4)
    r = np.random.default_rng(8)
    x = torch.from_numpy((r.random((2, 9, 8, 10, 1)) < 0.15).astype(np.float32))
    labels = torch.from_numpy(np.where(r.random((2, 9, 8, 10)) < 0.2,
                                       r.integers(0, CLASSES, (2, 9, 8, 10)),
                                       -1)).long()
    losses = []
    for _ in range(2):
        m = _port_model(kw, params)
        losses.append(float(make_train_step(m, CLASSES)(
            TrainState.create(m, lr=0.05), x, labels)[0]))
    assert np.isfinite(losses[0]) and losses[0] == losses[1]
    with pytest.raises(ValueError, match="dropout_generator"):
        m(x, train=True)


def test_interpolate_false_params_load_strict():
    """A JAX interpolate=False parameter tree carries into the port's
    model with ``strict=True`` (the decoders' ``upsample`` ConvTranspose3d
    weights in (I, O, k, k, k), no flip), directly and through a
    JAX-written ``.mdsm``, bit-exact both ways."""
    kw = dict(BASE, in_channels=1, interpolate=False)
    params = _jax_params(kw, seed=2)
    direct = state_dict_from_jax_params(params)
    assert direct["decoders.0.upsample.weight"].shape == (64, 64, 3, 3, 3)
    np.testing.assert_array_equal(
        direct["decoders.2.upsample.weight"].numpy(),
        np.transpose(np.asarray(params["decoders_2"]["upsample"]["kernel"]),
                     (3, 4, 0, 1, 2)))
    m = UNet3D(**kw, compute_dtype=torch.float32, device="cpu")
    m.load_state_dict(direct, strict=True)
    assert m.state_dict().keys() == direct.keys()


@pytest.fixture(scope="module")
def transposed_model_dir(tmp_path_factory):
    """One graph (32^3 bucket), and an interpolate=False model that the
    JAX package writes as ``.mdsm`` with its ``_params.json``."""
    labels = ["S.C._left", "S.T.s._left", "F.C.M._left", "unknown"]
    root = tmp_path_factory.mktemp("torch_nonfused_label")
    g = make_synthetic_graph(np.random.default_rng(301), labels,
                             n_folds_per_label=2, points_per_fold=50,
                             extent=40, unknown_fraction=0.2)
    graph = str(root / "subj_L.npz")
    save_graph_npz(g, graph)
    kw = dict(in_channels=1, out_channels=len(labels), init_channel_number=8,
              interpolate=False)
    model_file = str(root / "t_model.mdsm")
    write_state_dict(state_dict_from_params(_jax_params(kw, seed=11)),
                     model_file)
    dict_model = {"name": "t", "model_file": model_file,
                  "out_channels": len(labels), "init_channel_number": 8,
                  "num_filter": 8, "interpolate": False}
    params = str(root / "t_params.json")
    with open(params, "w") as f:
        json.dump({"dict_model": dict_model, "sulci_side_list": labels,
                   "cutting_threshold": 5}, f)
    return root, graph, dict_model, params, labels


def _load_jax_cli():
    path = Path(__file__).resolve().parents[1] / "label.py"
    spec = importlib.util.spec_from_file_location("jax_label_cli", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read_csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def _jax_eager_scores(jm, graph, bck2, names):
    """Softmax of the JAX model's op-by-op forward at the graph's voxels
    (test_torch_label.py:77-91: on the CPU the JAX labeller's jitted f32
    forward lands ~1e-3 from it)."""
    imgsize = (bucket_size(int(np.max(bck2 - bck2.min(0))) + 1),) * 3
    vol_in, _ = JaxDataset([graph], jm.dict_sulci, train=False,
                           dict_bck2={graph: bck2},
                           dict_names={graph: names}, img_size=imgsize)[0]
    logits = jm.model_def.apply({"params": jm.params},
                                jnp.asarray(vol_in[None]), train=False,
                                apply_final_activation=False)
    c = (bck2 - bck2.min(0)).T
    return np.asarray(jax.nn.softmax(logits[0][c[0], c[1], c[2]], axis=-1))


def test_label_transposed_mdsm_matches_jax(transposed_model_dir, monkeypatch):
    """An interpolate=False ``.mdsm`` written by the JAX package loads into
    the port's labeller (``strict=True``) and labels on the non-fused
    path: scores within 1e-4 of the JAX model's op-by-op f32 forward, the
    same per-voxel argmax; then both ``label.py`` CLIs (the port's with
    ``--device cpu``) write the same CSV rows (coordinates and true labels;
    the cut labels come from scores that differ by the jitted forward's
    gap, as in test_torch_label.py) and summary keys."""
    root, graph, dict_model, params, labels = transposed_model_dir
    assert "decoders.0.upsample.weight" in load_mdsm(dict_model["model_file"])
    jm = JaxLabeller([], "L", dict_model=dict_model, dict_bck2={},
                     dict_names={}, sulci_side_list=labels,
                     tpu=JaxTpuConfig(compute_dtype="float32"))
    jm.load_saved_model(dict(dict_model))
    tm = SulciLabeller([], "L", dict_model=dict_model, dict_bck2={},
                       dict_names={}, sulci_side_list=labels,
                       tpu=TpuConfig(compute_dtype="float32"), device="cpu")
    tm.load_saved_model(dict(dict_model))
    assert not tm.model.interpolate
    d = extract_data(read_graph(graph))
    _, tpred, tscores = tm._labeling_fetch(
        tm._labeling_dispatch(graph, bck2=d["bck2"], names=d["names"]))
    want = _jax_eager_scores(jm, graph, d["bck2"], d["names"])
    np.testing.assert_allclose(tscores, want, rtol=1e-4, atol=1e-4)
    assert tpred == want.argmax(-1).tolist()

    jout, tout = str(root / "jax_out"), str(root / "torch_out")
    monkeypatch.setattr(sys, "argv", ["label.py", "-m", params, "-g", graph,
                                      "-o", jout])
    _load_jax_cli().main()
    torch_label_cli.main(["-m", params, "-g", graph, "-o", tout,
                          "--device", "cpu"])
    name = op.splitext(op.basename(graph))[0] + "_labels.csv"
    trows = _read_csv(op.join(tout, name))
    assert [r[:4] for r in trows] == [r[:4] for r in
                                      _read_csv(op.join(jout, name))]
    assert {r[4] for r in trows[1:]} <= set(labels)
    with open(op.join(jout, "labeling_summary.json")) as f:
        jsum = json.load(f)
    with open(op.join(tout, "labeling_summary.json")) as f:
        tsum = json.load(f)
    assert tsum.keys() == jsum.keys()
    assert tsum[graph]["n_voxels"] == jsum[graph]["n_voxels"]


FLAGS = list(itertools.product(
    [True, False],  # fused_blocks / pallas_blocks
    [1, 2],  # batch
    [0.0, 0.2],  # dropout
    ["crg", "cgr"],  # order
    [True, False],  # interpolate
    [1, 10],  # in_channels
    [(9, 10, 11), (3, 10, 11)],  # extents
))


def test_routing_matches_pallas_eligible(monkeypatch):
    """``fused_eligible`` against the JAX package's ``_pallas_eligible``
    over every combination of the flags (f32 on the CPU, where both take
    the fused path; 990 voxels, inside JAX's interpret-mode size limit):
    equal except for in_channels > 8, which the port's dense entry conv
    does not take. And f32 on CUDA never takes the fused path, bf16 does."""
    for fused, n, p, order, interp, cin, ext in FLAGS:
        kw = dict(BASE, in_channels=cin, dropout=p, conv_layer_order=order,
                  interpolate=interp)
        x = np.zeros((n, *ext, cin), np.float32)
        jm = JaxUNet3D(**kw, compute_dtype=jnp.float32, pallas_blocks=fused)
        want = jm.apply({}, jnp.asarray(x),
                        method=lambda mod, v: mod._pallas_eligible(v))
        m = UNet3D(**kw, compute_dtype=torch.float32, device="cpu",
                   fused_blocks=fused)
        got = m.fused_eligible(torch.from_numpy(x))
        assert got == (want and cin <= 8), (fused, n, p, order, interp, cin, ext)

    x = torch.zeros((1, 9, 10, 11, 1))
    monkeypatch.setattr(UNet3D, "device", property(lambda s: torch.device("cuda")))
    for dtype, fused in ((torch.float32, False), (torch.bfloat16, True)):
        m = UNet3D(**BASE, compute_dtype=dtype, device="cpu")
        assert m.fused_eligible(x) == fused
