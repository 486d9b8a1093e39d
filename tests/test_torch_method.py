"""The port's method and experiment helpers against their JAX twins on the
CPU: the K-fold split (against sklearn), ``threshold_vote``, the
controllers, the batch pipeline, ``make_predict_fn``, the tensorboard
writer, the checkpointer, the ``cuda`` field, and epoch- and fold-level
resume.

Tolerances: everything here is exact except ``make_predict_fn`` (f32
forwards of two frameworks, the ROADMAP's 2e-4 logit bar) and the resumed
runs (the same torch CPU program replayed, held to rtol 1e-6).
"""

import json
import os
import os.path as op
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.model_selection import KFold

from unetsulc_tpu.data import pipeline as jax_pipeline
from unetsulc_tpu.data.dataset import SulciDataset as JaxDataset
from unetsulc_tpu.experiment.driver import threshold_vote as jax_vote
from unetsulc_tpu.experiment.tensorboard import SummaryWriter as JaxWriter
from unetsulc_tpu.io.graph import make_synthetic_graph
from unetsulc_tpu.models.torch_interop import params_from_state_dict
from unetsulc_tpu.models.unet3d import UNet3D as JaxUNet3D
from unetsulc_tpu.models.unet3d import make_apply_fn
from unetsulc_tpu.train import controllers as jax_ctrl
from unetsulc_tpu.train.step import make_predict_fn as jax_predict_fn
from unetsulc_tpu_torch import main as port_main
from unetsulc_tpu_torch.config import Parameters, TpuConfig
from unetsulc_tpu_torch.data import pipeline
from unetsulc_tpu_torch.data.dataset import SulciDataset
from unetsulc_tpu_torch.experiment.driver import (
    kfold_splits,
    run_experiment,
    threshold_vote,
)
from unetsulc_tpu_torch.experiment.tensorboard import SummaryWriter
from unetsulc_tpu_torch.method.training import TrainingSulciLabeller
from unetsulc_tpu_torch.models.unet3d import UNet3D
from unetsulc_tpu_torch.train import controllers
from unetsulc_tpu_torch.train.checkpoint import TrainCheckpointer
from unetsulc_tpu_torch.train.step import TrainState, make_predict_fn
from torch_threads import torch_one_thread  # noqa: F401,E402

SMALL = {"name": "M", "num_filter": 4}
# f32, synchronous loading, the non-fused path (cuDNN's place on the CPU:
# the fastest route for these tests)
FAST = {"compute_dtype": "float32", "prefetch": 0, "pallas_blocks": False}


# ---------------------------------------------------------------------------
# the K-fold split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [2, 3, 4, 5])
def test_kfold_matches_sklearn(k):
    for n in range(max(3, k), 14):
        want = list(KFold(n_splits=k, shuffle=True, random_state=0).split(
            np.arange(n)))
        got = list(kfold_splits(n, k))
        assert len(got) == len(want) == k
        for (gtr, gte), (wtr, wte) in zip(got, want):
            np.testing.assert_array_equal(gtr, wtr)
            np.testing.assert_array_equal(gte, wte)


# ---------------------------------------------------------------------------
# threshold_vote
# ---------------------------------------------------------------------------


def _vote_cases():
    r = np.random.default_rng(5)
    yield {10: [[50.0, 60.0], [70.0], [10.0]],
           50: [[55.0, 55.0], [70.0], [20.0]]}  # test_experiment's ties
    # scores from a few values, so ties are frequent; string keys as JSON
    # gives them back
    for folds, ths in ((3, [10, 20, 30, 40]), (5, [20, 50, 80])):
        yield {str(th): [list(r.choice([40.0, 45.0, 50.0], 2))
                         for _ in range(folds)] for th in ths}
    yield {}


@pytest.mark.parametrize("case", list(_vote_cases()),
                         ids=["ties", "four_th", "five_folds", "empty"])
def test_threshold_vote_matches_jax(case):
    results = {"threshold_scores": case}
    want = jax_vote(results, rng=np.random.default_rng(3))
    got = threshold_vote(results, rng=np.random.default_rng(3))
    assert got == want


# ---------------------------------------------------------------------------
# controllers
# ---------------------------------------------------------------------------

LOSSES = [1.0, 0.9, 0.95, 0.97, 0.96, 0.8, 0.85, 0.85, 0.9, 0.7, 0.75, 0.76,
          0.77, 0.78]


@pytest.mark.parametrize("name,kw", [
    ("EarlyStopping", {"patience": 3}),
    ("DivideLr", {"patience": 2, "repeat": 2}),
    ("FineTunning", {"patience": 2}),
])
def test_controllers_match_jax(name, kw, capsys):
    a = getattr(controllers, name)(**kw)
    b = getattr(jax_ctrl, name)(**kw)
    for loss in LOSSES:
        a(loss)
        b(loss)
        assert vars(a) == vars(b), loss


# ---------------------------------------------------------------------------
# the batch pipeline
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def point_clouds():
    labels = ["S.C._left", "S.T.s._left", "F.C.M._left", "unknown"]
    bck2, names = {}, {}
    for i, extent in enumerate((24, 40, 28, 60, 30)):
        from unetsulc_tpu.data.extract import extract_data

        d = extract_data(make_synthetic_graph(
            np.random.default_rng(40 + i), labels, n_folds_per_label=2,
            points_per_fold=30, extent=extent))
        bck2[f"g{i}"] = np.asarray(d["bck2"])
        names[f"g{i}"] = np.asarray(d["names"])
    return {n: i for i, n in enumerate(labels)}, bck2, names


@pytest.mark.parametrize("batch,fixed", [(1, False), (2, False), (2, True)],
                         ids=["bucket_b1", "grouped_b2", "fixed_b2"])
def test_iterate_batches_match_jax(point_clouds, batch, fixed):
    sulci, bck2, names = point_clouds
    files = sorted(bck2)

    def batches(mod, cls):
        ds = cls(files, sulci, train=True, dict_bck2=bck2, dict_names=names,
                 seed=42)
        size = mod.choose_static_size(ds, num_epochs=2) if fixed else None
        if size is not None:
            ds.img_size = list(size)
        return size, list(mod.iterate_batches(ds, batch, size, epoch=1))

    size_p, got = batches(pipeline, SulciDataset)
    size_j, want = batches(jax_pipeline, JaxDataset)
    assert size_p == size_j
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g.real == w.real
        np.testing.assert_array_equal(g.inputs, w.inputs)
        np.testing.assert_array_equal(g.labels, w.labels)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_device_iterator_on_cpu(point_clouds, prefetch):
    sulci, bck2, names = point_clouds
    ds = SulciDataset(sorted(bck2), sulci, train=False, dict_bck2=bck2,
                      dict_names=names)
    want = list(pipeline.iterate_batches(ds, 1))
    got = list(pipeline.device_iterator(iter(want), "cpu", prefetch=prefetch))
    assert len(got) == len(want)
    for (x, lb, real), w in zip(got, want):
        assert lb.dtype == torch.int64 and real == w.real
        np.testing.assert_array_equal(x.numpy(), w.inputs)
        np.testing.assert_array_equal(lb.numpy(), w.labels)


# ---------------------------------------------------------------------------
# make_predict_fn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("final_sigmoid,activation",
                         [(False, True), (True, True), (False, False)])
def test_predict_fn_matches_jax(final_sigmoid, activation):
    kw = dict(in_channels=1, out_channels=4, init_channel_number=4,
              final_sigmoid=final_sigmoid)
    port = UNet3D(**kw, compute_dtype=torch.float32, device="cpu", seed=3)
    params = params_from_state_dict(
        {k: v.numpy() for k, v in port.state_dict().items()})
    jmodel = JaxUNet3D(**kw, compute_dtype=jnp.float32, pallas_blocks=False)
    x = (np.random.default_rng(2).random((1, 12, 10, 16, 1)) < 0.2).astype(
        np.float32)
    want = np.asarray(jax_predict_fn(make_apply_fn(jmodel), activation,
                                     final_sigmoid)(params, jnp.asarray(x)))
    got = make_predict_fn(port, activation, final_sigmoid)(torch.from_numpy(x))
    assert got.shape == want.shape == (1, 12, 10, 16, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# tensorboard events, checkpoints, the device field
# ---------------------------------------------------------------------------


def test_tensorboard_events_match_jax(tmp_path):
    tb = pytest.importorskip(
        "tensorboard.backend.event_processing.event_accumulator")
    for cls, d in ((SummaryWriter, "port"), (JaxWriter, "jax")):
        w = cls(str(tmp_path / d))
        for step, v in enumerate([2.5, 1.25, 0.625]):
            w.add_scalar("Loss/train", v, step)
            w.add_scalar("Accuracy/val", 1 - v / 4, step)
        w.close()
    read = {}
    for d in ("port", "jax"):
        acc = tb.EventAccumulator(str(tmp_path / d))
        acc.Reload()
        read[d] = {t: [(s.step, s.value) for s in acc.Scalars(t)]
                   for t in acc.Tags()["scalars"]}
    assert read["port"] == read["jax"]
    assert set(read["port"]) == {"Loss/train", "Accuracy/val"}


def test_checkpointer_roundtrip_and_retention(tmp_path):
    model = UNet3D(in_channels=1, out_channels=3, init_channel_number=4,
                   device="cpu", compute_dtype=torch.float32)
    state = TrainState.create(model, lr=0.1, training_layers=["final_conv"])
    model.final_conv.weight.grad = torch.ones_like(model.final_conv.weight)
    model.final_conv.bias.grad = torch.ones_like(model.final_conv.bias)
    state.optimizer.step()
    state.step = 5
    state.divide_lr(10.0, reset_momentum=False)
    best = {k: v.clone() for k, v in model.state_dict().items()}
    ck = TrainCheckpointer(str(tmp_path / "ck"), keep=2)
    for e in range(4):
        ck.save(e, {"state": state, "best": best}, {"epoch": e, "note": e})
    assert ck.epochs() == [2, 3]

    other = UNet3D(in_channels=1, out_channels=3, init_channel_number=4,
                   device="cpu", compute_dtype=torch.float32, seed=9)
    st2 = TrainState.create(other, lr=0.5)
    epoch, tree, extra = ck.restore(
        {"state": st2, "best": {k: v.clone() for k, v in best.items()}})
    assert epoch == 3 and extra["note"] == 3
    assert tree["state"] is st2 and st2.step == 5
    assert st2.lr == pytest.approx(0.01)
    assert st2.training_layers == ["final_conv"]
    assert not other.encoders[0].double_conv.conv1.weight.requires_grad
    for k, v in model.state_dict().items():
        torch.testing.assert_close(other.state_dict()[k], v, rtol=0, atol=0)
    buf = st2.optimizer.state[other.final_conv.weight]["momentum_buffer"]
    torch.testing.assert_close(buf, torch.ones_like(buf), rtol=0, atol=0)


@pytest.mark.parametrize("cuda,want", [(None, "cuda"), (-1, "cpu"),
                                       (0, "cuda:0"), (2, "cuda:2")])
def test_parameters_cuda_field(cuda, want):
    d = {"cohort_name": "C"}
    if cuda is not None:
        d["cuda"] = cuda
    assert Parameters.from_dict(d).device() == want


@pytest.fixture()
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is usable")


def _write_params(wp, cohort_dir, **over):
    shutil.copytree(str(cohort_dir / "cohorts"), op.join(wp, "cohorts"))
    d = {"working_path": wp, "cohort_name": "Synth6", "hemi": "L",
         "batch_size": 2, "lr": 0.05, "momentum": 0.9, "n_cvinner": 2,
         "n_epochs": 1, "th_range": [], "dict_model": dict(SMALL),
         "tpu": dict(FAST), **over}
    path = op.join(wp, "parameters.json")
    with open(path, "w") as f:
        json.dump(d, f)
    return path


def test_cli_device_flag_overrides_file(no_cuda, cohort_dir, tmp_path):
    """A file without ``cuda`` means the card, and raises here; ``--device
    cpu`` runs it on the CPU."""
    path = _write_params(str(tmp_path / "wp"), cohort_dir)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main.main(["-p", path])
    results = port_main.main(["-p", path, "--device", "cpu"])
    assert len(results["best_acc"]) == 2


# ---------------------------------------------------------------------------
# resume
# ---------------------------------------------------------------------------


def test_fold_level_resume(cohort_dir, tmp_path):
    """The driver skips completed folds with tpu.resume: a run whose
    results hold 2 of 3 folds reruns only the third, and gives the
    uninterrupted run's numbers."""
    wp = str(tmp_path / "wp")
    path = _write_params(wp, cohort_dir, cuda=-1, n_cvinner=3,
                         tpu={**FAST, "resume": True})
    full = run_experiment(Parameters.from_file(path))
    results_path = op.join(wp, "results", "M_results.json")
    with open(results_path) as f:
        r = json.load(f)
    for key in ("lr", "best_acc", "epoch_loss_train"):
        r[key] = r[key][:2]
    with open(results_path, "w") as f:
        json.dump(r, f)
    resumed = run_experiment(Parameters.from_file(path))
    assert resumed["best_acc"][:2] == r["best_acc"]
    assert len(resumed["lr"]) == 3
    np.testing.assert_allclose(resumed["best_acc"], full["best_acc"],
                               rtol=1e-6)
    np.testing.assert_allclose(resumed["epoch_loss_train"][2],
                               full["epoch_loss_train"][2], rtol=1e-6)


def test_epoch_level_resume(cohort_dir, tmp_path):
    """learning() restores a mid-fold epoch snapshot and gives the curves
    of the uninterrupted run."""
    wp = str(tmp_path / "wp")
    shutil.copytree(str(cohort_dir / "cohorts"), op.join(wp, "cohorts"))
    with open(op.join(wp, "cohorts", "cohort-Synth6_hemi-L.json")) as f:
        graphs = [s["graph"] for s in json.load(f)["subjects"]]

    def run():
        m = TrainingSulciLabeller(
            graphs, "L", working_path=wp, dict_model=dict(SMALL),
            tpu=TpuConfig(**FAST, checkpoint_every=1, resume=True),
            device="cpu")
        m.extract_data_from_graphs()
        m.learning(lr=0.05, momentum=0.9, num_epochs=3,
                   gfile_list_train=graphs[:4], gfile_list_test=graphs[4:],
                   batch_size=2, patience={"divide_lr": 1})
        return m.results

    full = run()
    assert len(full["epoch_loss_val"][0]) == 3
    # keep=2 left epochs 1 and 2: drop 2, as a run cut after epoch 1
    ckdir = op.join(wp, "checkpoints", "M", "cv0")
    assert sorted(os.listdir(ckdir)) == ["epoch_00001", "epoch_00002"]
    shutil.rmtree(op.join(ckdir, "epoch_00002"))
    resumed = run()
    for key in ("epoch_loss_val", "epoch_loss_train", "epoch_acc_val"):
        assert len(resumed[key][0]) == 3
        np.testing.assert_allclose(resumed[key][0], full[key][0], rtol=1e-6)
    assert resumed["divide_lr_epoch"] == full["divide_lr_epoch"]
    assert resumed["best_acc"] == full["best_acc"]


# ---------------------------------------------------------------------------
# the rest of the driver: fold merging, both hemispheres, evaluation CSVs
# ---------------------------------------------------------------------------


def test_merge_fold_results_matches_jax():
    from unetsulc_tpu.experiment.driver import merge_fold_results as jax_merge
    from unetsulc_tpu_torch.experiment.driver import merge_fold_results

    folds = [{"lr": [0.1], "best_acc": [0.5], "patience": {"a": 1},
              "train_image_size": [32, 32, 48],
              "threshold_scores": {10: [[1.0, 2.0]], 50: [[3.0]]}},
             {"lr": [0.1], "best_acc": [0.7], "patience": {"a": 1},
              "train_image_size": [48, 48, 48],
              "threshold_scores": {10: [[4.0]], 50: [[5.0, 6.0]]}}]
    got, want = {}, {}
    for f in folds:
        merge_fold_results(got, json.loads(json.dumps(f)))
        jax_merge(want, json.loads(json.dumps(f)))
    assert got == want
    assert got["train_image_size"] == [32, 32, 48, [48, 48, 48]]


def test_evaluation_rows_match_jax():
    from unetsulc_tpu.experiment.evaluation import _row_for_subject as jax_row
    from unetsulc_tpu_torch.experiment.evaluation import _row_for_subject

    r = np.random.default_rng(0)
    sulci = ["a", "b", "c", "unknown"]
    ytrue, ypred = r.integers(0, 4, 300), r.integers(0, 4, 300)
    assert _row_for_subject(ytrue, ypred, sulci, sulci[:3]) == jax_row(
        ytrue, ypred, sulci, sulci[:3])


def test_evaluate_and_both_hemispheres(cohort_dir, tmp_path):
    """``tpu.evaluate`` writes one CSV per fold (a row per test subject),
    and ``run_both_hemispheres`` runs L and R as two experiments."""
    import csv

    from unetsulc_tpu_torch.experiment.driver import run_both_hemispheres

    wp = str(tmp_path / "wp")
    path = _write_params(wp, cohort_dir, cuda=-1,
                         tpu={**FAST, "evaluate": True})
    shutil.copy(op.join(wp, "cohorts", "cohort-Synth6_hemi-L.json"),
                op.join(wp, "cohorts", "cohort-Synth6_hemi-R.json"))
    results = run_both_hemispheres(Parameters.from_file(path))
    assert set(results) == {"L", "R"}
    for hemi in ("L", "R"):
        name = f"M_hemi{hemi}"
        assert op.exists(op.join(wp, "results", f"{name}_results.json"))
        for cvi in range(2):
            with open(op.join(wp, "evaluations", name, f"{name}_cv{cvi}",
                              f"cohort-Synth6_hemi-{hemi}.csv")) as f:
                rows = list(csv.DictReader(f))
            assert len(rows) == 3 and "ESI" in rows[0]


# ---------------------------------------------------------------------------
# routing: the counterpart of _cached_steps
# ---------------------------------------------------------------------------


def test_route_steps_records_and_raises(cohort_dir, tmp_path):
    from unetsulc_tpu_torch.method.training import _route_steps

    def model(**kw):
        return UNet3D(in_channels=1, out_channels=3, init_channel_number=4,
                      device="cpu", **kw)

    _, _, mesh, rec = _route_steps(model(compute_dtype=torch.float32), 3, 0.9)
    assert mesh is None and rec == {
        "step": "single_device", "kernels": "fused", "data_parallel": 1,
        "spatial_parallel": 1, "sp_fallback": False}
    _, _, mesh, rec = _route_steps(model(), 3, 0.9, spatial=2)
    assert rec["step"] == "sp_mesh" and rec["kernels"] == "fused"
    assert mesh.space == 2 and all(d.type == "cpu" for d in mesh.devices)
    nonfused = model(interpolate=False)
    assert _route_steps(nonfused, 3, 0.9)[3]["kernels"] == "nonfused"
    with pytest.raises(NotImplementedError, match="item 6"):
        _route_steps(nonfused, 3, 0.9, spatial=2)
    with pytest.raises(NotImplementedError, match="item 6"):
        _route_steps(model(), 3, 0.9, spatial=3)
    with pytest.raises(NotImplementedError, match="item 5"):
        _route_steps(model(), 3, 0.9, dp=2)
    path = _write_params(str(tmp_path / "wp"), cohort_dir, cuda=-1,
                         tpu={**FAST, "fold_parallel": 2})
    with pytest.raises(NotImplementedError, match="item 5"):
        run_experiment(Parameters.from_file(path))
