"""The port's CV experiment against the JAX package's, end to end on the
CPU: the ``cohort_dir`` fixture (six synthetic graphs) through both
drivers, 3 folds, 2 epochs, batch 2, ``num_filter`` 8, f32, ``cuda`` -1;
then a transfer-learning experiment from the same ``.mdsm`` through both.

The port runs through its CLI in process (``unetsulc_tpu_torch.main``).
Initial weights cannot match across frameworks (``jax.random.key(0)``
against a ``torch.Generator``), so the port starts from JAX's initial
parameters (and, for transfer, from JAX's swapped head): the test patches
the port's ``load_network`` / ``load_model`` to load them, never the
package. Both run their plain f32 paths (``pallas_blocks: false``: the JAX
XLA path, the port's non-fused path), each experiment once per module.

Tolerances and their reasons:

* exact: the splits (``graphs_train`` / ``graphs_test``), the results
  keys, the per-fold records that do not depend on training, the artifact
  names, the voted threshold's presence;
* each fold's first-epoch train loss: rtol 1e-3. Both frameworks run the
  same f32 arithmetic in another order, and after each SGD step a
  pre-activation within rounding of 0 can take the other side of its ReLU
  gate (ROADMAP.md §3), so the second step's loss already differs in the
  last digits; later epochs drift further and are held only to be finite;
* the threshold scores of the trained models: the schema only.
"""

import json
import os
import os.path as op
import shutil

import jax
import numpy as np
import pytest

from unetsulc_tpu.config import Parameters as JaxParameters
from unetsulc_tpu.experiment.driver import run_experiment as jax_run
from unetsulc_tpu.method.training import TrainingSulciLabeller as JaxTraining
from unetsulc_tpu.method.transfer import TransferSulciLabeller as JaxTransfer
from unetsulc_tpu_torch import main as port_main
from unetsulc_tpu_torch.method.training import TrainingSulciLabeller
from unetsulc_tpu_torch.method.transfer import TransferSulciLabeller
from unetsulc_tpu_torch.models.interop import state_dict_from_jax_params
from torch_threads import torch_one_thread  # noqa: F401,E402

TPU = {"compute_dtype": "float32", "prefetch": 0, "pallas_blocks": False}
TRAIN = {
    "learning": "training", "cuda": -1, "cohort_name": "Synth6", "hemi": "L",
    "batch_size": 2, "lr": 0.05, "momentum": 0.9, "n_cvinner": 3,
    "n_epochs": 2, "th_range": [10, 50],
    "dict_model": {"name": "SmokeModel", "num_filter": 8}, "patience": {},
    "tpu": TPU,
}


def _transfer(wp_src):
    model_dir = op.join(wp_src, "models", "SmokeModel")
    return {
        **TRAIN, "learning": "transfer_learning", "n_cvinner": 2,
        "th_range": [10],
        "dict_model": {"name": "TransferSmoke", "num_filter": 8,
                       "training_layers": ["final_conv"],
                       "fine_tunning_layers": ["decoders.2"], "num_conv": 2},
        "dict_trained_model": {
            "model_file": op.join(model_dir, "SmokeModel_cv0_model.mdsm"),
            "out_channels": op.join(model_dir, "SmokeModel_cv0_params.json"),
            "init_channel_number": 8,
        },
        "patience": {"fine_tunning": 1},
    }


def _workdir(root, name, cohort_dir):
    wp = str(root / name)
    shutil.copytree(str(cohort_dir / "cohorts"), op.join(wp, "cohorts"))
    return wp


def _capture(cls, method, seen):
    """Wrap ``cls.method`` to record the JAX method's parameters after it
    ran (the initial or transferred weights)."""
    orig = getattr(cls, method)

    def wrapped(self, *a, **kw):
        orig(self, *a, **kw)
        seen.append(jax.tree.map(np.asarray, self.params))

    return wrapped


def _loading(cls, method, params):
    """Wrap the port's ``cls.method`` to load JAX's ``params`` into the
    model it built."""
    orig = getattr(cls, method)

    def wrapped(self, *a, **kw):
        orig(self, *a, **kw)
        self.model.load_state_dict(state_dict_from_jax_params(params),
                                   strict=True)

    return wrapped


def _port_cli(wp, d):
    path = op.join(wp, "parameters.json")
    with open(path, "w") as f:
        json.dump({**d, "working_path": wp}, f)
    return port_main.main(["-p", path])


@pytest.fixture(scope="module")
def runs(cohort_dir, tmp_path_factory):
    root = tmp_path_factory.mktemp("experiments")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        init, head = [], []
        mp.setattr(JaxTraining, "load_network",
                   _capture(JaxTraining, "load_network", init))
        mp.setattr(JaxTransfer, "load_model",
                   _capture(JaxTransfer, "load_model", head))
        wj = _workdir(root, "jax", cohort_dir)
        out["jax"] = (wj, jax_run(JaxParameters.from_dict(
            {**TRAIN, "working_path": wj})))
        wjt = _workdir(root, "jax_transfer", cohort_dir)
        out["jax_transfer"] = (wjt, jax_run(JaxParameters.from_dict(
            {**_transfer(wj), "working_path": wjt})))

        # every fold starts from the same initial weights (seed 0), and
        # every transfer fold from the same trunk and head (seed 42)
        mp.setattr(TrainingSulciLabeller, "load_network",
                   _loading(TrainingSulciLabeller, "load_network", init[0]))
        mp.setattr(TransferSulciLabeller, "load_model",
                   _loading(TransferSulciLabeller, "load_model", head[0]))
        wpp = _workdir(root, "port", cohort_dir)
        out["port"] = (wpp, _port_cli(wpp, TRAIN))
        # the transfer experiment starts from JAX's fold-0 model
        wpt = _workdir(root, "port_transfer", cohort_dir)
        out["port_transfer"] = (wpt, _port_cli(wpt, _transfer(wj)))
    return out


def _tree(wp):
    """The artifact tree under ``wp``: relative file paths, with each
    tensorboard event file (its name holds host, pid and time) as its
    directory."""
    files = set()
    for d, _, names in os.walk(wp):
        for n in names:
            rel = op.relpath(op.join(d, n), wp)
            if rel.startswith("cohorts") or n == "parameters.json":
                continue
            files.add(op.dirname(rel) + "/<events>"
                      if n.startswith("events.out.tfevents") else rel)
    return files


@pytest.mark.parametrize("which", ["", "_transfer"])
def test_splits_match(runs, which):
    _, rj = runs["jax" + which]
    _, rp = runs["port" + which]
    assert rp["graphs_train"] == rj["graphs_train"]
    assert rp["graphs_test"] == rj["graphs_test"]


@pytest.mark.parametrize("which", ["", "_transfer"])
def test_results_schema_matches(runs, which):
    _, rj = runs["jax" + which]
    _, rp = runs["port" + which]
    assert set(rp) == set(rj)
    folds = len(rj["lr"])
    for key in ("lr", "momentum", "batch_size", "patience",
                "num_epochs" if not which else "num_epoch"):
        assert rp[key] == rj[key], key
    for key, val in rj.items():
        if isinstance(val, list) and key not in ("train_image_size",
                                                 "val_image_size"):
            assert len(rp[key]) == len(val), key
    assert set(rp["threshold_scores"]) == set(rj["threshold_scores"])
    for th, scores in rp["threshold_scores"].items():
        assert len(scores) == folds
        assert [len(s) for s in scores] == [
            len(s) for s in rj["threshold_scores"][th]]
    # the fixed image sizes are data, not training: equal
    assert rp["train_image_size"] == rj["train_image_size"]
    assert rp["val_image_size"] == rj["val_image_size"]
    # the routing record: JAX's keys; the port names its own kernels route
    for rec_p, rec_j in zip(rp["tpu"], rj["tpu"]):
        assert set(rec_p) == set(rec_j)
        assert rec_j["kernels"] == "xla" and rec_p["kernels"] == "nonfused"
        for k in ("step", "data_parallel", "spatial_parallel", "sp_fallback"):
            assert rec_p[k] == rec_j[k], k


@pytest.mark.parametrize("which", ["", "_transfer"])
def test_artifact_tree_matches(runs, which):
    wj, _ = runs["jax" + which]
    wp, _ = runs["port" + which]
    tree = _tree(wp)
    assert tree == _tree(wj)
    name = "SmokeModel" if not which else "TransferSmoke"
    folds = 3 if not which else 2
    for cvi in range(folds):
        assert f"models/{name}/{name}_cv{cvi}_model.mdsm" in tree
        assert f"models/{name}/{name}_cv{cvi}_params.json" in tree
        assert f"tensorboard/{name}/cv{cvi}/<events>" in tree
    with open(op.join(wp, "models", name, f"{name}_params.json")) as f:
        gparams = json.load(f)
    assert "cutting_threshold" in gparams
    with open(op.join(wp, "data", "cohort-Synth6_hemi-L_data.json")) as f:
        data = json.load(f)
    with open(op.join(runs["jax" + which][0], "data",
                      "cohort-Synth6_hemi-L_data.json")) as f:
        assert json.load(f) == data
    assert gparams["dict_model"]["out_channels"] == len(data["sulci_side_list"])


@pytest.mark.parametrize("which", ["", "_transfer"])
def test_fold_losses_match(runs, which):
    _, rj = runs["jax" + which]
    _, rp = runs["port" + which]
    for fold_p, fold_j in zip(rp["epoch_loss_train"], rj["epoch_loss_train"]):
        np.testing.assert_allclose(fold_p[0], fold_j[0], rtol=1e-3)
    for key in ("epoch_loss_train", "epoch_loss_val", "epoch_acc_train",
                "epoch_acc_val"):
        assert np.isfinite(np.asarray(rp[key], float)).all(), key


def test_transfer_fine_tunes_as_jax(runs):
    _, rj = runs["jax_transfer"]
    _, rp = runs["port_transfer"]
    # the forced unfreeze at int(0.8 * 2) = 1 in every fold
    assert rp["fine_tunning_epoch"] == rj["fine_tunning_epoch"] == [1, 1]
