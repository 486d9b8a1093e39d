"""The method and experiment layers under data parallelism, on the CPU.

* ``learning()`` at ``tpu.data_parallel: 2`` (batch 2, one fold, one
  epoch) against the JAX package's on two of its eight CPU devices, from
  JAX's initial weights: the first epoch's train and val losses at rtol
  1e-3, the bar of ``test_torch_experiment.py::test_fold_losses_match``
  (both frameworks' f32 arithmetic in another order), the routing record,
  and the bucket-grouped sizes (no fixed image size is recorded). The
  port runs its fused path (plain versions) and its non-fused path; JAX
  its jitted XLA path (no whole-model gradient through interpret-mode
  Pallas).
* the CLI with ``data_parallel: 2`` and ``fold_parallel: 2`` at once: each
  fold's dp mesh is built from its group of two CPU entries.
* an f32 model's ``precision()`` entered from two fold threads whose
  contexts overlap and end in either order: TF32 stays off inside both
  (the flags are process-wide) and comes back after the last.

The fold-parallel runs against the sequential ones are in
``test_torch_experiment.py``, which reuses its module's sequential runs.
"""

import json
import os.path as op
import shutil
import threading

import jax
import numpy as np
import pytest
import torch

from unetsulc_tpu.config import TpuConfig as JaxTpuConfig
from unetsulc_tpu.method.training import TrainingSulciLabeller as JaxTraining
from unetsulc_tpu_torch import main as port_main
from unetsulc_tpu_torch.config import TpuConfig
from unetsulc_tpu_torch.method.training import TrainingSulciLabeller
from unetsulc_tpu_torch.models.interop import state_dict_from_jax_params
from unetsulc_tpu_torch.models.unet3d import UNet3D
from torch_threads import torch_one_thread  # noqa: F401,E402

MODEL = {"name": "DPModel", "num_filter": 8}
LEARN = dict(lr=0.05, momentum=0.9, num_epochs=1, batch_size=2,
             save_results=True)


def _graphs(cohort_dir):
    with open(op.join(str(cohort_dir), "cohorts",
                      "cohort-Synth6_hemi-L.json")) as f:
        return [s["graph"] for s in json.load(f)["subjects"]]


@pytest.fixture(scope="module")
def jax_dp(cohort_dir, tmp_path_factory):
    """JAX's dp learning() and its initial parameters."""
    graphs = _graphs(cohort_dir)
    m = JaxTraining(graphs, "L", working_path=str(tmp_path_factory.mktemp("j")),
                    dict_model=MODEL,
                    tpu=JaxTpuConfig(compute_dtype="float32", prefetch=0,
                                     data_parallel=2, pallas_blocks=False))
    m.extract_data_from_graphs()
    init = []
    orig = m.load_network

    def load_network(*a, **kw):
        orig(*a, **kw)
        init.append(jax.tree.map(np.asarray, m.params))

    m.load_network = load_network
    assert m.learning(gfile_list_train=graphs[:4], gfile_list_test=graphs[4:],
                      **LEARN) == 0
    return m.results, init[0]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "nonfused"])
def test_learning_data_parallel_matches_jax(jax_dp, cohort_dir, tmp_path,
                                            fused):
    rj, init = jax_dp
    graphs = _graphs(cohort_dir)
    m = TrainingSulciLabeller(
        graphs, "L", working_path=str(tmp_path), dict_model=MODEL,
        tpu=TpuConfig(compute_dtype="float32", prefetch=0, data_parallel=2,
                      pallas_blocks=fused),
        device="cpu")
    m.extract_data_from_graphs()
    orig = m.load_network

    def load_network(*a, **kw):
        orig(*a, **kw)
        m.model.load_state_dict(state_dict_from_jax_params(init), strict=True)

    m.load_network = load_network
    assert m.learning(gfile_list_train=graphs[:4], gfile_list_test=graphs[4:],
                      **LEARN) == 0
    rp = m.results
    assert rp["tpu"][0] == {
        "step": "dp_mesh", "kernels": "fused" if fused else "nonfused",
        "data_parallel": 2, "spatial_parallel": 1, "sp_fallback": False}
    assert rj["tpu"][0]["step"] == "dp_shard_map"
    assert "train_image_size" not in rp and "train_image_size" not in rj
    for key in ("epoch_loss_train", "epoch_loss_val"):
        np.testing.assert_allclose(rp[key][0][0], rj[key][0][0], rtol=1e-3,
                                   err_msg=key)


def test_cli_data_and_fold_parallel(cohort_dir, tmp_path):
    """``python -m unetsulc_tpu_torch.main`` with both axes: two folds at
    once, each on a dp mesh of its own two CPU entries."""
    wp = str(tmp_path / "wp")
    shutil.copytree(str(cohort_dir / "cohorts"), op.join(wp, "cohorts"))
    path = op.join(wp, "parameters.json")
    with open(path, "w") as f:
        json.dump({"working_path": wp, "cohort_name": "Synth6", "hemi": "L",
                   "batch_size": 2, "lr": 0.05, "momentum": 0.9,
                   "n_cvinner": 2, "n_epochs": 1, "th_range": [],
                   "dict_model": {"name": "M", "num_filter": 4},
                   "tpu": {"compute_dtype": "float32", "prefetch": 0,
                           "pallas_blocks": False, "data_parallel": 2,
                           "fold_parallel": 2}}, f)
    results = port_main.main(["-p", path, "--device", "cpu"])
    assert results["fold_parallel"] == {
        "n_groups": 2, "groups": [["cpu", "cpu"], ["cpu", "cpu"]],
        "folds": {"0": 0, "1": 1}}
    assert [r["step"] for r in results["tpu"]] == ["dp_mesh", "dp_mesh"]
    assert np.isfinite(np.asarray(results["epoch_loss_train"], float)).all()
    for cvi in range(2):
        assert op.exists(op.join(wp, "models", "M", f"M_cv{cvi}_model.mdsm"))
        assert op.isdir(op.join(wp, "tensorboard", "M", f"cv{cvi}"))


def _tf32_flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@pytest.mark.parametrize("first_out", ["a", "b"])
def test_precision_holds_across_fold_threads(first_out):
    """Thread a enters an f32 model's ``precision()``, thread b enters
    while a is inside, then ``first_out`` leaves first while the other is
    still inside: the flags are off in both threads throughout, and the
    saved flags return once both have left."""
    model = UNet3D(in_channels=1, out_channels=3, init_channel_number=4,
                   compute_dtype=torch.float32, device="cpu")
    saved = _tf32_flags()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    inside = {k: threading.Event() for k in "ab"}
    leave = {k: threading.Event() for k in "ab"}
    seen = {k: [] for k in "ab"}

    def fold(k):
        with model.precision():
            seen[k].append(_tf32_flags())
            inside[k].set()
            leave[k].wait(10)
            seen[k].append(_tf32_flags())

    try:
        threads = {k: threading.Thread(target=fold, args=(k,)) for k in "ab"}
        threads["a"].start()
        assert inside["a"].wait(10)
        threads["b"].start()
        assert inside["b"].wait(10)
        last = "b" if first_out == "a" else "a"
        leave[first_out].set()
        threads[first_out].join(10)
        assert _tf32_flags() == (False, False)  # the other is still inside
        leave[last].set()
        threads[last].join(10)
        assert seen == {k: [(False, False)] * 2 for k in "ab"}
        assert _tf32_flags() == (True, True)
    finally:
        for e in leave.values():
            e.set()
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = saved
