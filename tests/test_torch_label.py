"""The port's labelling path against the JAX package's, on the CPU.

Two synthetic graphs (32^3 bucket) and a small model (init 8) that the JAX
side writes as ``.mdsm``: both ``SulciLabeller``s label them in f32, then
both ``label.py`` CLIs run in-process on the same inputs.
"""

import csv
import importlib.util
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
from unetsulc_tpu.data.extract import extract_data as jax_extract_data
from unetsulc_tpu.io.container import read_graph as jax_read_graph
from unetsulc_tpu.io.container import save_graph_npz
from unetsulc_tpu.io.graph import make_synthetic_graph
from unetsulc_tpu.io.mdsm import write_state_dict
from unetsulc_tpu.method.base import SulciLabeller as JaxLabeller
from unetsulc_tpu_torch import label as torch_label_cli
from unetsulc_tpu_torch.config import TpuConfig
from unetsulc_tpu_torch.data.extract import extract_data
from unetsulc_tpu_torch.data.voxelize import bucket_size
from unetsulc_tpu_torch.io.container import read_graph
from unetsulc_tpu_torch.method.base import SulciLabeller
from unetsulc_tpu_torch.models.unet3d import UNet3D
from torch_threads import torch_one_thread  # noqa: F401,E402

LABELS = ["S.C._left", "S.T.s._left", "F.C.M._left", "unknown"]
THRESHOLDS = [5, 20]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """Two graphs, a JAX-written ``.mdsm`` and its ``_params.json``."""
    root = tmp_path_factory.mktemp("torch_label")
    graphs = []
    for i in range(2):
        g = make_synthetic_graph(
            np.random.default_rng(300 + i), LABELS, n_folds_per_label=2,
            points_per_fold=50, extent=40, unknown_fraction=0.2,
        )
        path = str(root / f"subj{i}_L.npz")
        save_graph_npz(g, path)
        graphs.append(path)
    # the port's seeded init, perturbed from a numpy seed (as
    # test_pallas.py perturbs its params), written by the JAX package
    init = UNet3D(in_channels=1, out_channels=len(LABELS),
                  init_channel_number=8, compute_dtype=torch.float32,
                  device="cpu").state_dict()
    r = np.random.default_rng(11)
    state = {
        k: (v.numpy() + 0.03 * r.standard_normal(tuple(v.shape))
            ).astype(np.float32)
        for k, v in init.items()
    }
    model_file = str(root / "m_model.mdsm")
    write_state_dict(state, model_file)
    dict_model = {"name": "m", "model_file": model_file,
                  "out_channels": len(LABELS), "init_channel_number": 8,
                  "num_filter": 8}
    params = str(root / "m_params.json")
    with open(params, "w") as f:
        json.dump({"dict_model": dict_model, "sulci_side_list": LABELS,
                   "cutting_threshold": THRESHOLDS[0]}, f)
    return root, graphs, dict_model, params


def _jax_eager_scores(jm, gfile, bck2, names):
    """Softmax of the JAX model's op-by-op forward at the graph's voxels.

    The JAX labeller's jitted forward is not the 1e-4 reference: on the
    CPU, XLA's fused f32 program lands ~2.4e-3 (logits, 32^3, init 8) from
    the same model's op-by-op forward, which the port matches to ~4e-5."""
    imgsize = (bucket_size(int(np.max(bck2 - bck2.min(0))) + 1),) * 3
    vol_in, _ = JaxDataset(
        [gfile], jm.dict_sulci, train=False, dict_bck2={gfile: bck2},
        dict_names={gfile: names}, img_size=imgsize,
    )[0]
    logits = jm.model_def.apply({"params": jm.params}, jnp.asarray(vol_in[None]),
                                train=False, apply_final_activation=False)
    c = (bck2 - bck2.min(0)).T
    return np.asarray(jax.nn.softmax(logits[0][c[0], c[1], c[2]], axis=-1))


def test_labelling_and_device_vote_match_jax(model_dir):
    """yscores within 1e-4 of the JAX model's f32 forward (only the
    summation order of the convs differs), ypred and device-vote cutting
    for two thresholds equal to the JAX labeller's."""
    _, graphs, dict_model, _ = model_dir
    jm = JaxLabeller([], "L", dict_model=dict_model, dict_bck2={},
                     dict_names={}, sulci_side_list=LABELS,
                     tpu=JaxTpuConfig(compute_dtype="float32"))
    jm.load_saved_model(dict(dict_model))
    tm = SulciLabeller([], "L", dict_model=dict_model, dict_bck2={},
                       dict_names={}, sulci_side_list=LABELS,
                       tpu=TpuConfig(compute_dtype="float32"), device="cpu")
    tm.load_saved_model(dict(dict_model))
    for g in graphs:
        jd = jax_extract_data(jax_read_graph(g))
        td = extract_data(read_graph(g))
        np.testing.assert_array_equal(td["bck2"], jd["bck2"])
        jh = jm._labeling_dispatch(g, bck2=jd["bck2"], names=jd["names"])
        th = tm._labeling_dispatch(g, bck2=td["bck2"], names=td["names"])
        jtrue, jpred, jscores = jm._labeling_fetch(jh)
        ttrue, tpred, tscores = tm._labeling_fetch(th)
        assert ttrue == jtrue
        ref = _jax_eager_scores(jm, g, jd["bck2"], jd["names"])
        np.testing.assert_allclose(tscores, ref, rtol=1e-4, atol=1e-4)
        # the JAX labeller's own (jitted) probabilities, within the gap
        # between its jitted and op-by-op forwards
        np.testing.assert_allclose(tscores, jscores[:len(tscores)], rtol=0,
                                   atol=2e-3)
        assert tpred == jpred
        jcut = jm._cut_labels_device(jh, jd["vert"], jd["bck2"], THRESHOLDS)
        tcut = tm._cut_labels_device(th, td["vert"], td["bck2"], THRESHOLDS)
        np.testing.assert_array_equal(tcut, jcut)


def test_host_vote_thresholds_match_jax(model_dir):
    """``tpu.device_vote: false`` (the scores fetched and cut on the host by
    ``ops.cutting.cutting``) through ``test_thresholds`` on both graphs
    (each its own uncut graph): every threshold's (1 - ESI) * 100 equal
    to the JAX labeller's with ``device_vote: false``, and to the port's
    device vote."""
    _, graphs, dict_model, _ = model_dir
    data = {g: extract_data(read_graph(g)) for g in graphs}
    scores = {}
    for name, cls, cfg, kw, vote in (
            ("jax", JaxLabeller, JaxTpuConfig, {}, False),
            ("host", SulciLabeller, TpuConfig, {"device": "cpu"}, False),
            ("device", SulciLabeller, TpuConfig, {"device": "cpu"}, True)):
        m = cls([], "L", dict_model=dict_model,
                dict_bck2={g: d["bck2"] for g, d in data.items()},
                dict_names={g: d["names"] for g, d in data.items()},
                sulci_side_list=LABELS,
                tpu=cfg(compute_dtype="float32", device_vote=vote), **kw)
        m.load_saved_model(dict(dict_model))
        m.test_thresholds(graphs, graphs, THRESHOLDS, save_results=False)
        scores[name] = {th: list(v) for th, v in m.dict_scores.items()}
    assert sorted(scores["host"]) == THRESHOLDS
    assert all(len(v) == len(graphs) for v in scores["host"].values())
    assert scores["host"] == scores["jax"]
    assert scores["host"] == scores["device"]


def _load_jax_cli():
    path = Path(__file__).resolve().parents[1] / "label.py"
    spec = importlib.util.spec_from_file_location("jax_label_cli", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read_csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_cli_outputs_match_jax_cli(model_dir, monkeypatch):
    """Both CLIs write the same CSV rows (coordinates and true labels) and
    summary keys; the port's runs with ``--device cpu``."""
    root, graphs, _, params = model_dir
    jout, tout = str(root / "jax_out"), str(root / "torch_out")
    monkeypatch.setattr(sys, "argv", ["label.py", "-m", params, "-g",
                                      *graphs, "-o", jout])
    _load_jax_cli().main()
    torch_label_cli.main(["-m", params, "-g", *graphs, "-o", tout,
                          "--device", "cpu"])
    with open(op.join(jout, "labeling_summary.json")) as f:
        jsum = json.load(f)
    with open(op.join(tout, "labeling_summary.json")) as f:
        tsum = json.load(f)
    assert tsum.keys() == jsum.keys()
    for g in graphs:
        assert tsum[g].keys() == jsum[g].keys()
        assert tsum[g]["n_voxels"] == jsum[g]["n_voxels"]
        name = op.splitext(op.basename(g))[0] + "_labels.csv"
        jrows = _read_csv(op.join(jout, name))
        trows = _read_csv(op.join(tout, name))
        assert [r[:4] for r in trows] == [r[:4] for r in jrows]
        assert trows[0] == ["x", "y", "z", "true_label", "pred_label"]
        assert {r[4] for r in trows[1:]} <= set(LABELS)


@pytest.mark.parametrize("ext", [".npz", ".json", ".arg"])
def test_read_graph_and_extract_match_jax(tmp_path, ext):
    """The port's graph readers and extraction give the JAX package's
    arrays for every container format (exact)."""
    from unetsulc_tpu.io.arg_writer import save_graph_arg
    from unetsulc_tpu.io.container import save_graph_json

    g = make_synthetic_graph(np.random.default_rng(5), LABELS, 2, 30, 40,
                             unknown_fraction=0.3)
    path = str(tmp_path / f"g{ext}")
    {".npz": save_graph_npz, ".json": save_graph_json,
     ".arg": save_graph_arg}[ext](g, path)
    jd = jax_extract_data(jax_read_graph(path))
    td = extract_data(read_graph(path))
    assert td.keys() == jd.keys()
    for k in jd:
        np.testing.assert_array_equal(td[k], jd[k], err_msg=k)


def test_voxelize_matches_jax_and_later_scatter_wins():
    """numpy voxelizer == the JAX package's numpy path, and a duplicated
    voxel takes the label of its LAST point."""
    from unetsulc_tpu.data.voxelize import voxelize as jax_voxelize
    from unetsulc_tpu_torch.data.voxelize import voxelize

    r = np.random.default_rng(2)
    pts = r.integers(0, 6, (400, 3))  # many duplicates
    ids = r.integers(0, 5, 400).astype(np.int32)
    vin, vlb = voxelize(pts, ids, img_size=(6, 6, 7))
    jin, jlb = jax_voxelize(pts, ids, img_size=(6, 6, 7), use_native=False)
    np.testing.assert_array_equal(vin, jin)
    np.testing.assert_array_equal(vlb, jlb)
    last = {}
    for p, i in zip(map(tuple, pts), ids):
        last[p] = i
    for p, i in last.items():
        assert vlb[p] == i
