"""The port's side modules against the JAX package's, on the CPU.

``io/arg_writer.py`` (files byte-equal, read back by the port's reader),
the cohort tools and the ``.hie`` writer (equal JSON and bytes), the
``convert_graphs`` CLI (equal ``.npz`` contents), the figures (the same
file names, equal statistics), ``ops/pooling.max_pool_3d`` (bitwise,
forward and backward, ties and an integer input) and
``ops/resize.resize_nearest`` (exact).
"""

import json
import os
import os.path as op
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unetsulc_tpu.figures import model_comparison as jax_mc
from unetsulc_tpu.figures import plot_cohort_features as jax_pcf
from unetsulc_tpu.figures import plot_results as jax_pr
from unetsulc_tpu.io import arg_writer as jax_aw
from unetsulc_tpu.io.container import save_graph_npz as jax_save_npz
from unetsulc_tpu.ops.pooling import max_pool_3d as jax_max_pool_3d
from unetsulc_tpu.ops.resize import resize_nearest as jax_resize_nearest
from unetsulc_tpu.tools import convert_graphs as jax_cg
from unetsulc_tpu.tools import create_sulcal_root_colors as jax_hie
from unetsulc_tpu.tools import select_subjects as jax_ss
from unetsulc_tpu_torch.figures import model_comparison as mc
from unetsulc_tpu_torch.figures import plot_cohort_features as pcf
from unetsulc_tpu_torch.figures import plot_results as pr
from unetsulc_tpu_torch.io import arg_writer as aw
from unetsulc_tpu_torch.io.arg_reader import load_graph_arg
from unetsulc_tpu_torch.io.graph import make_synthetic_graph
from unetsulc_tpu_torch.ops.pooling import max_pool_3d
from unetsulc_tpu_torch.ops.resize import resize_nearest
from unetsulc_tpu_torch.tools import convert_graphs as cg
from unetsulc_tpu_torch.tools import create_sulcal_root_colors as hie
from unetsulc_tpu_torch.tools import select_subjects as ss
from torch_threads import torch_one_thread  # noqa: F401,E402

ROOT = op.dirname(op.dirname(op.abspath(__file__)))
LABELS = ["S.C._left", "S.T.s._left", "F.C.M._left"]


def _graph(seed=7):
    """conftest.py's ``graph`` fixture, built by the port's generator."""
    return make_synthetic_graph(np.random.default_rng(seed), LABELS,
                                n_folds_per_label=2, points_per_fold=60,
                                extent=48)


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = op.join(d, f)
            with open(p, "rb") as fh:
                out[op.relpath(p, root)] = fh.read()
    return out


# ---------------------------------------------------------------------------
# io/arg_writer.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ascii_mode", [False, True], ids=["binar", "ascii"])
def test_arg_writer_bytes_match_jax(tmp_path, ascii_mode):
    """The .arg text and each .bck file byte-equal to JAX's writer's, and
    the port's reader gives back the graph."""
    g = _graph()
    for name, mod in (("jax", jax_aw), ("port", aw)):
        os.makedirs(tmp_path / name)
        mod.save_graph_arg(g, str(tmp_path / name / "g.arg"),
                           ascii_buckets=ascii_mode)
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(got) == sorted(want)
    assert len(got) >= 2
    for k in want:
        assert got[k] == want[k], k
    back = load_graph_arg(str(tmp_path / "port" / "g.arg"))
    assert back.voxel_size == g.voxel_size
    np.testing.assert_allclose(back.talairach.matrix(), g.talairach.matrix(),
                               atol=1e-6)
    va, vb = g.vertices(), back.vertices()
    assert [(v.index, v.name) for v in va] == [(v.index, v.name) for v in vb]
    for x, y in zip(va, vb):
        for bt in x.buckets:
            np.testing.assert_array_equal(x.buckets[bt], y.buckets[bt])


def test_write_bck_matches_jax(tmp_path):
    """``write_bck`` alone, both modes, several time slices."""
    r = np.random.default_rng(3)
    buckets = {t: r.integers(-50, 300, (n, 3)) for t, n in ((2, 5), (0, 1),
                                                            (1, 0))}
    for ascii_mode in (False, True):
        a, b = str(tmp_path / f"a{ascii_mode}.bck"), str(tmp_path / f"b{ascii_mode}.bck")
        jax_aw.write_bck(a, buckets, ascii_mode)
        aw.write_bck(b, buckets, ascii_mode)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


# ---------------------------------------------------------------------------
# tools/
# ---------------------------------------------------------------------------


def _fake_bv_db(root):
    """tests/test_tools.py's BrainVISA-like tree: 3 subjects, one without
    a graph."""
    db = root / "db"
    for i in range(3):
        subj = f"chimp{i}"
        acq = db / "center" / subj / "t1mri" / "acq1"
        folds = acq / "default_analysis" / "folds" / "3.1"
        seg = acq / "default_analysis" / "segmentation"
        (folds / "base2018_manual").mkdir(parents=True)
        seg.mkdir(parents=True)
        (acq / f"{subj}.nii.gz").write_text("t1")
        (seg / f"Lroots_{subj}.nii.gz").write_text("r")
        (seg / f"Lskeleton_{subj}.nii.gz").write_text("s")
        if i != 2:
            (folds / "base2018_manual"
             / f"L{subj}_base2018_manual.arg").write_text(
                "# graph 1.0\n*BEGIN GRAPH CorticalFoldArg\n*END\n")
    return str(db)


def _cohort_tools(mod, db, out, capsys):
    """Every cohort tool of ``mod`` on the database: (printed text, {file
    name: JSON}) of what it wrote."""
    mod.select_subjects(db, "center", exclusion_list=["chimp1", "ghost"])
    written = mod.create_cohort(db, "center", "TestC", out_dir=out,
                                hemis=("L", "R"))
    path = written["L"]
    mod.create_short_cohort(path, op.join(out, "short.json"), 1)
    mod.select_subjects_from_cohort(path, op.join(out, "sel.json"), ["chimp1"])
    mod.create_composed_cohort([path, op.join(out, "sel.json")],
                               op.join(out, "comp.json"), "Comp")
    mod.change_path_cohort(path, db, "/new/root")
    files = {}
    for f in sorted(os.listdir(out)):
        with open(op.join(out, f)) as fh:
            files[f] = json.load(fh)
    return capsys.readouterr().out.replace(out, "<out>"), files


def test_cohort_tools_match_jax(tmp_path, capsys):
    """``select_subjects``, ``create_cohort`` (both hemispheres), the short,
    selected and composed cohorts and ``change_path_cohort``: the same
    files with the same JSON, the same audit print."""
    db = _fake_bv_db(tmp_path)
    want = _cohort_tools(jax_ss, db, str(tmp_path / "jax"), capsys)
    got = _cohort_tools(ss, db, str(tmp_path / "port"), capsys)
    assert got == want
    assert "ghost" in got[0]
    assert [s["name"] for s in got[1]["cohort-TestC_hemi-L.json"]["subjects"]
            ] == ["chimp0", "chimp1"]


def test_hie_files_match_jax(tmp_path):
    """``write_hie`` in random mode (two seeds) and metric mode, and
    ``sulcus_metric_from_csv``: byte-equal files, equal metrics."""
    import pandas as pd

    sulci = ["S.C._left", "S.T.s._left", "F.C.M._left"]
    csv = str(tmp_path / "eval.csv")
    pd.DataFrame({"ESI": [0.3, 0.4], "Elocal_S.C._left": [0.2, 0.3],
                  "Elocal_S.T.s._left": [0.1, 0.6], "acc_S.C._left": [1, 0]}
                 ).to_csv(csv, index=False)
    metric = hie.sulcus_metric_from_csv(csv)
    assert metric == jax_hie.sulcus_metric_from_csv(csv)
    assert hie.sulcus_metric_from_csv(csv, "acc") == \
        jax_hie.sulcus_metric_from_csv(csv, "acc")
    for tag, kw in (("rand0", dict(seed=0)), ("rand3", dict(seed=3)),
                    ("metric", dict(metric_values=metric))):
        a, b = str(tmp_path / f"jax_{tag}.hie"), str(tmp_path / f"{tag}.hie")
        assert jax_hie.write_hie(a, sulci, **kw) == a
        assert hie.write_hie(b, sulci, **kw) == b
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), tag


def _npz_equal(a, b):
    """Two .npz containers hold the same arrays (names as object arrays)."""
    with np.load(a, allow_pickle=True) as za, np.load(b, allow_pickle=True) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype, k
            assert za[k].shape == zb[k].shape, k
            assert za[k].tolist() == zb[k].tolist(), k


def test_convert_graphs_cli_matches_jax(tmp_path):
    """``python -m unetsulc_tpu_torch.tools.convert_graphs`` on an .arg and
    on a cohort file (``--cohort``) against JAX's ``convert_one`` and
    ``convert_cohort``: the same .npz contents, the same rewritten
    cohort."""
    src = str(tmp_path / "g.arg")
    jax_aw.save_graph_arg(_graph(), src)
    cohort = {"name": "C", "subjects": [
        {"name": "s0", "graph": src, "notcut_graph": src, "t1": None}]}
    cpath = str(tmp_path / "cohort-C_hemi-L.json")
    with open(cpath, "w") as f:
        json.dump(cohort, f)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    os.makedirs(jdir)
    jax_cg.convert_one(src, jdir)
    jax_cohort = jax_cg.convert_cohort(cpath, jdir)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-m", "unetsulc_tpu_torch.tools.convert_graphs",
         src, "--cohort", cpath, "-o", pdir],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    _npz_equal(op.join(jdir, "g.npz"), op.join(pdir, "g.npz"))
    with open(jax_cohort) as fa, open(op.join(pdir, op.basename(cpath))) as fb:
        want, got = json.load(fa), json.load(fb)
    assert got["subjects"][0]["graph"] == op.join(pdir, "g.npz")
    got["subjects"][0].update(graph=op.join(jdir, "g.npz"),
                              notcut_graph=op.join(jdir, "g.npz"))
    assert got == want
    # the module function writes what the CLI wrote
    os.makedirs(tmp_path / "fn")
    _npz_equal(cg.convert_one(src, str(tmp_path / "fn")),
               op.join(pdir, "g.npz"))


# ---------------------------------------------------------------------------
# figures/
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def figure_inputs(tmp_path_factory):
    """A results JSON, two evaluation CSVs, two graphs and their cached
    data JSON."""
    import pandas as pd

    root = tmp_path_factory.mktemp("figures")
    results = {
        "epoch_loss_train": [[1.0, 0.5], [0.9]],
        "epoch_loss_val": [[1.1, 0.7]],
        "epoch_acc_train": [[0.2, 0.5]],
        "epoch_acc_val": [[0.1, 0.4]],
        "threshold_scores": {"10": [[50.0]], "50": [[60.0, 62.0]]},
    }
    other = {"epoch_loss_train": [[0.8, 0.5, 0.4]],
             "epoch_loss_val": [[0.9, 0.6, 0.5]],
             "epoch_acc_train": [[0.3, 0.4, 0.6]],
             "epoch_acc_val": [[0.2, 0.5, 0.6]]}
    paths = {}
    for name, r in (("A_results.json", results), ("B_results.json", other)):
        paths[name] = str(root / name)
        with open(paths[name], "w") as f:
            json.dump(r, f)
    r = np.random.default_rng(2)
    for name in ("a.csv", "b.csv"):
        paths[name] = str(root / name)
        pd.DataFrame({"ESI": r.random(6), "Elocal_S.C.": r.random(6),
                      "Elocal_F.C.": r.random(6), "Elocal_S.T.s.": r.random(6)}
                     ).to_csv(paths[name], index=False)
    graphs = []
    for i in range(2):
        p = str(root / f"subj{i}.npz")
        jax_save_npz(_graph(20 + i), p)
        graphs.append(p)
    paths["graphs"] = graphs
    return root, paths


def _figures(mods, paths, out):
    """Every figure function of the modules (plot_results, plot_cohort_
    features, model_comparison) into ``out``: (file names, Wilcoxon)."""
    results, cohort, comparison = mods
    os.makedirs(out)
    written = []
    written += results.plot_training_curves(paths["A_results.json"], out)
    written.append(results.plot_threshold_scores(paths["A_results.json"], out))
    written.append(results.plot_elocal_bars(paths["a.csv"], out))
    data = cohort.regenerate_data(paths["graphs"])
    data_json = op.join(out, "Synth_data.json")
    with open(data_json, "w") as f:
        json.dump(data, f)
    written += cohort.plot_cohort_features(data_json, out)
    written += comparison.compare_curves(paths["A_results.json"],
                                         paths["B_results.json"],
                                         out_dir=out)
    cmp = comparison.compare_evaluations(paths["a.csv"], paths["b.csv"],
                                         out_dir=out)
    written.append(cmp["figure"])
    assert all(op.exists(p) for p in written)
    return sorted(op.relpath(p, out) for p in written), cmp["wilcoxon_esi"]


def test_figures_write_the_same_files_as_jax(figure_inputs):
    """The same file names from every figure function, and
    ``compare_evaluations``' Wilcoxon statistic and p-value equal."""
    root, paths = figure_inputs
    want = _figures((jax_pr, jax_pcf, jax_mc), paths, str(root / "jax"))
    got = _figures((pr, pcf, mc), paths, str(root / "port"))
    assert got[0] == want[0]
    assert sorted(os.listdir(root / "port")) == sorted(os.listdir(root / "jax"))
    assert got[1] is not None and got[1] == want[1]


def test_cohort_features_and_regenerate_data_match_jax(figure_inputs):
    """``regenerate_data`` from the graphs and ``cohort_features`` of it
    equal to JAX's."""
    _, paths = figure_inputs
    want = jax_pcf.regenerate_data(paths["graphs"])
    got = pcf.regenerate_data(paths["graphs"])
    assert got == want
    assert all(len(got["dict_bck2"][g]) > 0 for g in paths["graphs"])
    feats = pcf.cohort_features(got["dict_bck2"], got["dict_names"])
    assert feats == jax_pcf.cohort_features(want["dict_bck2"],
                                            want["dict_names"])
    assert feats["sizes"] and feats["occurrences"]


# ---------------------------------------------------------------------------
# ops/pooling.py and resize_nearest
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,quantized", [
    ((1, 9, 8, 11, 3), False), ((2, 7, 5, 6, 4), True), ((1, 4, 4, 4, 2), True)],
    ids=["odd_random", "ties", "even_ties"])
def test_max_pool_3d_matches_jax(shape, quantized):
    """Forward and backward bit-equal to JAX's custom-VJP pool (f32): on
    values quantized to {0, 0.5, 1}, ties route to the first window
    element in both."""
    r = np.random.default_rng(1)
    x = r.standard_normal(shape).astype(np.float32)
    if quantized:
        x = np.round(np.clip(x, 0, 1) * 2) / 2
    out_shape = tuple(shape[:1]) + tuple(d // 2 + 1 for d in shape[1:4]) + (shape[4],)
    g = r.standard_normal(out_shape).astype(np.float32)
    want, vjp = jax.vjp(jax_max_pool_3d, jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = max_pool_3d(xt)
    got.backward(torch.from_numpy(g))
    assert tuple(got.shape) == out_shape
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_dx))


@pytest.mark.parametrize("dtype", [np.int32, np.int8])
def test_max_pool_3d_integer_matches_jax(dtype):
    """An integer input through the window view, padded with iinfo.min:
    equal to JAX's, negative values included."""
    r = np.random.default_rng(4)
    x = r.integers(-100, 100, (2, 5, 6, 7, 3)).astype(dtype)
    want = np.asarray(jax_max_pool_3d(jnp.asarray(x)))
    got = max_pool_3d(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("extent,target", [
    ((8, 6, 9), (16, 12, 9)), ((8, 6, 9), (5, 3, 4)),
    ((26, 30, 39), (22, 26, 33))], ids=["up", "down", "f32_index_differs"])
def test_resize_nearest_matches_jax(extent, target):
    """Exactly JAX's gather for upscaling, downscaling, and ratios (26 ->
    22, 30 -> 26, 39 -> 33) where ``F.interpolate``'s float32 source index
    picks another row."""
    x = np.random.default_rng(6).standard_normal((2, *extent, 3)).astype(
        np.float32)
    want = np.asarray(jax_resize_nearest(jnp.asarray(x), target))
    got = resize_nearest(torch.from_numpy(x), target).numpy()
    assert got.shape == want.shape == (2, *target, 3)
    np.testing.assert_array_equal(got, want)
    f32 = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 4, 1, 2, 3), size=target,
        mode="nearest").permute(0, 2, 3, 4, 1).numpy()
    assert np.array_equal(f32, want) == (extent[0] == 8)
