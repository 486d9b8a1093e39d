"""The harness finds a configuration, a traffic mix and a metric by name,
and one added as files of its own, with no edit to a file that is there."""

import json
import shutil

import pytest

from benchmark import registry
from benchmark import run as run_mod


def test_finds_the_cells_parts_by_name():
    bench = registry.benchmark()
    for w in bench["workloads"]:
        cfg = registry.config(w["config"])
        traffic = registry.traffic(w["traffic"])
        assert cfg["model"] and traffic["batch"] >= 1
        assert registry.job(traffic["job"]).loop
        assert registry.model(cfg["model"]).layers
        assert registry.reference(cfg["model"]).train_steps
        assert set(registry.limits(w["name"])) >= {"grad1_gap", "counts_off"}
        for section in ("end_to_end", "per_layer"):
            for m in registry.cell_metrics(bench, section, w["name"]):
                assert callable(registry.metric_module(m["name"]).read)
    for c in bench["configs"]:
        assert (registry.REPO / c["file"]).is_file()


def test_gn_metric_is_reported_only_where_listed():
    bench = registry.benchmark()
    names = [m["name"] for m in registry.cell_metrics(
        bench, "per_layer", "unet3d_interp.train_b1")]
    assert "gn_roofline_pct.train" not in names
    assert "idle_pct.train" in names


def test_an_added_config_mix_and_metric(tmp_path, tiny):
    root = tmp_path / "benchmark"
    shutil.copytree(registry.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p.relative_to(root): p.read_bytes()
              for p in root.rglob("*") if p.is_file()}
    cfg = json.loads((root / "configs" / "unet3d_interp.json").read_text())
    cfg["init_channel_number"] = 16
    (root / "configs" / "unet3d_wide.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "traffic" / "train_b1.json").read_text())
    mix["pool"] = 4
    (root / "traffic" / "train_b1_small.json").write_text(json.dumps(mix))
    (root / "metrics" / "steps_done.train.py").write_text(
        "def start(run):\n    return run.next_batch\n\n\n"
        "def read(ctx):\n"
        "    assert ctx['started']['steps_done.train'] == 5\n"
        "    return float(ctx['steps'])\n")
    (root / "limits" / "unet3d_wide.train_b1_small.json").write_text(
        (root / "limits" / "unet3d_interp.train_b1.json").read_text())
    bench = registry.benchmark()
    bench["configs"].append({"name": "unet3d_wide", "source": "x",
                             "file": "benchmark/configs/unet3d_wide.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "unet3d_wide.train_b1_small",
                               "config": "unet3d_wide",
                               "traffic": "train_b1_small", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "steps_done.train", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "step", "moves": "setup_s",
                               "workloads": ["unet3d_wide.train_b1_small"]})
    assert registry.config("unet3d_wide", root)["init_channel_number"] == 16
    assert registry.traffic("train_b1_small", root)["pool"] == 4
    assert registry.metric_module("steps_done.train", root).read(
        {"steps": 3, "started": {"steps_done.train": 5}}) == 3.0
    tiny["config"].pop("init_channel_number")
    result = run_mod.run("unet3d_wide.train_b1_small", 7, 0.5, True, "cpu",
                         tiny, bench=bench, root=root)
    assert result["metrics"]["steps_done.train"]["value"] >= 1
    assert result["correct"] is True
    after = {p.relative_to(root): p.read_bytes()
             for p in root.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())


def test_an_unknown_job_is_refused(tmp_path, tiny):
    root = tmp_path / "benchmark"
    shutil.copytree(registry.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    mix = json.loads((root / "traffic" / "train_b1.json").read_text())
    mix["job"] = "label"
    (root / "traffic" / "train_b1.json").write_text(json.dumps(mix))
    with pytest.raises(FileNotFoundError, match="no job 'label'"):
        run_mod.open_run("unet3d_interp.train_b1", 1, "cpu", tiny, root=root)
