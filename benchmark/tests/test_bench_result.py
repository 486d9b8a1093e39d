"""The result's last line and the no-JAX check."""

import json
import subprocess
import sys

import pytest

from benchmark import registry
from benchmark import run as run_mod

CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("traced", [False, True])
def test_result_keys(traced, tiny):
    result = run_mod.run("unet3d_interp.transfer_b1", 2 ** 31 + 5, 0.5,
                         traced, "cpu", tiny)
    keys = list(result)
    assert keys[:5] == CONTRACT and keys[-1] == "checks"
    assert set(keys) <= set(CONTRACT) | {"breakdown", "checks"}
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    section = "per_layer" if traced else "end_to_end"
    allowed = {m["name"]: m["unit"] for m in registry.cell_metrics(
        registry.benchmark(), section, "unet3d_interp.transfer_b1")}
    assert result["metrics"] and all(
        allowed[k] == v["unit"] for k, v in result["metrics"].items())
    assert all(set(v) == {"value", "limit"}
               for v in result["checks"].values())
    json.dumps(result)


def test_banned_modules_compare_whole_names(monkeypatch):
    for name in ("unetsulc_tpu_torch", "jaxtyping", "flaxish"):
        monkeypatch.setitem(sys.modules, name, object())
    assert run_mod.banned_modules() == []
    monkeypatch.setitem(sys.modules, "unetsulc_tpu.ops", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert run_mod.banned_modules() == ["jaxlib", "unetsulc_tpu"]


def test_a_run_loads_no_jax(tmp_path):
    code = (
        "import sys, torch; sys.path.insert(0, %r)\n"
        "from benchmark import run\n"
        "tiny = {'config': {'init_channel_number': 4, "
        "'compute_dtype': 'float32'}, 'traffic': {'volume': [16, 16, 16]}}\n"
        "run.run('unet3d_transposed.train_b4', 1, 0.2, False, 'cpu', tiny)\n"
        "print(run.banned_modules())\n" % str(registry.REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run_mod.main(["--workload", "unet3d_interp.train_b1", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and "correct" not in out.out
