"""The plain reference against the port's CPU path at a small size (the
test imports both; the reference itself imports nothing of the port)."""

import ast
from pathlib import Path

import pytest
import torch

from benchmark import registry
from benchmark import run as run_mod
from benchmark import weights
from benchmark.data import make_pool
from benchmark.references import unet3d as ref


@pytest.mark.parametrize("workload", ["unet3d_interp.train_b1",
                                      "unet3d_transposed.train_b4"])
def test_forward_logits_match_the_port(workload, tiny):
    spec = registry.workload(registry.benchmark(), workload)
    cfg = dict(registry.config(spec["config"]), **tiny["config"])
    traffic = dict(registry.traffic(spec["traffic"]), **tiny["traffic"])
    w = weights.make(ref.param_shapes(cfg), 3, "cpu")
    model, _, _ = registry.model(cfg["model"]).build(cfg, traffic, w, "cpu")
    x, _ = make_pool(traffic["subjects"], traffic["volume"], 3, 2)
    x = torch.from_numpy(x)
    with torch.no_grad():
        port = model(x, train=True, apply_final_activation=False)
        mine = ref.Net(cfg)(w, x.permute(0, 4, 1, 2, 3))
    mine = mine.permute(0, 2, 3, 4, 1)
    scale = mine.abs().max()
    # float32 on both sides, summed in other orders (and threads) through
    # 14 GroupNorms, whose variance over the nearly empty volume is small
    assert (port - mine).abs().max() <= 1e-3 * scale


@pytest.mark.parametrize("workload", ["unet3d_interp.train_b1",
                                      "unet3d_transposed.train_b4",
                                      "unet3d_interp.transfer_b1"])
def test_first_steps_match_the_port(workload, tiny):
    r = run_mod.open_run(workload, 11, "cpu", tiny)
    r.setup()
    r.free_program()
    numbers = r.check()
    assert numbers["loss_gap"] < 1e-4
    assert numbers["grad1_gap"] < 1e-2 and numbers["change_gap"] < 1e-2
    assert numbers["change_weight_worst"] < 1e-2
    assert numbers["counts_off"] == 0
    # float32 on both sides: an argmax flips only at a near tie
    assert numbers["counts_gap"] < 1e-2
    assert numbers.get("frozen_moved", 0.0) == 0.0


def test_reference_imports_nothing_of_the_program():
    for path in (registry.ROOT / "references").glob("*.py"):
        tree = ast.parse(Path(path).read_text())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                names.add((node.module or "").split(".")[0])
        assert not names & {"unetsulc_tpu_torch", "unetsulc_tpu", "jax",
                            "flax", "benchmark"}, (path, names)


def test_fp8_rounds_to_e4m3():
    t = torch.tensor([1.0, 0.3, -448.0, 1e-3])
    q = ref.fp8(t)
    assert q[2] == -448.0 and q[0] == 1.0
    assert q[1] != 0.3 and abs(float(q[1]) - 0.3) < 0.3 / 8
