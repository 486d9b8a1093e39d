"""The Swin UNETR cell's files: its configuration, model file and
reference through the registry and a run on the CPU at a small size; the
model file's counts of work against a count by hand; the reference's
independence from the program; and, on the card, the window-attention
kernel against the plain attention at stage 1's shape."""

import ast
import json
import math
from pathlib import Path

import pytest
import torch

from benchmark import counts, registry
from benchmark import run as run_mod
from benchmark.models import swin_unetr as model_mod

CELL = "swin_unetr.train_b4"
SMALL = {
    "config": {"feature_size": 12, "compute_dtype": "float32"},
    "traffic": {"volume": [32, 32, 32],
                "subjects": {"labels": 63, "folds_per_label": 1,
                             "points_per_fold": 40, "jitter": 0.04,
                             "anatomy_seed": 20221}},
}


def test_config_model_and_reference_run_through_the_harness():
    bench = registry.benchmark()
    spec = registry.workload(bench, CELL)
    cfg = registry.config(spec["config"])
    assert cfg["model"] == "swin_unetr" and spec["chips"] == 1
    assert registry.model(cfg["model"]) is model_mod
    shapes = registry.reference(cfg["model"]).param_shapes(cfg)
    n = sum(math.prod(s) for s, _, _ in shapes.values())
    assert 62.0e6 < n < 62.4e6
    names = [m["name"] for m in registry.cell_metrics(bench, "per_layer",
                                                      CELL)]
    assert {"swin_encoder_ms.train", "attn_roofline_pct.train",
            "conv_roofline_pct.train", "gn_roofline_pct.train",
            "step_mfu.train"} <= set(names)
    result = run_mod.run(CELL, 2 ** 31 + 77, 0.5, False, "cpu",
                         json.loads(json.dumps(SMALL)))
    assert result["correct"] is True, result["checks"]
    assert result["metrics"]["train_subjects_per_s"]["value"] > 0
    assert result["failed"] == 0


def test_work_counts_match_a_count_by_hand():
    cfg = dict(registry.config("swin_unetr"), feature_size=12)
    traffic = {"volume": [32, 32, 32], "batch": 2, "training_layers": None}
    w = model_mod.work(cfg, traffic, "swin")
    f, v = 12, 32 ** 3
    # convs per volume (2 x voxels x taps x cin x cout), three passes but
    # the entry convs' input gradient (patch embedding, encoder1's conv1
    # and conv3): stage grids 16, 8, 4, 2, 1
    g = [16 ** 3, 8 ** 3, 4 ** 3, 2 ** 3, 1]

    def res(vox, a, b):
        return 2 * vox * 27 * (a * b + b * b) + (2 * vox * a * b if a != b
                                                 else 0)

    entry = 2 * g[0] * 8 * 1 * f + 2 * v * 27 * 1 * f + 2 * v * 1 * f
    rest = (2 * v * 27 * f * f                               # encoder1.conv2
            + res(g[0], f, f) + res(g[1], 2 * f, 2 * f)
            + res(g[2], 4 * f, 4 * f) + res(g[4], 16 * f, 16 * f)
            + sum(2 * g[k + 1] * 8 * a * b + res(g[k], 2 * b, b)
                  for k, a, b in ((3, 16 * f, 8 * f), (2, 8 * f, 4 * f),
                                  (1, 4 * f, 2 * f), (0, 2 * f, f)))
            + 2 * g[0] * 8 * f * f + res(v, 2 * f, f)          # decoder1
            + 2 * v * f * 63)                                  # head
    # Linear layers: qkv and proj on the padded windows (16 -> 21, 8 ->
    # 14, 4 and 2 whole), the MLP on the tokens, the merges
    padded = [21 ** 3, 14 ** 3, 4 ** 3, 2 ** 3]
    lin = sum(2 * 2 * (padded[i] * 4 * c * c + g[i] * 8 * c * c)
              for i, c in enumerate((f, 2 * f, 4 * f, 8 * f)))
    lin += sum(2 * g[i + 1] * 8 * c * 2 * c
               for i, c in enumerate((f, 2 * f, 4 * f, 8 * f)))
    # attention: QK^T and PV, 2 N^2 C per window each, two blocks a stage
    wins = [(27, 343), (8, 343), (1, 64), (1, 8)]
    attn = sum(2 * 2 * 2 * nw * n * n * c
               for (nw, n), c in zip(wins, (f, 2 * f, 4 * f, 8 * f)))
    want = 2 * (2 * entry + 3 * (rest + lin + attn))
    assert w["flops_step"] == pytest.approx(want, rel=1e-12)
    # the attention's bound, block by block: bytes win at head dim 4
    bound = 0.0
    for (nw, n), c, h in zip(wins, (f, 2 * f, 4 * f, 8 * f), (3, 6, 12, 24)):
        for rolled in (False, nw > 1):
            act = 2 * nw * n * c * 2
            bias, mask = h * n * n * 2, (nw * n * n * 2 if rolled else 0)
            nbytes = 12 * act + 3 * bias + 2 * mask
            flops = 3 * 2 * 2 * 2 * nw * n * n * c
            bound += max(flops / counts.PEAK_BF16_FLOPS,
                         nbytes / counts.PEAK_BYTES)
    assert w["attn_bound_s_step"] == pytest.approx(bound, rel=1e-12)


def test_reference_imports_nothing_of_the_program():
    path = registry.ROOT / "references" / "swin_unetr.py"
    tree = ast.parse(Path(path).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    assert {n.split(".")[0] for n in names} <= {
        "__future__", "contextlib", "itertools", "collections", "typing",
        "torch"}, names


@pytest.mark.card
def test_window_attention_kernel_at_stage_one(cuda):
    """343 windows x 3 heads x 343 tokens, head dim 16, batch 4, rolled:
    the fused kernel's output and its gradients of q, k, v and the bias
    against the plain f32 attention on the same bf16 inputs."""
    from unetsulc_tpu_torch.ops import window_attention as wa

    g = torch.Generator(device=cuda).manual_seed(5)
    b, nw, h, n, d = 4, 343, 3, 343, 16
    q, k, v = (torch.randn((b * nw, h, n, d), generator=g, device=cuda)
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    bias = (0.02 * torch.randn((h, n, n), generator=g, device=cuda)).to(
        torch.bfloat16).requires_grad_()
    plan = wa.window_plan((48, 48, 48), (7, 7, 7), (3, 3, 3), cuda,
                          torch.bfloat16)
    assert plan.mask.shape == (nw, n, n)
    dout = torch.randn((b * nw, h, n, d), generator=g, device=cuda).to(
        torch.bfloat16)
    out = wa.window_attention(q, k, v, bias, plan.mask, b, d ** -0.5)
    got = [out.float()] + [t.float() for t in torch.autograd.grad(
        out, (q, k, v, bias), dout)]
    want = [torch.zeros_like(t) for t in got]
    for i in range(b):
        sl = slice(i * nw, (i + 1) * nw)
        qi, ki, vi = (t.detach()[sl].float().requires_grad_()
                      for t in (q, k, v))
        bi = bias.detach().float().requires_grad_()
        o = wa.window_attention_plain(qi, ki, vi, bi[None] + plan.mask[
            :, None].float(), d ** -0.5)
        gq, gk, gv, gb = torch.autograd.grad(o, (qi, ki, vi, bi),
                                             dout[sl].float())
        want[0][sl], want[1][sl], want[2][sl], want[3][sl] = o, gq, gk, gv
        want[4] += gb
    # bf16 output and gradients against f32 sums of the same inputs: the
    # kernel rounds P to bf16 before PV and its outputs to bf16 (the
    # probe's readings: 3.4e-3 to 4.5e-3 relative)
    for name, a, w in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        rel = float((a - w).norm() / w.norm())
        assert rel < 2e-2, (name, rel)
