"""The output check fails what it has to fail.

Each fault test skips the harness's look for a card and drives the rest
of a run on the CPU at a small size, with the timed path broken under the
harness: a step that returns its state unchanged, half of the batch left
out (the mean taken over the rest), one weight leaf left unmoved, an
answer altered where the step produces it (one count moved; the counts'
classes shifted, every total kept). Each must come out not correct. (One chip: no exchange
between chips to leave out.) The control, the reference in float8 in the
program's place, must fail too; on the card it runs at the cell's own
size."""

import pytest
import torch

from benchmark import check, faults, registry
from benchmark import run as run_mod
from benchmark.models import unet3d as model_mod


CASES = [("unet3d_interp.train_b1", "unchanged"),
         ("unet3d_transposed.train_b4", "unchanged"),
         ("unet3d_interp.transfer_b1", "unchanged"),
         ("unet3d_transposed.train_b4", "half_batch"),
         ("unet3d_interp.train_b1", "altered_counts"),
         ("unet3d_interp.transfer_b1", "altered_counts"),
         ("unet3d_interp.train_b1", "one_leaf_unchanged"),
         ("unet3d_transposed.train_b4", "one_leaf_unchanged"),
         ("unet3d_interp.train_b1", "shifted_class"),
         ("unet3d_transposed.train_b4", "shifted_class"),
         ("unet3d_interp.transfer_b1", "shifted_class")]


@pytest.mark.parametrize("workload,fault", CASES,
                         ids=[f"{w}-{f}" for w, f in CASES])
def test_a_broken_step_is_not_correct(workload, fault, tiny):
    undo = faults.plant(model_mod, fault)
    try:
        result = run_mod.run(workload, 2 ** 31 + 99, 0.3, False, "cpu", tiny)
    finally:
        undo()
    assert result["correct"] is False


@pytest.mark.parametrize("workload", ["unet3d_interp.train_b1",
                                      "unet3d_transposed.train_b4",
                                      "unet3d_interp.transfer_b1"])
def test_the_control_is_not_correct(workload, tiny):
    r = run_mod.open_run(workload, 23, "cpu", tiny)
    r.setup()
    r.free_program()
    lim = registry.limits(workload)
    assert not check.judge(r.check("fp8"), lim)


@pytest.mark.card
@pytest.mark.parametrize("workload", ["unet3d_interp.train_b1",
                                      "unet3d_transposed.train_b4",
                                      "unet3d_interp.transfer_b1"])
def test_the_control_on_the_card(workload, cuda):
    for seed in (3000000101, 3000000102, 3000000103):
        r = run_mod.open_run(workload, seed, "cuda")
        r.setup()
        r.free_program()
        lim = registry.limits(workload)
        assert check.judge(r.check(), lim)
        assert not check.judge(r.check("fp8"), lim)
        del r
        torch.cuda.empty_cache()


def test_only_the_median_misses_one_leaf(tiny):
    """The leaf left unmoved reads 1 in the worst weight leaf's change,
    while the median over the leaves stays where a sound run has it."""
    undo = faults.plant(model_mod, "one_leaf_unchanged")
    try:
        r = run_mod.open_run("unet3d_interp.train_b1", 5, "cpu", tiny)
        r.setup()
    finally:
        undo()
    r.free_program()
    numbers = r.check()
    lim = registry.limits("unet3d_interp.train_b1")
    assert numbers["change_gap"] <= lim["change_gap"]
    assert numbers["change_weight_worst"] == pytest.approx(1.0, abs=1e-3)


def test_shifted_classes_keep_every_total(tiny):
    """The shifted counts pass what the labels alone fix (``counts_off``)
    and fail only the comparison with the reference's counts."""
    undo = faults.plant(model_mod, "shifted_class")
    try:
        r = run_mod.open_run("unet3d_interp.train_b1", 6, "cpu", tiny)
        r.setup()
    finally:
        undo()
    r.free_program()
    numbers = r.check()
    lim = registry.limits("unet3d_interp.train_b1")
    assert numbers["counts_off"] == 0
    assert numbers["counts_gap"] > lim["counts_gap"]
