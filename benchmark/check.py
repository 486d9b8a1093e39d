"""The output check that decides ``correct``: the program's first steps,
as the window's own call and feed ran them, against the plain reference's
steps from the same weights on the same batches.

Numbers compared (each against its limit in ``limits/<workload>.json``):

* ``loss_gap``: over the tracked steps, the largest |program's loss -
  reference's| / |reference's|;
* ``grad1_gap``: per leaf, the gap between the norm of the program's
  first gradient (as its optimizer got it, from the optimizer's state
  after the first step) and the reference's, over the larger of the
  reference leaf's norm and the median leaf's; the median of these over
  the leaves;
* ``change_gap``: the same for each leaf's change over the tracked steps;
* ``change_weight_worst``: the largest change gap over the weight leaves
  (the leaves of more than one dimension: conv, transposed-conv and head
  kernels), so that a fault in one leaf, which leaves the median where it
  was, shows; a leaf's change is made of its gradients, so a wrong
  gradient in one leaf shows there too;
* ``counts_gap``: at the first step, the L1 distance between the
  program's per-class true positives and the reference's, plus that
  between their per-class predicted counts (TP + FP), over the valid
  voxels. Only the first step's predictions come from the same weights on
  both sides: later, the weights have moved apart by rounding, and on the
  fused route from scratch the argmax's near ties turn that into up to 14%
  of the voxels by the third step;
* ``counts_off`` (limit 0): over the steps, how far the program's counts
  are from what the labels fix whatever the predictions: TP + FN of a
  class is its voxel count, and TP + FP over the classes the valid count;
* ``frozen_moved`` (limit 0, where a trainable set is given): the largest
  change of a frozen parameter.

Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of the gaps: they move by rounding alone.

The worst of all leaves (``grad1_worst``, ``change_worst``) is reported
and not compared: in bfloat16 the fused route's entry-conv bias (a sum
over 96³ voxels of nearly cancelling terms) reads 0.03-0.50 against the
float32 reference, as the port's own plain versions on the card do, where
its float32 path reads 0.001. The biases and GroupNorm affine leaves are
vectors of such sums; the weight leaves hold many entries each.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

TINY_GRAD = 1e-3


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.double().norm()) for n, t in tensors.items()}


def _median(values: List[float]) -> float:
    v = sorted(values)
    k = len(v) // 2
    return v[k] if len(v) % 2 else 0.5 * (v[k - 1] + v[k])


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: List[str]) -> List[float]:
    """|prog norm - ref norm| of each of ``leaves``, over the larger of its
    reference norm and the median leaf's."""
    if not leaves:
        return [0.0]
    med = _median([ref[n] for n in leaves])
    return [abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in leaves]


def label_counts(labels: torch.Tensor, classes: int) -> torch.Tensor:
    t = labels[labels != -1].reshape(-1)
    return torch.bincount(t.cpu(), minlength=classes)


def _leaf_numbers(prog: dict, ref: dict, out: Dict[str, float],
                  detail: Optional[dict]) -> None:
    g_ref = _norms(ref["grad1"])
    med = _median(list(g_ref.values())) if g_ref else 0.0
    leaves = [n for n in g_ref if g_ref[n] >= TINY_GRAD * med]
    names = ("grad1_gap", "change_gap", "change_weight_worst",
             "grad1_worst", "change_worst")
    if any(n not in prog["grad1"] for n in leaves):
        out.update({k: math.inf for k in names})
        return
    g = leaf_gaps(_norms({n: prog["grad1"][n] for n in leaves}), g_ref,
                  leaves)
    dp = _norms({n: prog["params"][n].float() - prog["params0"][n].float()
                 for n in leaves})
    dr = _norms({n: ref["params"][n] - prog["params0"][n].float()
                 for n in leaves})
    c = leaf_gaps(dp, dr, leaves)
    weight = [k for k, n in enumerate(leaves) if ref["grad1"][n].dim() > 1]
    out["grad1_gap"], out["change_gap"] = _median(g), _median(c)
    out["change_weight_worst"] = max((c[k] for k in weight), default=0.0)
    out["grad1_worst"], out["change_worst"] = max(g), max(c)
    if detail is not None:
        detail["leaves"] = {n: [g[k], c[k]] for k, n in enumerate(leaves)}


def compare(prog: dict, ref: dict, batches, frozen: List[str],
            detail: Optional[dict] = None) -> Dict[str, float]:
    """The numbers above. ``prog``: losses, counts ((3, classes) [TP, FP,
    FN] per step), grad1, params0 and params (after the tracked steps);
    ``ref``: what ``references.<model>.train_steps`` returns. ``detail``,
    where given, gets each leaf's [grad1 gap, change gap] (``leaves``) and
    each step's counts gap (``counts_gap_steps``)."""
    out = {}
    gaps = [abs(a - b) / max(abs(b), 1e-30)
            for a, b in zip(prog["losses"], ref["losses"])]
    out["loss_gap"] = max(gaps) if all(map(math.isfinite, prog["losses"])) \
        else math.inf
    _leaf_numbers(prog, ref, out, detail)
    cgap, off = [], 0
    for (x, lb), pc, rc in zip(batches, prog["counts"], ref["counts"]):
        pc, rc = pc.long().cpu(), rc.long().cpu()
        hist = label_counts(lb, pc.shape[-1])
        valid = int(hist.sum())
        off += int((pc[0] + pc[2] - hist).abs().sum())
        off += abs(int((pc[0] + pc[1]).sum()) - valid)
        gap = ((pc[0] - rc[0]).abs().sum()
               + (pc[0] + pc[1] - rc[0] - rc[1]).abs().sum())
        cgap.append(int(gap) / max(valid, 1))
    out["counts_gap"] = cgap[0]
    if detail is not None:
        detail["counts_gap_steps"] = cgap
    out["counts_off"] = float(off)
    if frozen:
        out["frozen_moved"] = max(
            float((prog["params"][n].float() - prog["params0"][n].float())
                  .abs().max()) for n in frozen)
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every limit's number present and at or under it (NaN fails)."""
    return all(k in numbers and numbers[k] <= v for k, v in limits.items())
