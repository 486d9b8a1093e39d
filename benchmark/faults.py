"""Faults planted under the harness, for the check's own tests and for
the readings (``readings.py --fault``): each wraps the program's step.

* ``unchanged``: the step runs and returns its loss and counts, but
  leaves the state (parameters, momentum) as it was;
* ``one_leaf_unchanged``: the step leaves one trainable weight leaf (the
  middle one, in the optimizer's order, of those of more than one
  dimension) as it was, as a weight gradient of zero in one layer would;
* ``half_batch``: the step runs on the first half of the batch, its mean
  over those subjects only;
* ``altered_counts``: one count moved where the step produces it;
* ``shifted_class``: the counts' per-class true positives and predicted
  counts moved one class on, as if each prediction were the next class;
  every total and every class's TP + FN stay what the labels fix.
"""

from __future__ import annotations

import torch


def unchanged(step):
    def run(state, x, lb):
        params = {n: p.detach().clone()
                  for n, p in state.model.named_parameters()}
        opt = {p: {k: v.clone() for k, v in s.items()}
               for p, s in state.optimizer.state.items()}
        out = step(state, x, lb)
        with torch.no_grad():
            for n, p in state.model.named_parameters():
                p.copy_(params[n])
        state.optimizer.state.clear()
        state.optimizer.state.update(opt)
        return out
    return run


def one_leaf_unchanged(step):
    def run(state, x, lb):
        weights = [p for g in state.optimizer.param_groups
                   for p in g["params"] if p.dim() > 1]
        leaf = weights[len(weights) // 2]
        kept = leaf.detach().clone()
        out = step(state, x, lb)
        with torch.no_grad():
            leaf.copy_(kept)
        return out
    return run


def half_batch(step):
    def run(state, x, lb):
        h = max(1, x.shape[0] // 2)
        return step(state, x[:h], lb[:h])
    return run


def altered_counts(step):
    def run(state, x, lb):
        loss, counts = step(state, x, lb)
        counts = counts.clone()
        counts[0, 0] += 1
        return loss, counts
    return run


def shifted_class(step):
    def run(state, x, lb):
        loss, counts = step(state, x, lb)
        tp, fp, fn = counts[0], counts[1], counts[2]
        tp2, pred2 = tp.roll(1), (tp + fp).roll(1)
        return loss, torch.stack([tp2, pred2 - tp2, fn + tp - tp2])
    return run


FAULTS = {f.__name__: f for f in (unchanged, one_leaf_unchanged, half_batch,
                                  altered_counts, shifted_class)}


def plant(model_mod, fault: str):
    """Wrap the step that ``model_mod.build`` returns in ``fault``;
    returns a function that undoes it."""
    real = model_mod.build
    wrap = FAULTS[fault]

    def build(*args, **kw):
        model, state, step = real(*args, **kw)
        return model, state, wrap(step)

    model_mod.build = build
    return lambda: setattr(model_mod, "build", real)
