"""ESI (Error Similarity Index) — the reference's accuracy metric.

Copy of ``unetsulc_tpu/ops/esi.py``: the on-device (TP, FP, FN) counts of
the train and eval steps (:func:`confusion_counts`) and the host
functions:

    esi_score(y_true, y_pred, labels)
      = mean over ``labels`` of  E_local(s) = (FP_s + FN_s) / (2*TP_s + FP_s + FN_s)

with labels that never occur (TP=FP=FN=0) contributing 0 error.  Reported
accuracy is ``1 - esi`` and threshold scores are ``(1 - esi) * 100``
(CONTRACTS.md §1).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def confusion_counts(
    y_true: torch.Tensor,
    y_pred: torch.Tensor,
    num_classes: int,
    background: int = -1,
) -> torch.Tensor:
    """(3, num_classes) int32 [TP, FP, FN] counts on the tensors' device,
    voxels with ``y_true == background`` excluded (ref training.py:216-217).

    y_true, y_pred: integer tensors of one shape. Per-class counts are
    weighted ``index_add_`` sums, so nothing waits for the host (a boolean
    index or ``bincount`` would)."""
    t = y_true.reshape(-1).long()
    p = y_pred.reshape(-1).long()
    valid = (t != background).float()
    match = valid * (t == p).float()

    def count(idx, w):
        # f32 counts are exact below 2^24 voxels
        z = torch.zeros(num_classes, dtype=torch.float32, device=t.device)
        return z.index_add_(0, idx.clamp(0, num_classes - 1), w)

    t_counts = count(t, valid)
    p_counts = count(p, valid)
    tp = count(t, match)
    return torch.stack([tp, p_counts - tp, t_counts - tp]).to(torch.int32)


def esi_from_counts(counts: np.ndarray, label_ids: Sequence[int]) -> float:
    """ESI from a (3, num_classes) count tensor restricted to ``label_ids``.

    ``label_ids`` = integer ids of the sslist labels (non-unknown,
    non-ventricle sulci), matching
    ``[dict_sulci[ss] for ss in sslist]`` (ref training.py:225).
    """
    counts = np.asarray(counts)
    label_ids = list(label_ids)
    if not label_ids:
        return 0.0
    tp = counts[0, label_ids].astype(np.float64)
    fp = counts[1, label_ids].astype(np.float64)
    fn = counts[2, label_ids].astype(np.float64)
    denom = 2 * tp + fp + fn
    elocal = np.where(denom > 0, (fp + fn) / np.where(denom > 0, denom, 1), 0.0)
    return float(elocal.mean())


def esi_score(y_true, y_pred, labels) -> float:
    """Drop-in host equivalent of ``deepsulci...stats.esi_score``.

    ``labels`` may be label *names* (when y_true/y_pred hold names, as in
    the threshold sweep, ref pattern_class.py:233) or integer ids (as in
    the train loop, ref training.py:225).
    """
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    labels = list(labels)
    if not labels:
        return 0.0
    total = 0.0
    for lab in labels:
        t = y_true == lab
        p = y_pred == lab
        tp = float(np.sum(t & p))
        fp = float(np.sum(~t & p))
        fn = float(np.sum(t & ~p))
        denom = 2 * tp + fp + fn
        if denom > 0:
            total += (fp + fn) / denom
    return total / len(labels)


def elocal_scores(y_true, y_pred, labels) -> dict:
    """Per-label local error dict (feeds the evaluation CSVs / figures)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    out = {}
    for lab in labels:
        t = y_true == lab
        p = y_pred == lab
        tp = float(np.sum(t & p))
        fp = float(np.sum(~t & p))
        fn = float(np.sum(t & ~p))
        denom = 2 * tp + fp + fn
        out[lab] = (fp + fn) / denom if denom > 0 else 0.0
    return out
