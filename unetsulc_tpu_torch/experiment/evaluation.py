"""Evaluation CSV producer (counterpart of
``unetsulc_tpu/experiment/evaluation.py``).

The reference's figure scripts consume per-sulcus evaluation CSVs
(``evaluations/<model>/<model>_cvK/<cohort_eval>.csv`` with columns
``acc_/sens_/spec_/bacc_/ESI_/Elocal_/TP_/FN_/FP_<sulcus>`` + global
``ESI``) whose producer lives OUTSIDE the reference repo
(SURVEY.md §2.4, ref create_figures/plot_results.py:40,86-96).  This module
is that producer: it labels each test graph with a trained method and
writes one row per subject.

Definitions per sulcus s over a subject's voxels (background excluded):
TP/FP/FN as usual; TN = voxels of other sulci predicted not-s;
acc=(TP+TN)/N, sens=TP/(TP+FN), spec=TN/(TN+FP), bacc=(sens+spec)/2,
Elocal=(FP+FN)/(2TP+FP+FN), ESI_s == Elocal_s (per-label error),
global ESI = mean Elocal over the method's sslist.
"""

from __future__ import annotations

import csv
import os
import os.path as op
from typing import Optional, Sequence

import numpy as np


def _row_for_subject(ytrue, ypred, sulci, sslist) -> dict:
    ytrue = np.asarray(ytrue)
    ypred = np.asarray(ypred)
    row = {}
    elocals = {}
    n = max(len(ytrue), 1)
    for i, s in enumerate(sulci):
        t = ytrue == i
        p = ypred == i
        tp = float(np.sum(t & p))
        fp = float(np.sum(~t & p))
        fn = float(np.sum(t & ~p))
        tn = float(np.sum(~t & ~p))
        denom = 2 * tp + fp + fn
        elocal = (fp + fn) / denom if denom > 0 else 0.0
        elocals[s] = elocal
        sens = tp / (tp + fn) if tp + fn > 0 else 0.0
        spec = tn / (tn + fp) if tn + fp > 0 else 0.0
        row[f"acc_{s}"] = (tp + tn) / n
        row[f"sens_{s}"] = sens
        row[f"spec_{s}"] = spec
        row[f"bacc_{s}"] = (sens + spec) / 2
        row[f"ESI_{s}"] = elocal
        row[f"Elocal_{s}"] = elocal
        row[f"TP_{s}"] = tp
        row[f"FN_{s}"] = fn
        row[f"FP_{s}"] = fp
    row["ESI"] = float(np.mean([elocals[s] for s in sslist])) if sslist else 0.0
    return row


def evaluate_cohort(
    method,
    gfile_list: Sequence[str],
    model_name: str,
    cv_name: str,
    cohort_eval: str,
    working_path: Optional[str] = None,
) -> str:
    """Label each graph and write the evaluation CSV (one row per subject,
    written with the ``csv`` module); returns its path."""
    wp = working_path or method.working_path
    rows = []

    def finish(gfile, handle) -> None:
        # the CSV needs only ytrue/ypred: skip the score fetch, and run
        # one volume behind the dispatch loop so the device computes
        # graph k+1's forward during graph k's fetch + row building
        ytrue, ypred, _ = method._labeling_fetch(handle, fetch_scores=False)
        row = {"subject": op.basename(gfile)}
        row.update(
            _row_for_subject(
                ytrue, ypred, method.sulci_side_list, method.sslist
            )
        )
        rows.append(row)

    pending = []
    for gfile in gfile_list:
        pending.append((gfile, method._labeling_dispatch(gfile)))
        if len(pending) > 1:
            finish(*pending.pop(0))
    for item in pending:
        finish(*item)
    out_dir = op.join(wp, "evaluations", model_name, cv_name)
    os.makedirs(out_dir, exist_ok=True)
    out = op.join(out_dir, cohort_eval + ".csv")
    with open(out, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]) if rows else [])
        writer.writeheader()
        writer.writerows(rows)
    print("Evaluation saved:", out)
    return out
