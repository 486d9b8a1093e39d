"""Training-results figures (ref create_figures/plot_results.py:13-207).

Loss/accuracy curves per CV fold from ``results/<model>_results.json``, and
per-sulcus Elocal/ESI bars from evaluation CSVs
(``evaluations/<model>/<model>_cvK/<cohort>.csv`` with columns
``acc_/sens_/spec_/bacc_/ESI_/Elocal_/TP_/FN_/FP_<sulcus>`` + global
``ESI`` — schema in SURVEY.md §2.4; this framework's
:mod:`unetsulc_tpu_torch.experiment.evaluation` produces them).
"""

from __future__ import annotations

import json
import os.path as op
from typing import List, Optional

import numpy as np


def plot_training_curves(results_json: str, out_dir: str = ".") -> List[str]:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(results_json) as f:
        r = json.load(f)
    name = op.splitext(op.basename(results_json))[0].replace("_results", "")
    paths = []
    for metric in ("loss", "acc"):
        fig, axes = plt.subplots(1, 2, figsize=(11, 4), sharey=True)
        for phase, ax in zip(("train", "val"), axes):
            key = f"epoch_{metric}_{phase}"
            for cv, series in enumerate(r.get(key, [])):
                ax.plot(series, label=f"cv{cv}")
            ax.set_title(f"{metric} / {phase}")
            ax.set_xlabel("epoch")
            ax.legend(fontsize=7)
        p = op.join(out_dir, f"{name}_{metric}_curves.png")
        fig.tight_layout()
        fig.savefig(p, dpi=120)
        plt.close(fig)
        paths.append(p)
    return paths


def plot_threshold_scores(results_json: str, out_dir: str = ".") -> Optional[str]:
    """Mean (1-ESI)*100 per cutting threshold across folds (ref main.py
    selection data, visualized)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(results_json) as f:
        r = json.load(f)
    th_scores = r.get("threshold_scores", {})
    if not th_scores:
        return None
    name = op.splitext(op.basename(results_json))[0].replace("_results", "")
    ths = sorted(th_scores, key=lambda t: float(t))
    means = [float(np.mean([np.mean(s) for s in th_scores[t]])) for t in ths]
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot([float(t) for t in ths], means, marker="o")
    ax.set_xlabel("cutting threshold")
    ax.set_ylabel("(1 - ESI) x 100")
    ax.set_title(f"{name}: threshold sweep")
    p = op.join(out_dir, f"{name}_thresholds.png")
    fig.tight_layout()
    fig.savefig(p, dpi=120)
    plt.close(fig)
    return p


def plot_elocal_bars(evaluation_csv: str, out_dir: str = ".") -> str:
    """Per-sulcus local error bars from an evaluation CSV (ref :86-96)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd

    df = pd.read_csv(evaluation_csv)
    elocal_cols = [c for c in df.columns if c.startswith("Elocal_")]
    sulci = [c[len("Elocal_") :] for c in elocal_cols]
    means = df[elocal_cols].mean().values
    order = np.argsort(means)[::-1]
    fig, ax = plt.subplots(figsize=(8, max(3, 0.25 * len(sulci))))
    ax.barh(
        [sulci[i] for i in order][::-1], [means[i] for i in order][::-1]
    )
    ax.set_xlabel("E_local")
    name = op.splitext(op.basename(evaluation_csv))[0]
    p = op.join(out_dir, f"{name}_elocal.png")
    fig.tight_layout()
    fig.savefig(p, dpi=120)
    plt.close(fig)
    return p
