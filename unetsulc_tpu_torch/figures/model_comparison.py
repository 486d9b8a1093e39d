"""Two-model comparison figures (ref create_figures/model_comparison.py:14-285).

Overlaid training curves (shorter runs padded with their last value,
ref :147-168) and per-sulcus metric deltas from evaluation CSVs, plus a
Wilcoxon signed-rank test on the per-subject global ESI (the reference
imports wilcoxon but never calls it, ref :6 — wired up here).
"""

from __future__ import annotations

import json
import os.path as op
from typing import Dict, List, Optional, Tuple

import numpy as np


def _pad_to(series: List[float], n: int) -> List[float]:
    """Pad a shorter curve with its last value (ref :147-168)."""
    if not series:
        return [np.nan] * n
    return list(series) + [series[-1]] * (n - len(series))


def compare_curves(
    results_a: str,
    results_b: str,
    labels: Tuple[str, str] = ("model A", "model B"),
    out_dir: str = ".",
) -> List[str]:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    curves = []
    for path in (results_a, results_b):
        with open(path) as f:
            curves.append(json.load(f))
    paths = []
    for metric in ("loss", "acc"):
        for phase in ("train", "val"):
            key = f"epoch_{metric}_{phase}"
            fig, ax = plt.subplots(figsize=(7, 4))
            series_ab = [
                [np.asarray(s, float) for s in c.get(key, [])] for c in curves
            ]
            n = max(
                (len(s) for ss in series_ab for s in ss),
                default=0,
            )
            for label, ss in zip(labels, series_ab):
                if not ss:
                    continue
                padded = np.asarray([_pad_to(list(s), n) for s in ss])
                mean = padded.mean(axis=0)
                ax.plot(mean, label=f"{label} (mean of {len(ss)} folds)")
                ax.fill_between(
                    np.arange(n),
                    padded.min(axis=0),
                    padded.max(axis=0),
                    alpha=0.15,
                )
            ax.set_xlabel("epoch")
            ax.set_title(f"{metric} / {phase}")
            ax.legend(fontsize=8)
            p = op.join(out_dir, f"compare_{metric}_{phase}.png")
            fig.tight_layout()
            fig.savefig(p, dpi=120)
            plt.close(fig)
            paths.append(p)
    return paths


def compare_evaluations(
    csv_a: str,
    csv_b: str,
    labels: Tuple[str, str] = ("model A", "model B"),
    out_dir: str = ".",
) -> Dict[str, object]:
    """Per-sulcus Elocal comparison + Wilcoxon test on global ESI."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd
    from scipy.stats import wilcoxon

    dfa = pd.read_csv(csv_a)
    dfb = pd.read_csv(csv_b)
    cols = sorted(
        set(c for c in dfa.columns if c.startswith("Elocal_"))
        & set(c for c in dfb.columns if c.startswith("Elocal_"))
    )
    sulci = [c[len("Elocal_") :] for c in cols]
    ma = dfa[cols].mean().values
    mb = dfb[cols].mean().values
    fig, ax = plt.subplots(figsize=(8, max(3, 0.25 * len(sulci))))
    y = np.arange(len(sulci))
    ax.barh(y + 0.2, ma, height=0.4, label=labels[0])
    ax.barh(y - 0.2, mb, height=0.4, label=labels[1])
    ax.set_yticks(y, sulci)
    ax.set_xlabel("E_local")
    ax.legend()
    p = op.join(out_dir, "compare_elocal.png")
    fig.tight_layout()
    fig.savefig(p, dpi=120)
    plt.close(fig)

    stat: Optional[tuple] = None
    if "ESI" in dfa.columns and "ESI" in dfb.columns and len(dfa) == len(dfb):
        diffs = dfa["ESI"].values - dfb["ESI"].values
        if np.any(diffs != 0):
            w = wilcoxon(dfa["ESI"].values, dfb["ESI"].values)
            stat = (float(w.statistic), float(w.pvalue))
    return {"figure": p, "wilcoxon_esi": stat}
