"""Cohort statistics figures (ref create_figures/plot_cohort_features.py:14-171).

Per-sulcus voxel-count and occurrence statistics across a cohort, rendered
as bar/box plots.  Data comes from the framework's cached
``data/<cohort>_data.json`` (or is regenerated from the graphs, like the
reference's optional re-extraction path, ref :38-82).
"""

from __future__ import annotations

import json
import os.path as op
from collections import defaultdict
from typing import Dict, Optional, Sequence

import numpy as np


def cohort_features(
    dict_bck2: Dict[str, list], dict_names: Dict[str, list]
) -> dict:
    """Per-sulcus size (voxel count) per subject + occurrence counts."""
    sizes = defaultdict(list)  # sulcus -> [count per subject]
    occurrences = defaultdict(int)
    for gfile, names in dict_names.items():
        counts = defaultdict(int)
        for n in names:
            counts[n] += 1
        for s, c in counts.items():
            sizes[s].append(c)
            occurrences[s] += 1
    return {"sizes": dict(sizes), "occurrences": dict(occurrences)}


def regenerate_data(graphs: Sequence[str]) -> dict:
    """Re-extract from graphs when no cached data JSON exists (ref :38-82)."""
    from unetsulc_tpu_torch.data.extract import extract_data
    from unetsulc_tpu_torch.io.container import read_graph

    dict_bck2, dict_names = {}, {}
    for gfile in graphs:
        data = extract_data(read_graph(gfile))
        dict_bck2[gfile] = np.asarray(data["bck2"]).tolist()
        dict_names[gfile] = np.asarray(data["names"]).tolist()
    return {"dict_bck2": dict_bck2, "dict_names": dict_names}


def plot_cohort_features(
    data_json: str,
    out_dir: str = ".",
    cohort_name: Optional[str] = None,
):
    """Emit the four summary figures (sizes barh, sizes boxplot,
    occurrences barh, subjects-per-sulcus).  Returns figure paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(data_json) as f:
        data = json.load(f)
    feats = cohort_features(data["dict_bck2"], data["dict_names"])
    name = cohort_name or op.splitext(op.basename(data_json))[0]
    sulci = sorted(feats["sizes"].keys())
    paths = []

    def _save(fig, tag):
        p = op.join(out_dir, f"{name}_{tag}.png")
        fig.tight_layout()
        fig.savefig(p, dpi=120)
        plt.close(fig)
        paths.append(p)

    mean_sizes = [float(np.mean(feats["sizes"][s])) for s in sulci]
    fig, ax = plt.subplots(figsize=(8, max(3, 0.25 * len(sulci))))
    ax.barh(sulci, mean_sizes)
    ax.set_xlabel("mean voxels per subject")
    ax.set_title(f"{name}: sulcus sizes")
    _save(fig, "sizes_mean")

    fig, ax = plt.subplots(figsize=(8, max(3, 0.25 * len(sulci))))
    ax.boxplot(
        [feats["sizes"][s] for s in sulci],
        orientation="horizontal",
        tick_labels=sulci,
    )
    ax.set_xlabel("voxels per subject")
    _save(fig, "sizes_box")

    occ = [feats["occurrences"][s] for s in sulci]
    fig, ax = plt.subplots(figsize=(8, max(3, 0.25 * len(sulci))))
    ax.barh(sulci, occ)
    ax.set_xlabel("subjects containing sulcus")
    _save(fig, "occurrences")

    total = [int(np.sum(feats["sizes"][s])) for s in sulci]
    fig, ax = plt.subplots(figsize=(8, max(3, 0.25 * len(sulci))))
    ax.barh(sulci, total)
    ax.set_xlabel("total voxels in cohort")
    _save(fig, "sizes_total")
    return paths
