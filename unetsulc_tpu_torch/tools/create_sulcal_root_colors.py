"""Anatomist ``.hie`` hierarchy color files (ref tools/create_sulcal_root_colors.py:12-138).

Emits a ``.hie`` tree that colors each sulcus either randomly or by a
jet-colormap of an evaluation metric (Elocal/ESI per sulcus) read from
evaluation CSVs.  The reference's ``:59`` undefined-variable bug (random
mode crashed) is fixed: random mode draws a color per sulcus from a seeded
Generator.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

_HEADER = """# tree 1.0

*BEGIN TREE hierarchy
graph_syntax CorticalFoldArg

*BEGIN TREE fold_name
name brain

"""
_FOOTER = "*END\n\n*END\n"


def _metric_colors(values: Dict[str, float]) -> Dict[str, tuple]:
    """Map metric values onto the jet colormap (ref :76-134)."""
    import matplotlib

    vals = np.asarray(list(values.values()), dtype=float)
    lo, hi = float(vals.min()), float(vals.max())
    span = (hi - lo) or 1.0
    cmap = matplotlib.colormaps["jet"]
    out = {}
    for name, v in values.items():
        r, g, b, _ = cmap((v - lo) / span)
        out[name] = (int(r * 255), int(g * 255), int(b * 255))
    return out


def _random_colors(
    names: Sequence[str], seed: int = 0
) -> Dict[str, tuple]:
    rng = np.random.default_rng(seed)
    return {n: tuple(int(c) for c in rng.integers(0, 256, 3)) for n in names}


def sulcus_metric_from_csv(
    evaluation_csv: str, metric: str = "Elocal"
) -> Dict[str, float]:
    """Mean per-sulcus metric from an evaluation CSV (columns
    ``<metric>_<sulcus>``, SURVEY.md §2.4)."""
    import pandas as pd

    df = pd.read_csv(evaluation_csv)
    prefix = metric + "_"
    return {
        c[len(prefix) :]: float(df[c].mean())
        for c in df.columns
        if c.startswith(prefix)
    }


def write_hie(
    out_path: str,
    sulci: Sequence[str],
    metric_values: Optional[Dict[str, float]] = None,
    seed: int = 0,
) -> str:
    """Write the hierarchy color file.

    ``metric_values`` given -> jet colormap of the metric; otherwise random
    colors (both modes of the reference tool).
    """
    colors = (
        _metric_colors(metric_values)
        if metric_values
        else _random_colors(sulci, seed)
    )
    with open(out_path, "w") as f:
        f.write(_HEADER)
        for name in sulci:
            r, g, b = colors.get(name, (127, 127, 127))
            f.write("*BEGIN TREE fold_name\n")
            f.write(f"name {name}\n")
            f.write(f"color {r} {g} {b}\n")
            f.write("*END\n\n")
        f.write(_FOOTER)
    return out_path
