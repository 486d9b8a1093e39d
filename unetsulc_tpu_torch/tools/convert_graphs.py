"""Offline graph converter: BrainVISA ``.arg`` -> fast ``.npz`` containers.

SURVEY.md §7 step 1: "an offline converter .arg -> npz ... preserves the
public contract".  The training pipeline reads ``.arg`` directly, but the
``.npz`` container loads ~an order of magnitude faster (one compressed
read vs text parse + per-bucket files), which matters when the extraction
cache is cold.

    python -m unetsulc_tpu_torch.tools.convert_graphs g1.arg g2.arg -o out/
    python -m unetsulc_tpu_torch.tools.convert_graphs --cohort cohort-X_hemi-L.json -o out/

``--cohort`` converts every graph/notcut_graph in a cohort JSON and writes
an updated cohort file pointing at the converted containers.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as op


def convert_one(path: str, out_dir: str) -> str:
    from unetsulc_tpu_torch.io.container import read_graph, save_graph_npz

    graph = read_graph(path)
    out = op.join(
        out_dir, op.splitext(op.basename(path))[0] + ".npz"
    )
    save_graph_npz(graph, out)
    print(f"{path} -> {out} ({graph.npoints()} points, "
          f"{len(graph.vertices())} folds)")
    return out


def convert_cohort(cohort_path: str, out_dir: str) -> str:
    with open(cohort_path) as f:
        cohort = json.load(f)
    converted = {}
    for s in cohort["subjects"]:
        for key in ("graph", "notcut_graph"):
            src = s.get(key)
            if not src:
                continue
            if src not in converted:
                converted[src] = convert_one(src, out_dir)
            s[key] = converted[src]
    out_cohort = op.join(out_dir, op.basename(cohort_path))
    with open(out_cohort, "w") as f:
        json.dump(cohort, f, indent=2)
    print(f"cohort -> {out_cohort}")
    return out_cohort


def main():
    ap = argparse.ArgumentParser(description="Convert graphs to .npz")
    ap.add_argument("graphs", nargs="*", help=".arg/.json graph files")
    ap.add_argument("--cohort", default=None, help="cohort JSON to convert")
    ap.add_argument("-o", dest="out_dir", default="converted")
    args = ap.parse_args()
    os.makedirs(args.out_dir, exist_ok=True)
    if args.cohort:
        convert_cohort(args.cohort, args.out_dir)
    for g in args.graphs:
        convert_one(g, args.out_dir)


if __name__ == "__main__":
    main()
