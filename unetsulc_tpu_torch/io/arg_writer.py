"""BrainVISA ``.arg`` graph writer (fixture generator + export path).

Counterpart of :mod:`unetsulc_tpu_torch.io.arg_reader`: emits a text ``.arg``
tree plus a ``.data/`` directory with global ``.bck`` bucket files (binar
by default, ascii optional).  Used for round-trip tests and to export
synthetic cohorts in the reference's on-disk layout.
"""

from __future__ import annotations

import os
import os.path as op
import struct
from typing import Dict

import numpy as np

from unetsulc_tpu_torch.io.graph import BUCKET_TYPES, SulcalGraph

_BUCKET_LABEL_KEYS = {
    "aims_ss": "ss_label",
    "aims_bottom": "bottom_label",
    "aims_other": "other_label",
}


def write_bck(
    path: str, buckets: Dict[int, np.ndarray], ascii_mode: bool = False
) -> None:
    """Write {time: (n,3) int coords} as a VOID bucket file."""
    if ascii_mode:
        with open(path, "w") as f:
            f.write("ascii\n")
            f.write("VOID\n")
            f.write("1 1 1 1\n")  # voxel size placeholder (unused)
            f.write(f"{len(buckets)}\n")
            for t in sorted(buckets):
                pts = np.asarray(buckets[t], np.int64)
                f.write(f"{t} {len(pts)}\n")
                f.write(
                    "\n".join(f"({x},{y},{z})" for x, y, z in pts) + "\n"
                )
        return
    with open(path, "wb") as f:
        f.write(b"binar")
        f.write(struct.pack("<I", 0x41424344))
        f.write(struct.pack("<I", 4) + b"VOID")
        f.write(struct.pack("<4f", 1.0, 1.0, 1.0, 1.0))
        f.write(struct.pack("<I", len(buckets)))
        for t in sorted(buckets):
            pts = np.asarray(buckets[t], np.int64)
            f.write(struct.pack("<II", int(t), len(pts)))
            f.write(pts.astype("<i2").tobytes())


def _fmt(v) -> str:
    if isinstance(v, (list, tuple, np.ndarray)):
        return " ".join(_fmt(x) for x in np.asarray(v).ravel())
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    return str(v)


def save_graph_arg(
    graph: SulcalGraph, path: str, ascii_buckets: bool = False
) -> None:
    base = op.splitext(op.basename(path))[0] + ".data"
    data_dir = op.join(op.dirname(path), base)
    os.makedirs(data_dir, exist_ok=True)

    # assemble global buckets: one time-slice per vertex per bucket type
    global_buckets: Dict[str, Dict[int, np.ndarray]] = {
        bt: {} for bt in BUCKET_TYPES
    }
    vertex_labels = []
    for vi, v in enumerate(graph.vertices()):
        labels = {}
        for bt, pts in v.buckets.items():
            t = len(global_buckets[bt])
            global_buckets[bt][t] = np.asarray(pts)
            labels[bt] = t
        vertex_labels.append(labels)

    for bt, tb in global_buckets.items():
        if tb:
            write_bck(
                op.join(data_dir, f"{bt}.global.bck"), tb, ascii_buckets
            )

    tal = graph.talairach
    with open(path, "w") as f:
        f.write("# graph 1.0\n\n")
        f.write("*BEGIN GRAPH CorticalFoldArg\n")
        f.write(f"filename_base {base}\n")
        f.write(f"voxel_size {_fmt(list(graph.voxel_size))}\n")
        f.write(f"Talairach_rotation {_fmt(tal.rotation.ravel())}\n")
        f.write(f"Talairach_translation {_fmt(tal.translation)}\n")
        if tal.scale is not None:
            f.write(f"Talairach_scale {_fmt(tal.scale)}\n")
        for bt, tb in global_buckets.items():
            if tb:
                f.write(f"{bt}.global.bck {bt}.global.bck\n")
        for key, val in graph.attributes.items():
            f.write(f"{key} {_fmt(val)}\n")
        for vi, v in enumerate(graph.vertices()):
            f.write(f"\n*BEGIN NODE fold {v.index}\n")
            f.write(f"index {v.index}\n")
            if v.name is not None:
                f.write(f"name {v.name}\n")
            for bt, t in vertex_labels[vi].items():
                f.write(f"{_BUCKET_LABEL_KEYS[bt]} {t}\n")
                f.write(f"{bt} {bt}\n")  # marker; data resolved via label
            f.write(f"point_number {v.npoints()}\n")
            f.write("*END\n")
        f.write("\n*END\n")
