"""Cohort construction tooling (ref tools/select_subjects.py:12-263).

Builds cohort JSONs (`{name, subjects: [{name, t1, roots, skeleton, graph,
notcut_graph}]}`, schema of SURVEY.md §2.4) from a BrainVISA database tree
``<db>/<center>/<subject>/t1mri/<acquisition>/...``.

The reference file ships two latent bugs fixed here (SURVEY.md §4):
a syntax error in ``create_cohort`` (ref :163) and an
uninitialized-variable crash in ``create_short_cohort`` (ref :116).
Graph paths accept ``.arg`` (BrainVISA) or this framework's ``.npz/.json``
containers.
"""

from __future__ import annotations

import glob
import json
import os
import os.path as op
from typing import Dict, List, Optional, Sequence


def _subject_paths(db: str, center: str, subject: str, hemi: str, graph_version: str = "3.1"):
    """Expected BrainVISA file locations for one subject/hemisphere."""
    base = op.join(db, center, subject)
    acq_glob = op.join(base, "t1mri", "*")
    acqs = sorted(glob.glob(acq_glob))
    if not acqs:
        return None
    acq = acqs[0]
    ana = op.join(acq, "default_analysis")
    seg = op.join(ana, "segmentation")
    folds = op.join(ana, "folds", graph_version)
    t1 = op.join(acq, subject + ".nii.gz")
    if not op.exists(t1):
        t1 = op.join(acq, subject + ".nii")
    paths = {
        "t1": t1,
        "roots": op.join(seg, f"{hemi}roots_{subject}.nii.gz"),
        "skeleton": op.join(seg, f"{hemi}skeleton_{subject}.nii.gz"),
        "graph": _first_existing(
            [
                op.join(folds, "base2018_manual", f"{hemi}{subject}_base2018_manual.arg"),
                op.join(folds, f"{hemi}{subject}.arg"),
            ]
        ),
        "notcut_graph": _first_existing(
            [
                op.join(
                    folds.replace(graph_version, graph_version + "_notcut"),
                    f"{hemi}{subject}.arg",
                ),
            ]
        ),
    }
    return paths


def _first_existing(candidates: Sequence[str]) -> Optional[str]:
    for c in candidates:
        if op.exists(c):
            return c
    return candidates[0] if candidates else None


def select_subjects(
    db: str,
    center: str,
    exclusion_list: Optional[Sequence[str]] = None,
) -> List[str]:
    """List subject dirs under <db>/<center>, minus exclusions, with an
    audit print for excluded-but-absent names (ref :12-79 semantics)."""
    exclusion_list = list(exclusion_list or [])
    root = op.join(db, center)
    subjects = sorted(
        d for d in os.listdir(root) if op.isdir(op.join(root, d))
    )
    missing = [e for e in exclusion_list if e not in subjects]
    if missing:
        print("Excluded subjects not present in database:", missing)
    return [s for s in subjects if s not in exclusion_list]


def create_cohort(
    db: str,
    center: str,
    name: str,
    out_dir: str = ".",
    hemis: Sequence[str] = ("L", "R"),
    exclusion_list: Optional[Sequence[str]] = None,
    require_notcut: bool = False,
) -> Dict[str, str]:
    """Walk the database and emit cohort-<name>_hemi-{L,R}.json
    (ref :153-236, with the :163 syntax error's intended logic restored:
    a subject is kept iff its required files exist)."""
    written = {}
    for hemi in hemis:
        subjects = []
        for subject in select_subjects(db, center, exclusion_list):
            paths = _subject_paths(db, center, subject, hemi)
            if paths is None:
                continue
            graph_exists = paths["graph"] and op.exists(paths["graph"])
            notcut_exists = paths["notcut_graph"] and op.exists(
                paths["notcut_graph"]
            )
            if not graph_exists:
                continue
            if require_notcut and not notcut_exists:
                continue
            subjects.append(
                {
                    "name": subject,
                    "t1": paths["t1"] if op.exists(paths["t1"]) else None,
                    "roots": paths["roots"]
                    if op.exists(paths["roots"])
                    else None,
                    "skeleton": paths["skeleton"]
                    if op.exists(paths["skeleton"])
                    else None,
                    "graph": paths["graph"],
                    "notcut_graph": paths["notcut_graph"]
                    if notcut_exists
                    else None,
                }
            )
        cohort = {"name": name, "subjects": subjects}
        out = op.join(out_dir, f"cohort-{name}_hemi-{hemi}.json")
        os.makedirs(out_dir, exist_ok=True)
        with open(out, "w") as f:
            json.dump(cohort, f, indent=2)
        print(f"{out}: {len(subjects)} subjects")
        written[hemi] = out
    return written


def load_cohort_file(path: str) -> dict:
    with open(path, "r") as f:
        return json.load(f)


def change_path_cohort(path: str, old_prefix: str, new_prefix: str) -> None:
    """Rewrite path prefixes inside a cohort file in place (ref :82-103)."""
    cohort = load_cohort_file(path)
    for s in cohort["subjects"]:
        for key in ("t1", "roots", "skeleton", "graph", "notcut_graph"):
            if s.get(key):
                s[key] = s[key].replace(old_prefix, new_prefix)
    with open(path, "w") as f:
        json.dump(cohort, f, indent=2)


def create_short_cohort(path: str, out_path: str, n: int) -> dict:
    """First-n-subjects sub-cohort (ref :106-125; the reference crashes on
    an uninitialized variable — this is the intended behavior)."""
    cohort = load_cohort_file(path)
    new_cohort = {
        "name": cohort["name"] + f"_short{n}",
        "subjects": cohort["subjects"][:n],
    }
    with open(out_path, "w") as f:
        json.dump(new_cohort, f, indent=2)
    return new_cohort


def select_subjects_from_cohort(
    path: str, out_path: str, subject_names: Sequence[str], name: Optional[str] = None
) -> dict:
    """Sub-cohort by subject-name list (ref :128-150)."""
    cohort = load_cohort_file(path)
    keep = set(subject_names)
    new_cohort = {
        "name": name or cohort["name"] + "_selection",
        "subjects": [s for s in cohort["subjects"] if s["name"] in keep],
    }
    with open(out_path, "w") as f:
        json.dump(new_cohort, f, indent=2)
    return new_cohort


def create_composed_cohort(
    paths: Sequence[str], out_path: str, name: str
) -> dict:
    """Merge several cohorts, de-duplicating by subject name (ref :239-263)."""
    seen = set()
    subjects = []
    for p in paths:
        for s in load_cohort_file(p)["subjects"]:
            if s["name"] not in seen:
                seen.add(s["name"])
                subjects.append(s)
    new_cohort = {"name": name, "subjects": subjects}
    with open(out_path, "w") as f:
        json.dump(new_cohort, f, indent=2)
    return new_cohort
