"""Where the harness finds what a cell names: everything that belongs to one
configuration, one traffic mix or one metric is a file of its own, found by
its name in ``BENCHMARK.json``.

    benchmark/configs/<config>.json      the model's sizes and settings
    benchmark/traffic/<mix>.json         the mix's parameters; its "job" names
    benchmark/jobs/<job>.py              the loop that runs such a mix (``Job``)
    benchmark/metrics/<metric>.py        ``read(ctx)`` -> number or None
                                         (and optionally ``start(run)``)
    benchmark/models/<model>.py          builds the port's model and step
    benchmark/references/<model>.py      the plain reference of that model
    benchmark/limits/<workload>.json     the limits of the output check
    benchmark/kernel_classes.json        kernel name -> class and group

Each function takes the folder it reads (``root``, the ``benchmark/``
folder by default), so a test can add a configuration, a mix or a metric
in a folder of its own.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"benchmark file {path} is missing")
    with open(path) as f:
        return json.load(f)


def benchmark(repo: Path = REPO) -> dict:
    return _json(repo / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                   + ", ".join(w["name"] for w in bench["workloads"]))


def config(name: str, root: Path = ROOT) -> dict:
    return _json(root / "configs" / f"{name}.json")


def traffic(name: str, root: Path = ROOT) -> dict:
    return _json(root / "traffic" / f"{name}.json")


def limits(workload_name: str, root: Path = ROOT) -> Dict[str, float]:
    return _json(root / "limits" / f"{workload_name}.json")["limits"]


def kernel_classes(root: Path = ROOT) -> List[dict]:
    return _json(root / "kernel_classes.json")["classes"]


def _load_file(path: Path, module_name: str):
    if not path.is_file():
        raise FileNotFoundError(f"benchmark file {path} is missing")
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_module(name: str, root: Path = ROOT):
    """``metrics/<name>.py`` (a metric's name may hold dots, so the file is
    loaded by its path): ``read(ctx)`` -> number or None, and optionally
    ``start(run)``, run before the window opens."""
    return _load_file(root / "metrics" / f"{name}.py",
                      "benchmark_metric_" + name.replace(".", "_"))


def model(name: str, root: Path = ROOT):
    """``models/<name>.py``: the program's side of a model family."""
    if root == ROOT:
        return importlib.import_module(f"benchmark.models.{name}")
    return _load_file(root / "models" / f"{name}.py", f"benchmark_model_{name}")


def job(name: str, root: Path = ROOT):
    """The ``Job`` class of ``jobs/<name>.py``: what runs a traffic mix
    whose ``job`` is ``name``. A name with no such file is refused."""
    if not (root / "jobs" / f"{name}.py").is_file():
        raise FileNotFoundError(
            f"no job {name!r}: benchmark file {root / 'jobs' / (name + '.py')}"
            " is missing")
    if root == ROOT:
        return importlib.import_module(f"benchmark.jobs.{name}").Job
    return _load_file(root / "jobs" / f"{name}.py", f"benchmark_job_{name}").Job


def reference(name: str, root: Path = ROOT):
    """``references/<name>.py``: the plain reference of a model family."""
    if root == ROOT:
        return importlib.import_module(f"benchmark.references.{name}")
    return _load_file(root / "references" / f"{name}.py",
                      f"benchmark_reference_{name}")


def cell_metrics(bench: dict, section: str, workload_name: str) -> List[dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that the
    cell reports: those whose ``workloads`` list names it, or that have no
    such list."""
    return [m for m in bench[section]
            if workload_name in m.get("workloads", [workload_name])]
