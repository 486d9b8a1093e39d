"""What every job of the benchmark shares: one run of one cell, with the
cell's configuration, traffic mix, model files and limits found by name;
set-up timed in parts; the measured window with the profiler and the
device's peak memory around it; and the metrics read from what the run
gathered.

A job (``jobs/<job>.py``, named by the mix's ``job``) subclasses
:class:`Run` and gives ``setup()``, ``loop(deadline)``,
``after_window(traced)``, ``free_program()``, ``check(quant=None)`` and
``context()``; see ``jobs/train.py``.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from benchmark import registry
from benchmark import trace as trace_mod


def _merge(base: dict, over: Optional[dict]) -> dict:
    out = dict(base)
    out.update(over or {})
    return out


class Run:
    """``overrides`` ({"config": {...}, "traffic": {...}}) and ``device``
    let the tests drive a run on the CPU at a small size; ``t0`` is the
    moment set-up is counted from (the process's start, in the command)."""

    def __init__(self, workload: str, seed: int, device: str = "cuda",
                 overrides: Optional[dict] = None, bench: Optional[dict] = None,
                 root: Path = registry.ROOT, t0: Optional[float] = None):
        overrides = overrides or {}
        self.bench = bench or registry.benchmark()
        self.spec = registry.workload(self.bench, workload)
        self.name = workload
        self.cfg = _merge(registry.config(self.spec["config"], root),
                          overrides.get("config"))
        self.traffic = _merge(registry.traffic(self.spec["traffic"], root),
                              overrides.get("traffic"))
        self.model_mod = registry.model(self.cfg["model"], root)
        self.ref_mod = registry.reference(self.cfg["model"], root)
        self.limits = registry.limits(workload, root)
        self.root = root
        self.seed = int(seed)
        self.device = device
        self.parts: Dict[str, float] = {}
        self.info: Dict[str, object] = {}
        self._t0 = time.perf_counter() if t0 is None else t0
        self._mark = self._t0
        self.setup_peak = 0
        self.trace = None

    def _part(self, name: str) -> None:
        self.sync()
        now = time.perf_counter()
        self.parts[name] = now - self._mark
        self._mark = now

    def _setup_done(self) -> None:
        self.setup_s = time.perf_counter() - self._t0

    def sync(self) -> None:
        import torch

        if self.device.startswith("cuda"):
            torch.cuda.synchronize()

    def _readers(self, traced: bool):
        section = "per_layer" if traced else "end_to_end"
        return [(m, registry.metric_module(m["name"], self.root))
                for m in registry.cell_metrics(self.bench, section, self.name)]

    def window(self, seconds: float, traced: bool) -> None:
        """The job's ``loop`` until ``seconds`` have passed, then one
        synchronisation: the queue's drain is inside the window. With
        ``traced`` under the profiler (device activity only). A metric
        file's optional ``start(run)`` runs before the window opens; what
        it returns is ``ctx["started"][<metric>]``."""
        import torch

        self.started = {m["name"]: mod.start(self)
                        for m, mod in self._readers(traced)
                        if hasattr(mod, "start")}
        prof = None
        if traced:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[
                ProfilerActivity.CUDA if self.device.startswith("cuda")
                else ProfilerActivity.CPU])
            prof.__enter__()
        if self.device.startswith("cuda"):
            self.setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        w0 = time.time_ns()
        t0 = time.perf_counter()
        marks: Dict[str, List[Tuple[int, int]]] = self.loop(t0 + seconds)
        d0 = time.time_ns()
        self.sync()
        w1 = time.time_ns()
        self.window_s = time.perf_counter() - t0
        self.peak_window = (torch.cuda.max_memory_allocated()
                            if self.device.startswith("cuda") else 0)
        if prof is not None:
            prof.__exit__(None, None, None)
            marks["drain"] = [(d0, w1)]
            self.trace = trace_mod.read(
                prof, registry.kernel_classes(self.root), (w0, w1), marks)
        self.after_window(traced)

    def context(self) -> dict:
        """What a metric's ``read(ctx)`` gets; a job adds its own keys, and
        ``run`` is the run itself."""
        return {"run": self, "workload": self.name,
                "window_s": self.window_s, "setup_s": self.setup_s,
                "trace": self.trace, "peak_window_bytes": self.peak_window,
                "started": self.started}

    def metrics(self, traced: bool) -> Dict[str, dict]:
        ctx = self.context()
        out = {}
        for m, mod in self._readers(traced):
            value = mod.read(ctx)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out
