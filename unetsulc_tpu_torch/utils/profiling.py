"""Tracing and profiling (counterpart of ``unetsulc_tpu/utils/profiling.py``).

* :class:`EpochTimer` — per-phase wall time and voxels/s, reported every
  epoch and kept in ``results['voxels_per_sec_<phase>']``;
* :func:`trace` — a ``torch.profiler`` context that writes a Chrome trace
  when ``UNETSULC_TRACE_DIR`` or a path is given, and does nothing
  otherwise;
* :func:`summarize_trace` — device-kernel time from a ``torch.profiler``
  run, aggregated by kernel name (the counterpart of
  ``summarize_xplane``);
* :class:`HostSpans` — host seconds by span over an epoch phase, from the
  prefetch thread (making a ``batch``, within it the dataset's
  ``points``, ``augment``, ``ids`` and ``voxelize``; ``pin``, ``upload``)
  and the main thread (``wait`` for a batch, ``step`` dispatch, the
  end-of-phase ``fetch``): what splits a phase's time beyond the steps
  (no JAX counterpart).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple


class EpochTimer:
    """Accumulates wall time and voxel counts within one epoch phase."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._start = time.perf_counter()
        self.voxels = 0

    def add_batch(self, batch_voxels: int):
        self.voxels += int(batch_voxels)

    def finish(self) -> dict:
        elapsed = max(time.perf_counter() - self._start, 1e-9)
        return {
            "seconds": elapsed,
            "voxels": self.voxels,
            "voxels_per_sec": self.voxels / elapsed,
        }


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[Optional[object]]:
    """``torch.profiler`` context over the CPU and, where there is one, the
    card; on exit writes ``trace-<pid>-<time>.json`` (Chrome format) into
    ``log_dir`` or ``$UNETSULC_TRACE_DIR``. Yields the profiler, or None
    (and traces nothing) when no directory is configured."""
    log_dir = log_dir or os.environ.get("UNETSULC_TRACE_DIR")
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{int(time.time() * 1e3)}.json"))


def summarize_trace(prof, top: int = 20) -> List[Tuple[float, str]]:
    """Device-kernel time of a finished ``torch.profiler.profile`` run, by
    kernel name: a list of (total_us, name), most expensive first. Only
    device-side entries count (a host op's entry repeats its kernels'
    time); a run that traced no device gives an empty list."""
    from torch.autograd import DeviceType

    agg = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            agg[e.key] = agg.get(e.key, 0.0) + float(e.self_device_time_total)
    return sorted(((us, name) for name, us in agg.items()), reverse=True)[:top]


class HostSpans:
    """Host wall time by span name, summed over calls and threads. The
    dataset, the input pipeline and ``learning()``'s epoch pass time their
    parts with :func:`span` when ``_epoch_pass`` is given one (None by
    default: nothing is timed)."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}
        self._lock = threading.Lock()

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self.seconds[name] = self.seconds.get(name, 0.0) + seconds
            self.calls[name] = self.calls.get(name, 0) + 1


@contextlib.contextmanager
def span(spans: Optional[HostSpans], name: str):
    """Time the block into ``spans[name]``; nothing when ``spans`` is
    None."""
    if spans is None:
        yield
        return
    t = time.perf_counter()
    try:
        yield
    finally:
        spans.add(name, time.perf_counter() - t)
