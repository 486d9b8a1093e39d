"""Tracing and profiling (counterpart of ``unetsulc_tpu/utils/profiling.py``).

* :class:`EpochTimer` — per-phase wall time and voxels/s, reported every
  epoch and kept in ``results['voxels_per_sec_<phase>']``;
* :func:`summarize_trace` — device-kernel time from a ``torch.profiler``
  run, aggregated by kernel name (the counterpart of
  ``summarize_xplane``);
* :class:`HostSpans` with :func:`span` — host seconds by span over an
  epoch phase, from the prefetch thread (making a ``batch``, within it
  the dataset's ``points``, ``augment``, ``ids`` and ``voxelize``;
  ``pin``, ``upload``) and the main thread (``wait`` for a batch,
  ``step`` dispatch, the end-of-phase ``fetch``), and within each train
  step on ``TrainState.spans`` its phases (``train/step.py``: ``prep``;
  per volume ``forward``, ``loss``, ``backward``, ``counts``; then
  ``update``): what splits a phase's time beyond the steps (no JAX
  counterpart). With ``timeline`` each span is also kept as a
  :class:`Span` on the ``time.time_ns()`` clock, the clock a
  ``torch.profiler`` trace's timestamps are read in; with ``device``, a
  span on a CUDA device also records CUDA events at its entry and exit,
  which give the device's time inside it without a profiler.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch


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


class Span(NamedTuple):
    """One kept span: its name, the train step it belongs to (``state.step``
    as its ``prep`` took it; None outside a step), the thread that ran it
    (steps of folds trained side by side may share a number), its host
    interval in ``time.time_ns()``, and its CUDA events at entry and exit
    (None off a CUDA device or without ``device``)."""

    name: str
    step: Optional[int]
    thread: int
    start_ns: int
    end_ns: int
    events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]]


class HostSpans:
    """Host wall time by span name, summed over calls and threads. The
    dataset, the input pipeline and ``learning()``'s epoch pass time their
    parts with :func:`span` when ``_epoch_pass`` is given one (None by
    default: nothing is timed), and the train steps their phases when
    ``TrainState.spans`` is one. With ``timeline`` or ``device`` every span
    is also kept in ``records`` (in memory, appended under the lock:
    steps may run on several threads at once)."""

    def __init__(self, timeline: bool = False, device: bool = False):
        self.seconds: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}
        self.timeline = timeline
        self.device = device
        self.records: List[Span] = []
        self._lock = threading.Lock()

    def add(self, name: str, seconds: float,
            record: Optional[Span] = None) -> None:
        with self._lock:
            self.seconds[name] = self.seconds.get(name, 0.0) + seconds
            self.calls[name] = self.calls.get(name, 0) + 1
            if record is not None:
                self.records.append(record)

    @property
    def intervals(self) -> Dict[str, List[Tuple[int, int]]]:
        """{name: [(start_ns, end_ns), ...]}, each list sorted: the host
        marks of a ``torch.profiler`` window read on the same clock."""
        with self._lock:
            records = list(self.records)
        out: Dict[str, List[Tuple[int, int]]] = {}
        for r in records:
            out.setdefault(r.name, []).append((r.start_ns, r.end_ns))
        return {k: sorted(v) for k, v in out.items()}

    def device_ms(self) -> List[Tuple[str, Optional[int], float]]:
        """(name, step, ms) of every kept span with CUDA events, in the
        order the spans closed: the time from the device reaching the
        span's entry event to its reaching the exit event, any idle in
        between included. Waits for each exit event."""
        with self._lock:
            records = [r for r in self.records if r.events is not None]
        out = []
        for r in records:
            start, end = r.events
            end.synchronize()
            out.append((r.name, r.step, start.elapsed_time(end)))
        return out


class _Span:
    """The context of one span: host clocks first and CUDA event last at
    entry, the reverse at exit, so the recorder's own cost falls inside
    the span and consecutive spans tile their caller."""

    __slots__ = ("spans", "name", "step", "device", "stream", "keep", "ns0",
                 "t0", "ev0")

    def __init__(self, spans: HostSpans, name: str, step: Optional[int],
                 device: Optional[torch.device]):
        self.spans, self.name, self.step, self.device = (spans, name, step,
                                                         device)

    def __enter__(self) -> "_Span":
        cuda = (self.spans.device and self.device is not None
                and self.device.type == "cuda")
        self.keep = self.spans.timeline or cuda
        self.ns0 = time.time_ns() if self.keep else 0
        self.t0 = time.perf_counter()
        self.stream = None
        if cuda:
            self.stream = torch.cuda.current_stream(self.device)
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record(self.stream)
        return self

    def __exit__(self, *exc) -> bool:
        events = None
        if self.stream is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            events = (self.ev0, end)
        seconds = time.perf_counter() - self.t0
        record = (Span(self.name, self.step, threading.get_ident(), self.ns0,
                       time.time_ns(), events) if self.keep else None)
        self.spans.add(self.name, seconds, record)
        return False


_NOOP = contextlib.nullcontext()


def span(spans: Optional[HostSpans], name: str, step: Optional[int] = None,
         device: Optional[torch.device] = None):
    """A context that times its block into ``spans[name]``, kept as a
    :class:`Span` of step ``step`` where ``spans`` keeps records, with CUDA
    events on ``device``'s current stream where it records them. With
    ``spans`` None, one shared context that does nothing."""
    if spans is None:
        return _NOOP
    return _Span(spans, name, step, device)
