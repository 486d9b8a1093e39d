"""Reading the profiler's timeline of a traced window.

The profiler records the device's activity only (CUDA), so that the host
runs at nearly its untraced pace. The harness keeps its own marks on the
host, in ``time.time_ns()``, the clock of the trace's timestamps: the
window, the job's own spans (each step call, ``step``, in training) and
the drain at the window's end (``drain``). From the trace's device records (kernels, copies, fills; not
annotations) this module takes the union of their intervals inside the
window (the device's busy time; not their sum), device time by kernel
class (``kernel_classes.json``: the first class whose patterns match a
kernel's name), and the gaps in the union, each named by the host mark
that was open in its middle ("loop" between marks).
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple


def classify(name: str, classes: List[dict]) -> Tuple[str, str]:
    """(class, group) of a device record's name; unmatched ones are
    ("plain:<name>", "plain")."""
    for c in classes:
        if any(p in name for p in c["match"]):
            return c["class"], c["group"]
    return "plain:" + name[:60], "plain"


def _device_records(prof) -> List[Tuple[int, int, str]]:
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        kind = e.activity_type() if hasattr(e, "activity_type") else ""
        if "annotation" in str(kind):
            continue
        s = e.start_ns()
        out.append((s, s + e.duration_ns(), e.name()))
    return out


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _mark_at(t: int, marks: Dict[str, List[Tuple[int, int]]]) -> str:
    for name, spans in marks.items():
        k = bisect.bisect_right(spans, (t, float("inf"))) - 1
        if k >= 0 and spans[k][0] <= t <= spans[k][1]:
            return name
    return "loop"


def read(prof, classes: List[dict], window: Tuple[int, int],
         marks: Dict[str, List[Tuple[int, int]]], top: int = 10) -> Optional[dict]:
    """busy_s, window_s, seconds by class and by group, the ``top``
    classes by time and the ``top`` longest gaps, over ``window`` (ns);
    ``marks``: host spans by name ("step", "drain"), each list sorted. None where no
    device record falls in the window."""
    w0, w1 = window
    device = _device_records(prof)
    overlap = [(s, e, n) for s, e, n in device if e > w0 and s < w1]
    if not overlap:
        return None
    inside = [(max(s, w0), min(e, w1), n) for s, e, n in overlap]
    by_class: Dict[str, float] = {}
    by_group: Dict[str, float] = {}
    for s, e, n in inside:
        c, g = classify(n, classes)
        by_class[c] = by_class.get(c, 0.0) + (e - s) * 1e-9
        by_group[g] = by_group.get(g, 0.0) + (e - s) * 1e-9
    busy = _union([(s, e) for s, e, _ in inside])
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    gaps = [(edges[k + 1] - edges[k], edges[k])
            for k in range(0, len(edges), 2) if edges[k + 1] > edges[k]]
    gaps.sort(reverse=True)
    return {
        "busy_s": sum(e - s for s, e in busy) * 1e-9,
        "window_s": (w1 - w0) * 1e-9,
        "by_class": by_class,
        "by_group": by_group,
        "device_ops": sorted(by_class.items(), key=lambda kv: -kv[1])[:top],
        "idle_gaps": [[_mark_at(s + d // 2, marks), d * 1e-9]
                      for d, s in gaps[:top]],
        # the clocks' agreement: from the window's opening to the first
        # device record in it, and from the last one's end to its close
        "lead_s": (min(s for s, _, _ in overlap) - w0) * 1e-9,
        "tail_s": (w1 - max(e for _, e, _ in overlap)) * 1e-9,
        "records_outside": sum(1 for s, e, _ in device
                               if e <= w0 or s >= w1),
    }
