"""The port's own phase spans of the train step, read by the per-layer
metrics ``<phase>_ms.train`` (device time) and
``<phase>_enqueue_ms.train`` (host time).

The port's step times its phases when ``TrainState.spans`` holds a
recorder (``unetsulc_tpu_torch/utils/profiling.py`` ``HostSpans``):
``prep``, per volume ``forward``, ``loss``, ``backward`` and ``counts``,
then ``update``, one after another over the call. Each metric file's
``start(run)`` is :func:`attach`, which hangs one recorder, with its
timeline and CUDA events, on the run's state before the traced window and
gives the same one to every metric; the harness's untraced runs never
call it, so the step records nothing there. Each span carries the step it
belongs to (``state.step`` as its ``prep`` read it): the first
``ctx["steps"]`` steps recorded are the window's, dispatched ahead; the
steps after them are the calls that ``jobs/train.py``'s
``probe_dispatch`` makes, each once the device has finished the one
before.

A program whose state takes no recorder gives nothing to read: every
function here returns None there.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

PHASES = {
    "forward": ("forward",),
    "backward": ("backward",),
    "loss_counts": ("prep", "loss", "counts"),
    "update": ("update",),
}


def attach(run):
    """The run's one recorder, hung on ``run.state.spans`` the first time
    (None where the program has no such recorder)."""
    if getattr(run, "program_spans", None) is not None:
        return run.program_spans
    from unetsulc_tpu_torch.utils.profiling import HostSpans

    try:
        spans = HostSpans(timeline=True, device=True)
    except TypeError:  # a recorder without a timeline or device events
        return None
    if not hasattr(run.state, "spans"):
        return None
    run.state.spans = spans
    run.program_spans = spans
    return spans


def _per_step(ctx, kind: str) -> Optional[Tuple[List[int], List[int],
                                                 Dict[int, Dict[str, float]]]]:
    """(window steps, probe steps, {step: {span name: ms}}) from the
    run's recorder: ``kind`` "device" from the CUDA events, "host" from
    the timeline. None without a recorder or a full window's steps."""
    spans = getattr(ctx.get("run"), "program_spans", None)
    n = ctx.get("steps") or 0
    if spans is None or n <= 0:
        return None
    if kind == "device":
        rows = spans.device_ms()
    else:
        rows = [(r.name, r.step, (r.end_ns - r.start_ns) * 1e-6)
                for r in spans.records]
    ms: Dict[int, Dict[str, float]] = {}
    for name, sid, v in rows:
        per = ms.setdefault(sid, {})
        per[name] = per.get(name, 0.0) + v
    order = sorted(ms)
    if len(order) < n:
        return None
    return order[:n], order[n:], ms


def _phase(per: Dict[str, float], names: Sequence[str]) -> float:
    return sum(per.get(k, 0.0) for k in names)


def device_ms(ctx, phase: str) -> Optional[float]:
    """Device milliseconds per window step in ``phase`` (a key of
    :data:`PHASES`): from the device reaching each span's entry event to
    its reaching the exit event, idle inside included."""
    got = _per_step(ctx, "device")
    if got is None:
        return None
    window, _, ms = got
    total = sum(_phase(ms[s], PHASES[phase]) for s in window)
    return total / len(window) if total > 0 else None


def enqueue_ms(ctx, phase: str) -> Optional[float]:
    """Host milliseconds in ``phase`` of the median queue-empty call after
    the window: the call whose phases' total is the median of the calls'
    totals (the lower one of an even count). One call's phases, so that
    the four metrics add up to that call, which ``dispatch_ms.train``'s
    median also times: the host's noise hits a call in one phase or
    another, and phase by phase medians would leave it out."""
    got = _per_step(ctx, "host")
    if got is None or not got[1]:
        return None
    _, probe, ms = got
    ranked = sorted(probe, key=lambda s: sum(ms[s].values()))
    value = _phase(ms[ranked[(len(ranked) - 1) // 2]], PHASES[phase])
    return value if value > 0 else None
