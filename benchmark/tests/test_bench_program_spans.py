"""The per-layer metrics that read the port's phase spans of the train
step (``benchmark/program_spans.py``, ``metrics/*_ms.train.py``).

On the CPU: each of the eight metric files reads its number from a
synthetic recorder and context, and nothing without a recorder or from a
program whose state takes none; ``attach`` hangs one recorder for all;
a traced run at a small size reports the host metrics (the CPU has no
device events). On the card (``card``): a short dispatched-ahead window of
each cell's step at 64³ under the test's own profiler, then steps called
with the queue empty. The device phases must add up to the window's time
per step, and each queue-empty step's first device record must start
within [-0.1, +2] ms of its ``prep`` span on the host: the spans' clock
and the trace's agree. It prints each cell's phase split and the device
records per phase (run with ``-s``).
"""

import json
import statistics
import time
from types import SimpleNamespace

import pytest

from benchmark import program_spans, registry
from benchmark import run as run_mod
from benchmark import trace as trace_mod

DEVICE = ["forward_ms.train", "backward_ms.train", "loss_counts_ms.train",
          "update_ms.train"]
HOST = ["forward_enqueue_ms.train", "backward_enqueue_ms.train",
        "loss_counts_enqueue_ms.train", "update_enqueue_ms.train"]
NAMES = ["prep", "forward", "loss", "backward", "counts",
         "forward", "loss", "backward", "counts", "update"]
WINDOW, PROBE = [10, 11], [12, 13, 14]


BUMPS = {(12, "backward"): 20.0, (14, "forward"): 30.0}


def _ms(sid, name, k):
    """A distinct number for each (step, span, occurrence); among the
    probe calls, 12 has the median total, while 13 holds each phase's
    median."""
    return sid + 0.1 * NAMES.index(name) + 0.01 * k + BUMPS.get((sid, name), 0)


class _Recorder:
    """Two volumes a step: what the metrics read of ``HostSpans``."""

    def __init__(self):
        self.records, self.rows = [], []
        t = 0
        for sid in WINDOW + PROBE:
            for k, name in enumerate(NAMES):
                host = int(_ms(sid, name, k) * 1e6)
                self.records.append(SimpleNamespace(
                    name=name, step=sid, start_ns=t, end_ns=t + host))
                self.rows.append((name, sid, 2 * _ms(sid, name, k)))
                t += host

    def device_ms(self):
        return list(self.rows)


def _want(metric):
    phase = metric.split("_ms.train")[0].replace("_enqueue", "")
    names = program_spans.PHASES[phase]

    def per_step(sid, scale):
        return sum(scale * _ms(sid, n, k) for k, n in enumerate(NAMES)
                   if n in names)

    if metric in DEVICE:
        return statistics.mean(per_step(s, 2) for s in WINDOW)
    totals = {s: sum(_ms(s, n, k) for k, n in enumerate(NAMES))
              for s in PROBE}
    assert sorted(PROBE, key=totals.get)[1] == 12
    return per_step(12, 1)


@pytest.mark.parametrize("metric", DEVICE + HOST)
def test_each_metric_reads_its_number(metric):
    mod = registry.metric_module(metric)
    run = SimpleNamespace(program_spans=_Recorder())
    got = mod.read({"run": run, "steps": len(WINDOW)})
    assert got == pytest.approx(_want(metric), rel=1e-6)
    others = {_want(m) for m in DEVICE + HOST if m != metric}
    assert all(abs(got - v) > 1e-3 for v in others)


@pytest.mark.parametrize("metric", DEVICE + HOST)
def test_nothing_without_a_recorder(metric):
    mod = registry.metric_module(metric)
    assert mod.read({"run": SimpleNamespace(), "steps": 5}) is None
    # a program whose state takes no recorder
    run = SimpleNamespace(state=SimpleNamespace())
    assert mod.start(run) is None
    assert mod.read({"run": run, "steps": 5}) is None
    # a window longer than what was recorded
    run = SimpleNamespace(program_spans=_Recorder())
    assert mod.read({"run": run, "steps": 6}) is None


def test_attach_shares_one_recorder():
    run = SimpleNamespace(state=SimpleNamespace(spans=None))
    got = [registry.metric_module(m).start(run) for m in DEVICE + HOST]
    assert got[0] is not None and all(g is got[0] for g in got)
    assert run.state.spans is got[0]
    assert got[0].timeline and got[0].device


def test_a_traced_window_reports_the_host_phases(tiny):
    r = run_mod.open_run("unet3d_interp.train_b1", 2 ** 31 + 19, "cpu", tiny)
    r.setup()
    r.window(0.5, True)
    ctx = r.context()
    for m in HOST:
        assert registry.metric_module(m).read(ctx) > 0
    # no device events on the CPU
    assert all(registry.metric_module(m).read(ctx) is None for m in DEVICE)
    # the phases of each queue-empty call tile what dispatch_ms.train times
    probe = sorted({s.step for s in r.program_spans.records})[ctx["steps"]:]
    assert len(probe) == len(r.dispatch_s) > 0
    for sid, call_s in zip(probe, r.dispatch_s):
        phases_ms = sum(s.end_ns - s.start_ns for s in
                        r.program_spans.records if s.step == sid) * 1e-6
        assert 0.9 * call_s * 1e3 <= phases_ms <= call_s * 1e3


CARD_STEPS, CARD_PROBE = 12, 5


@pytest.mark.card
@pytest.mark.parametrize("workload", ["unet3d_interp.train_b1",
                                      "unet3d_transposed.train_b4",
                                      "unet3d_interp.transfer_b1"])
def test_phases_on_the_card(workload, cuda):
    from torch.profiler import ProfilerActivity, profile

    r = run_mod.open_run(workload, 2 ** 31 + 4242, "cuda",
                         {"traffic": {"volume": [64, 64, 64]}})
    r.setup()
    spans = program_spans.attach(r)
    assert spans is not None
    k = r.next_batch
    starts = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        r.sync()
        t0 = time.perf_counter()
        for i in range(CARD_STEPS):
            r.step(r.state, *r.feed(k + i))
        r.sync()
        window_ms = (time.perf_counter() - t0) * 1e3 / CARD_STEPS
        for i in range(CARD_PROBE):
            x, lb = r.feed(k + CARD_STEPS + i)
            r.sync()
            starts.append(time.time_ns())
            r.step(r.state, x, lb)
        r.sync()
    ctx = {"run": r, "steps": CARD_STEPS}
    device = {p: program_spans.device_ms(ctx, p) for p in program_spans.PHASES}
    enqueue = {p: program_spans.enqueue_ms(ctx, p)
               for p in program_spans.PHASES}
    records, launched = _records(prof)
    marks = spans.intervals
    probe_ids = sorted({s.step for s in spans.records})[CARD_STEPS:]
    preps = {s.step: s.start_ns for s in spans.records if s.name == "prep"}
    # a device record belongs to the first queue-empty step whose
    # synchronisation came before its launch (the launch's host time where
    # the trace links the two, else the record's own start)
    at = [(launched.get(cid, s), s) for s, cid in records]
    offsets, lags, per_phase = [], [], {}
    for sid, synced in zip(probe_ids, starts):
        first = min((a, s) for a, s in at if a >= synced)
        offsets.append((first[1] - preps[sid]) * 1e-6)
        lags.append((first[1] - first[0]) * 1e-6)
    for a, s in at:
        if a >= starts[0]:
            name = trace_mod._mark_at(a, marks)
            per_phase[name] = per_phase.get(name, 0) + 1
    print(json.dumps({
        "workload": workload, "window_ms_per_step": window_ms,
        "device_ms": device, "enqueue_ms": enqueue,
        "clock_offsets_ms": offsets, "launch_to_start_ms": lags,
        "linked_launches": sum(cid in launched for _, cid in records),
        "device_records": len(records),
        "device_records_per_probe_step": {
            k: v / CARD_PROBE for k, v in sorted(per_phase.items())}}))
    assert all(v is not None and v > 0 for v in device.values()), device
    assert sum(device.values()) == pytest.approx(window_ms, rel=0.05)
    assert all(-0.1 <= o <= 2.0 for o in offsets), offsets


def _records(prof):
    """([(start_ns, correlation id)] of the trace's device records, sorted;
    {correlation id: host start_ns of the call that launched it})."""
    from torch.autograd import DeviceType

    device, launched = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            kind = e.activity_type() if hasattr(e, "activity_type") else ""
            if "annotation" not in str(kind):
                device.append((e.start_ns(), e.correlation_id()))
        elif e.correlation_id():
            launched[e.correlation_id()] = e.start_ns()
    return sorted(device), launched
