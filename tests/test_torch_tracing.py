"""The train step's phase spans (``TrainState.spans``, ``train/step.py``)
and their recorder (``utils/profiling.HostSpans``) on the CPU, at a small
fused size (batch 2: one forward per volume) and a small non-fused one
(``interpolate=False`` with dropout, batch 2 in one forward), f32.

A step that records its phases computes what it computes without them,
bit for bit; its spans come in the order ``prep``, per volume
``forward``, ``loss``, ``backward``, ``counts``, then ``update``, all of
the step that ``state.step`` names when the call starts, one after
another and covering the call; the timeline's ``intervals`` are the host
marks that ``benchmark.trace.read`` names idle gaps by; and steps run on
two threads into one recorder keep their records apart. Device times
need a card: ``benchmark/tests/test_bench_program_spans.py``.
"""

import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from unetsulc_tpu_torch.models.unet3d import UNet3D
from unetsulc_tpu_torch.train.step import TrainState, make_train_step
from unetsulc_tpu_torch.utils.profiling import HostSpans, span
from torch_threads import torch_one_thread  # noqa: F401,E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from benchmark import trace as bench_trace  # noqa: E402

CLASSES = 5
PER_VOLUME = ["forward", "loss", "backward", "counts"]
ROUTES = {
    "fused": dict(kw={}, volumes=2),
    "nonfused": dict(kw={"interpolate": False, "dropout": 0.1}, volumes=1),
}


def _model(**kw):
    m = UNet3D(in_channels=1, out_channels=CLASSES, init_channel_number=8,
               compute_dtype=torch.float32, device="cpu", seed=0, **kw)
    r = np.random.default_rng(5)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(torch.from_numpy(
                (0.03 * r.standard_normal(tuple(p.shape))).astype(np.float32)))
    return m


def _batch(n=2, shape=(8, 8, 8), seed=11):
    r = np.random.default_rng(seed)
    x = (r.random((n, *shape, 1)) < 0.15).astype(np.float32)
    labels = np.where(r.random((n, *shape)) < 0.2,
                      r.integers(0, CLASSES, (n, *shape)), -1)
    return torch.from_numpy(x), torch.from_numpy(labels.astype(np.int64))


def _traced_steps(route, n_steps=2, spans=None, first_step=0):
    """``n_steps`` train steps of a fresh model on the route, recording
    into ``spans``; the model, the outputs, and each call's host
    interval in ``time.time_ns()``."""
    m = _model(**ROUTES[route]["kw"])
    assert m.fused_eligible(_batch()[0][:1]) == (route == "fused")
    state, step = TrainState.create(m, lr=0.05), make_train_step(m, CLASSES)
    state.step = first_step
    state.spans = spans
    x, labels = _batch()
    outs, calls = [], []
    for _ in range(n_steps):
        t0 = time.time_ns()
        outs.append(step(state, x, labels))
        calls.append((t0, time.time_ns()))
    return m, outs, calls


def _by_step(records):
    out = {}
    for r in records:
        out.setdefault(r.step, []).append(r)
    return out


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_spans_leave_the_step_bit_equal(route):
    m0, outs0, _ = _traced_steps(route)
    m1, outs1, _ = _traced_steps(route, spans=HostSpans(timeline=True,
                                                        device=True))
    for (l0, c0), (l1, c1) in zip(outs0, outs1):
        assert torch.equal(l0, l1) and torch.equal(c0, c1)
    for p, q in zip(m0.parameters(), m1.parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_phases_in_order_one_step_id_no_overlap(route):
    spans = HostSpans(timeline=True)
    _, _, calls = _traced_steps(route, n_steps=3, spans=spans, first_step=7)
    steps = _by_step(spans.records)
    assert sorted(steps) == [7, 8, 9]
    want = ["prep"] + PER_VOLUME * ROUTES[route]["volumes"] + ["update"]
    for (t0, t1), sid in zip(calls, sorted(steps)):
        recs = steps[sid]
        assert [r.name for r in recs] == want
        assert len({r.thread for r in recs}) == 1
        assert t0 <= recs[0].start_ns and recs[-1].end_ns <= t1
        for a, b in zip(recs, recs[1:]):
            assert a.start_ns <= a.end_ns <= b.start_ns
        # the phases tile the call: what lies between them is the
        # recorder's own bookkeeping and the loop over the volumes
        covered = sum(r.end_ns - r.start_ns for r in recs)
        assert covered >= 0.9 * (t1 - t0), (covered, t1 - t0)
    assert spans.calls == {k: 3 * want.count(k) for k in set(want)}
    assert all(v > 0 for v in spans.seconds.values())
    # no CUDA device: no events, no device times
    assert all(r.events is None for r in spans.records)
    assert spans.device_ms() == []


def test_intervals_are_the_marks_of_a_trace_read():
    spans = HostSpans(timeline=True)
    _traced_steps("fused", n_steps=2, spans=spans)
    marks = spans.intervals
    assert set(marks) == {"prep", "update", *PER_VOLUME}
    for name, iv in marks.items():
        assert iv == sorted(iv) and len(iv) == spans.calls[name]
        assert all(isinstance(s, int) and isinstance(e, int) and s <= e
                   for s, e in iv)
    # a device record before the second step's forward and one after it:
    # the gap between them lies in that forward, and is named so
    f0, f1 = marks["forward"][2]
    fake = [(f0 - 10, f0), (f1, f1 + 10)]
    prof = _FakeProfile(fake)
    out = bench_trace.read(prof, [], (f0 - 10, f1 + 10), marks)
    assert out["idle_gaps"][0][0] == "forward"
    assert out["idle_gaps"][0][1] == pytest.approx((f1 - f0) * 1e-9)


class _FakeProfile:
    """What ``benchmark.trace`` reads of a ``torch.profiler.profile``: its
    device records (name, start, duration)."""

    def __init__(self, intervals):
        from torch.autograd import DeviceType

        events = [SimpleNamespace(device_type=lambda: DeviceType.CUDA,
                                  activity_type=lambda: "kernel",
                                  start_ns=lambda s=s: s,
                                  duration_ns=lambda s=s, e=e: e - s,
                                  name=lambda: "k")
                  for s, e in intervals]
        results = SimpleNamespace(events=lambda: events)
        self.profiler = SimpleNamespace(kineto_results=results)


def test_concurrent_steps_keep_their_records_apart():
    spans = HostSpans(timeline=True)
    errors = []

    def run(route, first):
        try:
            _traced_steps(route, n_steps=3, spans=spans, first_step=first)
        except Exception as e:  # reported by the assertion below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=("fused", 0)),
                   threading.Thread(target=run, args=("nonfused", 100))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    steps = _by_step(spans.records)
    assert sorted(steps) == [0, 1, 2, 100, 101, 102]
    for sid, recs in steps.items():
        volumes = ROUTES["fused" if sid < 100 else "nonfused"]["volumes"]
        assert [r.name for r in recs] == (["prep"] + PER_VOLUME * volumes
                                          + ["update"])
        assert len({r.thread for r in recs}) == 1
        for a, b in zip(recs, recs[1:]):
            assert a.end_ns <= b.start_ns
    assert len({steps[0][0].thread, steps[100][0].thread}) == 2
    assert sum(spans.calls.values()) == len(spans.records)


def test_off_is_one_shared_noop_and_keeps_no_records():
    assert span(None, "forward", 3, torch.device("cpu")) is span(None, "x")
    with span(None, "x"):
        pass
    spans = HostSpans()
    _traced_steps("fused", n_steps=1, spans=spans)
    assert spans.records == [] and spans.intervals == {}
    assert spans.calls["forward"] == 2 and spans.calls["update"] == 1
