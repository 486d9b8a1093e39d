"""The train step's CUDA-graph machinery (``train/graphs.py``) where there is
no card: the CPU step never captures and gives the eager step's numbers;
the capture key (``step_key``, ``eager_reason``) changes on a new shape,
``divide_lr``, ``reset_momentum`` (eager once, then new buffers),
``repartition`` and dropout; a step's returned loss and counts outlive the
next step; the per-state log reads ranges of steps; a capture's script
(``Recorder`` over stand-in graphs) cuts at every span's edge, opens each
graph with its anchor, and replays in order inside the same spans;
``StepGraphs`` over stand-ins for the graphs, streams and pools: a key's
first call eager, the second captured, later ones replayed; no key
captured once ``MAX_GRAPHS`` hold graphs; a signature that changes, or a
state that is gone, frees its keys; one pool per place; a failed capture
stays eager; the recorders restored; and the launch counter's capture and
replay bookkeeping.

The graphs themselves run only on the card:
``tests/test_torch_step_graphs_card.py``. No JAX here.
"""

import contextlib
import gc
import types

import pytest
import torch

from torch_threads import torch_one_thread  # noqa: F401

from unetsulc_tpu_torch import kernels
from unetsulc_tpu_torch.models.unet3d import UNet3D
from unetsulc_tpu_torch.train import graphs
from unetsulc_tpu_torch.train.step import (TrainState, _match_labels,
                                           make_train_step)
from unetsulc_tpu_torch.utils.profiling import HostSpans, span

CLASSES = 5


def _model(**kw):
    return UNet3D(in_channels=1, out_channels=CLASSES, init_channel_number=8,
                  device="cpu", compute_dtype=torch.float32, seed=0, **kw)


def _batch(seed=0, n=1, e=12):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, e, e, e, 1), generator=g)
    lb = torch.randint(-1, CLASSES, (n, e, e, e), generator=g)
    return x, lb


def test_cpu_step_stays_eager_and_gives_the_eager_numbers():
    """Three CPU steps: every one eager under ``cpu``, none captured or
    replayed, and loss, counts and parameters those of the same forward,
    cross-entropy and SGD with momentum written out by hand."""
    m, ref = _model(), _model()
    state, step = TrainState.create(m, lr=0.05), make_train_step(m, CLASSES)
    opt = torch.optim.SGD(ref.parameters(), lr=0.05, momentum=0.9)
    for k in range(3):
        x, lb = _batch(k)
        loss, counts = step(state, x, lb)
        opt.zero_grad(set_to_none=True)
        logits = ref(x, train=True, padded_output=True)
        lbl = _match_labels(logits, lb, -1)
        valid = lbl != -1
        want = torch.nn.functional.cross_entropy(
            logits.reshape(-1, CLASSES)[valid.reshape(-1)],
            lbl[valid].long(), reduction="sum") / valid.sum()
        want.backward()
        opt.step()
        torch.testing.assert_close(loss, want.detach(), rtol=1e-5, atol=1e-6)
        assert int(counts[0].sum() + counts[2].sum()) == int((lb != -1).sum())
    for p, q in zip(m.parameters(), ref.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-4, atol=1e-6)
    assert state.graphs.kinds(0, 2) == {"cpu": 3}


def test_returned_results_outlive_the_next_step():
    m = _model()
    state, step = TrainState.create(m, lr=0.05), make_train_step(m, CLASSES)
    loss, counts = step(state, *_batch(0))
    held = (loss.clone(), counts.clone())
    step(state, *_batch(1))
    assert torch.equal(loss, held[0]) and torch.equal(counts, held[1])


def _cuda_like(x):
    """What ``eager_reason`` reads of a CUDA input, without a card."""
    return types.SimpleNamespace(device=torch.device("cuda"), shape=x.shape)


def test_eager_reasons():
    m = _model()
    state, step = TrainState.create(m, lr=0.05), make_train_step(m, CLASSES)
    x, lb = _batch()
    assert graphs.eager_reason(state, m, x) == "cpu"
    # no momentum buffer before the first step, every one after it
    assert graphs.eager_reason(state, m, _cuda_like(x)) == "momentum"
    step(state, x, lb)
    assert graphs.eager_reason(state, m, _cuda_like(x)) is None
    state.reset_momentum()
    assert graphs.eager_reason(state, m, _cuda_like(x)) == "momentum"
    d = _model(dropout=0.1)
    assert graphs.eager_reason(TrainState.create(d, 0.05), d,
                               _cuda_like(x)) == "dropout"


def test_no_momentum_needs_no_buffer():
    """SGD without momentum makes no buffer: such a state can run as
    graphs from its first step, and its key holds no buffer."""
    m = _model()
    state, step = TrainState.create(m, lr=0.05), make_train_step(
        m, CLASSES, momentum=0.0)
    x, lb = _batch()
    step(state, x, lb)
    assert not state.optimizer.state
    assert graphs.eager_reason(state, m, _cuda_like(x)) is None
    assert graphs.state_signature(state, m)[4] == ()


def _stepped():
    m = _model()
    state, step = TrainState.create(m, lr=0.05), make_train_step(m, CLASSES)
    x, lb = _batch()
    step(state, x, lb)
    return m, state, step, x, lb


def test_key_is_stable_between_steps():
    """A step changes the parameters in place: same addresses, so the key
    of the next call is the same."""
    m, state, step, x, lb = _stepped()
    k1 = graphs.step_key(state, m, x, lb)
    step(state, x, lb)
    assert graphs.step_key(state, m, x, lb) == k1


def test_key_changes_on_a_new_shape():
    m, state, _, x, lb = _stepped()
    x2, lb2 = _batch(e=16)
    assert graphs.step_key(state, m, x, lb) != graphs.step_key(
        state, m, x2, lb2)
    assert graphs.step_key(state, m, x, lb) != graphs.step_key(
        state, m, x, lb.int())


def test_key_changes_on_divide_lr():
    m, state, _, x, lb = _stepped()
    k1 = graphs.step_key(state, m, x, lb)
    state.divide_lr(10.0, reset_momentum=False)
    assert graphs.step_key(state, m, x, lb) != k1


def test_key_changes_on_momentum():
    m, state, _, x, lb = _stepped()
    k1 = graphs.step_key(state, m, x, lb)
    state.optimizer.param_groups[0]["momentum"] = 0.5
    assert graphs.step_key(state, m, x, lb) != k1


def test_reset_momentum_runs_eager_once_then_keys_anew():
    """After ``reset_momentum`` the next step is eager (no buffer) and
    makes new buffers; the key after it differs from the one before, even
    where a new buffer lands at an old one's address (the old buffers are
    kept alive here, as a graph entry keeps them)."""
    m, state, step, x, lb = _stepped()
    k1 = graphs.step_key(state, m, x, lb)
    old = [s["momentum_buffer"] for s in state.optimizer.state.values()]
    state.reset_momentum()
    assert graphs.eager_reason(state, m, _cuda_like(x)) == "momentum"
    step(state, x, lb)
    assert graphs.eager_reason(state, m, _cuda_like(x)) is None
    assert graphs.step_key(state, m, x, lb) != k1
    assert len(old) == len(state.optimizer.state)


def test_key_changes_on_repartition():
    m, state, step, x, lb = _stepped()
    k1 = graphs.step_key(state, m, x, lb)
    state.repartition(["final_conv"])
    step(state, x, lb)
    assert graphs.step_key(state, m, x, lb) != k1


def test_key_changes_on_a_frozen_weight_loaded():
    """A frozen parameter is part of the key by version: loading weights
    into it changes the key; a trainable one is read by the graphs where
    it lies, so only its address counts."""
    m, state, step, x, lb = _stepped()
    state.repartition(["final_conv"])
    step(state, x, lb)
    k1 = graphs.step_key(state, m, x, lb)
    with torch.no_grad():
        m.final_conv.weight.mul_(1.0)
    assert graphs.step_key(state, m, x, lb) == k1
    with torch.no_grad():
        m.encoders[0].double_conv.conv1.weight.mul_(1.0)
    assert graphs.step_key(state, m, x, lb) != k1


def test_key_changes_with_dropout():
    x, lb = _batch()
    m0, m1 = _model(), _model(dropout=0.1)
    s0, s1 = TrainState.create(m0, 0.05), TrainState.create(m1, 0.05)
    assert graphs.state_signature(s0, m0)[1] is False
    assert graphs.state_signature(s1, m1)[1] is True


def test_counts_log_ranges_of_steps():
    c = graphs.GraphCounts()
    for s, kind in enumerate(["momentum", "first", "capture"]
                             + ["replay"] * 5 + ["first"] + ["replay"] * 2):
        c.add(s, kind)
    assert c.kinds(3, 7) == {"replay": 5}
    assert c.kinds(6, 10) == {"replay": 4, "first": 1}
    assert c.kinds(0, 10) == {"momentum": 1, "first": 2, "capture": 1,
                              "replay": 7}
    assert c.kinds(5, 11) is None  # step 11 has not run


class _FakeGraph:
    """A stand-in for ``torch.cuda.CUDAGraph``: what ``_launch`` sends while
    it captures is its work; ``replay`` sends the work to ``ran``."""

    capturing = None
    ran: list = []

    def __init__(self):
        self.work, self.pool = [], None

    def capture_begin(self, pool=None, capture_error_mode="global"):
        assert capture_error_mode == "thread_local" and pool is not None
        assert _FakeGraph.capturing is None
        _FakeGraph.capturing, self.pool = self, pool

    def capture_end(self):
        assert _FakeGraph.capturing is self
        _FakeGraph.capturing = None

    def replay(self):
        _FakeGraph.ran.extend(self.work)


def _launch(op):
    """Work on the device: into the graph being captured, else run now."""
    g = _FakeGraph.capturing
    (g.work if g is not None else _FakeGraph.ran).append(op)


class _FakeAnchor:
    def record(self):
        _launch("anchor")


@pytest.fixture
def fakes(monkeypatch):
    """Stand-ins for what a capture takes from CUDA; pools numbered."""
    _FakeGraph.capturing, _FakeGraph.ran = None, []
    pools = iter(range(1000))
    monkeypatch.setattr(graphs, "_new_graph", _FakeGraph)
    monkeypatch.setattr(graphs, "_new_anchor", _FakeAnchor)
    monkeypatch.setattr(graphs, "_capture_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=99))
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                        lambda: ("pool", next(pools)))
    return _FakeGraph


def _body(spans):
    """A step's shape: phases with work, one phase holding a nested span
    first thing (as Swin UNETR's forward does)."""
    with span(spans, "prep", 7):
        _launch("zero")
    with span(spans, "forward", 7):
        with span(spans, "swin_encoder"):
            _launch("enc")
        _launch("dec")
    with span(spans, "update", 7):
        _launch("sgd")


def _record(body=_body):
    rec = graphs.Recorder("pool")
    try:
        body(rec)
    finally:
        rec.end()
    return rec


def test_recorder_cuts_a_graph_at_every_span_edge(fakes):
    """One graph a phase, and inside a phase one before, in and after each
    nested span, each opening with the anchor's record, so none is empty
    (the stretch before the nested span holds the anchor alone)."""
    rec = _record()
    assert [type(it).__name__ for it in rec.items] == ["_Node"] * 3
    assert [it.name for it in rec.items] == ["prep", "forward", "update"]
    prep, fwd, update = rec.items
    assert prep.stepped and [g.work for g in prep.items] == [["anchor",
                                                              "zero"]]
    assert fwd.stepped and [type(it).__name__ for it in fwd.items] == [
        "_FakeGraph", "_Node", "_FakeGraph"]
    enc = fwd.items[1]
    assert enc.name == "swin_encoder" and not enc.stepped
    assert fwd.items[0].work == ["anchor"]
    assert [g.work for g in enc.items] == [["anchor", "enc"]]
    assert fwd.items[2].work == ["anchor", "dec"]
    assert [g.work for g in update.items] == [["anchor", "sgd"]]
    assert fakes.capturing is None and fakes.ran == []


def test_work_after_a_phase_stays_in_its_graph(fakes):
    def body(rec):
        with span(rec, "loss", 0):
            _launch("ce")
        _launch("between")
        with span(rec, "backward", 0):
            _launch("bwd")

    rec = _record(body)
    assert [[g.work for g in n.items] for n in rec.items] == [
        [["anchor", "ce", "between"]], [["anchor", "bwd"]]]


def test_replay_runs_the_graphs_in_order_inside_their_spans(fakes):
    rec = _record()
    spans = HostSpans(timeline=True)
    seen = []
    graphs.play(rec.items, spans, 42, {"prep": lambda: seen.append("in")},
                {"update": lambda: seen.append("out")})
    ran = fakes.ran
    assert [op for op in ran if op != "anchor"] == ["zero", "enc", "dec",
                                                    "sgd"]
    assert ran.count("anchor") == 5
    assert seen == ["in", "out"]
    got = sorted((r.name, r.step) for r in spans.records)
    assert got == [("forward", 42), ("prep", 42), ("swin_encoder", 42),
                   ("update", 42)]


def test_abort_ends_a_failed_capture(fakes):
    rec = graphs.Recorder("pool")
    with pytest.raises(RuntimeError):
        with span(rec, "prep", 0):
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
    rec.abort()
    assert fakes.capturing is None


class _Model(torch.nn.Module):
    """A model with a span of its own (``spans``), as Swin UNETR has."""

    dropout = 0.0

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(3))
        self.spans = None


def _fake_step(state, x, lb):
    """A train step's phases on stand-in work: what the capture records, or
    what runs now where it does not; the spans are the state's and the
    model's, as the port's step opens them."""
    spans, sid = state.spans, state.step
    with span(spans, "prep", sid):
        _launch(("zero", tuple(x.shape)))
    with span(spans, "forward", sid):
        with span(state.model.spans, "encoder"):
            _launch("enc")
    with span(spans, "update", sid):
        _launch("sgd")
        state.step += 1
    return x.sum(), lb.sum()


def _fake_graphs(monkeypatch, fail=()):
    """A ``StepGraphs`` over :func:`_fake_step` that takes every call as a
    CUDA one (no momentum to wait for), with its places given by
    ``place[0]``, and shapes in ``fail`` that cannot be captured."""
    place = [("thread", 1)]
    monkeypatch.setattr(graphs, "eager_reason", lambda *a: None)
    monkeypatch.setattr(graphs, "_place", lambda d: place[0])
    monkeypatch.setattr(kernels, "recording_launches",
                        lambda s: contextlib.nullcontext({"conv3x3x3_fwd": 2}))
    sg = graphs.StepGraphs(None, None)

    def body(state, x, lb):
        if isinstance(state.spans, graphs.Recorder) and tuple(x.shape) in fail:
            with span(state.spans, "prep", state.step):
                raise RuntimeError("not permitted when stream is capturing")
        return _fake_step(state, x, lb)

    sg.body = body
    return sg, place


def _state(model, lr=0.05):
    return TrainState.create(model, lr=lr)


def _call(sg, state, n):
    sg.model = state.model
    return sg(state, torch.ones(1, n, n, n, 1), torch.zeros(1, n, n, n))


def test_step_graphs_first_capture_replay(fakes, monkeypatch):
    """First call eager, second captured and replayed at once, later ones
    replayed: the same work each time, the step count and results of the
    eager step, the recorders put back after the capture."""
    sg, _ = _fake_graphs(monkeypatch)
    m = _Model()
    state = _state(m)
    spans, own = HostSpans(timeline=True), HostSpans()
    state.spans, m.spans = spans, own
    out = [_call(sg, state, 4) for _ in range(4)]
    assert state.graphs.kinds(0, 3) is not None
    assert [state.graphs.kinds(s, s) for s in range(4)] == [
        {"first": 1}, {"capture": 1}, {"replay": 1}, {"replay": 1}]
    assert state.step == 4 and state.spans is spans and m.spans is own
    work = [op for op in fakes.ran if op != "anchor"]
    assert work == [("zero", (1, 4, 4, 4, 1)), "enc", "sgd"] * 4
    # each replay returns clones, never the graphs' own outputs
    entry = sg._entries()[0]
    assert float(out[0][0]) == 64.0
    assert not any(loss is entry.loss or c is entry.counts
                   for loss, c in out)
    # the capture's phases and the replays' were timed on the state's
    # recorder: none inside the capture
    steps = sorted(r.step for r in spans.records if r.name == "update")
    assert steps == [0, 1, 2, 3]
    # a replay reopens the nested span on the step's recorder
    assert own.calls == {"encoder": 1} and spans.calls["encoder"] == 3


def test_no_capture_once_the_graphs_are_taken(fakes, monkeypatch):
    """MAX_GRAPHS + 2 shapes in turn, four times: each shape's first call
    eager; the first MAX_GRAPHS shapes captured once and replayed after;
    the others eager under ``full`` every time, never captured."""
    sg, _ = _fake_graphs(monkeypatch)
    state = _state(_Model())
    shapes = [2 + k for k in range(graphs.MAX_GRAPHS + 2)]
    for _ in range(4):
        for n in shapes:
            _call(sg, state, n)
    k = len(shapes)
    log = [next(iter(state.graphs.kinds(s, s))) for s in range(4 * k)]
    held = graphs.MAX_GRAPHS
    assert log[:k] == ["first"] * k
    assert log[k:2 * k] == ["capture"] * held + ["full"] * (k - held)
    assert log[2 * k:] == (["replay"] * held + ["full"] * (k - held)) * 2
    assert len(sg._entries()) == held


def test_a_new_signature_frees_the_keys(fakes, monkeypatch):
    """``divide_lr`` changes the signature: the state's graphs go, and its
    shapes start over (first, then capture)."""
    sg, _ = _fake_graphs(monkeypatch)
    state = _state(_Model())
    for _ in range(3):
        _call(sg, state, 3)
    assert len(sg._entries()) == 1
    state.divide_lr(10.0)
    for _ in range(3):
        _call(sg, state, 3)
    assert [next(iter(state.graphs.kinds(s, s))) for s in range(6)] == [
        "first", "capture", "replay", "first", "capture", "replay"]
    assert len(sg.keys) == 1 and len(sg._entries()) == 1


def test_a_state_that_is_gone_frees_its_keys(fakes, monkeypatch):
    sg, _ = _fake_graphs(monkeypatch)
    m = _Model()
    a, b = _state(m), _state(m)
    for _ in range(2):
        _call(sg, a, 3)
        _call(sg, b, 3)
    assert len(sg._entries()) == 2
    del b
    gc.collect()
    _call(sg, a, 3)
    assert len(sg.keys) == 1 and len(sg._entries()) == 1


def test_one_pool_per_place(fakes, monkeypatch):
    """The graphs of one place share its pool; another place (thread or
    stream) takes its own; a place whose graphs are all gone takes a new
    one."""
    sg, place = _fake_graphs(monkeypatch)
    state = _state(_Model())
    for n in (2, 3):
        for _ in range(2):
            _call(sg, state, n)
    place[0] = ("thread", 2)
    for _ in range(2):
        _call(sg, state, 2)
    pools = {k[0] + (k[1][0],): v[1].pool for k, v in sg.keys.items()}
    assert pools == {("thread", 1, (1, 2, 2, 2, 1)): ("pool", 0),
                     ("thread", 1, (1, 3, 3, 3, 1)): ("pool", 0),
                     ("thread", 2, (1, 2, 2, 2, 1)): ("pool", 1)}
    state.divide_lr(10.0)
    place[0] = ("thread", 1)
    for _ in range(2):
        _call(sg, state, 2)
    assert [v[1].pool for v in sg.keys.values()] == [("pool", 2)]


def test_a_failed_capture_stays_eager(fakes, monkeypatch):
    """A shape whose capture raises runs eagerly from then on under
    ``uncapturable``, with a warning, the state's step count and recorders
    as before; other shapes still capture."""
    sg, _ = _fake_graphs(monkeypatch, fail={(1, 3, 3, 3, 1)})
    m = _Model()
    state = _state(m)
    _call(sg, state, 3)
    with pytest.warns(UserWarning, match="not captured"):
        _call(sg, state, 3)
    _call(sg, state, 3)
    assert state.step == 3 and state.spans is None and m.spans is None
    assert fakes.capturing is None
    for _ in range(3):
        _call(sg, state, 2)
    assert [next(iter(state.graphs.kinds(s, s))) for s in range(6)] == [
        "first", "uncapturable", "uncapturable", "first", "capture",
        "replay"]


def test_a_replay_counts_the_captured_launches(fakes, monkeypatch):
    sg, _ = _fake_graphs(monkeypatch)
    state = _state(_Model())
    kernels.reset_launch_counts()
    for _ in range(4):
        _call(sg, state, 2)
    # the capture's launches are counted by the wrappers as they run; each
    # of the two later replays adds them again
    assert kernels.launch_counts["conv3x3x3_fwd"] == 4
    kernels.reset_launch_counts()


def test_launch_recording(monkeypatch):
    """A launch on a recorded stream is counted there too; a replay adds a
    graph's launches back."""
    stream = types.SimpleNamespace(cuda_stream=1234)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: stream)
    kernels.reset_launch_counts()
    with kernels.recording_launches(stream) as rec:
        kernels._count("conv3x3x3_fwd")
        kernels._count("conv3x3x3_fwd")
    kernels._count("max_pool_buf_fwd")  # after the capture: not its own
    assert rec == {"conv3x3x3_fwd": 2}
    kernels.add_launches(rec)
    assert kernels.launch_counts["conv3x3x3_fwd"] == 4
    assert kernels.launch_counts["max_pool_buf_fwd"] == 1
    assert not kernels._recording
    kernels.reset_launch_counts()
