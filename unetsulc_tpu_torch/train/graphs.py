"""CUDA-graph capture and replay of :func:`train.step.make_train_step`'s
step, so that the host's launches of a step (~1,200 on the fused route)
leave its critical path: a replay is a few graph launches and events.

When a call runs as graphs. On CUDA only, and not with dropout (the
step's masks come from a host-seeded generator): :func:`eager_reason`
names what keeps a call eager. Otherwise the call's key is its place
(the calling thread and its current stream), :func:`input_key` (the input
and label shapes, dtypes and device) and the state's signature
(:func:`state_signature`): the optimizer, each group's lr and momentum,
the trainable parameters and their momentum buffers by address, and each
frozen parameter by address and version. The first call with a key runs
eagerly, warming up what loads lazily (the kernels' libraries, cuDNN's
plans, the momentum buffers, per-shape caches); the second is captured
and replayed; every later one is replayed. A signature that changes
(``divide_lr``, ``reset_momentum`` and the eager step that makes the new
buffers, ``repartition``, a frozen weight loaded) forgets the state's
keys and drops its graphs, which can never match again; so do the keys
of a state that is gone. At most :data:`MAX_GRAPHS` keys hold graphs: a
key that comes once they are taken runs eagerly under ``full`` and is
never captured, so traffic of many shapes (``main.py``'s per-subject
shape buckets) costs no more than the eager step.

The capture. The step's own code runs once on a capture stream with
``capture_error_mode="thread_local"`` (fold threads capture too), its
recorders (``state.spans``, and ``model.spans`` where the model opens a
span of its own) replaced by a :class:`Recorder` that cuts one graph at
every edge of a span: one graph per phase (``prep``, per volume
``forward``, ``loss``, ``backward``, ``counts``, then ``update``), and
inside a phase one per nested span (Swin UNETR's ``swin_encoder``),
replayed in capture order. Autograd's backward runs on the forward's
stream, the capture's. The gradients are set to None before the capture,
so the replayed backward writes them whole, and SGD's step is captured
with them. Every trainable parameter's version is advanced before the
capture, so per-version caches of derived weights (``PackedWeight``) are
rebuilt inside the graphs. The graphs of every key of one place share
one memory pool: the place's replays run one whole step after another on
one stream, and each step writes every pooled tensor it reads before it
reads it, so the pool holds the largest step's temporaries once, not one
copy per key. The captures of the process take turns (one lock), and
each first hands the cached blocks of the eager steps back to the device
(``torch.cuda.empty_cache``, which may not run while any capture is
underway): a capture waits for the device. While one runs, no other thread
may wait for the whole device (``torch.cuda.synchronize``: CUDA refuses
it and the capture fails); the program's fold threads wait on their own
streams and events only.

The replay. Each call copies its inputs and labels into the entry's
static buffers (in ``prep``), replays the graphs inside the same spans
the eager step opens, on the step's recorder (``state.spans``; a nested
span too), so the phase metrics keep reading device time per phase,
while no recorder is active during a capture; and it returns clones
of the static loss and counts (in ``update``): a replay never overwrites
a result the caller still holds. It then advances the trainable
parameters' versions, as the eager update's in-place step does, points
their ``.grad`` at the replayed gradients, and adds the graphs' launches
(recorded at capture) to ``kernels.launch_counts``. A replay and a drop
do not wait for the device.

:class:`GraphCounts` (``TrainState.graphs``) logs how each of a state's
steps ran: ``replay``, ``capture`` or the eager reason. A capture that
fails leaves its key eager under the reason ``uncapturable``.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import warnings
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import torch

from unetsulc_tpu_torch import kernels
from unetsulc_tpu_torch.utils.profiling import span

# keys that hold graphs per step function: twice the shape buckets that
# an epoch of hemispheres at Talairach size visits at batch 1 (PERF.md §3)
MAX_GRAPHS = 4
# runs of the step log kept per state (a run: consecutive steps of one kind)
MAX_RUNS = 4096

REPLAY, CAPTURE = "replay", "capture"
_capture_lock = threading.Lock()  # one capture at a time in the process


class GraphCounts:
    """How a state's train steps ran, per step: ``replay``, ``capture`` or
    the eager reason, kept as runs of consecutive steps of one kind (the
    last :data:`MAX_RUNS`): :meth:`kinds` reads a range of steps."""

    def __init__(self):
        self._runs: collections.deque = collections.deque(maxlen=MAX_RUNS)

    def add(self, step: int, kind: str) -> None:
        last = self._runs[-1] if self._runs else None
        if last is not None and last[2] == kind and last[1] + 1 == step:
            last[1] = step
        else:
            self._runs.append([step, step, kind])

    def kinds(self, first: int, last: int) -> Optional[Dict[str, int]]:
        """{kind: steps} of steps ``first`` to ``last`` inclusive; None if
        the log no longer holds all of them."""
        out: Dict[str, int] = {}
        seen = 0
        for a, b, kind in self._runs:
            n = min(b, last) - max(a, first) + 1
            if n > 0:
                out[kind] = out.get(kind, 0) + n
                seen += n
        return out if seen == last - first + 1 else None


def eager_reason(state, model, inputs: torch.Tensor) -> Optional[str]:
    """Why a call runs eagerly: ``cpu``, ``dropout`` (host-seeded masks),
    ``momentum`` (a trainable parameter of a group with momentum has no
    buffer yet: the eager step makes it); None where it can run as
    graphs."""
    if inputs.device.type != "cuda":
        return "cpu"
    if model.dropout > 0:
        return "dropout"
    opt = state.optimizer
    need = sum(len(g["params"]) for g in opt.param_groups if g["momentum"])
    have = [s.get("momentum_buffer") for s in opt.state.values()]
    if len(have) < need or any(b is None for b in have):
        return "momentum"
    return None


def _trainable(opt) -> List[torch.Tensor]:
    return [p for group in opt.param_groups for p in group["params"]]


def frozen_parameters(state, model) -> List[torch.Tensor]:
    """The model's parameters that ``state``'s optimizer does not train."""
    trained = {id(p) for p in _trainable(state.optimizer)}
    return [p for p in model.parameters() if id(p) not in trained]


def state_signature(state, model,
                    frozen: Optional[List[torch.Tensor]] = None) -> tuple:
    """What a captured step bakes in of ``state`` and ``model``: the
    optimizer; each group's lr and momentum; the trainable parameters'
    addresses; each momentum buffer's address with its parameter; each
    frozen parameter's address and version (a derived cache of it is read
    by the graphs as it was at capture); and whether the model draws
    dropout. ``frozen``: :func:`frozen_parameters`, where the caller
    keeps it."""
    opt = state.optimizer
    if frozen is None:
        frozen = frozen_parameters(state, model)
    return (id(opt), model.dropout > 0,
            tuple((g["lr"], g["momentum"]) for g in opt.param_groups),
            tuple(p.data_ptr() for g in opt.param_groups
                  for p in g["params"]),
            tuple((id(p), s["momentum_buffer"].data_ptr())
                  for p, s in opt.state.items() if "momentum_buffer" in s),
            tuple((p.data_ptr(), p._version) for p in frozen))


def input_key(inputs: torch.Tensor, labels: torch.Tensor) -> tuple:
    return (tuple(inputs.shape), inputs.dtype, inputs.device,
            tuple(labels.shape), labels.dtype, labels.device)


def step_key(state, model, inputs: torch.Tensor, labels: torch.Tensor,
             frozen: Optional[List[torch.Tensor]] = None) -> tuple:
    """What a call's key holds beside its place: :func:`input_key` and
    :func:`state_signature`."""
    return input_key(inputs, labels), state_signature(state, model, frozen)


class _Node:
    """A span of the captured step: its name, whether it was opened with
    the step's number (a phase) or inherits it (a nested span), its
    device, and its items in order: graphs and nested spans."""

    __slots__ = ("name", "stepped", "device", "items")

    def __init__(self, name: str, stepped: bool, device):
        self.name, self.stepped, self.device = name, stepped, device
        self.items: list = []


def _new_graph():
    return torch.cuda.CUDAGraph()


def _new_anchor():
    """An external CUDA event, whose record inside a capture is a graph
    node of its own (no kernel)."""
    return torch.cuda.Event(external=True)


class Recorder:
    """One capture: the work launched on the capture stream cut into graphs,
    all in ``pool``. It stands in for the step's recorders while the
    capture runs (:func:`utils.profiling.span` opens
    ``recorder.span(name, step, device)``), so nothing is timed. The first
    span's entry begins the first graph: the body launches nothing before
    it (``make_train_step``'s ``prep``). Each span's entry cuts, and so
    does a nested span's exit, where the enclosing span's work goes on;
    work after a top-level span stays in its last graph. ``items`` is the
    step's script: graphs and :class:`_Node` s in order. Each graph opens
    with the record of an external event (``anchor``), so that none is
    empty: PyTorch warns of an empty capture, and a graph dropped from a
    shared pool would leave the pool's count of its graphs short."""

    def __init__(self, pool):
        self.pool = pool
        self.anchor = _new_anchor()
        self.items: list = []
        self._stack = [self.items]
        self._graph = None

    def begin(self) -> None:
        g = _new_graph()
        g.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        self._graph = g
        self._stack[-1].append(g)
        self.anchor.record()

    def end(self) -> None:
        g, self._graph = self._graph, None
        if g is not None:
            g.capture_end()

    def abort(self) -> None:
        """End a capture that failed, whatever its state."""
        with contextlib.suppress(Exception):
            self.end()

    @contextlib.contextmanager
    def span(self, name: str, step: Optional[int], device):
        self.end()
        node = _Node(name, step is not None, device)
        self._stack[-1].append(node)
        self._stack.append(node.items)
        self.begin()
        try:
            yield
        finally:
            self._stack.pop()
            if len(self._stack) > 1:
                # back in the enclosing span: its work goes on in a graph
                # of its own after the nested span's
                self.end()
                self.begin()


def play(items, spans, step: int, enter: Dict[str, Callable],
         leave: Dict[str, Callable]) -> None:
    """Replay a captured script: its graphs in order, each span reopened
    around its own (a phase with ``step``, a nested span inheriting it),
    with ``enter[name]()`` run first inside span ``name`` and
    ``leave[name]()`` last."""
    for it in items:
        if not isinstance(it, _Node):
            it.replay()
            continue
        with span(spans, it.name, step if it.stepped else None, it.device):
            if it.name in enter:
                enter[it.name]()
            play(it.items, spans, step, enter, leave)
            if it.name in leave:
                leave[it.name]()


class _Entry:
    """One key's graphs: the script and its anchor event, the pool, the
    static inputs and outputs, the trainable parameters with their
    replayed gradients, and the launches counted at capture. It holds the
    optimizer and the momentum buffers whose addresses the graphs bake
    in, so no other tensor takes them while it lives."""

    def __init__(self, pool, x: torch.Tensor, lb: torch.Tensor, opt,
                 params: List[torch.Tensor]):
        self.pool = pool
        self.x, self.lb = x, lb
        self.opt = opt
        self.params = params
        self.buffers = [s.get("momentum_buffer") for s in opt.state.values()]
        self.items: list = []
        self.anchor = None
        self.loss: Optional[torch.Tensor] = None
        self.counts: Optional[torch.Tensor] = None
        self.grads: List[Tuple[torch.Tensor, Optional[torch.Tensor]]] = []
        self.launches: Dict[str, int] = {}


def _advance(params: List[torch.Tensor]) -> None:
    """Mark each parameter as changed in place, as an eager in-place
    update would: caches keyed by the version counter are rebuilt."""
    torch.autograd.graph.increment_version(params)


_streams = threading.local()  # .stream: this thread's capture stream


def _capture_stream(device) -> torch.cuda.Stream:
    """This thread's capture stream on ``device``: one per thread, so fold
    threads never capture on one stream, and of high priority, so that
    none of the program's copy streams (of normal priority, from the
    other pool) is it."""
    s = getattr(_streams, "stream", None)
    if s is None or s.device != device:
        s = _streams.stream = torch.cuda.Stream(device, priority=-1)
    return s


def _place(device) -> tuple:
    """Where a call's replays run in order: its thread and current stream."""
    return threading.get_ident(), torch.cuda.current_stream(device).cuda_stream


FIRST, FULL, UNCAPTURABLE = "first", "full", "uncapturable"


class StepGraphs:
    """The graphs of one train step function. ``body(state, inputs,
    labels)`` is the step's eager code (its phases as spans); a call
    (:meth:`__call__`) runs it eagerly, or captures it, or replays it, as
    the module docstring says. ``keys`` maps each key to its state (a weak
    reference) and what it holds: an :class:`_Entry`, ``first`` (seen
    once) or ``uncapturable``."""

    def __init__(self, model, body: Callable):
        self.model = model
        self.body = body
        self.keys: Dict[tuple, list] = {}
        self._frozen: tuple = (None, [])  # (optimizer, its frozen params)

    def __call__(self, state, inputs: torch.Tensor, labels: torch.Tensor):
        log, sid = state.graphs, state.step
        kind = eager_reason(state, self.model, inputs)
        if kind is None:
            if self._frozen[0] is not state.optimizer:
                self._frozen = (state.optimizer,
                                frozen_parameters(state, self.model))
            sig = state_signature(state, self.model, self._frozen[1])
            self._prune(state, sig)
            place = _place(inputs.device)
            key = (place, input_key(inputs, labels), sig)
            held = self.keys.get(key, (None, None))[1]
            if isinstance(held, _Entry):
                log.add(sid, REPLAY)
                return self._replay(held, state, inputs, labels, True)
            if held is None:
                kind = FIRST
                self.keys[key] = [weakref.ref(state), FIRST]
            elif held == UNCAPTURABLE:
                kind = UNCAPTURABLE
            elif len(self._entries()) >= MAX_GRAPHS:
                kind = FULL
            else:
                entry = self._capture(state, inputs, labels, place)
                if entry is not None:
                    self.keys[key][1] = entry
                    log.add(sid, CAPTURE)
                    return self._replay(entry, state, inputs, labels, False)
                kind = self.keys[key][1] = UNCAPTURABLE
        log.add(sid, kind)
        return self.body(state, inputs, labels)

    def _entries(self) -> List[_Entry]:
        return [v for _, v in self.keys.values() if isinstance(v, _Entry)]

    def _prune(self, state, sig: tuple) -> None:
        """Forget the keys of a state that is gone, and ``state``'s keys of
        another signature: its lr, buffers, optimizer or frozen weights
        have changed since, for good. Their graphs go with them."""
        for key in [k for k, (ref, _) in self.keys.items()
                    if ref() is None or (ref() is state and k[2] != sig)]:
            del self.keys[key]

    def _capture(self, state, inputs, labels, place) -> Optional[_Entry]:
        """The step captured on a stream of its own into the pool of
        ``place`` (None if the capture fails: the step then runs eagerly,
        and its key stays so)."""
        stream = _capture_stream(inputs.device)
        # the place's pool, or a new one where it holds no graphs (a pool
        # whose graphs are all gone may not take another capture)
        pool = next((e.pool for k, (_, e) in self.keys.items()
                     if k[0] == place and isinstance(e, _Entry)), None)
        params = _trainable(state.optimizer)
        sid, spans = state.step, state.spans
        has_spans = hasattr(self.model, "spans")
        model_spans = self.model.spans if has_spans else None
        _advance(params)
        rec = None
        try:
            with _capture_lock:
                # the eager steps' cached blocks freed, so that the pool can
                # take their memory (as ``torch.cuda.graph`` does)
                torch.cuda.empty_cache()
                entry = _Entry(pool or torch.cuda.graph_pool_handle(),
                               torch.empty_like(inputs),
                               torch.empty_like(labels), state.optimizer,
                               params)
                rec = Recorder(entry.pool)
                state.spans = rec
                if has_spans:
                    self.model.spans = rec
                with torch.cuda.stream(stream), \
                        kernels.recording_launches(stream) as launches:
                    try:
                        entry.loss, entry.counts = self.body(state, entry.x,
                                                             entry.lb)
                    finally:
                        rec.end()
        except Exception as e:  # an operation that cannot be captured
            if rec is not None:
                rec.abort()
            warnings.warn(f"train step not captured, left eager: {e!r}")
            _advance(params)
            state.optimizer.zero_grad(set_to_none=True)
            return None
        finally:
            state.step, state.spans = sid, spans
            if has_spans:
                self.model.spans = model_spans
        entry.items, entry.anchor = rec.items, rec.anchor
        entry.grads = [(p, p.grad) for p in params]
        entry.launches = dict(launches)
        return entry

    def _replay(self, entry: _Entry, state, inputs, labels, count: bool):
        spans, sid = state.spans, state.step
        out = []

        def copy_in():
            entry.x.copy_(inputs)
            entry.lb.copy_(labels)

        def finish():
            out.append((entry.loss.clone(), entry.counts.clone()))
            state.step += 1

        play(entry.items, spans, sid, {"prep": copy_in}, {"update": finish})
        _advance(entry.params)
        for p, g in entry.grads:
            if p.grad is not g:
                p.grad = g
        if count:
            kernels.add_launches(entry.launches)
        return out[0]
