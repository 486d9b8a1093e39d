"""The train step replayed from CUDA graphs (``train/graphs.py``) on the
card, against the eager step (``make_train_step(...).eager``, the same
code run call by call).

Five steps from the same weights, both ways, each step on a batch of its
own (the same sequence both ways; the subjects' labelled voxels differ in
number): step 0 runs eagerly for want of momentum buffers, step 1
eagerly as its key's first call, step 2 is captured and replayed, steps
3 and 4 are replays. Losses, confusion counts, every parameter and every
momentum buffer must be bit-equal (the port's kernels are
deterministic), each returned loss and counts must still hold what they
held when returned once later steps have run, and a replayed step must
add to ``kernels.launch_counts`` what an eager step launches. Routes: the
fused U-Net at 64³, transfer (the head alone trains), the non-fused U-Net
at batch 2, a small Swin UNETR; two fused models trained in two threads
at once, as ``tpu.fold_parallel`` trains folds, their captures started
together; and three shapes in turn with room for two keys' graphs, as
``main.py``'s per-subject buckets come, the graphs of both sharing one
pool.

The tests need a CUDA card and skip without one. This file imports no
JAX; on the machine with the card run it without the JAX set-up of
``tests/conftest.py``::

    python -m pytest tests/test_torch_step_graphs_card.py --noconftest -q
"""

import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_threads import torch_one_thread  # noqa: F401,E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from benchmark.data import make_subject  # noqa: E402

CLASSES = 63
SUBJECTS = {"labels": CLASSES, "folds_per_label": 2, "points_per_fold": 350,
            "jitter": 0.04, "anatomy_seed": 20221}
SEED = 2 ** 31 + 2323
STEPS = 5
KINDS = ["momentum", "first", "capture", "replay", "replay"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test needs one")
    return torch.device("cuda")


def _batch(dev, n, shape, first=0):
    pool = [make_subject(SUBJECTS, shape, SEED, first + i) for i in range(n)]
    x = torch.from_numpy(np.stack([s[0] for s in pool])).to(dev)
    return x, torch.from_numpy(np.stack([s[1] for s in pool])).to(dev)


def _batches(dev, n, shape, first=0):
    """STEPS batches of ``n`` subjects each, all distinct."""
    return [_batch(dev, n, shape, first + k * n) for k in range(STEPS)]


def _unet(dev, **kw):
    from unetsulc_tpu_torch.models.unet3d import UNet3D

    return UNet3D(in_channels=1, out_channels=CLASSES, device=dev, seed=3,
                  **kw)


def _swin(dev):
    from unetsulc_tpu_torch.models.swin_unetr import SwinUNETR

    return SwinUNETR(1, CLASSES, 24, device=dev, seed=3)


def _train(make_model, batches, graphed, training_layers=None,
           before=None):
    """One step a batch of ``batches`` on a fresh model: (per step loss,
    counts, a copy of each taken as it was returned, the launches of step
    3), the parameters and the momentum buffers after the last, and the
    state's step log. ``before(k)`` runs before step k."""
    from unetsulc_tpu_torch import kernels
    from unetsulc_tpu_torch.train.step import TrainState, make_train_step

    m = make_model()
    state = TrainState.create(m, lr=0.01, training_layers=training_layers)
    step = make_train_step(m, CLASSES, momentum=0.9)
    call = step if graphed else step.eager
    out, launches = [], None
    for k, (x, labels) in enumerate(batches):
        if before is not None:
            before(k)
        if k == 3:
            kernels.reset_launch_counts()
        loss, counts = call(state, x, labels)
        if k == 3:
            launches = {n: v for n, v in kernels.launch_counts.items() if v}
        out.append((loss, counts, loss.clone(), counts.clone()))
    # this thread's stream: a wait for the whole device is not allowed while
    # another thread captures
    torch.cuda.current_stream().synchronize()
    params = {n: p.detach().clone() for n, p in m.named_parameters()}
    bufs = {n: state.optimizer.state[p]["momentum_buffer"].clone()
            for n, p in m.named_parameters() if p in state.optimizer.state}
    return dict(out=out, launches=launches, params=params, bufs=bufs,
                kinds=[state.graphs.kinds(s, s)
                       for s in range(len(batches))])


def _check_equal(g, e, where, launches=True, kinds=KINDS):
    for k, ((lg, cg, lg0, cg0), (le, ce, _, _)) in enumerate(
            zip(g["out"], e["out"])):
        assert torch.equal(lg, lg0) and torch.equal(cg, cg0), (
            f"{where}: step {k}'s result changed after later steps")
        assert torch.equal(lg, le), f"{where}: loss of step {k} {lg} != {le}"
        assert torch.equal(cg, ce), f"{where}: counts of step {k} differ"
    assert g["params"].keys() == e["params"].keys()
    bad = [n for n in g["params"] if not torch.equal(g["params"][n],
                                                     e["params"][n])]
    assert not bad, f"{where}: parameters differ: {bad}"
    assert g["bufs"].keys() == e["bufs"].keys() and g["bufs"]
    bad = [n for n in g["bufs"] if not torch.equal(g["bufs"][n],
                                                   e["bufs"][n])]
    assert not bad, f"{where}: momentum buffers differ: {bad}"
    if launches:  # (threads side by side share the counter)
        assert g["launches"] == e["launches"], (g["launches"],
                                                e["launches"])
    assert [list(k) for k in g["kinds"]] == [[k] for k in kinds], g["kinds"]


CASES = {
    # name: (model, batch, extent, training_layers)
    "fused_64": (lambda d: _unet(d, init_channel_number=64), 1, 64, None),
    "transfer_64": (lambda d: _unet(d, init_channel_number=64), 1, 64,
                    ["final_conv"]),
    "fused_b2": (lambda d: _unet(d, init_channel_number=16), 2, 32, None),
    "nonfused_b2": (lambda d: _unet(d, init_channel_number=32,
                                    interpolate=False), 2, 48, None),
    "swin_b2": (_swin, 2, 64, None),
}


@pytest.mark.card
@pytest.mark.parametrize("case", list(CASES))
def test_graphed_step_is_the_eager_step(case, cuda):
    from unetsulc_tpu_torch import kernels

    make, n, e, layers = CASES[case]
    batches = _batches(cuda, n, (e, e, e))
    labelled = [int((lb != -1).sum()) for _, lb in batches]
    assert len(set(labelled)) == STEPS, labelled
    g = _train(lambda: make(cuda), batches, True, layers)
    ref = _train(lambda: make(cuda), batches, False, layers)
    _check_equal(g, ref, case)
    if case.startswith(("fused", "transfer")):
        assert g["launches"].get("conv3x3x3_fwd", 0) == 13 * n
    if case == "transfer_64":
        assert not any(k in g["launches"] for k in
                       ("conv3x3x3_dx", "conv3x3x3_wgrad", "max_pool_buf_bwd"))
    # a replay's host time beside an eager step's, with the queue empty
    from unetsulc_tpu_torch.train.step import TrainState, make_train_step

    m = make(cuda)
    state = TrainState.create(m, lr=0.01, training_layers=layers)
    step = make_train_step(m, CLASSES)
    ms, first = {}, None
    x, labels = batches[0]
    for name, call in (("eager", step.eager), ("graph", step)):
        first = state.step
        for _ in range(4):
            call(state, x, labels)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            call(state, x, labels)
            times.append(1e3 * (time.perf_counter() - t))
        ms[name] = sorted(times)[2]
    kernels.reset_launch_counts()
    print(f"{case}: host ms per step call with the queue empty: eager "
          f"{ms['eager']:.2f}, replay {ms['graph']:.2f}; "
          f"graphed calls {state.graphs.kinds(first, state.step - 1)}")


@pytest.mark.card
def test_two_threads_capture_and_replay_side_by_side(cuda):
    """Two fused models trained at once in two threads, as
    ``tpu.fold_parallel`` trains folds, both reaching their capture
    together (a barrier before step 2): each captures and replays its own
    graphs, and each ends bit-equal to its model trained eagerly alone."""
    barrier = threading.Barrier(2, timeout=120)
    data = {i: _batches(cuda, 1, (32, 32, 32), first=10 * i)
            for i in range(2)}

    def make(seed):
        from unetsulc_tpu_torch.models.unet3d import UNet3D

        return lambda: UNet3D(in_channels=1, out_channels=CLASSES,
                              init_channel_number=16, device=cuda, seed=seed)

    def meet(k):
        if k == 2:
            barrier.wait()

    got, errors = {}, []

    def fold(i):
        try:
            got[i] = _train(make(i), data[i], True, before=meet)
        except BaseException as e:  # surfaced below
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=fold, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for i in range(2):
        ref = _train(make(i), data[i], False)
        _check_equal(got[i], ref, f"thread {i}", launches=False)


@pytest.mark.card
def test_shapes_in_turn_share_a_pool(cuda, monkeypatch):
    """Three cubic shapes in turn, four rounds, with room for two keys'
    graphs (``MAX_GRAPHS`` 2): round 1 eager (momentum, then first calls);
    in round 2 the first shape's first call with its buffers, the other
    two captured; rounds 3 and 4 replay the two, whose graphs share one
    pool, after an eager step of the first (``full``); every step on a
    batch of its own. Bit-equal to the eager step throughout."""
    from unetsulc_tpu_torch.train import graphs

    monkeypatch.setattr(graphs, "MAX_GRAPHS", 2)
    sizes = (32, 48, 64)
    batches = [_batch(cuda, 1, (e, e, e), 4 * r + j)
               for r in range(4) for j, e in enumerate(sizes)]
    make = lambda: _unet(cuda, init_channel_number=16)  # noqa: E731
    g = _train(make, batches, True)
    ref = _train(make, batches, False)
    kinds = (["momentum", "first", "first"] + ["first", "capture", "capture"]
             + ["full", "replay", "replay"] * 2)
    _check_equal(g, ref, "shapes in turn", launches=False, kinds=kinds)
