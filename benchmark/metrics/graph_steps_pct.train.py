"""The share of the window's train steps that ran as replays of CUDA
graphs, in %: of the steps numbered from the state's step count at the
window's start, the window's ``ctx["steps"]`` of them, those that the
port's per-state counts (``TrainState.graphs``, ``train/graphs.py``) log
as ``replay``. ``start`` keeps the counts and the first step; a program
whose state keeps no such counts gives nothing to read."""

NAME = "graph_steps_pct.train"


def start(run):
    counts = getattr(getattr(run, "state", None), "graphs", None)
    if counts is None or not hasattr(counts, "kinds"):
        return None
    return counts, run.state.step


def read(ctx):
    started = (ctx.get("started") or {}).get(NAME)
    n = ctx.get("steps") or 0
    if started is None or n <= 0:
        return None
    counts, first = started
    kinds = counts.kinds(first, first + n - 1)
    if kinds is None:
        return None
    return 100.0 * kinds.get("replay", 0) / n
