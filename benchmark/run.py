"""Run one cell of the benchmark once.

    python -m benchmark.run --workload <config>.<mix> --seed <n> \\
        --seconds <s> --trace <0|1>

The cell's traffic mix names its job (``jobs/<job>.py``), which does the
set-up (counted in ``setup_s``, printed in parts on an earlier line), the
measured window and the output check (:mod:`benchmark.harness`). With
``--trace 1`` the window runs under the profiler and the per-layer
metrics are reported instead of the end-to-end ones. The output check
runs once the program is freed. The last line of standard output is the
result, a JSON object; the last lines of standard error give each number
compared beside its limit.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import List, Optional  # noqa: E402

if __package__ in (None, ""):  # run as a file: the checkout's root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import check, registry  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "optax", "unetsulc_tpu")
CACHE = registry.REPO / "build" / "benchmark_cache"


def banned_modules() -> List[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (the port's own name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def fix_caches() -> None:
    """Every compiler cache at a fixed path inside the checkout (the
    port's kernels build into ``build/kernels/`` itself)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)


def open_run(workload: str, seed: int, device: str = "cuda",
             overrides: Optional[dict] = None, bench: Optional[dict] = None,
             root: Path = registry.ROOT, t0: Optional[float] = None):
    """The run of ``workload``: an instance of the ``Job`` of the job that
    its traffic mix names (an unknown job is refused). Set-up is counted
    from ``t0`` (``time.perf_counter()``; None: now)."""
    bench = bench or registry.benchmark()
    spec = registry.workload(bench, workload)
    job = registry.traffic(spec["traffic"], root).get("job")
    if not job:
        raise ValueError(f"traffic mix {spec['traffic']!r} names no job")
    cls = registry.job(job, root)
    return cls(workload, seed, device, overrides, bench, root, t0)


def card_line() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run(workload: str, seed: int, seconds: float, traced: bool,
        device: str = "cuda", overrides: Optional[dict] = None,
        chips: int = 1, bench: Optional[dict] = None,
        root: Path = registry.ROOT, t0: Optional[float] = None) -> dict:
    """One run; returns the result's object (without printing it)."""
    import torch

    r = open_run(workload, seed, device, overrides, bench, root, t0)
    r.setup()
    print(json.dumps({"setup_parts": r.parts, "setup_s": r.setup_s,
                      **r.info}), flush=True)
    r.window(seconds, traced)
    peak = max(r.setup_peak, r.peak_window)
    metrics = r.metrics(traced)
    result = {"correct": False, "attempted": r.attempted,
              "failed": r.failed, "metrics": metrics}
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": (torch.cuda.get_device_name(0)
                    if device.startswith("cuda") else "cpu"),
           "count": chips, "memory_peak_bytes": int(peak)}
    if traced and r.trace is not None:
        print(json.dumps({k: r.trace[k] for k in (
            "by_group", "by_class", "lead_s", "tail_s",
            "records_outside")}), flush=True)
        dev["busy_s"] = r.trace["busy_s"]
        dev["window_s"] = r.trace["window_s"]
        result["breakdown"] = {
            "device_ops": [list(v) for v in r.trace["device_ops"]],
            "idle_gaps": r.trace["idle_gaps"]}
    result["device"] = dev
    if device.startswith("cuda"):
        print(json.dumps({"card": card_line()}), flush=True)
    r.free_program()
    t_check = time.perf_counter()
    numbers = r.check()
    lim = r.limits
    result["correct"] = check.judge(numbers, lim) and r.failed == 0
    print(json.dumps({"check_s": time.perf_counter() - t_check,
                      "not_compared": {k: v for k, v in numbers.items()
                                       if k not in lim}}), flush=True)
    result["checks"] = {k: {"value": numbers.get(k), "limit": v}
                        for k, v in sorted(lim.items())}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    fix_caches()
    bench = registry.benchmark()
    chips = int(registry.workload(bench, args.workload)["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, "
              f"count: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 chips=chips, t0=_T0)
    found = banned_modules()
    if found:
        print("no result: JAX or the JAX package was loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
