"""The readings that the output check's limits are set from, on the chip.

    python -m benchmark.readings --workload <name> --seeds 1 2 3 ... \\
        [--control-seeds 1 2 3] [--fault <name>] \\
        [--out readings.jsonl]

For each seed: the cell's set-up (its first steps through the program's
own step), then the numbers of :mod:`benchmark.check` of the program
against the plain reference, with each leaf's gaps and each step's counts
gap; for each control seed, the same of the control, the reference in
float8 in the program's place. With ``--fault``, the program's step runs
with that fault of :mod:`benchmark.faults` planted. One JSON line per reading. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import faults
from benchmark import run as run_mod


def readings(workload: str, seed: int, control: bool, device: str = "cuda",
             overrides=None, fault=None) -> dict:
    r = run_mod.open_run(workload, seed, device, overrides)
    undo = faults.plant(r.model_mod, fault) if fault else None
    try:
        r.setup()
    finally:
        if undo:
            undo()
    r.free_program()
    t = time.perf_counter()
    leaves, ctl_leaves = {}, {}
    out = {"workload": workload, "seed": seed, "fault": fault,
           "setup_s": r.setup_s, "program": r.check(detail=leaves)}
    out["reference_s"] = time.perf_counter() - t
    if control:
        out["control"] = r.check("fp8", ctl_leaves)
    out["detail"] = {"program": leaves, "control": ctl_leaves}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", choices=sorted(faults.FAULTS), default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run_mod.fix_caches()
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            line = json.dumps(readings(args.workload, seed,
                                       seed in args.control_seeds,
                                       fault=args.fault))
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    found = run_mod.banned_modules()
    if found:
        print("JAX or the JAX package was loaded: " + ", ".join(found),
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
