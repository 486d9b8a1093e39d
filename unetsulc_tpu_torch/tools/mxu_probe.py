"""Matrix-unit probe: how far the bf16 ``wgmma`` path gets at each
contraction width, apart from its loads.

The counterpart of ``scripts/mxu_probe.py``. Kernels A, C and D
(``csrc/conv3x3x3_fwd.cu``, ``csrc/conv3x3x3_dx.cu``,
``csrc/conv3x3x3_wgrad.cu``) run their products as ``wgmma.mma_async``
with both operands in 128-byte-swizzled shared memory
(``csrc/wgmma.cuh``). This probe runs that instruction path alone, on
operands made once in shared memory in the conv kernels' layouts
(``csrc/mxu_probe.cu``), at the flagship's conv shapes (ps = 10976 rows,
one level-0 plane of the 96^3 volume), so its time per dot is the ceiling
of that path before any load or pipeline cost:

* ``mxu_dot``: (ps, K) @ (K, N) for the K/N pairs of the conv's forward
  and dx passes, both operands K-major, ``reps`` dots per launch;
* ``mxu_rdot``: the weight-gradient row contraction (ps, M)^T @ (ps, N),
  both operands MN-major;
* ``slab_build``: ``copies`` shifted stores of a (ps, cs) plane into a
  (ps, copies * cs) slab, the slab-build pattern, in shared memory.

Each kernel's plain PyTorch version is here too (``*_plain``): they loop
over ``reps`` and repeat the kernel's arithmetic (bf16 operands, f32
products and sums). The dispatchers (``mxu_dot``, ``mxu_rdot``,
``slab_build``) send a CPU device to the plain version and CUDA to the
kernel.

Run on the card (times per dot from the profiler's device trace, the bound
at 989 TFLOP/s bf16 and ``torch.matmul`` on the same bf16 operands from
device memory, which is not load-free, as the library column)::

    python -m unetsulc_tpu_torch.tools.mxu_probe [--ps 10976] [--reps 200]

``--device cpu`` runs the plain versions and checks the values; it
measures no time.
"""

from __future__ import annotations

import argparse
import subprocess
from typing import Callable, List, Optional, Sequence

import torch

from unetsulc_tpu_torch import kernels
from unetsulc_tpu_torch.device import resolve_device

PS = 10976  # level-0 plane rows of the 96^3 flagship (98 x 112)
REPS = 200
# the K/N pairs of the forward and dx passes, the M/N pairs of the weight
# gradient and the (cs, copies) slab builds (scripts/mxu_probe.py:133-166)
DOT_COMBOS = [
    (192, 64), (192, 128), (192, 192),
    (384, 128), (384, 192), (384, 384),
    (576, 128), (576, 192), (576, 384),
    (768, 128), (1152, 128),
]
RDOT_COMBOS = [(192, 192), (576, 192), (384, 128), (1152, 128), (192, 576),
               (64, 192)]
BUILD_COMBOS = [(cs, c) for cs in (64, 128) for c in (1, 3, 9)]
# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet, 700 W)
PEAK_BF16_FLOPS = 989e12
# shared memory: bytes per clock per SM
SMEM_BYTES_PER_CLOCK = 128


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _const(shape, value: float, device) -> torch.Tensor:
    return torch.full(shape, value, dtype=torch.bfloat16, device=device)


def mxu_dot_plain(k: int, n: int, ps: int, reps: int, device="cpu") -> torch.Tensor:
    """``reps`` times o[0, :] += column sums of a (ps, k) @ b (k, n), a and
    b bf16 0.5, in f32 (an f32 matmul on the card runs in full f32: TF32 is
    off for matmuls by default). o (8, n) f32."""
    a, b = _const((ps, k), 0.5, device), _const((k, n), 0.5, device)
    o = torch.zeros((8, n), dtype=torch.float32, device=device)
    for _ in range(reps):
        o[0] += (a.float() @ b.float()).sum(0)
    return o


def mxu_rdot_plain(m: int, n: int, ps: int, reps: int, device="cpu") -> torch.Tensor:
    """``reps`` times o[0, 0] += the sum of a^T @ b, a (ps, m) and b
    (ps, n) bf16 0.5, in f32: columns first, then rows. o (8, 128) f32."""
    a, b = _const((ps, m), 0.5, device), _const((ps, n), 0.5, device)
    o = torch.zeros((8, 128), dtype=torch.float32, device=device)
    for _ in range(reps):
        o[0, 0] += (a.float().t() @ b.float()).sum(1).sum()
    return o


def slab_build_plain(cs: int, copies: int, ps: int, reps: int, device="cpu",
                     return_slab: bool = False):
    """``reps`` slab builds of s (ps, copies * cs) bf16 from 0.25: norm =
    bf16(s[:, :cs] * 1.0001), s[1:, c*cs:(c+1)*cs] = norm[:-1] for each of
    the ``copies`` column blocks, o += norm[0, 0]. o (1, 1) f32, and with
    ``return_slab`` (o, s)."""
    s = _const((ps, copies * cs), 0.25, device)
    o = torch.zeros((1, 1), dtype=torch.float32, device=device)
    for _ in range(reps):
        norm = (s[:, :cs].float() * 1.0001).to(torch.bfloat16)
        for c in range(copies):
            s[1:, c * cs:(c + 1) * cs] = norm[:-1]
        o[0, 0] += norm[0, 0].float()
    return (o, s) if return_slab else o


# ---------------------------------------------------------------------------
# dispatchers: a CPU device -> plain version, CUDA -> kernel
# ---------------------------------------------------------------------------


def mxu_dot(k: int, n: int, ps: int, reps: int, device="cuda") -> torch.Tensor:
    dev = resolve_device(device)
    if dev.type == "cuda":
        return kernels.mxu_dot(k, n, ps, reps, dev)
    return mxu_dot_plain(k, n, ps, reps, dev)


def mxu_rdot(m: int, n: int, ps: int, reps: int, device="cuda") -> torch.Tensor:
    dev = resolve_device(device)
    if dev.type == "cuda":
        return kernels.mxu_rdot(m, n, ps, reps, dev)
    return mxu_rdot_plain(m, n, ps, reps, dev)


def slab_build(cs: int, copies: int, ps: int, reps: int, device="cuda",
               return_slab: bool = False):
    dev = resolve_device(device)
    if dev.type == "cuda":
        return kernels.slab_build(cs, copies, ps, reps, dev, return_slab)
    return slab_build_plain(cs, copies, ps, reps, dev, return_slab)


# ---------------------------------------------------------------------------
# what each launch should give, its work and its bound
# ---------------------------------------------------------------------------


def dot_value(k: int, ps: int, reps: int) -> float:
    """o[0, j] of ``mxu_dot``, in exact arithmetic."""
    return reps * ps * k * 0.25


def rdot_value(m: int, n: int, ps: int, reps: int) -> float:
    return reps * m * n * ps * 0.25


def build_value(reps: int) -> float:
    return reps * 0.25


def dot_flops(ps: int, k: int, n: int) -> float:
    """Operations of one dot (ps, k) @ (k, n) or one row contraction."""
    return 2.0 * ps * k * n


def dot_bound_us(ps: int, k: int, n: int) -> float:
    return dot_flops(ps, k, n) / PEAK_BF16_FLOPS * 1e6


def build_smem_bytes(cs: int, copies: int, ps: int) -> int:
    """Shared-memory bytes of one slab build: the plane's cs columns read
    once, ``copies`` column blocks written."""
    return (1 + copies) * ps * cs * 2


def build_bound_us(cs: int, copies: int, ps: int, sm_clock_hz: float,
                   sms: int) -> float:
    """One slab build's bytes at 128 bytes a clock on each SM."""
    return build_smem_bytes(cs, copies, ps) / (
        SMEM_BYTES_PER_CLOCK * sms * sm_clock_hz) * 1e6


def max_sm_clock_hz() -> Optional[float]:
    """The card's highest SM clock (``nvidia-smi clocks.max.sm``), or None
    where nvidia-smi does not answer."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60)
        return float(out.stdout.split()[0]) * 1e6
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


# ---------------------------------------------------------------------------
# timing: device time of one call from the profiler's trace
# ---------------------------------------------------------------------------


# torch.cuda._sleep's kernel, queued before a timed call (device_us)
SLEEP_KERNEL = "spin_kernel"
SLEEP_CYCLES = 10_000_000  # ~5 ms at 2 GHz


def device_us(fn: Callable[[], object], kernel: Optional[str] = None):
    """(result, device µs, timer) of one call of ``fn``: the summed time of
    the device kernels whose name holds ``kernel`` (all of the call's
    kernels when None) in ``torch.profiler``'s trace (timer "profiler").
    Where the trace holds no such kernel, the time between two CUDA events
    around the call (timer "events"), which also counts the output's zero
    fill: a device-side wait queued before them keeps the card busy while
    the host, slowed by the profiler, enqueues the call, so the events
    bracket the call's device work and not the host's."""
    from torch.profiler import ProfilerActivity, profile

    from unetsulc_tpu_torch.utils.profiling import summarize_trace

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
    rows = summarize_trace(prof, top=100000)
    us = sum(t for t, name in rows if SLEEP_KERNEL not in name
             and (kernel is None or kernel in name))
    if us:
        return out, us, "profiler"
    return out, start.elapsed_time(end) * 1e3, "events"


def _check(what: str, got: float, want: float) -> None:
    # f32 sums of exact products: exact at the probe's shapes, within a few
    # f32 roundings at any other
    if abs(got - want) > 1e-6 * abs(want):
        raise RuntimeError(f"{what}: {got!r}, expected {want!r}")


def _fmt(us: Optional[float], width: int = 7) -> str:
    return "not measured" if us is None else f"{us:{width}.2f} µs"


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    """Run every combination once, check its value and print the three
    tables; returns one row per launch (``kind``, its sizes, ``us`` per
    dot or build, ``bound_us``, ``library_us``; times None off the card)."""
    parser = argparse.ArgumentParser(
        description="Matrix-unit probe: wgmma efficiency against K, N")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (plain versions, no "
                             "times)")
    parser.add_argument("--ps", type=int, default=PS,
                        help="rows of the plane (default 10976)")
    parser.add_argument("--reps", type=int, default=REPS,
                        help="dots per launch (default 200)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    ps, reps = args.ps, args.reps
    on_card = dev.type == "cuda"
    if on_card:
        print(f"card: {torch.cuda.get_device_name(dev)}", flush=True)
    rows = []

    def timed(fn, kernel):
        if not on_card:
            return fn(), None
        out, us, timer = device_us(fn, kernel)
        if timer != "profiler":
            print(f"  ({kernel}: the profiler saw no device time; timed "
                  "with CUDA events)", flush=True)
        return out, us

    print(f"== dot timings (per dot, µs; bound at {PEAK_BF16_FLOPS / 1e12:.0f} "
          "TFLOP/s bf16; torch.matmul reads its operands from device memory "
          "and is not load-free) ==", flush=True)
    for k, n in DOT_COMBOS:
        o, us = timed(lambda: mxu_dot(k, n, ps, reps, dev), "mxu_dot_kernel")
        _check(f"mxu_dot K={k} N={n}", float(o[0, 0]), dot_value(k, ps, reps))
        if not (bool((o[0] == o[0, 0]).all()) and not o[1:].any()):
            raise RuntimeError(f"mxu_dot K={k} N={n}: uneven row 0 or "
                               "nonzero rows 1-7")
        lib = None
        if on_card:
            a, b = _const((ps, k), 0.5, dev), _const((k, n), 0.5, dev)
            _, lib, _ = device_us(lambda: torch.matmul(a, b))
        rows.append(_row("dot", (k, n), us, reps, dot_bound_us(ps, k, n), lib))
        r = rows[-1]
        eff = ("" if r["us"] is None
               else f"  eff {r['bound_us'] / r['us'] * 100:5.1f}%")
        print(f"K={k:5d} N={n:4d}: {_fmt(r['us'])}/dot  bound "
              f"{r['bound_us']:6.2f} µs{eff}  torch.matmul "
              f"{_fmt(r['library_us'])}", flush=True)

    print("== row-contraction (wgrad-style) dots ==", flush=True)
    for m, n in RDOT_COMBOS:
        o, us = timed(lambda: mxu_rdot(m, n, ps, reps, dev), "mxu_rdot_kernel")
        _check(f"mxu_rdot M={m} N={n}", float(o[0, 0]),
               rdot_value(m, n, ps, reps))
        if o.flatten()[1:].any():
            raise RuntimeError(f"mxu_rdot M={m} N={n}: nonzero o past [0, 0]")
        lib = None
        if on_card:
            a, b = _const((ps, m), 0.5, dev), _const((ps, n), 0.5, dev)
            _, lib, _ = device_us(lambda: torch.matmul(a.t(), b))
        rows.append(_row("rdot", (m, n), us, reps, dot_bound_us(ps, m, n), lib))
        r = rows[-1]
        eff = ("" if r["us"] is None
               else f"  eff {r['bound_us'] / r['us'] * 100:5.1f}%")
        print(f"M={m:5d} N={n:4d} (K=ps): {_fmt(r['us'])}/dot  bound "
              f"{r['bound_us']:6.2f} µs{eff}  torch.matmul "
              f"{_fmt(r['library_us'])}", flush=True)

    clock = max_sm_clock_hz() if on_card else None
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if on_card else None)
    print("== slab-build timings (per plane-build, µs; bound: shared-memory "
          f"bytes at {SMEM_BYTES_PER_CLOCK} B/clock on each of {sms} SMs at "
          f"{'?' if clock is None else f'{clock / 1e6:.0f} MHz'}) ==",
          flush=True)
    for cs, c in BUILD_COMBOS:
        o, us = timed(lambda: slab_build(cs, c, ps, reps, dev),
                      "slab_build_kernel")
        _check(f"slab_build cs={cs} copies={c}", float(o[0, 0]),
               build_value(reps))
        bound = (None if clock is None
                 else build_bound_us(cs, c, ps, clock, sms))
        rows.append(_row("build", (cs, c), us, reps, bound, None))
        r = rows[-1]
        print(f"cs={cs} copies={c}: {_fmt(r['us'])}  bound "
              f"{_fmt(r['bound_us'], 6)}", flush=True)
    return rows


def _row(kind, dims, us, reps, bound_us, library_us) -> dict:
    return {"kind": kind, "dims": list(dims),
            "us": None if us is None else us / max(reps, 1),
            "bound_us": bound_us, "library_us": library_us}


if __name__ == "__main__":
    main()
