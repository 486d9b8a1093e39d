"""The port's matrix-unit probe (``unetsulc_tpu_torch/tools/mxu_probe.py``)
against the JAX probe's Pallas kernels, and its profiling helpers.

``scripts/mxu_probe.py`` runs its ``main()`` when imported, so the test
parses it with ``ast`` and keeps only its three ``*_kernel`` functions and
their ``time_*`` launchers, run with the script's own specs through
``pl.pallas_call(..., interpret=True)`` at small ``ps`` and ``reps``. Every
product is exact (0.5 * 0.5 in bf16) and every sum of these sizes is exact
in f32, so the plain versions must equal the JAX kernels exactly.
"""

import ast
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from torch.profiler import ProfilerActivity, profile

from unetsulc_tpu_torch import kernels
from unetsulc_tpu_torch.tools import mxu_probe
from unetsulc_tpu_torch.utils import profiling
from torch_threads import torch_one_thread  # noqa: F401,E402

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "mxu_probe.py"


class _InterpretPallas:
    """``pl`` with ``pallas_call`` in interpret mode."""

    pallas_call = staticmethod(functools.partial(pl.pallas_call, interpret=True))

    def __getattr__(self, name):
        return getattr(pl, name)


def _jax_probe(reps):
    """The script's ``time_dot``, ``time_rdot`` and ``time_build`` (and the
    kernels they launch) with ``REPS = reps``."""
    tree = ast.parse(SCRIPT.read_text())
    keep = [n for n in tree.body if isinstance(n, ast.FunctionDef)
            and (n.name.endswith("_kernel")
                 or n.name in ("time_dot", "time_rdot", "time_build"))]
    assert len(keep) == 6, [n.name for n in keep]
    ns = {"jax": jax, "jnp": jnp, "pl": _InterpretPallas(), "pltpu": pltpu,
          "functools": functools, "REPS": reps,
          "PS": None}  # the default plane size; every call passes ps
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(SCRIPT), "exec"),
         ns)
    return ns


@pytest.fixture(scope="module")
def jax_probe():
    return {reps: _jax_probe(reps) for reps in (2, 3)}


@pytest.mark.parametrize("ps,k,n,reps", [(64, 32, 16, 3), (96, 64, 128, 2),
                                         (200, 192, 64, 2)])
def test_dot_plain_matches_jax(jax_probe, ps, k, n, reps):
    want = np.asarray(jax_probe[reps]["time_dot"](k, n, ps=ps)())
    got = mxu_probe.mxu_dot_plain(k, n, ps, reps).numpy()
    np.testing.assert_array_equal(got, want)
    assert want[0, 0] == mxu_probe.dot_value(k, ps, reps)


@pytest.mark.parametrize("ps,m,n,reps", [(64, 16, 32, 3), (128, 64, 64, 2),
                                         (200, 32, 16, 2)])
def test_rdot_plain_matches_jax(jax_probe, ps, m, n, reps):
    want = np.asarray(jax_probe[reps]["time_rdot"](m, n, ps=ps)())
    got = mxu_probe.mxu_rdot_plain(m, n, ps, reps).numpy()
    np.testing.assert_array_equal(got, want)
    assert want[0, 0] == mxu_probe.rdot_value(m, n, ps, reps)


@pytest.mark.parametrize("ps,cs,copies,reps", [(64, 16, 3, 3), (128, 64, 1, 2),
                                               (96, 8, 9, 2)])
def test_build_plain_matches_jax(jax_probe, ps, cs, copies, reps):
    want = np.asarray(jax_probe[reps]["time_build"](cs, copies, ps=ps)())
    o, slab = mxu_probe.slab_build_plain(cs, copies, ps, reps, return_slab=True)
    np.testing.assert_array_equal(o.numpy(), want)
    # the fixed point the kernel relies on: bf16(0.25 * 1.0001) = 0.25
    assert slab.shape == (ps, copies * cs)
    assert bool((slab == 0.25).all())


def test_dispatchers_route_cpu_to_plain():
    np.testing.assert_array_equal(
        mxu_probe.mxu_dot(64, 64, 40, 2, device="cpu").numpy(),
        mxu_probe.mxu_dot_plain(64, 64, 40, 2).numpy())
    np.testing.assert_array_equal(
        mxu_probe.mxu_rdot(64, 64, 40, 2, device="cpu").numpy(),
        mxu_probe.mxu_rdot_plain(64, 64, 40, 2).numpy())
    o, slab = mxu_probe.slab_build(16, 2, 40, 2, device="cpu", return_slab=True)
    assert float(o) == 0.5 and slab.shape == (40, 32)


def test_probe_wrappers_refuse_cpu_and_bad_sizes():
    for call in (lambda: kernels.mxu_dot(64, 64, 40, 2, "cpu"),
                 lambda: kernels.mxu_rdot(64, 64, 40, 2, "cpu"),
                 lambda: kernels.slab_build(16, 2, 40, 2, "cpu")):
        with pytest.raises(ValueError, match="CUDA device"):
            call()
    for call in (lambda: kernels.mxu_dot(48, 64, 40, 2, "cuda"),
                 lambda: kernels.mxu_dot(64, 16, 40, 2, "cuda"),
                 lambda: kernels.mxu_rdot(64, 96, 40, 2, "cuda"),
                 lambda: kernels.slab_build(12, 2, 40, 2, "cuda"),
                 lambda: kernels.mxu_dot(64, 64, 40, -1, "cuda")):
        with pytest.raises(ValueError, match="must be"):
            call()


def test_probe_cli_on_cpu(capsys):
    rows = mxu_probe.main(["--device", "cpu", "--ps", "64", "--reps", "2"])
    out = capsys.readouterr().out
    assert [r["kind"] for r in rows] == (["dot"] * 11 + ["rdot"] * 6
                                         + ["build"] * 6)
    assert [tuple(r["dims"]) for r in rows[:11]] == mxu_probe.DOT_COMBOS
    assert all(r["us"] is None and r["library_us"] is None for r in rows)
    assert "not measured" in out and "197" not in out
    # the dot bound at 989 TFLOP/s: 2 * ps * K * N FLOP
    assert rows[0]["bound_us"] == pytest.approx(2 * 64 * 192 * 64 / 989e12 * 1e6)


@pytest.fixture()
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is usable")


def test_probe_cli_needs_cuda_by_default(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mxu_probe.main(["--ps", "64", "--reps", "1"])


def test_build_bound_formula():
    # 128 B per clock on each SM: (1 + copies) * ps * cs * 2 bytes
    us = mxu_probe.build_bound_us(128, 9, 10976, 1.98e9, 132)
    assert us == pytest.approx(10 * 10976 * 128 * 2 / (128 * 132 * 1.98e9) * 1e6)


def test_epoch_timer_and_trace():
    timer = profiling.EpochTimer()
    timer.add_batch(10)
    timer.add_batch(5)
    perf = timer.finish()
    assert perf["voxels"] == 15 and perf["voxels_per_sec"] > 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(8).sum()
    # a CPU-only run traced no device kernel
    assert profiling.summarize_trace(prof) == []
