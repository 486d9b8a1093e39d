"""The port stands alone: no JAX, nothing of ``unetsulc_tpu``, and no
silent move to the CPU."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch_threads import torch_one_thread  # noqa: F401,E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "unetsulc_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|flax|optax)\b|from\s+(jax|flax|optax)\b"
    r"|import\s+unetsulc_tpu\b(?!_torch)|from\s+unetsulc_tpu\b(?!_torch))"
    r"|\bunetsulc_tpu\.",
    re.MULTILINE,
)


# the spatial-parallel modules, held to the rule by name as well
PARALLEL = ["unetsulc_tpu_torch.parallel", "unetsulc_tpu_torch.parallel.mesh",
            "unetsulc_tpu_torch.parallel.sp_fused"]


def test_port_imports_without_jax():
    """Importing every module of the port, the ``parallel`` package among
    them, loads neither jax/flax/optax nor any module of
    ``unetsulc_tpu``."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import unetsulc_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "print(json.dumps([sorted(m for m in sys.modules if m.split('.')[0]\n"
        "    in ('jax', 'flax', 'optax', 'unetsulc_tpu')),\n"
        "    sorted(m for m in sys.modules if m.startswith(p.__name__))]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    forbidden, port = json.loads(out.stdout.strip().splitlines()[-1])
    assert forbidden == []
    assert set(PARALLEL) <= set(port)


def test_source_scan_covers_parallel():
    """The source scan below reads the ``parallel`` package's files."""
    scanned = {str(p.relative_to(ROOT)) for p in SOURCES}
    assert {"unetsulc_tpu_torch/parallel/__init__.py",
            "unetsulc_tpu_torch/parallel/mesh.py",
            "unetsulc_tpu_torch/parallel/sp_fused.py"} <= scanned


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_jax(path):
    """No line of the port's sources or of chip_smoke.py imports JAX or
    names the JAX package's modules."""
    hits = [m.group(0) for m in FORBIDDEN.finditer(path.read_text())]
    assert hits == [], hits


@pytest.fixture()
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")


def test_model_defaults_to_cuda(no_cuda):
    from unetsulc_tpu_torch.models.unet3d import UNet3D

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        UNet3D(init_channel_number=8)


def test_labeller_defaults_to_cuda(no_cuda):
    from unetsulc_tpu_torch.method.base import SulciLabeller

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SulciLabeller([], "L", sulci_side_list=["a", "unknown"])


def test_cli_defaults_to_cuda(no_cuda, tmp_path):
    from unetsulc_tpu_torch import label

    params = tmp_path / "p_params.json"
    params.write_text(json.dumps({
        "dict_model": {"out_channels": 2, "init_channel_number": 8},
        "sulci_side_list": ["a", "unknown"],
    }))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        label.main(["-m", str(params), "-g", "none.npz", "-o", str(tmp_path)])
