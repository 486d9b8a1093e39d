"""The port stands alone: no JAX, nothing of ``unetsulc_tpu`` (not even a
file of it read at run time), and no silent move to the CPU."""

import ast
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


# the parallel and native-runtime modules and the driver entry points,
# held to the rule by name as well
PARALLEL = ["unetsulc_tpu_torch.parallel", "unetsulc_tpu_torch.parallel.mesh",
            "unetsulc_tpu_torch.parallel.sp_fused",
            "unetsulc_tpu_torch.parallel.halo",
            "unetsulc_tpu_torch.runtime", "unetsulc_tpu_torch.graft_entry"]
# a path component naming the JAX package's directory
JAX_DIR = re.compile(r"(^|[/\\])unetsulc_tpu([/\\]|$)")
CITATION = re.compile(r"\.py:\d+$")


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
    """The source scan below reads the ``parallel`` and ``runtime``
    packages' files and the driver entry points."""
    scanned = {str(p.relative_to(ROOT)) for p in SOURCES}
    assert {"unetsulc_tpu_torch/parallel/__init__.py",
            "unetsulc_tpu_torch/parallel/mesh.py",
            "unetsulc_tpu_torch/parallel/sp_fused.py",
            "unetsulc_tpu_torch/parallel/halo.py",
            "unetsulc_tpu_torch/runtime/__init__.py",
            "unetsulc_tpu_torch/graft_entry.py"} <= scanned


def _code_strings(tree):
    """The string constants of a module that are not docstrings."""
    docs = set()
    for n in ast.walk(tree):
        if (isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef,
                           ast.AsyncFunctionDef)) and n.body
                and isinstance(n.body[0], ast.Expr)
                and isinstance(n.body[0].value, ast.Constant)):
            docs.add(id(n.body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_reads_no_jax_file(path):
    """No string of the port's code or of chip_smoke.py names a path in
    the JAX package's directory, except as a ``file.py:line`` citation
    (chip_smoke.py's ``replaces`` keys): the port reads none of its files,
    the C++ voxelizer's source included."""
    hits = [v for v in _code_strings(ast.parse(path.read_text()))
            if (JAX_DIR.search(v) or v.strip() == "unetsulc_tpu")
            and not CITATION.search(v)]
    assert hits == [], hits


def test_runtime_builds_its_own_source():
    """The native voxelizer compiles the port's copy of the C++ source."""
    from unetsulc_tpu_torch import runtime

    assert runtime.SRC == PORT / "runtime" / "voxelize.cpp"
    assert runtime.SRC.exists()


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
