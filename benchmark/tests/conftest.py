"""Shared fixtures of the benchmark's own tests (run them with
``python -m pytest benchmark/tests -q`` from the repository root).

Tests that need the card carry the ``card`` marker and take the ``cuda``
fixture, which decides inside the test whether a card is present. The
others drive the harness on the CPU at a small size: the port's plain
versions in float32 (its fused path on the CPU), a 24³ volume, 8 initial
channels.
"""

import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {
    "config": {"init_channel_number": 8, "compute_dtype": "float32"},
    "traffic": {"volume": [24, 24, 24],
                "subjects": {"labels": 63, "folds_per_label": 1,
                             "points_per_fold": 40, "jitter": 0.04,
                             "anatomy_seed": 20221}},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda")


@pytest.fixture(scope="session", autouse=True)
def one_thread():
    import torch

    if int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")) > 1:
        torch.set_num_threads(1)


@pytest.fixture
def tiny():
    import copy

    return copy.deepcopy(TINY)
