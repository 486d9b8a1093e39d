"""The port's driver entry points (``unetsulc_tpu_torch/graft_entry.py``),
the counterparts of ``__graft_entry__.py``, on the CPU: the multichip dry
run on 2 and 4 CPU shards (every sharded route held to the single-device
step at the JAX function's bars, inside the function), and ``entry()``'s
forward at a tiny size; without CUDA, the default device raises."""

import pytest
import torch

from unetsulc_tpu_torch.graft_entry import dryrun_multichip, entry
from torch_threads import torch_one_thread  # noqa: F401,E402


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_cpu(n, capsys):
    dryrun_multichip(n, device="cpu")
    out = capsys.readouterr().out
    data = n // 2
    assert (f"dryrun_multichip OK: mesh=(data={data}, space=2), route "
            "sp_halo") in out
    for what in ("dp OK", "fused sp OK", "deep fused sp OK"):
        assert f"dryrun {what}" in out


def test_entry_forward_on_cpu():
    fn, args = entry(device="cpu", size=8)
    out = fn(*args)
    assert tuple(out.shape) == (1, 8, 8, 8, 63)
    assert bool(torch.isfinite(out).all())


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun_multichip(2)
