"""``UNet3D(remat=True)`` (``tpu.remat``) on the CPU: every route gives the
same bits with and without it, the replay runs the blocks' kernels a
second time, dropout draws each mask once, and the gradients agree with the
JAX model's ``nn.remat`` ones.

The fused route runs the plain versions of kernels A-E (CPU tensors, f32)
at ``test_pallas.py::test_pallas_remat_grads_bit_exact``'s shape; the JAX
reference is its XLA path (``pallas_blocks=False``) under ``jax.jit``, as
in ``test_torch_train.py``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unetsulc_tpu.models.torch_interop import params_from_state_dict
from unetsulc_tpu.models.unet3d import UNet3D as JaxUNet3D
from unetsulc_tpu_torch.models.interop import state_dict_from_jax_params
from unetsulc_tpu_torch.models.unet3d import UNet3D
from unetsulc_tpu_torch.ops import conv_fused as cf
from unetsulc_tpu_torch.parallel import make_mesh, shard_x
from torch_threads import torch_one_thread  # noqa: F401,E402

MODEL = dict(in_channels=1, out_channels=5, init_channel_number=8)
CPU = torch.device("cpu")


def _model(remat, **kw):
    """The port's seeded init, perturbed off the ReLU ties of a zero bias
    (numpy seed 5), f32 on the CPU."""
    m = UNet3D(**{**MODEL, **kw}, compute_dtype=torch.float32, device="cpu",
               seed=0, remat=remat)
    r = np.random.default_rng(5)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(torch.from_numpy(
                (0.03 * r.standard_normal(tuple(p.shape))).astype(np.float32)))
    return m


def _inputs(shape, n=1, seed=5):
    """test_pallas.py:306-310's input and a cotangent of the logits."""
    r = np.random.default_rng(seed)
    x = (r.random((n, *shape, 1)) < 0.1).astype(np.float32)
    gy = r.standard_normal((n, *shape, MODEL["out_channels"])).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(gy)


def _grads(m, run, gy):
    """(logits, every parameter's gradient) of sum(run() * gy)."""
    m.zero_grad(set_to_none=True)
    out = run()
    if isinstance(out, list):
        out = torch.cat(out, 1)
    (out * gy).sum().backward()
    return out.detach(), {n: p.grad.clone() for n, p in m.named_parameters()}


def _assert_bit_equal(a, b):
    (oa, ga), (ob, gb) = a, b
    assert torch.equal(oa, ob)
    assert ga.keys() == gb.keys()
    for k in ga:
        assert torch.equal(ga[k], gb[k]), k


@pytest.fixture()
def dispatch_counts(monkeypatch):
    """Calls of kernel A's and B's dispatchers (their plain versions here;
    on the card each is one launch)."""
    counts = {"conv_fwd": 0, "pool_fwd": 0}
    for name in counts:
        fn = getattr(cf, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(cf, name, counted)
    return counts


def test_fused_remat_is_bit_equal_and_replays_a_and_b(dispatch_counts):
    """The fused route (test_pallas.py:302-317's shape and widths): logits
    and every gradient bit-equal with and without remat; the backward
    replays each block, so A and B run twice as often in a step."""
    x, gy = _inputs((9, 8, 10))
    runs, calls = [], []
    for remat in (False, True):
        m = _model(remat)
        assert m.fused_eligible(x)
        for k in dispatch_counts:
            dispatch_counts[k] = 0
        runs.append(_grads(m, lambda: m(x, train=True), gy))
        calls.append(dict(dispatch_counts))
    _assert_bit_equal(*runs)
    assert calls[0] == {"conv_fwd": 13, "pool_fwd": 3}
    assert calls[1] == {"conv_fwd": 26, "pool_fwd": 6}


def test_nonfused_remat_dropout_draws_each_mask_once():
    """The non-fused route with dropout 0.1 from one generator, at batch 2
    with the transposed-conv decoder: logits and gradients bit-equal with
    and without remat, and the generator ends in the same state (a block
    that drew its mask inside the checkpoint would draw it again in the
    backward, from a generator that checkpoint does not restore)."""
    x, gy = _inputs((9, 8, 10), n=2)
    runs, states = [], []
    for remat in (False, True):
        m = _model(remat, dropout=0.1, interpolate=False)
        assert not m.fused_eligible(x)
        gen = torch.Generator().manual_seed(11)
        runs.append(_grads(m, lambda: m(x, train=True, dropout_generator=gen),
                           gy))
        states.append(gen.get_state())
    _assert_bit_equal(*runs)
    assert torch.equal(states[0], states[1])


def test_remat_grads_match_jax_remat():
    """The port's remat gradients against the JAX model's ``nn.remat``
    ones (XLA path), each scaled by max(1, max |g|), rtol=atol=2e-4:
    test_torch_train.py's bar for the gradients without remat."""
    m = _model(True)
    x, gy = _inputs((9, 8, 10), seed=0)
    params = params_from_state_dict(
        {k: v.detach().numpy() for k, v in m.state_dict().items()})
    mx = JaxUNet3D(**MODEL, compute_dtype=jnp.float32, pallas_blocks=False,
                   remat=True)
    want = jax.jit(jax.grad(lambda p: jnp.sum(
        mx.apply({"params": p}, jnp.asarray(x.numpy()), train=True)
        * jnp.asarray(gy.numpy()))))(params)
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, want))
    _, got = _grads(m, lambda: m(x, train=True), gy)
    assert got.keys() == want.keys()
    for k, v in want.items():
        scale = max(1.0, float(v.abs().max()))
        np.testing.assert_allclose(got[k].numpy() / scale, v.numpy() / scale,
                                   rtol=2e-4, atol=2e-4, err_msg=k)


@pytest.mark.parametrize("route", ["forward_sp", "forward_sp_nonfused"])
def test_sharded_routes_remat_bit_equal(route):
    """One space-2 case of each sharded route: ``forward_sp`` at (32, 8,
    8) (level 2 sharded too) and ``forward_sp_nonfused`` at (12, 8, 8)
    with the transposed-conv decoder; logits and gradients bit-equal with
    and without remat."""
    mesh = make_mesh(space=2, devices=[CPU] * 2)
    fused = route == "forward_sp"
    shape = (32, 8, 8) if fused else (12, 8, 8)
    x, gy = _inputs(shape)
    runs = []
    for remat in (False, True):
        m = _model(remat) if fused else _model(remat, interpolate=False)
        xs = shard_x(x, mesh)
        runs.append(_grads(m, lambda: getattr(m, route)(
            xs, train=True, padded_output=False), gy))
    _assert_bit_equal(*runs)


def test_remat_replay_reads_the_calls_parameters():
    """Under ``torch.func.functional_call`` (a replica on another card)
    the replay in the backward reads the parameters handed to the call,
    not the module's own: gradients bit-equal to the same call without
    remat."""
    x, gy = _inputs((9, 8, 10))
    runs = []
    for remat in (False, True):
        m = _model(remat)
        given = {n: (2.0 * p.detach()).requires_grad_(True)
                 for n, p in m.named_parameters()}
        out = torch.func.functional_call(m, given, (x,), {"train": True})
        (out * gy).sum().backward()
        runs.append((out.detach(), {n: p.grad for n, p in given.items()}))
    _assert_bit_equal(*runs)


def test_parameters_json_remat_builds_a_remat_model(cohort_dir, tmp_path):
    """``tpu.remat: true`` in a parameters.json reaches the model through
    ``experiment.driver.build_method`` and ``method/base.py``."""
    from unetsulc_tpu_torch.config import Parameters
    from unetsulc_tpu_torch.experiment.driver import build_method

    with open(cohort_dir / "cohorts" / "cohort-Synth6_hemi-L.json") as f:
        graphs = [s["graph"] for s in json.load(f)["subjects"]][:2]
    path = tmp_path / "parameters.json"
    path.write_text(json.dumps({
        "working_path": str(tmp_path), "cohort_name": "Synth6", "hemi": "L",
        "cuda": -1, "dict_model": {"name": "R", "num_filter": 8},
        "tpu": {"compute_dtype": "float32", "remat": True}}))
    params = Parameters.from_file(str(path))
    assert params.tpu.remat
    method = build_method(params, graphs)
    method.load_network()
    assert method.model.remat
