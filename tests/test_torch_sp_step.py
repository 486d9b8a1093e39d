"""The port's spatial-parallel train and eval steps on the CPU (f32),
against the port's single-device fused step and the JAX package's
single-device step.

The port's ``make_train_step_sp`` runs the flagship's fused pipeline on X
slabs over a mesh of CPU shards in one process (``make_mesh(space=n,
devices=[cpu] * n)``), through the halo-mode plain versions. Two
references from the same state:

* the port's single-device fused step (``make_train_step``), over 3
  steps: losses rtol 1e-5, confusion counts equal, parameters rtol 1e-4
  and atol 1e-6, the bars of ``tests/test_parallel.py:420-423``;
* the JAX single-device step on its jitted XLA path
  (``pallas_blocks=False``), at ``tests/test_torch_train.py``'s bars
  (loss within 1e-5, counts equal, parameters rtol=atol=2e-4). No
  whole-model JAX gradient runs through interpret-mode Pallas: the chain
  closes through ``test_parallel.py``, which holds JAX's sp step against
  JAX's single-device step.

Shapes: space 4 at 16^3 (4-plane slabs; level 0 and the slab+E middle
sharded; shards of both the edge and the interior kind), and space 2 at
(32, 8, 8) (16-plane slabs, so level 2 is sharded too), as JAX's own deep
test does. At 32^3 a float difference of the order the shard-added
GroupNorm sums make (1e-7, growing to 1e-5 downstream) leaves about one
pre-activation per layer within reach of its ReLU gate, and one flipped
gate moves a weight gradient by ~1%: the 32^3 deep case is held for one
step, where the two gradients agree. Parameters are the port's seed-0 init
perturbed from numpy seed 5, off the ReLU ties of a zero-bias init.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unetsulc_tpu.models.torch_interop import params_from_state_dict
from unetsulc_tpu.models.unet3d import UNet3D as JaxUNet3D
from unetsulc_tpu.models.unet3d import make_apply_fn
from unetsulc_tpu.parallel.sp_pallas import sp_static_shapes_ok as jax_shapes_ok
from unetsulc_tpu.train import step as jax_step
from unetsulc_tpu_torch.models.interop import state_dict_from_jax_params
from unetsulc_tpu_torch.models.unet3d import UNet3D
from unetsulc_tpu_torch.parallel import make_mesh, shard_x
from unetsulc_tpu_torch.parallel import sp_fused as sp
from unetsulc_tpu_torch.parallel import sp_static_shapes_ok
from unetsulc_tpu_torch.train.step import (
    TrainState,
    make_eval_step,
    make_eval_step_sp,
    make_train_step,
    make_train_step_sp,
)
from torch_threads import torch_one_thread  # noqa: F401,E402

MODEL = dict(in_channels=1, out_channels=3, init_channel_number=8)
LR = 0.05
CPU = torch.device("cpu")


def _model(**kw):
    m = UNet3D(**MODEL, compute_dtype=torch.float32, device="cpu", seed=0, **kw)
    r = np.random.default_rng(5)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(torch.from_numpy(
                (0.03 * r.standard_normal(tuple(p.shape))).astype(np.float32)))
    return m


def _batch(shape, n=1, seed=3):
    """test_parallel.py's ``_sp_pallas_setup`` inputs and labels."""
    r = np.random.default_rng(seed)
    x = (r.random((n, *shape, 1)) < 0.1).astype(np.float32)
    labels = np.where(x[..., 0] > 0, r.integers(0, 3, (n, *shape)),
                      -1).astype(np.int64)
    return torch.from_numpy(x), torch.from_numpy(labels)


def _mesh(n):
    return make_mesh(space=n, devices=[CPU] * n)


def _close_params(m, ref, rtol, atol):
    got = dict(m.named_parameters())
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].detach().numpy(), v.detach().numpy(),
                                   rtol=rtol, atol=atol, err_msg=k)


@pytest.fixture()
def deep_calls(monkeypatch):
    """Counts the calls of the level 1 -> 2 sharded pool (deep sharding)."""
    calls = []
    fn = sp.sp_pool_local_mid

    def counted(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)

    monkeypatch.setattr(sp, "sp_pool_local_mid", counted)
    return calls


@pytest.mark.parametrize("n,shape,deep", [
    (4, (16, 16, 16), False), (2, (32, 8, 8), True)],
    ids=["space4_16cubed_mid", "space2_32x8x8_deep"])
def test_sp_steps_match_single_device_and_jax(n, shape, deep, deep_calls):
    """Three train steps and one eval step through ``make_train_step_sp``
    / ``make_eval_step_sp``, against the port's single-device steps and
    the JAX XLA steps from the same parameters (module docstring bars);
    the deep case runs the level-2 sharded pool, the other does not."""
    x, labels = _batch(shape)
    mesh = _mesh(n)
    xs, ls = shard_x(x, mesh), shard_x(labels, mesh)
    m1, m2 = _model(), _model()
    s1, s2 = TrainState.create(m1, lr=LR), TrainState.create(m2, lr=LR)
    step1, step2 = make_train_step(m1, 3), make_train_step_sp(m2, 3, mesh)
    # copies: the port's steps update its parameters in place
    params = params_from_state_dict(
        {k: v.detach().numpy().copy() for k, v in m1.state_dict().items()})
    jmodel = JaxUNet3D(**MODEL, compute_dtype=jnp.float32, pallas_blocks=False)
    jstate = jax_step.TrainState.create(params, lr=LR)
    jtrain = jax_step.make_train_step(make_apply_fn(jmodel), num_classes=3,
                                      donate=False)
    xj, lj = jnp.asarray(x.numpy()), jnp.asarray(labels.numpy().astype(np.int32))
    for _ in range(3):
        l1, c1 = step1(s1, x, labels)
        l2, c2 = step2(s2, xs, ls)
        jstate, jl, jc = jtrain(jstate, xj, lj)
        np.testing.assert_allclose(float(l2), float(l1), rtol=1e-5)
        assert torch.equal(c2, c1)
        assert abs(float(l2) - float(jl)) < 1e-5
        np.testing.assert_array_equal(c2.numpy(), np.asarray(jc))
    assert (len(deep_calls) > 0) == deep
    _close_params(m2, dict(m1.named_parameters()), rtol=1e-4, atol=1e-6)
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, jstate.params))
    _close_params(m2, want, rtol=2e-4, atol=2e-4)
    assert s2.step == 3

    el1, ec1 = make_eval_step(m1, 3)(x, labels)
    el2, ec2 = make_eval_step_sp(m2, 3, mesh)(xs, ls)
    jel, jec = jax_step.make_eval_step(make_apply_fn(jmodel), num_classes=3)(
        jstate.params, xj, lj)
    np.testing.assert_allclose(float(el2), float(el1), rtol=1e-5)
    assert torch.equal(ec2, ec1)
    assert abs(float(el2) - float(jel)) < 1e-5
    np.testing.assert_array_equal(ec2.numpy(), np.asarray(jec))


def test_sp_step_32cubed_deep_one_step():
    """Space 2 at 32^3 (deep sharding on: S = 16): one train step against
    the single-device step, at the bars above (module docstring: why one
    step)."""
    x, labels = _batch((32, 32, 32))
    mesh = _mesh(2)
    m1, m2 = _model(), _model()
    l1, c1 = make_train_step(m1, 3)(TrainState.create(m1, lr=LR), x, labels)
    l2, c2 = make_train_step_sp(m2, 3, mesh)(TrainState.create(m2, lr=LR),
                                              shard_x(x, mesh), shard_x(labels, mesh))
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-5)
    assert torch.equal(c2, c1)
    _close_params(m2, dict(m1.named_parameters()), rtol=1e-4, atol=1e-6)


def test_sp_step_scan_batch2():
    """A global batch of 2 on the space axis runs one volume at a time (as
    ``scan_batch`` does) to the exact batch mean: one step against the
    single-device step's batch of 2, at the bars above."""
    x, labels = _batch((16, 16, 16), n=2)
    mesh = _mesh(2)
    m1, m2 = _model(), _model()
    l1, c1 = make_train_step(m1, 3)(TrainState.create(m1, lr=LR), x, labels)
    l2, c2 = make_train_step_sp(m2, 3, mesh)(TrainState.create(m2, lr=LR),
                                              shard_x(x, mesh), shard_x(labels, mesh))
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-5)
    assert torch.equal(c2, c1)
    _close_params(m2, dict(m1.named_parameters()), rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def test_sp_static_shapes_ok_matches_jax():
    for n in range(1, 17):
        assert sp_static_shapes_ok(n) == jax_shapes_ok(n), n
    assert {n for n in range(1, 17) if sp_static_shapes_ok(n)} == {2, 4, 8}


@pytest.mark.parametrize("kw", [dict(dropout=0.1), dict(interpolate=False),
                                dict(conv_layer_order="cgr"),
                                dict(fused_blocks=False)],
                         ids=["dropout", "transposed", "cgr", "not_fused"])
def test_ineligible_sp_model_raises(kw):
    """A model the fused pipeline does not take raises ValueError in the
    sp step, as the JAX model does under ``sp_axis`` (unet3d.py:906-914),
    instead of running some other path."""
    m = UNet3D(**MODEL, compute_dtype=torch.float32, device="cpu", **kw)
    mesh = _mesh(2)
    x, labels = _batch((8, 8, 8))
    with pytest.raises(ValueError, match="fused pipeline"):
        make_train_step_sp(m, 3, mesh)(TrainState.create(m, lr=LR),
                                        shard_x(x, mesh), shard_x(labels, mesh))


def test_ineligible_slabs_raise():
    """Slabs the slab+E layout cannot split (odd S) and a batch of 2 per
    forward raise ValueError; slabs off their shard's device, or a count
    other than the mesh's, raise too."""
    m, mesh = _model(), _mesh(2)
    with pytest.raises(ValueError, match="fused pipeline"):
        m.forward_sp(shard_x(torch.zeros((1, 10, 8, 8, 1)), mesh))
    with pytest.raises(ValueError, match="fused pipeline"):
        m.forward_sp(shard_x(torch.zeros((2, 16, 8, 8, 1)), mesh))
    x, labels = _batch((8, 8, 8))
    xs, ls = shard_x(x, mesh), shard_x(labels, mesh)
    with pytest.raises(ValueError, match="slabs"):
        make_train_step_sp(m, 3, mesh)(TrainState.create(m, lr=LR), xs[:1],
                                       ls[:1])


def test_make_mesh_axes():
    """A (data, space) mesh takes data x space devices and raises
    ValueError with fewer; with no device list and fewer cards than shards
    it raises instead of placing shards on the CPU; a CPU list runs the
    shards there."""
    with pytest.raises(ValueError, match="takes 4 devices"):
        make_mesh(data=2, space=2, devices=[CPU] * 2)
    grid = make_mesh(data=2, space=2, devices=[CPU] * 4)
    assert (grid.data, grid.space) == (2, 2)
    assert grid.row(1).space == 2 and grid.row(1).data == 1
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="CUDA devices"):
            make_mesh(space=2)
    mesh = make_mesh(space=4, devices=[CPU] * 4)
    assert mesh.space == 4 and mesh.home == CPU
    slabs = shard_x(torch.arange(2 * 8).reshape(2, 8), mesh)
    assert [tuple(s.shape) for s in slabs] == [(2, 2)] * 4
    with pytest.raises(ValueError, match="does not split"):
        shard_x(torch.zeros((1, 6)), mesh)


def test_sp_model_state_dict_is_the_single_device_models():
    """The sp options change no parameter: a model built with them has the
    single-device model's state_dict, keys and values, and loads it with
    strict=True."""
    a = UNet3D(**MODEL, compute_dtype=torch.float32, device="cpu", seed=0)
    b = UNet3D(**MODEL, compute_dtype=torch.float32, device="cpu", seed=1,
               sp_shard_middle=False, sp_shard_deep=False)
    b.load_state_dict(a.state_dict(), strict=True)
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


@pytest.mark.parametrize("middle,deep", [(False, False), (True, False),
                                         (True, True)],
                         ids=["replicated_middle", "sharded_middle", "deep"])
def test_sp_forward_layouts_match_single_device(middle, deep):
    """Each partition (the pooled level gathered and replicated, as
    ``sp_pool_gather`` leaves it; the slab+E middle; level 2 sharded too)
    gives the single-device forward's logits from one state, in eval mode,
    at space 2 and (32, 8, 8) (rtol=atol=1e-5)."""
    a = _model()
    b = _model(sp_shard_middle=middle, sp_shard_deep=deep)
    x, _ = _batch((32, 8, 8))
    with torch.no_grad():
        want = a(x, train=False, padded_output=False)
        got = torch.cat(b.forward_sp(shard_x(x, _mesh(2)), train=False), 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
