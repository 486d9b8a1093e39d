"""The port's data-parallel steps on the CPU (f32): ``make_train_step_dp``
and ``make_eval_step_dp`` on a mesh of CPU data rows in one process
(``make_mesh(data=n, devices=[cpu] * n)``), the batch cut by
``shard_batch``.

References from the same perturbed parameters and batch:

* the JAX package's ``make_train_step_dp`` / ``make_eval_step_dp`` on two
  of its eight CPU devices, on its jitted XLA path (``pallas_blocks=False``;
  no whole-model gradient through interpret-mode Pallas), at the bars of
  ``tests/test_parallel.py:280-345``: |dloss| < 1e-5, counts equal,
  updated parameters rtol = atol = 2e-4;
* the port's own single-device steps on the whole batch: the fused path at
  one volume per row takes the very operations of the single-device step
  in the same order, so it is held bit for bit; the padded batch (3
  volumes on 2 rows, one all-background volume added), the non-fused
  route (one forward per row instead of one for the batch) and the
  (data 2, space 2) mesh (GroupNorm sums added per shard) at counts
  equal, loss rtol 1e-6, parameters rtol 1e-5 with atol 1e-6 of the
  tensor's max |p|: the batch is summed in another order, and a
  parameter near 0 (~1e-4) moves by that order's f32 roundings of its
  update (up to 3e-8 measured on one thread, ~2.6e-7 of max |p|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unetsulc_tpu.models.torch_interop import params_from_state_dict
from unetsulc_tpu.models.unet3d import UNet3D as JaxUNet3D
from unetsulc_tpu.models.unet3d import make_apply_fn
from unetsulc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from unetsulc_tpu.train import step as jax_step
from unetsulc_tpu_torch.parallel import (
    device_groups,
    make_mesh,
    shard_batch,
    shard_x,
)
from unetsulc_tpu_torch.models.unet3d import UNet3D
from unetsulc_tpu_torch.train.step import (
    TrainState,
    dropout_generator,
    make_eval_step,
    make_eval_step_dp,
    make_eval_step_sp,
    make_train_step,
    make_train_step_dp,
    make_train_step_sp,
)
from torch_threads import torch_one_thread  # noqa: F401,E402

CPU = torch.device("cpu")
LR = 0.05
CLASSES = 5
MODEL = dict(in_channels=1, out_channels=CLASSES, init_channel_number=8)


def _model(**kw):
    """The port's seed-0 init perturbed from numpy seed 5, off the ReLU
    ties of a zero-bias init (``tests/test_torch_sp_step.py``)."""
    m = UNet3D(**MODEL, compute_dtype=torch.float32, device="cpu", seed=0,
               **kw)
    r = np.random.default_rng(5)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(torch.from_numpy(
                (0.03 * r.standard_normal(tuple(p.shape))).astype(np.float32)))
    return m


def _batch(shape, n, seed=11, occupied=0.15):
    """``test_parallel.py``'s dp batch: sparse inputs, 10% labelled."""
    r = np.random.default_rng(seed)
    x = (r.random((n, *shape, 1)) < occupied).astype(np.float32)
    labels = np.where(r.random((n, *shape)) < 0.1,
                      r.integers(0, CLASSES, (n, *shape)), -1)
    return torch.from_numpy(x), torch.from_numpy(labels.astype(np.int64))


def _params_close(m, ref, rtol, atol_of_max):
    """Each parameter at ``rtol``, with an absolute floor of
    ``atol_of_max`` times the reference tensor's largest magnitude."""
    got = dict(m.named_parameters())
    for k, v in ref.named_parameters():
        want = v.detach().numpy()
        np.testing.assert_allclose(got[k].detach().numpy(), want, rtol=rtol,
                                   atol=atol_of_max * np.abs(want).max(),
                                   err_msg=k)


def _steps(m, mesh):
    return (TrainState.create(m, lr=LR), make_train_step_dp(m, CLASSES, mesh),
            make_eval_step_dp(m, CLASSES, mesh))


def test_dp_steps_match_jax():
    """One train step and one eval step at data 2 against JAX's dp steps
    on two of its CPU devices (``test_parallel.py:280-345``'s bars)."""
    x, labels = _batch((9, 8, 10), 2)
    m = _model()
    params = params_from_state_dict(
        {k: v.detach().numpy().copy() for k, v in m.state_dict().items()})
    mesh = make_mesh(data=2, devices=[CPU] * 2)
    state, train, evaluate = _steps(m, mesh)
    l_ev, c_ev = evaluate(*shard_batch(mesh, x, labels))
    loss, counts = train(state, *shard_batch(mesh, x, labels))

    jmodel = JaxUNet3D(**MODEL, compute_dtype=jnp.float32, pallas_blocks=False)
    apply_fn = make_apply_fn(jmodel)
    jmesh = jax_make_mesh(data=2, space=1, devices=jax.devices()[:2])
    xj = jnp.asarray(x.numpy())
    lj = jnp.asarray(labels.numpy().astype(np.int32))
    jl_ev, jc_ev = jax_step.make_eval_step_dp(apply_fn, CLASSES, jmesh)(
        params, xj, lj)
    js, jloss, jcounts = jax_step.make_train_step_dp(
        apply_fn, CLASSES, jmesh, donate=False)(
            jax_step.TrainState.create(params, lr=LR), xj, lj)

    assert abs(float(l_ev) - float(jl_ev)) < 1e-5
    np.testing.assert_array_equal(c_ev.numpy(), np.asarray(jc_ev))
    assert abs(float(loss) - float(jloss)) < 1e-5
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    want = params_from_state_dict({k: v.detach().numpy()
                                   for k, v in m.state_dict().items()})
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(js.trainable)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=2e-4)


def test_dp_step_is_the_single_device_step_bit_for_bit():
    """Fused path, one volume per row, both rows on the CPU: two train
    steps and an eval step give the single-device step's loss, counts and
    parameters exactly."""
    x, labels = _batch((9, 8, 10), 2)
    m1, m2 = _model(), _model()
    mesh = make_mesh(data=2, devices=[CPU] * 2)
    s1, t1, e1 = (TrainState.create(m1, lr=LR), make_train_step(m1, CLASSES),
                  make_eval_step(m1, CLASSES))
    s2, t2, e2 = _steps(m2, mesh)
    for _ in range(2):
        a, b = t1(s1, x, labels), t2(s2, *shard_batch(mesh, x, labels))
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for p, q in zip(m1.parameters(), m2.parameters()):
        assert torch.equal(p, q)
    a, b = e1(x, labels), e2(*shard_batch(mesh, x, labels))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _hold(single, dp, state1, state2, x1, l1, x2, l2, m1, m2):
    a, b = single(state1, x1, l1), dp(state2, x2, l2)
    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())
    np.testing.assert_allclose(float(b[0]), float(a[0]), rtol=1e-6)
    _params_close(m2, m1, rtol=1e-5, atol_of_max=1e-6)


def test_alloc_batch_padding_is_neutral():
    """Batch 3 on data 2: the batch padded to 4 with an all-background
    volume (``alloc_batch``), against the unpadded batch of 3 on one
    device."""
    x, labels = _batch((9, 8, 10), 3)
    xp = torch.cat([x, torch.zeros_like(x[:1])])
    lp = torch.cat([labels, torch.full_like(labels[:1], -1)])
    m1, m2 = _model(), _model()
    mesh = make_mesh(data=2, devices=[CPU] * 2)
    s2, t2, e2 = _steps(m2, mesh)
    _hold(make_train_step(m1, CLASSES), t2, TrainState.create(m1, lr=LR), s2,
          x, labels, *shard_batch(mesh, xp, lp), m1, m2)
    a, b = make_eval_step(m1, CLASSES)(x, labels), e2(*shard_batch(mesh, xp, lp))
    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())
    np.testing.assert_allclose(float(b[0]), float(a[0]), rtol=1e-6)


@pytest.mark.parametrize("kw", [{"interpolate": False}, {"fused_blocks": False}],
                         ids=["transposed_decoder", "fused_blocks_off"])
def test_nonfused_dp_step_matches_single_device(kw):
    """A model the fused pipeline does not take: the single-device step
    runs the batch of 4 in one forward, each dp row its 2 in one."""
    x, labels = _batch((8, 8, 8), 4)
    m1, m2 = _model(**kw), _model(**kw)
    assert not m1.fused_config()
    mesh = make_mesh(data=2, devices=[CPU] * 2)
    s2, t2, e2 = _steps(m2, mesh)
    _hold(make_train_step(m1, CLASSES), t2, TrainState.create(m1, lr=LR), s2,
          x, labels, *shard_batch(mesh, x, labels), m1, m2)
    a, b = make_eval_step(m1, CLASSES)(x, labels), e2(*shard_batch(mesh, x, labels))
    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())
    np.testing.assert_allclose(float(b[0]), float(a[0]), rtol=1e-6)


def test_dropout_masks_fixed_by_step_and_row():
    """With dropout each row draws from a generator fixed by (step, row):
    two runs from one state agree exactly, and the two rows' streams
    differ from each other and from the single-device step's."""
    x, labels = _batch((8, 8, 8), 1)
    x2, l2 = torch.cat([x, x]), torch.cat([labels, labels])
    mesh = make_mesh(data=2, devices=[CPU] * 2)
    runs = []
    for _ in range(2):
        m = _model(dropout=0.2)
        state, train, _ = _steps(m, mesh)
        loss, counts = train(state, *shard_batch(mesh, x2, l2))
        runs.append((loss, counts, [p.detach().clone() for p in m.parameters()]))
    (la, ca, pa), (lb, cb, pb) = runs
    assert torch.equal(la, lb) and torch.equal(ca, cb)
    assert all(torch.equal(p, q) for p, q in zip(pa, pb))
    draws = [torch.rand(64, generator=dropout_generator(0, 3, CPU, shard=k))
             for k in (None, 0, 1)]
    assert not any(torch.equal(draws[i], draws[j])
                   for i, j in ((0, 1), (0, 2), (1, 2)))


def test_dp_sp_step_matches_single_device():
    """data 2 x space 2 on four CPU shards: each row runs the sp slab
    forward on its volume, the rows' sums and gradients added on the home
    device. At (32, 8, 8) (level 2 sharded), one train step and one eval
    step against the space-2 sp step on the batch of 2, bit for bit (the
    same volumes through the same shards in the same order), and against
    the single-device fused step at the bars above: the sp step adds its
    GroupNorm sums per shard (ROADMAP.md §3), ~1e-7 relative, ~1e-5 a
    few layers down."""
    x, labels = _batch((32, 8, 8), 2, seed=3, occupied=0.1)
    m1, m2, m3 = _model(), _model(), _model()
    mesh = make_mesh(data=2, space=2, devices=[CPU] * 4)
    sp2 = make_mesh(space=2, devices=[CPU] * 2)
    xs, ls = shard_batch(mesh, x, labels)
    assert [len(r) for r in xs] == [2, 2]
    assert tuple(xs[1][0].shape) == (1, 16, 8, 8, 1)
    x2, l2 = shard_x(x, sp2), shard_x(labels, sp2)
    a = make_eval_step(m1, CLASSES)(x, labels)
    b = make_eval_step_sp(m2, CLASSES, sp2)(x2, l2)
    c = make_eval_step_sp(m3, CLASSES, mesh)(xs, ls)
    assert torch.equal(b[0], c[0]) and torch.equal(b[1], c[1])
    np.testing.assert_array_equal(a[1].numpy(), c[1].numpy())
    np.testing.assert_allclose(float(c[0]), float(a[0]), rtol=1e-6)
    a = make_train_step(m1, CLASSES)(TrainState.create(m1, lr=LR), x, labels)
    b = make_train_step_sp(m2, CLASSES, sp2)(TrainState.create(m2, lr=LR),
                                             x2, l2)
    c = make_train_step_sp(m3, CLASSES, mesh)(TrainState.create(m3, lr=LR),
                                              xs, ls)
    assert torch.equal(b[0], c[0]) and torch.equal(b[1], c[1])
    assert all(torch.equal(p, q) for p, q in zip(m2.parameters(),
                                                  m3.parameters()))
    np.testing.assert_array_equal(a[1].numpy(), c[1].numpy())
    np.testing.assert_allclose(float(c[0]), float(a[0]), rtol=1e-6)
    _params_close(m3, m1, rtol=1e-5, atol_of_max=1e-6)


def test_mesh_rows_groups_and_batches():
    """``make_mesh`` rows, ``data=0``, ``device_groups`` and
    ``shard_batch``'s placement and errors."""
    mesh = make_mesh(data=0, space=2, devices=[CPU] * 6)
    assert (mesh.data, mesh.space, mesh.home) == (3, 2, CPU)
    assert make_mesh(data=2, devices=[CPU] * 5).devices == (CPU, CPU)
    groups = device_groups(2, [CPU] * 4)
    assert groups == [(CPU, CPU), (CPU, CPU)]
    with pytest.raises(ValueError, match="must divide"):
        device_groups(3, [CPU] * 4)
    x = torch.arange(4 * 6).reshape(4, 6, 1)
    xs, ls = shard_batch(make_mesh(data=2, devices=[CPU] * 2), x, x[..., 0])
    assert [tuple(t.shape) for t in xs] == [(2, 6, 1)] * 2
    assert torch.equal(torch.cat(xs), x) and torch.equal(torch.cat(ls), x[..., 0])
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(make_mesh(data=3, devices=[CPU] * 3), x, x[..., 0])
    with pytest.raises(ValueError, match="space-only"):
        shard_x(x, make_mesh(data=2, devices=[CPU] * 2))


def test_replica_on_another_device_reads_weights_through_to():
    """A row on another device than the model's runs the model with its
    parameters read through ``.to(device)`` (``functional_call``): here
    ``cpu:0`` against the model's ``cpu``, the same memory, so the output
    and the gradients that autograd brings home equal the model's own."""
    from unetsulc_tpu_torch.train.step import _replica

    x, _ = _batch((8, 8, 8), 1)
    m = _model()
    other = torch.device("cpu", 0)
    assert other != m.device
    want = m(x, train=True)
    want.square().sum().backward()
    g_want = [p.grad.clone() for p in m.parameters()]
    m.zero_grad(set_to_none=True)
    got = _replica(m, other)(x, train=True)
    got.square().sum().backward()
    assert torch.equal(got, want)
    assert all(torch.equal(p.grad, g) for p, g in zip(m.parameters(), g_want))
