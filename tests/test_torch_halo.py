"""The port's spatially sharded non-fused path on the CPU (f32):
``parallel/halo.py``'s sharded ops, the sharded GroupNorm and the sharded
non-fused train and eval steps (``make_train_step_sp_halo``), on meshes of
CPU shards in one process (``make_mesh(space=n, devices=[cpu] * n)``).

References, each made once per module from numpy seeds:

* ``conv3d_spatial`` against the JAX package's ``parallel.halo.
  conv3d_spatial`` under ``shard_map`` on 2 and 8 of conftest's CPU
  devices, at ``tests/test_parallel.py:44-45``'s rtol = atol = 2e-4;
* the GroupNorm plain sums and finalize modes and ``group_norm_sharded``
  (uneven shards, one of them empty), forward and backward, against JAX's
  ``group_norm`` on the whole volume: rtol 1e-5 with atol 1e-5 x the
  largest magnitude (f32 sums in another order);
* the sharded pool (ties included), transposed conv, resize and dropout,
  and the pair conv, against the port's single-device ops: bit-equal, the
  arithmetic of every output element being the same;
* the whole step at space 2 (X 16) and space 3 (X 12: levels of 12, 7, 4
  and 3 rows, split unevenly) against the JAX package's ``pjit_auto_spmd``
  step (``_cached_steps`` with ``spatial``, the plain step on a CPU mesh
  with ``batch_sharding`` and replicated parameters) at
  ``__graft_entry__.dryrun_multichip``'s bars: loss rtol 1e-5, counts
  equal, every parameter rtol 1e-4 / atol 1e-5. Parameters are the port's
  init perturbed from numpy seed 7, off the ReLU ties (ROADMAP.md §3);
* a dropout-0.1 step against the port's single-device step, which draws
  the same masks: counts equal, loss rtol 1e-6, parameters rtol 1e-5 with
  atol 1e-6 of the tensor's max |p| (``tests/test_torch_dp.py``'s bars:
  the GroupNorm sums are added per shard).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from unetsulc_tpu.method.training import _cached_steps
from unetsulc_tpu.models.torch_interop import params_from_state_dict
from unetsulc_tpu.models.unet3d import UNet3D as JaxUNet3D
from unetsulc_tpu.ops.groupnorm import group_norm as jax_group_norm
from unetsulc_tpu.parallel import halo as jax_halo
from unetsulc_tpu.parallel.mesh import batch_sharding, replicate
from unetsulc_tpu.train import step as jax_step
from unetsulc_tpu_torch.models import unet3d
from unetsulc_tpu_torch.models.interop import state_dict_from_jax_params
from unetsulc_tpu_torch.models.unet3d import UNet3D
from unetsulc_tpu_torch.ops import groupnorm as gn
from unetsulc_tpu_torch.parallel import halo, make_mesh, shard_x
from unetsulc_tpu_torch.train.step import (
    TrainState,
    make_eval_step_sp_halo,
    make_train_step,
    make_train_step_sp_halo,
)
from torch_threads import torch_one_thread  # noqa: F401,E402

CPU = torch.device("cpu")
CLASSES = 5
LR = 0.05
MODEL = dict(in_channels=1, out_channels=CLASSES, init_channel_number=8)


def _mesh(n):
    return make_mesh(space=n, devices=[CPU] * n)


def _split(t, sizes):
    """``t`` cut along X into pieces of ``sizes`` rows (an uneven level)."""
    return list(torch.split(t, sizes, dim=1))


# ---------------------------------------------------------------------------
# the halo conv against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 8])
def test_conv3d_spatial_matches_jax(n):
    r = np.random.default_rng(n)
    x = r.standard_normal((2, 16, 6, 5, 3)).astype(np.float32)
    w = (0.2 * r.standard_normal((4, 3, 3, 3, 3))).astype(np.float32)
    devs = np.array(jax.devices()[:n]).reshape(n)
    want = jax_halo.conv3d_spatial(
        jnp.asarray(x), jnp.asarray(w.transpose(2, 3, 4, 1, 0)),
        JaxMesh(devs, ("space",)))
    got = halo.conv3d_spatial(shard_x(torch.from_numpy(x), _mesh(n)),
                              torch.from_numpy(w), torch.zeros(4),
                              torch.float32)
    assert [tuple(t.shape) for t in got] == [(2, 16 // n, 6, 5, 4)] * n
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# the sharded GroupNorm
# ---------------------------------------------------------------------------


def _gn_case():
    r = np.random.default_rng(4)
    x = (3.0 + r.standard_normal((2, 7, 3, 4, 12))).astype(np.float32)
    g = r.standard_normal(x.shape).astype(np.float32)
    scale = (1 + 0.1 * r.standard_normal(12)).astype(np.float32)
    bias = (0.1 * r.standard_normal(12)).astype(np.float32)
    return x, g, scale, bias


def _close(a, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(a), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_gn_sums_and_finalize_plain_match_jax():
    """The sums mode over uneven shards, added in order and finalized over
    the global count, normalize as JAX's GroupNorm of the whole volume;
    on one slab the two modes are ``gn_stats_plain`` bit for bit."""
    x, _, scale, bias = _gn_case()
    xt = torch.from_numpy(x)
    parts = [gn.gn_sums_plain(t.reshape(2, -1, 12), 4)
             for t in _split(xt, [3, 4])]
    sums = [parts[0][i] + parts[1][i] for i in range(2)]
    mean, inv = gn.gn_finalize_plain(*sums, 7 * 3 * 4 * 3, 1e-5)
    out = gn.gn_apply_plain(xt.reshape(2, -1, 12), mean, inv,
                            torch.from_numpy(scale), torch.from_numpy(bias))
    want = jax_group_norm(jnp.asarray(x), 4, jnp.asarray(scale),
                          jnp.asarray(bias), use_pallas=False)
    _close(out.reshape(x.shape).numpy(), want)
    x3 = xt.reshape(2, -1, 12)
    one = gn.gn_finalize_plain(*gn.gn_sums_plain(x3, 4), 7 * 3 * 4 * 3, 1e-5)
    for a, b in zip(one, gn.gn_stats_plain(x3, 4, 1e-5)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("sizes", [[3, 4], [2, 0, 5]], ids=["2shards",
                                                           "3shards_empty"])
def test_group_norm_sharded_matches_jax(sizes):
    """Forward and backward of ``group_norm_sharded`` on uneven shards
    (an empty one included) against ``jax.vjp`` of JAX's GroupNorm on the
    whole volume; the empty shard takes no launch and gets a zero dx."""
    x, g, scale, bias = _gn_case()
    args = [jnp.asarray(v) for v in (x, scale, bias)]
    want, vjp = jax.vjp(
        lambda a, s, b: jax_group_norm(a, 4, s, b, use_pallas=False), *args)
    wdx, wds, wdb = vjp(jnp.asarray(g))
    xs = [t.clone().requires_grad_(True)
          for t in _split(torch.from_numpy(x), sizes)]
    sc = torch.from_numpy(scale).requires_grad_(True)
    bi = torch.from_numpy(bias).requires_grad_(True)
    outs = gn.group_norm_sharded(xs, 4, sc, bi, 1e-5)
    assert [o.shape[1] for o in outs] == sizes
    _close(torch.cat(outs, 1).detach().numpy(), want)
    torch.autograd.backward(outs, _split(torch.from_numpy(g), sizes))
    _close(torch.cat([t.grad for t in xs], 1).numpy(), wdx)
    _close(sc.grad.numpy(), wds)
    _close(bi.grad.numpy(), wdb)


# ---------------------------------------------------------------------------
# the other sharded ops against the single-device ops
# ---------------------------------------------------------------------------


def _level(seed, shape):
    r = np.random.default_rng(seed)
    return torch.from_numpy(r.standard_normal(shape).astype(np.float32))


def _grads_equal(single, sharded, x, sizes, out_sizes=None, exact=True):
    """Forward and input gradient of ``sharded`` on the pieces of ``x``
    equal to ``single``'s on x, for one random cotangent. Without
    ``exact`` the gradient of an input row that two shards read is their
    two parts added by autograd, in another order than the single-device
    backward's sum: rtol 1e-6, atol 1e-6 of its largest magnitude."""
    xa = x.clone().requires_grad_(True)
    xs = [t.clone().requires_grad_(True) for t in _split(x, sizes)]
    a = single(xa)
    outs = sharded(xs)
    if out_sizes is not None:
        assert [int(o.shape[1]) for o in outs] == out_sizes
    b = torch.cat(outs, 1)
    assert torch.equal(a, b)
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(
        tuple(a.shape)).astype(np.float32))
    a.backward(g)
    torch.autograd.backward(outs, _split(g, [int(o.shape[1]) for o in outs]))
    # a shard that holds no row the outputs read gets no gradient
    got = torch.cat([torch.zeros_like(t) if t.grad is None else t.grad
                     for t in xs], 1)
    if exact:
        assert torch.equal(xa.grad, got)
    else:
        want = xa.grad.numpy()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("sizes", [[8, 8], [4, 4, 4, 0], [1, 5, 6]],
                         ids=["2shards", "4shards_empty", "3shards_uneven"])
def test_max_pool_spatial_is_the_pool(sizes):
    """The pool's value and first-match routing on quantized data (ties
    within windows and across shard boundaries)."""
    x = torch.round(_level(2, (2, sum(sizes), 5, 6, 3)))
    d = sum(sizes) // 2 + 1
    _grads_equal(unet3d.max_pool_3d, halo.max_pool_3d_spatial, x, sizes,
                 [hi - lo for lo, hi in halo.level_rows(d, len(sizes))])


@pytest.mark.parametrize("skip", [12, 13, 7])
@pytest.mark.parametrize("n", [2, 3])
def test_upsample_transpose_spatial_is_the_upsample(skip, n):
    """The transposed-conv decoder's upsampling trimmed to the skip's
    extent and rows, from an unevenly split deeper level."""
    deep = skip // 2 + 1
    x = _level(3, (2, deep, 4, 3, 4))
    w, b = _level(5, (4, 4, 3, 3, 3)), _level(6, (4,))
    rows = halo.level_rows(skip, n)

    def single(v):
        up = unet3d.upsample_transpose(v, w, b, torch.float32)
        return up[:, :skip, :7, :5]

    def sharded(vs):
        return halo.upsample_transpose_spatial(vs, w, b, torch.float32, rows,
                                               [CPU] * n, (7, 5))

    _grads_equal(single, sharded, x,
                 [hi - lo for lo, hi in halo.level_rows(deep, n)],
                 [hi - lo for lo, hi in rows], exact=False)


@pytest.mark.parametrize("n", [2, 3])
def test_resize_spatial_is_the_resize(n):
    x = _level(7, (2, 7, 4, 3, 4))
    rows = halo.level_rows(12, n)
    _grads_equal(
        lambda v: unet3d.resize_trilinear(v, (12, 7, 6)),
        lambda vs: halo.resize_trilinear_spatial(vs, rows, [CPU] * n,
                                                 (12, 7, 6)),
        x, [hi - lo for lo, hi in halo.level_rows(7, n)],
        [hi - lo for lo, hi in rows], exact=False)


def test_pair_conv_and_dropout_spatial_are_the_single_device_ops():
    """A (skip, upsampled) pair conv on uneven shards, and dropout drawing
    the whole level's mask from the same generator."""
    skip, up = _level(8, (2, 7, 4, 5, 3)), _level(9, (2, 7, 4, 5, 2))
    w, b = _level(10, (4, 5, 3, 3, 3)), _level(11, (4,))
    want = unet3d.conv3x3x3((skip, up), w, b, torch.float32)
    got = halo.conv3d_spatial(list(zip(_split(skip, [2, 0, 5]),
                                       _split(up, [2, 0, 5]))),
                              w, b, torch.float32)
    assert torch.equal(torch.cat(got, 1), want)
    x = _level(12, (2, 7, 4, 5, 3))
    a = unet3d.dropout(x, 0.3, torch.Generator().manual_seed(4))
    bs = halo.dropout_spatial(_split(x, [3, 4]), 0.3,
                              torch.Generator().manual_seed(4))
    assert torch.equal(torch.cat(bs, 1), a)


def test_forward_sp_nonfused_rejects_bad_slabs():
    m = UNet3D(**MODEL, compute_dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="slab per shard"):
        m.forward_sp_nonfused([torch.zeros((1, 4, 8, 8, 1)),
                               torch.zeros((1, 4, 8, 7, 1))])
    with pytest.raises(ValueError, match="dropout_generator"):
        UNet3D(**MODEL, compute_dtype=torch.float32, device="cpu",
               dropout=0.1).forward_sp_nonfused([torch.zeros((1, 4, 8, 8, 1))])


# ---------------------------------------------------------------------------
# the whole step against JAX's pjit_auto_spmd step
# ---------------------------------------------------------------------------


def _params(kw, seed=7):
    init = UNet3D(**MODEL, compute_dtype=torch.float32, device="cpu",
                  **kw).state_dict()
    params = params_from_state_dict({k: v.numpy() for k, v in init.items()})
    leaves, treedef = jax.tree_util.tree_flatten(params)
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(treedef, [
        (v + 0.03 * r.standard_normal(v.shape)).astype(np.float32)
        for v in leaves])


def _batch(x_extent, n=2, seed=3):
    r = np.random.default_rng(seed)
    shape = (n, x_extent, 8, 8)
    x = (r.random((*shape, 1)) < 0.15).astype(np.float32)
    labels = np.where(r.random(shape) < 0.1, r.integers(0, CLASSES, shape),
                      -1).astype(np.int32)
    return x, labels


# (space, X extent, model options)
STEP_CASES = [(2, 16, dict(interpolate=False)),
              (3, 12, dict(conv_layer_order="cgr"))]
STEP_IDS = ["space2_transposed", "space3_cgr"]


@pytest.fixture(scope="module", params=STEP_CASES, ids=STEP_IDS)
def jax_spmd_step(request):
    """(case, params, batch, JAX's eval loss and counts, JAX's state,
    loss and counts after one train step) through ``_cached_steps``'
    ``pjit_auto_spmd`` route on ``space`` CPU devices."""
    space, extent, kw = request.param
    params = _params(kw)
    x, labels = _batch(extent)
    jmodel = JaxUNet3D(**MODEL, compute_dtype=jnp.float32, **kw)
    devices = tuple(jax.devices()[:space])
    train, evaluate, path = _cached_steps(jmodel, CLASSES, 0.9, dp=1,
                                          spatial=space, devices=devices)
    assert path["step"] == "pjit_auto_spmd" and path["sp_fallback"]
    from unetsulc_tpu.parallel.mesh import make_mesh as jax_make_mesh

    jmesh = jax_make_mesh(data=1, space=space, devices=devices)
    bs = batch_sharding(jmesh)
    xj, lj = jax.device_put(x, bs), jax.device_put(labels, bs)
    state = jax.device_put(jax_step.TrainState.create(params, lr=LR),
                           replicate(jmesh))
    with jmesh:
        ev = evaluate(state.params, xj, lj)
        state, loss, counts = train(state, xj, lj)
    return (request.param, params, (x, labels),
            jax.tree.map(np.asarray, ev),
            (jax.tree.map(np.asarray, state.params), float(loss),
             np.asarray(counts)))


def _port(params, kw):
    m = UNet3D(**MODEL, compute_dtype=torch.float32, device="cpu", **kw)
    m.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return m


def test_sharded_steps_match_jax_pjit(jax_spmd_step):
    (space, _, kw), params, (x, labels), (jl_ev, jc_ev), jtrain = \
        jax_spmd_step
    jparams, jloss, jcounts = jtrain
    m, mesh = _port(params, kw), _mesh(space)
    xs, ls = (shard_x(torch.from_numpy(v), mesh)
              for v in (x, labels.astype(np.int64)))
    l_ev, c_ev = make_eval_step_sp_halo(m, CLASSES, mesh)(xs, ls)
    np.testing.assert_allclose(float(l_ev), float(jl_ev), rtol=1e-5)
    np.testing.assert_array_equal(c_ev.numpy(), jc_ev)
    state = TrainState.create(m, lr=LR)
    loss, counts = make_train_step_sp_halo(m, CLASSES, mesh)(state, xs, ls)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    np.testing.assert_array_equal(counts.numpy(), jcounts)
    want = state_dict_from_jax_params(jparams)
    for k, p in m.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_dropout_step_is_the_single_device_step():
    """Dropout 0.1 at space 2: the sharded step draws the single-device
    step's masks (one generator per data row, the single-device stream on
    a one-row mesh), so one step equals it."""
    kw = dict(dropout=0.1, interpolate=False)
    params = _params(kw)
    x, labels = (torch.from_numpy(v) for v in _batch(16))
    labels = labels.long()
    m1, m2 = _port(params, kw), _port(params, kw)
    mesh = _mesh(2)
    a = make_train_step(m1, CLASSES)(TrainState.create(m1, lr=LR), x, labels)
    b = make_train_step_sp_halo(m2, CLASSES, mesh)(
        TrainState.create(m2, lr=LR), shard_x(x, mesh), shard_x(labels, mesh))
    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())
    np.testing.assert_allclose(float(b[0]), float(a[0]), rtol=1e-6)
    for (k, p), q in zip(m2.named_parameters(), m1.parameters()):
        want = q.detach().numpy()
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max(), err_msg=k)
