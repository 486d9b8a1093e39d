"""The port's whole UNet3D forward against the JAX package's, on the CPU.

JAX runs ``UNet3D(pallas_blocks=True, compute_dtype=float32)`` (its fused
pipeline, Pallas in interpret mode); the port runs its fused pipeline in
f32 through the kernels' plain versions. The same parameters, perturbed
from a numpy seed as at test_pallas.py:226-232, are carried across with
``state_dict_from_jax_params``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unetsulc_tpu.io.mdsm import write_state_dict
from unetsulc_tpu.models.torch_interop import (
    params_from_state_dict,
    state_dict_from_params,
)
from unetsulc_tpu.models.unet3d import UNet3D as JaxUNet3D
from unetsulc_tpu_torch.models.interop import load_mdsm, state_dict_from_jax_params
from unetsulc_tpu_torch.models.unet3d import UNet3D
from torch_threads import torch_one_thread  # noqa: F401,E402

MODEL = dict(in_channels=1, out_channels=5, init_channel_number=8)


def _jax_params(num_conv, seed=7):
    """Flax params: the port's seeded init mapped to the flax tree, then
    every leaf perturbed off its init (zero-bias ReLU ties are measure-zero
    only away from the init, test_pallas.py:221-225)."""
    init = UNet3D(**MODEL, num_conv=num_conv, compute_dtype=torch.float32,
                  device="cpu").state_dict()
    params = params_from_state_dict({k: v.numpy() for k, v in init.items()})
    leaves, treedef = jax.tree_util.tree_flatten(params)
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(treedef, [
        (v + 0.03 * r.standard_normal(v.shape)).astype(np.float32)
        for v in leaves
    ])


def _port_model(num_conv, params):
    m = UNet3D(**MODEL, num_conv=num_conv, compute_dtype=torch.float32,
               device="cpu")
    m.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return m


@pytest.mark.parametrize("num_conv", [1, 2])
@torch.no_grad()
def test_unet_forward_matches_jax_fused(num_conv):
    """Train-mode logits rtol=1e-4, atol=2e-4 (the bar of test_pallas.py's
    Pallas-vs-XLA check); eval probabilities rtol=1e-4, atol=1e-5 against
    the softmax of JAX's logits (JAX's eval forward is the same forward
    plus that softmax: dropout is 0); the padded output, gathered at voxel
    coordinates, gives the same logits."""
    r = np.random.default_rng(0)
    x = (r.random((1, 9, 8, 10, 1)) < 0.1).astype(np.float32)
    params = _jax_params(num_conv)
    jm = JaxUNet3D(**MODEL, num_conv=num_conv, compute_dtype=jnp.float32,
                   pallas_blocks=True)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), train=True))

    m = _port_model(num_conv, params)
    xt = torch.from_numpy(x)
    got = m(xt, train=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-4)

    probs = m(xt, train=False).numpy()
    np.testing.assert_allclose(probs, np.asarray(jax.nn.softmax(want, -1)),
                               rtol=1e-4, atol=1e-5)

    padded = m(xt, train=False, apply_final_activation=False,
               padded_output=True)
    assert tuple(padded.shape) == (11, 10, 12, 5)
    c = np.nonzero(x[0, ..., 0] > 0)
    picked = padded[c[0] + 1, c[1] + 1, c[2] + 1].numpy()
    np.testing.assert_allclose(picked, want[0][c], rtol=1e-4, atol=2e-4)


@pytest.mark.parametrize("num_conv", [1, 2])
def test_jax_written_mdsm_loads_strict(tmp_path, num_conv):
    """An ``.mdsm`` the JAX package writes loads into the port's module with
    ``strict=True``, and equals the direct flax-params mapping exactly."""
    params = _jax_params(num_conv, seed=3)
    path = str(tmp_path / "m.mdsm")
    write_state_dict(state_dict_from_params(params), path)
    state = load_mdsm(path)
    m = UNet3D(**MODEL, num_conv=num_conv, compute_dtype=torch.float32,
               device="cpu")
    m.load_state_dict(state, strict=True)
    direct = state_dict_from_jax_params(params)
    assert state.keys() == direct.keys() == m.state_dict().keys()
    for k, v in direct.items():
        torch.testing.assert_close(m.state_dict()[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("change,match", [
    (dict(dropout=0.1), "dropout"),
    (dict(conv_layer_order="cgr"), "conv_layer_order"),
    (dict(interpolate=False), "interpolate"),
    (dict(in_channels=9), "in_channels"),
])
def test_ineligible_models_raise(change, match):
    """What the fused pipeline cannot take (the flag ``match`` names) no
    longer raises: the model builds and routes to the non-fused path, as
    the JAX package falls back to its XLA path, and gives finite logits of
    the input's shape (tests/test_torch_nonfused.py holds them to JAX)."""
    kw = dict(MODEL, compute_dtype=torch.float32, device="cpu")
    kw.update(change)
    m = UNet3D(**kw)
    assert getattr(m, match) == change[match]
    x = torch.zeros((1, 8, 8, 8, m.in_channels))
    x[0, 2:5, 3:6, 1:4] = 1.0
    assert not m.fused_eligible(x)
    with torch.no_grad():
        out = m(x, train=False)
    assert tuple(out.shape) == (1, 8, 8, 8, 5)
    assert bool(torch.isfinite(out).all())


def test_ineligible_inputs_raise():
    """Inputs the fused pipeline cannot take (batch 2, an extent below 4)
    no longer raise: they route to the non-fused path; a wrong channel
    count still raises."""
    m = UNet3D(**MODEL, compute_dtype=torch.float32, device="cpu")
    for shape in ((2, 8, 8, 8, 1), (1, 8, 3, 8, 1)):
        x = torch.zeros(shape)
        assert not m.fused_eligible(x)
        with torch.no_grad():
            assert tuple(m(x).shape) == shape[:4] + (5,)
    with pytest.raises(ValueError, match="expected"):
        m(torch.zeros((1, 8, 8, 8, 2)))
