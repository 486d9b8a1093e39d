"""The operation and byte counts against sums by hand."""

import pytest

from benchmark import counts
from benchmark.models import unet3d as model


def conv(vox, cins, cout, entry=False, kind="conv", vox_out=None,
         param="p"):
    return dict(kind=kind, vox_in=vox, vox_out=vox_out or vox, cins=cins,
                cout=cout, taps=27 if kind != "head" else 1, entry=entry,
                param=param)


def test_layer_flops():
    assert counts.layer_flops(conv(10, [2], 3), 2) == 2 * 10 * 27 * 2 * 3
    # a transposed conv: every input voxel and tap
    t = conv(8, [4], 4, kind="convT", vox_out=64)
    assert counts.layer_flops(t, 4) == 2 * 8 * 27 * 4 * 4


def test_step_flops_by_trainable_set():
    layers = [conv(10, [1], 2, entry=True, param="a"),
              conv(10, [2, 3], 4, param="b"),
              conv(10, [4], 5, kind="head", param="final_conv")]
    f = [2 * 10 * 27 * 1 * 2, 2 * 10 * 27 * 5 * 4, 2 * 10 * 1 * 4 * 5]
    # from scratch: the entry conv forward + dW, the others three passes
    assert counts.step_flops(layers, 1, None) == pytest.approx(
        2 * f[0] + 3 * f[1] + 3 * f[2])
    # the head alone: forwards, the head's dW, no dx
    assert counts.step_flops(layers, 2, ["final_conv"]) == pytest.approx(
        2 * (f[0] + f[1] + 2 * f[2]))


def test_conv_pass_bounds_by_hand():
    layer = conv(1000, [64], 64)
    f, d, w = counts.conv_pass_bounds(layer, 64, 1)
    flops = 2 * 1000 * 27 * 64 * 64
    act = 1000 * 64 * 2
    assert f == pytest.approx(max(flops / 989e12,
                                  (2 * act + 2 * 27 * 64 * 64) / 3.35e12))
    assert w == pytest.approx(max(flops / 989e12,
                                  (2 * act + 4 * 27 * 64 * 64) / 3.35e12))
    assert d == f


def test_gn_launch_bound_by_hand():
    n, s, c, g = 2, 1000, 64, 32
    big = n * s * c * 2
    assert counts.gn_launch_bound("gn_stats", n, s, c, g) == pytest.approx(
        max(3 * n * s * c / 67e12, (big + 2 * 4 * n * g) / 3.35e12))
    assert counts.gn_launch_bound("gn_bwd_dx", n, s, c, g) == pytest.approx(
        max(7 * n * s * c / 67e12, (3 * big + 4 * 4 * n * g + 4 * c)
            / 3.35e12))


def test_unet_forward_flops_at_96():
    cfg = {"init_channel_number": 64, "in_channels": 1, "out_channels": 63,
           "interpolate": True}
    layers = model.layers(cfg, (96, 96, 96))
    fwd = sum(counts.layer_flops(l, c) for l in layers for c in l["cins"])
    v = [96 ** 3, 49 ** 3, 25 ** 3, 13 ** 3]
    k = 2 * 27
    by_hand = (v[0] * k * (1 * 32 + 32 * 64) + v[1] * k * (64 * 64 + 64 * 128)
               + v[2] * k * (128 * 128 + 128 * 256)
               + v[3] * k * (256 * 256 + 256 * 512)
               + v[2] * k * (768 * 256 + 256 * 256)
               + v[1] * k * (384 * 128 + 128 * 128)
               + v[0] * k * (192 * 64 + 64 * 64) + v[0] * 2 * 64 * 63)
    assert fwd == pytest.approx(by_hand)
    cfg["interpolate"] = False
    t = [l for l in model.layers(cfg, (96, 96, 96)) if l["kind"] == "convT"]
    assert [(l["vox_in"], l["cins"], l["vox_out"]) for l in t] == [
        (13 ** 3, [512], 26 ** 3), (25 ** 3, [256], 50 ** 3),
        (49 ** 3, [128], 98 ** 3)]


def test_unet_norms():
    cfg = {"init_channel_number": 64}
    norms = model.norms(cfg, (96, 96, 96))
    assert len(norms) == 14
    assert [n["c"] for n in norms] == [32, 64, 64, 128, 128, 256, 256, 512,
                                       256, 256, 128, 128, 64, 64]
    assert all(n["groups"] == 32 for n in norms)
