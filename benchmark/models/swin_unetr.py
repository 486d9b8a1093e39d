"""The program's side of Swin UNETR: the port's ``SwinUNETR`` built as
``method/base.py`` builds it (``dict_model.architecture: "swin_unetr"``),
the weights the benchmark made loaded into it, its ``TrainState`` and
``make_train_step`` (SGD with momentum); the first gradient as that
optimizer holds it; and the step's work from shapes: its convs for
:mod:`benchmark.counts`, its Linear layers and its window attention.

The port is imported inside the functions, so the test of the folder's
files and a directory without the port can import this module.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from benchmark import counts
# the optimizer and the freezing are the U-Net's: the same functions
from benchmark.models.unet3d import (  # noqa: F401
    DTYPES, first_gradient, trainable_names)


def build(cfg: dict, traffic: dict, weights: Dict[str, torch.Tensor],
          device):
    """(model, state, step) of the port on ``device``, the model's
    parameters set to ``weights``."""
    from unetsulc_tpu_torch.models import swin_unetr as swin
    from unetsulc_tpu_torch.train.step import TrainState, make_train_step

    fixed = {"depths": list(swin.DEPTHS), "num_heads": list(swin.NUM_HEADS),
             "window_size": swin.WINDOW, "patch_size": swin.PATCH,
             "mlp_ratio": swin.MLP_RATIO}
    if any(cfg[k] != v for k, v in fixed.items()):
        raise ValueError(f"the port's Swin UNETR has MONAI's {fixed}")
    model = swin.SwinUNETR(
        in_channels=int(cfg["in_channels"]),
        out_channels=int(cfg["out_channels"]),
        feature_size=int(cfg["feature_size"]),
        compute_dtype=DTYPES[cfg["compute_dtype"]],
        device=device,
    )
    names = [n for n, _ in model.named_parameters()]
    if sorted(names) != sorted(weights):
        raise ValueError("the port's parameters are not the reference's: "
                         f"{sorted(set(names) ^ set(weights))}")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[n])
    state = TrainState.create(model, float(cfg["lr"]),
                              traffic.get("training_layers"))
    step = make_train_step(model, int(cfg["out_channels"]),
                           momentum=float(cfg["momentum"]))
    return model, state, step


def route(model, x: torch.Tensor) -> str:
    """"swin": the model has one route, its batch in one forward."""
    return "swin"


def _vox(e) -> int:
    return int(e[0]) * int(e[1]) * int(e[2])


def _grids(cfg: dict, volume) -> List[List[int]]:
    """The token grid of each stage (the patch embedding's, then halved)."""
    p = int(cfg["patch_size"])
    g = [int(v) // p for v in volume]
    out = [g]
    for _ in range(4):
        out.append([-(-d // 2) for d in out[-1]])
    return out


def layers(cfg: dict, volume) -> List[dict]:
    """The convs and transposed convs of one volume (every one a cuDNN
    launch: the patch embedding, the residual blocks' 3^3 and 1x1 convs,
    the up-blocks' k2 s2 transposed convs, the 1x1 head), in the layer
    form of :mod:`benchmark.counts`; the patch embedding, ``encoder1``'s
    convs on the input and ``conv3`` of ``encoder1`` are entry layers."""
    f, cin = int(cfg["feature_size"]), int(cfg["in_channels"])
    p = int(cfg["patch_size"])
    g = _grids(cfg, volume)
    full = _vox(volume)
    out = [dict(kind="conv", vox_in=full, vox_out=_vox(g[0]), cins=[cin],
                cout=f, taps=p ** 3, entry=True,
                param="swinViT.patch_embed.proj")]

    def res(prefix, vox, a, b, entry=False):
        blk = [dict(kind="conv", vox_in=vox, vox_out=vox, cins=[a], cout=b,
                    taps=27, entry=entry, param=prefix + ".conv1"),
               dict(kind="conv", vox_in=vox, vox_out=vox, cins=[b], cout=b,
                    taps=27, entry=False, param=prefix + ".conv2")]
        if a != b:
            blk.append(dict(kind="conv", vox_in=vox, vox_out=vox, cins=[a],
                            cout=b, taps=1, entry=entry,
                            param=prefix + ".conv3"))
        return blk

    out += res("encoder1.layer", full, cin, f, entry=True)
    out += res("encoder2.layer", _vox(g[0]), f, f)
    out += res("encoder3.layer", _vox(g[1]), 2 * f, 2 * f)
    out += res("encoder4.layer", _vox(g[2]), 4 * f, 4 * f)
    out += res("encoder10.layer", _vox(g[4]), 16 * f, 16 * f)
    ups = [("decoder5", 3, 16 * f, 8 * f), ("decoder4", 2, 8 * f, 4 * f),
           ("decoder3", 1, 4 * f, 2 * f), ("decoder2", 0, 2 * f, f)]
    for name, lvl, a, b in ups:
        out.append(dict(kind="convT", vox_in=_vox(g[lvl + 1]),
                        vox_out=_vox(g[lvl]), cins=[a], cout=b, taps=8,
                        entry=False, param=name + ".transp_conv"))
        out += res(name + ".conv_block", _vox(g[lvl]), 2 * b, b)
    out.append(dict(kind="convT", vox_in=_vox(g[0]), vox_out=full, cins=[f],
                    cout=f, taps=8, entry=False,
                    param="decoder1.transp_conv"))
    out += res("decoder1.conv_block", full, 2 * f, f)
    out.append(dict(kind="conv", vox_in=full, vox_out=full, cins=[f],
                    cout=int(cfg["out_channels"]), taps=1, entry=False,
                    param="out"))
    return out


def attention_blocks(cfg: dict, volume) -> List[dict]:
    """Each Swin block of one volume: its ``param`` prefix, real tokens,
    padded tokens, width C, heads, window tokens N, windows and whether it
    rolls (the window is clipped to an axis no longer than it, which then
    takes no shift)."""
    f, w = int(cfg["feature_size"]), int(cfg["window_size"])
    out = []
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        grid = _grids(cfg, volume)[i]
        ws = [min(w, d) for d in grid]
        padded = [-(-d // s) * s for d, s in zip(grid, ws)]
        n = _vox(ws)
        for j in range(int(depth)):
            out.append(dict(
                param=f"swinViT.layers{i + 1}.0.blocks.{j}",
                tokens=_vox(grid), padded=_vox(padded), c=f * 2 ** i,
                heads=int(heads), n=n, windows=_vox(padded) // n,
                rolled=j % 2 == 1 and any(d > w for d in grid)))
    return out


def linears(cfg: dict, volume) -> List[dict]:
    """The Linear layers of one volume: (param prefix, rows, in, out); qkv
    and proj act on the padded windows, the MLP on the real tokens, each
    merge on the stage's tokens / 8."""
    ratio = float(cfg["mlp_ratio"])
    out = []
    for b in attention_blocks(cfg, volume):
        c, hid = b["c"], int(b["c"] * ratio)
        out += [(b["param"] + ".attn.qkv", b["padded"], c, 3 * c),
                (b["param"] + ".attn.proj", b["padded"], c, c),
                (b["param"] + ".mlp.linear1", b["tokens"], c, hid),
                (b["param"] + ".mlp.linear2", b["tokens"], hid, c)]
    f = int(cfg["feature_size"])
    for i, grid in enumerate(_grids(cfg, volume)[1:]):
        out.append((f"swinViT.layers{i + 1}.0.downsample.reduction",
                    _vox(grid), 8 * f * 2 ** i, 2 * f * 2 ** i))
    return out


def norms(cfg: dict, volume) -> List[dict]:
    """The InstanceNorms of one volume, each a GroupNorm launch of one group
    per channel: (voxels, channels, groups)."""
    return [dict(vox=layer["vox_out"], c=layer["cout"], groups=layer["cout"])
            for layer in layers(cfg, volume)
            if layer["param"].rsplit(".", 1)[-1] in ("conv1", "conv2", "conv3")]


def _trainable(param: str, tl: Optional[Sequence[str]]) -> bool:
    return tl is None or any(param.startswith(p) for p in tl)


def _attn_flops(b: dict) -> float:
    """QK^T and PV of one block's forward: 2 N^2 C per window, each."""
    return 2 * 2.0 * b["windows"] * b["n"] ** 2 * b["c"]


def attn_bound_s(cfg: dict, volume, batch: int, backward: bool) -> float:
    """Least seconds of one step's window attention, block by block: the
    larger of QK^T and PV at the bf16 peak (the backward's dQ, dK, dV and
    dP twice the forward's) and the bytes of q, k, v, o (the backward's q,
    k, v, o, dO read and dQ, dK, dV written), each block's bias (H, N, N)
    and shift mask (nW, N, N) read in each pass and the bias's gradient
    written, all bf16."""
    total = 0.0
    for b in attention_blocks(cfg, volume):
        act = batch * b["windows"] * b["n"] * b["c"] * counts.BF16
        bias = b["heads"] * b["n"] ** 2 * counts.BF16
        mask = b["windows"] * b["n"] ** 2 * counts.BF16 if b["rolled"] else 0
        flops = batch * _attn_flops(b)
        nbytes = 4 * act + bias + mask
        if backward:
            flops *= 3
            nbytes += 8 * act + 2 * bias + mask
        total += max(flops / counts.PEAK_BF16_FLOPS,
                     nbytes / counts.PEAK_BYTES)
    return total


def work(cfg: dict, traffic: dict, route_name: str) -> dict:
    """What the per-layer metrics read of one step of ``traffic``: its
    matrix operations (``flops_step``: convs, transposed convs, the head,
    the patch embedding, every Linear, the attention's QK^T and PV;
    forward, dx where the backward needs it, dW where trainable), the
    least time of its cuDNN convs (``conv_bound_s_step``, the batch in one
    launch), of its InstanceNorm launches (``gn_bound_s_step``) and of its
    window attention (``attn_bound_s_step``)."""
    volume, batch = traffic["volume"], int(traffic["batch"])
    tl = traffic.get("training_layers")
    lay = layers(cfg, volume)
    backward = any(counts.needs_dx(lay, i, tl) for i in range(len(lay)))
    trunk = tl is None or any(not p.startswith("out") for p in tl)
    flops = counts.step_flops(lay, batch, tl)
    for param, rows, a, b in linears(cfg, volume):
        passes = 1 + trunk + _trainable(param, tl)
        flops += passes * 2.0 * batch * rows * a * b
    flops += sum((3 if trunk else 1) * batch * _attn_flops(b)
                 for b in attention_blocks(cfg, volume))
    return {
        "flops_step": flops,
        "conv_bound_s_step": counts.conv_bound_s(
            lay, batch, batch, tl, ("conv", "convT"), skip_entry=False),
        "gn_bound_s_step": counts.gn_bound_s(norms(cfg, volume), batch,
                                             backward),
        "attn_bound_s_step": attn_bound_s(cfg, volume, batch, trunk),
    }
