"""The program's side of the 3D U-Net: the port's ``UNet3D`` built as
``method/base.py`` builds it, the weights the benchmark made loaded into
it, its ``TrainState`` and ``make_train_step`` (SGD with momentum); the
first gradient as that optimizer holds it; and the layers' shapes and the
step's work by route that :mod:`benchmark.counts` counts.

The port is imported inside the functions, so the test of the folder's
files and a directory without the port can import this module.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build(cfg: dict, traffic: dict, weights: Dict[str, torch.Tensor],
          device):
    """(model, state, step) of the port on ``device``, the model's
    parameters set to ``weights``."""
    from unetsulc_tpu_torch.models.unet3d import UNet3D
    from unetsulc_tpu_torch.train.step import TrainState, make_train_step

    model = UNet3D(
        in_channels=int(cfg["in_channels"]),
        out_channels=int(cfg["out_channels"]),
        final_sigmoid=bool(cfg["final_sigmoid"]),
        interpolate=bool(cfg["interpolate"]),
        conv_layer_order=cfg["conv_layer_order"],
        init_channel_number=int(cfg["init_channel_number"]),
        num_conv=int(cfg["num_conv"]),
        dropout=float(cfg["dropout"]),
        compute_dtype=DTYPES[cfg["compute_dtype"]],
        device=device,
        fused_blocks=bool(cfg["pallas_blocks"]),
        remat=False,
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
    """"fused" or "nonfused": the path the port takes for batch ``x``."""
    return "fused" if model.fused_eligible(x[:1]) else "nonfused"


def first_gradient(state) -> Dict[str, torch.Tensor]:
    """name -> the first gradient of each trainable parameter as the
    optimizer got it, read after the first step: SGD's momentum buffer,
    which that step set to the gradient."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    out = {}
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            buf = state.optimizer.state.get(p, {}).get("momentum_buffer")
            if buf is not None:
                out[names[id(p)]] = buf
    return out


def trainable_names(model, training_layers: Optional[Sequence[str]]):
    from unetsulc_tpu_torch.train.freeze import trainable_names as names

    return names(model, training_layers)


def work(cfg: dict, traffic: dict, route_name: str) -> dict:
    """What the per-layer metrics read of one step of ``traffic`` on
    ``route_name``: its matrix operations (``flops_step``) and the least
    time of its conv work (``conv_bound_s_step``) and of its GroupNorm
    launches (``gn_bound_s_step``). The fused route launches its convs one
    volume at a time, skips the entry conv's input gradient and runs no
    GroupNorm kernel; the non-fused one launches the batch at once,
    transposed convs with the convs."""
    from benchmark import counts

    volume, batch = traffic["volume"], int(traffic["batch"])
    tl = traffic.get("training_layers")
    lay = layers(cfg, volume)
    fused = route_name == "fused"
    backward = any(counts.needs_dx(lay, i, tl) for i in range(len(lay)))
    return {
        "flops_step": counts.step_flops(lay, batch, tl),
        "conv_bound_s_step": counts.conv_bound_s(
            lay, batch, 1 if fused else batch, tl,
            ("conv",) if fused else ("conv", "convT"), skip_entry=fused),
        "gn_bound_s_step": 0.0 if fused else counts.gn_bound_s(
            norms(cfg, volume), batch, backward),
    }


def _extents(volume) -> List[List[int]]:
    """Per level, the extents: MaxPool3d(2, 2, padding 1) takes d to
    d // 2 + 1."""
    ext = [list(int(v) for v in volume)]
    for _ in range(3):
        ext.append([d // 2 + 1 for d in ext[-1]])
    return ext


def _vox(e) -> int:
    return int(e[0]) * int(e[1]) * int(e[2])


def layers(cfg: dict, volume) -> List[dict]:
    """The convs, transposed convs and the head of one volume, in the
    network's order (see :mod:`benchmark.counts`)."""
    i, cin = int(cfg["init_channel_number"]), int(cfg["in_channels"])
    ext = _extents(volume)
    out = []
    for n, (a, b) in enumerate([(cin, i), (i, 2 * i), (2 * i, 4 * i),
                                (4 * i, 8 * i)]):
        v = _vox(ext[n])
        p = f"encoders.{n}.double_conv"
        out.append(dict(kind="conv", vox_in=v, vox_out=v, cins=[a],
                        cout=b // 2, taps=27, entry=n == 0, param=p + ".conv1"))
        out.append(dict(kind="conv", vox_in=v, vox_out=v, cins=[b // 2],
                        cout=b, taps=27, entry=False, param=p + ".conv2"))
    for n, (a, b) in enumerate([(12 * i, 4 * i), (6 * i, 2 * i), (3 * i, i)]):
        lvl = 2 - n
        v, deeper = _vox(ext[lvl]), _vox(ext[lvl + 1])
        up = a - b
        if not cfg["interpolate"]:
            full = _vox([2 * d for d in ext[lvl + 1]])
            out.append(dict(kind="convT", vox_in=deeper, vox_out=full,
                            cins=[up], cout=up, taps=27, entry=False,
                            param=f"decoders.{n}.upsample"))
        p = f"decoders.{n}.double_conv"
        out.append(dict(kind="conv", vox_in=v, vox_out=v, cins=[b, up],
                        cout=b, taps=27, entry=False, param=p + ".conv1"))
        out.append(dict(kind="conv", vox_in=v, vox_out=v, cins=[b], cout=b,
                        taps=27, entry=False, param=p + ".conv2"))
    v = _vox(ext[0])
    out.append(dict(kind="head", vox_in=v, vox_out=v, cins=[i],
                    cout=int(cfg["out_channels"]), taps=1, entry=False,
                    param="final_conv"))
    return out


def norms(cfg: dict, volume) -> List[dict]:
    """The GroupNorm layers of one volume: (voxels, channels, groups)."""
    from benchmark.references.unet3d import groups

    i = int(cfg["init_channel_number"])
    ext = _extents(volume)
    out = []
    for n, b in enumerate([i, 2 * i, 4 * i, 8 * i]):
        for c in (b // 2, b):
            out.append(dict(vox=_vox(ext[n]), c=c, groups=groups(c)))
    for n, b in enumerate([4 * i, 2 * i, i]):
        for _ in range(2):
            out.append(dict(vox=_vox(ext[2 - n]), c=b, groups=groups(b)))
    return out
