"""The plain reference of the 3D U-Net (deepsulci ``UNet3D``, as the
neurospin 2022_pauriau_unetsulc repository trains it) and its SGD step, in
float32 PyTorch with TF32 off.

It imports nothing of the program. It works the network out from the
configuration's sizes and the weights the benchmark made, on channels-first
(N, C, X, Y, Z) tensors, with the semantics the port gives the model:

* DoubleConv in 'crg' order: Conv3d(3, padding 1), ReLU, GroupNorm (groups:
  the largest divisor of the channels <= 32, eps 1e-5); an encoder's
  first conv goes in -> out/2, a decoder's in -> out;
* MaxPool3d(2, stride 2, padding 1) between encoders (extent d -> d//2+1);
* a decoder upsamples the deeper level to its skip's extent, by the
  trilinear resize with half-pixel centres (``align_corners=False``) when
  ``interpolate``, else by ConvTranspose3d(k 3, stride 2, padding 1,
  output padding 1) cropped at the leading corner, and runs its DoubleConv
  on the skip and the upsampled tensor in that order of channels;
* a 1x1x1 head; the loss is the cross-entropy summed over the voxels whose
  label is not -1, over their count; the counts are (TP, FP, FN) per class
  from the logits' argmax over those voxels;
* SGD with momentum, no dampening: buf = momentum * buf + grad (buf =
  grad at the first step), param -= lr * buf.

``quant="fp8"`` is the control, the precision below the configuration's
bfloat16: every conv's and transposed conv's input, weight and output
rounded to float8 e4m3 under a per-tensor scale, and the gradient that
flows back through each of them to float8 e5m2 (the head's too), where
the program holds them in bfloat16; GroupNorm, the resize, the loss and
the update stay in float32.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

GN_EPS = 1e-5


def groups(channels: int, preferred: int = 32) -> int:
    g = min(preferred, channels)
    while channels % g:
        g -= 1
    return g


def _double_conv(prefix: str, cin: int, cout: int, encoder: bool):
    mid = cout // 2 if encoder else cout
    out = []
    for unit, (a, b) in (("1", (cin, mid)), ("2", (mid, cout))):
        out += [(f"{prefix}.conv{unit}.weight", (b, a, 3, 3, 3), "uniform"),
                (f"{prefix}.conv{unit}.bias", (b,), "uniform"),
                (f"{prefix}.norm{unit}.weight", (b,), "one"),
                (f"{prefix}.norm{unit}.bias", (b,), "zero")]
    return out


def param_shapes(cfg: dict) -> "OrderedDict[str, tuple]":
    """name -> (shape, init, fan_in) of every parameter, in the torch
    ``state_dict`` names of the reference model. ``init``: "uniform"
    (torch's default for convs: U(-b, b), b = fan_in ** -0.5), "one" or
    "zero" (GroupNorm)."""
    i, cin = int(cfg["init_channel_number"]), int(cfg["in_channels"])
    specs = []
    for n, (a, b) in enumerate([(cin, i), (i, 2 * i), (2 * i, 4 * i),
                                (4 * i, 8 * i)]):
        specs += _double_conv(f"encoders.{n}.double_conv", a, b, True)
    for n, (a, b) in enumerate([(12 * i, 4 * i), (6 * i, 2 * i), (3 * i, i)]):
        if not cfg["interpolate"]:
            up = a - b
            specs += [(f"decoders.{n}.upsample.weight", (up, up, 3, 3, 3),
                       "uniform"),
                      (f"decoders.{n}.upsample.bias", (up,), "uniform")]
        specs += _double_conv(f"decoders.{n}.double_conv", a, b, False)
    out = int(cfg["out_channels"])
    specs += [("final_conv.weight", (out, i, 1, 1, 1), "uniform"),
              ("final_conv.bias", (out,), "uniform")]
    table = OrderedDict()
    for name, shape, init in specs:
        if name.endswith(".bias") and init == "uniform":
            w = table[name[:-len("bias")] + "weight"][0]
            fan_in = 1
            for s in w[1:]:
                fan_in *= s
        else:
            fan_in = 1
            for s in shape[1:]:
                fan_in *= s
        table[name] = (tuple(shape), init, fan_in)
    return table


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _round(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``t`` rounded to ``dtype`` under a per-tensor scale (its largest
    magnitude to the type's ``top``), back in float32."""
    scale = top / t.abs().amax().clamp_min(1e-30)
    return (t * scale).to(dtype).to(torch.float32) / scale


class _FP8(torch.autograd.Function):
    """A tensor as an fp8 pipeline holds it: float8 e4m3 forward, and the
    gradient that comes back through it float8 e5m2."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def fp8(t: torch.Tensor) -> torch.Tensor:
    return _FP8.apply(t)


class Net:
    """The forward of the reference over a dict of f32 parameters."""

    def __init__(self, cfg: dict, quant: Optional[str] = None):
        if cfg.get("conv_layer_order", "crg") != "crg":
            raise ValueError("the reference holds the 'crg' order only")
        self.interpolate = bool(cfg["interpolate"])
        self.q = fp8 if quant == "fp8" else (lambda t: t)
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown quant {quant!r}")

    def conv(self, x, w, b, **kw):
        return self.q(F.conv3d(self.q(x), self.q(w), b, **kw))

    def unit(self, p, x, prefix, k):
        x = torch.relu(self.conv(x, p[f"{prefix}.conv{k}.weight"],
                                 p[f"{prefix}.conv{k}.bias"], padding=1))
        return F.group_norm(x, groups(x.shape[1]), p[f"{prefix}.norm{k}.weight"],
                            p[f"{prefix}.norm{k}.bias"], GN_EPS)

    def double_conv(self, p, x, prefix):
        return self.unit(p, self.unit(p, x, prefix, 1), prefix, 2)

    def upsample(self, p, x, n, size):
        if self.interpolate:
            return F.interpolate(x, size=size, mode="trilinear",
                                 align_corners=False)
        w = p[f"decoders.{n}.upsample.weight"]
        y = self.q(F.conv_transpose3d(self.q(x), self.q(w),
                                      p[f"decoders.{n}.upsample.bias"],
                                      stride=2, padding=1, output_padding=1))
        return y[:, :, :size[0], :size[1], :size[2]]

    def __call__(self, p: Dict[str, torch.Tensor], x: torch.Tensor,
                 trunk_grad: bool = True) -> torch.Tensor:
        """Logits (N, classes, X, Y, Z) of input (N, 1, X, Y, Z); the
        trunk without autograd when ``trunk_grad`` is False."""
        with contextlib.nullcontext() if trunk_grad else torch.no_grad():
            skips = []
            for n in range(4):
                if n:
                    x = F.max_pool3d(x, 2, 2, padding=1)
                x = self.double_conv(p, x, f"encoders.{n}.double_conv")
                skips.insert(0, x)
            for n, skip in enumerate(skips[1:]):
                up = self.upsample(p, x, n, tuple(skip.shape[2:]))
                x = self.double_conv(p, torch.cat([skip, up], 1),
                                     f"decoders.{n}.double_conv")
        return self.conv(x, p["final_conv.weight"], p["final_conv.bias"])


def loss_and_counts(logits: torch.Tensor, labels: torch.Tensor,
                    classes: int):
    """(mean masked cross-entropy, (3, classes) int64 [TP, FP, FN])."""
    valid = labels != -1
    nll = F.cross_entropy(logits, torch.where(valid, labels, 0),
                          reduction="none")
    loss = torch.where(valid, nll, 0.0).sum() / valid.sum().clamp_min(1)
    t = labels[valid]
    pred = logits.detach().argmax(1)[valid]
    tc = torch.bincount(t, minlength=classes)
    pc = torch.bincount(pred, minlength=classes)
    tp = torch.bincount(t[t == pred], minlength=classes)
    return loss, torch.stack([tp, pc - tp, tc - tp])


def train_steps(params0: Dict[str, torch.Tensor], batches: Sequence,
                cfg: dict, trainable: Sequence[str],
                quant: Optional[str] = None) -> dict:
    """The first ``len(batches)`` SGD steps (``cfg``'s ``lr`` and
    ``momentum``) from ``params0`` on ``batches`` [(x (N, X, Y, Z, 1),
    labels (N, X, Y, Z))]: each step's
    loss and counts, the first step's gradient of each trainable
    parameter, and every parameter after the last step."""
    net = Net(cfg, quant)
    lr, momentum = float(cfg["lr"]), float(cfg["momentum"])
    classes = int(cfg["out_channels"])
    trainable = set(trainable)
    trunk_grad = any(not n.startswith("final_conv") for n in trainable)
    p = {n: v.detach().clone().float() for n, v in params0.items()}
    bufs: Dict[str, torch.Tensor] = {}
    losses: List[float] = []
    counts: List[torch.Tensor] = []
    grad1: Dict[str, torch.Tensor] = {}
    with no_tf32():
        for k, (x, lb) in enumerate(batches):
            for n, v in p.items():
                v.requires_grad_(n in trainable)
            logits = net(p, x.float().permute(0, 4, 1, 2, 3), trunk_grad)
            loss, cnt = loss_and_counts(logits, lb, classes)
            names = [n for n in p if n in trainable]
            grads = torch.autograd.grad(loss, [p[n] for n in names])
            del logits
            losses.append(loss.item())
            counts.append(cnt.cpu())
            with torch.no_grad():
                for n, g in zip(names, grads):
                    if k == 0:
                        grad1[n] = g.clone()
                        bufs[n] = g.clone()
                    else:
                        bufs[n].mul_(momentum).add_(g)
                    p[n] = (p[n] - lr * bufs[n]).detach()
    return {"losses": losses, "counts": counts, "grad1": grad1,
            "params": {n: v.detach() for n, v in p.items()}}
