"""The plain reference of Swin UNETR (Hatamizadeh et al. 2022,
arXiv:2201.01266), as MONAI's ``monai/networks/nets/swin_unetr.py``
builds it (``SwinUNETR``, ``use_v2=False``, ``norm_name="instance"``,
``normalize=True``, no dropout), and its SGD step, in float32 PyTorch with
TF32 off.

It imports nothing of the program: no kernel, no cache, no fused
attention. It follows MONAI's code on channels-first (N, C, D, H, W)
tensors, one volume at a time (the batch's gradients added up), from the
configuration's sizes and the weights the benchmark made:

* ``swinViT``: a Conv3d(patch, stride patch) patch embedding; four stages
  of Swin blocks (LayerNorm, pad to a multiple of the window, roll by
  -window // 2 in odd blocks, window partition, attention with the
  relative-position bias and, rolled, the -100 region mask, reverse, roll
  back, crop, residual; LayerNorm, Linear(4C), GELU (erf), Linear(C),
  residual), each stage ending in a patch merge (the eight 2^3
  neighbours concatenated, LayerNorm(8C), Linear(8C -> 2C, no bias)); an
  axis no longer than the window is one window with no shift, and such a
  window reads the first N rows and columns of the full window's
  relative-position index, as MONAI's ``[:n, :n]`` does; padded tokens
  are zeros and attend unmasked; the five hidden states layer-normed over
  channels with no affine;
* residual blocks (conv3^3, InstanceNorm without affine, eps 1e-5,
  LeakyReLU 0.01, conv3^3, InstanceNorm, a 1x1 conv and InstanceNorm on
  the input where the width changes, LeakyReLU after the sum; no conv
  bias), up-blocks (ConvTranspose3d k2 s2 without bias, concatenated with
  the skip in that order, a residual block) and a 1x1 head with bias;
* the loss, counts, SGD, TF32 switch and float8 control of
  :mod:`benchmark.references.unet3d`, repeated here.

Departures from MONAI, also in the configuration's ``assumed``: the
weights are torch's default uniform for every conv, transposed conv and
Linear, LayerNorm 1 and 0, and the relative-position tables U(-b, b) with
b = 0.02 sqrt(3), the spread of MONAI's trunc-normal std 0.02 (MONAI's own
draws are not used); the patch merge concatenates in
``itertools.product`` order (MONAI's ``PatchMergingV2``; its
``downsample="merging"`` takes the v0.9.0 ``PatchMerging``, whose order
differs); the relative-position index is rebuilt from the window, not
kept as a buffer; the optimizer is SGD with momentum, not the BTCV
recipe's AdamW.

``quant="fp8"`` is the control, the precision below the configuration's
bfloat16: every conv's, transposed conv's and Linear's input, weight and
output, and the attention's q, k, v and output, rounded to float8 e4m3
under a per-tensor scale, and the gradient back through each of them to
e5m2; LayerNorm, InstanceNorm, softmax, the loss and the update stay in
float32.
"""

from __future__ import annotations

import contextlib
import itertools
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

EPS = 1e-5
TABLE_FAN_IN = 1.0 / (3 * 0.02 ** 2)


# -- as references/unet3d.py has them (a reference imports no other file) --

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
    """float8 e4m3 forward; the gradient back through it float8 e5m2."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def fp8(t: torch.Tensor) -> torch.Tensor:
    return _FP8.apply(t)


def loss_and_counts(logits: torch.Tensor, labels: torch.Tensor,
                    classes: int):
    """(mean masked cross-entropy, (3, classes) int64 [TP, FP, FN]) of
    logits (N, classes, ...) against labels (N, ...), -1 left out."""
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


def _sizes(cfg: dict):
    f = int(cfg["feature_size"])
    return (f, [int(d) for d in cfg["depths"]],
            [int(h) for h in cfg["num_heads"]], int(cfg["window_size"]),
            int(cfg["patch_size"]), float(cfg["mlp_ratio"]))


def _res_block(prefix: str, cin: int, cout: int):
    out = [(f"{prefix}.conv1.conv.weight", (cout, cin, 3, 3, 3), "uniform"),
           (f"{prefix}.conv2.conv.weight", (cout, cout, 3, 3, 3), "uniform")]
    if cin != cout:
        out.append((f"{prefix}.conv3.conv.weight", (cout, cin, 1, 1, 1),
                    "uniform"))
    return out


def param_shapes(cfg: dict) -> "OrderedDict[str, tuple]":
    """name -> (shape, init, fan_in) of every parameter, in MONAI's
    ``state_dict`` names. ``init``: "uniform" (U(-b, b), b = fan_in **
    -0.5), "one" or "zero" (LayerNorm)."""
    f, depths, heads, w, patch, ratio = _sizes(cfg)
    cin, classes = int(cfg["in_channels"]), int(cfg["out_channels"])
    specs = [("swinViT.patch_embed.proj.weight", (f, cin, patch, patch, patch),
              "uniform"),
             ("swinViT.patch_embed.proj.bias", (f,), "uniform")]
    for i, (depth, nh) in enumerate(zip(depths, heads)):
        dim = f * 2 ** i
        lay = f"swinViT.layers{i + 1}.0"
        for j in range(depth):
            b = f"{lay}.blocks.{j}"
            hid = int(dim * ratio)
            specs += [(f"{b}.norm1.weight", (dim,), "one"),
                      (f"{b}.norm1.bias", (dim,), "zero"),
                      (f"{b}.attn.relative_position_bias_table",
                       ((2 * w - 1) ** 3, nh), "table"),
                      (f"{b}.attn.qkv.weight", (3 * dim, dim), "uniform"),
                      (f"{b}.attn.qkv.bias", (3 * dim,), "uniform"),
                      (f"{b}.attn.proj.weight", (dim, dim), "uniform"),
                      (f"{b}.attn.proj.bias", (dim,), "uniform"),
                      (f"{b}.norm2.weight", (dim,), "one"),
                      (f"{b}.norm2.bias", (dim,), "zero"),
                      (f"{b}.mlp.linear1.weight", (hid, dim), "uniform"),
                      (f"{b}.mlp.linear1.bias", (hid,), "uniform"),
                      (f"{b}.mlp.linear2.weight", (dim, hid), "uniform"),
                      (f"{b}.mlp.linear2.bias", (dim,), "uniform")]
        specs += [(f"{lay}.downsample.reduction.weight", (2 * dim, 8 * dim),
                   "uniform"),
                  (f"{lay}.downsample.norm.weight", (8 * dim,), "one"),
                  (f"{lay}.downsample.norm.bias", (8 * dim,), "zero")]
    for name, a, b in (("encoder1", cin, f), ("encoder2", f, f),
                       ("encoder3", 2 * f, 2 * f), ("encoder4", 4 * f, 4 * f),
                       ("encoder10", 16 * f, 16 * f)):
        specs += _res_block(f"{name}.layer", a, b)
    for name, a, b in (("decoder5", 16 * f, 8 * f), ("decoder4", 8 * f, 4 * f),
                       ("decoder3", 4 * f, 2 * f), ("decoder2", 2 * f, f),
                       ("decoder1", f, f)):
        specs.append((f"{name}.transp_conv.conv.weight", (a, b, 2, 2, 2),
                      "uniform"))
        specs += _res_block(f"{name}.conv_block", 2 * b, b)
    specs += [("out.conv.weight", (classes, f, 1, 1, 1), "uniform"),
              ("out.conv.bias", (classes,), "uniform")]
    table = OrderedDict()
    for name, shape, init in specs:
        if init == "table":
            table[name] = (tuple(shape), "uniform", TABLE_FAN_IN)
            continue
        src = shape
        if name.endswith(".bias") and init == "uniform":
            src = table[name[:-len("bias")] + "weight"][0]
        fan_in = 1
        for s in src[1:]:
            fan_in *= s
        table[name] = (tuple(shape), init, fan_in)
    return table


# -- MONAI's window helpers, plain -----------------------------------------

def get_window_size(x_size, window_size, shift_size):
    ws, ss = list(window_size), list(shift_size)
    for i in range(len(x_size)):
        if x_size[i] <= window_size[i]:
            ws[i] = x_size[i]
            ss[i] = 0
    return tuple(ws), tuple(ss)


def window_partition(x, ws):
    b, d, h, w, c = x.shape
    x = x.view(b, d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2], ws[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).contiguous().view(
        -1, ws[0] * ws[1] * ws[2], c)


def window_reverse(windows, ws, dims):
    b, d, h, w = dims
    x = windows.view(b, d // ws[0], h // ws[1], w // ws[2], ws[0], ws[1],
                     ws[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).contiguous().view(b, d, h, w, -1)


def compute_mask(dims, ws, ss, device):
    d, h, w = dims
    img_mask = torch.zeros((1, d, h, w, 1), device=device)
    cnt = 0
    for a in slice(-ws[0]), slice(-ws[0], -ss[0]), slice(-ss[0], None):
        for b in slice(-ws[1]), slice(-ws[1], -ss[1]), slice(-ss[1], None):
            for c in slice(-ws[2]), slice(-ws[2], -ss[2]), slice(-ss[2], None):
                img_mask[:, a, b, c, :] = cnt
                cnt += 1
    mask_windows = window_partition(img_mask, ws).squeeze(-1)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, -100.0).masked_fill(
        attn_mask == 0, 0.0)


def relative_position_index(window_size, device):
    coords = torch.stack(torch.meshgrid(
        torch.arange(window_size[0]), torch.arange(window_size[1]),
        torch.arange(window_size[2]), indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += window_size[0] - 1
    rel[:, :, 1] += window_size[1] - 1
    rel[:, :, 2] += window_size[2] - 1
    rel[:, :, 0] *= (2 * window_size[1] - 1) * (2 * window_size[2] - 1)
    rel[:, :, 1] *= 2 * window_size[2] - 1
    return rel.sum(-1).to(device)


class Net:
    """The forward of the reference over a dict of f32 parameters, one
    volume (1, C, D, H, W) at a time."""

    def __init__(self, cfg: dict, quant: Optional[str] = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown quant {quant!r}")
        (self.f, self.depths, self.heads, w, self.patch,
         self.ratio) = _sizes(cfg)
        self.window = (w, w, w)
        self.q = fp8 if quant == "fp8" else (lambda t: t)

    # -- layers ----------------------------------------------------------
    def linear(self, x, w, b=None):
        return self.q(F.linear(self.q(x), self.q(w), b))

    def conv(self, x, w, b=None, **kw):
        return self.q(F.conv3d(self.q(x), self.q(w), b, **kw))

    def layer_norm(self, p, x, prefix):
        return F.layer_norm(x, x.shape[-1:], p[prefix + ".weight"],
                            p[prefix + ".bias"], EPS)

    @staticmethod
    def instance_norm(x):
        mean = x.mean((2, 3, 4), keepdim=True)
        var = ((x - mean) ** 2).mean((2, 3, 4), keepdim=True)
        return (x - mean) / torch.sqrt(var + EPS)

    def attention(self, p, x, prefix, heads, mask):
        b, n, c = x.shape
        qkv = self.linear(x, p[prefix + ".qkv.weight"], p[prefix + ".qkv.bias"])
        qkv = qkv.reshape(b, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
        q, k, v = self.q(qkv[0]), self.q(qkv[1]), self.q(qkv[2])
        q = q * (c // heads) ** -0.5
        attn = q @ k.transpose(-2, -1)
        index = relative_position_index(self.window, x.device)[:n, :n]
        bias = p[prefix + ".relative_position_bias_table"][
            index.reshape(-1)].reshape(n, n, -1).permute(2, 0, 1)
        attn = attn + bias.unsqueeze(0)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(b // nw, nw, heads, n, n) + mask.unsqueeze(
                1).unsqueeze(0)
            attn = attn.view(-1, heads, n, n)
        attn = torch.softmax(attn, -1)
        x = self.q(attn @ v).transpose(1, 2).reshape(b, n, c)
        return self.linear(x, p[prefix + ".proj.weight"],
                           p[prefix + ".proj.bias"])

    def block(self, p, x, prefix, heads, shift, mask):
        shortcut = x
        x = self.layer_norm(p, x, prefix + ".norm1")
        b, d, h, w, c = x.shape
        ws, ss = get_window_size((d, h, w), self.window, shift)
        pd = (ws[0] - d % ws[0]) % ws[0]
        pb = (ws[1] - h % ws[1]) % ws[1]
        pr = (ws[2] - w % ws[2]) % ws[2]
        x = F.pad(x, (0, 0, 0, pr, 0, pb, 0, pd))
        _, dp, hp, wp, _ = x.shape
        rolled = any(s > 0 for s in ss)
        if rolled:
            x = torch.roll(x, shifts=(-ss[0], -ss[1], -ss[2]), dims=(1, 2, 3))
        windows = window_partition(x, ws)
        out = self.attention(p, windows, prefix + ".attn", heads,
                             mask if rolled else None)
        x = window_reverse(out.view(-1, *(ws + (c,))), ws, [b, dp, hp, wp])
        if rolled:
            x = torch.roll(x, shifts=ss, dims=(1, 2, 3))
        x = x[:, :d, :h, :w, :].contiguous()
        x = shortcut + x
        y = self.layer_norm(p, x, prefix + ".norm2")
        y = self.linear(y, p[prefix + ".mlp.linear1.weight"],
                        p[prefix + ".mlp.linear1.bias"])
        y = self.linear(F.gelu(y), p[prefix + ".mlp.linear2.weight"],
                        p[prefix + ".mlp.linear2.bias"])
        return x + y

    def merge(self, p, x, prefix):
        _, d, h, w, _ = x.shape
        if d % 2 or h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        x = torch.cat([x[:, i::2, j::2, k::2, :] for i, j, k in
                       itertools.product(range(2), range(2), range(2))], -1)
        x = self.layer_norm(p, x, prefix + ".norm")
        return self.linear(x, p[prefix + ".reduction.weight"])

    def stage(self, p, x, i):
        """``layers{i+1}`` on (1, C, D, H, W) -> (1, 2C, D/2, H/2, W/2)."""
        prefix = f"swinViT.layers{i + 1}.0"
        _, _, d, h, w = x.shape
        half = tuple(s // 2 for s in self.window)
        ws, ss = get_window_size((d, h, w), self.window, half)
        x = x.permute(0, 2, 3, 4, 1)
        dims = [-(-d // ws[0]) * ws[0], -(-h // ws[1]) * ws[1],
                -(-w // ws[2]) * ws[2]]
        mask = compute_mask(dims, ws, ss, x.device)
        for j in range(self.depths[i]):
            shift = (0, 0, 0) if j % 2 == 0 else half
            x = self.block(p, x, f"{prefix}.blocks.{j}", self.heads[i], shift,
                           mask)
        x = self.merge(p, x, prefix + ".downsample")
        return x.permute(0, 4, 1, 2, 3)

    @staticmethod
    def proj_out(x):
        x = x.permute(0, 2, 3, 4, 1)
        return F.layer_norm(x, x.shape[-1:], eps=EPS).permute(0, 4, 1, 2, 3)

    def res_block(self, p, x, prefix):
        y = F.leaky_relu(self.instance_norm(
            self.conv(x, p[prefix + ".conv1.conv.weight"], padding=1)), 0.01)
        y = self.instance_norm(
            self.conv(y, p[prefix + ".conv2.conv.weight"], padding=1))
        if prefix + ".conv3.conv.weight" in p:
            x = self.instance_norm(self.conv(x, p[prefix + ".conv3.conv.weight"]))
        return F.leaky_relu(y + x, 0.01)

    def up_block(self, p, x, skip, prefix):
        up = self.q(F.conv_transpose3d(
            self.q(x), self.q(p[prefix + ".transp_conv.conv.weight"]), stride=2))
        return self.res_block(p, torch.cat((up, skip), 1),
                              prefix + ".conv_block")

    def encode(self, p, x) -> List[torch.Tensor]:
        x0 = self.conv(x, p["swinViT.patch_embed.proj.weight"],
                       p["swinViT.patch_embed.proj.bias"], stride=self.patch)
        hidden, h = [self.proj_out(x0)], x0
        for i in range(4):
            h = self.stage(p, h, i)
            hidden.append(self.proj_out(h))
        return hidden

    def trunk(self, p, x):
        hidden = self.encode(p, x)
        enc0 = self.res_block(p, x, "encoder1.layer")
        enc1 = self.res_block(p, hidden[0], "encoder2.layer")
        enc2 = self.res_block(p, hidden[1], "encoder3.layer")
        enc3 = self.res_block(p, hidden[2], "encoder4.layer")
        dec4 = self.res_block(p, hidden[4], "encoder10.layer")
        dec3 = self.up_block(p, dec4, hidden[3], "decoder5")
        dec2 = self.up_block(p, dec3, enc3, "decoder4")
        dec1 = self.up_block(p, dec2, enc2, "decoder3")
        dec0 = self.up_block(p, dec1, enc1, "decoder2")
        return self.up_block(p, dec0, enc0, "decoder1")

    def __call__(self, p: Dict[str, torch.Tensor], x: torch.Tensor,
                 trunk_grad: bool = True) -> torch.Tensor:
        """Logits (1, classes, D, H, W) of a volume (1, C, D, H, W); the
        trunk without autograd when ``trunk_grad`` is False."""
        if trunk_grad:
            out = self.trunk(p, x)
        else:
            with torch.no_grad():
                out = self.trunk(p, x)
        return self.conv(out, p["out.conv.weight"], p["out.conv.bias"])


def train_steps(params0: Dict[str, torch.Tensor], batches: Sequence,
                cfg: dict, trainable: Sequence[str],
                quant: Optional[str] = None) -> dict:
    """The first ``len(batches)`` SGD steps (``cfg``'s ``lr`` and
    ``momentum``) from ``params0`` on ``batches`` [(x (N, X, Y, Z, C),
    labels (N, X, Y, Z))], each batch one volume at a time: a volume's
    loss is its NLL sum over the batch's valid count, and the volumes'
    gradients add up to the batch mean's. Returns each step's loss and
    counts, the first step's gradient of each trainable parameter, and
    every parameter after the last step."""
    net = Net(cfg, quant)
    lr, momentum = float(cfg["lr"]), float(cfg["momentum"])
    classes = int(cfg["out_channels"])
    trainable = set(trainable)
    trunk_grad = any(not n.startswith("out.") for n in trainable)
    p = {n: v.detach().clone().float() for n, v in params0.items()}
    bufs: Dict[str, torch.Tensor] = {}
    losses: List[float] = []
    counts: List[torch.Tensor] = []
    grad1: Dict[str, torch.Tensor] = {}
    with no_tf32():
        for k, (x, lb) in enumerate(batches):
            for n, v in p.items():
                v.requires_grad_(n in trainable)
            names = [n for n in p if n in trainable]
            denom = (lb != -1).sum().clamp_min(1).float()
            grads = [torch.zeros_like(p[n]) for n in names]
            loss, cnt = 0.0, 0
            for i in range(int(x.shape[0])):
                logits = net(p, x[i:i + 1].float().permute(0, 4, 1, 2, 3),
                             trunk_grad)
                part, c = loss_and_counts(logits, lb[i:i + 1], classes)
                part = part * ((lb[i] != -1).sum().clamp_min(1) / denom)
                for g, d in zip(grads, torch.autograd.grad(
                        part, [p[n] for n in names])):
                    g.add_(d)
                loss += part.item()
                cnt = cnt + c.cpu()
                del logits, part
            losses.append(loss)
            counts.append(cnt)
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
