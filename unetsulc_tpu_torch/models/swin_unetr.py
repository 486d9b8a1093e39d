"""Swin UNETR (Hatamizadeh et al. 2022, arXiv:2201.01266), as MONAI's
``monai.networks.nets.SwinUNETR`` builds it with ``use_v2=False``,
``norm_name="instance"``, ``normalize=True`` and no dropout, on the
port's training path.

Encoder (``swinViT``): a 2^3 stride-2 patch-embedding conv, then four
stages of two Swin blocks (3, 6, 12, 24 heads) over windows of 7^3
tokens (every odd block on the grid rolled by -3, with the region
mask), each stage
ending in a patch merge (the eight 2^3 neighbours concatenated in
``itertools.product`` order, LayerNorm(8C), Linear(8C -> 2C, no bias)).
A block is ``x + proj(attention(windows(LN1(x))))``, then ``x +
linear2(GELU(linear1(LN2(x))))``; the attention's windows, shifts, masks
and relative-position biases are :mod:`unetsulc_tpu_torch.ops.window_attention`'s.
The five hidden states (after the embedding and after each stage) are
layer-normed over channels with no affine.

Decoder: MONAI's residual blocks (conv3^3, InstanceNorm, LeakyReLU 0.01,
conv3^3, InstanceNorm, plus a 1x1 conv and InstanceNorm on the input
where the width changes, LeakyReLU after the sum; no conv bias),
``encoder1`` on the input, ``encoder2-4`` and ``encoder10`` on the hidden
states, five up-blocks (ConvTranspose3d k2 s2 without bias, concatenated
with the skip in (upsampled, skip) order, then a residual block) and a
1x1 head with bias. InstanceNorm (no affine) is
:func:`~unetsulc_tpu_torch.ops.groupnorm.group_norm` with one group per
channel, the port's GroupNorm kernels on the card. Convs are cuDNN's on
channels-last views, as ``UNet3D``'s non-fused route runs them.

Compute is in ``compute_dtype`` (bf16 by default): activations, matmuls
and convs; LayerNorm, InstanceNorm and softmax keep f32 statistics, and
the parameters stay f32. In f32 the matmuls and convs run with TF32 off.

Parameter names are MONAI's ``state_dict`` keys
(``swinViT.layers1.0.blocks.1.attn.qkv.weight``,
``encoder1.layer.conv3.conv.weight``, ``decoder5.transp_conv.conv.weight``,
``out.conv.conv.bias``, ...); the relative-position index is rebuilt from
the window and not kept as a buffer. The model speaks the port's model
protocol (``device``, ``dropout``, ``precision()``, ``fused_eligible``,
``forward(x, train, apply_final_activation, padded_output,
dropout_generator)``) on channels-last (N, X, Y, Z, C) tensors whose
extents are multiples of 32, as MONAI requires. Only ``feature_size``
is a knob; depths, heads, window, patch and MLP ratio are MONAI's
defaults. With ``spans`` set to a ``HostSpans`` the forward records the
encoder as span ``swin_encoder``, of the step whose phase encloses it on
the calling thread.
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from unetsulc_tpu_torch.device import resolve_device
from unetsulc_tpu_torch.ops import window_attention as wa
from unetsulc_tpu_torch.ops.conv_fused import no_tf32
from unetsulc_tpu_torch.ops.groupnorm import group_norm
from unetsulc_tpu_torch.utils.profiling import span

NORM_EPS = 1e-5
LEAKY_SLOPE = 0.01
DIVISOR = 32
TABLE_STD = 0.02
# MONAI's SwinUNETR defaults, which the BTCV recipe keeps
DEPTHS = (2, 2, 2, 2)
NUM_HEADS = (3, 6, 12, 24)
WINDOW = 7
PATCH = 2
MLP_RATIO = 4.0


def _linear(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x, layer.weight.to(dtype), bias)


def _layer_norm(x: torch.Tensor, norm: Optional[nn.LayerNorm]) -> torch.Tensor:
    """LayerNorm over the last axis in x's dtype (its statistics in f32,
    torch's accumulation type), the affine in x's dtype (CUDA's kernel
    takes no f32 affine with a bf16 input); no affine where ``norm`` is
    None."""
    if norm is None:
        return F.layer_norm(x, x.shape[-1:], eps=NORM_EPS)
    return F.layer_norm(x, x.shape[-1:], norm.weight.to(x.dtype),
                        norm.bias.to(x.dtype), norm.eps)


def _conv(x: torch.Tensor, conv: nn.Conv3d, dtype) -> torch.Tensor:
    """``conv`` (its stride and padding, its bias if any) of a
    channels-last (N, X, Y, Z, C) tensor, on the channels-last view."""
    w = conv.weight.to(dtype, memory_format=torch.channels_last_3d)
    b = None if conv.bias is None else conv.bias.to(dtype)
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, b, stride=conv.stride,
                 padding=conv.padding)
    return y.permute(0, 2, 3, 4, 1)


class _Wrap(nn.Module):
    """A layer under the name ``conv``: MONAI's ``Convolution`` holds its
    conv so, which gives the ``...conv1.conv.weight`` parameter names."""

    def __init__(self, conv: nn.Module):
        super().__init__()
        self.conv = conv


class PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, dim: int, patch: int, device):
        super().__init__()
        self.proj = nn.Conv3d(in_channels, dim, patch, stride=patch,
                              device=device)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, device):
        super().__init__()
        self.heads = heads
        self.scale = (dim // heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(torch.empty(
            (2 * window - 1) ** 3, heads, device=device))
        self.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def forward(self, windows: torch.Tensor, plan: wa.WindowPlan,
                images: int, dtype) -> torch.Tensor:
        """(B nW, N, C) -> (B nW, N, C)."""
        bw, n, c = windows.shape
        qkv = _linear(windows, self.qkv, dtype).view(
            bw, n, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        bias = self.relative_position_bias_table[plan.index].view(
            n, n, self.heads).permute(2, 0, 1).to(dtype)
        out = wa.window_attention(qkv[0], qkv[1], qkv[2], bias, plan.mask,
                                  images, self.scale)
        return _linear(out.transpose(1, 2).reshape(bw, n, c), self.proj,
                       dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, device):
        super().__init__()
        self.linear1 = nn.Linear(dim, hidden, device=device)
        self.linear2 = nn.Linear(hidden, dim, device=device)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        return _linear(F.gelu(_linear(x, self.linear1, dtype)), self.linear2,
                       dtype)


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int,
                 mlp_ratio: float, device):
        super().__init__()
        self.shift = shift
        self.norm1 = nn.LayerNorm(dim, eps=NORM_EPS, device=device)
        self.attn = WindowAttention(dim, heads, window, device)
        self.norm2 = nn.LayerNorm(dim, eps=NORM_EPS, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), device)

    def forward(self, x: torch.Tensor, plan: wa.WindowPlan,
                dtype) -> torch.Tensor:
        b, d, h, w, c = x.shape
        y = _layer_norm(x, self.norm1)
        pd, ph, pw = (p - g for p, g in zip(plan.padded, (d, h, w)))
        if pd or ph or pw:
            y = F.pad(y, (0, 0, 0, pw, 0, ph, 0, pd))
        if plan.rolled:
            y = torch.roll(y, [-s for s in plan.shift], dims=(1, 2, 3))
        y = self.attn(wa.window_partition(y, plan.window), plan, b, dtype)
        y = wa.window_reverse(y, plan.window, b, plan.padded)
        if plan.rolled:
            y = torch.roll(y, list(plan.shift), dims=(1, 2, 3))
        if pd or ph or pw:
            y = y[:, :d, :h, :w]
        x = x + y
        return x + self.mlp(_layer_norm(x, self.norm2), dtype)


class PatchMerging(nn.Module):
    def __init__(self, dim: int, device):
        super().__init__()
        self.reduction = nn.Linear(8 * dim, 2 * dim, bias=False,
                                   device=device)
        self.norm = nn.LayerNorm(8 * dim, eps=NORM_EPS, device=device)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        _, d, h, w, _ = x.shape
        if d % 2 or h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        x = torch.cat([x[:, i::2, j::2, k::2] for i, j, k in
                       itertools.product(range(2), repeat=3)], -1)
        return _linear(_layer_norm(x, self.norm), self.reduction, dtype)


class BasicLayer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, window: int,
                 mlp_ratio: float, device):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinTransformerBlock(dim, heads, window, 0 if i % 2 == 0
                                 else window // 2, mlp_ratio, device)
            for i in range(depth))
        self.downsample = PatchMerging(dim, device)


class SwinTransformer(nn.Module):
    def __init__(self, in_channels: int, dim: int, device):
        super().__init__()
        self.patch_embed = PatchEmbed(in_channels, dim, PATCH, device)
        for i, (depth, nh) in enumerate(zip(DEPTHS, NUM_HEADS)):
            setattr(self, f"layers{i + 1}", nn.ModuleList([BasicLayer(
                dim * 2 ** i, depth, nh, WINDOW, MLP_RATIO, device)]))

    def stages(self) -> List[BasicLayer]:
        return [getattr(self, f"layers{i + 1}")[0] for i in range(4)]


class UnetResBlock(nn.Module):
    """MONAI's ``UnetResBlock`` at stride 1 with InstanceNorm (no affine):
    ``conv3`` where the width changes."""

    def __init__(self, cin: int, cout: int, device):
        super().__init__()
        self.conv1 = _Wrap(nn.Conv3d(cin, cout, 3, padding=1, bias=False,
                                     device=device))
        self.conv2 = _Wrap(nn.Conv3d(cout, cout, 3, padding=1, bias=False,
                                     device=device))
        if cin != cout:
            self.conv3 = _Wrap(nn.Conv3d(cin, cout, 1, bias=False,
                                         device=device))

    def forward(self, x: torch.Tensor, norm, dtype) -> torch.Tensor:
        y = F.leaky_relu(norm(_conv(x, self.conv1.conv, dtype)), LEAKY_SLOPE)
        y = norm(_conv(y, self.conv2.conv, dtype))
        res = norm(_conv(x, self.conv3.conv, dtype)) if hasattr(
            self, "conv3") else x
        return F.leaky_relu(y + res, LEAKY_SLOPE)


class UnetrBasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, device):
        super().__init__()
        self.layer = UnetResBlock(cin, cout, device)


class UnetrUpBlock(nn.Module):
    def __init__(self, cin: int, cout: int, device):
        super().__init__()
        self.transp_conv = _Wrap(nn.ConvTranspose3d(
            cin, cout, 2, stride=2, bias=False, device=device))
        self.conv_block = UnetResBlock(2 * cout, cout, device)

    def forward(self, x: torch.Tensor, skip: torch.Tensor, norm,
                dtype) -> torch.Tensor:
        conv = self.transp_conv.conv
        w = conv.weight.to(dtype, memory_format=torch.channels_last_3d)
        up = F.conv_transpose3d(x.permute(0, 4, 1, 2, 3), w, stride=2)
        up = up.permute(0, 2, 3, 4, 1)
        return self.conv_block(torch.cat((up, skip), -1), norm, dtype)


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """torch's default for every conv, transposed conv and Linear (weight
    and bias U(-b, b), b = fan_in ** -0.5, ``weight[0].numel()`` for a
    transposed conv), LayerNorm 1/0, and each relative-position table
    U(-b, b) with b = 0.02 sqrt(3), the spread of MONAI's trunc-normal
    std 0.02; drawn on the CPU so that a seed gives the same weights on
    every device."""
    def fill(p, bound):
        p.copy_(torch.empty(p.shape).uniform_(-bound, bound,
                                              generator=generator))

    for m in module.modules():
        if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d, nn.Linear)):
            bound = m.weight[0].numel() ** -0.5
            if isinstance(m, nn.Linear):
                bound = m.in_features ** -0.5
            for p in (m.weight, m.bias):
                if p is not None:
                    fill(p, bound)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, WindowAttention):
            fill(m.relative_position_bias_table, TABLE_STD * 3 ** 0.5)


class SwinUNETR(nn.Module):
    """Input (N, X, Y, Z, in_channels), every extent a multiple of 32;
    output (N, X, Y, Z, out_channels) f32 logits (train) or probabilities
    (eval). Parameters are drawn from ``seed`` (:func:`init_parameters`)."""

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 14,
        feature_size: int = 48,
        compute_dtype: torch.dtype = torch.bfloat16,
        device="cuda",
        seed: int = 0,
    ):
        super().__init__()
        device = resolve_device(device)
        if compute_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"compute_dtype must be bfloat16 or float32, "
                             f"got {compute_dtype}")
        if feature_size % NUM_HEADS[0]:
            raise ValueError(f"feature_size {feature_size} does not split "
                             f"into {NUM_HEADS[0]} heads")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.feature_size = feature_size
        self.compute_dtype = compute_dtype
        self.final_sigmoid = False
        self.dropout = 0.0
        self.spans = None
        self._plans: Dict[tuple, wa.WindowPlan] = {}
        self._ones: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
        f = feature_size
        meta = torch.device("meta")
        self.swinViT = SwinTransformer(in_channels, f, meta)
        self.encoder1 = UnetrBasicBlock(in_channels, f, meta)
        self.encoder2 = UnetrBasicBlock(f, f, meta)
        self.encoder3 = UnetrBasicBlock(2 * f, 2 * f, meta)
        self.encoder4 = UnetrBasicBlock(4 * f, 4 * f, meta)
        self.encoder10 = UnetrBasicBlock(16 * f, 16 * f, meta)
        self.decoder5 = UnetrUpBlock(16 * f, 8 * f, meta)
        self.decoder4 = UnetrUpBlock(8 * f, 4 * f, meta)
        self.decoder3 = UnetrUpBlock(4 * f, 2 * f, meta)
        self.decoder2 = UnetrUpBlock(2 * f, f, meta)
        self.decoder1 = UnetrUpBlock(f, f, meta)
        self.out = _Wrap(nn.Conv3d(f, out_channels, 1, device=meta))
        self.to_empty(device=device)
        init_parameters(self, torch.Generator().manual_seed(seed))

    @property
    def device(self) -> torch.device:
        return self.out.conv.weight.device

    def fused_eligible(self, x: torch.Tensor) -> bool:
        """Never: the model has no fused route."""
        return False

    def precision(self):
        """TF32 off in f32, nothing to set in bf16 (``UNet3D.precision``)."""
        if self.compute_dtype == torch.float32:
            return no_tf32()
        return contextlib.nullcontext()

    # -- cached per shape ------------------------------------------------
    def _plan(self, grid, shift: int, device) -> wa.WindowPlan:
        key = (tuple(grid), shift, device)
        if key not in self._plans:
            self._plans[key] = wa.window_plan(grid, (WINDOW,) * 3,
                                              (shift,) * 3, device,
                                              self.compute_dtype)
        return self._plans[key]

    def _instance_norm(self, x: torch.Tensor) -> torch.Tensor:
        """InstanceNorm3d without affine: one group per channel."""
        c = int(x.shape[-1])
        key = (c, x.device)
        if key not in self._ones:
            self._ones[key] = (torch.ones(c, device=x.device),
                               torch.zeros(c, device=x.device))
        scale, bias = self._ones[key]
        return group_norm(x, c, scale, bias, NORM_EPS)

    # -- the network -----------------------------------------------------
    def _stage(self, layer: BasicLayer, x: torch.Tensor, dtype):
        grid = tuple(int(v) for v in x.shape[1:4])
        for blk in layer.blocks:
            x = blk(x, self._plan(grid, blk.shift, x.device), dtype)
        return layer.downsample(x, dtype)

    def encode(self, x: torch.Tensor, dtype) -> List[torch.Tensor]:
        """The five layer-normed hidden states of ``swinViT``."""
        vit = self.swinViT
        h = _conv(x, vit.patch_embed.proj, dtype)
        hidden = [_layer_norm(h, None)]
        for layer in vit.stages():
            h = self._stage(layer, h, dtype)
            hidden.append(_layer_norm(h, None))
        return hidden

    def _forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        with span(self.spans, "swin_encoder", device=x.device):
            hidden = self.encode(x, dtype)
        norm = self._instance_norm
        enc0 = self.encoder1.layer(x, norm, dtype)
        enc1 = self.encoder2.layer(hidden[0], norm, dtype)
        enc2 = self.encoder3.layer(hidden[1], norm, dtype)
        enc3 = self.encoder4.layer(hidden[2], norm, dtype)
        dec4 = self.encoder10.layer(hidden[4], norm, dtype)
        dec3 = self.decoder5(dec4, hidden[3], norm, dtype)
        dec2 = self.decoder4(dec3, enc3, norm, dtype)
        dec1 = self.decoder3(dec2, enc2, norm, dtype)
        dec0 = self.decoder2(dec1, enc1, norm, dtype)
        out = self.decoder1(dec0, enc0, norm, dtype)
        return _conv(out, self.out.conv, dtype).float()

    def forward(
        self,
        x: torch.Tensor,
        train: bool = True,
        apply_final_activation: Optional[bool] = None,
        padded_output: bool = False,
        dropout_generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """``padded_output`` and ``dropout_generator`` are the protocol's
        and change nothing: the output is always 5-D, and there is no
        dropout."""
        if x.dim() != 5 or x.shape[-1] != self.in_channels:
            raise ValueError(
                f"expected (N, X, Y, Z, {self.in_channels}), got {tuple(x.shape)}")
        if any(int(e) % DIVISOR for e in x.shape[1:4]):
            raise ValueError(f"Swin UNETR takes extents that are multiples "
                             f"of {DIVISOR}, got {tuple(x.shape[1:4])}")
        if x.device != self.device:
            raise ValueError(f"input on {x.device}, model on {self.device}")
        with self.precision():
            out = self._forward(x.to(self.compute_dtype), self.compute_dtype)
        if apply_final_activation is None:
            apply_final_activation = not train
        if apply_final_activation:
            out = torch.softmax(out, -1)
        return out
