"""The flagship 3D U-Net, differentiable, on a fused and a non-fused path.

Counterpart of ``UNet3D`` in ``unetsulc_tpu/models/unet3d.py``: encoder
ladder ``init -> 2i -> 4i -> 8i`` of DoubleConvs (3x3x3 convs with ReLU
and GroupNorm in ``conv_layer_order``), MaxPool3d(2, 2, padding 1)
between encoders, three decoders that upsample to their skip's extent and
run a DoubleConv on (skip, upsampled) without a concat, and the 1x1x1
``final_conv`` head (``num_conv`` convs with the reference's channel
schedule); softmax/sigmoid in eval mode.

**The fused path** (the JAX package's ``pallas_blocks=True`` pipeline,
'crg' only) on a padded channels-last buffer:

* the entry conv (in_channels <= 8) is the dense 27-tap matmul, every
  other conv one launch of kernel A
  (:func:`~unetsulc_tpu_torch.ops.conv_fused.fused_conv_block`) that
  applies the previous GroupNorm lazily and returns the stat sums of the
  next one; its backward launches kernels C (dx) and D (dW) per input;
* the pool is kernel B (backward kernel E) on the buffer;
* decoders resize the raw buffer trilinearly to the skip's size, keep its
  GroupNorm pending, and feed skip and upsampled tensor to ONE launch of
  kernel A as two inputs;
* the head runs on the padded buffer (``padded_output`` returns it).

**The non-fused path** (the JAX package's XLA path) on channels-last
(N, X, Y, Z, C) tensors:

* each 3x3x3 conv is ``F.conv3d`` on the channels-last view; a decoder's
  (skip, upsampled) pair goes through two convs on the weight's input
  slices, summed in the compute dtype, then the bias is added;
* ReLU and GroupNorm in the DoubleConv's order (any order of 'c', 'r',
  'g' that starts with the conv); GroupNorm is
  :func:`~unetsulc_tpu_torch.ops.groupnorm.group_norm`, four hand-written
  kernels on the card;
* MaxPool3d(2, 2, padding 1) is ``F.max_pool3d``, whose gradient goes to
  the first maximum of a window, as JAX's ``select_and_scatter``;
* dropout after each encoder in train mode (:func:`dropout`);
* decoders upsample by ConvTranspose3d(k 3, stride 2, padding 1, output
  padding 1), cropped at the leading corner to the skip's extent
  (CONTRACTS.md §5 U2; ``interpolate=False``), or by the trilinear resize;
* the head runs on the 5-D tensor; ``padded_output`` has no effect.

In f32 the non-fused convs and matmuls run with TF32 off
(:func:`~unetsulc_tpu_torch.ops.conv_fused.no_tf32`, the counterpart of
``Precision.HIGHEST``).

Routing (:meth:`UNet3D.fused_eligible`) follows the JAX package's
``_pallas_eligible``: the fused path exactly for ``fused_blocks`` (its
``pallas_blocks``), batch 1, no dropout, 'crg', ``interpolate``,
in_channels <= 8 (the dense entry conv), every extent >= 4, and bf16
compute, or f32 on the CPU only (the kernels take bf16; JAX's fused f32
runs only where its kernels are emulated). JAX's ``_shard_widths_ok`` and
``_INTERPRET_SIZE_LIMIT`` are a TPU layout limit and a CPU test-speed
limit and have no counterpart.

Parameter names are the torch ``state_dict`` keys of the reference
(``encoders.0.double_conv.conv1.weight``, ``...norm1.weight``,
``decoders.0.upsample.weight`` with ``interpolate=False``,
``final_conv.weight`` or ``final_conv.<n>.weight``), so ``.mdsm`` files
load with ``strict=True``. Tensors at the public surface keep the JAX
package's channels-last (N, X, Y, Z, C) layout.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from unetsulc_tpu_torch.device import resolve_device
from unetsulc_tpu_torch.ops import conv_fused as cf
from unetsulc_tpu_torch.ops.groupnorm import group_norm
from unetsulc_tpu_torch.ops.resize import resize_trilinear, resize_trilinear_buf


def pick_num_groups(channels: int, preferred: int = 32) -> int:
    """Largest divisor of ``channels`` that is <= ``preferred``."""
    g = min(preferred, channels)
    while channels % g:
        g -= 1
    return g


def channel_schedule(init_channels: int, out_channels: int, num_conv: int):
    """Channel counts of a ``num_conv``-conv head (ref pattern_class.py:357-365)."""
    fac = (init_channels - out_channels) / num_conv
    chans = [init_channels - round(n * fac) for n in range(num_conv + 1)]
    chans[-1] = init_channels - round(num_conv * fac)
    return chans


def check_order(order: str) -> None:
    """A DoubleConv order: each of 'c', 'r', 'g' at most once, the conv
    first (a decoder's pair input needs it first, and GroupNorm comes after
    the conv: unet3d.py:361-369 of the JAX package)."""
    if (not order or order[0] != "c" or len(set(order)) != len(order)
            or not set(order) <= set("crg")):
        raise ValueError(f"unsupported conv_layer_order {order!r}: one conv "
                         "first, then at most one each of 'r' and 'g'")


def conv3x3x3(x, weight: torch.Tensor, bias: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """3x3x3 same-padding conv of a channels-last (N, X, Y, Z, C) tensor,
    or of a (skip, upsampled) pair without their concat: the convs of each
    input with its slice of the weight's input channels, summed in
    ``dtype``, then the bias in ``dtype`` (unet3d.py:187-209 of the JAX
    package)."""
    xs = list(x) if isinstance(x, (tuple, list)) else [x]
    w = weight.to(dtype)
    out, c0 = None, 0
    for v in xs:
        ci = int(v.shape[-1])
        y = F.conv3d(v.to(dtype).permute(0, 4, 1, 2, 3), w[:, c0:c0 + ci],
                     padding=1)
        out = y if out is None else out + y
        c0 += ci
    return out.permute(0, 2, 3, 4, 1) + bias.to(dtype)


def max_pool_3d(x: torch.Tensor) -> torch.Tensor:
    """MaxPool3d(2, 2, padding 1) on (N, X, Y, Z, C): extent d -> d//2 + 1,
    pads count as -inf."""
    return F.max_pool3d(x.permute(0, 4, 1, 2, 3), 2, 2, padding=1).permute(
        0, 2, 3, 4, 1)


def upsample_transpose(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """ConvTranspose3d(k 3, stride 2, padding 1, output padding 1) of a
    channels-last tensor: extent d -> 2d; ``weight`` in torch's (I, O, 3,
    3, 3) layout, the bias added in ``dtype`` (unet3d.py:510-558 of the
    JAX package computes it as the dilated conv of the flipped kernel)."""
    y = F.conv_transpose3d(x.to(dtype).permute(0, 4, 1, 2, 3),
                           weight.to(dtype), stride=2, padding=1,
                           output_padding=1)
    return y.permute(0, 2, 3, 4, 1) + bias.to(dtype)


def dropout(x: torch.Tensor, p: float, generator: torch.Generator) -> torch.Tensor:
    """flax ``Dropout`` semantics: keep where a uniform draw is >= p, kept
    values x / (1 - p), the rest 0. The draws come from ``generator``,
    which lives on x's device."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0)


@dataclasses.dataclass
class FusedVol:
    """A volume in the fused pipeline: the padded buffer of RAW post-ReLU
    conv outputs, its pending GroupNorm affine (2, C) f32 or None, and its
    geometry (the JAX package's ``PallasVol``)."""

    buf: torch.Tensor
    aff: Optional[torch.Tensor]
    g: cf.Geom

    @property
    def channels(self) -> int:
        return int(self.buf.shape[-1])


class DoubleConv(nn.Module):
    """Two conv units in ``order``. Encoder (in < out): conv1 in->out//2,
    conv2 out//2->out; decoder (in >= out): conv1 in->out, conv2 out->out.
    GroupNorm modules exist only when the order has a 'g'."""

    def __init__(self, in_channels: int, out_channels: int,
                 order: str = "crg", device=None):
        super().__init__()
        check_order(order)
        self.order = order
        mid = out_channels // 2 if in_channels < out_channels else out_channels
        self.conv1 = nn.Conv3d(in_channels, mid, 3, padding=1, device=device)
        if "g" in order:
            self.norm1 = nn.GroupNorm(pick_num_groups(mid), mid, device=device)
        self.conv2 = nn.Conv3d(mid, out_channels, 3, padding=1, device=device)
        if "g" in order:
            self.norm2 = nn.GroupNorm(
                pick_num_groups(out_channels), out_channels, device=device
            )
        self._packed1, self._packed2 = cf.PackedWeight(), cf.PackedWeight()

    @staticmethod
    def _fused_unit(x, conv: nn.Conv3d, norm: nn.GroupNorm,
                    packed: cf.PackedWeight, dtype) -> FusedVol:
        if isinstance(x, torch.Tensor):  # (1, X, Y, Z, cin) network input
            buf, sums, g = cf.conv3d_dense_entry(x, conv.weight, conv.bias, dtype)
        else:
            vols = list(x) if isinstance(x, (tuple, list)) else [x]
            g = vols[0].g
            buf, sums = cf.fused_conv_block(
                [v.buf for v in vols], [v.aff for v in vols], conv.weight,
                conv.bias, g, packed=packed,
            )
        aff = cf.gn_affine_from_sums(
            sums, norm.weight, norm.bias, norm.num_groups, g.voxels
        )
        return FusedVol(buf, aff, g)

    def fused(self, x, dtype: torch.dtype) -> FusedVol:
        x = self._fused_unit(x, self.conv1, self.norm1, self._packed1, dtype)
        return self._fused_unit(x, self.conv2, self.norm2, self._packed2, dtype)

    def _unit(self, x, conv: nn.Conv3d, norm: Optional[nn.GroupNorm], dtype):
        for op in self.order:
            if op == "c":
                x = conv3x3x3(x, conv.weight, conv.bias, dtype)
            elif op == "r":
                x = torch.relu(x)
            else:
                x = group_norm(x, norm.num_groups, norm.weight, norm.bias,
                               norm.eps)
        return x

    def nonfused(self, x, dtype: torch.dtype) -> torch.Tensor:
        x = self._unit(x, self.conv1, getattr(self, "norm1", None), dtype)
        return self._unit(x, self.conv2, getattr(self, "norm2", None), dtype)


class Encoder(nn.Module):
    def __init__(self, in_channels, out_channels, pool: bool, order="crg",
                 device=None):
        super().__init__()
        self.pool = pool
        self.double_conv = DoubleConv(in_channels, out_channels, order, device)

    def fused(self, x, dtype: torch.dtype) -> FusedVol:
        if self.pool:
            # the pool consumes the pending affine: max does not commute
            # with it
            x = FusedVol(cf.max_pool_buf(x.buf, x.aff, x.g), None,
                         cf.pool_geom(x.g))
        return self.double_conv.fused(x, dtype)

    def nonfused(self, x, dtype: torch.dtype) -> torch.Tensor:
        if self.pool:
            x = max_pool_3d(x)
        return self.double_conv.nonfused(x, dtype)


class Decoder(nn.Module):
    """``upsample`` (registered before ``double_conv``, as torch's) is the
    ConvTranspose3d of the ``interpolate=False`` decoder, on the deeper
    input's in_channels - out_channels channels."""

    def __init__(self, in_channels, out_channels, interpolate: bool = True,
                 order="crg", device=None):
        super().__init__()
        self.interpolate = interpolate
        if not interpolate:
            up = in_channels - out_channels
            self.upsample = nn.ConvTranspose3d(
                up, up, 3, stride=2, padding=1, output_padding=1, device=device)
        self.double_conv = DoubleConv(in_channels, out_channels, order, device)

    def fused(self, skip: FusedVol, x: FusedVol, dtype) -> FusedVol:
        # trilinear weights sum to 1 per output voxel, so the resize
        # commutes with the affine: resize the RAW buffer, keep it pending
        up = FusedVol(resize_trilinear_buf(x.buf, x.g, skip.g), x.aff, skip.g)
        return self.double_conv.fused((skip, up), dtype)

    def nonfused(self, skip: torch.Tensor, x: torch.Tensor,
                 dtype) -> torch.Tensor:
        tx, ty, tz = (int(v) for v in skip.shape[1:4])
        if self.interpolate:
            up = resize_trilinear(x, (tx, ty, tz))
        else:
            # 2 * (d // 2 + 1) >= d rows: keep the leading d (U2)
            up = upsample_transpose(x, self.upsample.weight,
                                    self.upsample.bias, dtype)
            up = up[:, :tx, :ty, :tz]
        return self.double_conv.nonfused((skip, up.to(skip.dtype)), dtype)


class UNet3D(nn.Module):
    """Input (N, X, Y, Z, in_channels); output (N, X, Y, Z, out_channels)
    f32 logits (train) or probabilities (eval). On the fused path (batch 1),
    ``padded_output`` gives the (X+2, Y+2, Z+2, out_channels) padded form
    whose interior holds the same values (the labelling gather reads it
    directly); the non-fused path always returns the 5-D form.

    Parameters are initialized from ``seed`` with torch's default
    distributions for Conv3d and ConvTranspose3d (kaiming-uniform weights,
    uniform biases; GroupNorm 1/0), drawn on the CPU so a seed gives the
    same weights on every device.

    The forward records autograd's graph when a parameter needs a
    gradient. Inference callers run it under ``torch.no_grad()``. Dropout
    (``dropout > 0``, train mode) draws from ``dropout_generator``, which
    the caller seeds (``train/step.py``)."""

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 2,
        final_sigmoid: bool = False,
        interpolate: bool = True,
        conv_layer_order: str = "crg",
        init_channel_number: int = 64,
        dropout: float = 0.0,
        num_conv: int = 1,
        compute_dtype: torch.dtype = torch.bfloat16,
        device="cuda",
        seed: int = 0,
        fused_blocks: bool = True,
    ):
        super().__init__()
        device = resolve_device(device)
        if compute_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"compute_dtype must be bfloat16 or float32, "
                             f"got {compute_dtype}")
        if not 0.0 <= dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got {dropout}")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.init_channel_number = init_channel_number
        self.final_sigmoid = final_sigmoid
        self.interpolate = interpolate
        self.conv_layer_order = conv_layer_order
        self.dropout = dropout
        self.compute_dtype = compute_dtype
        self.fused_blocks = fused_blocks
        i = init_channel_number
        meta = torch.device("meta")
        self.encoders = nn.ModuleList(
            Encoder(cin, cout, pool=n != 0, order=conv_layer_order, device=meta)
            for n, (cin, cout) in enumerate(
                [(in_channels, i), (i, 2 * i), (2 * i, 4 * i), (4 * i, 8 * i)]
            )
        )
        self.decoders = nn.ModuleList(
            Decoder(cin, cout, interpolate, conv_layer_order, device=meta)
            for cin, cout in [(12 * i, 4 * i), (6 * i, 2 * i), (3 * i, i)]
        )
        if num_conv <= 1:
            self.final_conv = nn.Conv3d(i, out_channels, 1, device=meta)
        else:
            chans = channel_schedule(i, out_channels, num_conv)
            self.final_conv = nn.Sequential(*(
                nn.Conv3d(chans[n], chans[n + 1], 1, device=meta)
                for n in range(num_conv)
            ))
        self.to_empty(device=device)
        self.init_parameters(torch.Generator().manual_seed(seed))

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
                # weight[0].numel() is torch's fan_in for both layouts
                bound = m.weight[0].numel() ** -0.5
                for p in (m.weight, m.bias):
                    p.copy_(torch.empty(p.shape).uniform_(
                        -bound, bound, generator=generator))
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

    @property
    def device(self) -> torch.device:
        return self._head_convs()[0].weight.device

    def _head_convs(self) -> List[nn.Conv3d]:
        if isinstance(self.final_conv, nn.Sequential):
            return list(self.final_conv)
        return [self.final_conv]

    def fused_eligible(self, x: torch.Tensor) -> bool:
        """Whether ``x`` takes the fused path (module docstring)."""
        return bool(
            self.fused_blocks
            and x.shape[0] == 1
            and self.dropout == 0
            and self.conv_layer_order == "crg"
            and self.interpolate
            and self.in_channels <= 8
            and min(x.shape[1:4]) >= 4
            and (self.compute_dtype == torch.bfloat16
                 or self.device.type == "cpu")
        )

    def precision(self):
        """The context the non-fused path runs in, backward included: TF32
        off in f32 (``Precision.HIGHEST``), nothing to set in bf16."""
        if self.compute_dtype == torch.float32:
            return cf.no_tf32()
        return contextlib.nullcontext()

    def _head(self, h: torch.Tensor) -> torch.Tensor:
        """The 1x1x1 chain as channel matmuls in the compute dtype."""
        dt = self.compute_dtype
        for conv in self._head_convs():
            w = conv.weight.reshape(conv.out_channels, -1).t().to(dt)
            h = torch.matmul(h, w) + conv.bias.to(dt)
        return h.float()

    def _forward_fused(self, x: torch.Tensor, padded_output: bool) -> torch.Tensor:
        dt = self.compute_dtype
        v = x.to(dt)
        skips = []
        for enc in self.encoders:
            v = enc.fused(v, dt)
            skips.insert(0, v)
        for dec, skip in zip(self.decoders, skips[1:]):
            v = dec.fused(skip, v, dt)
        # materialize the last GroupNorm (f32, cast to the compute dtype)
        h = v.buf if padded_output else cf.unpad_from_geom(v.buf, v.g)
        return self._head(cf.apply_affine(h, v.aff))

    def _forward_nonfused(self, x: torch.Tensor, train: bool,
                          dropout_generator) -> torch.Tensor:
        dt = self.compute_dtype
        drop = train and self.dropout > 0
        if drop and dropout_generator is None:
            raise ValueError("dropout > 0 in train mode needs a "
                             "dropout_generator")
        v = x.to(dt)
        skips = []
        for enc in self.encoders:
            v = enc.nonfused(v, dt)
            if drop:
                v = dropout(v, self.dropout, dropout_generator)
            skips.insert(0, v)
        for dec, skip in zip(self.decoders, skips[1:]):
            v = dec.nonfused(skip, v, dt)
        return self._head(v)

    def forward(
        self,
        x: torch.Tensor,
        train: bool = True,
        apply_final_activation: Optional[bool] = None,
        padded_output: bool = False,
        dropout_generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        if x.dim() != 5 or x.shape[-1] != self.in_channels:
            raise ValueError(
                f"expected (N, X, Y, Z, {self.in_channels}), got {tuple(x.shape)}"
            )
        if x.device != self.device:
            raise ValueError(f"input on {x.device}, model on {self.device}")
        if self.fused_eligible(x):
            out = self._forward_fused(x, padded_output)
        else:
            with self.precision():
                out = self._forward_nonfused(x, train, dropout_generator)
        if apply_final_activation is None:
            apply_final_activation = not train
        if apply_final_activation:
            out = torch.sigmoid(out) if self.final_sigmoid else torch.softmax(out, -1)
        return out
