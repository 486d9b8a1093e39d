"""The flagship 3D U-Net on the fused 'crg' pipeline, differentiable.

Counterpart of the fused-pipeline forward of
``UNet3D`` in ``unetsulc_tpu/models/unet3d.py`` (``pallas_blocks=True``):

* encoder ladder ``init -> 2i -> 4i -> 8i``, each a DoubleConv of 3x3x3
  convs in 'crg' order; the entry conv (in_channels <= 8) is the dense
  27-tap matmul, every other conv one launch of kernel A
  (:func:`~unetsulc_tpu_torch.ops.conv_fused.fused_conv_block`) that
  applies the previous GroupNorm lazily and returns the stat sums of the
  next one; its backward launches kernels C (dx) and D (dW) per input;
* MaxPool3d(2, 2, padding 1) on the buffer between encoders (kernel B;
  backward kernel E);
* three decoders that resize the raw buffer trilinearly to the skip's
  size, keep its GroupNorm pending, and feed skip and upsampled tensor to
  ONE launch of kernel A as two inputs (no concat);
* the 1x1x1 ``final_conv`` head (``num_conv`` convs with the reference's
  channel schedule) on the padded buffer, softmax/sigmoid in eval mode.

Parameter names are the torch ``state_dict`` keys of the reference
(``encoders.0.double_conv.conv1.weight``, ``...norm1.weight``,
``final_conv.weight`` or ``final_conv.<n>.weight``), so ``.mdsm`` files
load with ``strict=True``. Tensors at the public surface keep the JAX
package's channels-last (N, X, Y, Z, C) layout.

What the fused pipeline cannot take raises ``NotImplementedError`` naming
the ROADMAP item that ports it (the JAX package silently falls back to its
XLA path there).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
from torch import nn

from unetsulc_tpu_torch.device import resolve_device
from unetsulc_tpu_torch.ops import conv_fused as cf
from unetsulc_tpu_torch.ops.resize import resize_trilinear_buf

_NON_FUSED = "the non-fused path (ROADMAP.md §1, 'Non-fused ops')"
_BATCHED = ("batch > 1 in one forward (train/step.py runs a batch one "
            "volume at a time)")


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
    """Two fused 'crg' units. Encoder (in < out): conv1 in->out//2, conv2
    out//2->out; decoder (in >= out): conv1 in->out, conv2 out->out."""

    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__()
        mid = out_channels // 2 if in_channels < out_channels else out_channels
        self.conv1 = nn.Conv3d(in_channels, mid, 3, padding=1, device=device)
        self.norm1 = nn.GroupNorm(pick_num_groups(mid), mid, device=device)
        self.conv2 = nn.Conv3d(mid, out_channels, 3, padding=1, device=device)
        self.norm2 = nn.GroupNorm(
            pick_num_groups(out_channels), out_channels, device=device
        )
        self._packed1, self._packed2 = cf.PackedWeight(), cf.PackedWeight()

    @staticmethod
    def _unit(x, conv: nn.Conv3d, norm: nn.GroupNorm, packed: cf.PackedWeight,
              dtype) -> FusedVol:
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

    def forward(self, x, dtype: torch.dtype) -> FusedVol:
        x = self._unit(x, self.conv1, self.norm1, self._packed1, dtype)
        return self._unit(x, self.conv2, self.norm2, self._packed2, dtype)


class Encoder(nn.Module):
    def __init__(self, in_channels, out_channels, pool: bool, device=None):
        super().__init__()
        self.pool = pool
        self.double_conv = DoubleConv(in_channels, out_channels, device)

    def forward(self, x, dtype: torch.dtype) -> FusedVol:
        if self.pool:
            # the pool consumes the pending affine: max does not commute
            # with it
            x = FusedVol(cf.max_pool_buf(x.buf, x.aff, x.g), None,
                         cf.pool_geom(x.g))
        return self.double_conv(x, dtype)


class Decoder(nn.Module):
    def __init__(self, in_channels, out_channels, device=None):
        super().__init__()
        self.double_conv = DoubleConv(in_channels, out_channels, device)

    def forward(self, skip: FusedVol, x: FusedVol, dtype) -> FusedVol:
        # trilinear weights sum to 1 per output voxel, so the resize
        # commutes with the affine: resize the RAW buffer, keep it pending
        up = FusedVol(resize_trilinear_buf(x.buf, x.g, skip.g), x.aff, skip.g)
        return self.double_conv((skip, up), dtype)


class UNet3D(nn.Module):
    """Input (1, X, Y, Z, in_channels); output (1, X, Y, Z, out_channels)
    f32 logits (train) or probabilities (eval), or with ``padded_output``
    the (X+2, Y+2, Z+2, out_channels) padded form whose interior holds the
    same values (the labelling gather reads it directly).

    Parameters are initialized from ``seed`` with torch Conv3d's default
    distributions (kaiming-uniform weights, uniform biases; GroupNorm 1/0),
    drawn on the CPU so a seed gives the same weights on every device.

    The forward records autograd's graph when a parameter needs a
    gradient: the fused ops' backwards are the kernels of
    :mod:`~unetsulc_tpu_torch.ops.conv_fused`, the entry conv, the resizes,
    the GroupNorm affines and the head take PyTorch's own autograd.
    Inference callers run it under ``torch.no_grad()``."""

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
    ):
        super().__init__()
        device = resolve_device(device)
        if dropout > 0:
            raise NotImplementedError(f"dropout > 0 needs {_NON_FUSED}")
        if conv_layer_order != "crg":
            raise NotImplementedError(
                f"conv_layer_order {conv_layer_order!r} needs {_NON_FUSED}"
            )
        if not interpolate:
            raise NotImplementedError(
                f"interpolate=False (transposed-conv decoder) needs {_NON_FUSED}"
            )
        if in_channels > 8:
            raise NotImplementedError(
                f"in_channels > 8 (XLA-style entry conv) needs {_NON_FUSED}"
            )
        if device.type == "cuda" and compute_dtype != torch.bfloat16:
            raise NotImplementedError(
                f"{compute_dtype} compute on CUDA needs {_NON_FUSED}: the "
                "kernels take bfloat16"
            )
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.final_sigmoid = final_sigmoid
        self.compute_dtype = compute_dtype
        i = init_channel_number
        meta = torch.device("meta")
        self.encoders = nn.ModuleList(
            Encoder(cin, cout, pool=n != 0, device=meta)
            for n, (cin, cout) in enumerate(
                [(in_channels, i), (i, 2 * i), (2 * i, 4 * i), (4 * i, 8 * i)]
            )
        )
        self.decoders = nn.ModuleList(
            Decoder(cin, cout, device=meta)
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
            if isinstance(m, nn.Conv3d):
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

    def forward(
        self,
        x: torch.Tensor,
        train: bool = True,
        apply_final_activation: Optional[bool] = None,
        padded_output: bool = False,
    ) -> torch.Tensor:
        if x.dim() != 5 or x.shape[-1] != self.in_channels:
            raise ValueError(
                f"expected (N, X, Y, Z, {self.in_channels}), got {tuple(x.shape)}"
            )
        if x.shape[0] != 1:
            raise NotImplementedError(f"{_BATCHED} is not ported yet")
        if min(x.shape[1:4]) < 4:
            raise NotImplementedError(
                f"extents below 4 voxels need {_NON_FUSED}"
            )
        if x.device != self.device:
            raise ValueError(f"input on {x.device}, model on {self.device}")
        dt = self.compute_dtype
        v = x.to(dt)
        skips = []
        for enc in self.encoders:
            v = enc(v, dt)
            skips.insert(0, v)
        for dec, skip in zip(self.decoders, skips[1:]):
            v = dec(skip, v, dt)

        # head: materialize the last GroupNorm (f32, cast to the compute
        # dtype), then the 1x1x1 chain as channel matmuls
        h = v.buf if padded_output else cf.unpad_from_geom(v.buf, v.g)
        h = cf.apply_affine(h, v.aff)
        for conv in self._head_convs():
            w = conv.weight.reshape(conv.out_channels, -1).t().to(dt)
            h = torch.matmul(h, w) + conv.bias.to(dt)
        out = h.float()
        if apply_final_activation is None:
            apply_final_activation = not train
        if apply_final_activation:
            out = torch.sigmoid(out) if self.final_sigmoid else torch.softmax(out, -1)
        return out
