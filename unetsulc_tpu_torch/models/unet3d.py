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

**The spatial-parallel fused path** (:meth:`UNet3D.forward_sp`, the JAX
model with ``sp_axis='space'`` inside ``shard_map``, unet3d.py:817-958
there) runs the fused path on a list of X slabs, one per shard of a mesh
(:mod:`unetsulc_tpu_torch.parallel`), every layer in lockstep over the
shards: each fused unit fills every shard's halo, launches kernel A in
halo mode once per shard, adds the shards' stat sums and forms one global
GroupNorm affine. Level 0 runs on the slabs; the pooled level 1
(``sp_shard_middle``) and level 2 (``sp_shard_deep``, when the slab
splits twice) run sharded in the slab+E layout; the rest runs once on the
mesh's home device, on gathered pooled-size volumes
(:mod:`unetsulc_tpu_torch.parallel.sp_fused` has the plan). Same
parameters, same ``state_dict``.

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
from unetsulc_tpu_torch.parallel import sp_fused as sp


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

    @staticmethod
    def _sp_unit(x, conv: nn.Conv3d, norm: nn.GroupNorm,
                 packed: cf.PackedWeight, dtype, mid: bool) -> List[FusedVol]:
        """One fused unit on every shard (the JAX package's ``SplitConv3``
        with ``sp_axis`` and ``_block_pallas``'s psum, unet3d.py:211-357
        there): fill each input's halo (:func:`sp.ring_fill`, or
        :func:`sp.ring_fill_mid` in the slab+E layout), one halo-mode
        launch per shard, the shards' stat sums added on the home device
        into one affine over the global voxel count."""
        n = len(x)
        if isinstance(x[0], torch.Tensor):  # (1, S, Y, Z, cin) input slabs
            outs = [cf.conv3d_dense_entry(r, conv.weight.to(r.device),
                                          conv.bias.to(r.device), dtype,
                                          ring=True)
                    for r in sp.ring_planes_5d(x)]
            bufs, sums, g = [o[0] for o in outs], [o[1] for o in outs], outs[0][2]
        else:
            vols = [list(v) if isinstance(v, (tuple, list)) else [v] for v in x]
            g = vols[0][0].g
            fills = []  # per input: (buffers, halos, valids, valid_outs)
            for i in range(len(vols[0])):
                b = [v[i].buf for v in vols]
                if mid:
                    fills.append(sp.ring_fill_mid(b))
                else:
                    halos, valids = sp.ring_fill(b)
                    fills.append((b, halos, valids, [None] * n))
            bufs, sums = [], []
            for k in range(n):
                dev = vols[k][0].buf.device
                y, s = cf.fused_conv_block(
                    [f[0][k] for f in fills], [v.aff for v in vols[k]],
                    conv.weight.to(dev), conv.bias.to(dev), g, packed=packed,
                    halos=[f[1][k] for f in fills],
                    valids=[f[2][k] for f in fills], valid_out=fills[0][3][k])
                bufs.append(y)
                sums.append(s)
        home = bufs[0].device
        total = sum(t.to(home) for t in sums)
        # slab+E: each shard owns P = X-1 planes, the last one the global
        # trailing plane too; the unowned E copies are out of the sums
        count = (n * (g.X - 1) + 1) * g.Y * g.Z if mid else n * g.voxels
        aff = cf.gn_affine_from_sums(total, norm.weight, norm.bias,
                                     norm.num_groups, count)
        return [FusedVol(b, aff.to(b.device), g) for b in bufs]

    def fused_sp(self, x, dtype: torch.dtype, mid: bool) -> List[FusedVol]:
        """:meth:`fused` on every shard: ``x`` one input per shard (input
        slabs, volumes or (skip, upsampled) pairs); ``mid``: the slab+E
        layout."""
        x = self._sp_unit(x, self.conv1, self.norm1, self._packed1, dtype, mid)
        return self._sp_unit(x, self.conv2, self.norm2, self._packed2, dtype,
                             mid)

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

    def fused_sp(self, x: List[FusedVol], dtype: torch.dtype,
                 pool) -> List[FusedVol]:
        """A sharded encoder (unet3d.py:439-507 of the JAX package):
        ``pool`` pools the shards' volumes into the slab+E layout
        (:func:`sp.sp_pool_local` from level-0 slabs,
        :func:`sp.sp_pool_local_mid` from slab+E ones), or is None for
        encoder 0; the DoubleConv then runs sharded."""
        if pool is None:
            return self.double_conv.fused_sp(x, dtype, mid=False)
        bufs, g = pool([v.buf for v in x], [v.aff for v in x], x[0].g)
        return self.double_conv.fused_sp([FusedVol(b, None, g) for b in bufs],
                                         dtype, mid=True)

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

    def fused_sp(self, skip: List[FusedVol], x, dtype,
                 mid: bool) -> List[FusedVol]:
        """A sharded decoder (unet3d.py:604-661 of the JAX package): ``x``
        is the replicated deeper output, or the deeper sharded decoder's
        slab+E volumes, gathered first; each shard resizes it to its own
        rows of the skip's level (slab+E rows when ``mid``), keeps its
        affine pending, and the pair conv runs sharded."""
        if isinstance(x, list):
            x = sp_gather(x)
        gt = skip[0].g
        resize = sp.sp_resize_to_slab_mid if mid else sp.sp_resize_to_slab
        ups = resize(x.buf, x.g, gt, [v.buf.device for v in skip])
        pairs = [(v, FusedVol(u, x.aff.to(u.device), gt))
                 for v, u in zip(skip, ups)]
        return self.double_conv.fused_sp(pairs, dtype, mid)

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


def sp_gather(x: List[FusedVol]) -> FusedVol:
    """Sharded slab+E volumes -> the replicated volume on the home device,
    its affine still pending (``sp_mid_gather``)."""
    buf, g = sp.sp_mid_gather([v.buf for v in x], x[0].g)
    return FusedVol(buf, x[0].aff, g)


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
    the caller seeds (``train/step.py``).

    ``sp_shard_middle`` and ``sp_shard_deep`` shape :meth:`forward_sp`'s
    partition (the JAX model's fields of those names): shard the pooled
    level 1, and level 2 where the slab splits twice; neither changes the
    parameters."""

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
        sp_shard_middle: bool = True,
        sp_shard_deep: bool = True,
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
        self.sp_shard_middle = sp_shard_middle
        self.sp_shard_deep = sp_shard_deep
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

    def fused_config(self) -> bool:
        """Whether the model's configuration takes the fused path, for a
        batch-1 input of extents >= 4 (the static half of
        :meth:`fused_eligible`)."""
        return bool(
            self.fused_blocks
            and self.dropout == 0
            and self.conv_layer_order == "crg"
            and self.interpolate
            and self.in_channels <= 8
            and (self.compute_dtype == torch.bfloat16
                 or self.device.type == "cpu")
        )

    def fused_eligible(self, x: torch.Tensor) -> bool:
        """Whether ``x`` takes the fused path (module docstring)."""
        return (self.fused_config() and x.shape[0] == 1
                and min(x.shape[1:4]) >= 4)

    def precision(self):
        """The context the non-fused path runs in, backward included: TF32
        off in f32 (``Precision.HIGHEST``), nothing to set in bf16."""
        if self.compute_dtype == torch.float32:
            return cf.no_tf32()
        return contextlib.nullcontext()

    def _head(self, h: torch.Tensor) -> torch.Tensor:
        """The 1x1x1 chain as channel matmuls in the compute dtype, on h's
        device."""
        dt = self.compute_dtype
        for conv in self._head_convs():
            w = conv.weight.reshape(conv.out_channels, -1).t()
            h = torch.matmul(h, w.to(h.device, dt)) + conv.bias.to(h.device, dt)
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

    def forward_sp(
        self,
        xs: List[torch.Tensor],
        train: bool = True,
        apply_final_activation: Optional[bool] = None,
        padded_output: bool = False,
    ) -> List[torch.Tensor]:
        """The fused forward of one volume split along X into slabs, one
        per shard (``parallel.shard_x``): xs[k] (1, S, Y, Z, in_channels)
        on shard k's device, the first shard's device the model's. Returns
        each shard's output as :meth:`forward` returns it for its slab:
        (S+2, Y+2, Z+2, out_channels) with ``padded_output``, else (1, S,
        Y, Z, out_channels). The partition is the JAX model's under
        ``sp_axis`` (class docstring); slab+E levels need an even S, and
        level 2 is sharded when S % 4 == 0 and S/4 >= 4. Raises ValueError
        where the fused pipeline does not take the slabs (unet3d.py:906-914
        of the JAX package): batch > 1 per shard, dropout, another order,
        ``interpolate=False``, in_channels > 8, an extent < 4, f32 on CUDA,
        ``fused_blocks=False``."""
        if not xs or any(x.dim() != 5 or x.shape[-1] != self.in_channels
                         or x.shape[0] != xs[0].shape[0]
                         or x.shape[2:] != xs[0].shape[2:] for x in xs):
            raise ValueError("expected one (N, S, Y, Z, in_channels) slab "
                             "per shard, of one shape")
        if xs[0].device != self.device:
            raise ValueError(f"the first slab is on {xs[0].device}, the model "
                             f"on {self.device}")
        s = int(xs[0].shape[1])
        if not self.fused_eligible(xs[0]) or (self.sp_shard_middle and s % 2):
            raise ValueError(
                "spatial parallelism needs the fused pipeline: batch 1 per "
                "shard, dropout 0, 'crg', interpolate, in_channels <= 8, "
                "extents >= 4, bf16 on CUDA, fused_blocks, and an even slab "
                f"with sp_shard_middle; got slabs {tuple(xs[0].shape)} on "
                f"{xs[0].device}")
        dt = self.compute_dtype
        mid = self.sp_shard_middle
        deep = mid and self.sp_shard_deep and s % 4 == 0 and s // 4 >= 4
        e0, e1, e2, e3 = self.encoders
        d0, d1, d2 = self.decoders
        s0 = e0.fused_sp([x.to(dt) for x in xs], dt, None)
        if mid:
            s1 = e1.fused_sp(s0, dt, sp.sp_pool_local)
        else:
            buf, g = sp.sp_pool_gather([v.buf for v in s0],
                                       [v.aff for v in s0], s0[0].g)
            s1 = e1.double_conv.fused(FusedVol(buf, None, g), dt)
        if deep:
            s2 = e2.fused_sp(s1, dt, sp.sp_pool_local_mid)
        else:
            s2 = e2.fused(sp_gather(s1) if mid else s1, dt)
        v = e3.fused(sp_gather(s2) if deep else s2, dt)
        v = d0.fused_sp(s2, v, dt, mid=True) if deep else d0.fused(s2, v, dt)
        v = d1.fused_sp(s1, v, dt, mid=True) if mid else d1.fused(s1, v, dt)
        v = d2.fused_sp(s0, v, dt, mid=False)
        outs = []
        for u in v:
            h = u.buf if padded_output else cf.unpad_from_geom(u.buf, u.g)
            outs.append(self._head(cf.apply_affine(h, u.aff)))
        if apply_final_activation is None:
            apply_final_activation = not train
        if apply_final_activation:
            outs = [torch.sigmoid(o) if self.final_sigmoid
                    else torch.softmax(o, -1) for o in outs]
        return outs

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
