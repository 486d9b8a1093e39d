"""The fused 'crg' pipeline's ops on a padded channels-last buffer.

Counterpart of the glue in ``unetsulc_tpu/ops/conv_pallas.py``. A volume
lives as a buffer ``(Xp, Yp, Zp, C)`` = ``(X+2, Y+2, Z+2, C)``: the
interior sits at offset (1, 1, 1) and the 1-voxel ring is exactly zero,
so it is the 3x3x3 conv's zero padding and, read as -inf, the padded max
pool's padding. (The JAX package's ``(K, Xp, plane, cs)`` shard layout,
its 128-lane shard widths and ``Zp % 16`` exist for the TPU and are not
carried over: ROADMAP.md "Keep the semantics, not the layout".)

GroupNorm is never materialized: a block's output is its raw post-ReLU
conv result plus the per-channel affine ``(2, C)`` f32 (row 0 = a,
row 1 = b, ``gn(y) = a*y + b``) that the next conv or pool applies lazily,
under the interior mask, while it reads the buffer.

Two differentiable ops (``torch.autograd.Function`` classes, the
counterparts of the JAX package's ``custom_vjp`` functions) run
hand-written CUDA kernels
(:mod:`unetsulc_tpu_torch.kernels`) forward and backward:

* :func:`fused_conv_block` — kernel A, ``conv3x3x3_fwd``, forward; per
  input branch kernel C, ``conv3x3x3_dx`` (dx and d(affine)), and kernel
  D, ``conv3x3x3_wgrad`` (dW), backward;
* :func:`max_pool_buf` — kernel B, ``max_pool_buf_fwd``, forward; kernel
  E, ``max_pool_buf_bwd``, backward.

Each kernel call goes through one dispatcher here (:func:`conv_fwd`,
:func:`conv_dx`, :func:`conv_wgrad`, :func:`pool_fwd`, :func:`pool_bwd`):
a CUDA tensor goes to the kernel, a CPU tensor to the plain PyTorch version
kept beside it (``*_plain``); there is no other dispatch.

The dense entry conv stays plain PyTorch, as the JAX package leaves it to
XLA.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from unetsulc_tpu_torch import kernels


@dataclasses.dataclass(frozen=True)
class Geom:
    """Interior extent (X, Y, Z) of a padded buffer (X+2, Y+2, Z+2, C)."""

    X: int
    Y: int
    Z: int

    @property
    def Xp(self) -> int:  # noqa: N802
        return self.X + 2

    @property
    def Yp(self) -> int:  # noqa: N802
        return self.Y + 2

    @property
    def Zp(self) -> int:  # noqa: N802
        return self.Z + 2

    @property
    def padded(self) -> Tuple[int, int, int]:
        return (self.Xp, self.Yp, self.Zp)

    @property
    def voxels(self) -> int:
        return self.X * self.Y * self.Z


def make_geom(x: int, y: int, z: int) -> Geom:
    return Geom(int(x), int(y), int(z))


def pool_geom(g: Geom) -> Geom:
    """Geometry after the torch-padded 2x2x2 / stride-2 max pool."""
    return make_geom(g.X // 2 + 1, g.Y // 2 + 1, g.Z // 2 + 1)


def pad_to_geom(x5: torch.Tensor, g: Geom) -> torch.Tensor:
    """(1, X, Y, Z, C) -> (Xp, Yp, Zp, C) with a zero ring."""
    if tuple(x5.shape[:4]) != (1, g.X, g.Y, g.Z):
        raise ValueError(f"volume {tuple(x5.shape)} does not match {g}")
    return F.pad(x5[0], (0, 0, 1, 1, 1, 1, 1, 1))


def unpad_from_geom(buf: torch.Tensor, g: Geom) -> torch.Tensor:
    """(Xp, Yp, Zp, C) -> (1, X, Y, Z, C) interior view."""
    return buf[1:1 + g.X, 1:1 + g.Y, 1:1 + g.Z][None]


def interior_mask(g: Geom, device) -> torch.Tensor:
    """(Xp, Yp, Zp, 1) bool: True on the interior, False on the ring."""
    m = torch.zeros(g.padded + (1,), dtype=torch.bool, device=device)
    m[1:1 + g.X, 1:1 + g.Y, 1:1 + g.Z] = True
    return m


def identity_affine(c: int, device) -> torch.Tensor:
    return torch.stack([
        torch.ones(c, dtype=torch.float32, device=device),
        torch.zeros(c, dtype=torch.float32, device=device),
    ])


def apply_affine(x: torch.Tensor, aff: Optional[torch.Tensor]) -> torch.Tensor:
    """Materialize a pending affine, in f32, cast back to x's dtype."""
    if aff is None:
        return x
    return (x.float() * aff[0] + aff[1]).to(x.dtype)


def stat_sums(y: torch.Tensor) -> torch.Tensor:
    """Per-channel (sum, sum of squares) of y in f32 -> (2, C)."""
    yf = y.float().reshape(-1, y.shape[-1])
    return torch.stack([yf.sum(0), (yf * yf).sum(0)])


def gn_affine_from_sums(
    sums: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    count: int,
    eps: float = 1e-5,
) -> torch.Tensor:
    """(2, C) per-channel sums over ``count`` voxels -> (2, C) GN affine.

    Matches ``conv_pallas.gn_affine_from_sums``: f32 biased variance over
    (voxels x channels-in-group), expressed per channel as
    ``gn(y) = a*y + b`` with a = inv*scale, b = bias - mean*a. The ring's
    zeros are not in ``count``: the sums are over the interior."""
    c = sums.shape[1]
    cg = c // num_groups
    denom = float(count * cg)
    g = sums.float().reshape(2, num_groups, cg).sum(-1)
    mean_g = g[0] / denom
    var_g = g[1] / denom - mean_g * mean_g
    inv_g = torch.rsqrt(var_g + eps)
    a = inv_g.repeat_interleave(cg) * scale.float()
    b = bias.float() - mean_g.repeat_interleave(cg) * a
    return torch.stack([a, b])


def conv3d_dense_entry(
    x5: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, Geom]:
    """relu(conv3x3x3(x5) + bias) straight into buffer layout: the
    pipeline's entry conv (cin <= 8), as ``conv_pallas.conv3d_dense_entry``.

    The 27-tap stack of the zero-ringed input is contracted with the
    (27*cin, cout) weight matrix in ``dtype`` (a plain matmul: the JAX
    package leaves this to XLA too). The output is rounded to ``dtype``
    before the bias is added in ``dtype``, and the stat sums are taken from
    the rounded output in f32, as there. Returns (buf, sums (2, C), g).
    ``weight`` is (Cout, Cin, 3, 3, 3)."""
    _, X, Y, Z, cin = x5.shape
    g = make_geom(X, Y, Z)
    p = pad_to_geom(x5.to(dtype), g)
    stack = torch.cat(
        [
            p[dx:dx + X, dy:dy + Y, dz:dz + Z]
            for dx in range(3) for dy in range(3) for dz in range(3)
        ],
        dim=-1,
    )  # (X, Y, Z, 27*cin), tap-major like the weight rows
    w = weight.permute(2, 3, 4, 1, 0).reshape(27 * cin, -1).to(dtype)
    y = torch.relu(torch.matmul(stack, w) + bias.to(dtype))
    buf = F.pad(y, (0, 0, 1, 1, 1, 1, 1, 1))
    return buf, stat_sums(y), g


# ---------------------------------------------------------------------------
# kernels A, C, D: the fused conv block and its gradients
# ---------------------------------------------------------------------------


def _kernel_affine(aff, x):
    """The (2, C) f32 affine a conv kernel reads for input ``x``: ``aff``,
    or the identity when there is none."""
    if aff is None:
        return identity_affine(int(x.shape[3]), x.device)
    return aff.float().contiguous()


def conv_fwd(xs, affs, weight, bias, g: Geom, packed=None):
    """Forward of :func:`fused_conv_block`: kernel A for CUDA tensors
    (bf16 only), :func:`fused_conv_block_plain` for CPU tensors."""
    if xs[0].is_cuda:
        return kernels.conv3x3x3_fwd(
            [x.contiguous() for x in xs],
            [_kernel_affine(a, x) for x, a in zip(xs, affs)], weight,
            bias.float().contiguous(), packed,
        )
    return fused_conv_block_plain(xs, affs, weight, bias, g)


def conv_dx(dconv, weight, cins, branch: int, aff, x, g: Geom, packed=None):
    """dx and d(affine) sums of input ``branch``: kernel C for CUDA tensors
    (``packed``: ``kernels.pack_conv_weights_dx``, packed here when None),
    :func:`conv3x3x3_dx_plain` for CPU tensors. Returns (dx, (2, C_b) f32
    sums (sum x * dxn, sum dxn))."""
    if dconv.is_cuda:
        if packed is None:
            packed = kernels.pack_conv_weights_dx(weight, cins, branch)
        return kernels.conv3x3x3_dx(dconv.contiguous(), _kernel_affine(aff, x),
                                    x.contiguous(), packed)
    return conv3x3x3_dx_plain(dconv, weight, cins, branch, aff, x, g)


def conv_wgrad(x, aff, dconv, g: Geom):
    """(27, C_b, Cout) f32 weight gradient of one input branch: kernel D
    for CUDA tensors, :func:`conv3x3x3_wgrad_plain` for CPU tensors."""
    if x.is_cuda:
        return kernels.conv3x3x3_wgrad(x.contiguous(), _kernel_affine(aff, x),
                                       dconv.contiguous())
    return conv3x3x3_wgrad_plain(x, aff, dconv, g)


class _FusedConvBlock(torch.autograd.Function):
    """The counterpart of ``conv_pallas.fused_conv_block``'s custom VJP:
    kernel A forward; backward per input branch, kernel C when the input
    or its affine needs a gradient and kernel D when the weight does, so a
    frozen block launches nothing (``ctx.needs_input_grad``)."""

    @staticmethod
    def forward(ctx, g, packer, weight, bias, x1, aff1, x2, aff2):
        xs = [x1] if x2 is None else [x1, x2]
        affs = [aff1] if x2 is None else [aff1, aff2]
        cins = [int(x.shape[3]) for x in xs]
        packed = None if packer is None else packer.get(weight, cins)
        y, sums = conv_fwd(xs, affs, weight, bias, g, packed)
        ctx.g, ctx.packer, ctx.cins = g, packer, cins
        ctx.save_for_backward(weight, x1, aff1, x2, aff2, y)
        return y, sums

    @staticmethod
    def backward(ctx, dy, dsums):
        weight, x1, aff1, x2, aff2, y = ctx.saved_tensors
        g, cins = ctx.g, ctx.cins
        need = ctx.needs_input_grad  # (g, packer, weight, bias, x1, ...)
        # cotangent through ReLU and the stat sums (conv_pallas.py:1376-1387):
        # dconv = 1[y > 0] (dy + ds0 + 2 y ds1); y is 0 on the ring, so
        # dconv is exactly 0 there, which kernels C and D rely on
        yf = y.float()
        dconv = torch.where(yf > 0, dy.float() + dsums[0] + 2.0 * yf * dsums[1],
                            0.0).to(y.dtype)
        dbias = dconv.float().sum((0, 1, 2)) if need[3] else None
        grads = [None, None, None, None]  # x1, aff1, x2, aff2
        dws = []
        for b, (x, aff) in enumerate(((x1, aff1), (x2, aff2))[:len(cins)]):
            if need[4 + 2 * b] or need[5 + 2 * b]:
                packed = (None if ctx.packer is None
                          else ctx.packer.get_dx(weight, cins, b))
                dx, sums = conv_dx(dconv, weight, cins, b, aff, x, g, packed)
                grads[2 * b] = dx if need[4 + 2 * b] else None
                grads[2 * b + 1] = sums if need[5 + 2 * b] else None
            if need[2]:
                dws.append(conv_wgrad(x, aff, dconv, g))
        dw = None
        if need[2]:
            # (27, Cin, Cout) taps -> (Cout, Cin, 3, 3, 3); rounded to the
            # compute dtype, as the JAX package's dW passes back through its
            # weight cast
            dw = torch.cat(dws, 1).permute(2, 1, 0).reshape(weight.shape)
            dw = dw.to(y.dtype).to(weight.dtype)
        return (None, None, dw, dbias, *grads)


def fused_conv_block(
    xs: Sequence[torch.Tensor],
    affs: Sequence[Optional[torch.Tensor]],
    weight: torch.Tensor,
    bias: torch.Tensor,
    g: Geom,
    packed: Optional["PackedWeight"] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """relu(conv3x3x3(concat_i(mask * (a_i * x_i + b_i)), W) + bias) with
    the per-channel stat sums of the f32 result, on padded buffers;
    differentiable in every tensor argument.

    xs: one or two (Xp, Yp, Zp, C_i) buffers of geometry ``g`` (two for a
    decoder's skip and upsampled inputs, never concatenated); affs: their
    pending (2, C_i) f32 affines or None; weight: (Cout, sum C_i, 3, 3, 3);
    bias: (Cout,); packed: the :class:`PackedWeight` cache of this conv,
    or None to pack the weight in each call. Returns (y (Xp, Yp, Zp, Cout)
    in the inputs' dtype with a zero ring, sums (2, Cout) f32) — the
    counterpart of ``conv_pallas.fused_conv_block``.

    CUDA tensors go to kernels A, C and D (bf16 only); CPU tensors to
    their plain versions."""
    if len(xs) not in (1, 2) or len(affs) != len(xs):
        raise ValueError("fused_conv_block takes one or two inputs with affines")
    x2, aff2 = (xs[1], affs[1]) if len(xs) == 2 else (None, None)
    return _FusedConvBlock.apply(g, packed, weight, bias, xs[0], affs[0], x2,
                                 aff2)


class PackedWeight:
    """One conv's weight as kernels A and C read it, packed at its first
    use and again only when the weight changes: a new storage, or an
    in-place update such as an optimizer step or ``load_state_dict`` (the
    tensor's version counter)."""

    def __init__(self):
        self._key = None
        self._packed = None
        self._dx = {}

    def _fresh(self, weight: torch.Tensor, cins: Sequence[int]) -> None:
        key = (weight.data_ptr(), weight._version, tuple(cins))
        if key != self._key:
            self._key, self._packed, self._dx = key, None, {}

    def get(self, weight: torch.Tensor, cins: Sequence[int]):
        """Kernel A's packed weight for a CUDA ``weight``; None on the CPU,
        where the plain version reads ``weight`` itself."""
        if not weight.is_cuda:
            return None
        self._fresh(weight, cins)
        if self._packed is None:
            with torch.no_grad():
                self._packed = kernels.pack_conv_weights(weight, cins)
        return self._packed

    def get_dx(self, weight: torch.Tensor, cins: Sequence[int], branch: int):
        """Kernel C's packed weight of input ``branch``; None on the CPU."""
        if not weight.is_cuda:
            return None
        self._fresh(weight, cins)
        if branch not in self._dx:
            with torch.no_grad():
                self._dx[branch] = kernels.pack_conv_weights_dx(
                    weight, cins, branch)
        return self._dx[branch]


@contextlib.contextmanager
def no_tf32():
    """f32 matmuls and convolutions in full f32 (no TF32), the plain
    versions' arithmetic."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _normalized(x, aff, mask, dtype):
    """mask * (a * x + b) in f32, rounded to ``dtype``: kernel A's prologue."""
    v = x.float() if aff is None else x.float() * aff[0] + aff[1]
    return torch.where(mask, v, 0.0).to(dtype)


def fused_conv_block_plain(xs, affs, weight, bias, g: Geom):
    """Plain PyTorch version of the forward of :func:`fused_conv_block`
    (and of kernel A).

    Normalizes each input in f32 under the interior mask and rounds it to
    the storage dtype, as the kernel's prologue does, then runs one f32
    ``F.conv3d`` of the concatenation (TF32 off, so bf16 products are
    exact and only the summation order differs from the kernel)."""
    dtype = xs[0].dtype
    mask = interior_mask(g, xs[0].device)
    norm = [_normalized(x, aff, mask, dtype) for x, aff in zip(xs, affs)]
    xn = torch.cat(norm, -1).float().permute(3, 0, 1, 2)[None]
    w = weight.to(dtype).float()
    with no_tf32():
        out = F.conv3d(xn, w)  # valid conv over the ring-padded buffer
    out = torch.relu(out[0].permute(1, 2, 3, 0) + bias.float())
    y = F.pad(out.to(dtype), (0, 0, 1, 1, 1, 1, 1, 1))
    return y, stat_sums(out)


def conv3x3x3_dx_plain(dconv, weight, cins, branch: int, aff, x, g: Geom):
    """Plain PyTorch version of :func:`conv_dx` (and of kernel C).

    dxn = the f32 transposed conv of dconv's interior with the branch's
    weights (rounded to the storage dtype, as the kernel reads them; TF32
    off), then the cross-stats (sum f32(x) * dxn, sum dxn) over the
    interior and dx = bf16(dxn * a) with a zero ring."""
    dtype = x.dtype
    c0 = sum(int(c) for c in cins[:branch])
    wb = weight[:, c0:c0 + int(cins[branch])].to(dtype).float()
    d = unpad_from_geom(dconv, g)[0].float().permute(3, 0, 1, 2)[None]
    with no_tf32():
        dxn = F.conv_transpose3d(d, wb, padding=1)[0].permute(1, 2, 3, 0)
    xi = unpad_from_geom(x, g)[0].float()
    sums = torch.stack([(xi * dxn).sum((0, 1, 2)), dxn.sum((0, 1, 2))])
    if aff is not None:
        dxn = dxn * aff[0].float()
    return F.pad(dxn.to(dtype), (0, 0, 1, 1, 1, 1, 1, 1)), sums


def conv3x3x3_wgrad_plain(x, aff, dconv, g: Geom):
    """Plain PyTorch version of :func:`conv_wgrad` (and of kernel D): the
    explicit 27-tap contraction in f32, dW[tap] = xn[v + off(tap)]^T
    dconv[v] over the interior, with xn recomputed as kernel A's prologue
    (TF32 off)."""
    xn = _normalized(x, aff, interior_mask(g, x.device), x.dtype).float()
    d = unpad_from_geom(dconv, g)[0].float().reshape(g.voxels, -1)
    taps = []
    with no_tf32():
        for dx in range(3):
            for dy in range(3):
                for dz in range(3):
                    xs = xn[dx:dx + g.X, dy:dy + g.Y, dz:dz + g.Z]
                    taps.append(xs.reshape(g.voxels, -1).t() @ d)
    return torch.stack(taps)


# ---------------------------------------------------------------------------
# kernels B, E: the buffer max pool and its gradient
# ---------------------------------------------------------------------------


def pool_fwd(buf, aff, g: Geom):
    """Forward of :func:`max_pool_buf`: kernel B for CUDA tensors (bf16
    only), :func:`max_pool_buf_plain` for CPU tensors."""
    if buf.is_cuda:
        ab = None if aff is None else aff.float().contiguous()
        return kernels.max_pool_buf_fwd(buf.contiguous(), ab)
    return max_pool_buf_plain(buf, aff, g)


def pool_bwd(buf, aff, out, cot, g: Geom):
    """(dbuf, dab or None) of :func:`max_pool_buf`: kernel E for CUDA
    tensors, :func:`max_pool_buf_bwd_plain` for CPU tensors."""
    if buf.is_cuda:
        ab = None if aff is None else aff.float().contiguous()
        return kernels.max_pool_buf_bwd(buf.contiguous(), ab,
                                        out.contiguous(),
                                        cot.to(out.dtype).contiguous())
    return max_pool_buf_bwd_plain(buf, aff, out, cot, g)


class _MaxPoolBuf(torch.autograd.Function):
    """The counterpart of ``conv_pallas.max_pool_buf``'s custom VJP: kernel
    B forward, kernel E backward (first-match routing, exact d(affine))."""

    @staticmethod
    def forward(ctx, g, buf, aff):
        out = pool_fwd(buf, aff, g)
        ctx.g = g
        ctx.save_for_backward(buf, aff, out)
        return out

    @staticmethod
    def backward(ctx, cot):
        buf, aff, out = ctx.saved_tensors
        dbuf, dab = pool_bwd(buf, aff, out, cot, ctx.g)
        return (None, dbuf if ctx.needs_input_grad[1] else None,
                dab if ctx.needs_input_grad[2] else None)


def max_pool_buf(
    buf: torch.Tensor, aff: Optional[torch.Tensor], g: Geom
) -> torch.Tensor:
    """Torch-padded MaxPool3d(2, 2, padding 1) of the normalized buffer,
    into a zero-ringed buffer of geometry ``pool_geom(g)``; differentiable
    in ``buf`` and ``aff``.

    Consumes the pending affine (max does not commute with it): values are
    bf16(f32(x)*a + b) in the storage dtype, pad positions count as -inf,
    and output voxel o reads padded coordinates 2o, 2o+1 per axis — the
    counterpart of ``conv_pallas.max_pool_buf``. The gradient goes to the
    first window position (x, y, z lexicographic) equal to the max, torch's
    tie rule. CUDA tensors go to kernels B and E (bf16 only); CPU tensors
    to their plain versions."""
    return _MaxPoolBuf.apply(g, buf, aff)


def _pool_windows(v, go: Geom):
    """(Xp, Yp, Zp, C) -> (OX, OY, OZ, 8, C): each pooled voxel's window,
    positions in (x, y, z) lexicographic order."""
    c = v.shape[-1]
    w = v[:2 * go.X, :2 * go.Y, :2 * go.Z].reshape(go.X, 2, go.Y, 2, go.Z, 2, c)
    return w.permute(0, 2, 4, 1, 3, 5, 6).reshape(go.X, go.Y, go.Z, 8, c)


def _unpool_windows(w, g: Geom, go: Geom):
    """Inverse of :func:`_pool_windows` into a zero (Xp, Yp, Zp, C)
    buffer."""
    c = w.shape[-1]
    v = w.reshape(go.X, go.Y, go.Z, 2, 2, 2, c).permute(0, 3, 1, 4, 2, 5, 6)
    out = w.new_zeros(g.padded + (c,))
    out[:2 * go.X, :2 * go.Y, :2 * go.Z] = v.reshape(
        2 * go.X, 2 * go.Y, 2 * go.Z, c)
    return out


def max_pool_buf_plain(buf, aff, g: Geom):
    """Plain PyTorch version of the forward of :func:`max_pool_buf` (and of
    kernel B)."""
    v = apply_affine(buf, aff)
    v = torch.where(interior_mask(g, buf.device), v, float("-inf"))
    p = F.max_pool3d(v.permute(3, 0, 1, 2)[None], 2, 2)[0].permute(1, 2, 3, 0)
    return F.pad(p, (0, 0, 1, 1, 1, 1, 1, 1))


def max_pool_buf_bwd_plain(buf, aff, out, cot, g: Geom):
    """Plain PyTorch version of :func:`pool_bwd` (and of kernel E): the 8
    window candidates, the first equal to the pooled max (``argmax`` of
    the match mask), the cotangent scattered there in f32, then dx =
    d * a in the storage dtype and dab = (sum f32(x) * d, sum d)."""
    go = pool_geom(g)
    mask = interior_mask(g, buf.device)
    v = torch.where(mask, apply_affine(buf, aff), float("-inf"))
    w = _pool_windows(v, go)  # (OX, OY, OZ, 8, C)
    o = unpad_from_geom(out, go)[0]
    first = (w == o[..., None, :]).to(torch.uint8).argmax(3, keepdim=True)
    d = torch.zeros(w.shape, dtype=torch.float32, device=buf.device).scatter_(
        3, first, unpad_from_geom(cot, go)[0].float()[..., None, :])
    dx = d if aff is None else d * aff[0].float()
    dbuf = torch.where(mask, _unpool_windows(dx.to(buf.dtype), g, go), 0.0)
    if aff is None:
        return dbuf.to(buf.dtype), None
    xw = _pool_windows(buf.float(), go)
    return dbuf.to(buf.dtype), torch.stack([(xw * d).sum((0, 1, 2, 3)),
                                            d.sum((0, 1, 2, 3))])
