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

Spatial-parallel halo mode (``conv_shards``' ``halo``, ``valid_in``,
``valid_out`` and ``edge_outputs`` in the JAX package; the plumbing is
:mod:`unetsulc_tpu_torch.parallel.sp_fused`): a shard's buffer holds its
slab of the volume along X, and each input of :func:`fused_conv_block`
takes its two neighbour planes as separate operands ``halos[i]`` = (lo,
hi), (Yp, Zp, C) each or None at the global volume's edge, with the
plane validity ``valids[i]`` ((Xp,) f32): planes 0 and Xp-1 are read from
lo and hi where valid, and as 0 elsewhere. ``valid_out`` ((Xp,) f32)
marks the output planes this shard owns; the others are written as 0 and
left out of the sums. The backward returns the gradients of lo and hi,
which autograd routes back to the neighbours' buffers.

The dense entry conv stays plain PyTorch, as the JAX package leaves it to
XLA.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
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
    ring: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Geom]:
    """relu(conv3x3x3(x5) + bias) straight into buffer layout: the
    pipeline's entry conv (cin <= 8), as ``conv_pallas.conv3d_dense_entry``.

    The 27-tap stack of the zero-ringed input is contracted with the
    (27*cin, cout) weight matrix in ``dtype`` (a plain matmul: the JAX
    package leaves this to XLA too). The output is rounded to ``dtype``
    before the bias is added in ``dtype``, and the stat sums are taken from
    the rounded output in f32, as there. Returns (buf, sums (2, C), g).
    ``weight`` is (Cout, Cin, 3, 3, 3).

    ``ring`` (spatial parallel): x5's first and last X planes are the
    neighbours' halo planes (zeros at the global volume's edges, where a
    zero ring is the conv's padding); they take the ring's place, and the
    output and sums cover the (X-2)-plane slab between them."""
    _, X, Y, Z, cin = x5.shape
    if ring:
        g = make_geom(X - 2, Y, Z)
        p = F.pad(x5[0].to(dtype), (0, 0, 1, 1, 1, 1))
    else:
        g = make_geom(X, Y, Z)
        p = pad_to_geom(x5.to(dtype), g)
    X = g.X
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


def _contiguous_halo(halo):
    return None if halo is None else tuple(
        None if t is None else t.contiguous() for t in halo)


def conv_fwd(xs, affs, weight, bias, g: Geom, packed=None, halos=None,
             valids=None, valid_out=None):
    """Forward of :func:`fused_conv_block`: kernel A for CUDA tensors
    (bf16 only; in halo mode when ``valids`` is given),
    :func:`fused_conv_block_plain` for CPU tensors."""
    if xs[0].is_cuda:
        return kernels.conv3x3x3_fwd(
            [x.contiguous() for x in xs],
            [_kernel_affine(a, x) for x, a in zip(xs, affs)], weight,
            bias.float().contiguous(), packed,
            halos=None if halos is None else [_contiguous_halo(h) for h in halos],
            valids=valids, valid_out=valid_out,
        )
    return fused_conv_block_plain(xs, affs, weight, bias, g, halos, valids,
                                  valid_out)


def conv_dx(dconv, weight, cins, branch: int, aff, x, g: Geom, packed=None,
            halo=None, valid=None):
    """dx and d(affine) sums of input ``branch``: kernel C for CUDA tensors
    (``packed``: ``kernels.pack_conv_weights_dx``, packed here when None),
    :func:`conv3x3x3_dx_plain` for CPU tensors. Returns (dx, (2, C_b) f32
    sums (sum x * dxn, sum dxn)); in halo mode (``valid`` given; ``halo``
    the forward's (lo, hi)) (dx, sums, dlo, dhi)."""
    if dconv.is_cuda:
        if packed is None:
            packed = kernels.pack_conv_weights_dx(weight, cins, branch)
        return kernels.conv3x3x3_dx(dconv.contiguous(), _kernel_affine(aff, x),
                                    x.contiguous(), packed,
                                    post_halo=_contiguous_halo(halo),
                                    valid=valid)
    return conv3x3x3_dx_plain(dconv, weight, cins, branch, aff, x, g, halo,
                              valid)


def conv_wgrad(x, aff, dconv, g: Geom, halo=None, valid=None):
    """(27, C_b, Cout) f32 weight gradient of one input branch: kernel D
    for CUDA tensors (in halo mode when ``valid`` is given),
    :func:`conv3x3x3_wgrad_plain` for CPU tensors."""
    if x.is_cuda:
        return kernels.conv3x3x3_wgrad(x.contiguous(), _kernel_affine(aff, x),
                                       dconv.contiguous(),
                                       halo=_contiguous_halo(halo), valid=valid)
    return conv3x3x3_wgrad_plain(x, aff, dconv, g, halo, valid)


# per input branch, the Function's tensor arguments: x, aff, lo, hi, valid
_BRANCH = 5


class _FusedConvBlock(torch.autograd.Function):
    """The counterpart of ``conv_pallas.fused_conv_block``'s custom VJP:
    kernel A forward; backward per input branch, kernel C when the input,
    its affine or its halo planes need a gradient and kernel D when the
    weight does, so a frozen block launches nothing
    (``ctx.needs_input_grad``). Arguments after the bias: each branch's
    (x, aff, lo, hi, valid), the last three None outside halo mode."""

    @staticmethod
    def forward(ctx, g, packer, valid_out, weight, bias, *branches):
        bs = [branches[i:i + _BRANCH] for i in range(0, len(branches), _BRANCH)]
        xs, affs = [b[0] for b in bs], [b[1] for b in bs]
        halo = bs[0][4] is not None
        cins = [int(x.shape[3]) for x in xs]
        packed = None if packer is None else packer.get(weight, cins)
        y, sums = conv_fwd(
            xs, affs, weight, bias, g, packed,
            halos=[(b[2], b[3]) for b in bs] if halo else None,
            valids=[b[4] for b in bs] if halo else None, valid_out=valid_out)
        ctx.g, ctx.packer, ctx.cins = g, packer, cins
        ctx.save_for_backward(weight, y, *branches)
        return y, sums

    @staticmethod
    def backward(ctx, dy, dsums):
        weight, y, *branches = ctx.saved_tensors
        g, cins = ctx.g, ctx.cins
        # (g, packer, valid_out, weight, bias, then _BRANCH per branch)
        need = ctx.needs_input_grad
        # cotangent through ReLU and the stat sums (conv_pallas.py:1376-1387):
        # dconv = 1[y > 0] (dy + ds0 + 2 y ds1); y is 0 on the ring and on
        # the planes valid_out drops, so dconv is exactly 0 there, which
        # kernels C and D rely on
        yf = y.float()
        dconv = torch.where(yf > 0, dy.float() + dsums[0] + 2.0 * yf * dsums[1],
                            0.0).to(y.dtype)
        dbias = dconv.float().sum((0, 1, 2)) if need[4] else None
        grads = [None] * len(branches)
        dws = []
        for b in range(len(cins)):
            i = b * _BRANCH
            x, aff, lo, hi, valid = branches[i:i + _BRANCH]
            halo = (lo, hi) if valid is not None else None
            wants = need[5 + i:5 + i + 4]  # x, aff, lo, hi
            if any(wants):
                packed = (None if ctx.packer is None
                          else ctx.packer.get_dx(weight, cins, b))
                out = conv_dx(dconv, weight, cins, b, aff, x, g, packed, halo,
                              valid)
                for k, t in enumerate(out):
                    grads[i + k] = t if wants[k] else None
            if need[3]:
                dws.append(conv_wgrad(x, aff, dconv, g, halo, valid))
        dw = None
        if need[3]:
            # (27, Cin, Cout) taps -> (Cout, Cin, 3, 3, 3); rounded to the
            # compute dtype, as the JAX package's dW passes back through its
            # weight cast
            dw = torch.cat(dws, 1).permute(2, 1, 0).reshape(weight.shape)
            dw = dw.to(y.dtype).to(weight.dtype)
        return (None, None, None, dw, dbias, *grads)


def fused_conv_block(
    xs: Sequence[torch.Tensor],
    affs: Sequence[Optional[torch.Tensor]],
    weight: torch.Tensor,
    bias: torch.Tensor,
    g: Geom,
    packed: Optional["PackedWeight"] = None,
    halos=None,
    valids: Optional[Sequence[torch.Tensor]] = None,
    valid_out: Optional[torch.Tensor] = None,
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

    Halo mode (module docstring) when ``valids`` is given: ``halos[i]`` =
    (lo, hi) and ``valids[i]`` per input, ``valid_out`` optional; the
    sums are the shard's own, which the caller adds over the shards.

    CUDA tensors go to kernels A, C and D (bf16 only); CPU tensors to
    their plain versions."""
    if len(xs) not in (1, 2) or len(affs) != len(xs):
        raise ValueError("fused_conv_block takes one or two inputs with affines")
    halo = valids is not None
    if halo and (halos is None or len(halos) != len(xs) or len(valids) != len(xs)):
        raise ValueError("halo mode takes one (lo, hi) pair and one valid "
                         "vector per input")
    if valid_out is not None and not halo:
        raise ValueError("valid_out needs halo mode")
    branches = []
    for i, (x, aff) in enumerate(zip(xs, affs)):
        lo, hi = halos[i] if halo else (None, None)
        branches += [x, aff, lo, hi, valids[i] if halo else None]
    return _FusedConvBlock.apply(g, packed, valid_out, weight, bias, *branches)


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


_tf32_lock = threading.Lock()
_tf32_users = 0
_tf32_restore: Optional[contextlib.ExitStack] = None


@contextlib.contextmanager
def no_tf32():
    """f32 matmuls and convolutions in full f32 (no TF32), the plain
    versions' arithmetic.

    The flags are process-wide and fold threads overlap their contexts,
    so they are counted: the first context to enter (in any thread) turns
    TF32 off, and only the last one to leave restores the saved flags."""
    global _tf32_users, _tf32_restore
    with _tf32_lock:
        if _tf32_users == 0:
            stack = contextlib.ExitStack()
            stack.callback(setattr, torch.backends.cuda.matmul, "allow_tf32",
                           torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            stack.enter_context(
                torch.backends.cudnn.flags(enabled=True, allow_tf32=False))
            _tf32_restore = stack
        _tf32_users += 1
    try:
        yield
    finally:
        with _tf32_lock:
            _tf32_users -= 1
            if _tf32_users == 0:
                _tf32_restore.close()
                _tf32_restore = None


def _normalized(x, aff, mask, dtype):
    """mask * (a * x + b) in f32, rounded to ``dtype``: kernel A's prologue."""
    v = x.float() if aff is None else x.float() * aff[0] + aff[1]
    return torch.where(mask, v, 0.0).to(dtype)


def halo_filled(x: torch.Tensor, halo) -> torch.Tensor:
    """x with its planes 0 and Xp-1 replaced by ``halo`` = (lo, hi), zeros
    where a plane is None: the buffer a halo-mode kernel reads (the plain
    versions' form; the kernels read the planes where they lie)."""
    zero = x.new_zeros(x.shape[1:])
    lo, hi = (zero if t is None else t for t in halo)
    return torch.cat([lo[None], x[1:-1], hi[None]])


def halo_mask(g: Geom, valid: torch.Tensor) -> torch.Tensor:
    """(Xp, Yp, Zp, 1) bool: the (y, z) interior of every plane p with
    valid[p] != 0."""
    yz = torch.zeros((g.Yp, g.Zp), dtype=torch.bool, device=valid.device)
    yz[1:1 + g.Y, 1:1 + g.Z] = True
    return (valid != 0)[:, None, None, None] & yz[None, :, :, None]


def _read_mask(x, g: Geom, halo, valid):
    """(the buffer a conv reads, the mask it reads it under)."""
    if valid is None:
        return x, interior_mask(g, x.device)
    return halo_filled(x, halo), halo_mask(g, valid)


def fused_conv_block_plain(xs, affs, weight, bias, g: Geom, halos=None,
                           valids=None, valid_out=None):
    """Plain PyTorch version of the forward of :func:`fused_conv_block`
    (and of kernel A).

    Normalizes each input in f32 under the interior mask (in halo mode:
    its neighbour planes in place of the ring planes, each plane under its
    validity) and rounds it to the storage dtype, as the kernel's prologue
    does, then runs one f32 ``F.conv3d`` of the concatenation (TF32 off, so
    bf16 products are exact and only the summation order differs from the
    kernel); output planes where ``valid_out`` is 0 become 0 before the
    sums."""
    dtype = xs[0].dtype
    norm = []
    for i, (x, aff) in enumerate(zip(xs, affs)):
        xr, mask = _read_mask(x, g, None if halos is None else halos[i],
                              None if valids is None else valids[i])
        norm.append(_normalized(xr, aff, mask, dtype))
    xn = torch.cat(norm, -1).float().permute(3, 0, 1, 2)[None]
    w = weight.to(dtype).float()
    with no_tf32():
        out = F.conv3d(xn, w)  # valid conv over the ring-padded buffer
    out = torch.relu(out[0].permute(1, 2, 3, 0) + bias.float())
    if valid_out is not None:
        out = torch.where((valid_out[1:1 + g.X] != 0)[:, None, None, None],
                          out, 0.0)
    y = F.pad(out.to(dtype), (0, 0, 1, 1, 1, 1, 1, 1))
    return y, stat_sums(out)


def conv3x3x3_dx_plain(dconv, weight, cins, branch: int, aff, x, g: Geom,
                       halo=None, valid=None):
    """Plain PyTorch version of :func:`conv_dx` (and of kernel C).

    dxn = the f32 transposed conv of dconv's interior with the branch's
    weights (rounded to the storage dtype, as the kernel reads them; TF32
    off), then the cross-stats (sum f32(x) * dxn, sum dxn) over the
    interior and dx = bf16(dxn * a) with a zero ring.

    Halo mode (``valid`` given; ``halo`` the forward's (lo, hi)): dxn also
    at planes 0 and Xp-1, every plane weighed by ``valid`` (x's ring planes
    being lo and hi), as ``_fused_bwd``'s halo branch
    (conv_pallas.py:1405-1425); returns (dx with zero ring planes, sums,
    dlo, dhi), dlo and dhi the (Yp, Zp, C) dx of planes 0 and Xp-1."""
    dtype = x.dtype
    c0 = sum(int(c) for c in cins[:branch])
    wb = weight[:, c0:c0 + int(cins[branch])].to(dtype).float()
    d = unpad_from_geom(dconv, g)[0].float().permute(3, 0, 1, 2)[None]
    if valid is None:
        with no_tf32():
            dxn = F.conv_transpose3d(d, wb, padding=1)[0].permute(1, 2, 3, 0)
        xi = unpad_from_geom(x, g)[0].float()
    else:
        with no_tf32():  # all X+2 planes: padding 0 along X
            dxn = F.conv_transpose3d(d, wb, padding=(0, 1, 1))[0].permute(
                1, 2, 3, 0)
        dxn = torch.where((valid != 0)[:, None, None, None], dxn, 0.0)
        xi = halo_filled(x, halo)[:, 1:1 + g.Y, 1:1 + g.Z].float()
    sums = torch.stack([(xi * dxn).sum((0, 1, 2)), dxn.sum((0, 1, 2))])
    if aff is not None:
        dxn = dxn * aff[0].float()
    if valid is None:
        return F.pad(dxn.to(dtype), (0, 0, 1, 1, 1, 1, 1, 1)), sums
    full = F.pad(dxn.to(dtype), (0, 0, 1, 1, 1, 1))
    zero = torch.zeros_like(full[:1])
    return torch.cat([zero, full[1:-1], zero]), sums, full[0], full[-1]


def conv3x3x3_wgrad_plain(x, aff, dconv, g: Geom, halo=None, valid=None):
    """Plain PyTorch version of :func:`conv_wgrad` (and of kernel D): the
    explicit 27-tap contraction in f32, dW[tap] = xn[v + off(tap)]^T
    dconv[v] over the interior, with xn recomputed as kernel A's prologue
    (in halo mode from the neighbour planes under ``valid``; TF32 off)."""
    xr, mask = _read_mask(x, g, halo, valid)
    xn = _normalized(xr, aff, mask, x.dtype).float()
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
