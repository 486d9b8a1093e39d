"""GroupNorm with float32 statistics on channels-last tensors, differentiable.

Counterpart of ``group_norm`` in ``unetsulc_tpu/ops/groupnorm.py`` and of
the custom VJP ``_gn3`` of ``unetsulc_tpu/ops/groupnorm_pallas.py``: torch
``nn.GroupNorm`` semantics on (N, ..., C), per-sample statistics over
(voxels x channels-in-group) of the full volume (no mask), biased variance
``E[x^2] - E[x]^2`` in f32 whatever the input dtype, then the per-channel
affine; the output keeps x's dtype.

The tensor is viewed as (N, S, C). Four steps, each through one
dispatcher here (a CUDA tensor goes to its hand-written kernel in
:mod:`unetsulc_tpu_torch.kernels`, a CPU tensor to the plain PyTorch
version beside it; there is no other branch):

* :func:`gn_stats` — (mean_g, inv_g) (N, G) f32;
* :func:`gn_apply` — ``(x - mean_c) * (inv_c * scale) + bias``;
* :func:`gn_bwd_reduce` — dscale, dbias (C,) f32 and, per (sample, group),
  sum(dxhat) and sum(dxhat * xhat) with dxhat = g * scale;
* :func:`gn_bwd_dx` — ``dx = inv/D * (D*dxhat - sum(dxhat) - xhat *
  sum(dxhat*xhat))`` with D = S * C/G, in x's dtype.

The TPU package gates its kernel by whether a slab fits VMEM
(``use_pallas_for``); the CUDA kernels split the reduction across blocks
and take every size, so there is no gate.
"""

from __future__ import annotations

from typing import Tuple

import torch

from unetsulc_tpu_torch import kernels


def _per_channel(v: torch.Tensor, c: int) -> torch.Tensor:
    """(N, G) per-group values -> (N, 1, C) per channel."""
    return v.repeat_interleave(c // v.shape[1], 1)[:, None, :]


# ---------------------------------------------------------------------------
# plain versions (CPU tensors; the oracle of the kernels on the card)
# ---------------------------------------------------------------------------


def gn_stats_plain(x3: torch.Tensor, num_groups: int,
                   eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean_g, inv_g), each (N, G) f32, of the (N, S, C) slab."""
    n, s, c = x3.shape
    xf = x3.float()
    denom = float(s * (c // num_groups))
    ch_sum = xf.sum(1).view(n, num_groups, -1).sum(-1)
    ch_sq = (xf * xf).sum(1).view(n, num_groups, -1).sum(-1)
    mean = ch_sum / denom
    var = ch_sq / denom - mean * mean
    return mean, torch.rsqrt(var + eps)


def gn_apply_plain(x3, mean, inv, scale, bias) -> torch.Tensor:
    """(x - mean_c) * (inv_c * scale) + bias in f32, in x's dtype."""
    c = x3.shape[-1]
    out = (x3.float() - _per_channel(mean, c)) * (
        _per_channel(inv, c) * scale.float()) + bias.float()
    return out.to(x3.dtype)


def _xhat(x3, mean, inv):
    c = x3.shape[-1]
    return (x3.float() - _per_channel(mean, c)) * _per_channel(inv, c)


def gn_bwd_reduce_plain(x3, g3, mean, inv, scale):
    """(dscale (C,), dbias (C,), sum dxhat (N, G), sum dxhat*xhat (N, G)),
    all f32: the reductions of ``_gn3_bwd`` (groupnorm_pallas.py:111-140)."""
    n, _, c = x3.shape
    groups = mean.shape[1]
    xhat = _xhat(x3, mean, inv)
    gf = g3.float()
    dxhat = gf * scale.float()
    return ((gf * xhat).sum((0, 1)), gf.sum((0, 1)),
            dxhat.sum(1).view(n, groups, -1).sum(-1),
            (dxhat * xhat).sum(1).view(n, groups, -1).sum(-1))


def gn_bwd_dx_plain(x3, g3, mean, inv, scale, sdx, sdxx) -> torch.Tensor:
    """dx = inv/D * (D*dxhat - sum dxhat - xhat * sum dxhat*xhat), in x's
    dtype (groupnorm_pallas.py:133-134)."""
    _, s, c = x3.shape
    d = float(s * (c // mean.shape[1]))
    xhat = _xhat(x3, mean, inv)
    dxhat = g3.float() * scale.float()
    dx = _per_channel(inv, c) / d * (
        d * dxhat - _per_channel(sdx, c) - xhat * _per_channel(sdxx, c))
    return dx.to(x3.dtype)


# ---------------------------------------------------------------------------
# dispatchers: CUDA tensor -> kernel, CPU tensor -> plain version
# ---------------------------------------------------------------------------


def gn_stats(x3, num_groups: int, eps: float):
    if x3.is_cuda:
        return kernels.gn_stats(x3, num_groups, eps)
    return gn_stats_plain(x3, num_groups, eps)


def gn_apply(x3, mean, inv, scale, bias):
    if x3.is_cuda:
        return kernels.gn_apply(x3, mean, inv, scale.float().contiguous(),
                                bias.float().contiguous())
    return gn_apply_plain(x3, mean, inv, scale, bias)


def gn_bwd_reduce(x3, g3, mean, inv, scale):
    if x3.is_cuda:
        return kernels.gn_bwd_reduce(x3, g3, mean, inv,
                                     scale.float().contiguous())
    return gn_bwd_reduce_plain(x3, g3, mean, inv, scale)


def gn_bwd_dx(x3, g3, mean, inv, scale, sdx, sdxx):
    if x3.is_cuda:
        return kernels.gn_bwd_dx(x3, g3, mean, inv,
                                 scale.float().contiguous(), sdx, sdxx)
    return gn_bwd_dx_plain(x3, g3, mean, inv, scale, sdx, sdxx)


class GroupNormFn(torch.autograd.Function):
    """The counterpart of ``_gn3``'s custom VJP: forward :func:`gn_stats`
    and :func:`gn_apply`, saving (x, mean_g, inv_g); backward
    :func:`gn_bwd_reduce`, then :func:`gn_bwd_dx` when x needs a
    gradient."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups: int, eps: float):
        x3 = x.reshape(x.shape[0], -1, x.shape[-1]).contiguous()
        mean, inv = gn_stats(x3, num_groups, eps)
        out = gn_apply(x3, mean, inv, scale, bias)
        ctx.shape = x.shape
        ctx.save_for_backward(x3, scale, mean, inv)
        return out.view(x.shape)

    @staticmethod
    def backward(ctx, g):
        x3, scale, mean, inv = ctx.saved_tensors
        g3 = g.reshape(x3.shape).to(x3.dtype).contiguous()
        dscale, dbias, sdx, sdxx = gn_bwd_reduce(x3, g3, mean, inv, scale)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = gn_bwd_dx(x3, g3, mean, inv, scale, sdx, sdxx).view(ctx.shape)
        return (dx, dscale.to(scale.dtype) if ctx.needs_input_grad[1] else None,
                dbias.to(scale.dtype) if ctx.needs_input_grad[2] else None,
                None, None)


def group_norm(x: torch.Tensor, num_groups: int, scale: torch.Tensor,
               bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Channels-last GroupNorm. x: (N, ..., C) bf16 or f32; scale, bias:
    (C,) f32. Differentiable in all three."""
    c = x.shape[-1]
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    return GroupNormFn.apply(x, scale, bias, num_groups, eps)
