"""3D shifted-window attention (the Swin Transformer's W-MSA and SW-MSA as
MONAI's ``monai/networks/nets/swin_unetr.py`` computes them) on
channels-last token grids (B, D, H, W, C).

* :func:`window_sizes` — the window and the shift that a grid takes
  (MONAI's ``get_window_size``): an axis no longer than the window is one
  window along that axis, with no shift;
* :func:`window_partition` / :func:`window_reverse` — (B, Dp, Hp, Wp, C)
  <-> (B nW, N, C): windows in (b, d, h, w) order, tokens in (d, h, w)
  order within a window;
* :func:`relative_position_index` — (N, N) index into the (2w - 1)^3-row
  table of relative-position biases, for a window of w^3 tokens;
* :func:`shift_mask` — (nW, N, N) additive mask of the shifted windows:
  0 between tokens of one region of the rolled grid, -100 across regions
  (MONAI's ``compute_mask``);
* :class:`WindowPlan` — all of the above for one grid and one block,
  built once by :func:`window_plan` and kept by the caller;
* :func:`window_attention` — softmax(q k^T scale + bias + mask) v over the
  windows: on CUDA tensors through PyTorch's fused memory-efficient
  attention kernel (``scaled_dot_product_attention`` with the
  ``EFFICIENT_ATTENTION`` backend, asked for alone, so that a shape it does
  not take raises instead of running the math path), which takes the bias
  and the mask as its additive mask and gives the bias's gradient in its
  backward; on CPU tensors through :func:`window_attention_plain`.

Two MONAI behaviours are kept as they are. A window clipped to a smaller
grid (6^3 in a module whose window is 7^3) reads the first N rows and
columns of the module window's index (``relative_position_index[:n,
:n]``), not the index of its own window. The tokens that pad a grid to a
multiple of the window are zeros and take part in the attention unmasked.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

MASK_VALUE = -100.0

Triple = Tuple[int, int, int]


def window_sizes(grid: Sequence[int], window: Sequence[int],
                 shift: Sequence[int]) -> Tuple[Triple, Triple]:
    """(window, shift) of a grid: along an axis of at most the window's
    extent, the whole axis and no shift."""
    ws, ss = list(window), list(shift)
    for i, g in enumerate(grid):
        if g <= window[i]:
            ws[i], ss[i] = int(g), 0
    return tuple(ws), tuple(ss)


def padded_grid(grid: Sequence[int], window: Sequence[int]) -> Triple:
    return tuple(-(-int(g) // int(w)) * int(w) for g, w in zip(grid, window))


def window_partition(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """(B, Dp, Hp, Wp, C) -> (B nW, N, C)."""
    b, d, h, w, c = x.shape
    wd, wh, ww = window
    x = x.view(b, d // wd, wd, h // wh, wh, w // ww, ww, c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wd * wh * ww, c)


def window_reverse(windows: torch.Tensor, window: Sequence[int], b: int,
                   grid: Sequence[int]) -> torch.Tensor:
    """(B nW, N, C) -> (B, Dp, Hp, Wp, C), the inverse of
    :func:`window_partition`."""
    d, h, w = grid
    wd, wh, ww = window
    x = windows.view(b, d // wd, h // wh, w // ww, wd, wh, ww, -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


def relative_position_index(window: Sequence[int]) -> torch.Tensor:
    """(N, N) long: row ((di + wd - 1) (2wh - 1) + dj + wh - 1) (2ww - 1)
    + dk + ww - 1 of the bias table for tokens i, j of a window, (di, dj,
    dk) their coordinates' difference."""
    wd, wh, ww = window
    coords = torch.stack(torch.meshgrid(
        torch.arange(wd), torch.arange(wh), torch.arange(ww),
        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + torch.tensor([wd - 1, wh - 1, ww - 1])
    return (rel[..., 0] * (2 * wh - 1) * (2 * ww - 1)
            + rel[..., 1] * (2 * ww - 1) + rel[..., 2])


def shift_mask(grid: Sequence[int], window: Sequence[int],
               shift: Sequence[int]) -> torch.Tensor:
    """(nW, N, N) f32 of the padded ``grid`` rolled by -``shift``: 0 where
    two tokens of a window come from one region of the grid, -100
    elsewhere. The regions are MONAI's: per axis the slices [:-w],
    [-w:-s] and [-s:]."""
    region = torch.zeros((1, *grid, 1))
    cnt = 0
    cuts = [(slice(-w), slice(-w, -s), slice(-s, None))
            for w, s in zip(window, shift)]
    for a in cuts[0]:
        for b in cuts[1]:
            for c in cuts[2]:
                region[:, a, b, c, :] = cnt
                cnt += 1
    ids = window_partition(region, window).squeeze(-1)
    diff = ids[:, None, :] - ids[:, :, None]
    return torch.where(diff != 0, MASK_VALUE, 0.0)


@dataclasses.dataclass(frozen=True)
class WindowPlan:
    """One block's windows over one grid: the window and shift it takes,
    the padded grid, the bias table's rows for its (N, N) token pairs
    (``index``, flat), and the shift mask (nW, N, N) in the compute dtype,
    or None without a shift."""

    window: Triple
    shift: Triple
    padded: Triple
    index: torch.Tensor
    mask: Optional[torch.Tensor]

    @property
    def rolled(self) -> bool:
        return any(s > 0 for s in self.shift)


def window_plan(grid: Sequence[int], window: Sequence[int],
                shift: Sequence[int], device, dtype) -> WindowPlan:
    """The :class:`WindowPlan` of a block whose module has window
    ``window`` and shift ``shift`` (0 or half the window) on ``grid``."""
    ws, ss = window_sizes(grid, window, shift)
    padded = padded_grid(grid, ws)
    n = ws[0] * ws[1] * ws[2]
    index = relative_position_index(window)[:n, :n].reshape(-1)
    mask = None
    if any(s > 0 for s in ss):
        mask = shift_mask(padded, ws, ss).to(device=device, dtype=dtype)
    return WindowPlan(ws, ss, padded, index.to(device), mask)


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           additive: torch.Tensor,
                           scale: float) -> torch.Tensor:
    """softmax(q k^T scale + additive) v in f32, in q's dtype: q, k, v (W,
    H, N, d), ``additive`` broadcasting to (W, H, N, N)."""
    s = torch.matmul(q.float() * scale, k.float().transpose(-2, -1))
    p = torch.softmax(s + additive.float(), -1)
    return torch.matmul(p, v.float()).to(q.dtype)


def _sdpa_efficient(q, k, v, additive, scale):
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=additive,
                                              scale=scale)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, mask: Optional[torch.Tensor],
                     images: int, scale: float) -> torch.Tensor:
    """The attention of every window: q, k, v (B nW, H, N, d) in the
    compute dtype, ``bias`` (H, N, N) the relative-position biases (with
    autograd), ``mask`` (nW, N, N) or None, ``images`` = B. One launch per
    image, each with the (nW, H, N, N) additive mask that its windows
    share, so that the mask and its gradient are one image's size."""
    nw = q.shape[0] // images
    bias = bias.contiguous()  # the fused kernels read the mask's rows densely
    if mask is None:
        additive = bias[None].expand(nw, -1, -1, -1)
    else:
        additive = bias[None] + mask[:, None]
    attend = _sdpa_efficient if q.is_cuda else window_attention_plain
    outs = [attend(q[i * nw:(i + 1) * nw], k[i * nw:(i + 1) * nw],
                   v[i * nw:(i + 1) * nw], additive, scale)
            for i in range(images)]
    return outs[0] if images == 1 else torch.cat(outs)
