"""Shared small helpers for image ops: shifts, border pads, 3x3 dilation and
the canvas helpers of the shape-bucketed path, border_remap and region_mask
(port of img2sgf_tpu/ops/common.py).

Content dims (h, w) are Python ints, 0-d tensors, or int tensors over the
leading dims of the image they describe: [B] for a batch of images, [P] for
a pool of planes. They broadcast over any further leading dims (the colour
channels of a [B, C, H, W] stack)."""

from __future__ import annotations

import torch


def long_on(n, device):
    """Content dim n (a Python int or an int tensor) as an int64 tensor on
    device; a tensor already there is used as it is, with no copy."""
    if isinstance(n, torch.Tensor):
        return n.to(device=device, dtype=torch.int64)
    return torch.tensor(n, dtype=torch.int64, device=device)


def _lead(n, x):
    """Content dim n as an int64 tensor: 0-d for one dim, else shaped to
    broadcast over x's leading dims (x.shape[:-2]) with one trailing axis
    for the row or column."""
    n = long_on(n, x.device)
    if n.ndim == 0:
        return n
    return n.reshape(n.shape + (1,) * (x.ndim - 1 - n.ndim))


def border_remap(x, h, w, mode: str):
    """Emulate an op's virtual border inside a fixed-size canvas.

    x: [..., Hb, Wb] canvas whose top-left [h, w] block is real content.
    Rewrites the padding band so that any local op reading <= (Hb - h) px
    past the content edge sees what OpenCV's border mode would supply at
    native size: 'replicate' or 'reflect101'. Content cells are unchanged.
    """
    H, W = x.shape[-2], x.shape[-1]
    hh, ww = _lead(h, x), _lead(w, x)
    iy = torch.arange(H, device=x.device)
    ix = torch.arange(W, device=x.device)
    if mode == "replicate":
        ry = torch.minimum(iy, hh - 1)
        rx = torch.minimum(ix, ww - 1)
    elif mode == "reflect101":
        ry = torch.minimum(torch.where(iy < hh, iy, 2 * hh - 2 - iy).clamp(min=0),
                           hh - 1)
        rx = torch.minimum(torch.where(ix < ww, ix, 2 * ww - 2 - ix).clamp(min=0),
                           ww - 1)
    else:
        raise ValueError(mode)
    if ry.ndim == 1:
        return x.index_select(-2, ry).index_select(-1, rx)
    shape = x.shape
    x = x.gather(-2, ry.unsqueeze(-1).expand(shape))
    return x.gather(-1, rx.unsqueeze(-2).expand(shape))


def region_mask(shape2d, h, w, device=None):
    """Bool mask of the real-content block: [*h.shape, Hb, Wb] (h, w ints,
    or int tensors of one shape)."""
    Hb, Wb = shape2d
    h, w = long_on(h, device), long_on(w, device)
    ys = torch.arange(Hb, device=h.device)[:, None]
    xs = torch.arange(Wb, device=h.device)[None, :]
    return (ys < h[..., None, None]) & (xs < w[..., None, None])


def shift2d(x, dy: int, dx: int, fill=0):
    """Shift a [..., H, W] tensor by (dy, dx), filling vacated cells:
    out[y, x] = in[y - dy, x - dx]."""
    H, W = x.shape[-2], x.shape[-1]
    out = torch.full_like(x, fill)
    if abs(dy) >= H or abs(dx) >= W:
        return out
    out[..., max(dy, 0):H + min(dy, 0), max(dx, 0):W + min(dx, 0)] = \
        x[..., max(-dy, 0):H + min(-dy, 0), max(-dx, 0):W + min(-dx, 0)]
    return out


def _pad_index(x, idx_h, idx_w):
    return x.index_select(-2, idx_h).index_select(-1, idx_w)


def pad_replicate(x, n: int):
    """Replicate-pad the trailing two dims by n (BORDER_REPLICATE)."""
    H, W = x.shape[-2], x.shape[-1]
    ih = torch.arange(-n, H + n, device=x.device).clamp(0, H - 1)
    iw = torch.arange(-n, W + n, device=x.device).clamp(0, W - 1)
    return _pad_index(x, ih, iw)


def _reflect101(i, size: int):
    i = i.abs()
    return torch.where(i >= size, 2 * (size - 1) - i, i)


def pad_reflect101(x, n: int):
    """Reflect-101 pad (BORDER_REFLECT_101), like jnp.pad mode='reflect'."""
    H, W = x.shape[-2], x.shape[-1]
    ih = _reflect101(torch.arange(-n, H + n, device=x.device), H)
    iw = _reflect101(torch.arange(-n, W + n, device=x.device), W)
    return _pad_index(x, ih, iw)


def dilate8(x):
    """3x3 max (8-neighbourhood dilation) on [..., H, W]."""
    out = x
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            out = torch.maximum(out, shift2d(x, dy, dx))
    return out
