"""Circle erasure: blank each circle's bounding box, repaint a centre dot
(port of img2sgf_tpu/hough/erase.py, img2sgf.py:188-198).

The reference paints rect-then-dot per circle in order, so a later circle's
black box overpaints earlier circles' white dots: a dot pixel stays white
iff no later valid circle's box covers it. The box union is an exact
integer 2-D difference array here instead of the JAX package's outer
product, and the dots are scattered, so no float product is involved.
"""

from __future__ import annotations

import torch

from ..ops.common import region_mask

_DOT = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0))


def erase_circles(edges_u8, circles_xyr, valid, hw=None):
    """edges_u8: [H, W] uint8; circles_xyr: [C, 3] (cx, cy, r); valid: [C].
    Returns uint8 [H, W]. hw=(h, w): content dims inside a fixed canvas;
    the output is zero outside the content block, as cv.rectangle and
    cv.circle clip their painting to the image."""
    H, W = edges_u8.shape
    dev = edges_u8.device
    circ = circles_xyr[valid]  # valid circles, in list order
    xc, yc = circ[:, 0], circ[:, 1]
    r = circ[:, 2] + 2.0  # circle edges stick out past the bbox (img2sgf.py:193)
    x0, x1 = torch.round(xc - r), torch.round(xc + r)
    y0, y1 = torch.round(yc - r), torch.round(yc + r)

    # inclusive boxes clipped to the image, as half-open integer ranges
    by0 = y0.clamp(0, H).long()
    by1 = (y1 + 1).clamp(0, H).long()
    bx0 = x0.clamp(0, W).long()
    bx1 = (x1 + 1).clamp(0, W).long()
    live = (by0 < by1) & (bx0 < bx1)
    diff = torch.zeros((H + 1, W + 1), dtype=torch.int32, device=dev)
    one = torch.ones_like(by0[live], dtype=torch.int32)
    diff.index_put_((by0[live], bx0[live]), one, accumulate=True)
    diff.index_put_((by0[live], bx1[live]), -one, accumulate=True)
    diff.index_put_((by1[live], bx0[live]), -one, accumulate=True)
    diff.index_put_((by1[live], bx1[live]), one, accumulate=True)
    boxed = diff.cumsum(0).cumsum(1)[:H, :W] > 0

    cxi, cyi = torch.round(xc), torch.round(yc)
    dy = torch.tensor([o[0] for o in _DOT], dtype=torch.float32, device=dev)
    dx = torch.tensor([o[1] for o in _DOT], dtype=torch.float32, device=dev)
    py = cyi[:, None] + dy[None, :]  # [C, 5]
    px = cxi[:, None] + dx[None, :]
    n = circ.shape[0]
    idx = torch.arange(n, device=dev)
    later = idx[None, None, :] > idx[:, None, None]
    covered = (
        later
        & (py[:, :, None] >= y0[None, None, :])
        & (py[:, :, None] <= y1[None, None, :])
        & (px[:, :, None] >= x0[None, None, :])
        & (px[:, :, None] <= x1[None, None, :])
    ).any(dim=2)  # [C, 5]
    inside = (py >= 0) & (py < H) & (px >= 0) & (px < W)
    put = ~covered & inside
    dot = torch.zeros((H, W), dtype=torch.bool, device=dev)
    dot[py[put].long(), px[put].long()] = True

    out = torch.where(boxed, torch.zeros_like(edges_u8), edges_u8)
    out = torch.where(dot, torch.full_like(edges_u8, 255), out)
    if hw is not None:
        out = out * region_mask((H, W), hw[0], hw[1], dev)
    return out
