"""Circle erasure: blank each circle's bounding box, repaint a centre dot
(port of img2sgf_tpu/hough/erase.py, img2sgf.py:188-198).

The reference paints rect-then-dot per circle in order, so a later circle's
black box overpaints earlier circles' white dots: a dot pixel stays white
iff no later valid circle's box covers it. The box union is an exact
integer 2-D difference array here instead of the JAX package's outer
product, and the dots are scattered, so no float product is involved.
Everything runs over a batch of images at once with fixed shapes: dead
circles add 0 to the difference array and scatter their dots into a spare
slot, so nothing is compacted and nothing is read back to the host. The
"later box covers this dot" test splits the circle list into chunks: the
boxes of later chunks are counted per pixel by difference arrays, one layer
a chunk, and only the pairs within a chunk are tested one by one.
"""

from __future__ import annotations

import math

import torch

from ..ops.common import region_mask

_DOT = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0))


def _chunk(C, H, W):
    """Circles per chunk of the coverage test: about sqrt(H * W) / 2, where
    its two parts cost about the same, the pairwise test within a chunk
    (C * 5 * chunk tests an image) and the count images of the later chunks
    ((C / chunk) * H * W int32 cells an image, each written and summed)."""
    return max(1, min(C, math.isqrt(H * W) // 2))


def _later_counts(by0, by1, bx0, bx1, w, S, H, W):
    """[N, NB + 1, H + 1, W + 1] int32 for NB = C / S chunks of S circles:
    layer l counts, at each pixel, the boxes of weight 1 in chunks NB - l
    and after (layer 0 is empty, layer NB counts every box). Each box adds
    its four corners to the 2-D difference array of its chunk's layer; a
    cumulative sum over the layers and then over y and x gives the counts,
    all in exact integers."""
    N, C = w.shape
    NB = C // S
    layer = NB - torch.arange(C, device=w.device) // S  # chunk b -> NB - b
    base = layer * ((H + 1) * (W + 1))
    corners = torch.stack([by0 * (W + 1) + bx0, by0 * (W + 1) + bx1,
                           by1 * (W + 1) + bx0, by1 * (W + 1) + bx1], dim=-1)
    weights = torch.stack([w, -w, -w, w], dim=-1)
    diff = torch.zeros((N, (NB + 1) * (H + 1) * (W + 1)), dtype=torch.int32,
                       device=w.device)
    diff.scatter_add_(1, (base[:, None] + corners).reshape(N, -1),
                      weights.reshape(N, -1))
    return diff.view(N, NB + 1, H + 1, W + 1).cumsum(1, dtype=torch.int32) \
        .cumsum(2, dtype=torch.int32).cumsum(3, dtype=torch.int32)


def erase_circles(edges_u8, circles_xyr, valid, hw=None):
    """edges_u8: [..., H, W] uint8; circles_xyr: [..., C, 3] (cx, cy, r);
    valid: [..., C]; the leading dims are a batch. Returns uint8 [..., H, W].
    hw=(h, w): content dims inside a fixed canvas, ints or int tensors of
    the leading dims; the output is zero outside the content block, as
    cv.rectangle and cv.circle clip their painting to the image."""
    H, W = edges_u8.shape[-2:]
    C = circles_xyr.shape[-2]
    lead = edges_u8.shape[:-2]
    dev = edges_u8.device
    edges = edges_u8.reshape(-1, H, W)
    circ = circles_xyr.reshape(-1, C, 3)
    valid = valid.reshape(-1, C)
    N = edges.shape[0]
    S = _chunk(C, H, W)
    pad = -C % S
    if pad:  # dead circles at the end: they cover nothing and put no dot
        circ = torch.cat([circ, circ.new_zeros((N, pad, 3))], dim=1)
        valid = torch.cat([valid, valid.new_zeros((N, pad))], dim=1)
        C += pad
    xc, yc = circ[..., 0], circ[..., 1]
    r = circ[..., 2] + 2.0  # circle edges stick out past the bbox (img2sgf.py:193)
    x0, x1 = torch.round(xc - r), torch.round(xc + r)
    y0, y1 = torch.round(yc - r), torch.round(yc + r)

    # inclusive boxes clipped to the image, as half-open integer ranges, at
    # weight 1 for a live box and 0 for a dead circle or an empty box
    by0 = y0.clamp(0, H).long()
    by1 = (y1 + 1).clamp(0, H).long()
    bx0 = x0.clamp(0, W).long()
    bx1 = (x1 + 1).clamp(0, W).long()
    w = (valid & (by0 < by1) & (bx0 < bx1)).to(torch.int32)
    cnt = _later_counts(by0, by1, bx0, bx1, w, S, H, W)
    NB = C // S
    boxed = cnt[:, NB, :H, :W] > 0

    # a dot pixel of circle i stays white iff no later valid box covers it:
    # the boxes of later chunks are counted at the pixel (the layer of the
    # chunks after i's), those of i's own chunk tested pair by pair
    cxi, cyi = torch.round(xc), torch.round(yc)
    py = torch.stack([cyi + oy for oy, _ in _DOT], dim=-1)  # [N, C, 5]
    px = torch.stack([cxi + ox for _, ox in _DOT], dim=-1)
    inside = (py >= 0) & (py < H) & (px >= 0) & (px < W)
    qy, qx = py.long().clamp(0, H - 1), px.long().clamp(0, W - 1)
    layer = (NB - 1 - torch.arange(C, device=dev) // S)[:, None]  # [C, 1]
    at = (layer * (H + 1) + qy) * (W + 1) + qx
    covered = cnt.view(N, -1).gather(1, at.reshape(N, -1)).view(N, C, 5) > 0
    idx = torch.arange(S, device=dev)
    later = (idx[None, :] > idx[:, None])[:, None, :]  # [S (i), 1, S (j)]
    box = lambda t: t.view(N, NB, 1, 1, S)  # noqa: E731  [N, NB, 1, 1, S (j)]
    cy, cx = py.view(N, NB, S, 5, 1), px.view(N, NB, S, 5, 1)
    hit = (later & box(valid) & (cy >= box(y0)) & (cy <= box(y1))
           & (cx >= box(x0)) & (cx <= box(x1)))
    covered |= hit.any(dim=-1).view(N, C, 5)
    put = valid[..., None] & ~covered & inside
    # dots that are not put go to the spare slot H * W, cut off below
    flat = torch.where(put, py.long() * W + px.long(), H * W)
    dot = torch.zeros((N, H * W + 1), dtype=torch.bool, device=dev)
    dot.scatter_(1, flat.reshape(N, -1), True)
    dot = dot[:, :H * W].view(N, H, W)

    out = edges.masked_fill(boxed, 0).masked_fill(dot, 255)
    if hw is not None:
        out = out * region_mask((H, W), hw[0], hw[1], dev).reshape(-1, H, W)
    return out.reshape(*lead, H, W)
