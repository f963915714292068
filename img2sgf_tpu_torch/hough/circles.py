"""Hough gradient circle detection, cv.HOUGH_GRADIENT semantics (port of the
main-path functions of img2sgf_tpu/hough/circles.py).

Every stage works on a pool of planes: images [P, H, W] and candidate lists
[P, K]. The XLA schedule devices of the JAX package (pair-shrink before
top-k, four planes per uint32, optimization barriers, lax.map/lax.cond
dead-chunk skipping, the counting top-k search) are replaced by the plainest
tensor code that gives the same output. The exact-vote rescore and the
radius histogram run through kernels K2 and K3 on the card
(hough/rescore_cuda.py, hough/radius_cuda.py, which also hold their plain
versions and the radius tables _hist10_tables and _hist10_scan).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..ops.common import shift2d
from .radius_cuda import radius_support_pool
from .rescore_cuda import exact_rescore

__all__ = [
    "centre_candidates", "circle_candidates", "circle_finalize",
    "circle_recentre", "circle_votes", "compact_candidates", "direction_bins",
    "direction_labels", "exact_rescore", "greedy_min_dist", "pixel_steps",
    "propose_from_acc", "provisional_ring", "radius_support_pool",
    "top_k_set_by_count", "vote_accumulator_pool_labels",
]

_INT32_MAX = 2 ** 31 - 1


def _cascade_tables(num_bins: int, min_r: int, max_r: int, seg: int = 5):
    """Static offset tables for the two-level cascade accumulator (verbatim
    from the JAX package): per bin, centred inner offsets round(j*u) for
    j in [-seg//2, seg//2] and outer offsets +-round(t_m*u) per segment."""
    n = max_r - min_r + 1
    assert n % seg == 0, "radius span must divide into whole segments"
    half = seg // 2
    inner, outer = [], []
    for d in range(num_bins):
        phi = d * math.pi / num_bins
        ux, uy = math.cos(phi), math.sin(phi)
        inner.append(
            [(int(np.round(j * uy)), int(np.round(j * ux)))
             for j in range(-half, half + 1)]
        )
        outs = []
        for m in range(n // seg):
            t = min_r + half + m * seg
            by, bx = int(np.round(t * uy)), int(np.round(t * ux))
            outs.append((by, bx))
            outs.append((-by, -bx))
        outer.append(outs)
    return inner, outer


# Gradient pairs (dx, dy) where the JAX package's float32 arctan2 on XLA:CPU
# rounds across a bin boundary, with its bin. Found by comparing it with the
# float64 angle over all 2041^2 Sobel pairs in [-1020, 1020]^2 (the nearest
# integer direction sits 2.5e-7 bin widths from a boundary, far above
# float64 error); tests/test_torch_circles.py re-checks every pair. Only the
# default 64 bins are tabulated: other counts have their own exceptions
# (48 bins: 22 pairs, 128 bins: 12).
_BIN_EXCEPTIONS = {64: (
    (-203, -904, 28), (-203, 904, 36), (203, -904, 36), (203, 904, 28),
    (904, -203, 60), (904, 203, 4),
)}


def direction_bins(dx, dy, num_bins: int):
    """Gradient direction quantized to [0, num_bins) over [0, pi): the bin
    the JAX package's round(atan2(dy, dx) / (pi / num_bins)) gives. Computed
    in float64 (device-independent for integer gradients) plus the float32
    exception table, so CPU and CUDA agree bit for bit."""
    if num_bins not in _BIN_EXCEPTIONS:
        raise ValueError(f"num_angle_bins={num_bins}: the port reproduces the "
                         f"reference's float32 bins for {sorted(_BIN_EXCEPTIONS)}")
    ang = torch.atan2(dy.to(torch.float64), dx.to(torch.float64))
    bins = torch.remainder(
        torch.round(ang / (math.pi / num_bins)).to(torch.int32), num_bins)
    for ex, ey, b in _BIN_EXCEPTIONS[num_bins]:
        bins = torch.where((dx == ex) & (dy == ey), torch.full_like(bins, b),
                           bins)
    return bins


def direction_labels(emask, dx, dy, num_bins: int):
    """Direction bin on edge pixels, the num_bins sentinel elsewhere (uint8)."""
    assert num_bins < 255
    return torch.where(emask, direction_bins(dx, dy, num_bins),
                       torch.full_like(dx, num_bins)).to(torch.uint8)


# (|d_major|, |d_minor|, |step|) where XLA:CPU's x * rsqrt(y) rewrite of the
# JAX package's rint(1024 * d / sqrt(dx^2 + dy^2)) lands on the other side
# of a .5 tie than IEEE float32 division (8 of 2041^2 pairs per component,
# found and re-checked exhaustively by tests/test_torch_circles.py).
_STEP_EXCEPTIONS = ((399, 79, 1004), (798, 158, 1004))


def pixel_steps(dx, dy):
    """Per-pixel fixed-point walk steps sx = cvRound(1024*dx/|d|), float32,
    as the JAX package computes them."""
    fx = dx.to(torch.float32)
    fy = dy.to(torch.float32)
    mag = torch.sqrt(fx * fx + fy * fy)
    safe = torch.clamp(mag, min=1e-20)
    sx = torch.round((1024.0 * fx) / safe).to(torch.int32)
    sy = torch.round((1024.0 * fy) / safe).to(torch.int32)
    ax, ay = dx.abs(), dy.abs()
    for major, minor, step in _STEP_EXCEPTIONS:
        sx = torch.where((ax == major) & (ay == minor),
                         torch.where(dx < 0, -step, step).to(torch.int32), sx)
        sy = torch.where((ay == major) & (ax == minor),
                         torch.where(dy < 0, -step, step).to(torch.int32), sy)
    return sx, sy


def vote_accumulator_pool_labels(labels, num_bins: int, min_r: int, max_r: int):
    """Approximate centre-vote accumulator over a pool of [P, H, W] direction
    labels (direction_labels): per bin, a partial plane of the `seg` inner
    shifts, sampled at the outer segment offsets. Exact integer sums, equal
    to the JAX package's vote_accumulator_cascade and its byte-packed pool
    version. Returns f32."""
    P, H, W = labels.shape
    inner, outer = _cascade_tables(num_bins, min_r, max_r)
    B = max_r
    pad = B + 3
    lab = torch.nn.functional.pad(labels.to(torch.int32),
                                  (pad, pad, pad, pad), value=num_bins)
    acc = torch.zeros((P, H, W), dtype=torch.int32, device=labels.device)
    for d in range(num_bins):
        e_d = (lab == d).to(torch.int32)
        part = None
        for (jy, jx) in inner[d]:
            y0, x0 = pad - B - jy, pad - B - jx
            t = e_d[:, y0:y0 + H + 2 * B, x0:x0 + W + 2 * B]
            part = t if part is None else part + t
        for (by, bx) in outer[d]:
            acc += part[:, B - by:B - by + H, B - bx:B - bx + W]
    return acc.to(torch.float32)


def _stable_argsort(x, descending: bool = False):
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    return torch.sort(x, dim=-1, stable=True, descending=descending).indices


def top_k_set_by_count(score, k: int):
    """The SET lax.top_k(score, k) keeps (ties toward the smaller index),
    returned in stream order with a valid prefix: (votes, idx, valid), each
    [..., k]. Live scores are positive, dead ones -1. One stable sort: the
    JAX package's sort path; its counting search selects the same set."""
    N = score.shape[-1]
    order = _stable_argsort(score, descending=True)[..., :k]
    livek = torch.gather(score, -1, order) > 0
    skey = torch.where(livek, order, torch.full_like(order, N))
    if skey.shape[-1] < k:
        fill = torch.full((*skey.shape[:-1], k - skey.shape[-1]), N,
                          dtype=skey.dtype, device=skey.device)
        skey = torch.cat([skey, fill], dim=-1)
    skey = torch.sort(skey, dim=-1).values
    ok = skey < N
    idx = skey.clamp(0, N - 1)
    return torch.gather(score, -1, idx), idx, ok


def _f32(x: float, dev):
    return torch.tensor(x, dtype=torch.float32, device=dev)


def _content(hw, H: int, W: int, ndim: int):
    """Content dims of a pool, shaped to broadcast over [P, ...] tensors of
    `ndim` dims: the canvas (H, W) without hw, else hw's [P] tensors. OpenCV
    scans the accumulator over [1, h-2] x [1, w-2] of the content block."""
    if hw is None:
        return H, W
    shape = (-1,) + (1,) * (ndim - 1)
    return hw[0].reshape(shape), hw[1].reshape(shape)


def centre_candidates(acc, acc_threshold: float, top_k: int,
                      margin: float | None = None,
                      select_min: float | None = None, hw=None):
    """The top_k accumulator 4-neighbour maxima > threshold of each plane
    of acc [P, H, W], as a set in stream order with a valid prefix.
    Returns (ys, xs, votes, valid, n_live[, n_margin]); border cells are
    excluded (OpenCV scans y, x in [1, size-2]; with hw=(hs, ws) [P] the
    size is each plane's content block)."""
    P, H, W = acc.shape
    dev = acc.device
    h, w = _content(hw, H, W, 3)
    ys_i = torch.arange(H, device=dev)[:, None]
    xs_i = torch.arange(W, device=dev)[None, :]
    interior = (ys_i >= 1) & (ys_i <= h - 2) & (xs_i >= 1) & (xs_i <= w - 2)
    is_max = (
        (acc > _f32(acc_threshold, dev))
        & (acc > shift2d(acc, 0, 1))
        & (acc >= shift2d(acc, 0, -1))
        & (acc > shift2d(acc, 1, 0))
        & (acc >= shift2d(acc, -1, 0))
        & interior
    )
    n_live = is_max.sum(dim=(1, 2), dtype=torch.int32)
    counts = (n_live,)
    if margin is not None:
        counts += ((is_max & (acc >= _f32(margin, dev))).sum(
            dim=(1, 2), dtype=torch.int32),)
    if select_min is not None:
        is_max = is_max & (acc >= _f32(select_min, dev))
    score = torch.where(is_max, acc, _f32(-1.0, dev)).reshape(P, -1)
    votes, flat, ok = top_k_set_by_count(score, top_k)
    valid = ok & (votes > 0)
    return (flat // W, flat % W, votes, valid) + counts


def propose_from_acc(acc, acc_threshold: float, top_k: int,
                     threshold_factor: float = 0.5,
                     margin_factor: float | None = None,
                     select_floor: float | None = None, hw=None):
    """Budget-dependent proposal selection: (ys, xs, valid) [P, top_k] and
    the exact margin-gated saturation flag sat [P] (more qualifying maxima
    than slots, with the top_k'th at or above margin_factor *
    acc_threshold; see the JAX package's propose_from_acc). hw=(hs, ws):
    per-plane content dims bounding the scan."""
    P, H, W = acc.shape
    floor = threshold_factor * acc_threshold
    margin = None
    if margin_factor is not None and margin_factor * acc_threshold > floor:
        margin = margin_factor * acc_threshold
    sel_min = None
    if select_floor is not None and select_floor > floor:
        sel_min = select_floor
    out = centre_candidates(acc, floor, top_k, margin=margin,
                            select_min=sel_min, hw=hw)
    ys, xs, _votes, valid, n_live = out[:5]
    sat = n_live > top_k
    if margin is not None:
        sat = sat & (out[5] >= top_k)
    return ys.clamp(0, H - 1), xs.clamp(0, W - 1), valid, sat


def circle_votes(emask, sx, sy, ys, xs, valid, min_r: int, max_r: int,
                 cells: int = 3):
    """Stage 2a: exact votes on the cells x cells patch around each
    proposal, [P, K, cells, cells] f32 (kernel K2 on the card)."""
    return exact_rescore(emask, sx, sy, ys, xs, valid, min_r, max_r,
                         cells=cells)


_CENTRE = np.array([i * 5 + j for i in (1, 2, 3) for j in (1, 2, 3)])


def circle_recentre(patch, ys, xs, valid, acc_threshold: float, H: int,
                    W: int, hw=None):
    """Stage 2b: every cell of each proposal's central 3x3 that passes
    OpenCV's candidate test on its exact 5x5 votes (> threshold, > left,
    >= right, > up, >= down, interior of the content block hw, else of the
    canvas). Returns (ys_c, xs_c, votes, ok), each [P, K*9]."""
    P, K, cells = patch.shape[0], patch.shape[1], patch.shape[2]
    if cells != 5:
        raise ValueError("the port's recentre takes 5x5 patches only")
    dev = patch.device
    flat = patch.reshape(P, K, 25)
    c = torch.from_numpy(_CENTRE).to(dev)
    v = flat[..., c]
    nms_ok = (
        (v > flat[..., c - 1])
        & (v >= flat[..., c + 1])
        & (v > flat[..., c - 5])
        & (v >= flat[..., c + 5])
    )
    offy = (c // 5 - 2).to(torch.int64)
    offx = (c % 5 - 2).to(torch.int64)
    cy = ys[..., None].long() + offy
    cx = xs[..., None].long() + offx
    h, w = _content(hw, H, W, 3)
    interior = (cy >= 1) & (cy <= h - 2) & (cx >= 1) & (cx <= w - 2)
    ok = valid[..., None] & nms_ok & (v > _f32(acc_threshold, dev)) & interior
    return (cy.clamp(0, H - 1).reshape(P, -1), cx.clamp(0, W - 1).reshape(P, -1),
            v.reshape(P, -1), ok.reshape(P, -1))


_RING = np.array([i * 5 + j for i in range(5) for j in range(5)
                  if i in (0, 4) or j in (0, 4)])


@functools.lru_cache(maxsize=4)
def _ring_neighbours(off):
    cols = []
    for c in _RING:
        i, j = divmod(int(c), 5)
        ni, nj = i + off[0], j + off[1]
        cols.append(ni * 5 + nj if 0 <= ni < 5 and 0 <= nj < 5 else -1)
    known = np.array([c >= 0 for c in cols])
    idx = np.array([max(c, 0) for c in cols])
    return known, idx


def provisional_ring(patch, ys, xs, valid, acc_threshold: float, H: int,
                     W: int, budget: int, hw=None):
    """Outer-ring (Chebyshev-2) cells of each 5x5 patch passing the partial
    OpenCV test (out-of-patch neighbours pass; interior of the content
    block hw, else of the canvas). Returns (ys_p, xs_p, valid_p)
    [P, budget] (the top-`budget` set by votes, stream order) and n_live
    [P], the count before truncation."""
    P, K = patch.shape[:2]
    dev = patch.device
    flat = patch.reshape(P, K, 25)
    minus1 = _f32(-1.0, dev)

    def nbr(off):
        known, idx = _ring_neighbours(off)
        vals = flat[..., torch.from_numpy(idx).to(dev)]
        return torch.where(torch.from_numpy(known).to(dev), vals, minus1)

    ring = torch.from_numpy(_RING).to(dev)
    v = flat[..., ring]
    ok = (
        (v > _f32(acc_threshold, dev))
        & (v > nbr((0, -1)))
        & (v >= nbr((0, 1)))
        & (v > nbr((-1, 0)))
        & (v >= nbr((1, 0)))
    )
    cy = ys[..., None].long() + (ring // 5 - 2)
    cx = xs[..., None].long() + (ring % 5 - 2)
    h, w = _content(hw, H, W, 3)
    interior = (cy >= 1) & (cy <= h - 2) & (cx >= 1) & (cx <= w - 2)
    ok = valid[..., None] & ok & interior
    score = torch.where(ok, v, minus1).reshape(P, -1)
    top, idx, live = top_k_set_by_count(score, budget)
    ys_p = torch.gather(cy.reshape(P, -1), 1, idx).clamp(0, H - 1)
    xs_p = torch.gather(cx.reshape(P, -1), 1, idx).clamp(0, W - 1)
    return ys_p, xs_p, live & (top > 0.0), ok.reshape(P, -1).sum(
        dim=1, dtype=torch.int32)


def _stream_select(live, budget: int):
    """Indices of the first `budget` live rows of each row of live [P, N],
    in stream order, and their validity."""
    order = _stable_argsort(~live)
    if order.shape[-1] < budget:
        fill = torch.zeros((order.shape[0], budget - order.shape[-1]),
                           dtype=order.dtype, device=order.device)
        order = torch.cat([order, fill], dim=-1)
    idx = order[:, :budget]
    total = live.sum(dim=1, dtype=torch.int32)
    ok = torch.arange(budget, device=live.device)[None, :] < total[:, None]
    return idx, ok


def _dup_of_sorted(ks):
    first = torch.zeros_like(ks[:, :1], dtype=torch.bool)
    return torch.cat([first, ks[:, 1:] == ks[:, :-1]], dim=1)


def compact_candidates(ys, xs, votes, valid, W: int, budget: int,
                       dedupe: bool = False, dedupe_first: bool = False):
    """Compact candidate streams [P, N] to a [P, budget] live-first prefix
    (see the JAX package for the two modes). Returns (ys, xs, votes, valid,
    sat): sat [P] flags that more than `budget` live rows existed."""
    big = _INT32_MAX
    g = torch.gather
    if dedupe_first:
        key = torch.where(valid, ys.long() * W + xs.long(), big)
        order = _stable_argsort(key)
        ks = g(key, 1, order)
        live = (ks < big) & ~_dup_of_sorted(ks)
        sat = live.sum(dim=1) > budget
        score = torch.where(live, g(votes, 1, order), _f32(-1.0, votes.device))
        top, sel2, okk = top_k_set_by_count(score, min(budget, score.shape[1]))
        sel = g(order, 1, sel2)
        return (g(ys, 1, sel), g(xs, 1, sel), g(votes, 1, sel),
                okk & (top > 0.0), sat)
    sat = valid.sum(dim=1) > budget
    b = min(budget, valid.shape[1])
    sel, ok = _stream_select(valid, b)
    ys, xs, votes, valid = g(ys, 1, sel), g(xs, 1, sel), g(votes, 1, sel), ok
    if not dedupe:
        return ys, xs, votes, valid, sat
    key = torch.where(valid, ys.long() * W + xs.long(), big)
    order = _stable_argsort(key)
    ks = g(key, 1, order)
    live = (ks < big) & ~_dup_of_sorted(ks)
    order2 = _stable_argsort(~live)
    sel2 = g(order, 1, order2)
    return (g(ys, 1, sel2), g(xs, 1, sel2), g(votes, 1, sel2),
            g(live, 1, order2), sat)


def circle_candidates(emask, sx, sy, ys, xs, valid, min_r: int, max_r: int,
                      acc_threshold: float, H: int, W: int,
                      prov_budget: int = 512, peak_budget: int | None = None,
                      dedupe_first: bool = False, hw=None):
    """Stages 2a-2c over a pool: 5x5 exact votes and multi-emission
    recentre, the +-2 ring verified by a 3x3 exact pass, and (peak_budget
    set) dedupe + compaction. hw=(hs, ws): per-plane content dims bounding
    the accumulator interior. Returns (ys_c, xs_c, votes, valid2, sat)."""
    patch = circle_votes(emask, sx, sy, ys, xs, valid, min_r, max_r, cells=5)
    ys_c, xs_c, votes_c, ok_c = circle_recentre(
        patch, ys, xs, valid, acc_threshold, H, W, hw=hw)
    ys_p, xs_p, valid_p, n_ring = provisional_ring(
        patch, ys, xs, valid, acc_threshold, H, W, prov_budget, hw=hw)
    patch3 = circle_votes(emask, sx, sy, ys_p, xs_p, valid_p, min_r, max_r,
                          cells=3)
    c = patch3[:, :, 1, 1]
    h, w = _content(hw, H, W, 2)
    ok_p = (
        valid_p
        & (c > _f32(acc_threshold, c.device))
        & (c > patch3[:, :, 1, 0])
        & (c >= patch3[:, :, 1, 2])
        & (c > patch3[:, :, 0, 1])
        & (c >= patch3[:, :, 2, 1])
        & (ys_p >= 1) & (ys_p <= h - 2) & (xs_p >= 1) & (xs_p <= w - 2)
    )
    ys_all = torch.cat([ys_c, ys_p], dim=1)
    xs_all = torch.cat([xs_c, xs_p], dim=1)
    votes_all = torch.cat([votes_c, c], dim=1)
    ok_all = torch.cat([ok_c, ok_p], dim=1)
    ring_sat = n_ring > prov_budget
    if peak_budget is None:
        return ys_all, xs_all, votes_all, ok_all, ring_sat
    ys_k, xs_k, votes_k, ok_k, over = compact_candidates(
        ys_all, xs_all, votes_all, ok_all, W, peak_budget, dedupe=True,
        dedupe_first=dedupe_first)
    return ys_k, xs_k, votes_k, ok_k, ring_sat | over


def greedy_min_dist(ys, xs, live, min_dist: float, max_out: int):
    """Sequential acceptance in the given order with centre spacing >=
    min_dist (cv2's overlap removal), over [P, K] candidate lists.

    A plain loop over the live prefix, vectorised across planes, run on the
    host in numpy float32 (the same arithmetic as the JAX package's
    fori_loop; coordinates are small integers, so every d^2 is exact).
    Acceptances past max_out stop blocking, as in the JAX package: they are
    truncated by the [max_out] output anyway. Returns accepted [P, K]."""
    dev = ys.device
    fy = ys.detach().cpu().numpy().astype(np.float32)
    fx = xs.detach().cpu().numpy().astype(np.float32)
    lv = live.detach().cpu().numpy()
    P, K = lv.shape
    md2 = np.float32(min_dist * min_dist)
    accepted = np.zeros((P, K), bool)
    far = np.float32(-(2.0 ** 30))
    ay = np.full((P, max_out), far, np.float32)
    ax = np.full((P, max_out), far, np.float32)
    cnt = np.zeros(P, np.int64)
    rows = np.arange(P)
    last = np.where(lv.any(axis=1), K - np.argmax(lv[:, ::-1], axis=1), 0)
    for i in range(int(last.max(initial=0))):
        ddy = ay - fy[:, i:i + 1]
        ddx = ax - fx[:, i:i + 1]
        take = lv[:, i] & ~((ddy * ddy + ddx * ddx) < md2).any(axis=1)
        store = take & (cnt < max_out)
        slot = np.minimum(cnt, max_out - 1)
        ay[rows[store], slot[store]] = fy[store, i]
        ax[rows[store], slot[store]] = fx[store, i]
        cnt += store
        accepted[:, i] = take
    return torch.from_numpy(accepted).to(dev)


def _lexsort(keys):
    """np.lexsort along the last dim (last key primary) by chained stable
    sorts, least significant key first."""
    order = _stable_argsort(keys[0])
    for k in keys[1:]:
        order = torch.gather(order, -1, _stable_argsort(torch.gather(k, -1, order)))
    return order


def circle_finalize(ys_c, xs_c, valid2, r_best, support, acc_threshold: float,
                    min_dist: float, max_out: int, packed_sort: bool = True):
    """Stage 3 (cv2 4.x/5.x): keep candidates with run support > param2,
    sort by (support desc, radius desc, cx asc, cy asc), greedy minDist
    removal. Returns (circles [P, max_out, 3] as (cx, cy, r) with OpenCV's
    +0.5 centre offset, valid [P, max_out]) in acceptance order."""
    dev = ys_c.device
    supported = valid2 & (support > _f32(acc_threshold, dev))
    g = torch.gather
    if packed_sort:
        # exact for max_r <= 44 (the caller's gate), see the JAX package
        k1 = torch.where(
            supported,
            support.to(torch.int32) * 8192
            + torch.round(r_best * 20.0).to(torch.int32),
            -1,
        )
        k2 = xs_c.to(torch.int32) * 65536 + ys_c.to(torch.int32)
        order = _lexsort((k2, -k1))
    else:
        s_key = torch.where(supported, support, _f32(-1.0, dev))
        order = _lexsort((ys_c, xs_c, -r_best, -s_key))
    ys_s = g(ys_c, 1, order)
    xs_s = g(xs_c, 1, order)
    r_s = g(r_best, 1, order)
    accepted = greedy_min_dist(ys_s, xs_s, g(supported, 1, order), min_dist,
                               max_out)
    keep = _stable_argsort(~accepted)[:, :max_out]
    out_valid = g(accepted, 1, keep)
    cx = g(xs_s, 1, keep).to(torch.float32) + 0.5
    cy = g(ys_s, 1, keep).to(torch.float32) + 0.5
    circles = torch.stack([cx, cy, g(r_s, 1, keep)], dim=-1)
    return torch.where(out_valid[..., None], circles, _f32(0.0, dev)), out_valid
