"""Hough gradient circle detection, cv.HOUGH_GRADIENT semantics (port of
img2sgf_tpu/hough/circles.py).

Every stage works on a pool of planes: images [P, H, W] and candidate lists
[P, K]. The XLA schedule devices of the JAX package (pair-shrink before
top-k, four planes per uint32, optimization barriers, lax.map/lax.cond
dead-chunk skipping, the counting top-k search) are replaced by the plainest
tensor code that gives the same output. The exact-vote rescore and the
radius histogram run through kernels K2 and K3 on the card
(hough/rescore_cuda.py, hough/radius_cuda.py, which also hold their plain
versions and the radius tables _hist10_tables and _hist10_scan). The
centre-vote accumulator and the greedy minimum-distance selection, device
loops in the JAX package, run through kernels of their own
(hough/accumulator_cuda.py, which also holds the accumulators' plain
versions and offset tables, and hough/greedy_cuda.py).

The single-image functions of the JAX package's diagnostic tools
(circle_plane_state, circle_propose, vote_accumulator,
hough_circles_gradient) take one [H, W] plane and run the pool functions on
a pool of one. They keep the JAX signatures and defaults without the
use_pallas switch: on a CUDA plane the kernels always run.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .._devconst import device_cache
from ..ops.canny import canny_pool
from ..ops.common import border_remap, shift2d
from ..ops.sobel import sobel3
from . import _bin_exceptions as _bx
from .accumulator_cuda import (  # noqa: F401 (_cascade_tables: re-exported)
    _cascade_tables, check_labels, vote_accumulator_cascade_labels,
    vote_accumulator_cuda, vote_accumulator_offsets)
from .greedy_cuda import greedy_min_dist
from .radius_cuda import radius_support_pool
from .rescore_cuda import exact_rescore

__all__ = [
    "centre_candidates", "circle_candidates", "circle_finalize",
    "circle_plane_state", "circle_plane_state_pool", "circle_propose",
    "circle_recentre", "circle_votes", "compact_candidates", "direction_bins",
    "direction_labels", "exact_rescore", "greedy_min_dist",
    "hough_circles_gradient", "pixel_steps", "propose_from_acc",
    "provisional_ring", "radius_support_pool", "top_k_desc",
    "top_k_set_by_count", "vote_accumulator", "vote_accumulator_cascade_labels",
    "vote_accumulator_offsets", "vote_accumulator_pool",
    "vote_accumulator_pool_labels",
]

_INT32_MAX = 2 ** 31 - 1


@device_cache(maxsize=64)
def _bin_exceptions_on(num_bins: int, device: str):
    """The float32 bin table of one count on a device (_bin_exceptions):
    the eight ray bins [8] int32, and the other pairs as sorted keys
    dx * 2^16 + dy [M] int64 with their bins [M] int32 (None if M = 0).
    `device` is str(tensor.device), which names the card ("cuda:1")."""
    rays = torch.tensor(_bx.RAYS[num_bins], dtype=torch.int32, device=device)
    pairs = sorted((dx * 65536 + dy, b) for dx, dy, b in
                   _bx.PAIRS.get(num_bins, ()))
    if not pairs:
        return rays, None, None
    keys = torch.tensor([k for k, _ in pairs], dtype=torch.int64, device=device)
    vals = torch.tensor([b for _, b in pairs], dtype=torch.int32, device=device)
    return rays, keys, vals


def direction_bins(dx, dy, num_bins: int):
    """Gradient direction quantized to [0, num_bins) over [0, pi): the bin
    the JAX package's float32 round(atan2(dy, dx) / (pi / num_bins)) gives
    on XLA:CPU, for any 1 <= num_bins <= 254 and Sobel gradients (|dx|,
    |dy| <= 1020). Computed from the float64 angle, which depends on the
    device only far from a bin boundary, then corrected from the generated
    table _bin_exceptions: one bin for each of the eight rays dx = 0, dy = 0
    and |dx| = |dy| (exact ties for some counts) and a short list of other
    pairs where float32 rounds across a boundary. CPU and CUDA agree bit
    for bit."""
    if not 1 <= num_bins <= 254:
        raise ValueError(f"num_angle_bins={num_bins}: labels are uint8 with "
                         "a num_bins sentinel, so 1 <= num_bins <= 254")
    ang = torch.atan2(dy.to(torch.float64), dx.to(torch.float64))
    bins = torch.remainder(
        torch.round(ang / (math.pi / num_bins)).to(torch.int32), num_bins)
    rays, keys, vals = _bin_exceptions_on(num_bins, str(bins.device))
    on_axis, on_diag, on_anti = dx == 0, dx == dy, dx == -dy
    pos_x, neg_x = dx > 0, dx < 0
    masks = (on_axis & (dy > 0), on_axis & (dy < 0), (dy == 0) & pos_x,
             (dy == 0) & neg_x, on_diag & pos_x, on_diag & neg_x,
             on_anti & pos_x, on_anti & neg_x)
    for i, m in enumerate(masks):
        bins = torch.where(m, rays[i], bins)
    if keys is not None:
        key = dx.to(torch.int64) * 65536 + dy.to(torch.int64)
        pos = torch.searchsorted(keys, key).clamp(max=keys.numel() - 1)
        bins = torch.where(keys[pos] == key, vals[pos], bins)
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
    """Centre-vote accumulator over a pool of [P, H, W] direction labels:
    the cascade when the radius span divides into segments of 5, the exact
    per-offset accumulator otherwise, as the JAX package's vote_accumulator
    chooses. Returns f32. CPU labels take the plain versions; CUDA labels
    launch kernel A with the cascade's or the per-offset offset table
    (accumulator_cuda.vote_table)."""
    check_labels(labels, num_bins)
    dev = labels.device
    if dev.type == "cuda":
        return vote_accumulator_cuda(labels, num_bins, min_r, max_r)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    if (max_r - min_r + 1) % 5:
        return vote_accumulator_offsets(labels, num_bins, min_r, max_r)
    return vote_accumulator_cascade_labels(labels, num_bins, min_r, max_r)


def vote_accumulator_pool(emask, dx, dy, num_bins: int, min_r: int,
                          max_r: int):
    """Accumulators of a pool of [P, H, W] planes from their edge masks and
    Sobel gradients (the JAX package's vote_accumulator_pool)."""
    devs = {t.device for t in (emask, dx, dy)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {devs}")
    return vote_accumulator_pool_labels(
        direction_labels(emask, dx, dy, num_bins), num_bins, min_r, max_r)


def vote_accumulator(edge_mask, dx, dy, num_bins: int, min_r: int, max_r: int):
    """Centre-vote accumulator A [H, W] f32 of one plane: edge_mask [H, W]
    bool (Canny edges with a nonzero gradient), dx, dy int32 Sobel
    gradients (vote_accumulator_pool of a pool of one)."""
    return vote_accumulator_pool(edge_mask[None], dx[None], dy[None], num_bins,
                                 min_r, max_r)[0]


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


def top_k_desc(score, k: int):
    """lax.top_k semantics along the last dim: (values, indices) of the k
    largest scores in descending order, ties to the smaller index, from one
    stable descending sort (the JAX package's sort path, used there above
    4096; lax.top_k below gives the same rows). With fewer than k scores,
    all of them."""
    order = _stable_argsort(score, descending=True)[..., :k]
    return torch.gather(score, -1, order), order


def _content(hw, H: int, W: int, ndim: int):
    """Content dims of a pool, shaped to broadcast over [P, ...] tensors of
    `ndim` dims: the canvas (H, W) without hw, else hw's [P] tensors. OpenCV
    scans the accumulator over [1, h-2] x [1, w-2] of the content block."""
    if hw is None:
        return H, W
    shape = (-1,) + (1,) * (ndim - 1)
    return hw[0].reshape(shape), hw[1].reshape(shape)


def _block_candidates(acc, is_max, top_k: int, block: int,
                      margin: float | None):
    """centre_candidates' block > 1 path: the strongest maximum of each
    block x block tile (the first in the tile's scan order), tiles ranked by
    top_k_desc, so rows come in vote order. Counts are of live tiles."""
    P, H, W = acc.shape
    b = block
    Hb, Wb = -(-H // b), -(-W // b)
    s = torch.full((P, Hb * b, Wb * b), -1.0, dtype=acc.dtype,
                   device=acc.device)
    s[:, :H, :W] = torch.where(is_max, acc, -1.0)
    tiles = s.reshape(P, Hb, b, Wb, b).permute(0, 1, 3, 2, 4).reshape(
        P, Hb * Wb, b * b)
    bmax = tiles.amax(dim=2)
    barg = tiles.argmax(dim=2)  # the first max: scan order in the tile
    votes, bidx = top_k_desc(bmax, top_k)
    cell = torch.gather(barg, 1, bidx)
    ys = (bidx // Wb) * b + cell // b
    xs = (bidx % Wb) * b + cell % b
    counts = (bmax.gt(0).sum(dim=1, dtype=torch.int32),)
    if margin is not None:
        counts += ((bmax >= margin).sum(
            dim=1, dtype=torch.int32),)
    return (ys.clamp(max=H - 1), xs.clamp(max=W - 1), votes,
            votes > 0) + counts


def centre_candidates(acc, acc_threshold: float, top_k: int,
                      margin: float | None = None,
                      select_min: float | None = None, hw=None,
                      block: int = 1):
    """The top_k accumulator 4-neighbour maxima > threshold of each plane
    of acc [P, H, W], as a set in stream order with a valid prefix.
    Returns (ys, xs, votes, valid, n_live[, n_margin]); border cells are
    excluded (OpenCV scans y, x in [1, size-2]; with hw=(hs, ws) [P] the
    size is each plane's content block).

    block > 1: only the strongest maximum of each block x block tile
    competes, rows come in vote-descending order (ties to the smaller tile
    index), and the counts are of live tiles, after select_min
    (_block_candidates; the JAX package's block path)."""
    P, H, W = acc.shape
    dev = acc.device
    h, w = _content(hw, H, W, 3)
    ys_i = torch.arange(H, device=dev)[:, None]
    xs_i = torch.arange(W, device=dev)[None, :]
    interior = (ys_i >= 1) & (ys_i <= h - 2) & (xs_i >= 1) & (xs_i <= w - 2)
    is_max = (
        (acc > acc_threshold)
        & (acc > shift2d(acc, 0, 1))
        & (acc >= shift2d(acc, 0, -1))
        & (acc > shift2d(acc, 1, 0))
        & (acc >= shift2d(acc, -1, 0))
        & interior
    )
    if block > 1:
        if select_min is not None:
            is_max = is_max & (acc >= select_min)
        return _block_candidates(acc, is_max, top_k, block, margin)
    n_live = is_max.sum(dim=(1, 2), dtype=torch.int32)
    counts = (n_live,)
    if margin is not None:
        counts += ((is_max & (acc >= margin)).sum(
            dim=(1, 2), dtype=torch.int32),)
    if select_min is not None:
        is_max = is_max & (acc >= select_min)
    score = torch.where(is_max, acc, -1.0).reshape(P, -1)
    votes, flat, ok = top_k_set_by_count(score, top_k)
    valid = ok & (votes > 0)
    return (flat // W, flat % W, votes, valid) + counts


def propose_from_acc(acc, acc_threshold: float, top_k: int,
                     threshold_factor: float = 0.5,
                     margin_factor: float | None = None,
                     select_floor: float | None = None, hw=None,
                     block: int = 1):
    """Budget-dependent proposal selection: (ys, xs, valid) [P, top_k] and
    the exact margin-gated saturation flag sat [P] (more qualifying maxima
    than slots, with the top_k'th at or above margin_factor *
    acc_threshold; see the JAX package's propose_from_acc). hw=(hs, ws):
    per-plane content dims bounding the scan. block > 1: one maximum per
    tile, in vote order, with fewer than top_k rows when the planes have
    fewer tiles (centre_candidates)."""
    P, H, W = acc.shape
    floor = threshold_factor * acc_threshold
    margin = None
    if margin_factor is not None and margin_factor * acc_threshold > floor:
        margin = margin_factor * acc_threshold
    sel_min = None
    if select_floor is not None and select_floor > floor:
        sel_min = select_floor
    out = centre_candidates(acc, floor, top_k, margin=margin,
                            select_min=sel_min, hw=hw, block=block)
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


@device_cache(maxsize=16)
def _centre_on(device: str):
    """_CENTRE on a device, uploaded once per card."""
    return torch.from_numpy(_CENTRE).to(device)


def circle_recentre(patch, ys, xs, valid, acc_threshold: float, H: int,
                    W: int, hw=None):
    """Stage 2b: every cell of each proposal's central 3x3 that passes
    OpenCV's candidate test on its exact 5x5 votes (> threshold, > left,
    >= right, > up, >= down, interior of the content block hw, else of the
    canvas). Returns (ys_c, xs_c, votes, ok), each [P, K*9].

    A 3x3 patch takes the JAX package's legacy path, which the diagnostic
    tools use: the patch's best cell (the first maximum), tested against
    its in-patch neighbours (an out-of-patch neighbour passes at -1), with
    no interior test; each [P, K]."""
    P, K, cells = patch.shape[0], patch.shape[1], patch.shape[2]
    if cells == 3:
        return _recentre_argmax(patch, ys, xs, valid, acc_threshold, H, W)
    if cells != 5:
        raise ValueError("recentre takes 3x3 or 5x5 patches")
    dev = patch.device
    flat = patch.reshape(P, K, 25)
    c = _centre_on(str(dev))
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
    ok = valid[..., None] & nms_ok & (v > acc_threshold) & interior
    return (cy.clamp(0, H - 1).reshape(P, -1), cx.clamp(0, W - 1).reshape(P, -1),
            v.reshape(P, -1), ok.reshape(P, -1))


def _recentre_argmax(patch, ys, xs, valid, acc_threshold: float, H: int,
                     W: int):
    """circle_recentre of 3x3 patches [P, K, 3, 3]: (ys_c, xs_c, votes, ok),
    each [P, K]."""
    P, K = patch.shape[:2]
    flat = patch.reshape(P, K, 9)
    best = flat.argmax(dim=2)  # the first maximum
    votes = torch.gather(flat, 2, best[..., None])[..., 0]
    py, px = best // 3, best % 3
    minus1 = -1.0

    def nbr(dy, dx):
        yy, xx = py + dy, px + dx
        inside = (yy >= 0) & (yy < 3) & (xx >= 0) & (xx < 3)
        idx = yy.clamp(0, 2) * 3 + xx.clamp(0, 2)
        return torch.where(inside, torch.gather(flat, 2, idx[..., None])[..., 0],
                           minus1)

    nms_ok = ((votes > nbr(0, -1)) & (votes >= nbr(0, 1))
              & (votes > nbr(-1, 0)) & (votes >= nbr(1, 0)))
    ys_c = (ys.long() + py - 1).clamp(0, H - 1)
    xs_c = (xs.long() + px - 1).clamp(0, W - 1)
    return (ys_c, xs_c, votes,
            valid & (votes > acc_threshold) & nms_ok)


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


@device_cache(maxsize=16)
def _ring_on(device: str):
    """_RING and, for each of the four neighbour offsets of
    provisional_ring, _ring_neighbours' (known, idx) on a device, uploaded
    once per card."""
    nbrs = {off: tuple(torch.from_numpy(a).to(device)
                       for a in _ring_neighbours(off))
            for off in ((0, -1), (0, 1), (-1, 0), (1, 0))}
    return torch.from_numpy(_RING).to(device), nbrs


def provisional_ring(patch, ys, xs, valid, acc_threshold: float, H: int,
                     W: int, budget: int, hw=None):
    """Outer-ring (Chebyshev-2) cells of each 5x5 patch passing the partial
    OpenCV test (out-of-patch neighbours pass; interior of the content
    block hw, else of the canvas). Returns (ys_p, xs_p, valid_p)
    [P, budget] (the top-`budget` set by votes, stream order) and n_live
    [P], the count before truncation."""
    P, K = patch.shape[:2]
    flat = patch.reshape(P, K, 25)
    minus1 = -1.0
    ring, nbrs = _ring_on(str(patch.device))

    def nbr(off):
        known, idx = nbrs[off]
        return torch.where(known, flat[..., idx], minus1)

    v = flat[..., ring]
    ok = (
        (v > acc_threshold)
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
        score = torch.where(live, g(votes, 1, order), -1.0)
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
        & (c > acc_threshold)
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
    supported = valid2 & (support > acc_threshold)
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
        s_key = torch.where(supported, support, -1.0)
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
    return torch.where(out_valid[..., None], circles, 0.0), out_valid


def circle_plane_state_pool(planes, canny_high: float, min_r: int, max_r: int,
                            num_bins: int, hysteresis_iters: int = 24,
                            hw_planes=None, with_acc: bool = True,
                            edges=None):
    """Budget-independent circle state of a [P, H, W] uint8 plane pool:
    internal Canny (one hysteresis call for the pool, unless `edges` gives
    the [P, H, W] edge maps), walk steps, and the accumulator
    (vote_accumulator_pool_labels). hw_planes=(hs, ws): [P] content dims;
    Sobel then reads the replicate-remapped plane. Returns dict(emask, sx,
    sy, acc), or with with_acc=False dict(emask, sx, sy, lbl), lbl the
    uint8 direction labels."""
    if edges is None:
        edges = canny_pool(planes, max(canny_high / 2, 1), canny_high,
                           iters=hysteresis_iters, hw_planes=hw_planes)
    if hw_planes is not None:
        planes = border_remap(planes, hw_planes[0], hw_planes[1], "replicate")
    dx, dy = sobel3(planes)
    emask = (edges > 0) & ((dx != 0) | (dy != 0))
    sx, sy = pixel_steps(dx, dy)
    zero = torch.zeros_like(sx)
    labels = direction_labels(emask, dx, dy, num_bins)
    out = dict(emask=emask, sx=torch.where(emask, sx, zero),
               sy=torch.where(emask, sy, zero))
    if with_acc:
        out["acc"] = vote_accumulator_pool_labels(labels, num_bins, min_r,
                                                  max_r)
    else:
        out["lbl"] = labels
    return out


def _hw_of_one(hw, dev):
    """Single-image content dims (h, w) as the [1] tensors of a pool of one."""
    if hw is None:
        return None
    return tuple(torch.as_tensor(v, device=dev).reshape(1).long() for v in hw)


def circle_plane_state(img_u8, canny_high: float, min_r: int, max_r: int,
                       num_bins: int, hysteresis_iters: int = 24, hw=None,
                       with_acc: bool = True, edges=None):
    """Stage 1a of one [H, W] plane (circle_plane_state_pool of a pool of
    one): dict(emask, sx, sy, acc), or dict(emask, sx, sy, lbl) with
    with_acc=False. hw=(h, w): content dims inside a canvas; edges: a
    precomputed [H, W] internal-Canny edge map."""
    st = circle_plane_state_pool(
        img_u8[None], canny_high, min_r, max_r, num_bins, hysteresis_iters,
        hw_planes=_hw_of_one(hw, img_u8.device), with_acc=with_acc,
        edges=None if edges is None else edges[None])
    return {k: v[0] for k, v in st.items()}


def circle_propose(img_u8, canny_high: float, acc_threshold: float,
                   min_r: int, max_r: int, num_bins: int, top_k: int,
                   hysteresis_iters: int = 24, hw=None, block: int = 1,
                   threshold_factor: float = 0.5):
    """Stage 1 of one [H, W] plane: plane state and the proposals of
    propose_from_acc (no margin, no floor). Returns dict(emask, sx, sy, ys,
    xs, valid, sat)."""
    hwp = _hw_of_one(hw, img_u8.device)
    st = circle_plane_state_pool(img_u8[None], canny_high, min_r, max_r,
                                 num_bins, hysteresis_iters, hw_planes=hwp)
    ys, xs, valid, sat = propose_from_acc(
        st["acc"], acc_threshold, top_k, threshold_factor=threshold_factor,
        hw=hwp, block=block)
    return dict(emask=st["emask"][0], sx=st["sx"][0], sy=st["sy"][0],
                ys=ys[0], xs=xs[0], valid=valid[0], sat=sat[0])


def hough_circles_gradient(img_u8, canny_high: float, acc_threshold: float,
                           min_dist: float, min_r: int, max_r: int,
                           num_bins: int, top_k: int, max_out: int,
                           hysteresis_iters: int = 24, hw=None,
                           cells: int = 5):
    """cv.HoughCircles(HOUGH_GRADIENT) on one [H, W] uint8 plane, as the
    JAX package composes it for its diagnostic tools: circle_propose, the
    exact candidates with a ring budget of 512 and no compaction (the
    ring's budget truncates in stream order), the radius stage and
    circle_finalize with the packed sort key. Returns (circles [max_out, 3]
    f32 as (cx, cy, r) with OpenCV's +0.5 centre offset, valid [max_out]).
    Runs K1 (in the Canny), K2 and K3 on a CUDA plane."""
    H, W = img_u8.shape
    assert cells == 5, "the cv2-exact candidate flow requires 5x5 patches"
    st = circle_propose(img_u8, canny_high, acc_threshold, min_r, max_r,
                        num_bins, top_k, hysteresis_iters, hw=hw)
    one = {k: v[None] for k, v in st.items()}
    ys_c, xs_c, _votes, valid2, _ring_sat = circle_candidates(
        one["emask"], one["sx"], one["sy"], one["ys"], one["xs"],
        one["valid"], min_r, max_r, acc_threshold, H, W,
        hw=_hw_of_one(hw, img_u8.device))
    r_best, support = radius_support_pool(one["emask"], ys_c, xs_c, valid2,
                                          min_r, max_r)
    circles, valid = circle_finalize(ys_c, xs_c, valid2, r_best, support,
                                     acc_threshold, min_dist, max_out)
    return circles[0], valid[0]
