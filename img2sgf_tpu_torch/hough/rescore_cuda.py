"""Exact-vote rescore: the plain PyTorch version and the wrapper of CUDA
kernel K2 (csrc/rescore.cu).

K2 replaces the Pallas kernel img2sgf_tpu/hough/rescore_pallas.py
(exact_rescore_pallas, body _build_kernel.kern). For each candidate centre
it counts OpenCV HOUGH_GRADIENT's exact fixed-point votes on the
cells x cells patch around it: an edge pixel with steps (sx, sy) lands on
cell (y + ((r*s*sy) >> 10), x + ((r*s*sx) >> 10)) for radius r and sign s.
Only radii |r - rhat| <= kmax (rhat = round(|offset|)) can land, the sign
toward the candidate covers the whole window, and the opposite sign can
only land from the central (4*reach+1)^2 block (the pruning proof in
img2sgf_tpu/hough/circles.py exact_rescore, which this walk follows).

On the H100 a persistent grid walks only the valid (plane, candidate)
pairs, one warp per pair (a prefix over each plane's valid count, built on
the device), and zeroes the rows past each prefix. The warp lists the edge
pixels of the candidate's window in its own shared-memory list and walks
the list whenever it fills, so shared memory is bounded by the list and
every radius runs; every lane walks one edge pixel, rhat comes from the
per-offset table of _geometry, and landings go to the warp's integer
counters, exact in any order. The kernel reads emask, sx and sy directly;
only the plain version packs them into one word.

min_r = 0 (a value the JAX package runs on its XLA path) needs nothing of
its own: the step r = 0 lands a pixel on its own cell, from both signed
walks of the central block, as OpenCV's two walks count it, and
rhat - kmax <= 0 for every pixel of the patch, so the walk reaches it.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import _build
from .._devconst import device_cache

# Counts, added to under _build.count_lock: calls that launched K2, and
# calls of the plain version.
launches = 0
plain_calls = 0
CHUNK = 256  # candidates per step of the plain version


@functools.lru_cache(maxsize=16)
def _geometry(min_r: int, max_r: int, cells: int):
    """Static per-window-pixel tables, numpy, as in circles.exact_rescore."""
    assert cells in (3, 5), "rescore patch must be 3x3 or 5x5"
    reach = cells // 2
    ext = max_r + reach + 2
    win = 2 * ext + 1
    uu = np.broadcast_to(np.arange(win)[:, None] - ext, (win, win))
    vv = np.broadcast_to(np.arange(win)[None, :] - ext, (win, win))
    boy = (-uu).reshape(-1).astype(np.int32)  # centre - pixel (rows)
    box = (-vv).reshape(-1).astype(np.int32)
    d = np.sqrt(boy.astype(np.float64) ** 2 + box.astype(np.float64) ** 2)
    rhat = np.round(d).astype(np.int32)
    kmax = int(math.floor(math.sqrt(2.0) * (reach + 1.015) + 0.5))
    ih = 2 * reach
    inner = ((np.abs(boy) <= ih) & (np.abs(box) <= ih)).nonzero()[0]
    return reach, ext, win, boy, box, rhat, kmax, inner


def _pack(emask, sx, sy):
    return (emask.to(torch.int32) | ((sx + 1024) << 1) | ((sy + 1024) << 13))


def exact_rescore_plain(emask, sx, sy, ys, xs, valid, min_r: int, max_r: int,
                        cells: int):
    """Plain PyTorch exact-vote patches over a pool: emask/sx/sy [P, H, W],
    ys/xs/valid [P, K]. Returns [P, K, cells, cells] f32 counts; rows that
    are not valid are 0 (the JAX XLA path scores them, K2 and the Pallas
    kernel do not)."""
    global plain_calls
    with _build.count_lock:
        plain_calls += 1
    P, H, W = emask.shape
    K = ys.shape[1]
    dev = emask.device
    reach, ext, win, boy_np, box_np, rhat_np, kmax, inner_np = _geometry(
        min_r, max_r, cells)
    nc = cells * cells
    boy = torch.from_numpy(boy_np).to(dev)
    box = torch.from_numpy(box_np).to(dev)
    rhat = torch.from_numpy(rhat_np).to(dev)
    inner = torch.from_numpy(inner_np).to(dev)
    packed = torch.nn.functional.pad(_pack(emask, sx, sy), (ext, ext, ext, ext))
    off = torch.arange(win, device=dev)
    out = torch.zeros((P * K, nc + 1), dtype=torch.int32, device=dev)
    rows = valid.reshape(-1).nonzero()[:, 0]
    for start in range(0, rows.numel(), CHUNK):
        r_idx = rows[start:start + CHUNK]
        p = r_idx // K
        cy = ys.reshape(-1)[r_idx].long()
        cx = xs.reshape(-1)[r_idx].long()
        # padded row cy + u holds unpadded row cy - ext + u
        win_y = (cy[:, None] + off[None, :])[:, :, None]
        win_x = (cx[:, None] + off[None, :])[:, None, :]
        pk = packed[p[:, None, None], win_y, win_x].reshape(r_idx.numel(), -1)
        e = (pk & 1).bool()
        wx = ((pk >> 1) & 0xFFF) - 1024
        wy = ((pk >> 13) & 0xFFF) - 1024
        sgn = torch.where(wy * boy + wx * box >= 0, 1, -1).to(torch.int32)
        counts = torch.zeros((r_idx.numel(), nc + 1), dtype=torch.int32,
                             device=dev)

        def walk(tx, ty, e_, rh, bx, by):
            for k in range(-kmax, kmax + 1):
                r = rh + k
                ok = (r >= min_r) & (r <= max_r)
                ddx = ((r * tx) >> 10) - bx
                ddy = ((r * ty) >> 10) - by
                inb = e_ & ok & (ddx.abs() <= reach) & (ddy.abs() <= reach)
                code = torch.where(inb, (ddy + reach) * cells + (ddx + reach),
                                   nc).long()
                counts.scatter_add_(1, code, inb.to(torch.int32))

        walk(sgn * wx, sgn * wy, e, rhat, box, boy)
        walk(-(sgn * wx)[:, inner], -(sgn * wy)[:, inner], e[:, inner],
             rhat[inner], box[inner], boy[inner])
        out[r_idx] = counts
    return out[:, :nc].to(torch.float32).reshape(P, K, cells, cells)


@device_cache(maxsize=16)
def _rhat_on(min_r: int, max_r: int, cells: int, device: str):
    """K2's per-offset rhat table [win * win] int32, uploaded once per card:
    `device` is str(tensor.device), which names the card ("cuda:1")."""
    return torch.from_numpy(_geometry(min_r, max_r, cells)[5]).to(device)


def exact_rescore_cuda(emask, sx, sy, ys, xs, valid, min_r: int, max_r: int,
                       cells: int):
    """Launch K2 over the valid prefix of each plane; other rows are 0."""
    global launches
    lib = _build.load()
    P, H, W = emask.shape
    K = ys.shape[1]
    kmax = _geometry(min_r, max_r, cells)[6]
    rhat = _rhat_on(min_r, max_r, cells, str(emask.device))
    emask, sx, sy = emask.contiguous(), sx.contiguous(), sy.contiguous()
    ys32 = ys.to(torch.int32).contiguous()
    xs32 = xs.to(torch.int32).contiguous()
    nvalid = valid.sum(dim=1, dtype=torch.int32).contiguous()
    out = torch.empty((P, K, cells * cells), dtype=torch.float32,
                      device=emask.device)
    if P and K:
        # the C entry point launches on the thread's current device
        with torch.cuda.device(out.device):
            err = lib.img2sgf_rescore(
                emask.data_ptr(), sx.data_ptr(), sy.data_ptr(),
                ys32.data_ptr(), xs32.data_ptr(), nvalid.data_ptr(),
                rhat.data_ptr(), out.data_ptr(), P, H, W, K, cells, min_r,
                max_r, kmax, _build.stream_of(out))
        _build.check(err, "rescore kernel")
        if _build.launching():
            with _build.count_lock:
                launches += 1
    return out.reshape(P, K, cells, cells)


def exact_rescore(emask, sx, sy, ys, xs, valid, min_r: int, max_r: int,
                  cells: int = 3):
    """Exact OpenCV votes on a cells x cells patch around each candidate.

    emask [P, H, W] bool, sx/sy [P, H, W] int32 steps in [-1024, 1024],
    ys/xs [P, K] int centres inside the plane, valid [P, K] bool, a live
    prefix per plane (K2 takes its length, so a mask with a gap raises on
    the CPU and fails a device assert on the card).
    Returns [P, K, cells, cells] f32, zero past the prefix. CPU tensors take
    the plain version; CUDA tensors launch K2.
    """
    if cells not in (3, 5):
        raise ValueError("rescore patch must be 3x3 or 5x5")
    if min_r < 0:
        raise ValueError("min_r must be >= 0")
    if emask.ndim != 3 or sx.shape != emask.shape or sy.shape != emask.shape:
        raise ValueError("emask, sx, sy must be matching [P, H, W]")
    if ys.ndim != 2 or ys.shape != xs.shape or ys.shape != valid.shape \
            or ys.shape[0] != emask.shape[0]:
        raise ValueError("ys, xs, valid must be matching [P, K]")
    if emask.dtype != torch.bool or valid.dtype != torch.bool:
        raise TypeError("emask and valid must be bool")
    if sx.dtype != torch.int32 or sy.dtype != torch.int32:
        raise TypeError("sx and sy must be int32")
    devs = {t.device for t in (emask, sx, sy, ys, xs, valid)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {devs}")
    gap = (valid[:, 1:] & ~valid[:, :-1]).any()
    dev = emask.device
    if dev.type == "cpu":
        _raise_on_gap(gap)
        return exact_rescore_plain(emask, sx, sy, ys, xs, valid, min_r,
                                   max_r, cells)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    # on the card the check reads nothing back: a gap fails a device assert
    # (which ends the process's CUDA context) instead of raising here
    torch._assert_async(~gap, _GAP)
    return exact_rescore_cuda(emask, sx, sy, ys, xs, valid, min_r, max_r,
                              cells)


_GAP = "valid must be a prefix of each plane's rows"


def _raise_on_gap(gap):
    """The CPU form of the prefix check: raise if `gap` (a bool tensor)."""
    if bool(gap):
        raise ValueError(_GAP)
