"""cv2 radius estimate and run support: the plain PyTorch version and the
wrapper of CUDA kernel K3 (csrc/radius.cu).

K3 replaces the Pallas kernel img2sgf_tpu/hough/radius_pallas.py:119
(radius_words_pallas, called by radius_support_pallas, body
_build_kernel.kern), and also does the run scan (_hist10_scan) that the JAX
package runs in XLA after it. For each wanted candidate centre it builds
OpenCV 4.x/5.x's radius histogram (10 bins per dr over the float32 distance
of every edge pixel in the (2*max_r+1)^2 window from (cx+.5, cy+.5); 290
bins at r in [1, 30]) and scans it into (r_best, support).

Every window pixel's bin is static: _bin_map gives the bin of each window
offset (-1 outside the annulus), and _row_spans derives from it up to two
column spans per window row that cover the annulus exactly; both are built
on the host and uploaded once. The kernel is bound by the bytes of the
mask and the per-slot arrays, or by an edge test per in-plane annulus pixel
and a lookup and a count per edge pixel, and stays far above both: each
candidate is a chain of dependent warp instructions. On the H100 a
persistent grid gives every wanted candidate one warp (each warp ballots
its own strided sample of slots, so none works on an unwanted one); the
warp reads its window's rows along the spans as aligned 16-byte chunks,
adds edge pixels into its own shared-memory histogram, and runs the scan
warp-parallel where it can: one pass builds the integer prefix and a table
of the highest nonempty bin below each bin, so each of the scan's steps is
one shared-memory read. The scan's float32 operations are those of
_hist10_scan: the run radius is one explicit fused multiply-add, as the
reference rounds it, and the library is built with --fmad=false so that no
other product is contracted into one. A call is one kernel launch and no
device read; any want mask, any P and any radius range whose two int32
tables per warp fit shared memory run.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build

# Counts, added to under _build.count_lock: calls that launched K3, and
# calls of the plain version.
launches = 0
plain_calls = 0
CHUNK = 512  # candidates per step of the plain version
_RUN_SCALE = float(np.float32(0.05))  # float32 1/(2*10), as XLA folds it


def _hist10_bins(min_r: int, max_r: int, dr: float = 1.0):
    """Each window offset's bin in OpenCV 4.x/5.x's radius histogram and
    whether it lies in the annulus, as flat [win*win] arrays; numpy float32,
    verbatim from img2sgf_tpu/hough/circles.py _hist10_tables."""
    nbins_per_dr = 10
    nbins = int(round((max_r - min_r) / dr * nbins_per_dr))
    ext = max_r
    win = 2 * ext + 1
    off = np.arange(win, dtype=np.float32) - np.float32(ext)
    dyy = (np.float32(0.5) - off)[:, None]
    dxx = (np.float32(0.5) - off)[None, :]
    r2 = (dxx * dxx + dyy * dyy).astype(np.float32)
    sel = (r2 >= np.float32(min_r * min_r)) & (r2 <= np.float32(max_r * max_r))
    d = np.sqrt(r2, dtype=np.float32)
    b = np.rint((d - np.float32(min_r)) / np.float32(dr)
                * nbins_per_dr).astype(np.int64)
    np.clip(b, 0, nbins - 1, out=b)
    return sel.ravel(), b.ravel(), win, nbins


@functools.lru_cache(maxsize=32)
def _hist10_tables(min_r: int, max_r: int, dr: float = 1.0):
    """Static distance->bin one-hot [win*win, nbins] float32 for OpenCV
    4.x/5.x's radius histogram, as the JAX package builds it."""
    sel, b, win, nbins = _hist10_bins(min_r, max_r, dr)
    onehot = np.zeros((win * win, nbins), np.float32)
    onehot[np.arange(win * win), b] = sel.astype(np.float32)
    return onehot, win, nbins


@functools.lru_cache(maxsize=32)
def _bin_map(min_r: int, max_r: int):
    """[win*win] int32 bin of each window offset, -1 outside the annulus:
    the column of each row's one in _hist10_tables' one-hot, without
    building the one-hot (win^2 * nbins floats, 160 GB at max_r 1000)."""
    sel, b, win, nbins = _hist10_bins(min_r, max_r)
    return np.where(sel, b, -1).astype(np.int32), win, nbins


def _hist10_scan(counts, min_r: int):
    """cv2's run scan over radius histograms counts [..., nbins] f32 (port of
    img2sgf_tpu/hough/circles.py _hist10_scan at dr = 1): bins walk from
    large radii down, each nonempty bin anchors a run of 10 bins, and a run
    replaces the best when cnt*r_best >= max_count*r_cur. Returns (r_best,
    max_count).

    The run radius is rounded as XLA:CPU rounds the JAX package's
    (anchor + j_after) / 2 / 10 * dr + min_r: it folds the divisions into a
    multiply by 0.05f and contracts the add, i.e. one float32 fused
    multiply-add, computed here exactly in float64 and rounded once."""
    nbins_per_dr = 10
    nbins = counts.shape[-1]
    csum = torch.cumsum(counts, dim=-1)
    iota = torch.arange(nbins, dtype=torch.int32, device=counts.device)
    nonempty = counts > 0
    shape = counts.shape[:-1]
    j = torch.full(shape, nbins - 1, dtype=torch.int32, device=counts.device)
    r_best = torch.zeros(shape, dtype=torch.float32, device=counts.device)
    max_count = torch.zeros(shape, dtype=torch.float32, device=counts.device)
    n_iter = (nbins - 2) // (nbins_per_dr + 1) + 1
    eps = torch.tensor(1.19e-7, dtype=torch.float32, device=counts.device)
    for _ in range(n_iter):
        mask = nonempty & (iota >= 1) & (iota <= j[..., None])
        anchor = torch.where(mask, iota, -1).amax(dim=-1)
        has = anchor >= 0
        j_after = torch.clamp(anchor - nbins_per_dr, min=-1)
        top = torch.gather(csum, -1, anchor.clamp(min=0)[..., None].long())[..., 0]
        lo = torch.gather(csum, -1, j_after.clamp(min=0)[..., None].long())[..., 0]
        cnt = top - torch.where(j_after >= 0, lo, torch.zeros_like(lo))
        r_cur = ((anchor + j_after).to(torch.float64) * _RUN_SCALE
                 + min_r).to(torch.float32)
        better = has & (
            (cnt * r_best >= max_count * r_cur)
            | ((r_best < eps) & (cnt >= max_count))
        )
        r_best = torch.where(better, r_cur, r_best)
        max_count = torch.where(better, cnt, max_count)
        j = torch.where(has, anchor - (nbins_per_dr + 1), -1).to(torch.int32)
    return r_best, max_count


def radius_support_pool_plain(emask, ys, xs, want, min_r: int, max_r: int):
    """Plain PyTorch version: window gather + integer histogram + run scan
    for the wanted rows. emask [P, H, W] bool; ys/xs/want [P, K]."""
    global plain_calls
    with _build.count_lock:
        plain_calls += 1
    P, H, W = emask.shape
    K = ys.shape[1]
    dev = emask.device
    bmap_np, win, nbins = _bin_map(min_r, max_r)
    bmap = torch.from_numpy(np.where(bmap_np >= 0, bmap_np, nbins)).long().to(dev)
    ep = torch.nn.functional.pad(emask.to(torch.int32),
                                 (max_r, max_r, max_r, max_r))
    off = torch.arange(win, device=dev)
    r_out = torch.zeros(P * K, dtype=torch.float32, device=dev)
    s_out = torch.zeros(P * K, dtype=torch.float32, device=dev)
    rows = want.reshape(-1).nonzero()[:, 0]
    for start in range(0, rows.numel(), CHUNK):
        r_idx = rows[start:start + CHUNK]
        p = r_idx // K
        cy = ys.reshape(-1)[r_idx].long()
        cx = xs.reshape(-1)[r_idx].long()
        w = ep[p[:, None, None], (cy[:, None] + off)[:, :, None],
               (cx[:, None] + off)[:, None, :]].reshape(r_idx.numel(), -1)
        counts = torch.zeros((r_idx.numel(), nbins + 1), dtype=torch.int32,
                             device=dev)
        counts.scatter_add_(1, bmap.expand(r_idx.numel(), -1), w)
        r, s = _hist10_scan(counts[:, :nbins].to(torch.float32), min_r)
        r_out[r_idx] = r
        s_out[r_idx] = s
    return r_out.reshape(P, K), s_out.reshape(P, K)


@functools.lru_cache(maxsize=32)
def _row_spans(min_r: int, max_r: int):
    """[win, 4] int32 (dx0, dx1, dx2, dx3) per window row: the columns dx0..dx1
    and dx2..dx3 (offsets in [-max_r, max_r], left run first) of that row's
    part of _bin_map's annulus; an empty run is (1, 0). Derived from the bin
    map itself, so the spans cover exactly its >= 0 set."""
    bmap, win, _ = _bin_map(min_r, max_r)
    sel = bmap.reshape(win, win) >= 0
    spans = np.tile(np.array([1, 0, 1, 0], np.int32), (win, 1))
    for u in range(win):
        cols = np.flatnonzero(sel[u])
        if not cols.size:
            continue
        cut = np.flatnonzero(np.diff(cols) > 1) + 1
        runs = np.split(cols, cut)
        if len(runs) > 2:
            raise AssertionError(f"annulus row {u} has {len(runs)} runs")
        for i, run in enumerate(runs):
            spans[u, 2 * i:2 * i + 2] = (run[0] - max_r, run[-1] - max_r)
    return spans


@functools.lru_cache(maxsize=8)
def _tables_on(min_r: int, max_r: int, device: str):
    """K3's bin map and row spans on the device, uploaded once per card:
    `device` is str(tensor.device), which names the card ("cuda:1")."""
    bmap_np, win, nbins = _bin_map(min_r, max_r)
    return (torch.from_numpy(bmap_np).to(device),
            torch.from_numpy(_row_spans(min_r, max_r)).to(device), nbins)


_TOO_MANY_BINS = -1  # img2sgf_radius: one warp's tables exceed shared memory


def radius_support_cuda(emask, ys, xs, want, min_r: int, max_r: int):
    """Launch K3 over the pool; rows not wanted are 0. One launch, no device
    read; ys and xs are read as they are (int32 or int64)."""
    global launches
    lib = _build.load()
    P, H, W = emask.shape
    K = ys.shape[1]
    if ys.dtype != xs.dtype or ys.dtype not in (torch.int32, torch.int64):
        raise TypeError("K3 takes ys and xs of one dtype, int32 or int64; "
                        f"got {ys.dtype} and {xs.dtype}")
    bmap, spans, nbins = _tables_on(min_r, max_r, str(emask.device))
    em = emask.contiguous().view(torch.uint8)
    wn = want.contiguous().view(torch.uint8)
    ys, xs = ys.contiguous(), xs.contiguous()
    r_out = torch.empty((P, K), dtype=torch.float32, device=emask.device)
    s_out = torch.empty((P, K), dtype=torch.float32, device=emask.device)
    if P and K:
        # the C entry point launches on the thread's current device
        with torch.cuda.device(r_out.device):
            err = lib.img2sgf_radius(
                em.data_ptr(), ys.data_ptr(), xs.data_ptr(), wn.data_ptr(),
                bmap.data_ptr(), spans.data_ptr(), r_out.data_ptr(),
                s_out.data_ptr(), P, H, W, K, min_r, max_r, nbins,
                int(ys.dtype == torch.int64), _build.stream_of(r_out))
        if err == _TOO_MANY_BINS:
            raise ValueError(
                f"radius range [{min_r}, {max_r}] needs {nbins} histogram "
                f"bins; one warp's two int32 tables ({8 * nbins} bytes) do "
                "not fit this card's shared memory per block")
        _build.check(err, "radius kernel")
        with _build.count_lock:
            launches += 1
    return r_out, s_out


def radius_support_pool(emask, ys, xs, want, min_r: int, max_r: int):
    """cv2 radius estimate + run support at given centres over a pool:
    emask [P, H, W] bool, ys/xs [P, K] int centres inside the plane, want
    [P, K] bool, any mask. Returns (r_best, support) [P, K] f32, zeros
    where not wanted. CPU tensors take the plain version; CUDA tensors
    launch K3 (ys and xs then int32 or int64, of one dtype)."""
    if min_r < 1 or max_r < min_r:
        raise ValueError(f"bad radius range [{min_r}, {max_r}]")
    if emask.ndim != 3 or emask.dtype != torch.bool:
        raise ValueError("emask must be [P, H, W] bool")
    if ys.ndim != 2 or ys.shape != xs.shape or ys.shape != want.shape \
            or ys.shape[0] != emask.shape[0]:
        raise ValueError("ys, xs, want must be matching [P, K]")
    if want.dtype != torch.bool:
        raise TypeError("want must be bool")
    devs = {t.device for t in (emask, ys, xs, want)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {devs}")
    dev = emask.device
    if dev.type == "cpu":
        return radius_support_pool_plain(emask, ys, xs, want, min_r, max_r)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return radius_support_cuda(emask, ys, xs, want, min_r, max_r)
