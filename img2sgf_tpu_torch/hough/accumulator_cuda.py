"""Centre-vote accumulator of a label pool: the plain PyTorch versions and
the wrapper of CUDA kernel A (csrc/accumulator.cu).

Kernel A replaces no Pallas kernel. It stands for the JAX package's pooled
accumulator: vote_accumulator_pool_labels (img2sgf_tpu/hough/circles.py:278),
a lax.map over vote_accumulator_packed4, in which XLA fuses each direction
bin's shift chain into one pass over the bin's plane; and for the per-offset
chain of its vote_accumulator (:299-347), taken when the radius span does
not divide into segments of 5. Plain PyTorch runs either one as hundreds of
launches over whole padded int32 planes, so on the card it is a kernel.

Both accumulators are one function of the uint8 direction labels: an edge
pixel q of bin d adds weight w at q + o for every entry (o, w) of bin d's
offset table (vote_table); votes that land outside the plane are dropped,
and pixels outside the plane never vote. For the cascade the table is the
merged multiset of (by + jy, bx + jx) over _cascade_tables' outer (by, bx)
and inner (jy, jx) offsets; for the per-offset chain it is _walk_offsets.
Every count is an integer below 2^24, so the kernel's int32 sums equal the
plain versions bit for bit. The kernel also takes each bin's span
(vote_extents) to skip the edge pixels that cannot reach a tile. A call is
one launch and no device read.
"""

from __future__ import annotations

import collections
import functools
import math

import numpy as np
import torch

from .. import _build
from .._devconst import device_cache

# Counts, added to under _build.count_lock: calls that launched kernel A,
# and calls of either plain version.
launches = 0
plain_calls = 0


def _count_plain():
    global plain_calls
    with _build.count_lock:
        plain_calls += 1


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


def _walk_offsets(ux: float, uy: float, min_r: int, max_r: int):
    """Exact OpenCV vote-walk offsets for direction (ux, uy), both ways
    (verbatim from the JAX package): the cell of step r is
    floor(r*s*sx/1024) with sx = round(1024*ux) (not the negation for the -
    direction). Duplicate cells get several votes: (dy, dx) -> weight."""
    sx = round(1024 * ux)
    sy = round(1024 * uy)
    weights: dict[tuple[int, int], int] = {}
    for sign in (1, -1):
        for r in range(min_r, max_r + 1):
            o = (math.floor(sign * r * sy / 1024), math.floor(sign * r * sx / 1024))
            weights[o] = weights.get(o, 0) + 1
    return weights


def vote_accumulator_offsets(labels, num_bins: int, min_r: int, max_r: int):
    """Exact per-offset centre-vote accumulator over a pool of [P, H, W]
    direction labels: per bin, the bin's edge plane shifted to every cell of
    the exact fixed-point walk (_walk_offsets) and added with its weight.
    The JAX package's vote_accumulator for radius spans that do not divide
    into segments of 5; its float32 chain adds integers below 2^24, so the
    int32 sums here equal it. Returns f32."""
    _count_plain()
    P, H, W = labels.shape
    pad = max_r
    lab = torch.nn.functional.pad(labels.to(torch.int32),
                                  (pad, pad, pad, pad), value=num_bins)
    acc = torch.zeros((P, H, W), dtype=torch.int32, device=labels.device)
    step = math.pi / num_bins
    for d in range(num_bins):
        e_d = (lab == d).to(torch.int32)
        phi = d * step
        for (oy, ox), w in _walk_offsets(math.cos(phi), math.sin(phi), min_r,
                                         max_r).items():
            acc.add_(e_d[:, pad - oy:pad - oy + H, pad - ox:pad - ox + W],
                     alpha=w)
    return acc.to(torch.float32)


def vote_accumulator_cascade_labels(labels, num_bins: int, min_r: int,
                                    max_r: int):
    """Approximate centre-vote accumulator over a pool of [P, H, W] direction
    labels (direction_labels): per bin, a partial plane of the `seg` inner
    shifts, sampled at the outer segment offsets. Exact integer sums, equal
    to the JAX package's vote_accumulator_cascade and its byte-packed pool
    version. Returns f32."""
    _count_plain()
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


@functools.lru_cache(maxsize=32)
def vote_table(num_bins: int, min_r: int, max_r: int):
    """The accumulator as one offset table: (start, entries, halo). Bin d's
    entries are columns start[d]:start[d + 1] of entries [3, E] int32, rows
    (dy, dx, weight): an edge pixel of bin d at q adds weight at q + (dy,
    dx). The cascade's merged offsets when the radius span divides into
    segments of 5, _walk_offsets' otherwise, as
    vote_accumulator_pool_labels chooses; each bin's entries sorted, each
    offset once. halo is the largest |dy| or |dx| (0 for an empty table).
    Host numpy arrays, read-only."""
    if (max_r - min_r + 1) % 5 == 0:
        inner, outer = _cascade_tables(num_bins, min_r, max_r)
        per_bin = [collections.Counter((by + jy, bx + jx) for by, bx in outer[d]
                                       for jy, jx in inner[d])
                   for d in range(num_bins)]
    else:
        step = math.pi / num_bins
        per_bin = [_walk_offsets(math.cos(d * step), math.sin(d * step),
                                 min_r, max_r) for d in range(num_bins)]
    rows = [(dy, dx, w) for t in per_bin for (dy, dx), w in sorted(t.items())]
    start = np.cumsum([0] + [len(t) for t in per_bin]).astype(np.int32)
    entries = np.array(rows, np.int32).reshape(-1, 3).T.copy()
    halo = int(np.abs(entries[:2]).max()) if entries.size else 0
    start.setflags(write=False)
    entries.setflags(write=False)
    return start, entries, halo


# Kernel A packs a staged pixel's (y, x) relative to its tile, and each
# vote's target, into two 15-bit halves of a word, so it takes offset
# tables whose largest |offset| (vote_table's halo) is below this
MAX_HALO = 8000


@functools.lru_cache(maxsize=32)
def vote_extents(num_bins: int, min_r: int, max_r: int):
    """The spans of vote_table's offsets: (ext, bounds). ext [num_bins, 4]
    int16 holds each bin's (dymin, dymax, dxmin, dxmax), saturated to int16
    (exact below MAX_HALO): an edge pixel of bin d reaches only [y + dymin,
    y + dymax] x [x + dxmin, x + dxmax]. An
    empty bin gets an empty span (min 32767, max -32768). bounds is (ymin,
    ymax, xmin, xmax) over all entries ((0, 0, 0, 0) for an empty table).
    Host numpy, read-only."""
    start, entries, _ = vote_table(num_bins, min_r, max_r)
    ext = np.tile(np.array([32767, -32768, 32767, -32768], np.int64),
                  (num_bins, 1))
    for d in range(num_bins):
        dy, dx = entries[:2, start[d]:start[d + 1]]
        if dy.size:
            ext[d] = dy.min(), dy.max(), dx.min(), dx.max()
    ext = np.clip(ext, -32768, 32767).astype(np.int16)
    bounds = ((int(entries[0].min()), int(entries[0].max()),
               int(entries[1].min()), int(entries[1].max()))
              if entries.size else (0, 0, 0, 0))
    ext.setflags(write=False)
    return ext, bounds


@device_cache(maxsize=16)
def _table_on(num_bins: int, min_r: int, max_r: int, device: str):
    """vote_table and vote_extents on a device, uploaded once per card:
    (start, entries, ext, bounds). `device` is str(tensor.device), which
    names the card ("cuda:1")."""
    start, entries, _ = vote_table(num_bins, min_r, max_r)
    ext, bounds = vote_extents(num_bins, min_r, max_r)
    return (torch.tensor(start, device=device),
            torch.tensor(entries, device=device),
            torch.tensor(ext, device=device), bounds)


def check_labels(labels, num_bins: int):
    """Raise unless labels is a [P, H, W] uint8 label pool and num_bins a
    count direction_labels takes (1-254)."""
    if labels.dtype != torch.uint8:
        raise TypeError(f"labels must be uint8, got {labels.dtype}")
    if labels.ndim != 3:
        raise ValueError("labels must be [P, H, W], got shape "
                         f"{tuple(labels.shape)}")
    if not 1 <= num_bins <= 254:
        raise ValueError(f"num_bins={num_bins}: labels are uint8 with a "
                         "num_bins sentinel, so 1 <= num_bins <= 254")


def vote_accumulator_cuda(labels, num_bins: int, min_r: int, max_r: int):
    """Launch kernel A over the [P, H, W] uint8 label pool with the table of
    (num_bins, min_r, max_r): the f32 accumulator, one launch, no device
    read."""
    global launches
    check_labels(labels, num_bins)
    halo = vote_table(num_bins, min_r, max_r)[2]
    if halo >= MAX_HALO:
        raise ValueError(f"kernel A takes offsets below {MAX_HALO}; radii "
                         f"{min_r}-{max_r} reach {halo}")
    if labels.device.type != "cuda":
        raise ValueError(f"kernel A takes CUDA labels, got {labels.device}")
    P, H, W = labels.shape
    lib = _build.load()
    start, entries, ext, (ymin, ymax, xmin, xmax) = _table_on(
        num_bins, min_r, max_r, str(labels.device))
    lab = labels.contiguous()
    out = torch.empty((P, H, W), dtype=torch.float32, device=labels.device)
    if out.numel():
        # the C entry point launches on the thread's current device
        with torch.cuda.device(out.device):
            err = lib.img2sgf_accumulator(
                lab.data_ptr(), start.data_ptr(), entries.data_ptr(),
                entries.shape[1], ext.data_ptr(), out.data_ptr(), P, H, W,
                num_bins, ymin, ymax, xmin, xmax, _build.stream_of(out))
        _build.check(err, "accumulator kernel")
        if _build.launching():
            with _build.count_lock:
                launches += 1
    return out
