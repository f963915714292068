"""Canny hysteresis sweeps on bit-packed planes: the plain PyTorch version
and the wrapper of CUDA kernel K1 (csrc/hysteresis.cu).

K1 replaces the Pallas kernel img2sgf_tpu/ops/hysteresis_pallas.py
(hysteresis_pallas / hysteresis_pallas_packed, body _kernel). Planes are
packed as bits of int32 words [G, H, W]; every operation is bitwise, so the
bit-planes stay independent. One sweep is, exactly as the JAX package
defines it (ops/canny.py hysteresis / hysteresis_pool):

  1. segmented OR-fill along rows, forward and backward: every pixel of a
     contiguous run of `gate` becomes set if any pixel of the run is set;
  2. the same along columns;
  3. new = (dilate8(new) & gate) | new.

Sweeps repeat while one changed something, at most `iters` times. The cap
can bind (photo-textured scans need hundreds of sweeps), so the kernel
keeps the sweep semantics and not only the fixed point: a tile-local
fixed point would give another result whenever the cap binds.

On the H100 one call is one persistent cooperative launch that runs every
sweep on the device, with grid-wide barriers between the row fill, the
column summaries and the column fill (which also does the gated dilation),
and one 4-byte read of the sweep count afterwards. The fills are segmented
scans that each lane runs over its own words (a row segment staged through
shared memory, a band of a column in registers), with the carries between
lanes, segments and bands composed by the scan's associative operator, so
no line has to fit anywhere and any H, W runs (csrc/hysteresis.cu says
more).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .common import shift2d

launches = 0      # K1 host calls that launched the kernel (each runs all sweeps)
last_sweeps = 0   # sweeps the last call ran (kernel or plain version)


def _shift(x, k: int, dim: int):
    """Shift by k along dim (-1 or -2) toward higher indices, zero fill."""
    return shift2d(x, 0, k) if dim == -1 else shift2d(x, k, 0)


def _fill_dir(act, gate, dim: int, forward: bool):
    a, g = act, gate
    k = 1
    while k < act.shape[dim]:
        kk = k if forward else -k
        a = a | (g & _shift(a, kk, dim))
        g = g & _shift(g, kk, dim)
        k *= 2
    return a


def _seg_fill(act, gate, dim: int):
    """Segmented OR-fill along dim (the associative scans of
    ops/canny.py _seg_fill_axis_packed, as log-doubling steps)."""
    return _fill_dir(act, gate, dim, True) | _fill_dir(act, gate, dim, False)


def _dilate8_or(x):
    """Bitwise 3x3 dilation of int32 words (dilate8 with | for max)."""
    out = x
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                out = out | shift2d(x, dy, dx)
    return out


def hysteresis_packed_plain(edge0, gate, iters: int):
    """Plain PyTorch sweeps on int32 words [G, H, W]; returns the words."""
    global last_sweeps
    edge = edge0
    last_sweeps = 0
    for _ in range(iters):
        new = _seg_fill(edge, gate, -1)
        new = _seg_fill(new, gate, -2)
        new = (_dilate8_or(new) & gate) | new
        changed = bool((new != edge).any())
        edge = new
        last_sweeps += 1
        if not changed:
            break
    return edge


def hysteresis_packed_cuda(edge0, gate, iters: int):
    """Launch K1 on CUDA int32 words [G, H, W]: one launch and one device
    read per call, whatever the number of sweeps. Returns new words."""
    global launches, last_sweeps
    if iters <= 0 or edge0.numel() == 0:
        last_sweeps = 0
        return edge0.clone()
    lib = _build.load()
    G, H, W = edge0.shape
    edge = torch.empty_like(edge0)
    t = torch.empty_like(edge0)
    scratch = torch.empty(lib.img2sgf_hysteresis_scratch(G, H, W),
                          dtype=torch.int32, device=edge0.device)
    sweeps = ctypes.c_int(0)
    err = lib.img2sgf_hysteresis(
        edge0.data_ptr(), edge.data_ptr(), t.data_ptr(), gate.data_ptr(),
        scratch.data_ptr(), G, H, W, int(iters), ctypes.addressof(sweeps),
        _build.stream_of(edge))
    _build.check(err, "hysteresis kernel")
    launches += 1
    last_sweeps = sweeps.value
    return edge


def hysteresis_packed(edge0, gate, iters: int):
    """Hysteresis sweeps on bit-packed int32 words [G, H, W] (edge0 must be
    a subset of gate). CPU tensors take the plain version; CUDA tensors
    launch K1."""
    if edge0.dtype != torch.int32 or gate.dtype != torch.int32:
        raise TypeError("hysteresis words must be int32")
    if edge0.ndim != 3 or edge0.shape != gate.shape:
        raise ValueError(f"expected matching [G, H, W] words, got "
                         f"{tuple(edge0.shape)} and {tuple(gate.shape)}")
    if edge0.device != gate.device:
        raise ValueError("edge0 and gate lie on different devices")
    if edge0.device.type == "cpu":
        return hysteresis_packed_plain(edge0, gate, iters)
    if edge0.device.type != "cuda":
        raise ValueError(f"unsupported device {edge0.device}")
    return hysteresis_packed_cuda(edge0.contiguous(), gate.contiguous(), iters)
