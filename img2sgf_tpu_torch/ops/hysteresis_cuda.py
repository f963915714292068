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
column summaries and the column fill (which also does the gated dilation).
The kernel writes its sweep count to a device int and the call reads
nothing back, so a CUDA graph can capture it; last_sweeps() reads the
count when asked. The fills are segmented
scans that each lane runs over its own words (a row segment staged through
shared memory, a band of a column in registers), with the carries between
lanes, segments and bands composed by the scan's associative operator, so
no line has to fit anywhere and any H, W runs (csrc/hysteresis.cu says
more).
"""

from __future__ import annotations

import contextlib
import threading

import torch

from .. import _build
from .common import shift2d

# Counts, added to under _build.count_lock: K1 host calls that launched the
# kernel (each runs all sweeps), and calls of the plain version.
launches = 0
plain_calls = 0
_local = threading.local()
# Each launch sizes its cooperative grid to fill the card, so two running
# at once on two streams could each hold part of the card and spin at a
# grid barrier for blocks the other holds. So the work that holds K1 takes
# turns on each card (card_turn): on the device, each turn's stream waits
# for the event that ends the one before. card index -> (lock, last event)
_card_turns: dict = {}


@contextlib.contextmanager
def card_turn(device: torch.device):
    """Order the work enqueued inside the block on the current stream of
    `device` after every earlier turn on that card, on the device (no host
    wait). Eager K1 calls take one each; the graph runner takes one around
    each replay of a graph that holds K1. Not inside a stream capture: a
    captured graph takes its turn when it is replayed."""
    turn = _card_turns.setdefault(device.index, [threading.Lock(), None])
    with turn[0]:
        stream = torch.cuda.current_stream(device)
        if turn[1] is not None:
            stream.wait_event(turn[1])
        yield
        turn[1] = stream.record_event()


def last_sweeps() -> int:
    """The sweeps that this thread's last call ran (kernel or plain
    version), kept per thread so that concurrent calls cannot overwrite
    each other's. After a kernel call this reads the kernel's device count
    back (a host synchronisation; for diagnostics)."""
    s = getattr(_local, "sweeps", 0)
    return s if isinstance(s, int) else int(s.item())


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
    global plain_calls
    with _build.count_lock:
        plain_calls += 1
    edge = edge0
    sweeps = 0
    for _ in range(iters):
        new = _seg_fill(edge, gate, -1)
        new = _seg_fill(new, gate, -2)
        new = (_dilate8_or(new) & gate) | new
        changed = bool((new != edge).any())
        edge = new
        sweeps += 1
        if not changed:
            break
    _local.sweeps = sweeps
    return edge


def hysteresis_packed_cuda(edge0, gate, iters: int):
    """Launch K1 on CUDA int32 words [G, H, W]: one launch per call,
    whatever the number of sweeps, and no device read. Returns new words."""
    global launches
    if iters <= 0 or edge0.numel() == 0:
        _local.sweeps = 0
        return edge0.clone()
    lib = _build.load()
    G, H, W = edge0.shape
    dev = edge0.device
    edge = torch.empty_like(edge0)
    t = torch.empty_like(edge0)
    scratch = torch.empty(lib.img2sgf_hysteresis_scratch(G, H, W),
                          dtype=torch.int32, device=dev)
    sweeps = torch.empty(1, dtype=torch.int32, device=dev)
    turn = card_turn(dev) if _build.launching() else contextlib.nullcontext()
    # the C entry point launches on (and sizes its cooperative grid for)
    # the thread's current device, which need not be edge's
    with torch.cuda.device(dev), turn:
        err = lib.img2sgf_hysteresis(
            edge0.data_ptr(), edge.data_ptr(), t.data_ptr(), gate.data_ptr(),
            scratch.data_ptr(), G, H, W, int(iters), sweeps.data_ptr(),
            _build.stream_of(edge))
    _build.check(err, "hysteresis kernel")
    if _build.launching():
        with _build.count_lock:
            launches += 1
    _local.sweeps = sweeps
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
