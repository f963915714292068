"""Greedy minimum-distance selection: the plain PyTorch version and the
wrapper of the CUDA kernel in csrc/greedy.cu.

The counterpart of the JAX package's greedy_min_dist
(img2sgf_tpu/hough/circles.py:823), a lax.fori_loop on the device: cv2's
overlap removal, which accepts the candidates of each plane in the given
order unless an earlier accepted one lies closer than min_dist. It is not a
Pallas kernel, but plain PyTorch on the card could only run it as a host
loop or as several launches per candidate, so on the card it is a
hand-written kernel: one block per plane, the candidates 32 at a time,
each tested at once against the stored acceptances and the batch's
earlier candidates, then decided in order with bit masks (see the
kernel's header). A call is one launch and no device read.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build

# Counts, added to under _build.count_lock: calls that launched the kernel,
# and calls of the plain version.
launches = 0
plain_calls = 0
_FAR = -(2.0 ** 30)  # an unused slot of the accepted buffer


def _md2(min_dist: float) -> float:
    """min_dist^2 as the JAX package compares it: the Python product,
    rounded once to float32."""
    return float(np.float32(min_dist * min_dist))


def greedy_min_dist_plain(ys, xs, live, min_dist: float, max_out: int):
    """Plain PyTorch version: one step per candidate up to the last live one
    of any plane, vectorised across planes; the float32 arithmetic of the
    JAX package's fori_loop (coordinates are integers, so every d^2 is
    exact). Returns accepted [P, K] bool."""
    global plain_calls
    with _build.count_lock:
        plain_calls += 1
    P, K = live.shape
    dev = live.device
    md2 = _md2(min_dist)
    f = torch.stack([ys, xs], dim=1).to(torch.float32)  # [P, 2, K]
    # accepted positions [P, 2, max_out] and a spare slot that takes the
    # writes of the planes that store nothing at a step
    acc = torch.full((P, 2, max_out + 1), _FAR, dtype=torch.float32, device=dev)
    slots = acc[..., :max_out]
    cnt = torch.zeros((P, 1, 1), dtype=torch.int64, device=dev)
    accepted = torch.zeros((P, K), dtype=torch.bool, device=dev)
    idx = torch.arange(1, K + 1, device=dev)
    n_live = int(torch.where(live, idx, 0).amax()) if live.numel() else 0
    for i in range(n_live):
        fi = f[..., i:i + 1]  # [P, 2, 1]
        d = slots - fi
        d = d * d
        clash = (d[:, 0] + d[:, 1] < md2).any(dim=1)
        take = live[:, i] & ~clash
        store = take[:, None, None] & (cnt < max_out)
        acc.scatter_(2, torch.where(store, cnt, max_out).expand(P, 2, 1),
                     torch.where(store, fi, _FAR))
        cnt += store
        accepted[:, i] = take
    return accepted


def greedy_min_dist_cuda(ys, xs, live, min_dist: float, max_out: int):
    """Launch the kernel over the [P, K] candidate lists: one launch, no
    device read; ys and xs are read as they are (int32 or int64)."""
    global launches
    lib = _build.load()
    P, K = live.shape
    if ys.dtype != xs.dtype or ys.dtype not in (torch.int32, torch.int64):
        raise TypeError("the greedy kernel takes ys and xs of one dtype, "
                        f"int32 or int64; got {ys.dtype} and {xs.dtype}")
    ys, xs = ys.contiguous(), xs.contiguous()
    lv = live.contiguous().view(torch.uint8)
    out = torch.empty((P, K), dtype=torch.bool, device=live.device)
    if P and K:
        # the C entry point launches on the thread's current device
        with torch.cuda.device(out.device):
            err = lib.img2sgf_greedy(
                ys.data_ptr(), xs.data_ptr(), lv.data_ptr(), out.data_ptr(),
                P, K, max_out, _md2(min_dist), int(ys.dtype == torch.int64),
                _build.stream_of(out))
        _build.check(err, "greedy kernel")
        if _build.launching():
            with _build.count_lock:
                launches += 1
    return out


def greedy_min_dist(ys, xs, live, min_dist: float, max_out: int):
    """Sequential acceptance in the given order with centre spacing >=
    min_dist (cv2's overlap removal), over [P, K] candidate lists: ys, xs
    integer centres, live bool. Skipped or dead candidates block nothing;
    acceptances past max_out are reported but stop blocking, as in the JAX
    package (the caller keeps the first max_out). Returns accepted [P, K]
    bool. CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if max_out < 1:
        raise ValueError(f"max_out must be >= 1, got {max_out}")
    if live.ndim != 2 or ys.shape != live.shape or xs.shape != live.shape:
        raise ValueError("ys, xs, live must be matching [P, K]")
    if live.dtype != torch.bool:
        raise TypeError("live must be bool")
    devs = {t.device for t in (ys, xs, live)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {devs}")
    dev = live.device
    if dev.type == "cpu":
        return greedy_min_dist_plain(ys, xs, live, min_dist, max_out)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return greedy_min_dist_cuda(ys, xs, live, min_dist, max_out)
