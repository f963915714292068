#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (img2sgf_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one line or a few:
  1. the card (nvidia-smi name and power limit) and the nvcc build of every
     kernel in img2sgf_tpu_torch/csrc/;
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it and at larger ones (K1: a 1280x1280
     staircase and 6400-word rows; K2: circle_max_radius 60; K3: the 768^2
     diagram's own inputs, random centres at max_r 30 and 60, and the
     noisy diagram's overflow-rerun inputs), exactly equal, with both times
     and the roofline bound; K1's sweep count equal to the plain loop's;
  3. direction_bins and pixel_steps over all 2041^2 Sobel gradient pairs,
     CUDA against CPU, exactly equal;
  4. the main path on a seeded synthetic 19x19 diagram at 768x768: the CLI
     in a subprocess and detect_board in process, every planted stone found
     with its colour, the SGF equal to to_sgf of the in-process result, the
     whole BoardResult bit-equal to the port's CPU run, the warm wall time
     and the per-stage times; then a noisy diagram that takes the overflow
     rerun, CUDA against CPU, and the rerun's own wall time;
  5. the batch path: detect_board_bucket_batch on 16 seeded diagrams of
     mixed sizes (648-768 px, an exact fit and margins of 1 and 2 px) in
     the 768 canvas bucket, every planted stone found; each row equal to
     detect_board_auto of its image in every field, detect_board_auto equal
     to native detect_board at margins 0 and >= 3; a sub-batch of 3 equal
     to its CPU run; launch counts that do not grow with B (2 K1, 2 K2,
     1 K3, plus 2 K2 and 1 K3 with the overflow rerun); the CLI's --batch;
     detect_board_batch on 32 512^2 diagrams; warm img/s and stage times of
     both batches and of the 16 images through detect_board and
     detect_board_auto one by one.
     Phase 2 also holds each kernel at the batch's own inputs (recorded
     from one batch run: K1 at [1,768,768] and [4,768,768] words, K2 and K3
     over the 128-plane pool) against its plain version;
  5b. the editing session (DetectSession) on the 768^2 diagram: an action
     script (process, alignment, a stone cycled, a black-threshold change
     and reclassify, a zoom onto a corner that re-detects in the 512
     bucket, a 2-degree rotation, zoom out) on the card and on the CPU, with
     the same log, board, side to move and SGF after every action; the
     launches of one process(), none for reclassify, and the warm wall
     time of each action;
  5c. the batch loader: the 16 batch diagrams as JPEGs through decode_batch
     (the native libjpeg loader where its headers exist), close to PIL,
     and its decode time;
  5d. data parallelism: make_sharded_detector on [cuda:0] (32 512^2) and on
     [cuda:0, cuda:0] (the 16-image bucket batch, K1-K3 called from both
     worker threads) equal to the one-device batches in every field,
     feed_and_detect over the JPEGs equal to detect_board_auto of each
     decoded image, and warm img/s of each beside its one-device batch;
  6. every kernel launched by each path's counted run (detect_board,
     detect_board_bucket_batch, detect_board_batch, DetectSession.process,
     the sharded detectors, feed_and_detect; counts set to 0 just before
     each and read just after), and no plain version called on the card;
  7. torch.profiler over each kernel's main-path call, the single image's
     other cases (K1's outer Canny, K2's 3x3 case and both K2 cases at
     max_r 60) and its batch cases (K3: each of its cases): its launches
     and device reads per call (K1 must be one kernel launch and one device
     read, K3 one launch and no device read) and its device time;
  8. the device busy share of one warm 16-image batch (profiler), then
     K1's main-path profile once more (logged only).

Then one JSON line with each kernel's launches (by path), error, times and
bound, one with the batch throughputs (the sharded ones included), one with
the session's and the loader's numbers, the card's name and power limit,
and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure raises, so the exit code is not 0 and no result line is printed.
Without a CUDA device it exits with 1 before doing anything.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
SIZE = 768           # the 768-class book scan the CLI runs at native size
N_LINES = 19
N_STONES = 40
SEED = 0
BIG = 1280           # the 1280-class scan: K1 staircase planes past a row segment
# K1 rows past 6144 words, the cap of a kernel that held a line in shared memory
WIDE = (16, 6400)
# The batch path: B = 16 diagrams (the JAX CLI's default --batch-size) of
# mixed native sizes in the 768 canvas bucket, the book-scan class: an exact
# fit, margins of 1 and 2 px, and sizes down to 648, each with its own seed
# (sizes and seeds at which the detector reads every planted stone).
BATCH = ((768, 100), (767, 101), (766, 102), (760, 116), (752, 104),
         (744, 105), (736, 106), (728, 107), (720, 108), (712, 109),
         (704, 110), (696, 111), (688, 112), (672, 113), (656, 114),
         (648, 115))
# detect_board_batch: 32 same-size 512^2 diagrams of 13 lines (the 19-line
# 512^2 diagram is not read correctly by either package)
SMALL, SMALL_B, SMALL_LINES, SMALL_STONES, SMALL_SEED = 512, 32, 13, 30, 200
# the fields tests/test_bucketed.py holds bucketed against native detection
BUCKET_FIELDS = ("full_board", "detected_board", "hsize", "vsize",
                 "board_ready", "valid_grid", "num_black", "num_white",
                 "side_to_move", "hspace", "vspace", "intensities",
                 "stone_mask", "edges", "grey", "circles_removed")


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def render_diagram(size=SIZE, n=N_LINES, n_stones=N_STONES, seed=SEED):
    """Seeded synthetic diagram: a grid of 1-px lines, anti-aliased stones
    with a dark outline (white stones are outlined discs). Returns the RGB
    image and the planted stones as {(column, row): colour 1 black/2 white}."""
    rng = np.random.default_rng(seed)
    img = np.full((size, size), 250, np.float32)
    lo, hi = 30, size - 30
    coords = np.linspace(lo, hi, n)
    for c in coords:
        ci = int(round(c))
        img[ci, lo:hi + 1] = 10
        img[lo:hi + 1, ci] = 10
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    r = (coords[1] - coords[0]) * 0.42
    cells = rng.choice(n * n, size=n_stones, replace=False)
    stones = {}
    for k, cell in enumerate(cells):
        i, j = divmod(int(cell), n)
        colour = 0 if k % 2 == 0 else 255
        cx, cy = coords[i], coords[j]
        d = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
        inside = np.clip(r + 0.5 - d, 0, 1)
        img = img * (1 - inside) + colour * inside
        ring = np.clip(0.8 - np.abs(d - r), 0, 1)
        img = img * (1 - ring) + 10 * ring
        stones[(i, j)] = 1 if colour == 0 else 2
    rgb = np.repeat(img.astype(np.uint8)[:, :, None], 3, axis=2)
    return rgb, stones


def staircase_plane(rng, H, W):
    """A candidate plane whose hysteresis needs one sweep per stair: runs of
    1-3 pixels along a row, each run one diagonal hop below the last, seeded
    at the first pixel. Returns (strong, cand) bool numpy planes."""
    cand = np.zeros((H, W), bool)
    strong = np.zeros((H, W), bool)
    for start in (0, W // 2):
        y, x = 0, start
        strong[y, x] = True
        while y < H and x < W:
            n = int(rng.integers(1, 4))
            cand[y, x:min(x + n, W)] = True
            x += n
            y += 1
            if x >= start + W // 2 - 2:
                break
    return strong & cand, cand


def batch_images():
    """The batch path's 16 diagrams: [(rgb, planted stones)]."""
    return [render_diagram(size=size, seed=seed) for size, seed in BATCH]


def bucket(imgs):
    """Images padded top-left into their common canvas bucket, with their
    content dims and line thresholds, as the CLI's --batch builds them."""
    from img2sgf_tpu_torch import bucket_dim, choose_line_threshold

    hb = max(bucket_dim(im.shape[0]) for im in imgs)
    wb = max(bucket_dim(im.shape[1]) for im in imgs)
    canvases = np.zeros((len(imgs), hb, wb, 3), np.uint8)
    for i, im in enumerate(imgs):
        canvases[i, :im.shape[0], :im.shape[1]] = im
    hs = [im.shape[0] for im in imgs]
    ws = [im.shape[1] for im in imgs]
    ths = [choose_line_threshold(h, w) for h, w in zip(hs, ws)]
    return canvases, hs, ws, ths


@contextlib.contextmanager
def recording():
    """Record the arguments of every K1, K2 and K3 wrapper call made through
    the pipeline's own references to them: yields {"K1": [(args, kwargs)],
    "K2": [...], "K3": [...], "threads": {"K1": {idents}, ...}}, "threads"
    holding the idents of the threads that made each kernel's calls."""
    import importlib
    import threading

    # the packages re-export functions under some module names (ops.canny)
    mod = importlib.import_module
    targets = [(mod("img2sgf_tpu_torch.ops.canny"), "hysteresis_packed", "K1"),
               (mod("img2sgf_tpu_torch.hough.circles"), "exact_rescore", "K2"),
               (mod("img2sgf_tpu_torch.pipeline.detect"), "radius_support_pool",
                "K3")]
    calls = {k: [] for _, _, k in targets}
    threads = calls["threads"] = {k: set() for _, _, k in targets}
    saved = [(m, name, getattr(m, name)) for m, name, _ in targets]
    for (m, name, key), (_, _, orig) in zip(targets, saved):
        def rec(*a, _orig=orig, _key=key, **kw):
            calls[_key].append((a, kw))
            threads[_key].add(threading.get_ident())
            return _orig(*a, **kw)
        setattr(m, name, rec)
    try:
        yield calls
    finally:
        for m, name, orig in saved:
            setattr(m, name, orig)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps runs after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def check_equal(name, a, b):
    """Exact equality of two tensors (or tuples); returns max |a - b|."""
    import torch

    if isinstance(a, (tuple, list)):
        return max(check_equal(f"{name}[{i}]", x, y)
                   for i, (x, y) in enumerate(zip(a, b)))
    if a.shape != b.shape:
        raise AssertionError(f"{name}: shapes {tuple(a.shape)} != {tuple(b.shape)}")
    err = (a.double() - b.double()).abs().max().item() if a.numel() else 0.0
    if not torch.equal(a, b):
        raise AssertionError(f"{name}: kernel and plain version differ, "
                             f"max |diff| {err}")
    return err


# Roofline inputs: the published H100 SXM memory rate (NVIDIA data sheet) and
# the int32 rate of 64 lanes per SM per clock, at the card's own SM
# count and maximum SM clock as this run reads them.
HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
# Least int32 instructions of the work each kernel must do (sm_90's LOP3
# does any bitwise function of three words in one):
K1_OPS_PER_WORD_SWEEP = 8   # 4 one-sided fills a | (g & f), the dilation's
#                             two 3-way ORs, the gate-or, the change test
K2_OPS_PER_STEP = 10        # r, two products, two shifts, two offsets,
#                             the patch test and the count
K3_OPS_PER_WINDOW_PIXEL = 1  # the edge test, at annulus pixels in the plane
K3_OPS_PER_EDGE = 2          # bin lookup and count, at edge pixels only


def int32_ops_per_s(dev):
    """(int32 operations per second, maximum SM clock in MHz)."""
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms * INT32_LANES_PER_SM * mhz * 1e6, mhz


def roofline(nbytes, ops, rate):
    """(bound ms, "bytes" or "operations"): the larger of the two times."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k2_walk_steps(emask, ys, xs, valid, max_r, cells):
    """Radius steps K2's walk takes on these inputs: every edge pixel in a
    valid candidate's window walks 2*kmax+1 radii, those of the central
    block twice (box sums over an integral image of emask)."""
    import torch

    from img2sgf_tpu_torch.hough import rescore_cuda

    reach = cells // 2
    kmax = rescore_cuda._geometry(1, max_r, cells)[6]
    P, H, W = emask.shape
    integ = torch.zeros((P, H + 1, W + 1), dtype=torch.int64, device=emask.device)
    integ[:, 1:, 1:] = emask.long().cumsum(1).cumsum(2)
    pidx = torch.arange(P, device=emask.device)[:, None]

    def edges_within(h):
        y0, y1 = (ys - h).clamp(0, H), (ys + h + 1).clamp(0, H)
        x0, x1 = (xs - h).clamp(0, W), (xs + h + 1).clamp(0, W)
        box = (integ[pidx, y1, x1] - integ[pidx, y0, x1]
               - integ[pidx, y1, x0] + integ[pidx, y0, x0])
        return int((box * valid).sum())

    return (edges_within(max_r + reach + 2) + edges_within(2 * reach)) \
        * (2 * kmax + 1)


def k2_bytes(emask, ys, xs, valid, max_r, cells):
    """Bytes K2 must move on these inputs: emask once at the pixels inside
    some valid candidate's window (the kernel reads no other), sx and sy
    (4 B each) only at edge pixels among them, ys and xs (int32), valid,
    and the float32 output."""
    import torch

    P, H, W = emask.shape
    h = max_r + cells // 2 + 2
    y0, y1 = (ys - h).clamp(0, H), (ys + h + 1).clamp(0, H)
    x0, x1 = (xs - h).clamp(0, W), (xs + h + 1).clamp(0, W)
    pidx = torch.arange(P, device=emask.device)[:, None].expand_as(ys)
    m = valid.bool()
    diff = torch.zeros((P, H + 1, W + 1), dtype=torch.int32, device=emask.device)
    one = torch.ones(int(m.sum()), dtype=torch.int32, device=emask.device)
    for yy, xx, sign in ((y0, x0, 1), (y0, x1, -1), (y1, x0, -1), (y1, x1, 1)):
        diff.index_put_((pidx[m], yy[m], xx[m]), sign * one, accumulate=True)
    covered = diff.cumsum(1).cumsum(2)[:, :H, :W] > 0
    n_edges = int((covered & emask).sum())
    return (int(covered.sum()) + 8 * n_edges + 9 * ys.numel()
            + 4 * P * ys.shape[1] * cells * cells)


def k3_work(emask, ys, xs, want, min_r, max_r):
    """(bytes, instructions) K3 must spend on these inputs. Bytes, each
    read or written once: the mask pixels that some wanted window's
    in-plane annulus covers, ys and xs of the wanted slots in their dtype,
    want, the two float32 outputs, the int32 bin map and the row-span
    table. Instructions: an edge test at each in-plane annulus pixel of a
    wanted window, a bin lookup and a count at each edge pixel among them."""
    import torch

    from img2sgf_tpu_torch.hough import radius_cuda

    bmap, win, _ = radius_cuda._bin_map(min_r, max_r)
    dev = emask.device
    ann = torch.from_numpy(np.flatnonzero(bmap >= 0)).to(dev)
    dy, dx = ann // win - max_r, ann % win - max_r
    P, H, W = emask.shape
    rows = want.reshape(-1).nonzero()[:, 0]
    covered = torch.zeros_like(emask)
    n_in = n_edge = 0
    for start in range(0, rows.numel(), 512):
        r = rows[start:start + 512]
        p = (r // ys.shape[1])[:, None].expand(-1, ann.numel())
        yy = ys.reshape(-1)[r][:, None] + dy
        xx = xs.reshape(-1)[r][:, None] + dx
        inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        e = emask[p, yy.clamp(0, H - 1), xx.clamp(0, W - 1)] & inside
        covered[p[inside], yy[inside], xx[inside]] = True
        n_in += int(inside.sum())
        n_edge += int(e.sum())
    nbytes = (int(covered.sum())
              + (ys.element_size() + xs.element_size()) * rows.numel()
              + (1 + 8) * want.numel() + 4 * win * win + 16 * win)
    return nbytes, K3_OPS_PER_WINDOW_PIXEL * n_in + K3_OPS_PER_EDGE * n_edge


def main_path_calls(dev, rgb, cfg):
    """The K1, K2 and K3 wrapper arguments of one detect_board run on the
    768^2 diagram (recording)."""
    from img2sgf_tpu_torch import choose_line_threshold
    from img2sgf_tpu_torch.pipeline import detect_board

    with recording() as calls:
        detect_board(rgb, cfg, choose_line_threshold(*rgb.shape[:2]), device=dev)
    if [len(calls[k]) for k in ("K1", "K2", "K3")] != [2, 2, 1]:
        raise AssertionError("the 768^2 main path's kernel calls: "
                             f"{ {k: len(calls[k]) for k in ('K1', 'K2', 'K3')} }")
    return calls


def k1_cases(dev, calls, rng):
    """K1's inputs: the main path's two Canny calls (recorded) and staircase
    planes whose sweeps bind the cap, past a row segment, and past the old
    6144 line cap. Returns [(label, edge0 words, gate words, iters)]."""
    import torch

    from img2sgf_tpu_torch.ops.canny import pack_planes

    (outer, _), (internal, _) = calls["K1"]
    n_planes = calls["K2"][0][0][0].shape[0]

    def stairs(r, H, W):
        pairs = [staircase_plane(r, H, W) for _ in range(8)]
        return (torch.from_numpy(np.stack([a for a, _ in pairs])).to(dev),
                torch.from_numpy(np.stack([b for _, b in pairs])).to(dev))

    st_s, st_c = stairs(rng, SIZE, SIZE)
    rng2 = np.random.default_rng(SEED + 2)  # new cases keep rng's stream
    big_s, big_c = stairs(rng2, BIG, BIG)
    wide_c = torch.from_numpy(rng2.random((8, *WIDE)) < 0.45).to(dev)
    wide_c[:, 3, :] = True  # a gated run along a whole row
    wide_s = wide_c & torch.from_numpy(rng2.random((8, *WIDE)) < 0.002).to(dev)
    wide_s[:, 3, -1] = True
    cases = [
        ("stairs iters=3", st_s, st_c, 3),
        ("stairs iters=256", st_s, st_c, 256),
        ("stairs iters=256", big_s, big_c, 256),
        (f"random, a {WIDE[1]}-word run", wide_s, wide_c, 256),
    ]
    return [("outer canny", *outer),
            (f"internal canny ({n_planes} planes)", *internal)] + \
        [(label, pack_planes(s & c), pack_planes(c), iters)
         for label, s, c, iters in cases]


def batch_kernel_cases(dev, cfg, batch, rate):
    """Each kernel at the batch path's own inputs, recorded from one run of
    detect_board_bucket_batch on the 16 diagrams: K1's outer Canny ([1,H,W]
    words holding 16 images) and internal Canny ([4,H,W] words, 128 planes),
    K2's 5x5 and 3x3 calls over the 128-plane pool, and K3's. Each equal to
    its plain version, with the call's time, the plain version's and the
    bound. Returns {"K1": [case], "K2": [case], "K3": [case]}."""
    from img2sgf_tpu_torch.hough import radius_cuda, rescore_cuda
    from img2sgf_tpu_torch.ops import hysteresis_cuda as hyst
    from img2sgf_tpu_torch.pipeline import detect_board_bucket_batch

    canvases, hs, ws, ths = bucket([im for im, _ in batch])
    with recording() as calls:
        detect_board_bucket_batch(canvases, cfg, ths, hs, ws, device=dev)
    if [len(calls[k]) for k in ("K1", "K2", "K3")] not in ([2, 2, 1], [2, 4, 2]):
        raise AssertionError("the batch's kernel calls: "
                             f"{ {k: len(calls[k]) for k in ('K1', 'K2', 'K3')} }")
    out = {"K1": [], "K2": [], "K3": []}
    for name, ((e0, g, iters), _) in zip(("outer", "internal"), calls["K1"]):
        label = (f"batch {name} canny [" + ",".join(map(str, e0.shape)) + "]")
        out_k = hyst.hysteresis_packed(e0, g, iters)
        sweeps = hyst.last_sweeps()
        out_p = hyst.hysteresis_packed_plain(e0, g, iters)
        if sweeps != hyst.last_sweeps():
            raise AssertionError(f"K1 {label}: {sweeps} sweeps, the plain "
                                 f"loop ran {hyst.last_sweeps()}")
        err = check_equal(f"K1 {label}", out_k, out_p)
        ms = cuda_ms(lambda: hyst.hysteresis_packed(e0, g, iters), 5)
        pms = cuda_ms(lambda: hyst.hysteresis_packed_plain(e0, g, iters), 1)
        b_ms, b_by = roofline(12 * e0.numel(),
                              K1_OPS_PER_WORD_SWEEP * e0.numel() * sweeps, rate)
        out["K1"].append(dict(label=label, sweeps=sweeps, ms=ms, plain_ms=pms,
                              bound_ms=b_ms, bound_by=b_by, err=err,
                              call=lambda a=(e0, g, iters): hyst.hysteresis_packed(*a)))
        log("kernels", f"K1 hysteresis {label} iters={iters}: equal, {sweeps} "
            f"sweeps (plain loop the same), call {ms:.3f} ms, plain {pms:.3f} "
            f"ms, bound {b_ms * 1e3:.2f} us ({b_by})")
    for args, kw in calls["K2"]:
        emask, ys, xs, valid = args[0], args[3], args[4], args[5]
        max_r, cells = args[7], kw["cells"]
        label = f"batch cells={cells} [{ys.shape[0]},{ys.shape[1]}]"
        out_k = rescore_cuda.exact_rescore(*args, **kw)
        out_p = rescore_cuda.exact_rescore_plain(*args, **kw)
        err = check_equal(f"K2 {label}", out_k, out_p)
        ms = cuda_ms(lambda: rescore_cuda.exact_rescore(*args, **kw), 10)
        pms = cuda_ms(lambda: rescore_cuda.exact_rescore_plain(*args, **kw), 1)
        steps = k2_walk_steps(emask, ys, xs, valid, max_r, cells)
        nbytes = k2_bytes(emask, ys, xs, valid, max_r, cells)
        b_ms, b_by = roofline(nbytes, K2_OPS_PER_STEP * steps, rate)
        out["K2"].append(dict(label=label, ms=ms, plain_ms=pms, bound_ms=b_ms,
                              bound_by=b_by, err=err, valid=int(valid.sum()),
                              call=lambda a=args, k=kw: rescore_cuda.exact_rescore(*a, **k)))
        log("kernels", f"K2 rescore {label} valid={int(valid.sum())}: equal, "
            f"call {ms:.3f} ms, plain {pms:.3f} ms, bound {b_ms * 1e3:.2f} us "
            f"({b_by}: {steps} walk steps, {nbytes / 1e6:.1f} MB)")
    for args, kw in calls["K3"]:
        emask, ys, xs, want, min_r, max_r = args
        label = f"batch [{ys.shape[0]},{ys.shape[1]}]"
        out_k = radius_cuda.radius_support_pool(*args)
        out_p = radius_cuda.radius_support_pool_plain(*args)
        err = check_equal(f"K3 {label}", out_k, out_p)
        ms = cuda_ms(lambda: radius_cuda.radius_support_pool(*args), 10)
        pms = cuda_ms(lambda: radius_cuda.radius_support_pool_plain(*args), 1)
        nbytes, ops = k3_work(*args)
        b_ms, b_by = roofline(nbytes, ops, rate)
        out["K3"].append(dict(label=label, max_r=max_r, wanted=int(want.sum()),
                              ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                              err=err,
                              call=lambda a=args: radius_cuda.radius_support_pool(*a)))
        log("kernels", f"K3 radius {label} wanted={int(want.sum())}: equal, "
            f"call {ms:.3f} ms, plain {pms:.3f} ms, bound {b_ms * 1e3:.2f} us "
            f"({b_by}: {ops} instructions, {nbytes / 1e6:.2f} MB)")
    return out


def phase_kernels(dev, rgb, cfg, batch):
    """Phase 2: each kernel against its plain version on the card, with the
    call's time, the plain version's, and the roofline bound; at the
    single-image path's shapes and at the batch path's
    (batch_kernel_cases)."""
    import torch

    from img2sgf_tpu_torch.hough import radius_cuda, rescore_cuda
    from img2sgf_tpu_torch.ops import hysteresis_cuda as hyst
    from img2sgf_tpu_torch.pipeline.detect import (
        _overflow_budgets, _select_candidates)

    rng = np.random.default_rng(SEED + 1)
    rate, mhz = int32_ops_per_s(dev)
    log("kernels", f"int32 rate {rate / 1e12:.2f} T op/s (64 lanes x SMs x "
        f"{mhz:.0f} MHz max SM clock); memory {HBM_BYTES_PER_S / 1e12} TB/s")
    results = {}
    calls = main_path_calls(dev, rgb, cfg)

    # --- K1
    err = 0.0
    k1 = []
    cases = k1_cases(dev, calls, rng)
    for label, e0, g, iters in cases:
        shape = "[" + ",".join(map(str, e0.shape)) + "]"
        out_k = hyst.hysteresis_packed(e0, g, iters)
        sweeps = hyst.last_sweeps()
        out_p = hyst.hysteresis_packed_plain(e0, g, iters)
        plain_sweeps = hyst.last_sweeps()
        if sweeps != plain_sweeps:
            raise AssertionError(f"K1 {label} {shape}: {sweeps} sweeps, the "
                                 f"plain loop ran {plain_sweeps}")
        err = max(err, check_equal(f"K1 {label} {shape}", out_k, out_p))
        big = e0.numel() > SIZE * SIZE
        ms = cuda_ms(lambda: hyst.hysteresis_packed(e0, g, iters), 5)
        pms = cuda_ms(lambda: hyst.hysteresis_packed_plain(e0, g, iters),
                      1 if big else 2)
        b_ms, b_by = roofline(12 * e0.numel(),
                              K1_OPS_PER_WORD_SWEEP * e0.numel() * sweeps, rate)
        k1.append(dict(label=f"{label} {shape}", sweeps=sweeps, ms=ms,
                       plain_ms=pms, bound_ms=b_ms, bound_by=b_by))
        log("kernels", f"K1 hysteresis {label} words {shape} iters={iters}: "
            f"equal, {sweeps} sweeps (plain loop {plain_sweeps}), kernel {ms:.3f} ms "
            f"({ms / sweeps * 1e3:.1f} us/sweep), plain {pms:.3f} ms, bound "
            f"{b_ms * 1e3:.2f} us ({b_by}; bytes alone "
            f"{12 * e0.numel() / HBM_BYTES_PER_S * 1e6:.2f} us)")
    main = k1[1]  # the internal Canny: most of K1's main-path work
    results["K1"] = dict(err=err, ms=main["ms"], plain_ms=main["plain_ms"],
                         bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                         sweeps=main["sweeps"],
                         call=lambda: hyst.hysteresis_packed(*cases[1][1:]))

    # --- K2 / K3 on the main path's plane state (recorded), with random
    # centres and prefixes and with the main path's own radius inputs
    emask, sx, sy = calls["K2"][0][0][:3]
    P = emask.shape[0]
    err = 0.0
    k2 = []
    main_args = None  # cells 5 at the config's radius: the main path's case
    draws = [(5, cfg.max_center_candidates), (3, cfg.max_ring_candidates)]
    draws = [(cells, K, rng.integers(0, SIZE, (P, K)), rng.integers(0, SIZE, (P, K)),
              np.concatenate([[0, K, 1], rng.integers(1, K, P - 3)]))
             for cells, K in draws]
    for max_r in (cfg.circle_max_radius, 60):
        for cells, K, ys_np, xs_np, n_valid in draws:
            ys = torch.from_numpy(ys_np).to(dev)
            xs = torch.from_numpy(xs_np).to(dev)
            valid = torch.from_numpy(np.arange(K)[None, :] < n_valid[:, None]).to(dev)
            args = (emask, sx, sy, ys, xs, valid, cfg.circle_min_radius,
                    max_r)
            main_args = main_args or args
            out_k = rescore_cuda.exact_rescore(*args, cells=cells)
            out_p = rescore_cuda.exact_rescore_plain(*args, cells=cells)
            label = f"cells={cells} [{P},{K}] max_r={max_r}"
            err = max(err, check_equal(f"K2 {label}", out_k, out_p))
            ms = cuda_ms(lambda: rescore_cuda.exact_rescore(*args, cells=cells), 10)
            pms = cuda_ms(lambda: rescore_cuda.exact_rescore_plain(*args, cells=cells), 1)
            steps = k2_walk_steps(emask, ys, xs, valid, max_r, cells)
            nbytes = k2_bytes(emask, ys, xs, valid, max_r, cells)
            b_ms, b_by = roofline(nbytes, K2_OPS_PER_STEP * steps, rate)
            k2.append(dict(label=label, ms=ms, plain_ms=pms, bound_ms=b_ms,
                           bound_by=b_by, valid=int(valid.sum()),
                           call=lambda a=args, c=cells:
                               rescore_cuda.exact_rescore(*a, cells=c)))
            log("kernels", f"K2 rescore {label} valid={int(valid.sum())}: "
                f"equal, kernel {ms:.3f} ms, plain {pms:.3f} ms, bound "
                f"{b_ms * 1e3:.2f} us ({b_by}: {steps} walk steps, "
                f"{nbytes / 1e6:.1f} MB)")
    results["K2"] = dict(err=err, ms=k2[0]["ms"], plain_ms=k2[0]["plain_ms"],
                         bound_ms=k2[0]["bound_ms"], bound_by=k2[0]["bound_by"],
                         call=lambda: rescore_cuda.exact_rescore(*main_args,
                                                                 cells=5))

    K = cfg.max_peak_candidates
    ys = torch.from_numpy(rng.integers(0, SIZE, (P, K))).to(dev)
    xs = torch.from_numpy(rng.integers(0, SIZE, (P, K))).to(dev)
    n_want = np.concatenate([[0, K, 1], rng.integers(1, K, P - 3)])
    want = torch.from_numpy(np.arange(K)[None, :] < n_want[:, None]).to(dev)
    min_r = cfg.circle_min_radius
    _, ys_m, xs_m, want_m = calls["K3"][0][0][:4]
    _, _, sub = overflow_state(dev, cfg)
    ys_o, xs_o, want_o, _ = _select_candidates(sub, cfg,
                                               **_overflow_budgets(cfg))
    k3_cases = [  # the main path's case first: it gives the kernel's JSON row
        (f"768^2 main path [{P},{K}]", emask, ys_m, xs_m, want_m,
         cfg.circle_max_radius),
        (f"random [{P},{K}]", emask, ys, xs, want, cfg.circle_max_radius),
        (f"random [{P},{K}]", emask, ys, xs, want, 60),
        (f"noisy 256^2 overflow rerun [{sub['emask'].shape[0]},"
         f"{ys_o.shape[1]}]", sub["emask"], ys_o, xs_o, want_o,
         cfg.circle_max_radius),
    ]
    err = 0.0
    k3 = []
    for label, em, y, x, w, max_r in k3_cases:
        args = (em, y, x, w, min_r, max_r)
        out_k = radius_cuda.radius_support_pool(*args)
        out_p = radius_cuda.radius_support_pool_plain(*args)
        err = max(err, check_equal(f"K3 {label}", out_k, out_p))
        ms = cuda_ms(lambda: radius_cuda.radius_support_pool(*args), 10)
        pms = cuda_ms(lambda: radius_cuda.radius_support_pool_plain(*args), 2)
        nbytes, ops = k3_work(*args)
        b_ms, b_by = roofline(nbytes, ops, rate)
        k3.append(dict(label=label, max_r=max_r, wanted=int(w.sum()), ms=ms,
                       plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                       call=lambda a=args: radius_cuda.radius_support_pool(*a)))
        log("kernels", f"K3 radius {label} wanted={int(w.sum())} "
            f"max_r={max_r} ys {str(y.dtype)[6:]}: equal, call {ms:.3f} ms, "
            f"plain {pms:.3f} ms, bound {b_ms * 1e3:.2f} us ({b_by}: {ops} "
            f"instructions, {nbytes / 1e6:.2f} MB)")
    results["K3"] = dict(err=err, label=k3[0]["label"], wanted=k3[0]["wanted"],
                         ms=k3[0]["ms"], plain_ms=k3[0]["plain_ms"],
                         bound_ms=k3[0]["bound_ms"], bound_by=k3[0]["bound_by"],
                         cases=k3)

    # --- the batch path's own inputs; the single-image main case stays
    # first, then the single image's other cases that phase 7 profiles (the
    # outer Canny, K2's 3x3 patches and both at max_r 60)
    batched = batch_kernel_cases(dev, cfg, batch, rate)
    outer = dict(k1[0], call=lambda: hyst.hysteresis_packed(*cases[0][1:]))
    results["K1"]["cases"] = [dict(label="internal canny (main path)",
                                   call=results["K1"]["call"]),
                              outer] + batched["K1"]
    results["K2"]["cases"] = [dict(label="cells=5 (main path)",
                                   call=results["K2"]["call"])] \
        + k2[1:] + batched["K2"]
    results["K3"]["cases"] += batched["K3"]
    for k in results:
        results[k]["err"] = max([results[k]["err"]]
                                + [c["err"] for c in batched[k]])
    return results


KERNEL_NAMES = {"K1": "hysteresis_kernel", "K2": "rescore_kernel",
                "K3": "radius_kernel"}


def profile_call(call, name, reps):
    """torch.profiler over `reps` calls: per call, the device kernels
    launched, those named `name`, and the device-to-host copies; the
    device time of `name` per call, and the other kernels' names. A call
    with no device events recorded fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not evs:
        raise AssertionError(f"{name}: the profiler recorded no device "
                             "activity, so launches per call are unchecked")
    d2h = [e for e in evs if e.name.startswith("Memcpy") and "DtoH" in e.name]
    launched = [e for e in evs if not e.name.startswith(("Memcpy", "Memset"))]
    mine = [e for e in launched if name in e.name]
    kernel_ms = sum(e.time_range.elapsed_us() for e in mine) / reps / 1e3
    others = sorted({e.name.split("(")[0][:60] for e in launched
                     if name not in e.name})
    return (len(launched) / reps, len(mine) / reps, len(d2h) / reps,
            kernel_ms, others)


def phase_profile(kernels, reps=5):
    """Phase 6: torch.profiler over `reps` calls of each kernel's wrapper
    at its main-path case (K3: at each of its cases): the device kernels
    and device-to-host copies of a call, and the kernel's own device time.
    K1 must be one kernel and one copy per call, K3 one kernel and no
    copy."""
    for k, name in KERNEL_NAMES.items():
        r = kernels[k]
        cases = r.get("cases") or [dict(label="main path", call=r["call"])]
        for case in cases:
            n, n_mine, n_d2h, kernel_ms, others = profile_call(
                case["call"], name, reps)
            case["kernel_ms"] = kernel_ms
            label = case["label"] + (f" max_r={case['max_r']}"
                                     if "max_r" in case else "")
            log("profile", f"{k} {label}: per call {n:g} kernel "
                f"launches ({n_mine:g} of {name}), {n_d2h:g} device-to-host "
                f"copies; {name} device time {kernel_ms:.4f} ms; other "
                f"kernels: {others}")
            if k == "K1" and (n, n_mine, n_d2h) != (1, 1, 1):
                raise AssertionError("K1 is not one launch and one device "
                                     "read per call")
            if k == "K3" and (n, n_mine, n_d2h) != (1, 1, 0):
                raise AssertionError(f"K3 {label} is not one launch "
                                     "and no device read per call")
        r["kernel_ms"] = cases[0]["kernel_ms"]


def phase_tables(dev):
    """Phase 3: direction bins and walk steps, CUDA against CPU."""
    import torch

    from img2sgf_tpu_torch.hough.circles import direction_bins, pixel_steps

    v = torch.arange(-1020, 1021, dtype=torch.int32)
    dx = v.repeat_interleave(v.numel()).reshape(v.numel(), v.numel())
    dy = v.repeat(v.numel()).reshape(v.numel(), v.numel())
    b_cpu = direction_bins(dx, dy, 64)
    b_gpu = direction_bins(dx.to(dev), dy.to(dev), 64).cpu()
    s_cpu = pixel_steps(dx, dy)
    s_gpu = [t.cpu() for t in pixel_steps(dx.to(dev), dy.to(dev))]
    nb = int((b_cpu != b_gpu).sum())
    ns = int((s_cpu[0] != s_gpu[0]).sum() + (s_cpu[1] != s_gpu[1]).sum())
    if nb or ns:
        raise AssertionError(f"CUDA and CPU differ: {nb} direction bins, "
                             f"{ns} walk steps of {dx.numel()} pairs")
    log("tables", f"direction_bins and pixel_steps equal on all "
        f"{dx.numel()} gradient pairs (CUDA vs CPU)")


def compare_results(a, b, label):
    """Every BoardResult field bit-equal (values, shape, dtype)."""
    import torch

    bad = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name).cpu(), getattr(b, f.name).cpu()
        if x.shape != y.shape or x.dtype != y.dtype or not torch.equal(x, y):
            bad.append(f.name)
    if bad:
        raise AssertionError(f"{label}: BoardResult fields differ: {bad}")


def phase_main_path(dev, rgb, stones, cfg):
    """Phase 4: the CLI and detect_board on the card; checks; timings."""
    import torch

    from img2sgf_tpu_torch import choose_line_threshold, to_sgf
    from img2sgf_tpu_torch.hough import radius_cuda, rescore_cuda
    from img2sgf_tpu_torch.ops import hysteresis_cuda
    from img2sgf_tpu_torch.pipeline import detect_board

    counters = (hysteresis_cuda, rescore_cuda, radius_cuda)
    thr = choose_line_threshold(rgb.shape[0], rgb.shape[1])

    # the counted main-path run
    for m in counters:
        m.launches = 0
        m.plain_calls = 0
    res = detect_board(rgb, cfg, thr, device=dev)
    torch.cuda.synchronize()
    launches = {m.__name__.rsplit(".", 1)[1]: m.launches for m in counters}
    if any(m.plain_calls for m in counters):
        raise AssertionError("the main path called a plain version on the card")

    if not bool(res.board_ready):
        raise AssertionError("board not ready on the synthetic diagram")
    if int(res.hsize) != N_LINES or int(res.vsize) != N_LINES:
        raise AssertionError(f"grid {int(res.hsize)}x{int(res.vsize)}")
    board = res.full_board.cpu().numpy()
    missed = {ij: c for ij, c in stones.items() if board[ij] != c}
    if missed:
        raise AssertionError(f"planted stones missed or miscoloured: {missed}")
    phantoms = int((board > 0).sum()) - len(stones)
    log("main", f"detect_board: board_ready, {N_LINES}x{N_LINES}, all "
        f"{len(stones)} planted stones found with their colours "
        f"({phantoms} extra stones at bare points)")

    with tempfile.TemporaryDirectory() as tmp:
        from PIL import Image

        png = os.path.join(tmp, "diagram.png")
        sgf_path = os.path.join(tmp, "diagram.sgf")
        Image.fromarray(rgb).save(png)
        proc = subprocess.run(
            [sys.executable, "-m", "img2sgf_tpu_torch", "--device", "cuda",
             png, sgf_path], cwd=HERE, capture_output=True, text=True,
            timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"CLI failed ({proc.returncode}):\n"
                                 f"{proc.stdout}\n{proc.stderr}")
        with open(sgf_path) as f:
            sgf_cli = f.read()
    sgf = to_sgf(res.full_board, side_to_move=int(res.side_to_move))
    if sgf_cli != sgf:
        raise AssertionError("CLI SGF differs from to_sgf of detect_board")
    log("main", f"CLI --device cuda wrote the same SGF ({len(sgf)} bytes)")

    # warm wall time and per-stage times
    walls, stages = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        detect_board(rgb, cfg, thr, device=dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        tm = {}
        detect_board(rgb, cfg, thr, device=dev, timings=tm)
        stages.append(tm)
    wall_ms = statistics.median(walls) * 1e3
    stage_ms = {k: statistics.median(s[k] for s in stages) * 1e3
                for k in stages[0]}
    log("main", f"warm wall time, median of 5: {wall_ms:.1f} ms; stages "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in stage_ms.items()))

    # the main-path result against the port's own CPU run, field by field
    t0 = time.perf_counter()
    res_c = detect_board(rgb, cfg, thr, device="cpu")
    cpu_s = time.perf_counter() - t0
    compare_results(res, res_c, f"CUDA vs CPU at {SIZE}^2")
    log("main", f"BoardResult at {SIZE}x{SIZE}: CUDA and CPU runs "
        f"bit-equal in every field (CPU run {cpu_s:.1f} s)")
    return launches, wall_ms, stage_ms


def noisy_diagram():
    """A 256x256 9x9 diagram under seeded noise, whose planes saturate the
    base budgets, so that the overflow rerun runs."""
    rgb, _ = render_diagram(size=256, n=9, n_stones=10)
    rng = np.random.default_rng(SEED + 7)
    noise = rng.integers(-60, 61, rgb.shape[:2])[..., None]
    return np.clip(rgb.astype(np.int16) + noise, 0, 255).astype(np.uint8)


def overflow_state(dev, cfg):
    """The noisy diagram's plane state, its saturation flags, and the state
    of its saturated planes, which the overflow rerun takes."""
    import torch

    from img2sgf_tpu_torch.pipeline.detect import (
        _circles_from_state, _plane_state_pool, _pre_circles, _variant_dedup)

    v = _pre_circles(torch.from_numpy(noisy_diagram()).to(dev)[None], cfg)[2][0]
    keep, _ = _variant_dedup(cfg, v.shape[0])
    st = _plane_state_pool(v[keep], cfg)
    _, _, sat = _circles_from_state(st, cfg, margin_filter=True)
    redo = sat.nonzero()[:, 0]
    if not redo.numel():
        raise AssertionError("the noisy diagram no longer saturates a plane")
    return st, sat, {k: t[redo] for k, t in st.items()}


def phase_overflow(dev, cfg):
    """Phase 4b: the noisy diagram, whose overflow rerun (K2 at 16384
    proposals, K3 at 8192 peaks) runs on the card: its BoardResult must
    equal the CPU run's bit for bit; then the wall time of the base
    selection of every plane and of the rerun alone."""
    import torch

    from img2sgf_tpu_torch.pipeline import detect_board
    from img2sgf_tpu_torch.pipeline.detect import (
        _circles_from_state, _overflow_budgets)

    rgb = noisy_diagram()
    st, sat, sub = overflow_state(dev, cfg)
    res_g = detect_board(rgb, cfg, 30, device=dev)
    res_c = detect_board(rgb, cfg, 30, device="cpu")
    compare_results(res_g, res_c, "overflow rerun, CUDA vs CPU")

    def wall_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return statistics.median(walls) * 1e3

    base_ms = wall_ms(lambda: _circles_from_state(st, cfg, margin_filter=True))
    rerun_ms = wall_ms(lambda: _circles_from_state(sub, cfg,
                                                   **_overflow_budgets(cfg)))
    log("main", f"overflow rerun of {int(sat.sum())} saturated planes of "
        f"{sat.numel()} (noisy 256x256 diagram): CUDA and CPU BoardResults "
        f"bit-equal; wall, median of 5: base selection of all planes "
        f"{base_ms:.2f} ms, the rerun alone {rerun_ms:.2f} ms")
    return rerun_ms


COUNTERS = {"K1": "hysteresis_cuda", "K2": "rescore_cuda", "K3": "radius_cuda"}


@contextlib.contextmanager
def counted(out: dict):
    """Set every kernel's launch count (and plain-version call count) to 0,
    run the body, then store the launch counts (by kernel) in out. A path on
    the card that called a plain version fails."""
    import torch

    from img2sgf_tpu_torch.hough import radius_cuda, rescore_cuda
    from img2sgf_tpu_torch.ops import hysteresis_cuda

    mods = {"K1": hysteresis_cuda, "K2": rescore_cuda, "K3": radius_cuda}
    for m in mods.values():
        m.launches = 0
        m.plain_calls = 0
    yield
    torch.cuda.synchronize()
    out.update({k: m.launches for k, m in mods.items()})
    plain = {k: m.plain_calls for k, m in mods.items() if m.plain_calls}
    if plain:
        raise AssertionError(f"plain versions called on the card: {plain}")


def check_batch_launches(launches, label):
    """One batch makes 2 K1 calls (outer and internal Canny), 2 K2 and 1 K3,
    plus 2 K2 and 1 K3 when a plane saturates, whatever its size."""
    k1, k2, k3 = launches["K1"], launches["K2"], launches["K3"]
    if k1 != 2 or k3 not in (1, 2) or k2 != 2 * k3:
        raise AssertionError(f"{label}: launches {launches}, expected K1 2, "
                             "K2 2 and K3 1 (plus 2 and 1 with a rerun)")


def check_stones(res, i, stones, n_lines, label):
    """Row i of a batch result: board-ready, n_lines x n_lines, and every
    planted stone with its colour. Returns the extra stones' count."""
    if not bool(res.board_ready[i]):
        raise AssertionError(f"{label} image {i}: board not ready")
    if int(res.hsize[i]) != n_lines or int(res.vsize[i]) != n_lines:
        raise AssertionError(f"{label} image {i}: grid "
                             f"{int(res.hsize[i])}x{int(res.vsize[i])}")
    board = res.full_board[i].cpu().numpy()
    missed = {ij: c for ij, c in stones.items() if board[ij] != c}
    if missed:
        raise AssertionError(f"{label} image {i}: planted stones missed or "
                             f"miscoloured: {missed}")
    return int((board > 0).sum()) - len(stones)


def wall_runs(fn, reps=5):
    """Median host wall time (s) of reps runs of fn ending in a device
    sync, after one warm-up, and the per-stage medians when fn takes a
    timings dict."""
    import torch

    fn({})
    walls, stages = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(None)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        tm = {}
        fn(tm)
        stages.append(tm)
    return (statistics.median(walls),
            {k: statistics.median(s[k] for s in stages) * 1e3 for k in stages[0]})


def device_busy(fn, top=6):
    """One warm run of fn under torch.profiler: (wall ms, device busy ms
    summed over its kernels and copies, their count, the `top` names by
    device time as (name, ms, count))."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not evs:
        raise AssertionError("the profiler recorded no device activity")
    by_name = {}
    for e in evs:
        ms, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, cnt + 1)
    busy = sum(ms for ms, _ in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return wall * 1e3, busy, len(evs), [(k, ms, c) for k, (ms, c) in ranked]


def phase_busy(dev, cfg, batch):
    """Phase 8: the device busy share of one warm 16-image bucket batch
    under torch.profiler (last of all: a profiled run of ~18,000 device
    events has made the next profiled run drop a kernel event)."""
    from img2sgf_tpu_torch.pipeline import detect_board_bucket_batch

    canvases, hs, ws, ths = bucket([im for im, _ in batch])
    wall_ms, busy_ms, n, top = device_busy(lambda: detect_board_bucket_batch(
        canvases, cfg, ths, hs, ws, device=dev))
    log("busy", f"bucket batch B={len(batch)} under torch.profiler: wall "
        f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms (share "
        f"{busy_ms / wall_ms:.3f}) over {n} device kernels and copies; most "
        "device time: " + "; ".join(f"{name[:80]} {ms:.1f} ms x{cnt}"
                                    for name, ms, cnt in top))
    return dict(profiled_wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_busy_share=busy_ms / wall_ms, device_events=n)


def phase_batch(dev, cfg, batch):
    """Phase 5: the batch path. detect_board_bucket_batch on the 16
    diagrams (counted): every image read; each row equal to
    detect_board_auto of its image in every field; detect_board_auto equal
    to native detect_board at margins 0 and >= 3; a sub-batch of 3 (margins
    0, 1, 2) equal to its CPU run and to its rows of the 16; launch counts
    that do not grow with B; the CLI's --batch; then detect_board_batch on
    32 512^2 diagrams (counted), and the warm throughput of both batches
    and of the 16 images through detect_board and detect_board_auto one by
    one."""
    import torch

    from img2sgf_tpu_torch import to_sgf
    from img2sgf_tpu_torch.pipeline import (
        detect_board, detect_board_auto, detect_board_batch,
        detect_board_bucket_batch)

    imgs = [im for im, _ in batch]
    canvases, hs, ws, ths = bucket(imgs)
    B, Hc, Wc = canvases.shape[:3]
    paths = {}
    launches = {}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with counted(launches):
        res = detect_board_bucket_batch(canvases, cfg, ths, hs, ws, device=dev)
    peak_gb = (torch.cuda.max_memory_allocated(dev) / 1e9
               if dev.type == "cuda" else float("nan"))
    paths[f"detect_board_bucket_batch B={B} {Hc}"] = launches
    check_batch_launches(launches, f"B={B} bucket batch")
    extra = sum(check_stones(res, i, stones, N_LINES, "bucket batch")
                for i, (_, stones) in enumerate(batch))
    log("batch", f"detect_board_bucket_batch, {B} images {min(hs)}-{max(hs)} "
        f"px in the {Hc} canvas: every image board_ready with all its planted "
        f"stones and colours ({extra} extra stones in all); launches "
        f"{launches}; peak device memory {peak_gb:.2f} GB")

    for i, im in enumerate(imgs):
        single = detect_board_auto(im, cfg, ths[i], device=dev)
        h, w = hs[i], ws[i]
        for f in dataclasses.fields(single):
            row = getattr(res, f.name)[i]
            if f.name in ("grey", "edges", "circles_removed"):
                row = row[:h, :w]
            got = getattr(single, f.name)
            if row.dtype != got.dtype or not torch.equal(row, got):
                raise AssertionError(f"batch row {i} differs from "
                                     f"detect_board_auto in {f.name}")
        margin = min(Hc - h, Wc - w)
        if margin in (1, 2):
            continue
        native = detect_board(im, cfg, ths[i], device=dev)
        bad = [f for f in BUCKET_FIELDS
               if not torch.equal(getattr(native, f), getattr(single, f))]
        if bad:
            raise AssertionError(f"image {i} (margin {margin}): "
                                 f"detect_board_auto differs from native "
                                 f"detect_board in {bad}")
    log("batch", f"each batch row equals detect_board_auto of its image in "
        f"every field; detect_board_auto equals native detect_board in "
        f"{len(BUCKET_FIELDS)} fields at margins 0 and >= 3")

    sub = [0, 1, 2]  # margins 0, 1 and 2
    sub_args = (canvases[sub], cfg, [ths[i] for i in sub], [hs[i] for i in sub],
                [ws[i] for i in sub])
    launches3 = {}
    with counted(launches3):
        res3 = detect_board_bucket_batch(*sub_args, device=dev)
    check_batch_launches(launches3, f"B={len(sub)} bucket batch")
    if launches3 != launches:
        log("batch", f"note: B={len(sub)} launches {launches3} against "
            f"B={B} {launches} (a plane saturates in one of them)")
    t0 = time.perf_counter()
    res3c = detect_board_bucket_batch(*sub_args, device="cpu")
    cpu_s = time.perf_counter() - t0
    compare_results(res3, res3c, f"bucket batch of {len(sub)}, CUDA vs CPU")
    for j, i in enumerate(sub):
        for f in dataclasses.fields(res3):
            if not torch.equal(getattr(res3, f.name)[j], getattr(res, f.name)[i]):
                raise AssertionError(f"image {i}: its row of the B={len(sub)} "
                                     f"batch differs from B={B} in {f.name}")
    log("batch", f"B={len(sub)} sub-batch (margins 0, 1, 2): CUDA and CPU "
        f"bit-equal in every field (CPU run {cpu_s:.1f} s), rows equal to the "
        f"B={B} batch's; launches {launches3}"
        + (f", as at B={B}" if launches3 == launches else ""))

    with tempfile.TemporaryDirectory() as tmp:
        from PIL import Image

        names = [f"d{i:02d}" for i in range(B)]
        for name, im in zip(names, imgs):
            Image.fromarray(im).save(os.path.join(tmp, name + ".png"))
        out = os.path.join(tmp, "out")
        proc = subprocess.run(
            [sys.executable, "-m", "img2sgf_tpu_torch", "--batch",
             os.path.join(tmp, "*.png"), "-o", out, "--device", dev.type],
            cwd=HERE, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"CLI --batch failed ({proc.returncode}):\n"
                                 f"{proc.stdout}\n{proc.stderr}")
        for i, name in enumerate(names):
            with open(os.path.join(out, name + ".sgf")) as f:
                got = f.read()
            if got != to_sgf(res.full_board[i], side_to_move=int(res.side_to_move[i])):
                raise AssertionError(f"CLI --batch SGF of image {i} differs "
                                     "from to_sgf of its batch row")
    log("batch", f"CLI --batch --device {dev.type} wrote {B} SGFs, each equal to "
        f"to_sgf of its batch row ({proc.stdout.strip().splitlines()[-1]})")

    small = [render_diagram(size=SMALL, n=SMALL_LINES, n_stones=SMALL_STONES,
                            seed=SMALL_SEED + i) for i in range(SMALL_B)]
    sbatch = np.stack([im for im, _ in small])
    from img2sgf_tpu_torch import choose_line_threshold

    sths = [choose_line_threshold(SMALL, SMALL)] * SMALL_B
    launches512 = {}
    with counted(launches512):
        res512 = detect_board_batch(sbatch, cfg, sths, device=dev)
    paths[f"detect_board_batch B={SMALL_B} {SMALL}"] = launches512
    check_batch_launches(launches512, f"B={SMALL_B} batch")
    extra = sum(check_stones(res512, i, stones, SMALL_LINES, "512 batch")
                for i, (_, stones) in enumerate(small))
    log("batch", f"detect_board_batch, {SMALL_B} images {SMALL}x{SMALL}: every "
        f"image board_ready with all its planted stones ({extra} extra in "
        f"all); launches {launches512}")

    tput = {}
    wall, stages = wall_runs(lambda tm: detect_board_bucket_batch(
        canvases, cfg, ths, hs, ws, device=dev, timings=tm))
    tput[f"bucket_batch_{Hc}_B{B}"] = dict(img_per_s=B / wall, wall_ms=wall * 1e3,
                                           stage_ms=stages)
    wall, stages = wall_runs(lambda tm: detect_board_batch(
        sbatch, cfg, sths, device=dev, timings=tm))
    tput[f"batch_{SMALL}_B{SMALL_B}"] = dict(img_per_s=SMALL_B / wall,
                                             wall_ms=wall * 1e3, stage_ms=stages)

    def one_by_one(tm):
        st = {}
        for i, im in enumerate(imgs):
            detect_board(im, cfg, ths[i], device=dev, timings=st)
            if tm is not None:
                for k, v in st.items():
                    tm[k] = tm.get(k, 0.0) + v
    def auto_one_by_one(tm):
        st = {}
        for i, im in enumerate(imgs):
            detect_board_auto(im, cfg, ths[i], device=dev, timings=st)
            if tm is not None:
                for k, v in st.items():
                    tm[k] = tm.get(k, 0.0) + v
    # detect_board at 16 native shapes; detect_board_auto at the one canvas
    # shape the batch uses (the Hough-line tables are cached by shape)
    for name, fn in ((f"detect_board_loop_{Hc}_x{B}", one_by_one),
                     (f"detect_board_auto_loop_{Hc}_x{B}", auto_one_by_one)):
        wall, stages = wall_runs(fn, reps=3)
        tput[name] = dict(img_per_s=B / wall, wall_ms=wall * 1e3,
                          stage_ms=stages)
    for name, t in tput.items():
        log("batch", f"{name}: {t['img_per_s']:.2f} img/s warm (wall "
            f"{t['wall_ms']:.1f} ms, median); stages (summed over the loop "
            f"for detect_board) " + ", ".join(f"{k} {v:.1f} ms"
                                              for k, v in t["stage_ms"].items()))
    return paths, tput, (sbatch, sths)


# The editing session's action script (phase 5b): what a GUI user does to
# the 768^2 diagram. The zoom drags over the top-left 420 px of a canvas
# showing the image at scale 1, so the crop re-detects in the 512 bucket.
SESSION_ACTIONS = ("process", "set_alignment", "cycle_stone", "reclassify",
                   "select_region", "rotate", "zoom_out")
ZOOM = ([0, 0, 420, 420], (SIZE, SIZE))
ALTERED_BLACK_THRESHOLD = 60


def session_script(session, rgb, lines):
    """Run the action script on a DetectSession whose log appends to
    `lines`; after each action: its name, its wall seconds, the log so far,
    the full board, side to move and SGF text."""
    from img2sgf_tpu_torch.core import Alignment

    def reclassify():
        session.black_stone_threshold = ALTERED_BLACK_THRESHOLD
        session.reclassify()

    def rotate():
        session.rotate_deg = 2
        session.process()

    acts = {
        "process": lambda: (session.load_image(rgb), session.process()),
        "set_alignment": lambda: session.set_alignment(Alignment.RIGHT,
                                                       Alignment.BOTTOM),
        "cycle_stone": lambda: session.cycle_stone(0, 0, right_click=False),
        "reclassify": reclassify,
        "select_region": lambda: session.select_region(*ZOOM),
        "rotate": rotate,
        "zoom_out": session.zoom_out,
    }
    steps = []
    for name in SESSION_ACTIONS:
        t0 = time.perf_counter()
        acts[name]()
        dt = time.perf_counter() - t0
        fb = session.full_board
        steps.append(dict(action=name, seconds=dt, log=list(lines),
                          board=None if fb is None else fb.copy(),
                          side=int(session.side_to_move),
                          sgf=None if fb is None else session.sgf_text(),
                          ready=session.board_ready))
    return steps


def phase_session(dev, rgb, cfg):
    """Phase 5b: the editing session (DetectSession) on the card. The action
    script on device="cuda" and on device="cpu" gives, after every action,
    the same log lines, full board, side to move and SGF; one process() is
    counted (2 K1, 2 K2, 1 K3 as any batch of one) and reclassify launches
    nothing; then the warm wall time of each action, median of 3 scripts."""
    import torch

    from img2sgf_tpu_torch.gui.session import DetectSession

    glines, clines = [], []
    gses = DetectSession(cfg, log=glines.append, device=dev)
    g = session_script(gses, rgb, glines)
    t0 = time.perf_counter()
    c = session_script(DetectSession(cfg, log=clines.append, device="cpu"),
                       rgb, clines)
    cpu_s = time.perf_counter() - t0
    for a, b in zip(g, c):
        same_board = (a["board"] is None and b["board"] is None) or (
            a["board"] is not None and b["board"] is not None
            and np.array_equal(a["board"], b["board"]))
        for what, ok in (("log", a["log"] == b["log"]), ("full_board", same_board),
                         ("side_to_move", a["side"] == b["side"]),
                         ("sgf_text", a["sgf"] == b["sgf"])):
            if not ok:
                raise AssertionError(f"session after {a['action']}: {what} "
                                     "differs between CUDA and CPU")
    log("session", "action script " + " -> ".join(
        f"{s['action']} ({'board' if s['ready'] else 'no board'})" for s in g)
        + f": log ({len(glines)} lines), full board, side to move and SGF "
        f"equal to the CPU session's after every action (CPU script {cpu_s:.1f} s)")

    launches, recl = {}, {}
    with counted(launches):
        gses.load_image(rgb)
        gses.process()
    check_batch_launches(launches, "DetectSession.process")
    with counted(recl):
        gses.black_stone_threshold = ALTERED_BLACK_THRESHOLD
        gses.reclassify()
    if any(recl.values()):
        raise AssertionError(f"reclassify launched kernels: {recl}")

    # each script in turn with one detect_board_auto of the diagram, the
    # pipeline call that process() makes
    from img2sgf_tpu_torch import choose_line_threshold
    from img2sgf_tpu_torch.pipeline import detect_board_auto

    thr = choose_line_threshold(*rgb.shape[:2])
    times = {a: [] for a in SESSION_ACTIONS + ("detect_board_auto",)}
    for _ in range(3):
        t0 = time.perf_counter()
        detect_board_auto(rgb, cfg, thr, device=dev)
        torch.cuda.synchronize()
        times["detect_board_auto"].append(time.perf_counter() - t0)
        glines.clear()
        for s in session_script(gses, rgb, glines):
            times[s["action"]].append(s["seconds"])
    action_ms = {a: statistics.median(v) * 1e3 for a, v in times.items()}
    log("session", f"one process(): launches {launches}; reclassify: none; warm "
        "wall per action (median of 3 scripts; detect_board_auto of the "
        "diagram in turn with them): " + ", ".join(
            f"{a} {ms:.2f} ms" for a, ms in action_ms.items()))
    return {f"DetectSession.process {SIZE}": launches}, dict(
        action_ms=action_ms, process_launches=launches)


def phase_loader(batch, tmp):
    """Phase 5c: the batch's 16 diagrams written as JPEG (quality 95) into
    tmp and decoded by decode_batch at 768x768: which decoder ran (the
    native one must build where libjpeg's headers exist), each image close
    to PIL's decode and resize (mean |diff| < 4, the JAX package's bound),
    and the decode time of the 16. Returns (the JPEG paths, numbers)."""
    from PIL import Image

    from img2sgf_tpu_torch.hostio import batch_loader

    paths = []
    for i, (im, _) in enumerate(batch):
        paths.append(os.path.join(tmp, f"b{i:02d}.jpg"))
        Image.fromarray(im).save(paths[-1], quality=95)
    headers = any(os.path.exists(os.path.join(d, "jpeglib.h"))
                  for d in ("/usr/include", "/usr/local/include"))
    native = batch_loader.native_available()
    if headers and not native:
        raise AssertionError("the native loader did not build where libjpeg's "
                             f"headers exist: {batch_loader.build_error}")
    out = batch_loader.decode_batch(paths, SIZE, SIZE)
    diffs = []
    for i, p in enumerate(paths):
        with Image.open(p) as im:
            ref = np.asarray(im.convert("RGB").resize((SIZE, SIZE), Image.BILINEAR))
        diffs.append(float(np.abs(out[i].astype(np.int32) - ref).mean()))
    if max(diffs) >= 4.0:
        raise AssertionError(f"decode_batch differs from PIL: mean |diff| {diffs}")
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        batch_loader.decode_batch(paths, SIZE, SIZE, out=out)
        walls.append(time.perf_counter() - t0)
    decode_ms = statistics.median(walls) * 1e3
    log("loader", f"decode_batch of {len(paths)} JPEGs to {SIZE}x{SIZE}: "
        f"{'native (libjpeg, ' + str(os.cpu_count()) + ' cores)' if native else 'PIL'}"
        f"{'' if native else ' (native loader: ' + str(batch_loader.build_error).splitlines()[-1][:200] + ')'}"
        f"{'' if headers else '; libjpeg headers absent'}; mean |diff| against "
        f"PIL at most {max(diffs):.3f}; {decode_ms:.1f} ms (median of 5)")
    return paths, dict(native=native, decode_ms=decode_ms, images=len(paths),
                       max_mean_abs_diff_vs_pil=max(diffs))


def interleaved_img_s(fns: dict, n_images: int, reps: int = 3):
    """Warm img/s of each fn() (median of reps host walls ending in a
    device sync), the fns run in turns within each rep after one warm-up."""
    import torch

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    walls = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[k].append(time.perf_counter() - t0)
    return {k: dict(img_per_s=n_images / statistics.median(v),
                    wall_ms=statistics.median(v) * 1e3) for k, v in walls.items()}


def phase_sharded(dev, cfg, batch, small, jpegs):
    """Phase 5d: the data-parallel detector and feed on the card.
    make_sharded_detector([cuda:0]) on the 32 512^2 diagrams equals
    detect_board_batch in every field; make_sharded_detector([cuda:0,
    cuda:0], bucketed=True) on the 16 diagrams of the 768 bucket equals
    detect_board_bucket_batch in every field, with K1-K3 called from both
    worker threads; feed_and_detect over the 16 JPEGs on [cuda:0] gives
    rows equal to detect_board_auto of each decoded image. Each run
    counted; then warm img/s of each next to its one-device batch."""
    import torch

    from img2sgf_tpu_torch import choose_line_threshold
    from img2sgf_tpu_torch.hostio.batch_loader import decode_batch
    from img2sgf_tpu_torch.parallel import (
        aggregate_metrics, feed_and_detect, make_sharded_detector)
    from img2sgf_tpu_torch.pipeline import (
        detect_board_auto, detect_board_batch, detect_board_bucket_batch)

    paths = {}
    sbatch, sths = small
    one = make_sharded_detector([dev], cfg)
    launches = {}
    with counted(launches):
        res = one(sbatch, sths)
    check_batch_launches(launches, "sharded [cuda:0]")
    compare_results(res, detect_board_batch(sbatch, cfg, sths, device=dev),
                    "make_sharded_detector([cuda:0]) vs detect_board_batch")
    paths[f"make_sharded_detector [cuda:0] B={len(sths)} {SMALL}"] = launches
    agg = {k: int(v) for k, v in aggregate_metrics(res).items()}
    log("sharded", f"make_sharded_detector([cuda:0]) on {len(sths)} x {SMALL}^2: "
        f"equal to detect_board_batch in every field; launches {launches}; {agg}")

    imgs = [im for im, _ in batch]
    canvases, hs, ws, ths = bucket(imgs)
    two = make_sharded_detector([dev, dev], cfg, bucketed=True)
    launches = {}
    with counted(launches), recording() as calls:
        res = two(canvases, ths, hs, ws)
    threads = calls["threads"]
    if launches["K1"] != 4 or launches["K3"] not in (2, 3, 4) \
            or launches["K2"] != 2 * launches["K3"]:
        raise AssertionError(f"two shards' launches {launches}, expected K1 4, "
                             "K2 4 and K3 2 (plus 2 and 1 a shard with a rerun)")
    if any(len(t) != 2 for t in threads.values()):
        raise AssertionError("K1-K3 not called from both worker threads: "
                             f"{ {k: len(t) for k, t in threads.items()} }")
    compare_results(res, detect_board_bucket_batch(canvases, cfg, ths, hs, ws,
                                                   device=dev),
                    "make_sharded_detector([cuda:0, cuda:0]) vs bucket batch")
    paths[f"make_sharded_detector [cuda:0, cuda:0] bucketed B={len(imgs)} "
          f"{canvases.shape[1]}"] = launches
    log("sharded", f"make_sharded_detector([cuda:0, cuda:0], bucketed) on "
        f"{len(imgs)} images of the {canvases.shape[1]} bucket: equal to "
        f"detect_board_bucket_batch in every field; launches {launches}, "
        "K1-K3 each called from both worker threads (two streams; K1's "
        "cooperative launches take turns)")

    feed = make_sharded_detector([dev], cfg)
    launches = {}
    with counted(launches):
        res = feed_and_detect([dev], feed, jpegs, SIZE, SIZE)
    check_batch_launches(launches, "feed_and_detect")
    decoded = decode_batch(jpegs, SIZE, SIZE)
    thr = choose_line_threshold(SIZE, SIZE)
    for i, im in enumerate(decoded):
        single = detect_board_auto(im, cfg, thr, device=dev)
        for f in dataclasses.fields(single):
            if not torch.equal(getattr(res, f.name)[i], getattr(single, f.name)):
                raise AssertionError(f"feed_and_detect row {i} differs from "
                                     f"detect_board_auto in {f.name}")
    paths[f"feed_and_detect [cuda:0] {len(jpegs)} {SIZE}"] = launches
    log("sharded", f"feed_and_detect([cuda:0]) over {len(jpegs)} JPEGs at "
        f"{SIZE}x{SIZE}: each row equal to detect_board_auto of its decoded "
        f"image; launches {launches}; "
        f"{int(res.board_ready.sum())} boards ready")

    thrs = [thr] * len(jpegs)
    tput = {}
    for name, t in {
        **interleaved_img_s({
            f"detect_board_batch_{SMALL}_B{len(sths)}":
                lambda: detect_board_batch(sbatch, cfg, sths, device=dev),
            f"sharded_cuda0_{SMALL}_B{len(sths)}": lambda: one(sbatch, sths)},
            len(sths)),
        **interleaved_img_s({
            f"detect_board_bucket_batch_{canvases.shape[1]}_B{len(imgs)}":
                lambda: detect_board_bucket_batch(canvases, cfg, ths, hs, ws,
                                                  device=dev),
            f"sharded_cuda0_cuda0_bucketed_{canvases.shape[1]}_B{len(imgs)}":
                lambda: two(canvases, ths, hs, ws)}, len(imgs)),
        **interleaved_img_s({
            f"decode_and_detect_board_batch_{SIZE}_B{len(jpegs)}":
                lambda: detect_board_batch(decode_batch(jpegs, SIZE, SIZE), cfg,
                                           thrs, device=dev),
            f"feed_and_detect_cuda0_{SIZE}_B{len(jpegs)}":
                lambda: feed_and_detect([dev], feed, jpegs, SIZE, SIZE)},
            len(jpegs)),
    }.items():
        tput[name] = t
        log("sharded", f"{name}: {t['img_per_s']:.2f} img/s warm (wall "
            f"{t['wall_ms']:.1f} ms, median of 3, in turns with its pair)")
    return paths, tput


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    if not (HERE / "img2sgf_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: img2sgf_tpu_torch/csrc not found beside this "
              "script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))

    from img2sgf_tpu_torch import DetectionConfig, _build

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    t0 = time.perf_counter()
    _build.load()
    log("device", f"{smi}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"kernels built in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds or 0:.1f} s)")

    cfg = DetectionConfig()
    rgb, stones = render_diagram()
    batch = batch_images()
    kernels = phase_kernels(dev, rgb, cfg, batch)
    phase_tables(dev)
    launches, _wall, _stages = phase_main_path(dev, rgb, stones, cfg)
    rerun_ms = phase_overflow(dev, cfg)
    paths, tput, small = phase_batch(dev, cfg, batch)
    session_paths, session = phase_session(dev, rgb, cfg)
    with tempfile.TemporaryDirectory() as tmp:
        jpegs, loader = phase_loader(batch, tmp)
        sharded_paths, sharded_tput = phase_sharded(dev, cfg, batch, small, jpegs)
    paths.update(session_paths)
    paths.update(sharded_paths)
    tput.update(sharded_tput)
    phase_profile(kernels)  # late: the profiler's hooks could slow the wall
    tput[f"bucket_batch_{SIZE}_B{len(batch)}"].update(phase_busy(dev, cfg, batch))
    # K1's profile once more, after the busy profile's ~17,600 events, for
    # the record of whether a long profile makes the next one drop events
    # (logged, not asserted: phase 7 holds K1 to one launch and one read)
    n, n_mine, n_d2h, _, _ = profile_call(kernels["K1"]["call"],
                                          KERNEL_NAMES["K1"], 5)
    log("profile", f"K1 main path after the busy profile: per call {n:g} "
        f"kernel launches ({n_mine:g} of {KERNEL_NAMES['K1']}), {n_d2h:g} "
        "device-to-host copies")

    names = COUNTERS
    paths = {f"detect_board {SIZE}": {k: launches[m] for k, m in names.items()},
             **paths}
    for path, counts in paths.items():
        zero = [k for k in names if counts[k] <= 0]
        if zero:
            raise AssertionError(f"kernels not launched by {path}: {zero}")
        log("launches", f"{path}: " + ", ".join(f"{k} {counts[k]}" for k in names))

    meta = {
        "K1": ("hysteresis", "img2sgf_tpu_torch/csrc/hysteresis.cu",
               "img2sgf_tpu/ops/hysteresis_pallas.py:99"),
        "K2": ("exact_rescore", "img2sgf_tpu_torch/csrc/rescore.cu",
               "img2sgf_tpu/hough/rescore_pallas.py:253"),
        "K3": ("radius_support", "img2sgf_tpu_torch/csrc/radius.cu",
               "img2sgf_tpu/hough/radius_pallas.py:119"),
    }
    rows = []
    for k, (name, src, rep) in meta.items():
        r = kernels[k]
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": rep, "launches": launches[names[k]],
               "max_abs_err": r["err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": None,
               "kernel_ms": r["kernel_ms"],
               "launches_by_path": {p: c[k] for p, c in paths.items()}}
        fields = ("label", "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by")
        if k == "K1":
            row["sweeps"] = r["sweeps"]
            row["cases"] = [{f: c[f] for f in fields + ("sweeps",)}
                            for c in r["cases"][1:]]
        if k == "K2":
            row["cases"] = [{f: c[f] for f in fields + ("valid",)}
                            for c in r["cases"][1:]]
        if k == "K3":
            row["label"], row["wanted"] = r["label"], r["wanted"]
            row["cases"] = [{f: c[f] for f in fields + ("max_r", "wanted")}
                            for c in r["cases"]]
            row["overflow_rerun_wall_ms"] = rerun_ms
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"throughput": tput}))
    print(json.dumps({"session": session, "loader": loader}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
