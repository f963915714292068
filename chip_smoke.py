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
     the greedy minimum-distance kernel at the recorded inputs of the 768^2
     detect_board, the 16-image bucket batch, the 32-image 512^2 batch and
     the noisy diagram's overflow rerun, and at seeded edge cases (ties at
     min_dist, more acceptances than max_out, empty planes, K = 8192), with
     its bound and its latency floor (dependent steps); the accumulator
     kernel (A) at the recorded labels of the 768^2 detect_board, the
     16-image bucket batch and the 32-image 512^2 batch, and at the 768^2
     labels with the per-offset table (span 31) and at r = 0 (0-29), with
     its bound, and its yardstick: one conv2d of the one-hot labels with
     the offset table as its weight (library_ms, 768^2 only); the plane
     state's kernels S1 (Sobel, NMS and thresholds, packed for K1) and S2
     (edge mask, walk steps and labels from K1's words) at the recorded
     inputs of the 768^2 detect_board, the 16-image bucket batch, the
     32-image 512^2 batch and the noisy diagram, each with its bound;
  3. direction_bins and pixel_steps over all 2041^2 Sobel gradient pairs,
     CUDA against CPU, exactly equal; direction_bins also at 48, 63, 66,
     127 and 254 bins, and S2's label table on the card at each count
     equal to the CPU's bins;
  4. the main path on a seeded synthetic 19x19 diagram at 768x768: the CLI
     in a subprocess and detect_board in process, every planted stone found
     with its colour, the SGF equal to to_sgf of the in-process result, the
     whole BoardResult bit-equal to the port's CPU run, the warm wall time
     and the per-stage times; then a noisy diagram that takes the overflow
     rerun, CUDA against CPU, and the rerun's own wall time;
  4c. detect_board under each config value off the default path that the
     JAX package runs (circle_max_radius 31, the per-offset accumulator;
     circle_min_radius 0 with max 29, K2 and K3 at r = 0; propose_block 2;
     num_angle_bins 48 and 63) on the 768^2 diagram: every planted stone
     found, each kernel launched and no plain version on the card, the warm
     wall beside the default config's, and CUDA equal to CPU on a 320^2
     diagram; K2 (cells 5 and 3) and K3 at the r = 0 run's own inputs
     against their plain versions, with their bounds (JSON rows of their
     own);
  4d. hough_circles_gradient (the diagnostic tools' single-plane path) on
     the 768^2 grey plane, counted, CUDA against CPU;
  5. the batch path: detect_board_bucket_batch on 16 seeded diagrams of
     mixed sizes (648-768 px, an exact fit and margins of 1 and 2 px) in
     the 768 canvas bucket, every planted stone found; each row equal to
     detect_board_auto of its image in every field, detect_board_auto equal
     to native detect_board at margins 0 and >= 3; a sub-batch of 3 equal
     to its CPU run; launch counts that do not grow with B (2 K1, 2 K2,
     1 K3, 1 greedy, 1 A, 1 S1 and 1 S2, plus 2 K2, 1 K3 and 1 greedy with
     the overflow rerun); the CLI's --batch;
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
  5e. (run right after phase 5) the post stage, one pass over a batch, at
     the recorded inputs of the 768^2 detect_board, the 16-image bucket
     batch and the 32-image 512^2 batch: a warm pass, a warm greedy_min_dist
     call and a warm kernel A call make no host synchronisation
     (torch.cuda.set_sync_debug_mode
     "error"), the pass's warm wall and CUDA-event time beside the post
     stage's time from timings=, and the host synchronisations of one warm
     detect_board and one warm 16-image batch counted by their sites
     ("warn");
  6. every kernel (the greedy one, A, S1 and S2 too) launched by each
     path's counted run
     (detect_board and
     its config variants, hough_circles_gradient,
     detect_board_bucket_batch, detect_board_batch, DetectSession.process,
     the sharded detectors, feed_and_detect; counts set to 0 just before
     each and read just after), and no plain version called on the card;
  7. torch.profiler over each kernel's main-path call, the single image's
     other cases (K1's outer Canny, K2's 3x3 case and both K2 cases at
     max_r 60), its batch cases and the r = 0 cases of K2 and K3 (K3: each
     of its cases; the greedy kernel, A, S1 and S2: each of their cases):
     its launches and device reads per call (every kernel but K2 must be
     one kernel launch and no device read) and its device time;
  8. the device busy time of one warm 16-image batch (profiler: the union
     of the device intervals, so overlapping events count once) beside
     the median unprofiled graphed wall of phase 5, then K1's main-path
     profile once more (logged only);
  9. the plain per-offset accumulator (radius span 31) and the plain
     cascade (30) on the 768^2 diagram's 8 planes under torch.profiler,
     beside kernel A with each table: wall and device busy time (profiles
     of thousands of launches before phase 7 made its first profile record
     no device event);
  10. (run after phase 5d) the captured CUDA graphs of the jitted entry
     points: detect_board_auto and detect_board_jit of the 768^2 diagram
     (and auto with the overflow rerun off: one graph, no flag read),
     detect_board_jit of the noisy 256^2 diagram (its chunk graphs replay),
     the 16-image bucket batch and the 32-image 512^2 batch, each graphed
     equal to its eager segments in every field on the first call and on a
     warm replay; the host synchronisations of a warm graphed call by site
     (at most the one saturation-flag read); first-call and warm walls
     (graphed and eager in turns, medians of 5), peak memory and graph
     pool size; the session's action script graphed equal to eager;
  10b. the host side of a graphed call: back-to-back graphed calls that
     alternate two inputs of one key with no sync between them
     (detect_board_auto at 768^2 and 767 x 700 in one bucket,
     detect_board_bucket_batch of the 16 diagrams in two orders), each
     equal to the eager run of its own input in every field, with no new
     capture; the staging's (_to_device) host ms and upload device ms at
     768^2 and at B = 16, and the host wall of the 16 to_sgf of the B = 16
     result;
  11. (last) each phase-10 path's warm graphed call under torch.profiler:
     the kernels a replay runs, counted by name (the 768^2 call must run
     K1 twice and K2, K3, G, A, S1 and S2), its device busy time (the union of
     the device intervals) beside phase 10's median unprofiled graphed
     wall, and the profiled wall.

The counted runs of phase 6 drop the graph caches first: a graphed path's
counted call is its first, whose warm-up runs the segments eagerly (one
overflow chunk included) before the capture, which launches nothing.

Then one JSON line with each kernel's launches (by path), error, times and
bound (K2 and K3 at r = 0 in rows of their own; the greedy kernel's rows
also give its kernel time a dependent step, us_per_step), one with the batch
throughputs (the sharded ones included), the config variants' walls and the
accumulators' device times, one with the post stage's times and the host
synchronisations (phase 5e), one with
the session's and the loader's numbers, one with phase 10-11's graph
records (its kernel counts also in each kernel's "replay_launches"), one
with phase 10b's staging records, the card's name and power limit,
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
# direction-bin counts checked on all Sobel pairs besides the default 64
BIN_COUNTS = (48, 63, 66, 127, 254)
# the fields tests/test_bucketed.py holds bucketed against native detection
BUCKET_FIELDS = ("full_board", "detected_board", "hsize", "vsize",
                 "board_ready", "valid_grid", "num_black", "num_white",
                 "side_to_move", "hspace", "vspace", "intensities",
                 "stone_mask", "edges", "grey", "circles_removed")


# each kernel's launch counter: (module of img2sgf_tpu_torch, attribute);
# each module also counts the calls of its plain versions (plain_calls)
COUNTERS = {"K1": ("ops.hysteresis_cuda", "launches"),
            "K2": ("hough.rescore_cuda", "launches"),
            "K3": ("hough.radius_cuda", "launches"),
            "G": ("hough.greedy_cuda", "launches"),
            "A": ("hough.accumulator_cuda", "launches"),
            "S1": ("hough.state_cuda", "s1_launches"),
            "S2": ("hough.state_cuda", "s2_launches")}


def reset_counts():
    """Set every kernel's launch count and every plain-call count to 0;
    returns {kernel: (module, attribute)} for read_counts."""
    import importlib

    counters = {k: (importlib.import_module(f"img2sgf_tpu_torch.{m}"), a)
                for k, (m, a) in COUNTERS.items()}
    for m, a in counters.values():
        setattr(m, a, 0)
        m.plain_calls = 0
    return counters


def read_counts(counters) -> dict:
    """The launches by kernel since reset_counts, after the device's work;
    raises if a plain version was called."""
    import torch

    torch.cuda.synchronize()
    plain = {m.__name__.rsplit(".", 1)[1]: m.plain_calls
             for m, _ in counters.values() if m.plain_calls}
    if plain:
        raise AssertionError(f"plain versions called on the card: {plain}")
    return {k: getattr(m, a) for k, (m, a) in counters.items()}


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


def greedy_cases(seed=SEED + 40):
    """Seeded greedy_min_dist inputs that reach its edge cases, as numpy
    [(label, ys, xs, live, min_dist, max_out)] with ys, xs int64 [P, K]:
    ties at exactly min_dist (lattice neighbours, and (6, 8) offsets at
    min_dist 10) beside duplicates at distance 0; more acceptances than
    max_out, with later duplicates of the unstored ones; a plane with no
    live candidate, live candidates after dead ones and only the last slot
    live; the overflow rerun's K = 8192 with long live prefixes; random
    lists at the base pass's [8, 1024]."""
    rng = np.random.default_rng(seed)
    cases = []
    # ties: a 10-px lattice, each point also at (+6, +8), some repeated
    P, K = 3, 96
    g = np.arange(6) * 10 + 40
    pts = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    ys = np.empty((P, K), np.int64)
    xs = np.empty((P, K), np.int64)
    for p in range(P):
        cand = np.concatenate([pts, pts[:24] + [6, 8], pts[rng.integers(0, 36, 36)]])
        cand = cand[rng.permutation(len(cand))][:K]
        ys[p], xs[p] = cand[:, 0], cand[:, 1]
    cases.append(("ties at min_dist, duplicates", ys, xs,
                  np.ones((P, K), bool), 10.0, 384))
    # a 12-px lattice of 400 points, max_out 64: acceptances 64+ are
    # reported but block nothing, so their later duplicates are taken too
    g = np.arange(20) * 12 + 5
    pts = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    dup = pts[rng.integers(64, 400, 112)]
    cand = np.concatenate([pts, dup])
    ys = np.stack([cand[:, 0], cand[::-1, 0]])
    xs = np.stack([cand[:, 1], cand[::-1, 1]])
    cases.append(("more than max_out", ys, xs, np.ones(ys.shape, bool),
                  10.0, 64))
    # no live candidate; live after dead; only the last slot live
    P, K = 4, 128
    ys = rng.integers(0, 120, (P, K))
    xs = rng.integers(0, 120, (P, K))
    live = np.zeros((P, K), bool)
    live[1] = rng.random(K) < 0.5
    live[2, -1] = True
    live[3, 40:] = True
    cases.append(("empty plane, gaps, last slot", ys, xs, live, 10.0, 384))
    # the overflow rerun's budget: dense candidates, long live prefixes
    P, K = 3, 8192
    ys = rng.integers(0, 256, (P, K))
    xs = rng.integers(0, 256, (P, K))
    live = np.arange(K)[None, :] < np.array([[K], [5000], [0]])
    cases.append(("K = 8192", ys, xs, live, 10.0, 384))
    # the base pass's shape at a 768^2 plane
    P, K = 8, 1024
    ys = rng.integers(0, 768, (P, K))
    xs = rng.integers(0, 768, (P, K))
    live = np.arange(K)[None, :] < rng.integers(0, K + 1, (P, 1))
    cases.append(("random [8, 1024]", ys, xs, live, 10.0, 384))
    return cases


def small_images():
    """detect_board_batch's 32 512^2 diagrams: ((images [B, H, W, 3], line
    thresholds), [planted stones])."""
    from img2sgf_tpu_torch import choose_line_threshold

    small = [render_diagram(size=SMALL, n=SMALL_LINES, n_stones=SMALL_STONES,
                            seed=SMALL_SEED + i) for i in range(SMALL_B)]
    return ((np.stack([im for im, _ in small]),
             [choose_line_threshold(SMALL, SMALL)] * SMALL_B),
            [stones for _, stones in small])


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
    """Record the arguments of every K1, K2, K3, greedy-kernel (G),
    accumulator (A), S1 and S2 wrapper call, and of every post-stage pass,
    made through the pipeline's own references to them (K1: the outer
    Canny's, then the plane state's): yields {"K1": [(args, kwargs)], "K2":
    [...], "K3": [...], "G": [...], "A": [...], "S1": [...], "S2": [...],
    "post": [...], "threads": {"K1": {idents}, ...}}, "threads" holding
    the idents of the threads that made each call."""
    import importlib
    import threading

    # the packages re-export functions under some module names (ops.canny)
    mod = importlib.import_module
    targets = [(mod("img2sgf_tpu_torch.ops.canny"), "hysteresis_packed", "K1"),
               (mod("img2sgf_tpu_torch.hough.circles"), "hysteresis_packed",
                "K1"),
               (mod("img2sgf_tpu_torch.hough.circles"), "state_canny", "S1"),
               (mod("img2sgf_tpu_torch.hough.circles"), "state_steps", "S2"),
               (mod("img2sgf_tpu_torch.hough.circles"), "exact_rescore", "K2"),
               (mod("img2sgf_tpu_torch.pipeline.detect"), "radius_support_pool",
                "K3"),
               (mod("img2sgf_tpu_torch.hough.circles"), "greedy_min_dist", "G"),
               (mod("img2sgf_tpu_torch.hough.circles"),
                "vote_accumulator_pool_labels", "A"),
               (mod("img2sgf_tpu_torch.pipeline.detect"), "_post_circles",
                "post")]
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


def roofline(nbytes, ops, rate, flops=0):
    """(bound ms, "bytes" or "operations"): the larger of the two times, the
    operations' time being ops at `rate` and flops float32 operations at
    F32_FLOPS_PER_S."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (ops / rate + flops / F32_FLOPS_PER_S) * 1e3
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


# the wrappers and the stage that recording() records
CALLS = ("K1", "K2", "K3", "G", "A", "S1", "S2", "post")


def main_path_calls(dev, rgb, cfg):
    """The kernel wrappers' arguments of one detect_board run on the 768^2
    diagram (recording)."""
    from img2sgf_tpu_torch import choose_line_threshold
    from img2sgf_tpu_torch.pipeline import detect_board

    with recording() as calls:
        detect_board(rgb, cfg, choose_line_threshold(*rgb.shape[:2]), device=dev)
    if [len(calls[k]) for k in CALLS] != [2, 2, 1, 1, 1, 1, 1, 1]:
        raise AssertionError("the 768^2 main path's kernel calls: "
                             f"{ {k: len(calls[k]) for k in CALLS} }")
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
    from img2sgf_tpu_torch.ops import hysteresis_cuda as hyst
    from img2sgf_tpu_torch.pipeline import detect_board_bucket_batch

    canvases, hs, ws, ths = bucket([im for im, _ in batch])
    with recording() as calls:  # eager (timings=): each call's own inputs
        detect_board_bucket_batch(canvases, cfg, ths, hs, ws, device=dev,
                                  timings={})
    if [len(calls[k]) for k in CALLS] not in ([2, 2, 1, 1, 1, 1, 1, 1],
                                              [2, 4, 2, 2, 1, 1, 1, 1]):
        raise AssertionError("the batch's kernel calls: "
                             f"{ {k: len(calls[k]) for k in CALLS} }")
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
    out.update(recorded_k2_k3_cases(calls, "batch", rate))
    return out, calls


def recorded_k2_k3_cases(calls, prefix, rate):
    """K2 and K3 at a recorded run's own inputs (recording()), each equal to
    its plain version, with the call's time, the plain version's and the
    bound. Returns {"K2": [case], "K3": [case]}, labels starting with
    `prefix`."""
    from img2sgf_tpu_torch.hough import radius_cuda, rescore_cuda

    out = {"K2": [], "K3": []}
    for args, kw in calls["K2"]:
        emask, ys, xs, valid = args[0], args[3], args[4], args[5]
        max_r, cells = args[7], kw["cells"]
        label = f"{prefix} cells={cells} [{ys.shape[0]},{ys.shape[1]}]"
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
        label = f"{prefix} [{ys.shape[0]},{ys.shape[1]}]"
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


def phase_kernels(dev, rgb, cfg, batch, small):
    """Phase 2: each kernel against its plain version on the card, with the
    call's time, the plain version's, and the roofline bound; at the
    single-image path's shapes and at the batch path's
    (batch_kernel_cases); the greedy kernel also at the 512^2 batch's
    inputs (small: its images and thresholds) and the overflow rerun's.
    Returns (results by kernel, the recorded calls of the 768^2 main path,
    the bucket batch and the 512^2 batch)."""
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
    batched, bcalls = batch_kernel_cases(dev, cfg, batch, rate)
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

    # --- the greedy kernel at the recorded inputs of the 768^2 main path,
    # the 16-image bucket batch, the 32-image 512^2 batch and the noisy
    # diagram's overflow rerun, then at the seeded edge cases
    from img2sgf_tpu_torch.pipeline import detect_board, detect_board_batch

    sbatch, sths = small
    with recording() as scalls:
        detect_board_batch(sbatch, cfg, sths, device=dev, timings={})
    with recording() as ocalls:
        detect_board(noisy_diagram(), cfg, 30, device=dev)
    if len(scalls["G"]) != 1 or len(ocalls["G"]) != 2:
        raise AssertionError("greedy calls of the 512^2 batch and the noisy "
                             f"diagram: {len(scalls['G'])}, {len(ocalls['G'])}")
    recorded = [(f"{SIZE}^2 main path", calls["G"][0][0])] + [
        (f"bucket batch B={len(batch)}" + (" overflow rerun" if j else ""), a)
        for j, (a, _) in enumerate(bcalls["G"])] + [
        (f"{SMALL}^2 batch B={SMALL_B}", scalls["G"][0][0]),
        ("noisy 256^2 overflow rerun", ocalls["G"][1][0])]
    seeded = [(f"seeded: {label}",
               (*(torch.from_numpy(a).to(dev) for a in (ys_, xs_, live_)),
                md, mo))
              for label, ys_, xs_, live_, md, mo in greedy_cases()]
    g = [greedy_case(label, args) for label, args in recorded + seeded]
    results["G"] = dict(g[0], err=max(c["err"] for c in g), cases=g)

    # --- kernel A at the recorded labels of the 768^2 main path, the
    # 16-image bucket batch and the 32-image 512^2 batch, then at the main
    # path's labels with the per-offset table (span 31) and at r = 0
    main_a = calls["A"][0][0]
    lbl, nb = main_a[0], main_a[1]
    a = [accumulator_case(label, *args, rate) for label, args in (
        (f"{SIZE}^2 main path", main_a),
        (f"bucket batch B={len(batch)}", bcalls["A"][0][0]),
        (f"{SMALL}^2 batch B={SMALL_B}", scalls["A"][0][0]),
        (f"{SIZE}^2 per-offset", (lbl, nb, 1, 31)),
        (f"{SIZE}^2 r = 0", (lbl, nb, 0, 29)))]
    lib_ms, lib_err = accumulator_library(*main_a)
    results["A"] = dict(a[0], err=max(c["err"] for c in a), cases=a,
                        library_ms=lib_ms, library_err=lib_err)

    # --- S1 and S2 at the recorded inputs of the 768^2 main path, the
    # 16-image bucket batch, the 32-image 512^2 batch and the noisy diagram
    for k in ("S1", "S2"):
        cs = [state_case(label, k, rec[k][0][0], rate) for label, rec in (
            (f"{SIZE}^2 main path", calls),
            (f"bucket batch B={len(batch)}", bcalls),
            (f"{SMALL}^2 batch B={SMALL_B}", scalls),
            ("noisy 256^2", ocalls))]
        results[k] = dict(cs[0], err=max(c["err"] for c in cs), cases=cs)
    return results, dict(single=calls, bucket=bcalls, small=scalls)


# Roofline of the greedy kernel: the published H100 SXM float32 rate outside
# the tensor cores (NVIDIA data sheet), and its float32 operations per
# distance test: two differences, two squares, their sum and the compare.
F32_FLOPS_PER_S = 67e12
GREEDY_OPS_PER_TEST = 6


def greedy_work(ys, xs, live, accepted, max_out):
    """(bytes, operations, dependent steps) of the greedy selection on these
    inputs and its result `accepted`. Bytes: live read and accepted written
    at every slot, ys and xs read at the live candidates alone. Operations:
    a distance test of each live candidate against each position stored
    before it (the acceptances before it, at most max_out). Steps: the
    largest live length (last live index + 1) of a plane, the chain of
    dependent steps that bounds its latency from below."""
    import torch

    P, K = live.shape
    n_live = int(live.sum())
    nbytes = 2 * P * K + (ys.element_size() + xs.element_size()) * n_live
    acc = accepted.to(torch.int64)
    stored = (acc.cumsum(-1) - acc).clamp(max=max_out)
    ops = GREEDY_OPS_PER_TEST * int(torch.where(live, stored, 0).sum())
    idx = torch.arange(1, K + 1, device=live.device)
    steps = int(torch.where(live, idx, 0).amax()) if live.numel() else 0
    return nbytes, ops, steps


def greedy_case(label, args):
    """The greedy kernel against its plain version at args (ys, xs, live,
    min_dist, max_out): exactly equal, with the call's time, the plain
    version's and the bound."""
    from img2sgf_tpu_torch.hough import greedy_cuda

    ys, xs, live, _, max_out = args
    label = f"{label} [{live.shape[0]},{live.shape[1]}]"
    out_k = greedy_cuda.greedy_min_dist(*args)
    out_p = greedy_cuda.greedy_min_dist_plain(*args)
    err = check_equal(f"greedy {label}", out_k, out_p)
    ms = cuda_ms(lambda: greedy_cuda.greedy_min_dist(*args), 10)
    pms = cuda_ms(lambda: greedy_cuda.greedy_min_dist_plain(*args), 1)
    nbytes, ops, steps = greedy_work(ys, xs, live, out_k, max_out)
    b_ms, b_by = roofline(nbytes, ops, F32_FLOPS_PER_S)
    log("kernels", f"greedy {label} live={int(live.sum())} "
        f"accepted={int(out_k.sum())} ys {str(ys.dtype)[6:]}: equal, call "
        f"{ms:.3f} ms, plain {pms:.3f} ms, bound {b_ms * 1e3:.4f} us ({b_by}:"
        f" {nbytes / 1e3:.1f} kB, {ops} operations); latency floor {steps} "
        "dependent steps")
    return dict(label=label, ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                err=err, steps=steps, live=int(live.sum()), bytes=nbytes,
                operations=ops, call=lambda a=args: greedy_cuda.greedy_min_dist(*a))


def us_per_step(case):
    """The greedy kernel's device time a dependent step (the measure its
    design moves), in microseconds: None for a case with no live
    candidate."""
    return case["kernel_ms"] * 1e3 / case["steps"] if case["steps"] else None


def accumulator_work(labels, num_bins, min_r, max_r):
    """(bytes, votes) of kernel A on these labels. Bytes, each read or
    written once: the uint8 labels, the float32 accumulator and the offset
    table (start and entries, int32). Votes: over the edge pixels, the sum
    of their bin's table weights (2 * n_r each), one int32 add a vote."""
    import torch

    from img2sgf_tpu_torch.hough import accumulator_cuda

    start, entries, _ = accumulator_cuda.vote_table(num_bins, min_r, max_r)
    wsum = np.bincount(np.repeat(np.arange(num_bins), np.diff(start)),
                       weights=entries[2], minlength=num_bins).astype(np.int64)
    counts = torch.bincount(labels.reshape(-1).long(),
                            minlength=num_bins + 1)[:num_bins].cpu().numpy()
    nbytes = 5 * labels.numel() + start.nbytes + entries.nbytes
    return nbytes, int((counts.astype(np.int64) * wsum).sum())


def accumulator_case(label, labels, num_bins, min_r, max_r, rate):
    """Kernel A against its plain version (the cascade, or the per-offset
    sums for a span not divisible by 5) at these labels: exactly equal,
    with the call's time, the plain version's and the bound."""
    from img2sgf_tpu_torch.hough import accumulator_cuda as acc

    plain = (acc.vote_accumulator_offsets if (max_r - min_r + 1) % 5
             else acc.vote_accumulator_cascade_labels)
    args = (labels, num_bins, min_r, max_r)
    label = (f"{label} [" + ",".join(map(str, labels.shape))
             + f"] r {min_r}-{max_r}")
    err = check_equal(f"A {label}", acc.vote_accumulator_cuda(*args),
                      plain(*args))
    ms = cuda_ms(lambda: acc.vote_accumulator_cuda(*args), 10)
    pms = cuda_ms(lambda: plain(*args), 1)
    nbytes, votes = accumulator_work(*args)
    b_ms, b_by = roofline(nbytes, votes, rate)
    edges = int((labels < num_bins).sum())
    log("kernels", f"A accumulator {label} {edges} edge pixels: equal, call "
        f"{ms:.3f} ms, plain {pms:.3f} ms, bound {b_ms * 1e3:.2f} us ({b_by}: "
        f"{nbytes / 1e6:.2f} MB, {votes} votes)")
    return dict(label=label, ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                err=err, edges=edges, votes=votes, bytes=nbytes,
                call=lambda: acc.vote_accumulator_cuda(*args))


def accumulator_library(labels, num_bins, min_r, max_r):
    """The yardstick of kernel A (on no path of the port): one
    torch.nn.functional.conv2d over the one-hot labels [P, nb, H+2R, W+2R]
    with the offset table as a [1, nb, 2R+1, 2R+1] weight, which computes
    the same accumulator. cuDNN's TF32 is on (PyTorch's default, set here):
    0/1 inputs and integer weights are exact in TF32. Returns (ms, max
    |conv - kernel|)."""
    import torch
    import torch.nn.functional as F

    from img2sgf_tpu_torch.hough import accumulator_cuda as acc

    start, entries, R = acc.vote_table(num_bins, min_r, max_r)
    w = np.zeros((1, num_bins, 2 * R + 1, 2 * R + 1), np.float32)
    for d in range(num_bins):
        dy, dx, wt = entries[:, start[d]:start[d + 1]]
        w[0, d, R - dy, R - dx] = wt  # out[y, x] reads in[y - dy, x - dx]
    weight = torch.from_numpy(w).to(labels.device)
    P, H, W = labels.shape
    pad = F.pad(labels, (R, R, R, R), value=num_bins).long()
    onehot = torch.zeros((P, num_bins + 1, H + 2 * R, W + 2 * R),
                         dtype=torch.float32, device=labels.device)
    onehot = onehot.scatter_(1, pad[:, None], 1.0)[:, :num_bins].contiguous()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        conv = F.conv2d(onehot, weight)[:, 0]
        ms = cuda_ms(lambda: F.conv2d(onehot, weight), 3)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    err = float((conv - acc.vote_accumulator_cuda(
        labels, num_bins, min_r, max_r)).abs().max())
    log("kernels", f"A yardstick: conv2d of the one-hot labels "
        f"[{P},{num_bins},{H + 2 * R},{W + 2 * R}] with the table as a "
        f"[1,{num_bins},{2 * R + 1},{2 * R + 1}] weight (TF32): {ms:.3f} ms, "
        f"max |conv - kernel| {err}")
    return ms, err


KERNEL_NAMES = {"K1": "hysteresis_kernel", "K2": "rescore_kernel",
                "K3": "radius_kernel", "G": "greedy_kernel",
                "A": "accumulator_kernel", "S1": "state_canny_kernel",
                "S2": "state_steps_kernel"}


# Least work of S1 and S2: int32 instructions a pixel of a plane, and
# float32 operations an edge pixel
S1_OPS_PER_PIXEL = 20   # separable Sobel 6, |dx| + |dy| 3, the sector tests
#                         and two neighbour compares 7, the two thresholds
#                         2, the two bits 2
S2_OPS_PER_PIXEL = 9    # separable Sobel 6, the word's bit and the
#                         nonzero-gradient test 3
S2_FLOPS_PER_EDGE = 10  # two squares and their sum, the root, two products
#                         by 1024, two divisions, two roundings


def edge_pairs(planes, hw_planes, emask) -> int:
    """The distinct (dx, dy) Sobel pairs of the edge pixels: the entries
    of the label table that S2 reads."""
    import torch

    from img2sgf_tpu_torch.ops.common import border_remap
    from img2sgf_tpu_torch.ops.sobel import sobel3

    if hw_planes is not None:
        planes = border_remap(planes, hw_planes[0], hw_planes[1], "replicate")
    dx, dy = sobel3(planes)
    return int(torch.unique((dx[emask] + 1020) * 2041 + dy[emask]).numel())


def state_work(kernel, planes, hw_planes=None, emask=None, pairs=0):
    """(bytes, int32 operations, float32 operations) of S1 or S2 on these
    inputs, each input read once and each output written once. S1 reads
    the uint8 planes (and the [P] int64 content dims) and writes two int32
    words a pixel of each group of 32 planes; S2 reads the planes, the dims
    and one word, writes the bool mask, two int32 steps and the uint8 label
    of every pixel, and reads the label table's entries of the `pairs`
    distinct gradients of its edge pixels (emask), where it also computes
    the steps."""
    P, H, W = planes.shape
    words = 4 * -(-P // 32) * H * W
    dims = 0 if hw_planes is None else 16 * P
    if kernel == "S1":
        return (planes.numel() + dims + 2 * words,
                S1_OPS_PER_PIXEL * planes.numel(), 0)
    return (11 * planes.numel() + dims + words + pairs,
            S2_OPS_PER_PIXEL * planes.numel(),
            S2_FLOPS_PER_EDGE * int(emask.sum()))


def state_case(label, kernel, args, rate):
    """S1 or S2 against its plain version at recorded args (S1: planes,
    canny_high, hw_planes; S2: planes, words, num_bins, hw_planes): bit for
    bit equal, with the call's time, the plain version's and the bound."""
    from img2sgf_tpu_torch.hough import state_cuda as sc

    fn, plain = ((sc.state_canny_cuda, sc.state_canny_plain) if kernel == "S1"
                 else (sc.state_steps_cuda, sc.state_steps_plain))
    planes, hw = args[0], args[-1]
    label = (f"{label} [" + ",".join(map(str, planes.shape)) + "]"
             + (" with content dims" if hw is not None else ""))
    out_k = fn(*args)
    err = check_equal(f"{kernel} {label}", out_k, plain(*args))
    ms = cuda_ms(lambda: fn(*args), 10)
    pms = cuda_ms(lambda: plain(*args), 1)
    if kernel == "S1":
        work = state_work(kernel, planes, hw)
    else:
        work = state_work(kernel, planes, hw, out_k[0],
                          edge_pairs(planes, hw, out_k[0]))
    nbytes, ops, flops = work
    b_ms, b_by = roofline(nbytes, ops, rate, flops)
    log("kernels", f"{kernel} {label}: equal, call {ms:.3f} ms, plain "
        f"{pms:.3f} ms, bound {b_ms * 1e3:.2f} us ({b_by}: "
        f"{nbytes / 1e6:.2f} MB, {ops / 1e6:.1f} M int32 instructions, "
        f"{flops / 1e6:.1f} M float32 operations)")
    return dict(label=label, ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                err=err, bytes=nbytes, operations=ops, flops=flops,
                call=lambda: fn(*args))


def profiled_events(fn, reps, label):
    """One warm-up call of fn, then `reps` calls under torch.profiler: (the
    device events recorded, the wall ms per call). A profile that records
    no device event at all (the profiler can drop a whole cycle after a
    long one) is taken again, at most three times in all; then it fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / reps
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if evs:
            return evs, wall
        log("profile", f"{label}: the profiler recorded no device activity "
            f"(attempt {attempt + 1} of 3)")
    raise AssertionError(f"{label}: the profiler recorded no device activity "
                         "in 3 profiles")


def profile_call(call, name, reps):
    """torch.profiler over `reps` calls (profiled_events): per call, the
    device kernels launched, those named `name`, and the device-to-host
    copies; the device time of `name` per call, and the other kernels'
    names."""
    evs, _ = profiled_events(call, reps, name)
    d2h = [e for e in evs if e.name.startswith("Memcpy") and "DtoH" in e.name]
    launched = [e for e in evs if not e.name.startswith(("Memcpy", "Memset"))]
    mine = [e for e in launched if name in e.name]
    kernel_ms = sum(e.time_range.elapsed_us() for e in mine) / reps / 1e3
    others = sorted({e.name.split("(")[0][:60] for e in launched
                     if name not in e.name})
    return (len(launched) / reps, len(mine) / reps, len(d2h) / reps,
            kernel_ms, others)


def phase_profile(kernels, reps=5):
    """Phase 7: torch.profiler over `reps` calls of each kernel's wrapper
    at its main-path case (K3, the greedy kernel, A, S1 and S2: at each of
    their cases): the device kernels and device-to-host copies of a call,
    and the kernel's own device time. Every kernel but K2 (which launches
    its device assert's kernels too) must be one kernel and no copy per
    call."""
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
            if k != "K2" and (n, n_mine, n_d2h) != (1, 1, 0):
                raise AssertionError(f"{k} {label} is not one launch "
                                     "and no device read per call")
        r["kernel_ms"] = cases[0]["kernel_ms"]


def phase_tables(dev):
    """Phase 3: direction bins and walk steps, CUDA against CPU; direction
    bins also at BIN_COUNTS (the generated exception table on both)."""
    import torch

    from img2sgf_tpu_torch.hough.circles import direction_bins, pixel_steps
    from img2sgf_tpu_torch.hough.state_cuda import label_table

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
    nt = int((label_table(64, str(dev)).cpu() != b_cpu.reshape(-1)).sum())
    for n in BIN_COUNTS:
        cpu = direction_bins(dx, dy, n)
        nb = int((cpu != direction_bins(dx.to(dev), dy.to(dev), n).cpu()).sum())
        if nb:
            raise AssertionError(f"direction_bins at {n} bins: CUDA and CPU "
                                 f"differ on {nb} pairs")
        nt += int((label_table(n, str(dev)).cpu() != cpu.reshape(-1)).sum())
    if nt:
        raise AssertionError(f"S2's label tables differ from the CPU's "
                             f"direction_bins on {nt} entries")
    log("tables", f"direction_bins equal on all {dx.numel()} pairs at "
        f"{list(BIN_COUNTS)} bins (CUDA vs CPU); S2's label tables on the "
        f"card equal the CPU's bins at 64 and {list(BIN_COUNTS)}")


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
    from img2sgf_tpu_torch.pipeline import detect_board

    thr = choose_line_threshold(rgb.shape[0], rgb.shape[1])

    # the counted main-path run
    counters = reset_counts()
    res = detect_board(rgb, cfg, thr, device=dev)
    launches = read_counts(counters)

    phantoms = check_stones(res, None, stones, N_LINES, "detect_board")
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


# the overflow rerun's read of the saturation flags: an event wait, which
# PyTorch's sync debug mode does not see, counted by the pipeline instead
FLAG_READ_SITE = ("img2sgf_tpu_torch/pipeline/detect.py _chunks_to_run "
                  "(saturation flags, event wait)")


def sync_sites(fn):
    """Run fn() once under torch.cuda.set_sync_debug_mode("warn"): the host
    synchronisations it makes, as {"file:line function": count} of the
    innermost frame of this repository's code under each, and the reads of
    the saturation flags (FLAG_READ_SITE)."""
    import traceback
    import warnings

    import torch

    sites = {}

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1]
                if f.filename.startswith(str(HERE))
                and not f.filename.endswith("chip_smoke.py")]
        where = (f"{os.path.relpath(ours[-1].filename, HERE)}:{ours[-1].lineno}"
                 f" {ours[-1].name}" if ours else "outside the repository")
        sites[where] = sites.get(where, 0) + 1

    from img2sgf_tpu_torch.pipeline import detect

    torch.cuda.synchronize()
    reads = detect.flag_reads
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if detect.flag_reads > reads:
        sites[FLAG_READ_SITE] = detect.flag_reads - reads
    return sites


def no_sync(label, fn):
    """fn() under torch.cuda.set_sync_debug_mode("error"): a host
    synchronisation fails the check."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        raise AssertionError(f"{label} synchronised the host: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def phase_post(dev, cfg, rgb, batch, recorded, stage_ms):
    """Phase 5e: the post stage, one pass over a batch (_post_circles) at
    the recorded inputs of the 768^2 main path, the 16-image bucket batch
    and the 32-image 512^2 batch: a warm pass, a warm greedy_min_dist call
    and a warm kernel A call make no host synchronisation
    (set_sync_debug_mode "error"); the
    warm pass's wall (host clock to a sync) and CUDA-event time, median of
    5, beside the post stage's ms from timings= (stage_ms), and the CUDA-
    event ms of its erase_circles alone (mean of 5); then the host
    synchronisations of one warm detect_board and one warm 16-image bucket
    batch, counted by their sites (set_sync_debug_mode "warn")."""
    import torch

    from img2sgf_tpu_torch import choose_line_threshold
    from img2sgf_tpu_torch.hough import accumulator_cuda, greedy_cuda
    from img2sgf_tpu_torch.hough.erase import erase_circles
    from img2sgf_tpu_torch.pipeline import detect as pdetect
    from img2sgf_tpu_torch.pipeline import detect_board, detect_board_bucket_batch

    out = {}
    for name, calls in recorded.items():
        (args, kw), = calls["post"]
        B = args[0].shape[0]
        label = {"single": f"detect_board {SIZE}",
                 "bucket": f"bucket_batch_{SIZE}_B{B}",
                 "small": f"batch_{SMALL}_B{B}"}[name]
        fn = lambda a=args, k=kw: pdetect._post_circles(*a, **k)  # noqa: E731
        fn()  # warm: the Hough vote tables are cached per shape
        no_sync(f"post pass ({label})", fn)
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[label] = dict(B=B, post_wall_ms=statistics.median(walls) * 1e3,
                          post_event_ms=cuda_ms(fn, 5),
                          post_stage_ms=stage_ms[label],
                          erase_event_ms=cuda_ms(lambda a=args: erase_circles(
                              a[1], a[2], a[3], hw=a[6]), 5))
        log("post", f"{label}: one post pass over B={B}, no host "
            f"synchronisation; warm wall {out[label]['post_wall_ms']:.2f} ms, "
            f"CUDA events {out[label]['post_event_ms']:.2f} ms (median of 5); "
            f"post stage from timings= {stage_ms[label]:.2f} ms; its erase "
            f"alone {out[label]['erase_event_ms']:.2f} ms (CUDA events)")
    (gargs, _), = recorded["single"]["G"]
    no_sync("greedy_min_dist", lambda: greedy_cuda.greedy_min_dist(*gargs))
    (aargs, _), = recorded["single"]["A"]
    no_sync("vote_accumulator_cuda",
            lambda: accumulator_cuda.vote_accumulator_cuda(*aargs))
    log("post", "a warm greedy_min_dist call and a warm kernel A call: no "
        "host synchronisation")

    thr = choose_line_threshold(*rgb.shape[:2])
    canvases, hs, ws, ths = bucket([im for im, _ in batch])
    runs = {f"detect_board {SIZE}": lambda: detect_board(rgb, cfg, thr, device=dev),
            f"bucket_batch_{SIZE}_B{len(batch)}": lambda: detect_board_bucket_batch(
                canvases, cfg, ths, hs, ws, device=dev)}
    syncs = {}
    for label, fn in runs.items():
        fn()
        sites = sync_sites(fn)
        syncs[label] = dict(count=sum(sites.values()), sites=sites)
        log("post", f"{label}: {sum(sites.values())} host synchronisations in "
            "one warm call: " + "; ".join(f"{k} x{v}" for k, v in sites.items()))
    out["host_syncs"] = syncs
    return out


# Phase 4c: config values off the default path that the JAX package runs
# (the per-offset accumulator, r = 0 in K2 and K3, block proposals, other
# direction-bin counts), each on the 768^2 diagram and, CUDA against CPU, on
# a smaller diagram whose CPU run stays short.
CONFIG_VARIANTS = (
    ("circle_max_radius=31", dict(circle_max_radius=31)),
    ("circle_min_radius=0 circle_max_radius=29",
     dict(circle_min_radius=0, circle_max_radius=29)),
    ("propose_block=2", dict(propose_block=2)),
    ("num_angle_bins=48", dict(num_angle_bins=48)),
    ("num_angle_bins=63", dict(num_angle_bins=63)),
)
MIN_R0 = CONFIG_VARIANTS[1][0]  # the variant whose K2 and K3 inputs are kept
COMPARE = dict(size=320, n=13, n_stones=20, seed=SEED + 30)


def phase_configs(dev, rgb, stones, cfg):
    """Phase 4c: detect_board under each CONFIG_VARIANTS value on the 768^2
    diagram (counted: every planted stone found, each kernel launched, no
    plain version on the card), its warm wall beside the default config's,
    and its CUDA result equal to its CPU run on the COMPARE diagram. Returns
    (launches by path, walls, the K1-K3 calls of the MIN_R0 run)."""
    from img2sgf_tpu_torch import choose_line_threshold
    from img2sgf_tpu_torch.pipeline import detect_board

    thr = choose_line_threshold(*rgb.shape[:2])
    small, _ = render_diagram(**COMPARE)
    sthr = choose_line_threshold(*small.shape[:2])
    paths, walls, calls0 = {}, {}, None
    for name, change in (("default", {}),) + CONFIG_VARIANTS:
        vcfg = cfg.replace(**change)
        if change:
            launches = {}
            with counted(launches):
                res = detect_board(rgb, vcfg, thr, device=dev)
            paths[f"detect_board {SIZE} {name}"] = launches
            extra = check_stones(res, None, stones, N_LINES, name)
        if name == MIN_R0:
            with recording() as calls0:
                detect_board(rgb, vcfg, thr, device=dev)
        wall, stages = wall_runs(lambda tm: detect_board(
            rgb, vcfg, thr, device=dev, timings=tm))
        walls[f"detect_board_{SIZE}_{name.replace(' ', '_')}"] = dict(
            wall_ms=wall * 1e3, stage_ms=stages)
        if not change:
            log("configs", f"default config: warm wall {wall * 1e3:.1f} ms")
            continue
        t0 = time.perf_counter()
        res_c = detect_board(small, vcfg, sthr, device="cpu")
        cpu_s = time.perf_counter() - t0
        compare_results(detect_board(small, vcfg, sthr, device=dev), res_c,
                        f"{name} at {COMPARE['size']}^2, CUDA vs CPU")
        log("configs", f"{name}: all {len(stones)} planted stones found at "
            f"{SIZE}^2 ({extra} extra), launches {launches}; warm wall "
            f"{wall * 1e3:.1f} ms (" + ", ".join(
                f"{k} {v:.1f}" for k, v in stages.items())
            + f" ms); CUDA = CPU in every field at {COMPARE['size']}^2 "
            f"(CPU run {cpu_s:.1f} s)")
    return paths, walls, calls0


def phase_hough(dev, rgb, cfg):
    """Phase 4d: hough_circles_gradient, the diagnostic tools' single-plane
    path, on the 768^2 diagram's grey plane: counted (K1, K2 and K3 each
    launched), circles found, equal to its CPU run. Returns its launches."""
    import torch

    from img2sgf_tpu_torch import choose_line_threshold
    from img2sgf_tpu_torch.hough.circles import hough_circles_gradient
    from img2sgf_tpu_torch.pipeline import detect_board

    grey = detect_board(rgb, cfg, choose_line_threshold(*rgb.shape[:2]),
                        device=dev).grey
    args = (cfg.circle_canny_high, cfg.circle_acc_threshold,
            cfg.circle_min_dist, cfg.circle_min_radius, cfg.circle_max_radius,
            cfg.num_angle_bins, cfg.max_center_candidates,
            cfg.max_circles_per_variant, cfg.hysteresis_iters)
    launches = {}
    with counted(launches):
        circles, valid = hough_circles_gradient(grey, *args)
    circles_c, valid_c = hough_circles_gradient(grey.cpu(), *args)
    if not (torch.equal(circles.cpu(), circles_c)
            and torch.equal(valid.cpu(), valid_c)):
        raise AssertionError("hough_circles_gradient: CUDA and CPU differ")
    n = int(valid.sum())
    if n == 0:
        raise AssertionError("hough_circles_gradient found no circle")
    log("configs", f"hough_circles_gradient on the {SIZE}^2 grey plane: {n} "
        f"circles, CUDA = CPU; launches {launches}")
    return launches


def phase_accumulator(dev, rgb, cfg):
    """Phase 9: the plain per-offset accumulator (radius span 31) on the
    768^2 diagram's 8 unique planes under torch.profiler, beside the plain
    cascade (span 30) on the same labels and kernel A with each table:
    wall and device busy ms of one warm call."""
    import torch

    from img2sgf_tpu_torch.hough.accumulator_cuda import vote_accumulator_cuda
    from img2sgf_tpu_torch.hough.circles import (
        circle_plane_state_pool, vote_accumulator_cascade_labels,
        vote_accumulator_offsets)
    from img2sgf_tpu_torch.pipeline.detect import _pre_circles, _variant_dedup

    v = _pre_circles(torch.from_numpy(rgb).to(dev)[None], cfg)[2][0]
    keep, _ = _variant_dedup(cfg, v.shape[0])
    lbl = circle_plane_state_pool(v[keep], cfg.circle_canny_high, 1, 31,
                                  cfg.num_angle_bins, cfg.hysteresis_iters,
                                  with_acc=False)["lbl"]
    out = {}
    nb = cfg.num_angle_bins
    for name, fn in (("offsets_r1_31", lambda: vote_accumulator_offsets(lbl, nb, 1, 31)),
                     ("cascade_r1_30", lambda: vote_accumulator_cascade_labels(lbl, nb, 1, 30)),
                     ("kernel_r1_31", lambda: vote_accumulator_cuda(lbl, nb, 1, 31)),
                     ("kernel_r1_30", lambda: vote_accumulator_cuda(lbl, nb, 1, 30))):
        wall_ms, busy_ms, n, top = device_busy(fn, top=2)
        out[name] = dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                         device_events=n)
        log("configs", f"accumulator {name} over [{lbl.shape[0]},{SIZE},{SIZE}] "
            f"labels: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms over "
            f"{n} device kernels; most: " + "; ".join(
                f"{k[:60]} {ms:.1f} ms x{c}" for k, ms, c in top))
    return out


@contextlib.contextmanager
def counted(out: dict):
    """Set every kernel's launch count (and plain-version call count) to 0,
    run the body, then store the launch counts (by kernel) in out. A path on
    the card that called a plain version fails. The graph caches are
    dropped first, so a path through a graphed entry point makes its first
    call: the launches counted are its warm-up's (the eager segments, one
    rerun chunk included); a capture launches nothing, and phase 10 counts
    a warm replay's kernels from the profile."""
    from img2sgf_tpu_torch.pipeline import graphs

    graphs.clear()
    counters = reset_counts()
    yield
    out.update(read_counts(counters))


def check_batch_launches(launches, label):
    """One batch makes 2 K1 calls (outer and internal Canny), 2 K2, 1 K3,
    1 greedy, 1 accumulator (A), 1 S1 and 1 S2 launch, plus 2 K2, 1 K3 and
    1 greedy
    launch when a plane saturates (and in the warm-up of a graphed path's
    first call, which runs one rerun chunk; the rerun reuses the plane
    state), whatever its size."""
    k1, k2, k3 = launches["K1"], launches["K2"], launches["K3"]
    if k1 != 2 or k3 not in (1, 2) or k2 != 2 * k3 or launches["G"] != k3 \
            or [launches[k] for k in ("A", "S1", "S2")] != [1, 1, 1]:
        raise AssertionError(f"{label}: launches {launches}, expected K1 2, "
                             "K2 2, K3 1, G 1, A 1, S1 1 and S2 1 (plus 2, 1 "
                             "and 1 with a rerun)")


def check_stones(res, i, stones, n_lines, label):
    """Row i of a batch result (i=None: a single-image result): board-ready,
    n_lines x n_lines, and every planted stone with its colour. Returns the
    extra stones' count."""
    row = (lambda t: t) if i is None else (lambda t: t[i])
    if not bool(row(res.board_ready)):
        raise AssertionError(f"{label} image {i}: board not ready")
    h, v = int(row(res.hsize)), int(row(res.vsize))
    if h != n_lines or v != n_lines:
        raise AssertionError(f"{label} image {i}: grid {h}x{v}")
    board = row(res.full_board).cpu().numpy()
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


def busy_union_ms(evs) -> float:
    """The union of the device events' intervals, in ms: time in which the
    device ran at least one of them (overlapping events count once)."""
    total, end = 0.0, None
    for s, e in sorted((ev.time_range.start, ev.time_range.end) for ev in evs):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def device_busy(fn, top=6):
    """One warm run of fn under torch.profiler (profiled_events): (wall ms,
    device busy ms as the union of its kernels' and copies' intervals, their
    count, the `top` names by device time as (name, summed ms, count))."""
    evs, wall = profiled_events(fn, 1, "device_busy")
    by_name = {}
    for e in evs:
        ms, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, cnt + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return (wall, busy_union_ms(evs), len(evs),
            [(k, ms, c) for k, (ms, c) in ranked])


def phase_busy(dev, cfg, batch, graphed_ms):
    """Phase 8: the device busy time (the union of the device intervals) of
    one warm 16-image bucket batch under torch.profiler, logged beside the
    median unprofiled graphed wall (graphed_ms, phase 5) (last of all: a
    profiled run of ~18,000 device events has made the next profiled run
    drop a kernel event)."""
    from img2sgf_tpu_torch.pipeline import detect_board_bucket_batch

    canvases, hs, ws, ths = bucket([im for im, _ in batch])
    wall_ms, busy_ms, n, top = device_busy(lambda: detect_board_bucket_batch(
        canvases, cfg, ths, hs, ws, device=dev))
    log("busy", f"bucket batch B={len(batch)} under torch.profiler: device "
        f"busy {busy_ms:.1f} ms (union of {n} device kernels and copies) "
        f"beside the median unprofiled graphed wall {graphed_ms:.1f} ms "
        f"(profiled wall {wall_ms:.1f} ms); most device time: " + "; ".join(
            f"{name[:80]} {ms:.1f} ms x{cnt}" for name, ms, cnt in top))
    return dict(profiled_wall_ms=wall_ms, device_busy_ms=busy_ms,
                graphed_wall_ms=graphed_ms, device_events=n)


def phase_batch(dev, cfg, batch, small, small_stones):
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

    sbatch, sths = small
    launches512 = {}
    with counted(launches512):
        res512 = detect_board_batch(sbatch, cfg, sths, device=dev)
    paths[f"detect_board_batch B={SMALL_B} {SMALL}"] = launches512
    check_batch_launches(launches512, f"B={SMALL_B} batch")
    extra = sum(check_stones(res512, i, stones, SMALL_LINES, "512 batch")
                for i, stones in enumerate(small_stones))
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
    return paths, tput


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
            or launches["K2"] != 2 * launches["K3"] \
            or [launches[k] for k in ("A", "S1", "S2")] != [2, 2, 2]:
        raise AssertionError(f"two shards' launches {launches}, expected K1 4, "
                             "K2 4, K3 2, A 2, S1 2 and S2 2 (plus 2 K2 and 1 "
                             "K3 a shard with a rerun)")
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


@contextlib.contextmanager
def eager_entry_points():
    """The entry points run their segments eagerly (_detect_batch_impl,
    with no sync between stages) instead of replaying graphs: the eager
    side of phase 10's comparisons."""
    from img2sgf_tpu_torch.pipeline import detect

    graphed = detect._detect_batch
    detect._detect_batch = lambda rgb, cfg, ths, hw, timings: \
        detect._detect_batch_impl(rgb, cfg, ths, hw, timings)
    try:
        yield
    finally:
        detect._detect_batch = graphed


def graph_paths(dev, cfg, rgb, batch, small):
    """Phase 10's paths: {label: call} through the graphed entry points."""
    from img2sgf_tpu_torch import choose_line_threshold
    from img2sgf_tpu_torch.pipeline import (
        detect_board_auto, detect_board_batch, detect_board_bucket_batch,
        detect_board_jit)

    thr = choose_line_threshold(*rgb.shape[:2])
    canvases, hs, ws, ths = bucket([im for im, _ in batch])
    sbatch, sths = small
    noisy = noisy_diagram()
    off = cfg.replace(overflow_center_candidates=0)
    return {
        f"detect_board_auto {SIZE}": lambda: detect_board_auto(
            rgb, cfg, thr, device=dev),
        f"detect_board_jit {SIZE}": lambda: detect_board_jit(
            rgb, cfg, thr, device=dev),
        f"detect_board_auto {SIZE} overflow off": lambda: detect_board_auto(
            rgb, off, thr, device=dev),
        "detect_board_jit noisy 256 (overflow chunks)": lambda: detect_board_jit(
            noisy, cfg, 30, device=dev),
        f"detect_board_bucket_batch B={len(batch)} {canvases.shape[1]}":
            lambda: detect_board_bucket_batch(canvases, cfg, ths, hs, ws,
                                              device=dev),
        f"detect_board_batch B={len(sths)} {SMALL}": lambda: detect_board_batch(
            sbatch, cfg, sths, device=dev),
    }


def pool_bytes(dev):
    """Bytes of device memory in the graph pool of (dev, its current
    stream), from the allocator's snapshot; None where the snapshot does
    not name pools."""
    import torch

    from img2sgf_tpu_torch.pipeline import graphs

    pool = tuple(graphs.cache_for(dev).pool)
    segs = torch.cuda.memory_snapshot()
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    return sum(sg["total_size"] for sg in segs
               if tuple(sg["segment_pool_id"]) == pool)


def phase_graphs(dev, cfg, rgb, batch, small):
    """Phase 10: the captured CUDA graphs of the jitted entry points. Each
    path's graphed call (first: warm-up, capture and a replay; then warm
    replays) equals the eager segments' run in every field; the noisy
    diagram replays its chunk graphs; the editing session's action script
    gives the same log, boards and SGF graphed and eager. Then per path:
    the host synchronisations of a warm graphed call by site (at most one,
    the saturation-flag read; none with the overflow rerun off), the
    first call's wall (warm-up and capture) and peak memory beside the
    eager call's, the graph pool's size, and graphed and eager warm walls
    in turns, each the median of 5. Returns the JSON record."""
    import torch

    from img2sgf_tpu_torch.gui.session import DetectSession
    from img2sgf_tpu_torch.pipeline import graphs

    out = {}
    for label, fn in graph_paths(dev, cfg, rgb, batch, small).items():
        graphs.clear()
        with eager_entry_points():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            t0 = time.perf_counter()
            want = fn()
            torch.cuda.synchronize()
            eager_first_ms = (time.perf_counter() - t0) * 1e3
            eager_peak = torch.cuda.max_memory_allocated(dev) - base
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        caps, reps = graphs.captures, graphs.replays
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        graph_peak = torch.cuda.max_memory_allocated(dev) - base
        n_graphs, n_replays = graphs.captures - caps, graphs.replays - reps
        compare_results(got, want, f"{label}: graphed first call vs eager")
        compare_results(fn(), want, f"{label}: warm replay vs eager")
        sites = sync_sites(fn)
        seen = {k: v for k, v in sites.items() if k != FLAG_READ_SITE}
        if seen or sum(sites.values()) > 1:
            raise AssertionError(f"{label}: a warm graphed call synchronised "
                                 f"the host: {sites}")
        if "overflow off" in label and sites:
            raise AssertionError(f"{label}: the flags were read with the "
                                 "rerun off")
        if "chunks" in label and n_replays < 3:
            raise AssertionError(f"{label}: no chunk graph replayed "
                                 f"({n_replays} replays)")
        walls = {"graphed": [], "eager": []}
        for _ in range(5):
            for kind in ("graphed", "eager"):
                ctx = eager_entry_points() if kind == "eager" \
                    else contextlib.nullcontext()
                with ctx:
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                walls[kind].append((time.perf_counter() - t0) * 1e3)
        pool = pool_bytes(dev)
        rec = dict(
            graphs=n_graphs, replays_first_call=n_replays,
            host_syncs=sum(sites.values()), sync_sites=sites,
            graphed_ms=statistics.median(walls["graphed"]),
            eager_ms=statistics.median(walls["eager"]),
            graphed_walls_ms=walls["graphed"], eager_walls_ms=walls["eager"],
            first_call_ms=first_ms, eager_first_call_ms=eager_first_ms,
            first_call_peak_gb=graph_peak / 1e9, eager_peak_gb=eager_peak / 1e9,
            pool_gb=None if pool is None else pool / 1e9)
        out[label] = rec
        log("graphs", f"{label}: graphed = eager in every field ({n_graphs} "
            f"graphs, {n_replays} replays in the first call); warm graphed "
            f"{rec['graphed_ms']:.2f} ms vs eager {rec['eager_ms']:.2f} ms "
            f"(medians of 5, in turns); host syncs of a warm graphed call "
            f"{rec['host_syncs']} {sites}; first call (warm-up + capture + "
            f"replay) {first_ms:.1f} ms vs eager first {eager_first_ms:.1f} "
            f"ms; peak {graph_peak / 1e9:.2f} GB vs eager {eager_peak / 1e9:.2f}"
            f" GB; graph pool {rec['pool_gb']} GB")

    lines_g, lines_e = [], []
    g = session_script(DetectSession(cfg, log=lines_g.append, device=dev),
                       rgb, lines_g)
    with eager_entry_points():
        e = session_script(DetectSession(cfg, log=lines_e.append, device=dev),
                           rgb, lines_e)
    for a, b in zip(g, e):
        same = (a["log"] == b["log"] and a["side"] == b["side"]
                and a["sgf"] == b["sgf"]
                and ((a["board"] is None and b["board"] is None)
                     or np.array_equal(a["board"], b["board"])))
        if not same:
            raise AssertionError(f"session after {a['action']}: graphed and "
                                 "eager differ")
    out["session"] = {s_["action"]: dict(graphed_ms=s_["seconds"] * 1e3,
                                         eager_ms=t_["seconds"] * 1e3)
                      for s_, t_ in zip(g, e)}
    log("graphs", "session action script: log, boards, side to move and SGF "
        "equal graphed and eager after every action; first-script ms "
        "(graphed / eager): " + ", ".join(
            f"{k} {v['graphed_ms']:.1f} / {v['eager_ms']:.1f}"
            for k, v in out["session"].items()))
    out["max_graphs_per_pool"] = graphs.MAX_GRAPHS
    return out


def page_diagram(h, w, seed):
    """A seeded diagram, min(h, w) px square, top-left on a blank h x w
    page."""
    side = min(h, w)
    page = np.full((h, w, 3), 250, np.uint8)
    page[:side, :side] = render_diagram(size=side, seed=seed)[0]
    return page


def host_allocs():
    """cudaHostAlloc calls of PyTorch's pinned host allocator so far (None
    where this PyTorch does not count them)."""
    import torch

    get = getattr(torch.cuda, "host_memory_stats", None)
    return (get() if get is not None else {}).get("num_host_alloc")


def alternating_calls(dev, cfg, entry, batch=None, calls=6):
    """Graphed calls of one key that alternate two inputs back to back, no
    sync between them, after a first call that captures: for "auto"
    detect_board_auto of the 768^2 diagram and of a 767 x 700 page (one 768
    bucket), for "bucket_batch" detect_board_bucket_batch of the 16 batch
    diagrams (batch, batch_images() if None) in their order and reversed.
    Each result equals the eager run of its own input in every field, so
    the graph's static buffers never hand a call another call's pixels,
    and the warm calls capture nothing. Raises on any difference; returns
    the record, with the pinned allocator's new cudaHostAlloc calls in the
    warm calls (host_allocs, recorded, not held to a number)."""
    import torch

    from img2sgf_tpu_torch import choose_line_threshold
    from img2sgf_tpu_torch.pipeline import (
        detect_board_auto, detect_board_bucket_batch, graphs)

    if entry == "auto":
        inputs = [render_diagram()[0], page_diagram(SIZE - 1, 700, SEED + 1)]

        def call(x, **kw):
            return detect_board_auto(x, cfg, choose_line_threshold(
                *x.shape[:2]), device=dev, **kw)
    else:
        imgs = [im for im, _ in (batch or batch_images())]
        inputs = [bucket(imgs), bucket(imgs[::-1])]

        def call(x, **kw):
            canvases, hs, ws, ths = x
            return detect_board_bucket_batch(canvases, cfg, ths, hs, ws,
                                             device=dev, **kw)
    want = [call(x, timings={}) for x in inputs]
    call(inputs[0])
    torch.cuda.synchronize()
    captures, allocs = graphs.captures, host_allocs()
    got = [call(inputs[i % 2]) for i in range(calls)]
    torch.cuda.synchronize()
    rec = dict(calls=calls, captures=graphs.captures - captures,
               host_allocs=None if allocs is None else host_allocs() - allocs)
    for i, res in enumerate(got):
        compare_results(res, want[i % 2], f"{entry}: alternating call {i}")
    if rec["captures"]:
        raise AssertionError(f"{entry}: warm graphed calls captured: {rec}")
    return rec


def staging_ms(dev, x, reps=21):
    """The host wall of one staging of a host input x [B, h, w, 3] as the
    entry points do it (detect._to_device: pin_memory, the upload enqueued)
    and the upload's device time (CUDA events); medians of reps, the card
    idle before each."""
    import torch

    from img2sgf_tpu_torch.pipeline import detect

    host, upload = [], []
    e0, e1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    for _ in range(reps):
        torch.cuda.synchronize()
        e0.record()
        t0 = time.perf_counter()
        detect._to_device(x, dev)
        host.append((time.perf_counter() - t0) * 1e3)
        e1.record()
        torch.cuda.synchronize()
        upload.append(e0.elapsed_time(e1))
    return dict(to_device_host_ms=statistics.median(host),
                upload_device_ms=statistics.median(upload), bytes=x.numel())


def phase_staging(dev, cfg, rgb, batch):
    """Phase 10b: the host side of a graphed call. Back-to-back graphed
    calls alternating two inputs equal their eager results and capture
    nothing (alternating_calls: detect_board_auto at 768^2 and 767 x 700
    in one bucket, detect_board_bucket_batch at B = 16); then the
    staging's host and upload times at 768^2 and at B = 16 (staging_ms),
    and the host wall of the 16 to_sgf of the B = 16 result (median of 21
    passes). Returns the JSON record."""
    import torch

    from img2sgf_tpu_torch import to_sgf
    from img2sgf_tpu_torch.pipeline import detect_board_bucket_batch, graphs

    graphs.clear()
    out = {"alternating": {e: alternating_calls(dev, cfg, e, batch)
                           for e in ("auto", "bucket_batch")}}
    log("staging", "alternating graphed calls equal eager in every field, "
        f"no capture: {out['alternating']}")
    canvases, hs, ws, ths = bucket([im for im, _ in batch])
    B = len(hs)
    out["stage"] = {
        f"{SIZE}^2": staging_ms(dev, torch.from_numpy(rgb)),
        f"B={B} {SIZE}": staging_ms(dev, torch.from_numpy(canvases))}
    res = detect_board_bucket_batch(canvases, cfg, ths, hs, ws, device=dev)
    ready = res.board_ready.cpu().numpy()
    boards = res.full_board.cpu()
    sides = res.side_to_move.cpu().numpy()
    walls = []
    for _ in range(21):
        t0 = time.perf_counter()
        for i in range(B):
            if ready[i]:
                to_sgf(boards[i], side_to_move=int(sides[i]))
        walls.append((time.perf_counter() - t0) * 1e3)
    out["to_sgf_ms"] = {"boards": int(ready.sum()),
                        "median_ms": statistics.median(walls),
                        "min_ms": min(walls), "max_ms": max(walls)}
    for k, v in out["stage"].items():
        log("staging", f"{k}: _to_device {v['to_device_host_ms']:.3f} ms "
            f"host, upload {v['upload_device_ms']:.3f} ms device "
            f"({v['bytes']} bytes)")
    log("staging", f"{out['to_sgf_ms']['boards']} to_sgf on the host: "
        f"{out['to_sgf_ms']['median_ms']:.3f} ms (median of 21)")
    return out


def phase_graph_profiles(dev, cfg, rgb, batch, small, graph_rec, reps=3):
    """Phase 11 (last): torch.profiler over `reps` warm graphed calls of
    each phase-10 path: the kernels one call runs, counted by name (the
    launch counts of the wrappers do not see a replay), its device busy
    time (the union of the device intervals) beside the path's median
    unprofiled graphed wall from phase 10 (graph_rec), and the profiled
    wall. The 768^2 detect_board_auto call must run every kernel. A
    profile that records no device event is retaken (profiled_events)."""
    out = {}
    for label, fn in graph_paths(dev, cfg, rgb, batch, small).items():
        evs, wall = profiled_events(fn, reps, label)
        counts = {k: sum(name in e.name for e in evs) / reps
                  for k, name in KERNEL_NAMES.items()}
        busy = busy_union_ms(evs) / reps
        kernel_ms = {k: sum(e.time_range.elapsed_us() for e in evs
                            if name in e.name) / 1e3 / reps
                     for k, name in KERNEL_NAMES.items()}
        graphed = graph_rec[label]["graphed_ms"]
        out[label] = dict(kernels=counts, kernel_ms=kernel_ms,
                          device_events=len(evs) / reps, device_busy_ms=busy,
                          profiled_wall_ms=wall, graphed_wall_ms=graphed)
        log("graphs", f"{label}: one warm graphed call under torch.profiler "
            f"runs {counts} ({len(evs) / reps:g} device events), device busy "
            f"{busy:.2f} ms (union of the device intervals) beside the median "
            f"unprofiled graphed wall {graphed:.2f} ms (profiled wall "
            f"{wall:.2f} ms)")
    main = out[f"detect_board_auto {SIZE}"]["kernels"]
    if any(main[k] < 1 for k in KERNEL_NAMES) or main["K1"] != 2:
        raise AssertionError(f"the graphed main path's replay ran {main}")
    return out


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
    small, small_stones = small_images()
    kernels, recorded = phase_kernels(dev, rgb, cfg, batch, small)
    phase_tables(dev)
    launches, _wall, main_stages = phase_main_path(dev, rgb, stones, cfg)
    rerun_ms = phase_overflow(dev, cfg)
    cfg_paths, cfg_walls, calls0 = phase_configs(dev, rgb, stones, cfg)
    hough_launches = phase_hough(dev, rgb, cfg)
    # K2 and K3 at circle_min_radius = 0, at that run's own inputs; profiled
    # with each kernel's other cases in phase 7
    rate, _ = int32_ops_per_s(dev)
    r0 = recorded_k2_k3_cases(calls0, "circle_min_radius=0", rate)
    for k in r0:
        kernels[k]["cases"] += r0[k]
        kernels[k]["err"] = max([kernels[k]["err"]] + [c["err"] for c in r0[k]])
    paths, tput = phase_batch(dev, cfg, batch, small, small_stones)
    post = phase_post(dev, cfg, rgb, batch, recorded, {
        f"detect_board {SIZE}": main_stages["post"],
        **{k: t["stage_ms"]["post"] for k, t in tput.items()
           if k.startswith(("bucket_batch", "batch_"))}})
    del recorded
    paths.update(cfg_paths)
    paths[f"hough_circles_gradient {SIZE}"] = hough_launches
    tput.update(cfg_walls)
    session_paths, session = phase_session(dev, rgb, cfg)
    with tempfile.TemporaryDirectory() as tmp:
        jpegs, loader = phase_loader(batch, tmp)
        sharded_paths, sharded_tput = phase_sharded(dev, cfg, batch, small, jpegs)
    paths.update(session_paths)
    paths.update(sharded_paths)
    tput.update(sharded_tput)
    graph_rec = phase_graphs(dev, cfg, rgb, batch, small)
    staging = phase_staging(dev, cfg, rgb, batch)
    phase_profile(kernels)  # late: the profiler's hooks could slow the wall
    bb = tput[f"bucket_batch_{SIZE}_B{len(batch)}"]
    bb.update(phase_busy(dev, cfg, batch, bb["wall_ms"]))
    # K1's profile once more, after the busy profile's ~17,600 events, for
    # the record of whether a long profile makes the next one drop events
    # (logged, not asserted: phase 7 holds K1 to one launch and no read)
    n, n_mine, n_d2h, _, _ = profile_call(kernels["K1"]["call"],
                                          KERNEL_NAMES["K1"], 5)
    log("profile", f"K1 main path after the busy profile: per call {n:g} "
        f"kernel launches ({n_mine:g} of {KERNEL_NAMES['K1']}), {n_d2h:g} "
        "device-to-host copies")
    # last: a profile of thousands of launches has made the next profile
    # record no device event at all
    tput[f"accumulator_{SIZE}_8_planes"] = phase_accumulator(dev, rgb, cfg)
    # after every other profile: the replays' kernels by name
    graph_rec["profiles"] = phase_graph_profiles(dev, cfg, rgb, batch, small,
                                                 graph_rec)

    names = COUNTERS
    paths = {f"detect_board {SIZE}": launches, **paths}
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
        # not a Pallas kernel: the JAX package's device fori_loop
        "G": ("greedy_min_dist", "img2sgf_tpu_torch/csrc/greedy.cu",
              "img2sgf_tpu/hough/circles.py:823"),
        # not a Pallas kernel: the JAX package's lax.map over
        # vote_accumulator_packed4 (and the per-offset chain, :299-347)
        "A": ("vote_accumulator", "img2sgf_tpu_torch/csrc/accumulator.cu",
              "img2sgf_tpu/hough/circles.py:278"),
        # not Pallas kernels: the plane-state stage that XLA fuses
        "S1": ("state_canny", "img2sgf_tpu_torch/csrc/state.cu",
               "img2sgf_tpu/pipeline/detect.py:156"),
        "S2": ("state_steps", "img2sgf_tpu_torch/csrc/state.cu",
               "img2sgf_tpu/pipeline/detect.py:156"),
    }
    rows = []
    for k, (name, src, rep) in meta.items():
        r = kernels[k]
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": rep, "launches": launches[k],
               "max_abs_err": r["err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": None,
               "kernel_ms": r["kernel_ms"],
               "launches_by_path": {p: c[k] for p, c in paths.items()},
               "replay_launches": {p: v["kernels"][k] for p, v in
                                   graph_rec["profiles"].items()}}
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
        if k == "A":
            row["label"] = r["label"]
            row["replaces_note"] = (
                "not a Pallas kernel: the lax.map over vote_accumulator_packed4"
                " (img2sgf_tpu/hough/circles.py:278-296) and the per-offset "
                "chain (:299-347)")
            row["library_ms"] = r["library_ms"]
            row["library_call"] = ("torch.nn.functional.conv2d over the "
                                   "one-hot labels, TF32 (768^2 main path)")
            row["library_max_abs_err"] = r["library_err"]
            row["cases"] = [{f: c[f] for f in fields + (
                "edges", "votes", "bytes")} for c in r["cases"]]
        if k in ("S1", "S2"):
            row["label"] = r["label"]
            row["replaces_note"] = (
                "not a Pallas kernel: the plane state that XLA fuses in "
                "_plane_state_pool (img2sgf_tpu/pipeline/detect.py:156); S1 "
                "the internal Canny before the hysteresis, S2 the edge mask, "
                "walk steps and direction labels after it")
            row["cases"] = [{f: c[f] for f in fields + (
                "bytes", "operations", "flops")} for c in r["cases"]]
        if k == "G":
            row["label"], row["steps"] = r["label"], r["steps"]
            row["us_per_step"] = us_per_step(r)
            row["cases"] = [{**{f: c[f] for f in fields + (
                "steps", "live", "bytes", "operations")},
                "us_per_step": us_per_step(c)} for c in r["cases"]]
        rows.append(row)
    # K2 (cells 5 and 3) and K3 at circle_min_radius = 0, rows of their own
    r0_path = f"detect_board {SIZE} {MIN_R0}"
    for k, cases in r0.items():
        name, src, rep = meta[k]
        for c in cases:
            rows.append({
                "name": f"{name} ({c['label']})", "route": "cuda",
                "source": src, "replaces": rep,
                "launches": paths[r0_path][k], "max_abs_err": c["err"],
                "ms": c["ms"], "plain_ms": c["plain_ms"],
                "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                "library_ms": None, "kernel_ms": c["kernel_ms"],
                "launches_by_path": {r0_path: paths[r0_path][k]}})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"throughput": tput}))
    print(json.dumps({"post": post}))
    print(json.dumps({"session": session, "loader": loader}))
    print(json.dumps({"graphs": graph_rec}))
    print(json.dumps({"staging": staging}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
