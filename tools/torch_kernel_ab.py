#!/usr/bin/env python3
"""Wrapper-call times of the port's CUDA kernels in one checkout, on the
card, for comparing two checkouts within one machine session:

    python3 tools/torch_kernel_ab.py CHECKOUT

imports img2sgf_tpu_torch and chip_smoke from CHECKOUT (a directory holding
both), records the K1, K2 and K3 wrapper calls of one detect_board run on
chip_smoke's 768^2 synthetic diagram (default config), and times each call
with CUDA events (mean of 20 calls after a warm-up, three rounds, median);
then the greedy_min_dist call of that run (host wall to a device sync,
median of 20: a host loop in checkouts that have no greedy kernel); then
the warm walls, median of 5, with their per-stage times (timings=, each
stage's median) of detect_board and of chip_smoke's two batch cells: the
16-image 768 bucket batch and the 32-image 512^2 batch. Prints one JSON
line. Run it on two checkouts in turns (parent, change, change, parent) in
one command: the card and its host then stay the same.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import sys
import time


def main(tree: str) -> int:
    root = pathlib.Path(tree).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: needs an NVIDIA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from img2sgf_tpu_torch import DetectionConfig, _build, choose_line_threshold
    from img2sgf_tpu_torch.hough import circles, radius_cuda, rescore_cuda
    from img2sgf_tpu_torch.ops import hysteresis_cuda
    from img2sgf_tpu_torch.pipeline import (
        detect_board, detect_board_batch, detect_board_bucket_batch)

    if not cs.__file__.startswith(str(root)):
        raise RuntimeError(f"chip_smoke imported from {cs.__file__}, not {root}")
    dev = torch.device("cuda", 0)
    _build.load()
    cfg = DetectionConfig()
    rgb, _ = cs.render_diagram()
    calls = cs.main_path_calls(dev, rgb, cfg)
    (outer, _), (internal, _) = calls["K1"]
    (k2_5, kw_5), (k2_3, kw_3) = calls["K2"]
    k3 = calls["K3"][0][0]
    cases = {
        "K1 outer canny": lambda: hysteresis_cuda.hysteresis_packed(*outer),
        "K1 internal canny": lambda: hysteresis_cuda.hysteresis_packed(*internal),
        f"K2 cells={kw_5['cells']}": lambda: rescore_cuda.exact_rescore(*k2_5, **kw_5),
        f"K2 cells={kw_3['cells']}": lambda: rescore_cuda.exact_rescore(*k2_3, **kw_3),
        "K3": lambda: radius_cuda.radius_support_pool(*k3),
    }
    rounds = {k: [] for k in cases}
    for _ in range(3):
        for k, fn in cases.items():
            rounds[k].append(cs.cuda_ms(fn, 20))
    thr = choose_line_threshold(*rgb.shape[:2])

    greedy_args = []
    greedy = circles.greedy_min_dist

    def record(*a):
        greedy_args.append(a)
        return greedy(*a)

    circles.greedy_min_dist = record
    try:
        detect_board(rgb, cfg, thr, device=dev)
    finally:
        circles.greedy_min_dist = greedy
    greedy_ms = wall_ms(lambda: greedy(*greedy_args[0]), 20)[0]

    canvases, hs, ws, ths = cs.bucket([im for im, _ in cs.batch_images()])
    small = [cs.render_diagram(size=cs.SMALL, n=cs.SMALL_LINES,
                               n_stones=cs.SMALL_STONES, seed=cs.SMALL_SEED + i)[0]
             for i in range(cs.SMALL_B)]
    sths = [choose_line_threshold(cs.SMALL, cs.SMALL)] * cs.SMALL_B
    runs = {
        "detect_board_768": lambda tm: detect_board(rgb, cfg, thr, device=dev,
                                                    timings=tm),
        "bucket_batch_768_B16": lambda tm: detect_board_bucket_batch(
            canvases, cfg, ths, hs, ws, device=dev, timings=tm),
        "batch_512_B32": lambda tm: detect_board_batch(
            cs.np.stack(small), cfg, sths, device=dev, timings=tm),
    }
    walls = {}
    for name, fn in runs.items():
        wall, _ = wall_ms(lambda: fn(None), 5)
        stages = {}
        for _ in range(5):
            tm = {}
            fn(tm)
            for k, v in tm.items():
                stages.setdefault(k, []).append(v * 1e3)
        walls[name] = dict(wall_ms=wall, stage_ms={
            k: statistics.median(v) for k, v in stages.items()})
    print(json.dumps({
        "checkout": str(root), "device": torch.cuda.get_device_name(0),
        "call_ms": {k: statistics.median(v) for k, v in rounds.items()},
        "greedy_min_dist_wall_ms": greedy_ms,
        "detect_board_wall_ms": walls["detect_board_768"]["wall_ms"],
        "walls": walls}))
    return 0


def wall_ms(fn, reps: int):
    """(median host wall ms of reps runs of fn, each ending in a device
    sync, after one warm-up run; the list of walls)."""
    import torch

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls), walls


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1]))
