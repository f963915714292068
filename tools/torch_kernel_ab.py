#!/usr/bin/env python3
"""Wrapper-call times of the port's CUDA kernels in one checkout, on the
card, for comparing two checkouts within one machine session:

    python3 tools/torch_kernel_ab.py CHECKOUT

imports img2sgf_tpu_torch and chip_smoke from CHECKOUT (a directory holding
both) and records the kernel wrapper calls of one detect_board run on
chip_smoke's 768^2 synthetic diagram (default config), of the 16-image 768
bucket batch and of the 32-image 512^2 batch: K1, K2 and K3 of the 768^2
run; kernel A (the accumulator) of the 768^2 run, the two batches, and the
768^2 labels with the per-offset table (r 1-31) and at r 0-29, and on
all-sentinel pools of the 768^2 and bucket shapes (the scan alone); the greedy
kernel G of the 768^2 run, the two batches and the noisy 256^2 diagram's
overflow rerun, and at chip_smoke's seeded [3, 8192] and [8, 1024] cases
and a [2, 20000] list at max_out 8000. Each call is timed with CUDA
events (mean of 20 calls after a warm-up, 3 for the long G cases; three
rounds, median) and under torch.profiler (the kernel's own device time a
call, mean of 5 calls: the wrapper's time can differ between processes
with the kernel unchanged, its device time does not). Then the warm walls,
median of 5 (each of the 5 also given), with their per-stage times (timings=, each stage's median) of
detect_board, the graphed detect_board_auto, and chip_smoke's two batch
cells (graphed; their stages eager). Prints one JSON line. Run it on two
checkouts in turns (parent, change, change, parent) in one command: the
card and its host then stay the same.
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
    from img2sgf_tpu_torch.hough import (
        accumulator_cuda, greedy_cuda, radius_cuda, rescore_cuda)
    from img2sgf_tpu_torch.ops import hysteresis_cuda
    from img2sgf_tpu_torch.pipeline import (
        detect_board, detect_board_auto, detect_board_batch,
        detect_board_bucket_batch)

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
    canvases, hs, ws, ths = cs.bucket([im for im, _ in cs.batch_images()])
    small = [cs.render_diagram(size=cs.SMALL, n=cs.SMALL_LINES,
                               n_stones=cs.SMALL_STONES, seed=cs.SMALL_SEED + i)[0]
             for i in range(cs.SMALL_B)]
    sths = [choose_line_threshold(cs.SMALL, cs.SMALL)] * cs.SMALL_B
    with cs.recording() as bcalls:
        detect_board_bucket_batch(canvases, cfg, ths, hs, ws, device=dev,
                                  timings={})
    with cs.recording() as scalls:
        detect_board_batch(cs.np.stack(small), cfg, sths, device=dev,
                           timings={})
    with cs.recording() as ocalls:
        detect_board(cs.noisy_diagram(), cfg, 30, device=dev)
    lbl, nb = calls["A"][0][0][:2]
    acc = accumulator_cuda.vote_accumulator_cuda
    blbl = bcalls["A"][0][0][0]
    a_cases = {
        "768 main": calls["A"][0][0],
        "bucket B16": bcalls["A"][0][0],
        "512 B32": scalls["A"][0][0],
        "768 per-offset r1-31": (lbl, nb, 1, 31),
        "768 r0-29": (lbl, nb, 0, 29),
        # every pixel the sentinel: the scan alone, no vote
        "768 sentinel": (torch.full_like(lbl, nb), nb, 1, 30),
        "bucket B16 sentinel": (torch.full_like(blbl, nb), nb, 1, 30),
    }
    rng = cs.np.random.default_rng(11)
    large = [torch.from_numpy(rng.integers(0, 4000, (2, 20000))).to(dev),
             torch.from_numpy(rng.integers(0, 4000, (2, 20000))).to(dev),
             torch.ones((2, 20000), dtype=torch.bool, device=dev), 10.0, 8000]
    seeded = {label: [*(torch.from_numpy(x).to(dev) for x in (ys, xs, lv)),
                      md, mo]
              for label, ys, xs, lv, md, mo in cs.greedy_cases()}
    g_cases = {
        "768 main": calls["G"][0][0],
        "bucket B16": bcalls["G"][0][0],
        "512 B32": scalls["G"][0][0],
        "noisy rerun": ocalls["G"][1][0],
        "seeded [3,8192]": seeded["K = 8192"],
        "seeded [8,1024]": seeded["random [8, 1024]"],
        "[2,20000] max_out 8000": large,
    }
    greedy = greedy_cuda.greedy_min_dist
    cases = {
        "K1 outer canny": lambda: hysteresis_cuda.hysteresis_packed(*outer),
        "K1 internal canny": lambda: hysteresis_cuda.hysteresis_packed(*internal),
        f"K2 cells={kw_5['cells']}": lambda: rescore_cuda.exact_rescore(*k2_5, **kw_5),
        f"K2 cells={kw_3['cells']}": lambda: rescore_cuda.exact_rescore(*k2_3, **kw_3),
        "K3": lambda: radius_cuda.radius_support_pool(*k3),
        **{f"A {k}": (lambda a=a: acc(*a)) for k, a in a_cases.items()},
        **{f"G {k}": (lambda a=a: greedy(*a)) for k, a in g_cases.items()},
    }
    reps = {k: 3 if k in ("G seeded [3,8192]", "G [2,20000] max_out 8000")
            else 20 for k in cases}
    rounds = {k: [] for k in cases}
    for _ in range(3):
        for k, fn in cases.items():
            rounds[k].append(cs.cuda_ms(fn, reps[k]))
    kernel_ms = {}
    for k, fn in cases.items():
        name = cs.KERNEL_NAMES[k.split()[0]]
        kernel_ms[k] = cs.profile_call(fn, name, 5)[3]
    thr = choose_line_threshold(*rgb.shape[:2])

    runs = {
        "detect_board_768": lambda tm: detect_board(rgb, cfg, thr, device=dev,
                                                    timings=tm),
        "detect_board_auto_768": lambda tm: detect_board_auto(
            rgb, cfg, thr, device=dev, timings=tm),
        "bucket_batch_768_B16": lambda tm: detect_board_bucket_batch(
            canvases, cfg, ths, hs, ws, device=dev, timings=tm),
        "batch_512_B32": lambda tm: detect_board_batch(
            cs.np.stack(small), cfg, sths, device=dev, timings=tm),
    }
    walls = {}
    for name, fn in runs.items():
        wall, each = wall_ms(lambda: fn(None), 5)
        stages = {}
        for _ in range(5):
            tm = {}
            fn(tm)
            for k, v in tm.items():
                stages.setdefault(k, []).append(v * 1e3)
        walls[name] = dict(wall_ms=wall, walls_ms=each, stage_ms={
            k: statistics.median(v) for k, v in stages.items()})
    print(json.dumps({
        "checkout": str(root), "device": torch.cuda.get_device_name(0),
        "call_ms": {k: statistics.median(v) for k, v in rounds.items()},
        "kernel_ms": kernel_ms,
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
