#!/usr/bin/env python3
"""Wrapper-call times of the port's three CUDA kernels in one checkout, on
the card, for comparing two checkouts within one machine session:

    python3 tools/torch_kernel_ab.py CHECKOUT

imports img2sgf_tpu_torch and chip_smoke from CHECKOUT (a directory holding
both), records the K1, K2 and K3 wrapper calls of one detect_board run on
chip_smoke's 768^2 synthetic diagram (default config), and times each call
with CUDA events (mean of 20 calls after a warm-up, three rounds, median),
then the warm detect_board wall (median of 5). Prints one JSON line. Run it
on two checkouts in turns (parent, change, change, parent) in one command:
the card and its host then stay the same.
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
    from img2sgf_tpu_torch.hough import radius_cuda, rescore_cuda
    from img2sgf_tpu_torch.ops import hysteresis_cuda
    from img2sgf_tpu_torch.pipeline import detect_board

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
    detect_board(rgb, cfg, thr, device=dev)
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        detect_board(rgb, cfg, thr, device=dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(json.dumps({
        "checkout": str(root), "device": torch.cuda.get_device_name(0),
        "call_ms": {k: statistics.median(v) for k, v in rounds.items()},
        "detect_board_wall_ms": statistics.median(walls) * 1e3}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1]))
