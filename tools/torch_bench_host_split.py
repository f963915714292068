#!/usr/bin/env python3
"""Split a bench cell's timed calls into the entry point, the host's SGF
writing and the rest, on one card:

    python3 tools/torch_bench_host_split.py [--cell batch512_b32] [--seed 0]
        [--timed 200]

runs the cell's timed call as bench_torch/run.py makes it (make_calls:
the graphed entry point from host numpy arrays, the host copies, to_sgf of
each ready board), after the cell's warm-up, with the entry point and
to_sgf wrapped in timers. Per call it keeps the wall, the time inside the
entry point (staging, the graph replays, the saturation-flag read, the
outputs' clones enqueued), the time inside to_sgf, and the rest (the wait
for the device and the host copies).
Before the loop it times the SGF writing of the last warm-up call's
boards alone, with no device work in flight (the median of 21 passes over
the batch): the same host work in every process, so that runs in separate
processes and on separate machines can be told apart by the host's speed
alone. Prints the cell's img_per_s as the bench computes it, the parts'
medians, 95th percentiles and sums, and one JSON line. The bench does not
import this tool.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
ENTRY_POINTS = ("detect_board_auto", "detect_board_bucket_batch",
                "detect_board_batch")


def calibration_ms(to_sgf, res) -> float:
    """Median wall of to_sgf over every ready board of a result, in ms."""
    ready = res.board_ready.cpu().numpy().reshape(-1)
    boards = res.full_board.cpu().reshape(-1, *res.full_board.shape[-2:])
    sides = res.side_to_move.cpu().numpy().reshape(-1)
    walls = []
    for _ in range(21):
        t0 = time.perf_counter()
        for i in range(len(ready)):
            if ready[i]:
                to_sgf(boards[i], side_to_move=int(sides[i]))
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls) * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", default="batch512_b32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timed", type=int, default=200)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_bench_host_split: needs an NVIDIA card", file=sys.stderr)
        return 1
    import img2sgf_tpu_torch
    from bench_torch import diagrams
    from bench_torch.run import load_cell, load_config, make_calls, nvidia_smi
    from img2sgf_tpu_torch import _build

    spent = {"entry": 0.0, "to_sgf": 0.0}
    to_sgf = img2sgf_tpu_torch.to_sgf

    def timer(part, fn):
        def timed(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            spent[part] += time.perf_counter() - t0
            return out
        return timed

    # make_calls imports these late, from the package
    img2sgf_tpu_torch.to_sgf = timer("to_sgf", to_sgf)
    for name in ENTRY_POINTS:
        setattr(img2sgf_tpu_torch, name,
                timer("entry", getattr(img2sgf_tpu_torch, name)))
    dev = torch.device("cuda", 0)
    _build.load()
    cell = load_cell(args.cell)
    inputs = diagrams.cell_inputs(cell, args.seed)
    calls = make_calls(cell, load_config(cell["config"]),
                       [rgb for rgb, _ in inputs], dev)
    for k in range(cell["warmup"]):
        res, _ = calls[k % len(calls)]()
    torch.cuda.synchronize()
    calib = calibration_ms(to_sgf, res)
    walls, entry, sgf = [], [], []
    for k in range(args.timed):
        spent.update(entry=0.0, to_sgf=0.0)
        t0 = time.perf_counter()
        calls[k % len(calls)]()
        walls.append(time.perf_counter() - t0)
        entry.append(spent["entry"])
        sgf.append(spent["to_sgf"])
    rest = [w - e - s for w, e, s in zip(walls, entry, sgf)]

    def ms(xs):
        xs_sorted = sorted(xs)
        p95 = xs_sorted[-(-95 * len(xs) // 100) - 1]
        return dict(median=statistics.median(xs) * 1e3, p95=p95 * 1e3,
                    sum=sum(xs) * 1e3)

    rec = dict(cell=args.cell, seed=args.seed, timed=args.timed,
               img_per_s=cell["batch"] * len(walls) / sum(walls),
               calibration_ms=calib, wall_ms=ms(walls), entry_ms=ms(entry),
               to_sgf_ms=ms(sgf), rest_ms=ms(rest),
               to_sgf_share=sum(sgf) / sum(walls), device=nvidia_smi())
    print(f"[{args.cell}] seed {args.seed}: img_per_s {rec['img_per_s']:.2f}; "
          f"median wall {rec['wall_ms']['median']:.2f} ms (p95 "
          f"{rec['wall_ms']['p95']:.2f}) = entry point "
          f"{rec['entry_ms']['median']:.2f} (p95 {rec['entry_ms']['p95']:.2f})"
          f" + to_sgf {rec['to_sgf_ms']['median']:.2f} (p95 "
          f"{rec['to_sgf_ms']['p95']:.2f}) + the rest "
          f"{rec['rest_ms']['median']:.2f} (p95 {rec['rest_ms']['p95']:.2f}) "
          f"ms; to_sgf's share of the timed walls {rec['to_sgf_share']:.3f}; "
          f"calibration {calib:.3f} ms (to_sgf of one call's boards alone)",
          flush=True)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
