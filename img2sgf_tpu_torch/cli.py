"""CLI: python -m img2sgf_tpu_torch [--fast] [--device cuda|cpu]
input_image [output.sgf]

Mirrors img2sgf_tpu's CLI (and the reference's argv semantics,
img2sgf.py:1256-1269): arg1 is the input image, arg2 the output SGF
(default: input stem + .sgf). The image is detected headless through the
shape-bucketed path (detect_board_auto), as the JAX CLI does. With --gui,
or with no input image, the Tk editor opens instead (on the input image,
if one is given).

Batch mode: python -m img2sgf_tpu_torch --batch 'scans/*.jpg' [-o out/]
[--batch-size N] groups images by canvas bucket and converts each group
through detect_board_bucket_batch, with the JAX CLI's messages and exit
codes. --device defaults to cuda and raises when there is no card.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def run_headless(input_path: str, output_path: str | None, verbose: bool = True,
                 fast: bool = False, device: str = "cuda") -> int:
    from .config import DetectionConfig, choose_line_threshold
    from .core import to_sgf
    from .hostio import load_rgb
    from .pipeline import detect_board_auto
    from .pipeline.detect import resolve_device

    dev = resolve_device(device)
    try:
        rgb = load_rgb(input_path)
    except (OSError, ValueError) as e:
        print(f"Error opening file {input_path}:\n{e}", file=sys.stderr)
        return 1
    cfg = DetectionConfig.fast() if fast else DetectionConfig()
    thr = choose_line_threshold(rgb.shape[0], rgb.shape[1])
    if verbose:
        print(f"Image size {rgb.shape[1]}x{rgb.shape[0]}, line threshold {thr}")
    res = detect_board_auto(rgb, cfg, thr, device=dev)
    ready = bool(res.board_ready)
    if verbose:
        n_circ = int(res.circles_valid.sum())
        print(f"Found {n_circ} circles; grid "
              f"{int(res.hsize)}x{int(res.vsize)} valid={bool(res.valid_grid)}")
    if not ready:
        print("Board not detected! Things to try: select a smaller region, "
              "rotate the image, increase contrast or threshold.")
        return 1
    side = int(res.side_to_move)
    print(f"Detected {int(res.num_black)} black and {int(res.num_white)} white "
          f"stones on a {int(res.hsize)}x{int(res.vsize)} board; "
          f"{'black' if side == 1 else 'white'} to play")
    sgf = to_sgf(res.full_board, side_to_move=side)
    if output_path is None:
        output_path = os.path.splitext(input_path)[0] + ".sgf"
    with open(output_path, "w") as f:
        f.write(sgf)
    print(f"Saved to file {output_path}")
    return 0


def run_batch(inputs, outdir: str | None, batch_size: int = 16,
              verbose: bool = True, fast: bool = False,
              device: str = "cuda") -> int:
    """Convert many images: group them by canvas bucket (bucket_dim of each
    side), pad each group's images top-left into [B, Hb, Wb, 3] canvases of
    at most batch_size, and run detect_board_bucket_batch on each. SGFs go
    to outdir (default: beside each input) as <stem>.sgf."""
    import glob as globmod
    import time

    from .config import DetectionConfig, choose_line_threshold
    from .core import to_sgf
    from .hostio import load_rgb
    from .pipeline import bucket_dim, detect_board_bucket_batch
    from .pipeline.detect import resolve_device

    dev = resolve_device(device)
    files: list[str] = []
    for pat in inputs:
        hits = sorted(globmod.glob(pat))
        files.extend(hits if hits else [pat])
    if not files:
        print("No input images.", file=sys.stderr)
        return 1
    if outdir:
        os.makedirs(outdir, exist_ok=True)

    cfg = DetectionConfig.fast() if fast else DetectionConfig()
    groups: dict[tuple[int, int], list[tuple[str, np.ndarray]]] = {}
    for path in files:
        try:
            rgb = load_rgb(path)
        except (OSError, ValueError) as e:
            print(f"Error opening file {path}:\n{e}", file=sys.stderr)
            continue
        key = (bucket_dim(rgb.shape[0]), bucket_dim(rgb.shape[1]))
        groups.setdefault(key, []).append((path, rgb))

    n_ok = n_fail = 0
    t0 = time.perf_counter()
    for (hb, wb), items in sorted(groups.items()):
        for start in range(0, len(items), batch_size):
            chunk = items[start:start + batch_size]
            B = len(chunk)
            canvases = np.zeros((B, hb, wb, 3), np.uint8)
            hs = np.zeros((B,), np.int32)
            ws = np.zeros((B,), np.int32)
            ths = np.zeros((B,), np.float32)
            for i, (_, rgb) in enumerate(chunk):
                h, w = rgb.shape[:2]
                canvases[i, :h, :w] = rgb
                hs[i], ws[i] = h, w
                ths[i] = choose_line_threshold(h, w)
            res = detect_board_bucket_batch(canvases, cfg, ths, hs, ws,
                                            device=dev)
            ready = res.board_ready.cpu().numpy()
            boards = res.full_board.cpu()
            sides = res.side_to_move.cpu().numpy()
            for i, (path, _) in enumerate(chunk):
                stem = os.path.splitext(os.path.basename(path))[0]
                out = (os.path.join(outdir, stem + ".sgf") if outdir
                       else os.path.splitext(path)[0] + ".sgf")
                if not ready[i]:
                    n_fail += 1
                    if verbose:
                        print(f"{path}: board not detected")
                    continue
                with open(out, "w") as f:
                    f.write(to_sgf(boards[i], side_to_move=int(sides[i])))
                n_ok += 1
                if verbose:
                    print(f"{path} -> {out}")
    dt = time.perf_counter() - t0
    print(f"{n_ok} converted, {n_fail} not detected, "
          f"{len(files)} files in {dt:.1f}s ({len(files) / dt:.1f} img/s)")
    return 0 if n_ok else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m img2sgf_tpu_torch",
        description="Convert an image of a Go diagram to SGF. With no input "
                    "image, or with --gui, open the editor.")
    parser.add_argument("paths", nargs="*",
                        help="input image and output SGF (default: input "
                             "stem + .sgf); with --batch, input glob patterns")
    parser.add_argument("--gui", action="store_true",
                        help="open the Tk editor (on the input image, if "
                             "given; the output SGF is the save default)")
    parser.add_argument("--batch", action="store_true",
                        help="convert every image the patterns match, "
                             "batched by canvas bucket")
    parser.add_argument("-o", dest="outdir", default=None,
                        help="--batch: directory for the SGFs (default: "
                             "beside each input)")
    parser.add_argument("--batch-size", type=int, default=16,
                        help="--batch: images per batch (default: 16)")
    parser.add_argument("--fast", action="store_true",
                        help="reduced blur pyramid (DetectionConfig.fast)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    args = parser.parse_args(argv)
    if args.batch:
        return run_batch(args.paths, args.outdir, batch_size=args.batch_size,
                         fast=args.fast, device=args.device)
    if len(args.paths) > 2:
        sys.exit("Too many command line arguments.")
    input_path = args.paths[0] if args.paths else None
    output = args.paths[1] if len(args.paths) > 1 else None
    if args.gui or input_path is None:
        from .gui.app import run_gui

        return run_gui(input_path, output, device=args.device)
    return run_headless(input_path, output, fast=args.fast,
                        device=args.device)


if __name__ == "__main__":
    raise SystemExit(main())
