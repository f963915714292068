#!/usr/bin/env python3
"""Device time of each stage of the port's detector, and of each step of its
plane-state stage, on one card:

    python3 tools/torch_stage_profile.py [CHECKOUT]

runs chip_smoke's 768^2 diagram (one image, native size) and its 16-image
768 bucket batch through the segments of img2sgf_tpu_torch/pipeline/detect.py
eagerly, step by step: pre (_pre_circles), the plane state split into its
steps (the internal Canny, border remap and Sobel, the edge mask and walk
steps, the direction labels, the accumulator), the base selection with the
overflow rerun, and post. Each step runs on its own recorded inputs under
torch.profiler after a warm-up (chip_smoke.device_busy): the device busy ms
summed over its kernels and copies, their count, and the kernels that take
most of it. Prints one line per step and one JSON line. CHECKOUT (default:
this script's repository) is a directory holding img2sgf_tpu_torch and
chip_smoke.py.
"""

from __future__ import annotations

import json
import pathlib
import sys


def _steps(dev, cfg, rgb, hw, ths):
    """[(name, fn)] of the detector's steps on rgb [B, H, W, 3] (hw: None or
    the [B] content dims), each fn taking the previous steps' outputs as
    they were recorded in one eager pass here."""
    import torch

    from img2sgf_tpu_torch.hough.circles import (
        direction_labels, pixel_steps, vote_accumulator_pool_labels)
    from img2sgf_tpu_torch.ops.canny import canny_pool
    from img2sgf_tpu_torch.ops.common import border_remap
    from img2sgf_tpu_torch.ops.sobel import sobel3
    from img2sgf_tpu_torch.pipeline import detect as d

    B, H, W = rgb.shape[:3]
    grey, edges, variants = d._pre_circles(rgb, cfg, hw)
    keep, expand = d._variant_dedup(cfg, variants.shape[1])
    Vu = len(keep)
    planes = d._take(variants, keep).reshape(B * Vu, H, W)
    hwp = None if hw is None else tuple(
        v[:, None].expand(B, Vu).reshape(-1) for v in hw)
    high, nb = cfg.circle_canny_high, cfg.num_angle_bins
    lo, hi = cfg.circle_min_radius, cfg.circle_max_radius

    def canny():
        return canny_pool(planes, max(high / 2, 1), high,
                          iters=cfg.hysteresis_iters, hw_planes=hwp)

    def remap_sobel():
        p = planes if hwp is None else border_remap(planes, hwp[0], hwp[1],
                                                    "replicate")
        return sobel3(p)

    e = canny()
    dx, dy = remap_sobel()

    def mask_steps():
        emask = (e > 0) & ((dx != 0) | (dy != 0))
        sx, sy = pixel_steps(dx, dy)
        zero = torch.zeros_like(sx)
        return emask, torch.where(emask, sx, zero), torch.where(emask, sy, zero)

    emask, sx, sy = mask_steps()
    labels = direction_labels(emask, dx, dy, nb)
    st = dict(emask=emask, sx=sx, sy=sy,
              acc=vote_accumulator_pool_labels(labels, nb, lo, hi))
    if hwp is not None:
        st["hs"], st["ws"] = hwp

    def select():
        pooled = d._select_base(st, cfg)
        d._run_chunks(pooled, cfg)
        return d._Selected(grey, edges, pooled, expand)

    sel = select()
    return [
        ("pre", lambda: d._pre_circles(rgb, cfg, hw)),
        ("state: internal canny", canny),
        ("state: border remap + sobel", remap_sobel),
        ("state: edge mask + walk steps", mask_steps),
        ("state: direction labels", lambda: direction_labels(emask, dx, dy, nb)),
        ("state: accumulator (kernel A)",
         lambda: vote_accumulator_pool_labels(labels, nb, lo, hi)),
        ("select (base + overflow rerun)", select),
        ("post", lambda: d._segment_post(sel, cfg, ths, hw)),
    ]


def main(tree: str) -> int:
    root = pathlib.Path(tree).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_stage_profile: needs an NVIDIA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from img2sgf_tpu_torch import DetectionConfig, _build, choose_line_threshold

    dev = torch.device("cuda", 0)
    _build.load()
    cfg = DetectionConfig()
    rgb, _ = cs.render_diagram()
    canvases, hs, ws, ths = cs.bucket([im for im, _ in cs.batch_images()])
    cells = {
        f"single {cs.SIZE}": (
            torch.from_numpy(rgb).to(dev)[None], None,
            torch.tensor([choose_line_threshold(*rgb.shape[:2])],
                         dtype=torch.float32, device=dev)),
        f"bucket batch B={len(hs)} {canvases.shape[1]}": (
            torch.from_numpy(canvases).to(dev),
            tuple(torch.tensor(v, dtype=torch.int64, device=dev)
                  for v in (hs, ws)),
            torch.tensor(np.asarray(ths, np.float32), device=dev)),
    }
    out = {}
    for cell, (x, hw, t) in cells.items():
        rec = {}
        for name, fn in _steps(dev, cfg, x, hw, t):
            wall, busy, n, top = cs.device_busy(fn, top=4)
            rec[name] = dict(device_busy_ms=busy, device_events=n, wall_ms=wall,
                             top=[dict(kernel=k[:90], ms=ms, count=c)
                                  for k, ms, c in top])
            print(f"[{cell}] {name}: device busy {busy:.3f} ms over {n} "
                  f"kernels and copies (wall {wall:.1f} ms); most: " + "; ".join(
                      f"{k[:60]} {ms:.2f} ms x{c}" for k, ms, c in top),
                  flush=True)
        rec["device_busy_ms_sum"] = sum(r["device_busy_ms"] for r in rec.values())
        out[cell] = rec
    print(json.dumps({"stage_profile": out, "device": cs.nvidia_smi()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1
                  else str(pathlib.Path(__file__).resolve().parent.parent)))
