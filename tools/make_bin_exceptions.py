#!/usr/bin/env python3
"""Generate and check img2sgf_tpu_torch/hough/_bin_exceptions.py, the table
that makes the port's direction_bins equal to the JAX package's float32
bins for every count the packages take (1 <= num_bins <= 254):

    JAX_PLATFORMS=cpu python3 tools/make_bin_exceptions.py [--check]

The JAX package bins a Sobel gradient (dx, dy) as
round(atan2(dy, dx) / (pi / n)) mod n in float32 on XLA:CPU. The port takes
the float64 angle, which depends on the device only far from a bin
boundary, and corrects the pairs where XLA:CPU's float32 result lands in
another bin:

  * the eight rays dx = 0, dy = 0 and |dx| = |dy| (each by sign), whose
    angle is 0, pi/4, pi/2 or 3pi/4 and so lies exactly on a bin boundary
    for some counts: float64 and float32 may round such a tie to opposite
    sides. Every pair of a ray has the same float32 angle, so the table
    holds one bin per ray and count (RAYS), for every count; the tool fails
    if a ray's pairs do not all share one bin.
  * the other pairs where the two disagree (PAIRS, per count), which lie
    near a boundary without being on it.

All 2041^2 pairs of the Sobel range [-1020, 1020]^2 are compared for each
count. Before writing the module the tool checks that every pair off the
rays lies at least MARGIN bin widths from a boundary in float64, so that
atan2's last-place differences between devices cannot move a bin. After
writing it, it imports the port's direction_bins afresh and requires it to
equal JAX's bins on every pair for every count. --check only runs that
last comparison against the committed module. This tool imports JAX and is
not part of the port; the module it writes holds only Python literals.
"""

from __future__ import annotations

import argparse
import importlib
import math
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
OUT = ROOT / "img2sgf_tpu_torch" / "hough" / "_bin_exceptions.py"
COUNTS = range(1, 255)
SOBEL = 1020  # |dx|, |dy| <= 4 * 255 for a 3x3 Sobel of uint8
# least float64 distance from a boundary, in bin widths: 60 times what a
# 2-ulp atan2 error (CUDA's float64 bound) can move q = angle / width <= 254
MARGIN = 1e-11

# the rays, in the order of the RAYS tuples: (name, mask of (dx, dy))
RAY_NAMES = ("dx=0,dy>0", "dx=0,dy<0", "dy=0,dx>0", "dy=0,dx<0",
             "dx=dy>0", "dx=dy<0", "dx=-dy>0", "dx=-dy<0")


def ray_masks(dx, dy):
    return ((dx == 0) & (dy > 0), (dx == 0) & (dy < 0),
            (dy == 0) & (dx > 0), (dy == 0) & (dx < 0),
            (dx == dy) & (dx > 0), (dx == dy) & (dx < 0),
            (dx == -dy) & (dx > 0), (dx == -dy) & (dx < 0))


def all_pairs():
    v = np.arange(-SOBEL, SOBEL + 1, dtype=np.int32)
    dx = np.repeat(v, v.size).reshape(v.size, v.size)
    dy = np.tile(v, v.size).reshape(v.size, v.size)
    return dx, dy


def jax_bins():
    """{n: [2041, 2041] int32 bins of the JAX package's direction_bins}."""
    import jax

    from img2sgf_tpu.hough import circles as jc

    dx, dy = all_pairs()
    for n in COUNTS:
        fn = jax.jit(lambda a, b, n=n: jc.direction_bins(a, b, n))
        yield n, np.asarray(fn(dx, dy))


def build():
    """(RAYS, PAIRS, least float64 margin off the rays, pair count)."""
    dx, dy = all_pairs()
    rays = ray_masks(dx, dy)
    on_ray = np.zeros(dx.shape, bool)
    for m in rays:
        on_ray |= m
    ang = np.arctan2(dy.astype(np.float64), dx.astype(np.float64))
    out_rays, out_pairs = {}, {}
    least, n_pairs = math.inf, 0
    for n, want in jax_bins():
        q = ang / (math.pi / n)
        least = min(least, float(np.abs(q - np.floor(q) - 0.5)[~on_ray].min()))
        f64 = np.mod(np.round(q).astype(np.int64), n)
        bins = []
        for name, m in zip(RAY_NAMES, rays):
            u = np.unique(want[m])
            if u.size != 1:
                raise SystemExit(f"num_bins={n}: ray {name} takes bins "
                                 f"{u.tolist()}, not one")
            bins.append(int(u[0]))
        out_rays[n] = tuple(bins)
        diff = (want != f64) & ~on_ray
        idx = np.flatnonzero(diff)
        if idx.size:
            out_pairs[n] = tuple(
                (int(dx.flat[i]), int(dy.flat[i]), int(want.flat[i]))
                for i in idx)
            n_pairs += idx.size
    return out_rays, out_pairs, least, n_pairs


def write(rays, pairs):
    lines = [
        '"""Where the JAX package\'s float32 direction bins (XLA:CPU) differ',
        "from the float64 angle's, for every num_bins in [1, 254]. Generated",
        "and checked on all 2041^2 Sobel gradient pairs by",
        "tools/make_bin_exceptions.py; do not edit.",
        "",
        "RAYS[n]: the bin of every pair on each of the rays dx = 0 (dy > 0,",
        "dy < 0), dy = 0 (dx > 0, dx < 0), dx = dy (dx > 0, dx < 0) and",
        "dx = -dy (dx > 0, dx < 0), in that order. PAIRS[n]: (dx, dy, bin) of",
        'the other pairs whose float32 bin is not the float64 one."""',
        "",
        "RAYS = {",
    ]
    lines += [f"    {n}: {rays[n]!r}," for n in sorted(rays)]
    lines += ["}", "", "PAIRS = {"]
    for n in sorted(pairs):
        lines.append(f"    {n}: (")
        row = "       "
        for t in pairs[n]:
            item = f" ({t[0]}, {t[1]}, {t[2]}),"
            if len(row) + len(item) > 79:
                lines.append(row)
                row = "       "
            row += item
        lines.append(row)
        lines.append("    ),")
    lines += ["}", ""]
    OUT.write_text("\n".join(lines))


def check() -> int:
    """The port's direction_bins (the module re-imported) against JAX's
    bins on every pair for every count. Returns the counts checked."""
    import torch

    sys.path.insert(0, str(ROOT))
    import img2sgf_tpu_torch.hough._bin_exceptions as bx
    import img2sgf_tpu_torch.hough.circles as tc

    importlib.reload(bx)
    importlib.reload(tc)
    dx, dy = all_pairs()
    tdx, tdy = torch.from_numpy(dx), torch.from_numpy(dy)
    bad = []
    for n, want in jax_bins():
        got = tc.direction_bins(tdx, tdy, n).numpy()
        if not np.array_equal(got, want):
            bad.append((n, int((got != want).sum())))
    if bad:
        raise SystemExit(f"direction_bins differs from JAX (count, pairs): {bad}")
    return len(COUNTS)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="only check the committed module against JAX")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    t0 = time.perf_counter()
    if not args.check:
        rays, pairs, least, n_pairs = build()
        if least < MARGIN:
            raise SystemExit(f"a pair off the rays lies {least:.3e} bin widths "
                             f"from a boundary in float64 (< {MARGIN})")
        write(rays, pairs)
        print(f"wrote {OUT.relative_to(ROOT)}: {len(rays)} counts, 8 rays each, "
              f"{n_pairs} pairs off the rays in {len(pairs)} counts; least "
              f"float64 distance of a pair off the rays from a boundary "
              f"{least:.3e} bin widths")
    n = check()
    print(f"direction_bins equals the JAX package's float32 bins on all "
          f"{(2 * SOBEL + 1) ** 2} pairs for each of {n} counts "
          f"({time.perf_counter() - t0:.0f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
