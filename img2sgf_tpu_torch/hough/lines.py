"""Hough line transform restricted to near-horizontal/vertical windows
(port of img2sgf_tpu/hough/lines.py, cv.HoughLines as called at
img2sgf.py:230-255).

The vote bin of pixel (x, y) at angle t is static: cvRound(x*cos t +
y*sin t) + (numrho-1)//2 in float32 (OpenCV's trig tables). The tables are
built by the same numpy code as in the JAX package; here the accumulator is
an exact integer histogram of the edge pixels' bins (bincount) instead of
the JAX package's row-reduction and prefix-sum decomposition.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def window_angles(min_theta: float, max_theta: float, step: float = math.pi / 180.0):
    """cv2 5.x computeNumangle: floor((max-min)/step) + 1 angles from min."""
    numangle = int(math.floor((max_theta - min_theta) / step + 1e-9)) + 1
    return [min_theta + n * step for n in range(numangle)]


@functools.lru_cache(maxsize=64)
def _angle_tables(H: int, W: int, angle: float):
    """Static vote-index decomposition for one angle on an HxW image,
    verbatim from the JAX package: vote bin of pixel (t, u) = base[t] +
    kmat[t, u] in the (optionally transposed, flipped) layout."""
    numrho = int(round((W + H) * 2 + 1))
    tab_cos = np.float32(math.cos(angle))
    tab_sin = np.float32(math.sin(angle))
    xs = np.arange(W, dtype=np.float32)
    ys = np.arange(H, dtype=np.float32)
    # OpenCV: cvRound(j*tabCos[n] + i*tabSin[n]) in float32 arithmetic
    B = np.rint(xs[None, :] * tab_cos + ys[:, None] * tab_sin).astype(np.int64)
    B += (numrho - 1) // 2
    transpose = abs(tab_cos) > abs(tab_sin)
    Bt = B.T if transpose else B
    base = Bt.min(axis=1)
    flip = bool(base[-1] < base[0])
    if flip:
        Bt = Bt[::-1]
        base = base[::-1]
    kmat = (Bt - base[:, None]).astype(np.int32)
    K = int(kmat.max()) + 1
    rhos = np.arange(numrho)
    lo = np.searchsorted(base, rhos, side="left").astype(np.int32)
    hi = np.searchsorted(base, rhos, side="right").astype(np.int32)
    return transpose, flip, kmat, K, lo, hi, numrho


@functools.lru_cache(maxsize=64)
def _vote_bins(H: int, W: int, angle: float, device: str):
    """[H*W] vote bin of every pixel in image layout, on `device`:
    str(tensor.device), which names the card ("cuda:1"), so each card
    keeps its own entry."""
    transpose, flip, kmat, _K, lo, hi, numrho = _angle_tables(H, W, angle)
    base = np.repeat(np.arange(numrho), hi - lo)  # base[t] from its run
    assert base.shape[0] == kmat.shape[0], "row bases must ascend"
    Bt = base[:, None] + kmat
    if flip:
        Bt = Bt[::-1]
    B = Bt.T if transpose else Bt
    return torch.from_numpy(np.ascontiguousarray(B).reshape(-1)).to(device), numrho


def hough_window_accumulator(edges_u8, angles):
    """Full [A, numrho] f32 vote accumulator for a tuple of angles."""
    H, W = edges_u8.shape
    on = (edges_u8 > 0).reshape(-1)
    cols = []
    for a in angles:
        bins, numrho = _vote_bins(H, W, a, str(edges_u8.device))
        cols.append(torch.bincount(bins[on], minlength=numrho)[:numrho])
    return torch.stack(cols).to(torch.float32)


def local_maxima(acc, threshold: float):
    """OpenCV findLocalMaximums: vote > threshold, > left-rho, >= right-rho,
    > prev-angle, >= next-angle (zero-padded borders)."""
    z = torch.zeros_like(acc[:1])
    up = torch.cat([z, acc[:-1]], dim=0)
    down = torch.cat([acc[1:], z], dim=0)
    zc = torch.zeros_like(acc[:, :1])
    left = torch.cat([zc, acc[:, :-1]], dim=1)
    right = torch.cat([acc[:, 1:], zc], dim=1)
    thr = torch.tensor(threshold, dtype=torch.float32, device=acc.device)
    return (acc > thr) & (acc > left) & (acc >= right) & (acc > up) & (acc >= down)


def _compact(values, mask, cap: int):
    """Masked values into a fixed-capacity prefix, order-preserving."""
    flat_v = values.reshape(-1)
    flat_m = mask.reshape(-1)
    order = torch.sort((~flat_m).to(torch.uint8), stable=True).indices
    take = order[:cap]
    return flat_v[take], flat_m[take], flat_m.sum(dtype=torch.int32)


def hough_lines_intercepts(edges_u8, threshold: float, horizontal: bool,
                           angle_delta: float, max_lines: int):
    """Line intercepts for one direction (find_lines, img2sgf.py:230-255):
    (rho_values [max_lines] f32, valid [max_lines] bool, count i32). For the
    vertical direction the second window's rho is negated."""
    dev = edges_u8.device
    if horizontal:
        angles = window_angles(math.pi / 2 - angle_delta, math.pi / 2 + angle_delta)
        acc = hough_window_accumulator(edges_u8, angles)
        mask = local_maxima(acc, threshold)
        numrho = acc.shape[1]
        rho = (torch.arange(numrho, dtype=torch.float32, device=dev)
               - (numrho - 1) * 0.5)[None, :].expand(len(angles), -1)
        return _compact(rho, mask, max_lines)

    angles1 = window_angles(0.0, angle_delta)
    angles2 = window_angles(math.pi - angle_delta, math.pi)
    acc1 = hough_window_accumulator(edges_u8, angles1)
    acc2 = hough_window_accumulator(edges_u8, angles2)
    m1 = local_maxima(acc1, threshold)
    m2 = local_maxima(acc2, threshold)
    numrho = acc1.shape[1]
    rho_base = torch.arange(numrho, dtype=torch.float32, device=dev) - (numrho - 1) * 0.5
    rho1 = rho_base[None, :].expand(len(angles1), -1)
    rho2 = (-rho_base)[None, :].expand(len(angles2), -1)
    values = torch.cat([rho1.reshape(-1), rho2.reshape(-1)])
    mask = torch.cat([m1.reshape(-1), m2.reshape(-1)])
    return _compact(values, mask, max_lines)
