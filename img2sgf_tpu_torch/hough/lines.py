"""Hough line transform restricted to near-horizontal/vertical windows
(port of img2sgf_tpu/hough/lines.py, cv.HoughLines as called at
img2sgf.py:230-255).

The vote bin of pixel (x, y) at angle t is static: cvRound(x*cos t +
y*sin t) + (numrho-1)//2 in float32 (OpenCV's trig tables). The tables are
built by the same numpy code as in the JAX package; here the accumulator is
an exact integer histogram of the edge pixels' bins (index_add_ of 0/1
weights, over every image of a batch at once) instead of the JAX package's
row-reduction and prefix-sum decomposition.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .._devconst import device_cache


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


@device_cache(maxsize=64)
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
    """Full [..., A, numrho] f32 vote accumulator of [..., H, W] edge maps
    (the leading dims are a batch) for a tuple of angles: per angle, one
    index_add_ of every pixel's 0/1 weight into its vote bin of every image
    (the images share the canvas, so the bins are one table). The counts
    are integers below 2^24, exact in any order."""
    H, W = edges_u8.shape[-2:]
    lead = edges_u8.shape[:-2]
    on = (edges_u8 > 0).reshape(-1, H * W).to(torch.float32)
    cols = []
    for a in angles:
        bins, numrho = _vote_bins(H, W, a, str(edges_u8.device))
        acc = torch.zeros((on.shape[0], numrho), dtype=torch.float32,
                          device=on.device)
        cols.append(acc.index_add_(1, bins, on))
    return torch.stack(cols, dim=1).reshape(*lead, len(angles), -1)


def local_maxima(acc, threshold):
    """OpenCV findLocalMaximums over [..., A, numrho]: vote > threshold,
    > left-rho, >= right-rho, > prev-angle, >= next-angle (zero-padded
    borders). threshold: a number, or a float32 tensor of the leading
    dims."""
    z = torch.zeros_like(acc[..., :1, :])
    up = torch.cat([z, acc[..., :-1, :]], dim=-2)
    down = torch.cat([acc[..., 1:, :], z], dim=-2)
    zc = torch.zeros_like(acc[..., :1])
    left = torch.cat([zc, acc[..., :-1]], dim=-1)
    right = torch.cat([acc[..., 1:], zc], dim=-1)
    if isinstance(threshold, torch.Tensor):
        threshold = threshold[..., None, None]
    return (acc > threshold) & (acc > left) & (acc >= right) & (acc > up) \
        & (acc >= down)


def _compact(values, mask, cap: int):
    """Masked values [..., L] into a fixed-capacity prefix [..., cap],
    order-preserving, with the mask count [...]."""
    order = torch.sort((~mask).to(torch.uint8), dim=-1, stable=True).indices
    take = order[..., :cap]
    return (torch.gather(values, -1, take), torch.gather(mask, -1, take),
            mask.sum(dim=-1, dtype=torch.int32))


def hough_lines_intercepts(edges_u8, threshold, horizontal: bool,
                           angle_delta: float, max_lines: int):
    """Line intercepts for one direction (find_lines, img2sgf.py:230-255) of
    [..., H, W] edge maps (the leading dims are a batch; threshold a number
    or a float32 tensor of them): (rho_values [..., max_lines] f32, valid
    [..., max_lines] bool, count [...] i32). For the vertical direction the
    second window's rho is negated."""
    dev = edges_u8.device
    lead = edges_u8.shape[:-2]
    if horizontal:
        windows = ((window_angles(math.pi / 2 - angle_delta,
                                  math.pi / 2 + angle_delta), False),)
    else:
        windows = ((window_angles(0.0, angle_delta), False),
                   (window_angles(math.pi - angle_delta, math.pi), True))
    values, masks = [], []
    for angles, negate in windows:
        acc = hough_window_accumulator(edges_u8, angles)
        masks.append(local_maxima(acc, threshold).reshape(*lead, -1))
        numrho = acc.shape[-1]
        rho = torch.arange(numrho, dtype=torch.float32, device=dev) \
            - (numrho - 1) * 0.5
        rho = -rho if negate else rho
        values.append(rho.repeat(len(angles)).expand(*lead, -1))
    return _compact(torch.cat(values, dim=-1), torch.cat(masks, dim=-1),
                    max_lines)
