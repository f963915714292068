"""Stone snapping and colour classification (port of
img2sgf_tpu/grid/identify.py, img2sgf.py:448-543): the 361 windowed means
come from one integral-image gather."""

from __future__ import annotations

import torch

from ..core.board import BoardStates


def closest_indices(a, x, n):
    """For each value of a, the index of the nearest element of x[:n]
    (ascending, +inf padded), ties to the left (closest_index, :448-459)."""
    hi = torch.clamp(n - 1, min=0)
    i = torch.minimum(torch.searchsorted(x, a), hi)
    im1 = torch.clamp(i - 1, 0, x.shape[0] - 1)
    left_better = a - x[im1] <= x[i] - a
    out = torch.where(i == 0, torch.zeros_like(i),
                      torch.where(left_better, i - 1, i))
    return torch.minimum(torch.clamp(out, min=0), hi)


def integral_image(grey_u8):
    """2-D inclusive prefix sum with a zero row/col prepended, int32."""
    s = grey_u8.to(torch.int32).cumsum(0, dtype=torch.int32).cumsum(
        1, dtype=torch.int32)
    return torch.nn.functional.pad(s, (1, 0, 1, 0))


def window_means(integral, y0, y1, x0, x1):
    """Mean over half-open [y0:y1, x0:x1] windows (index tensors)."""
    a = integral[y1, x1] - integral[y0, x1] - integral[y1, x0] + integral[y0, x0]
    area = torch.clamp((y1 - y0) * (x1 - x0), min=1)
    return a.to(torch.float32) / area.to(torch.float32)


def intersection_intensities(grey_u8, hc, vc, hsize, vsize, hspace, vspace,
                             board_size: int, hw=None):
    """average_intensity for every board point (:468-481), [board_size,
    board_size] f32 indexed [i, j] = (column i of vc, row j of hc). hw=(h, w)
    (ints): content dims inside a fixed canvas, which bound the windows as
    the image's own size does at native size (:472-475)."""
    H, W = grey_u8.shape if hw is None else (int(hw[0]), int(hw[1]))
    dev = grey_u8.device
    integral = integral_image(grey_u8)
    ii = torch.arange(board_size, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    x = torch.where(ii < hsize, vc[ii.clamp(0, vc.shape[0] - 1)], zero)
    y = torch.where(ii < vsize, hc[ii.clamp(0, hc.shape[0] - 1)], zero)
    half_h = hspace / 2
    half_v = vspace / 2
    xmin = torch.round(x - half_h).to(torch.int64).clamp(0, W)
    xmax = torch.round(x + half_h).to(torch.int64).clamp(0, W)
    ymin = torch.round(y - half_v).to(torch.int64).clamp(0, H)
    ymax = torch.round(y + half_v).to(torch.int64).clamp(0, H)
    return window_means(
        integral,
        ymin[None, :], ymax[None, :],
        xmin[:, None], xmax[:, None],
    )


def identify_board(grey_u8, circles_xyr, circles_valid, grid,
                   black_stone_threshold, board_size: int, hw=None):
    """Snap circles to grid points and classify colours (:497-543); hw as
    in intersection_intensities."""
    dev = grey_u8.device
    hc = grid["hcentres_complete"]
    vc = grid["vcentres_complete"]
    hsize, vsize = grid["hsize"], grid["vsize"]

    ci = closest_indices(circles_xyr[:, 0].contiguous(), vc, hsize)
    cj = closest_indices(circles_xyr[:, 1].contiguous(), hc, vsize)
    stone = torch.zeros((board_size, board_size), dtype=torch.bool, device=dev)
    on = circles_valid & (ci < board_size) & (cj < board_size)
    stone[ci[on], cj[on]] = True

    inten = intersection_intensities(
        grey_u8, hc, vc, hsize, vsize, grid["hspace"], grid["vspace"],
        board_size, hw=hw)
    thr = torch.tensor(black_stone_threshold, dtype=torch.float32, device=dev)
    black = stone & (inten <= thr)
    white = stone & ~black
    num_black = black.sum(dtype=torch.int32)
    num_white = white.sum(dtype=torch.int32)
    detected = torch.where(
        black, int(BoardStates.BLACK),
        torch.where(white, int(BoardStates.WHITE), 0)).to(torch.int32)
    side = torch.where(num_black <= num_white, 1, 2).to(torch.int32)
    return {
        "detected_board": detected,
        "intensities": inten,
        "stone_mask": stone,
        "num_black": num_black,
        "num_white": num_white,
        "side_to_move": side,
    }
