"""Stone snapping and colour classification (port of
img2sgf_tpu/grid/identify.py, img2sgf.py:448-543): the 361 windowed means
come from one integral-image gather. Every function takes leading batch
dims; the stone mask is a scatter into a spare slot, so nothing is read
back to the host."""

from __future__ import annotations

import torch

from ..core.board import BoardStates


def _clip(t, hi):
    """t clipped to [0, hi]; hi a number, or a tensor of t's batch dims."""
    t = t.clamp(min=0)
    if isinstance(hi, torch.Tensor):
        return torch.minimum(t, hi[..., None])
    return t.clamp(max=hi)


def closest_indices(a, x, n):
    """For each value of a [..., C], the index of the nearest element of
    x[..., :n] (ascending, +inf padded), ties to the left (closest_index,
    :448-459)."""
    hi = torch.clamp(n - 1, min=0)[..., None]
    i = torch.minimum(torch.searchsorted(x, a.contiguous()), hi)
    im1 = torch.clamp(i - 1, 0, x.shape[-1] - 1)
    left_better = a - torch.gather(x, -1, im1) <= torch.gather(x, -1, i) - a
    out = torch.where(i == 0, 0, torch.where(left_better, i - 1, i))
    return torch.minimum(torch.clamp(out, min=0), hi)


def integral_image(grey_u8):
    """2-D inclusive prefix sum of [..., H, W] with a zero row/col
    prepended, int32."""
    s = grey_u8.to(torch.int32).cumsum(-2, dtype=torch.int32).cumsum(
        -1, dtype=torch.int32)
    return torch.nn.functional.pad(s, (1, 0, 1, 0))


def window_means(integral, y0, y1, x0, x1):
    """Mean over half-open [y0:y1, x0:x1] windows: integral [N, H+1, W+1],
    index tensors broadcasting to [N, ...]."""
    N, _, W1 = integral.shape
    flat = integral.reshape(N, -1)
    shape = torch.broadcast_shapes(y0.shape, y1.shape, x0.shape, x1.shape)

    def at(y, x):
        i = (y * W1 + x).expand(shape).reshape(N, -1)
        return torch.gather(flat, 1, i).reshape(shape)

    a = at(y1, x1) - at(y0, x1) - at(y1, x0) + at(y0, x0)
    area = torch.clamp((y1 - y0) * (x1 - x0), min=1)
    return a.to(torch.float32) / area.to(torch.float32)


def intersection_intensities(grey_u8, hc, vc, hsize, vsize, hspace, vspace,
                             board_size: int, hw=None):
    """average_intensity for every board point (:468-481), [..., board_size,
    board_size] f32 indexed [i, j] = (column i of vc, row j of hc). hw=(h,
    w), ints or int tensors of the batch dims: content dims inside a fixed
    canvas, which bound the windows as the image's own size does at native
    size (:472-475)."""
    H, W = grey_u8.shape[-2:]
    lead = grey_u8.shape[:-2]
    if hw is not None:
        H, W = hw
    dev = grey_u8.device
    integral = integral_image(grey_u8.reshape(-1, *grey_u8.shape[-2:]))
    ii = torch.arange(board_size, device=dev)
    x = torch.where(ii < hsize[..., None],
                    vc.index_select(-1, ii.clamp(0, vc.shape[-1] - 1)), 0.0)
    y = torch.where(ii < vsize[..., None],
                    hc.index_select(-1, ii.clamp(0, hc.shape[-1] - 1)), 0.0)
    half_h = (hspace / 2)[..., None]
    half_v = (vspace / 2)[..., None]
    xmin = _clip(torch.round(x - half_h).to(torch.int64), W)
    xmax = _clip(torch.round(x + half_h).to(torch.int64), W)
    ymin = _clip(torch.round(y - half_v).to(torch.int64), H)
    ymax = _clip(torch.round(y + half_v).to(torch.int64), H)
    flat = lambda t: t.reshape(-1, board_size)  # noqa: E731
    means = window_means(
        integral,
        flat(ymin)[:, None, :], flat(ymax)[:, None, :],
        flat(xmin)[:, :, None], flat(xmax)[:, :, None],
    )
    return means.reshape(*lead, board_size, board_size)


def identify_board(grey_u8, circles_xyr, circles_valid, grid,
                   black_stone_threshold, board_size: int, hw=None):
    """Snap circles to grid points and classify colours (:497-543) over
    leading batch dims; hw as in intersection_intensities."""
    hc = grid["hcentres_complete"]
    vc = grid["vcentres_complete"]
    hsize, vsize = grid["hsize"], grid["vsize"]
    lead = hsize.shape
    dev = grey_u8.device

    ci = closest_indices(circles_xyr[..., 0], vc, hsize)
    cj = closest_indices(circles_xyr[..., 1], hc, vsize)
    on = circles_valid & (ci < board_size) & (cj < board_size)
    # stones that are not on the board go to the spare slot, cut off below
    n2 = board_size * board_size
    flat = torch.where(on, ci * board_size + cj, n2).reshape(-1, on.shape[-1])
    stone = torch.zeros((flat.shape[0], n2 + 1), dtype=torch.bool, device=dev)
    stone.scatter_(1, flat, True)
    stone = stone[:, :n2].reshape(*lead, board_size, board_size)

    inten = intersection_intensities(
        grey_u8, hc, vc, hsize, vsize, grid["hspace"], grid["vspace"],
        board_size, hw=hw)
    black = stone & (inten <= black_stone_threshold)
    white = stone & ~black
    num_black = black.sum(dim=(-2, -1), dtype=torch.int32)
    num_white = white.sum(dim=(-2, -1), dtype=torch.int32)
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
