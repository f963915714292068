"""Grid completion, truncation and validation over fixed-capacity sorted
coordinate tensors (+inf padded) and counts (port of
img2sgf_tpu/grid/complete.py, img2sgf.py:335-445). Reference quirks kept:
round half to even, "no big gaps" returns x unchanged, hspace divides by
the line count."""

from __future__ import annotations

import torch

# rejection reason codes (mirror the reference's log messages)
OK = 0
NO_LINES = 1  # "No grid lines found at all!" (:340)
ONE_LINE = 2  # "Only found one grid line" (:344)
TOO_CLOSE = 3  # "Grid lines are too close together" (:351)
TOO_BIG = 4  # "Extra lines on diagram, or a grid line detected twice?" (:371)


def _gather(x, i):
    """x[..., i] for an index tensor i of x's leading dims."""
    return torch.gather(x, -1, i)


def complete_grid(x, n, board_size: int, min_grid_spacing: float,
                  big_space_ratio: float):
    """x: [..., M] ascending coords padded with +inf; n: [...] valid counts
    (i32); the leading dims are a batch. Returns (y [..., M], ny, ok,
    reason, diag [..., 4] = [min_space, has_big, steps, grid_n])."""
    dev = x.device
    M = x.shape[-1]
    inf = float("inf")
    idx = torch.arange(M, device=dev)
    space_valid = idx < torch.clamp(n - 1, min=0)[..., None]
    nxt = torch.cat([x[..., 1:], torch.full_like(x[..., :1], inf)], dim=-1)
    spaces = torch.where(space_valid, nxt - x, inf)

    min_space = spaces.amin(dim=-1)
    bound = (min_space * big_space_ratio)[..., None]
    bigmask = space_valid & (spaces > bound)
    smallmask = space_valid & (spaces <= bound)
    has_big = bigmask.any(dim=-1)
    max_space = torch.where(smallmask, spaces, -inf).amax(dim=-1)
    average = ((min_space + max_space) * 0.5)[..., None]

    m = torch.where(
        bigmask, torch.round(spaces / average),
        torch.where(smallmask, 1.0, 0.0),
    ).to(torch.int32)
    steps = m.sum(dim=-1, dtype=torch.int32)
    ny_fill = steps + 1

    cumM = torch.cumsum(m, dim=-1, dtype=torch.int32)
    t = torch.arange(M, dtype=torch.int32, device=dev).expand_as(cumM)
    i_of_t = torch.searchsorted(cumM, t.contiguous()).clamp(0, M - 1)
    cum_excl = cumM - m
    k_of_t = t - 1 - _gather(cum_excl, i_of_t)
    s_t = _gather(spaces, i_of_t)
    m_t = torch.clamp(_gather(m, i_of_t), min=1).to(x.dtype)
    y_fill = _gather(x, i_of_t) + (k_of_t + 1).to(x.dtype) * s_t / m_t
    y_fill = torch.where(t == 0, x[..., :1], y_fill)
    y_fill = torch.where(t < ny_fill[..., None], y_fill, inf)

    use_fill = has_big & (n < ny_fill)
    y = torch.where(use_fill[..., None], y_fill, x)
    ny = torch.where(use_fill, ny_fill, n)

    fail_reason = torch.where(
        n == 0, NO_LINES,
        torch.where(
            n == 1, ONE_LINE,
            torch.where(
                min_space < min_grid_spacing, TOO_CLOSE,
                torch.where(has_big & (steps > board_size + 2), TOO_BIG, OK),
            ),
        ),
    ).to(torch.int32)
    ok = fail_reason == OK
    y = torch.where(ok[..., None], y, inf)
    ny = torch.where(ok, ny, 0)
    diag = torch.stack([
        min_space,
        has_big.to(torch.float32),
        steps.to(torch.float32),
        ny_fill.to(torch.float32),
    ], dim=-1).to(torch.float32)
    return y, ny, ok, fail_reason, diag


def truncate_grid(x, n, board_size: int):
    """Drop 2 outer lines at board_size+2, or the last at board_size+1
    (img2sgf.py:400-417); x [..., M], n [...]."""
    M = x.shape[-1]
    start = torch.where(n == board_size + 2, 1, 0)
    newn = torch.where(
        n == board_size + 2, n - 2, torch.where(n == board_size + 1, n - 1, n)
    )
    idx = torch.arange(M, device=x.device)
    y = _gather(x, (idx + start[..., None]).clamp(0, M - 1))
    y = torch.where(idx < newn[..., None], y, float("inf"))
    return y, newn


def validate_axis(centres, count, board_size: int, min_grid_spacing: float,
                  big_space_ratio: float):
    """truncate -> complete -> truncate for one axis (img2sgf.py:422-430).
    Returns (x, n, ok, reason, diag [..., 6]): complete_grid's diag
    followed by the line counts after the first truncation and after
    completion."""
    x, n1 = truncate_grid(centres, count, board_size)
    x, n2, ok, reason, cdiag = complete_grid(
        x, n1, board_size, min_grid_spacing, big_space_ratio
    )
    x, n = truncate_grid(x, n2, board_size)
    diag = torch.cat([
        cdiag, torch.stack([n1.to(torch.float32), n2.to(torch.float32)], -1)],
        dim=-1)
    return x, n, ok, reason, diag


def validate_grid(hcentres, hcount, vcentres, vcount, board_size: int,
                  min_grid_spacing: float, big_space_ratio: float):
    """Both axes + grid geometry (img2sgf.py:420-445), over any leading
    batch dims. Note the reference's naming: vsize = number of horizontal
    lines, hsize = vertical lines."""
    hc, hcn, hok, hreason, hdiag = validate_axis(
        hcentres, hcount, board_size, min_grid_spacing, big_space_ratio
    )
    vc, vcn, vok, vreason, vdiag = validate_axis(
        vcentres, vcount, board_size, min_grid_spacing, big_space_ratio
    )
    valid = hok & vok
    vsize = torch.where(valid, hcn, 0)
    hsize = torch.where(valid, vcn, 0)
    last_h = _gather(hc, (hcn - 1).clamp(0, hc.shape[-1] - 1)[..., None])[..., 0]
    last_v = _gather(vc, (vcn - 1).clamp(0, vc.shape[-1] - 1)[..., None])[..., 0]
    hspace = torch.where(valid, (last_h - hc[..., 0]) / vsize.clamp(min=1), 0.0)
    vspace = torch.where(valid, (last_v - vc[..., 0]) / hsize.clamp(min=1), 0.0)
    return {
        "valid": valid,
        "hreason": hreason,
        "vreason": vreason,
        "hdiag": hdiag,
        "vdiag": vdiag,
        "hcentres_complete": hc,
        "vcentres_complete": vc,
        "vsize": vsize,
        "hsize": hsize,
        "hspace": hspace,
        "vspace": vspace,
    }
