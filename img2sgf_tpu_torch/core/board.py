"""Board model: cell states, alignment and board placement (PyTorch port of
img2sgf_tpu/core/board.py)."""

from __future__ import annotations

import enum

import numpy as np
import torch


class BoardStates(enum.IntEnum):
    EMPTY = 0
    BLACK = 1
    WHITE = 2
    STONE = 3  # temporary flag: stone present, colour not yet determined


class Alignment(enum.IntEnum):
    TOP = 0
    BOTTOM = 1
    LEFT = 2
    RIGHT = 3


# Side-to-move encoding (img2sgf.py:89)
BLACK, WHITE = 1, 2


def align_board_np(part: np.ndarray, alignment, board_size: int = 19) -> np.ndarray:
    """Place an hsize x vsize part-board into a full board (host numpy).
    `part` is indexed [i, j] = (column, row); `alignment` is
    (LEFT|RIGHT, TOP|BOTTOM)."""
    hsize, vsize = part.shape
    board = np.zeros((board_size, board_size), dtype=part.dtype)
    xoff = board_size - hsize if alignment[0] == Alignment.RIGHT else 0
    yoff = board_size - vsize if alignment[1] == Alignment.BOTTOM else 0
    board[xoff : xoff + hsize, yoff : yoff + vsize] = part
    return board


def align_board(part, hsize, vsize, align_right: bool, align_bottom: bool,
                board_size: int = 19):
    """Counterpart of align_board_jnp: `part` is a [..., board_size,
    board_size] tensor whose top-left [hsize, vsize] block holds the
    part-board; hsize and vsize are tensors of the leading (batch) dims.
    Returns the full boards."""
    dev = part.device
    xoff = board_size - hsize if align_right else torch.zeros_like(hsize)
    yoff = board_size - vsize if align_bottom else torch.zeros_like(vsize)
    ii = torch.arange(board_size, device=dev)[:, None]
    jj = torch.arange(board_size, device=dev)[None, :]
    src_i = ii - xoff[..., None, None]
    src_j = jj - yoff[..., None, None]
    inside = ((src_i >= 0) & (src_i < hsize[..., None, None]) & (src_j >= 0)
              & (src_j < vsize[..., None, None]))
    src = src_i.clamp(0, board_size - 1) * board_size \
        + src_j.clamp(0, board_size - 1)
    lead = part.shape[:-2]
    flat = part.reshape(*lead, board_size * board_size)
    moved = torch.gather(flat, -1, src.reshape(*lead, -1)).reshape(part.shape)
    return torch.where(inside, moved, 0)
