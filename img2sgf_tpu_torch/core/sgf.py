"""SGF writer, byte-identical to the reference's to_SGF (img2sgf.py:781-810)
and to img2sgf_tpu/core/sgf.py, quirks included: the side to move's stones
are listed first, and an absent colour drops its tag but keeps the newline."""

from __future__ import annotations

import string

import numpy as np

from .board import BLACK, BoardStates

# "[" + column letter + row letter + "]" of every point, indexed [i, j]
_POINTS = np.array([["[" + a + b + "]" for b in string.ascii_lowercase]
                    for a in string.ascii_lowercase])


def _moves(board, colour: int, tag: str, board_size: int) -> str:
    """The colour's tag and points in the reference's order (i, then j):
    np.nonzero lists them row-major. The tag stands whenever the colour is
    anywhere on the board, as the reference tests it."""
    if not (board == colour).any():
        return ""
    i, j = np.nonzero(board[:board_size, :board_size] == colour)
    return tag + "".join(_POINTS[i, j].tolist())


def to_sgf(board, side_to_move: int = BLACK, board_size: int = 19) -> str:
    """Render a [board_size, board_size] array of BoardStates (indexed
    [column, row]) to SGF text. Accepts numpy arrays and CPU or CUDA
    tensors."""
    if hasattr(board, "detach"):
        board = board.detach().cpu().numpy()
    board = np.asarray(board)
    black_moves = _moves(board, int(BoardStates.BLACK), "AB", board_size)
    white_moves = _moves(board, int(BoardStates.WHITE), "AW", board_size)
    out = "(;GM[1]FF[4]SZ[" + str(board_size) + "]\n"
    if side_to_move == BLACK:
        return out + "PL[B]\n" + black_moves + "\n" + white_moves + "\n)\n"
    return out + "PL[W]\n" + white_moves + "\n" + black_moves + "\n)\n"


def guess_side_to_move(board) -> int:
    """Black to play iff #black <= #white (img2sgf.py:529-534)."""
    if hasattr(board, "detach"):
        board = board.detach().cpu().numpy()
    board = np.asarray(board)
    nb = int((board == BoardStates.BLACK).sum())
    nw = int((board == BoardStates.WHITE).sum())
    return 1 if nb <= nw else 2
