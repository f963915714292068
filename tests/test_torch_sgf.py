"""The port's SGF writer against the JAX package's, byte for byte: random
boards of every cell value at the three board sizes, both sides to move,
several dtypes and array forms, and the reference's quirks one by one."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra.numpy import arrays

from img2sgf_tpu.core import sgf as jsgf
from img2sgf_tpu_torch.core import sgf as tsgf

EMPTY, BLACK, WHITE, STONE = 0, 1, 2, 3


def _forms(board: np.ndarray):
    """(what the reference gets, what the port gets) for each input form
    the port accepts: the array, a CPU tensor, and transposed views of
    both (non-contiguous)."""
    return {
        "numpy": (board, board),
        "tensor": (board, torch.from_numpy(board)),
        "numpy transposed": (board.T, board.T),
        "tensor transposed": (board.T, torch.from_numpy(board).T),
    }


@st.composite
def boards(draw):
    """A square board of 9, 13 or 19 whose cells take values from a random
    non-empty subset of 0-3, so that empty and one-colour boards come up
    as often as mixed ones."""
    n = draw(st.sampled_from([9, 13, 19]))
    values = draw(st.lists(st.integers(EMPTY, STONE), min_size=1, max_size=4,
                           unique=True))
    dtype = draw(st.sampled_from([np.int32, np.int64, np.uint8]))
    return draw(arrays(dtype, (n, n), elements=st.sampled_from(values)))


@settings(max_examples=300, deadline=None, database=None)
@given(board=boards(), side=st.sampled_from([BLACK, WHITE]))
def test_to_sgf_equals_jax_on_random_boards(board, side):
    n = board.shape[0]
    for form, (ref, ours) in _forms(board).items():
        assert tsgf.to_sgf(ours, side, n) == jsgf.to_sgf(ref, side, n), form


def _board(n=19, **cells):
    """An n x n int32 board, empty but for cells {"i_j": value}."""
    b = np.zeros((n, n), np.int32)
    for k, v in cells.items():
        i, j = map(int, k[1:].split("_"))
        b[i, j] = v
    return b


HEAD = "(;GM[1]FF[4]SZ[19]\n"
QUIRKS = {
    # the side to move's colour first; an absent colour keeps its newline
    "empty, black to move": (_board(), BLACK, HEAD + "PL[B]\n\n\n)\n"),
    "empty, white to move": (_board(), WHITE, HEAD + "PL[W]\n\n\n)\n"),
    "black only, white to move": (
        _board(p3_4=BLACK), WHITE, HEAD + "PL[W]\n\nAB[de]\n)\n"),
    "white only, black to move": (
        _board(p18_0=WHITE), BLACK, HEAD + "PL[B]\n\nAW[sa]\n)\n"),
    "both, white to move": (
        _board(p0_0=BLACK, p1_2=WHITE), WHITE,
        HEAD + "PL[W]\nAW[bc]\nAB[aa]\n)\n"),
    # STONE (3) and any other value is no move
    "stones of no colour": (
        _board(p0_0=STONE, p5_5=STONE, p7_1=9), BLACK,
        HEAD + "PL[B]\n\n\n)\n"),
    "a stone of no colour beside black": (
        _board(p0_0=STONE, p2_3=BLACK), BLACK, HEAD + "PL[B]\nAB[cd]\n\n)\n"),
    # points in row-major order of [column, row]: i first, then j
    "row-major order": (
        _board(p1_0=BLACK, p0_5=BLACK, p0_1=BLACK, p18_18=BLACK, p1_18=WHITE,
               p1_3=WHITE), BLACK,
        HEAD + "PL[B]\nAB[ab][af][ba][ss]\nAW[bd][bs]\n)\n"),
}


@pytest.mark.parametrize("case", list(QUIRKS))
def test_to_sgf_quirks(case):
    board, side, want = QUIRKS[case]
    assert jsgf.to_sgf(board, side) == want
    for form, (_, ours) in _forms(board).items():
        if "transposed" not in form:
            assert tsgf.to_sgf(ours, side) == want, form


def test_to_sgf_keeps_a_tag_for_a_colour_outside_the_board():
    """A colour that lies only outside the top-left board_size block keeps
    its tag with no point after it, as the reference tests the whole
    array for the colour."""
    board = _board(p15_15=BLACK, p2_1=WHITE)
    want = "(;GM[1]FF[4]SZ[9]\nPL[B]\nAB\nAW[cb]\n)\n"
    assert jsgf.to_sgf(board, BLACK, 9) == want
    assert tsgf.to_sgf(board, BLACK, 9) == want


@pytest.mark.parametrize("side", [BLACK, WHITE])
def test_to_sgf_full_board(side):
    """Every point of a 19 x 19 board holds a stone, in a checkerboard."""
    board = (np.indices((19, 19)).sum(0) % 2 + 1).astype(np.uint8)
    assert tsgf.to_sgf(board, side) == jsgf.to_sgf(board, side)
    assert tsgf.to_sgf(board, side).count("[") == 4 + 361
