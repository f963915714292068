"""PyTorch port against the JAX package end to end on configuration values
off the default path: detect_board against detect_board_jit at the small
pipeline configuration (TINY), every BoardResult field bit for bit, for
circle_min_radius = 0 (K2 and K3 at r = 0, the cascade from r = 0) and
direction bins at 48 and 63 (63: the dx = 0 rays tie); and
detect_board_auto with propose_block = 2, the one value that meets content
dims. (test_torch_pipeline.py covers propose_block = 2 and
circle_max_radius = 31 at native size.)"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from img2sgf_tpu.pipeline import detect as jdetect
from img2sgf_tpu.pipeline import detect_board_jit

from img2sgf_tpu_torch.config import from_jax_config
from img2sgf_tpu_torch.pipeline import detect_board, detect_board_auto

from test_torch_pipeline import TINY, _compare, cap_torch_threads, synth_board

cap_torch_threads()

STONES = ((2, 3, 0), (4, 4, 255), (6, 2, 0))


def _tcfg(jcfg):
    return from_jax_config(dataclasses.asdict(jcfg))


def _found(res, stones=STONES, n=9):
    assert bool(res.board_ready) and int(res.hsize) == int(res.vsize) == n
    b = res.detected_board.numpy()
    for i, j, colour in stones:
        assert b[i, j] == (1 if colour == 0 else 2)


@pytest.mark.parametrize("change", [
    dict(circle_min_radius=0, circle_max_radius=29),
    dict(num_angle_bins=48),
    dict(num_angle_bins=63),
], ids=["min_r0", "bins48", "bins63"])
def test_detect_board_config_every_field(change):
    jcfg = dataclasses.replace(TINY, **change)
    rgb = synth_board()
    jres = detect_board_jit(jnp.asarray(rgb), jcfg, 28.0)
    tres = detect_board(rgb, _tcfg(jcfg), 28.0, device="cpu")
    _compare(jres, tres)
    _found(tres)


def test_detect_board_auto_block_every_field():
    """propose_block = 2 inside a canvas (147 px into the 160 bucket): the
    tiles cover the canvas and the scan the content block."""
    jcfg = dataclasses.replace(TINY, propose_block=2)
    stones = ((1, 2, 0), (3, 3, 255))
    rgb = synth_board(size=147, n=7, stones=stones)
    jres = jdetect.detect_board_auto(rgb, jcfg, 24.0)
    tres = detect_board_auto(rgb, _tcfg(jcfg), 24.0, device="cpu")
    _compare(jres, tres)
    assert tres.grey.shape == (147, 147)
    _found(tres, stones, 7)
