"""PyTorch port against the JAX package end to end: detect_board on a seeded
synthetic diagram, every BoardResult field bit for bit, and the port's
headless CLI."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from img2sgf_tpu.config import DetectionConfig as JaxConfig
from img2sgf_tpu.pipeline import detect_board_jit

from img2sgf_tpu_torch import cli
from img2sgf_tpu_torch.config import DetectionConfig, from_jax_config
from img2sgf_tpu_torch.core import to_sgf
from img2sgf_tpu_torch.pipeline import BoardResult, detect_board

# torch intra-op threads of a test process that runs the detector
TEST_THREADS = 2


def cap_torch_threads():
    """Cap torch's intra-op threads in this process at TEST_THREADS (worker
    threads, such as the sharded detector's, take the cap up at their first
    op). Each port test module that runs the detector calls this when it is
    imported: a team of every core in each of the six processes of the
    tier-1 command makes the teams' spinning threads starve each other (on
    an 8-core machine that command took 769 s with such teams, 188-224 s
    with two threads a process)."""
    torch.set_num_threads(min(TEST_THREADS, torch.get_num_threads()))


cap_torch_threads()

# the JAX package's pipeline smoke-test configuration (tests/test_pipeline_
# smoke.py), copied: small budgets, one compiled budget branch on the CPU
TINY = JaxConfig(
    max_center_candidates=256,
    overflow_center_candidates=0,
    max_circles_per_variant=32,
    max_lines=256,
    hysteresis_iters=8,
)
# the same with the saturation-gated overflow rerun enabled at small budgets
OVERFLOW = JaxConfig(
    max_center_candidates=24, overflow_center_candidates=192,
    max_ring_candidates=24, overflow_ring_candidates=96,
    max_peak_candidates=64, overflow_peak_candidates=256,
    max_circles_per_variant=32, max_lines=256, hysteresis_iters=8,
    overflow_margin_factor=0.0,
)


def synth_board(size=160, n=9, stones=((2, 3, 0), (4, 4, 255), (6, 2, 0))):
    """Anti-aliased synthetic diagram (the recipe of tests/test_pipeline_
    smoke.py)."""
    img = np.full((size, size), 250, np.float32)
    lo, hi = 14, size - 14
    coords = np.linspace(lo, hi, n)
    for c in coords:
        ci = int(round(c))
        img[ci, int(lo):int(hi) + 1] = 10
        img[int(lo):int(hi) + 1, ci] = 10
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    r = (coords[1] - coords[0]) * 0.42
    for i, j, colour in stones:
        cx, cy = coords[i], coords[j]
        d = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
        inside = np.clip(r + 0.5 - d, 0, 1)
        img = img * (1 - inside) + colour * inside
        ring = np.clip(0.8 - np.abs(d - r), 0, 1)
        img = img * (1 - ring) + 10 * ring
    return np.repeat(img.astype(np.uint8)[:, :, None], 3, axis=2)


def _noisy_board(seed=3):
    rgb = synth_board(size=128, n=7).astype(np.int16)
    rng = np.random.default_rng(seed)
    rgb += rng.integers(-60, 61, rgb.shape[:2])[..., None]
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _compare(jres, tres):
    names = [f.name for f in dataclasses.fields(jres)]
    assert names == [f.name for f in dataclasses.fields(tres)]
    for name in names:
        want = np.asarray(getattr(jres, name))
        got = getattr(tres, name)
        assert isinstance(got, torch.Tensor), name
        got = got.numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.fixture(scope="module")
def tiny_results():
    rgb = synth_board()
    jres = detect_board_jit(jnp.asarray(rgb), TINY, 28.0)
    tres = detect_board(rgb, from_jax_config(dataclasses.asdict(TINY)), 28.0,
                        device="cpu")
    return jres, tres


def test_detect_board_every_field(tiny_results):
    jres, tres = tiny_results
    _compare(jres, tres)


def test_detect_board_found_the_stones(tiny_results):
    _, tres = tiny_results
    assert bool(tres.board_ready) and int(tres.hsize) == int(tres.vsize) == 9
    b = tres.detected_board.numpy()
    assert b[2, 3] == 1 and b[4, 4] == 2 and b[6, 2] == 1


def test_detect_board_overflow_rerun_every_field():
    """A noisy diagram whose planes saturate the base budgets, so the
    overflow rerun runs (JAX: lax.map/lax.cond; port: a Python branch)."""
    rgb = _noisy_board()
    cfg = from_jax_config(dataclasses.asdict(OVERFLOW))
    from img2sgf_tpu_torch.pipeline.detect import (
        _circles_from_state, _plane_state_pool, _pre_circles, _variant_dedup)
    v = _pre_circles(torch.from_numpy(rgb)[None], cfg)[2][0]
    keep, _ = _variant_dedup(cfg, v.shape[0])
    _, _, sat = _circles_from_state(_plane_state_pool(v[keep], cfg), cfg,
                                    margin_filter=True)
    assert bool(sat.any()) and not bool(sat.all())
    jres = detect_board_jit(jnp.asarray(rgb), OVERFLOW, 26.0)
    tres = detect_board(rgb, cfg, 26.0, device="cpu")
    _compare(jres, tres)


def test_stage_timings_and_result_type(tiny_results):
    timings = {}
    res = detect_board(synth_board(), from_jax_config(dataclasses.asdict(TINY)),
                       28.0, device="cpu", timings=timings)
    assert isinstance(res, BoardResult)
    assert list(timings) == ["pre", "state", "select", "post"]
    _compare(tiny_results[0], res)


def test_detect_board_large_radius_every_field():
    """circle_max_radius 55 (past the Pallas rescore's geometry, where the
    JAX package takes its XLA rescore) runs on the port and equals the JAX
    package in every field, with the board and its stones found."""
    jcfg = dataclasses.replace(TINY, circle_max_radius=55)
    rgb = synth_board(size=192, n=5, stones=((1, 2, 0), (3, 3, 255), (2, 1, 0)))
    jres = detect_board_jit(jnp.asarray(rgb), jcfg, 28.0)
    tres = detect_board(rgb, from_jax_config(dataclasses.asdict(jcfg)), 28.0,
                        device="cpu")
    _compare(jres, tres)
    assert bool(tres.board_ready) and int(tres.hsize) == 5
    b = tres.detected_board.numpy()
    assert b[1, 2] == 1 and b[3, 3] == 2 and b[2, 1] == 1


@pytest.mark.parametrize("change", [dict(propose_block=2),
                                    dict(circle_max_radius=31)])
def test_unported_config_values_raise(change):
    """The values the port once refused (block proposals; a radius span of
    31, which takes the per-offset accumulator) now run, raise nothing, and
    equal the JAX package in every field, with the stones found."""
    jcfg = dataclasses.replace(TINY, **change)
    rgb = synth_board()
    jres = detect_board_jit(jnp.asarray(rgb), jcfg, 28.0)
    tres = detect_board(rgb, from_jax_config(dataclasses.asdict(jcfg)), 28.0,
                        device="cpu")
    _compare(jres, tres)
    assert bool(tres.board_ready) and int(tres.hsize) == 9
    b = tres.detected_board.numpy()
    assert b[2, 3] == 1 and b[4, 4] == 2 and b[6, 2] == 1


def _png(tmp_path, rgb):
    from PIL import Image

    path = tmp_path / "diagram.png"
    Image.fromarray(rgb).save(path)
    return path


def test_cli_cpu_writes_the_sgf(tmp_path, capsys):
    rgb = synth_board(size=192)
    png = _png(tmp_path, rgb)
    out = tmp_path / "out.sgf"
    rc = cli.main(["--device", "cpu", str(png), str(out)])
    res = detect_board(rgb, DetectionConfig(), 31, device="cpu")
    assert rc == (0 if bool(res.board_ready) else 1)
    assert rc == 0, capsys.readouterr().out
    assert out.read_text() == to_sgf(res.full_board,
                                     side_to_move=int(res.side_to_move))


def test_cli_module_entry(tmp_path):
    png = _png(tmp_path, synth_board(size=192))
    proc = subprocess.run(
        [sys.executable, "-m", "img2sgf_tpu_torch", "--device", "cpu",
         str(png)], capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert (tmp_path / "diagram.sgf").read_text().startswith("(;GM[1]FF[4]SZ[19]")


def test_cli_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this pins the no-card error")
    png = _png(tmp_path, synth_board())
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--device", "cuda", str(png), str(tmp_path / "x.sgf")])
    with pytest.raises(RuntimeError, match="cuda"):
        detect_board(synth_board(), DetectionConfig(), device="cuda")
    assert not (tmp_path / "x.sgf").exists()
