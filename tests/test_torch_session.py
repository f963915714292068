"""The port's editing session (img2sgf_tpu_torch.gui.session.DetectSession)
against the JAX package's, and the logic cases of tests/test_session.py on
the port's session.

The action script runs the same edits on both sessions over one seeded
synthetic diagram: load, detect, align, cycle stones, a black-threshold
change with reclassification, a zoom onto a corner (which re-detects
through another canvas bucket), a rotation and a zoom out. After every step
the log, boards, side to move, stone brightnesses and SGF text must be
exactly equal. Every crop stays in the 128 and 160 canvas buckets at the
default contrast and brightness, so the JAX side compiles few programs.
"""

import dataclasses

import numpy as np
import pytest
import torch

from img2sgf_tpu.gui.session import DetectSession as JaxSession

from img2sgf_tpu_torch.config import from_jax_config
from img2sgf_tpu_torch.core import Alignment, BoardStates
from img2sgf_tpu_torch.gui.session import DetectSession
from test_session import _fake_result, _reference_select_region_oracle
from test_torch_pipeline import TINY, cap_torch_threads, synth_board

cap_torch_threads()

# 147 px (the 160 bucket), 7 lines, a black and a white stone in the corner
# the script zooms onto and one stone outside it
SCRIPT_IMAGE = dict(size=147, n=7, stones=((1, 2, 0), (2, 1, 255), (5, 4, 0)))


def _snapshot(s):
    """What the script compares after each step."""
    return dict(
        full_board=None if s.full_board is None else np.array(s.full_board),
        detected_board=(None if s.detected_board is None
                        else np.array(s.detected_board)),
        side_to_move=int(s.side_to_move),
        brightnesses=np.array(s.stone_brightnesses()),
        sgf=None if s.full_board is None else s.sgf_text(),
        selection=np.array(s.selection, float),
        line_threshold=int(s.line_threshold),
    )


def _run_script(session, log):
    """The action script; returns [(step, log so far, snapshot)]."""
    rgb = synth_board(**SCRIPT_IMAGE)
    steps = []

    def step(name):
        steps.append((name, list(log), _snapshot(session)))

    session.load_image(rgb)
    session.process()
    step("process")
    assert session.set_alignment(Alignment.RIGHT, Alignment.BOTTOM)
    step("set_alignment")
    session.cycle_stone(18, 18, right_click=False)
    session.cycle_stone(17, 18, right_click=True)
    step("cycle_stone")
    session.black_stone_threshold = 225  # the white stone (~219) turns black
    session.reclassify()
    step("reclassify")
    assert session.select_region([0, 0, 100, 100], (147, 147))
    step("select_region")
    session.rotate_deg = 2
    session.process()
    step("rotate")
    session.zoom_out()
    step("zoom_out")
    return steps


@pytest.fixture(scope="module")
def scripts():
    jlog, tlog = [], []
    jsteps = _run_script(JaxSession(TINY, log=jlog.append), jlog)
    tses = DetectSession(from_jax_config(dataclasses.asdict(TINY)),
                         log=tlog.append, device="cpu")
    tsteps = _run_script(tses, tlog)
    return jsteps, tsteps, tses


STEPS = ["process", "set_alignment", "cycle_stone", "reclassify",
         "select_region", "rotate", "zoom_out"]


@pytest.mark.parametrize("i", range(len(STEPS)), ids=STEPS)
def test_action_script_equals_jax(scripts, i):
    jsteps, tsteps, _ = scripts
    (jname, jlog, jsnap), (tname, tlog, tsnap) = jsteps[i], tsteps[i]
    assert jname == tname == STEPS[i]
    assert tlog == jlog
    for key, want in jsnap.items():
        got = tsnap[key]
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, key
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            assert got == want, key


def test_action_script_detects_and_zooms(scripts):
    """The script exercises what it claims: a board at full size and after
    the zoom, two canvas buckets, a reclassification that changed the
    board, and a zoom out that resets the parameters."""
    _, tsteps, session = scripts
    snaps = dict((name, snap) for name, _, snap in tsteps)
    assert snaps["process"]["full_board"] is not None
    assert snaps["select_region"]["full_board"] is not None
    assert not np.array_equal(snaps["reclassify"]["detected_board"],
                              snaps["cycle_stone"]["detected_board"])
    assert tuple(snaps["select_region"]["selection"]) == (0, 0, 100, 100)
    zoomed_log = tsteps[STEPS.index("select_region")][1]
    assert "\nZoomed in.  Region size 100x100" in zoomed_log
    assert "Rotated by 2 degrees" in tsteps[STEPS.index("rotate")][1]
    assert session.black_stone_threshold == session.cfg.black_stone_threshold
    assert session.board_alignment == [Alignment.LEFT, Alignment.TOP]


def test_session_result_is_host_numpy(scripts):
    """process() brings the result to the host once: every field numpy."""
    session = scripts[2]
    for f in dataclasses.fields(session.result):
        assert isinstance(getattr(session.result, f.name), np.ndarray), f.name


def test_reclassify_runs_no_detection(scripts, monkeypatch):
    """reclassify re-thresholds the cached result on the host: it calls no
    pipeline entry point and no kernel wrapper."""
    from img2sgf_tpu_torch import pipeline
    from img2sgf_tpu_torch.hough import radius_cuda, rescore_cuda
    from img2sgf_tpu_torch.ops import hysteresis_cuda

    session = scripts[2]

    def boom(*a, **k):
        raise AssertionError("reclassify ran detection")

    monkeypatch.setattr(pipeline, "detect_board_auto", boom)
    before = [m.plain_calls + m.launches
              for m in (hysteresis_cuda, rescore_cuda, radius_cuda)]
    session.black_stone_threshold = 100
    session.reclassify()
    assert [m.plain_calls + m.launches
            for m in (hysteresis_cuda, rescore_cuda, radius_cuda)] == before


def test_session_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this pins the no-card error")
    with pytest.raises(RuntimeError, match="cuda"):
        DetectSession()


# --- the logic cases of tests/test_session.py, on the port's session


def _session_with_board(hsize=19, vsize=19, **kw):
    s = DetectSession(log=lambda *_: None, device="cpu")
    s.input_rgb = np.zeros((100, 100, 3), np.uint8)
    s.result = _fake_result(hsize, vsize, **kw)
    s.detected_board = np.zeros((19, 19), np.int32)
    s.apply_alignment()
    return s


def test_reclassify_uses_cached_intensities_only():
    inten = np.full((19, 19), 200.0)
    stones = np.zeros((19, 19), bool)
    stones[3, 3] = stones[4, 4] = True
    inten[3, 3] = 50.0  # dark -> black
    s = _session_with_board(inten=inten, stones=stones)
    s.reclassify()
    assert s.detected_board[3, 3] == BoardStates.BLACK
    assert s.detected_board[4, 4] == BoardStates.WHITE
    s.black_stone_threshold = 40
    s.reclassify()
    assert s.detected_board[3, 3] == BoardStates.WHITE
    assert s.side_to_move == 1


def test_cycle_stone_left_and_right():
    s = _session_with_board()
    s.cycle_stone(0, 0, right_click=False)
    assert s.full_board[0, 0] == BoardStates.WHITE
    s.cycle_stone(0, 0, right_click=False)
    assert s.full_board[0, 0] == BoardStates.BLACK
    s.cycle_stone(0, 0, right_click=False)
    assert s.full_board[0, 0] == BoardStates.EMPTY
    s.cycle_stone(1, 1, right_click=True)
    assert s.full_board[1, 1] == BoardStates.BLACK
    assert s.board_edited


def test_alignment_moves_part_board():
    s = _session_with_board(hsize=5, vsize=7)
    s.detected_board[:5, :7] = BoardStates.BLACK
    s.apply_alignment()
    assert s.full_board[:5, :7].all()
    assert s.set_alignment(Alignment.RIGHT, Alignment.BOTTOM)
    assert s.full_board[14:, 12:].all()
    assert not s.full_board[:14, :].any()


def _blank_session(h=400, w=400):
    s = DetectSession(log=lambda *_: None, device="cpu")
    rgb = np.zeros((h, w, 3), np.uint8)
    s.load_image(rgb)
    s.region_rgb = rgb
    return s


def test_zoom_geometry_no_rotation():
    s = _blank_session()
    s.process = lambda: None  # geometry only
    assert s.select_region([100, 100, 200, 200], (400, 400))
    np.testing.assert_allclose(s.selection, [100, 100, 200, 200])
    # the stale pre-zoom region's threshold (400x400 -> 47)
    assert s.line_threshold == 47


def test_zoom_threshold_uses_stale_region_quirk():
    s = _blank_session()

    def fake_process():
        x1, y1, x2, y2 = (int(v) for v in s.selection)
        s.region_rgb = s.input_rgb[y1:y2, x1:x2]

    s.process = fake_process
    assert s.select_region([0, 0, 200, 200], (400, 400))
    assert s.line_threshold == 47
    assert s.select_region([0, 0, 100, 100], (400, 400))
    assert s.line_threshold == 31  # from the first zoom's 200x200 region


def test_zoom_out_full_parameter_reset():
    s = _blank_session(300, 400)
    s.process = lambda: None
    s.rotate_deg = 10.0
    s.contrast = 90
    s.brightness = 10
    s.black_stone_threshold = 60
    s.board_alignment = [Alignment.RIGHT, Alignment.BOTTOM]
    s.selection = np.array([10, 10, 50, 50])
    s.zoom_out()
    assert s.rotate_deg == 0.0
    assert s.contrast == s.cfg.contrast
    assert s.brightness == s.cfg.brightness
    assert s.black_stone_threshold == s.cfg.black_stone_threshold
    assert s.board_alignment == [Alignment.LEFT, Alignment.TOP]
    np.testing.assert_allclose(s.selection, [0, 0, 400, 300])
    assert s.line_threshold == 39


def test_zoom_rejects_tiny_rectangles():
    s = _blank_session()
    s.process = lambda: None
    assert not s.select_region([100, 100, 105, 200], (400, 400))


@pytest.mark.parametrize("angle", [-17.0, -5.0, 3.5, 12.0, 90.0])
def test_zoom_geometry_rotated_matches_reference_math(angle):
    for base, local, canvas in [
        ([0, 0, 640, 480], [50, 40, 300, 260], (320, 240)),
        ([60, 30, 500, 400], [12, 25, 200, 180], (400, 300)),
        ([100, 100, 620, 460], [210, 170, 80, 35], (256, 256)),
    ]:
        s = DetectSession(log=lambda *_: None, device="cpu")
        s.load_image(np.zeros((480, 640, 3), np.uint8))
        s.selection = np.asarray(base, float)
        region = np.zeros((base[3] - base[1], base[2] - base[0], 3), np.uint8)
        s.region_rgb = region
        s.rotate_deg = angle
        s.process = lambda: None
        assert s.select_region(local, canvas)
        want = _reference_select_region_oracle(
            base, local, canvas, (640, 480),
            (region.shape[1], region.shape[0]), angle)
        np.testing.assert_allclose(np.asarray(s.selection, float), want,
                                   atol=1e-9, err_msg=f"angle={angle}")
