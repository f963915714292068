"""The port's GUI layer against the JAX package's: the session's axis
narration against the reference oracle, the editor's pure geometry helpers,
crop_and_rotate, the CLI's GUI route, and a display test that skips where
there is no Tk display (as tests/test_gui_smoke.py does)."""

import numpy as np
import pytest
import torch

from img2sgf_tpu.gui import app as japp
from img2sgf_tpu.hostio import crop_and_rotate as j_crop_and_rotate

from img2sgf_tpu_torch import cli
from img2sgf_tpu_torch.grid import validate_axis
from img2sgf_tpu_torch.gui import app
from img2sgf_tpu_torch.gui.session import DetectSession
from img2sgf_tpu_torch.hostio import crop_and_rotate
from test_narration import AXIS_CASES, _oracle_axis_log
from test_torch_pipeline import synth_board


def _port_axis_log(coords):
    msgs = []
    s = DetectSession(log=msgs.append, device="cpu")
    v = torch.full((64,), float("inf"), dtype=torch.float32)
    v[: len(coords)] = torch.tensor(coords, dtype=torch.float32)
    _x, _n, _ok, reason, diag = validate_axis(
        v, torch.tensor(len(coords), dtype=torch.int32), 19, 10.0, 1.6)
    s._narrate_axis("horizontal", len(coords), diag.numpy(), int(reason))
    return msgs


@pytest.mark.parametrize("coords", AXIS_CASES)
def test_axis_narration_matches_reference(coords):
    assert _port_axis_log(coords) == _oracle_axis_log(coords)


# --- the editor's geometry helpers, against the JAX package's


@pytest.mark.parametrize("w,h", [(460, 460), (500, 460), (460, 700), (222, 222)])
@pytest.mark.parametrize("hsize,vsize", [(19, 19), (17, 19), (19, 3), (8, 6)])
def test_board_click_action_equals_jax(w, h, hsize, vsize):
    for x in np.linspace(0, w - 1, 41):
        for y in np.linspace(0, h - 1, 41):
            assert app.board_click_action(x, y, w, h, hsize, vsize) == \
                japp.board_click_action(x, y, w, h, hsize, vsize), (x, y)


def test_canvas_fit_scale_equals_jax():
    for args in [(750, 747, 400, 400), (100, 400, 400, 400), (200, 100, 0, 0),
                 (640, 480, 1, 1), (33, 1000, 400, 250)]:
        assert app.canvas_fit_scale(*args) == japp.canvas_fit_scale(*args)


def test_hist_pixel_to_data_equals_jax():
    import matplotlib
    matplotlib.use("Agg", force=True)
    from matplotlib.figure import Figure

    fig = Figure(figsize=(3, 2), dpi=130)
    ax = fig.add_subplot(1, 1, 1)
    rng = np.random.default_rng(0)
    ax.hist(rng.uniform(0, 255, 300), bins=20, range=[0, 255], color="pink")
    fig.canvas.draw()
    height = int(fig.bbox.height)
    for t in (0.0, 64.0, 128.0, 250.0):
        px, py_disp = ax.transData.transform((t, 0.0))
        got = app.hist_pixel_to_data(ax, px, height - py_disp, height)
        assert got == japp.hist_pixel_to_data(ax, px, height - py_disp, height)
        assert abs(got - t) < 0.5, (t, got)


def test_layout_constants_equal_jax():
    assert (app.IMAGE_SIZE, app.BORDER) == (japp.IMAGE_SIZE, japp.BORDER)


@pytest.mark.parametrize("selection,angle", [
    ((0, 0, 147, 147), 0.0), ((10, 20, 120, 140), 0.0), ((0, 0, 100, 100), 2.0),
    ((30, 5, 140, 90), -7.5), ((5, 40, 60, 147), 33.0), ((12, 12, 135, 135), 90.0),
])
def test_crop_and_rotate_equals_jax(selection, angle):
    rgb = synth_board(size=147, n=7, stones=((1, 2, 0), (2, 1, 255)))
    rgb = rgb.copy()
    rgb[..., 1] = np.roll(rgb[..., 1], 3, axis=1)  # channels differ
    got = crop_and_rotate(rgb, np.array(selection), angle)
    want = j_crop_and_rotate(rgb, np.array(selection), angle)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# --- the CLI's GUI route


@pytest.mark.parametrize("argv,want", [
    ([], (None, None, "cuda")),
    (["--device", "cpu"], (None, None, "cpu")),
    (["--gui"], (None, None, "cuda")),
    (["--gui", "in.png"], ("in.png", None, "cuda")),
    (["--gui", "--device", "cpu", "in.png", "out.sgf"], ("in.png", "out.sgf", "cpu")),
])
def test_cli_gui_route(monkeypatch, argv, want):
    seen = []

    def fake_run_gui(input_path=None, output_path=None, device="cuda"):
        seen.append((input_path, output_path, device))
        return 0

    monkeypatch.setattr(app, "run_gui", fake_run_gui)
    assert cli.main(argv) == 0
    assert seen == [want]


def test_run_gui_needs_a_card_for_cuda():
    """run_gui raises before it opens a window when there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this pins the no-card error")
    with pytest.raises(RuntimeError, match="cuda"):
        app.run_gui(None, None)


# --- display


def test_gui_module_imports():
    assert callable(app.run_gui)
    assert app.IMAGE_SIZE > 0 and app.BORDER >= 0


def _display_available():
    try:
        import tkinter as tk

        root = tk.Tk()
        root.destroy()
        return True
    except Exception:
        return False


@pytest.mark.skipif(not _display_available(), reason="no Tk display")
def test_gui_construct_load_destroy(monkeypatch, tmp_path):
    """Construct the editor on the CPU, open a synthetic diagram, wait for
    its board, destroy: the board the editor holds is the session's."""
    import tkinter as tk

    from PIL import Image

    png = tmp_path / "diagram.png"
    Image.fromarray(synth_board(size=192)).save(png)
    errors, sessions = [], []
    orig_session = app.DetectSession

    class SpySession(orig_session):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            sessions.append(self)

    monkeypatch.setattr(app, "DetectSession", SpySession)

    def fake_mainloop(self):
        import time

        deadline = time.time() + 120
        while time.time() < deadline:
            self.update()
            if sessions and sessions[0].board_ready:
                break
            time.sleep(0.05)
        self.destroy()

    monkeypatch.setattr(tk.Tk, "mainloop", fake_mainloop)
    monkeypatch.setattr(tk.Tk, "report_callback_exception",
                        lambda self, et, ev, tb: errors.append(ev))
    assert app.run_gui(str(png), None, device="cpu") == 0
    assert not errors, f"Tk callback raised: {errors[0]!r}"
    assert sessions and sessions[0].board_ready
    assert (np.asarray(sessions[0].full_board) != 0).sum() == 3
