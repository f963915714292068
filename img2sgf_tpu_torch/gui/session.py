"""GUI-independent editing session state (port of img2sgf_tpu/gui/session.py).

Everything the Tk layer does that isn't drawing lives here so it can be
unit-tested without a display: selection/zoom geometry, the detection
cache, stone-cycle editing, alignment moves and SGF export. Mirrors the
reference's globals + handlers (img2sgf.py:616-737, 955-1002).

Detection runs on `device` (default the card); each process() brings its
BoardResult to the host once, as numpy arrays, so that narration,
reclassification, editing and the GUI's drawing read host memory and never
wait on the device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..config import DetectionConfig, choose_line_threshold
from ..core import BLACK, Alignment, BoardStates, align_board_np, to_sgf
from ..hostio import crop_and_rotate
from ..pipeline.detect import resolve_device


def _fmt_num(v) -> str:
    """Reference log formatting: Tk sliders hold ints, so integral values
    print without a decimal point."""
    f = float(v)
    return str(int(f)) if f == int(f) else str(f)


def _to_host(res):
    """A BoardResult with every field copied to a numpy array."""
    return dataclasses.replace(res, **{
        f.name: getattr(res, f.name).cpu().numpy()
        for f in dataclasses.fields(res)})


class DetectSession:
    """One loaded image + parameters + cached detection results."""

    def __init__(self, cfg: DetectionConfig | None = None, log=print,
                 device="cuda"):
        self.cfg = cfg or DetectionConfig()
        self.log = log
        self.device = resolve_device(device)
        self.input_rgb: np.ndarray | None = None  # full original image
        self.selection: np.ndarray | None = None  # x1,y1,x2,y2 on original
        self.rotate_deg = 0.0
        self.contrast = self.cfg.contrast
        self.brightness = self.cfg.brightness
        self.line_threshold = self.cfg.line_threshold
        self.black_stone_threshold = self.cfg.black_stone_threshold
        self.board_alignment = [Alignment.LEFT, Alignment.TOP]
        self.result = None  # BoardResult of last detection, numpy fields
        self.region_rgb: np.ndarray | None = None
        self.detected_board: np.ndarray | None = None  # [19,19] states
        self.full_board: np.ndarray | None = None
        self.side_to_move = BLACK
        self.board_edited = False

    # --- lifecycle (img2sgf.py:616-640) -------------------------------
    def load_image(self, rgb: np.ndarray):
        self.input_rgb = rgb
        self.selection = np.array([0, 0, rgb.shape[1], rgb.shape[0]])
        self.rotate_deg = 0.0
        self.contrast = self.cfg.contrast
        self.brightness = self.cfg.brightness
        self.black_stone_threshold = self.cfg.black_stone_threshold
        self.board_alignment = [Alignment.LEFT, Alignment.TOP]
        self.line_threshold = choose_line_threshold(rgb.shape[0], rgb.shape[1])
        self.board_edited = False

    @property
    def image_loaded(self):
        return self.input_rgb is not None

    @property
    def board_ready(self):
        return self.result is not None and bool(self.result.board_ready)

    @property
    def valid_grid(self):
        return self.result is not None and bool(self.result.valid_grid)

    # --- detection -----------------------------------------------------
    def process(self):
        """Crop/rotate host-side, run the bucketed pipeline on the session's
        device, cache its result on the host.

        Mirrors process_image (img2sgf.py:117-204); stone classification
        staging matches the reference: a later threshold change only
        reclassifies (apply_black_threshold), it does not re-detect.
        """
        if not self.image_loaded:
            return None
        from ..pipeline import detect_board_auto

        self.log("\nProcessing image")
        if self.rotate_deg != 0:
            self.log(f"Rotated by {_fmt_num(self.rotate_deg)} degrees")
        self.log(f"Contrast = {_fmt_num(self.contrast)}")
        self.log(f"Brightness = {_fmt_num(self.brightness)}")
        self.log("Converting to greyscale")
        self.log("Running Canny edge detection algorithm")
        self.log("Detecting circles")
        region = crop_and_rotate(self.input_rgb, self.selection, self.rotate_deg)
        self.region_rgb = region
        cfg = self.cfg.replace(contrast=float(self.contrast),
                               brightness=float(self.brightness),
                               black_stone_threshold=float(self.black_stone_threshold))
        # bucketed execution: zooming changes the crop shape on every drag;
        # a canvas per bucket keeps the shapes the device sees few
        res = _to_host(detect_board_auto(region, cfg, float(self.line_threshold),
                                         device=self.device))
        self.result = res
        self._narrate(res)
        if bool(res.board_ready):
            self.detected_board = res.detected_board
            self.side_to_move = int(res.side_to_move)
            self.apply_alignment()
        else:
            self.detected_board = None
            self.full_board = None
        self.board_edited = False
        return res

    def _narrate_truncate(self, n: int):
        """truncate_grid's messages (img2sgf.py:400-417)."""
        bs = self.cfg.board_size
        if n == bs + 2:
            self.log("Dropping two extra lines at the outsides of the grid")
        elif n == bs + 1:
            self.log("Dropping one extra line at the end of the grid")

    def _narrate_axis(self, name: str, count: int, diag, reason: int) -> bool:
        """One axis of validate_grid's decision script (img2sgf.py:335-430):
        truncate -> complete_grid -> truncate, message-for-message."""
        from ..grid import complete as gc

        min_space, has_big, steps, grid_n, n_trunc1, n_complete = (
            float(x) for x in np.asarray(diag)
        )
        self.log(f"Assessing {name} lines.")
        self._narrate_truncate(count)  # first truncation (:422/:427)
        if reason == gc.NO_LINES:
            self.log("No grid lines found at all!")
            return False
        if reason == gc.ONE_LINE:
            self.log("Only found one grid line")
            return False
        if reason == gc.TOO_CLOSE:
            # the five spaces before "pixels" are verbatim reference
            # output (img2sgf.py:351)
            self.log(
                "Grid lines are too close together: minimum spacing is "
                f"{round(min_space, 4)}     pixels"
            )
            return False
        n1 = int(n_trunc1)
        if not has_big:  # no gaps (:356-358)
            self.log(f"Got a complete grid of {n1} lines")
        else:
            if reason == gc.TOO_BIG:
                self.log(
                    f"Distance between edges of grid is {int(steps)} "
                    "times minimum space."
                )
                self.log("Extra lines on diagram, or a grid line detected twice?")
                return False
            self.log(f"Got {n1} lines within a grid of size {int(grid_n)}")
            if n1 < int(grid_n):
                self.log("Filling in gaps.")
        self._narrate_truncate(int(n_complete))  # second truncation (:424/:429)
        return True

    def _narrate(self, res):
        """Reproduce the reference's log narration line-for-line from the
        BoardResult diagnostics (find_grid and everything it calls,
        img2sgf.py:258-266, 295-306, 335-430, 497-534, 546-576)."""
        nh = int(np.asarray(res.hlines_valid).sum())
        nv = int(np.asarray(res.vlines_valid).sum())
        self.log(f"Found {nh} distinct horizontal lines and {nv} distinct vertical lines")
        self.log(f"Got {int(res.hcount)} horizontal and {int(res.vcount)} vertical grid lines")
        if self._narrate_axis("horizontal", int(res.hcount), res.hdiag, int(res.hreason)):
            self._narrate_axis("vertical", int(res.vcount), res.vdiag, int(res.vreason))
        if bool(res.valid_grid):
            hsize, vsize = int(res.hsize), int(res.vsize)
            if hsize > self.cfg.board_size:
                self.log("Too many vertical lines!")
            elif vsize > self.cfg.board_size:
                self.log("Too many horizontal lines!")
            else:
                self.log(
                    "Guessing stone colours based on a threshold of "
                    f"{_fmt_num(self.black_stone_threshold)}"
                )
                nb, nw = int(res.num_black), int(res.num_white)
                self.log(
                    f"Detected {nb} black stone{'s' if nb != 1 else ''} and "
                    f"{nw} white stone{'s' if nw != 1 else ''} on a "
                    f"{hsize}x{vsize} board."
                )
                self.log("Guessing black to play" if nb <= nw else "Guessing white to play")

    def reclassify(self):
        """Re-threshold cached intensities only (img2sgf.py:762-766): host
        arithmetic on the cached result, no detection and no device work."""
        if self.result is None or not self.board_ready:
            return
        inten = np.asarray(self.result.intensities)
        stones = np.asarray(self.result.stone_mask)
        board = np.zeros_like(inten, dtype=np.int32)
        board[stones & (inten <= self.black_stone_threshold)] = BoardStates.BLACK
        board[stones & (inten > self.black_stone_threshold)] = BoardStates.WHITE
        self.detected_board = board
        nb = int((board == BoardStates.BLACK).sum())
        nw = int((board == BoardStates.WHITE).sum())
        self.side_to_move = 1 if nb <= nw else 2
        self.apply_alignment()

    # --- board editing (img2sgf.py:955-1002) --------------------------
    def apply_alignment(self):
        hsize, vsize = int(self.result.hsize), int(self.result.vsize)
        part = self.detected_board[:hsize, :vsize]
        self.full_board = align_board_np(
            part, self.board_alignment, self.cfg.board_size
        ).astype(np.int32)
        self.board_edited = False

    def cycle_stone(self, i: int, j: int, right_click: bool):
        if self.full_board is None:
            return
        cur = self.full_board[i, j]
        if right_click:
            nxt = {0: BoardStates.BLACK, BoardStates.BLACK: BoardStates.WHITE}.get(cur, 0)
        else:
            nxt = {0: BoardStates.WHITE, BoardStates.WHITE: BoardStates.BLACK}.get(cur, 0)
        self.full_board[i, j] = nxt
        self.board_edited = True

    def set_alignment(self, horiz: Alignment | None, vert: Alignment | None):
        changed = False
        if horiz is not None and self.board_alignment[0] != horiz:
            self.board_alignment[0] = horiz
            changed = True
        if vert is not None and self.board_alignment[1] != vert:
            self.board_alignment[1] = vert
            changed = True
        if changed:
            self.apply_alignment()
        return changed

    # --- zoom geometry (img2sgf.py:677-714) ---------------------------
    def select_region(self, sel_local, canvas_wh):
        """Map a canvas-space drag rectangle to original-image coords with
        rotation compensation, then re-process."""
        if not self.image_loaded or self.region_rgb is None:
            return False
        xs = sorted((sel_local[0], sel_local[2]))
        ys = sorted((sel_local[1], sel_local[3]))
        if xs[1] - xs[0] < 10 or ys[1] - ys[0] < 10:
            return False
        x_c, y_c = canvas_wh
        y_i, x_i = self.region_rgb.shape[:2]
        scale = max(x_i / x_c, y_i / y_c)
        old = self.selection.astype(float)
        old_centre = np.array([(old[0] + old[2]) / 2, old[1] + old[3] / 2])
        new = np.array([
            old[0] + scale * xs[0], old[1] + scale * ys[0],
            old[0] + scale * xs[1], old[1] + scale * ys[1],
        ])
        new_centre = np.array([(new[0] + new[2]) / 2, new[1] + new[3] / 2])
        offset = new_centre - old_centre
        theta = -self.rotate_deg * math.pi / 180
        rot = np.array([[math.cos(theta), math.sin(theta)],
                        [math.sin(theta), math.cos(theta)]])
        xdelta, ydelta = rot @ offset - offset
        new += (-xdelta, ydelta, -xdelta, ydelta)
        new[0] = round(max(new[0], 0))
        new[1] = round(max(new[1], 0))
        new[2] = round(min(new[2], self.input_rgb.shape[1]))
        new[3] = round(min(new[3], self.input_rgb.shape[0]))
        self.selection = new
        w = int(new[2] - new[0])
        h = int(new[3] - new[1])
        self.log(f"\nZoomed in.  Region size {w}x{h}")
        # Reference quirk (img2sgf.py:721): the threshold is auto-chosen
        # from the STALE pre-zoom region (region_PIL is only recropped
        # later, inside process_image at :136) — not the new selection.
        ph, pw = self.region_rgb.shape[:2]
        self.line_threshold = choose_line_threshold(ph, pw)
        self.process()
        return True

    def zoom_out(self):
        if self.image_loaded:
            self.log("Zoomed out to full size")
            # the reference's zoom_out (img2sgf.py:732-737) re-runs
            # initialise_parameters: a FULL reset of selection, rotation,
            # contrast/brightness, black threshold and alignment — exactly
            # what load_image does
            self.load_image(self.input_rgb)
            self.process()

    # --- export (img2sgf.py:781-822) ----------------------------------
    def sgf_text(self) -> str:
        return to_sgf(self.full_board, side_to_move=self.side_to_move,
                      board_size=self.cfg.board_size)

    def stone_brightnesses(self) -> np.ndarray:
        if self.result is None:
            return np.zeros(0)
        inten = np.asarray(self.result.intensities)
        stones = np.asarray(self.result.stone_mask)
        # reference scan order (img2sgf.py:510-514): i (x index) outer,
        # j (y index) inner == C-order over the [i, j] board arrays
        return inten[stones]
