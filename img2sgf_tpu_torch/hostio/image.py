"""Host-side image IO and geometry (PIL), as img2sgf_tpu/hostio/image.py,
mirroring the reference's open/crop/rotate behaviour (img2sgf.py:106-114,
643-660, 769-778)."""

from __future__ import annotations

import numpy as np
from PIL import Image


def load_rgb(path: str) -> np.ndarray:
    """Image.open(...).convert('RGB') (img2sgf.py:651) as [H, W, 3] uint8."""
    with Image.open(path) as im:
        return np.array(im.convert("RGB"))


def crop_and_rotate(rgb: np.ndarray, selection, rotate_deg: float) -> np.ndarray:
    """Rotate the full image about the selection centre (white fill), then
    crop to the selection (img2sgf.py:110-114). selection = (x1, y1, x2, y2).
    """
    img = Image.fromarray(rgb)
    cx = (selection[0] + selection[2]) / 2
    cy = selection[1] + selection[3] / 2  # reference quirk (img2sgf.py:107)
    out = img.rotate(angle=-rotate_deg, fillcolor="white", center=(cx, cy)).crop(
        tuple(selection)
    )
    return np.array(out)


def screen_capture() -> np.ndarray:
    """Full-screen grab via PIL ImageGrab or pyscreenshot (img2sgf.py:34-39)."""
    try:
        from PIL import ImageGrab
    except ImportError:  # pragma: no cover
        import pyscreenshot as ImageGrab
    return np.array(ImageGrab.grab().convert("RGB"))
