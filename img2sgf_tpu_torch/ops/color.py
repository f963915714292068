"""Colour-space and enhancement ops with PIL/OpenCV bit parity (port of
img2sgf_tpu/ops/color.py).

The JAX package's float32 expressions are rounded here as XLA:CPU rounds
them: it rewrites the mean's division by the constant pixel count into a
multiply by the float32 reciprocal, and contracts `m + alpha*(x - m)` and
`t * (1/n) + 0.5` into fused multiply-adds (one rounding). A fused
multiply-add of float32 operands is computed exactly in float64 and rounded
once to float32 (the product needs at most 48 bits), which gives the same
bits on every device.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import long_on, region_mask


def pil_luma(rgb_u8):
    """PIL convert('L') luma: (R*19595 + G*38470 + B*7471 + 32768) >> 16."""
    x = rgb_u8.to(torch.int64)
    return (x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471 + 32768) >> 16


def grey_bgr_quirk(rgb_u8):
    """cv.cvtColor(BGR2GRAY) applied to RGB data, as the reference does
    (img2sgf.py:153): (c0*3735 + c1*19235 + c2*9798 + 16384) >> 15."""
    x = rgb_u8.to(torch.int32)
    g = (x[..., 0] * 3735 + x[..., 1] * 19235 + x[..., 2] * 9798 + 16384) >> 15
    return g.to(torch.uint8)


def _f32(x: float) -> float:
    """x rounded to float32, kept as a Python float: the float32 constant
    of the JAX package's expression, with no upload to the device."""
    return float(np.float32(x))


def _fma_f32(a, b, c):
    """float32 fused multiply-add a*b + c (float32 tensors, or Python
    floats from _f32; one rounding)."""
    def f64(x):
        return x.double() if isinstance(x, torch.Tensor) else x
    return (f64(a) * f64(b) + f64(c)).to(torch.float32)


def _pil_blend_trunc(degenerate_f, img_f, alpha: float):
    """PIL Image.blend: in1 + alpha*(in2 - in1), clipped to [0, 255] and
    truncated (Pillow Blend.c casts to UINT8)."""
    out = _fma_f32(_f32(alpha), img_f - degenerate_f, degenerate_f)
    out = out.clamp(0.0, 255.0)
    return torch.floor(out).to(torch.uint8)


def enhance_contrast(rgb_u8, contrast: float, hw=None):
    """PIL ImageEnhance.Contrast with the reference's slider remap
    (img2sgf.py:142-144) on [..., H, W, 3]; the degenerate image is the
    solid grey int(mean(L) + 0.5) of each image.

    hw=(h, w): content dims inside a fixed canvas (one per image); the mean
    is taken over the content block with the count h*w. The count is then
    a run-time value for XLA, which divides by it and adds the 0.5 in a
    separate rounding, instead of the fused reciprocal of the native path.
    """
    alpha = 102.0 / (101.0 - contrast) - 1.0
    luma = pil_luma(rgb_u8)
    dev = rgb_u8.device
    if hw is None:
        total = luma.sum(dim=(-2, -1)).to(torch.float32)
        # the float32 reciprocal of the pixel count, rounded on the host as
        # the device rounds it (IEEE division)
        rcp = float(np.float32(1.0) / np.float32(luma.shape[-2] * luma.shape[-1]))
        mean = torch.floor(_fma_f32(total, rcp, 0.5))
    else:
        h, w = long_on(hw[0], dev), long_on(hw[1], dev)
        inside = region_mask(luma.shape[-2:], h, w, dev)
        total = (luma * inside).sum(dim=(-2, -1)).to(torch.float32)
        mean = torch.floor(total / (h * w).to(torch.float32) + 0.5)
    return _pil_blend_trunc(mean[..., None, None, None],
                            rgb_u8.to(torch.float32), alpha)


def enhance_brightness(rgb_u8, brightness: float):
    """PIL ImageEnhance.Brightness with the reference's slider remap
    (img2sgf.py:146-149); the degenerate image is black."""
    alpha = 450.0 / (200.0 - brightness) - 2.0
    # black degenerate: XLA folds 0 + alpha*(x - 0) to one multiply
    out = (_f32(alpha) * rgb_u8.to(torch.float32)).clamp(0.0, 255.0)
    return torch.floor(out).to(torch.uint8)


def preprocess(rgb_u8, contrast: float, brightness: float, hw=None):
    """Contrast then brightness enhancement (img2sgf.py:142-150) of
    [..., H, W, 3] images; hw as in enhance_contrast."""
    return enhance_brightness(enhance_contrast(rgb_u8, contrast, hw=hw),
                              brightness)
