"""Canny edge detection with cv.Canny parity (port of
img2sgf_tpu/ops/canny.py). Sobel, magnitude, channel select and sector NMS
are integer tensor ops; hysteresis runs on bit-packed int32 words through
ops/hysteresis_cuda.py (kernel K1 on the card)."""

from __future__ import annotations

import torch

from .common import border_remap, region_mask, shift2d
from .hysteresis_cuda import hysteresis_packed
from .sobel import sobel3

_TG22 = 13573  # tan(22.5 deg) * 2^15, OpenCV's fixed-point constant
_WORD_BITS = 32  # planes per int32 word


def _nms(mag, dx, dy, low):
    """OpenCV sector NMS: candidate mask mag > low and local max along the
    quantized gradient direction (out-of-bounds neighbours read 0)."""
    m = mag
    x = dx.abs()
    y = dy.abs() * (1 << 15)
    tg22x = x * _TG22
    tg67x = tg22x + ((x + x) * (1 << 15))

    left = shift2d(m, 0, 1)
    right = shift2d(m, 0, -1)
    up = shift2d(m, 1, 0)
    down = shift2d(m, -1, 0)
    up_left = shift2d(m, 1, 1)
    up_right = shift2d(m, 1, -1)
    down_left = shift2d(m, -1, 1)
    down_right = shift2d(m, -1, -1)

    horiz = y < tg22x
    vert = y > tg67x
    s_neg = (dx ^ dy) < 0

    pass_h = (m > left) & (m >= right)
    pass_v = (m > up) & (m >= down)
    pass_d_neg = (m > up_right) & (m > down_left)
    pass_d_pos = (m > up_left) & (m > down_right)
    pass_d = torch.where(s_neg, pass_d_neg, pass_d_pos)

    local_max = torch.where(horiz, pass_h, torch.where(vert, pass_v, pass_d))
    return (m > low) & local_max


def pack_planes(x):
    """[P, H, W] bool -> [ceil(P/32), H, W] int32 words, plane b of group g
    in bit b: one shift over a [G, 32, H, W] view and a sum, which is the OR
    of the bits since no two planes share one."""
    P, H, W = x.shape
    G = -(-P // _WORD_BITS)
    if G * _WORD_BITS != P:
        x = torch.cat([x, x.new_zeros((G * _WORD_BITS - P, H, W))])
    bits = torch.arange(_WORD_BITS, dtype=torch.int32, device=x.device)
    shifted = x.reshape(G, _WORD_BITS, H, W).to(torch.int32) << bits[:, None, None]
    return shifted.sum(dim=1, dtype=torch.int32)


def unpack_planes(words, P: int):
    """Inverse of pack_planes: [G, H, W] int32 -> [P, H, W] bool."""
    G, H, W = words.shape
    bits = torch.arange(_WORD_BITS, dtype=torch.int32, device=words.device)
    planes = (words[:, None] >> bits[:, None, None]) & 1
    return planes.reshape(G * _WORD_BITS, H, W)[:P].to(torch.bool)


def hysteresis_pool(strong, cand, iters: int):
    """8-connected propagation from strong seeds through candidates over a
    pool of [P, H, W] planes, 32 planes per int32 word. A converged plane
    stays fixed, so each plane gets min(iters, its own convergence) sweeps,
    as in the JAX package. Returns [P, H, W] bool."""
    gate = pack_planes(cand)
    edge0 = pack_planes(strong & cand)
    return unpack_planes(hysteresis_packed(edge0, gate, iters), strong.shape[0])


def hysteresis(strong, cand, iters: int):
    """hysteresis_pool of one [H, W] plane."""
    return hysteresis_pool(strong[None], cand[None], iters)[0]


def _canny_pre(img_u8, low: float, high: float, l2gradient: bool, hw=None,
               colour: bool | None = None):
    """Sobel (per-channel max on colour), NMS and thresholds: (strong, cand)
    bool planes [..., H, W]. img_u8 is [..., H, W, C] when colour (default:
    a 3-D image is colour) and [..., H, W] otherwise.

    hw=(h, w): content dims inside a fixed canvas. The band past the content
    is rewritten with replicate semantics so that Sobel matches native-size
    results inside the content block, and magnitudes outside it are zeroed
    (OpenCV's zero border) before NMS, so no edge exists or grows there."""
    if colour is None:
        colour = img_u8.ndim == 3
    img = img_u8.movedim(-1, -3) if colour else img_u8
    if hw is not None:
        img = border_remap(img, hw[0], hw[1], "replicate")
    img = img.to(torch.int32)
    if colour:
        dx, dy = sobel3(img)
        cmag = dx * dx + dy * dy if l2gradient else dx.abs() + dy.abs()
        mag = cmag[..., 0, :, :]
        dxs, dys = dx[..., 0, :, :], dy[..., 0, :, :]
        for c in range(1, cmag.shape[-3]):
            better = cmag[..., c, :, :] > mag
            mag = torch.where(better, cmag[..., c, :, :], mag)
            dxs = torch.where(better, dx[..., c, :, :], dxs)
            dys = torch.where(better, dy[..., c, :, :], dys)
        dx, dy = dxs, dys
    else:
        dx, dy = sobel3(img)
        mag = (dx * dx + dy * dy) if l2gradient else (dx.abs() + dy.abs())
    if l2gradient:
        low_t, high_t = int(low) * int(low), int(high) * int(high)
    else:
        low_t, high_t = int(low), int(high)
    if hw is not None:
        mag = mag * region_mask(mag.shape[-2:], hw[0], hw[1], mag.device)
    cand = _nms(mag, dx, dy, low_t)
    strong = cand & (mag > high_t)
    return strong, cand


def canny(img_u8, low: float, high: float, l2gradient: bool = False,
          iters: int = 256, hw=None):
    """cv.Canny parity on a [H, W] or [H, W, C] uint8 image; uint8 {0, 255}.
    hw=(h, w): content dims inside a fixed canvas (see _canny_pre)."""
    strong, cand = _canny_pre(img_u8, low, high, l2gradient, hw)
    return hysteresis(strong, cand, iters).to(torch.uint8) * 255


def canny_pool(planes_u8, low: float, high: float, iters: int = 256,
               hw_planes=None):
    """cv.Canny (L1 gradient) over a pool of [P, H, W] planes sharing one
    packed hysteresis run; the HoughCircles-internal Canny. hw_planes:
    (hs, ws) [P] content dims per plane. Returns [P, H, W] uint8 {0, 255}."""
    strong, cand = _canny_pre(planes_u8, low, high, False, hw_planes,
                              colour=False)
    return hysteresis_pool(strong, cand, iters).to(torch.uint8) * 255


def canny_rgb_pool(imgs_u8, low: float, high: float, l2gradient: bool = False,
                   iters: int = 256, hw_batch=None):
    """cv.Canny over a batch of [B, H, W, 3] images sharing one packed
    hysteresis run (one K1 call for the whole batch): the batch path's outer
    Canny. hw_batch: (hs, ws) [B] content dims. Returns [B, H, W] uint8."""
    strong, cand = _canny_pre(imgs_u8, low, high, l2gradient, hw_batch,
                              colour=True)
    return hysteresis_pool(strong, cand, iters).to(torch.uint8) * 255
