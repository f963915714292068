"""PyTorch port against the JAX package on the shape-bucketed and batched
path, bit for bit: the canvas helpers, every op that takes content dims, the
circle stages with per-plane content dims, detect_board_auto,
detect_board_batch and detect_board_bucket_batch, and the CLI's --batch.

Each JAX function is called as its pipeline calls it: under jax.jit, with
the content dims passed as traced arguments (constant-folded dims can round
differently), and under jax.vmap where the pipeline batches. The JAX
pipeline programs take most of this file's time, so each is compiled once
and shared through module fixtures."""

import dataclasses
import glob
import importlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from img2sgf_tpu.config import DetectionConfig as JaxConfig
from img2sgf_tpu.ops import common as jcommon
from img2sgf_tpu.ops.blur import blur_pyramid as j_blur_pyramid
from img2sgf_tpu.ops.color import preprocess as j_preprocess
from img2sgf_tpu.pipeline import detect as jdetect

from img2sgf_tpu_torch import cli
from img2sgf_tpu_torch.config import DetectionConfig, from_jax_config
from img2sgf_tpu_torch.core import to_sgf
from img2sgf_tpu_torch.hough import circles as tcircles
from img2sgf_tpu_torch.ops import common as tcommon
from img2sgf_tpu_torch.ops.blur import blur_pyramid
from img2sgf_tpu_torch.ops.color import preprocess
from img2sgf_tpu_torch.pipeline import (
    bucket_dim,
    detect_board,
    detect_board_auto,
    detect_board_batch,
    detect_board_bucket_batch,
)
from img2sgf_tpu_torch.pipeline import detect as tdetect

from test_torch_pipeline import (
    OVERFLOW, TINY, _compare, _noisy_board, cap_torch_threads, synth_board)

cap_torch_threads()

jcanny = importlib.import_module("img2sgf_tpu.ops.canny")
tcanny = importlib.import_module("img2sgf_tpu_torch.ops.canny")
jcircles = importlib.import_module("img2sgf_tpu.hough.circles")
jerase = importlib.import_module("img2sgf_tpu.hough.erase")
terase = importlib.import_module("img2sgf_tpu_torch.hough.erase")
jident = importlib.import_module("img2sgf_tpu.grid.identify")
tident = importlib.import_module("img2sgf_tpu_torch.grid.identify")


def _eq(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _eq_live(got, want, got_valid, want_valid):
    """Candidate lists equal in their valid rows (the packages fill the
    other slots differently, and nothing downstream reads them)."""
    _eq(got_valid, want_valid)
    live = np.asarray(want_valid)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy()[live], np.asarray(w)[live])


def _tcfg(jcfg):
    return from_jax_config(dataclasses.asdict(jcfg))


def _canvas(imgs, hb=None, wb=None):
    """Images padded top-left into one canvas: (canvases, hs, ws)."""
    hb = hb or max(bucket_dim(im.shape[0]) for im in imgs)
    wb = wb or max(bucket_dim(im.shape[1]) for im in imgs)
    out = np.zeros((len(imgs), hb, wb) + imgs[0].shape[2:], np.uint8)
    for i, im in enumerate(imgs):
        out[i, :im.shape[0], :im.shape[1]] = im
    hs = np.array([im.shape[0] for im in imgs], np.int32)
    ws = np.array([im.shape[1] for im in imgs], np.int32)
    return out, hs, ws


def _scene(seed, H=40, W=48):
    """Seeded grey scene with discs, lines and noise, [H, W] uint8."""
    rng = np.random.default_rng(seed)
    img = np.full((H, W), 190.0)
    yy, xx = np.mgrid[0:H, 0:W]
    for _ in range(4):
        cy, cx, r = rng.integers(4, H - 4), rng.integers(4, W - 4), rng.integers(3, 9)
        img[np.hypot(yy - cy, xx - cx) < r] = rng.integers(0, 256)
    img[rng.integers(3, H - 3), :] = 20
    img[:, rng.integers(3, W - 3)] = 20
    img += rng.normal(0, 14, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


# --- canvas helpers


@pytest.mark.parametrize("mode", ["replicate", "reflect101"])
@pytest.mark.parametrize("hw", [(20, 31), (1, 5), (32, 40), (29, 2)])
def test_border_remap(mode, hw):
    x = np.random.default_rng(7).integers(0, 256, (3, 32, 40)).astype(np.uint8)
    want = jax.jit(lambda a, h, w: jcommon.border_remap(a, h, w, mode))(
        jnp.asarray(x), *hw)
    _eq(tcommon.border_remap(torch.from_numpy(x), *hw, mode), want)
    _eq(tcommon.border_remap(torch.from_numpy(x), torch.tensor(hw[0]),
                             torch.tensor(hw[1]), mode), want)


@pytest.mark.parametrize("mode", ["replicate", "reflect101"])
def test_border_remap_per_image(mode):
    """Content dims [B] over a [B, C, H, W] stack (the batch's colour
    channels) and over [P, H, W] planes, against jax.vmap."""
    x = np.random.default_rng(8).integers(0, 256, (3, 2, 24, 30)).astype(np.uint8)
    hs, ws = np.array([24, 17, 9], np.int32), np.array([5, 30, 28], np.int32)
    want = jax.jit(jax.vmap(lambda a, h, w: jcommon.border_remap(a, h, w, mode)))(
        jnp.asarray(x), hs, ws)
    got = tcommon.border_remap(torch.from_numpy(x), torch.from_numpy(hs),
                               torch.from_numpy(ws), mode)
    _eq(got, want)
    _eq(tcommon.border_remap(torch.from_numpy(x[:, 0]), torch.from_numpy(hs),
                             torch.from_numpy(ws), mode), np.asarray(want)[:, 0])


def test_region_mask():
    want = jax.jit(lambda h, w: jcommon.region_mask((12, 20), h, w))(7, 13)
    _eq(tcommon.region_mask((12, 20), 7, 13), want)
    hs, ws = np.array([12, 1, 5]), np.array([20, 3, 0])
    want = jax.jit(jax.vmap(lambda h, w: jcommon.region_mask((12, 20), h, w)))(
        hs, ws)
    _eq(tcommon.region_mask((12, 20), torch.from_numpy(hs), torch.from_numpy(ws)),
        want)


# --- pre ops


def _tie_image():
    """A 10x11 grey block whose mean luma is exactly 15.5, in a 32x32
    canvas: the rounding of the contrast mean decides between 15 and 16."""
    img = np.full((32, 32, 3), 200, np.uint8)
    block = np.array([15, 16] * 55, np.uint8).reshape(10, 11)
    img[:10, :11] = block[..., None]
    return img


@pytest.mark.parametrize("hw", [(32, 32), (10, 11), (23, 17), (1, 32)])
def test_preprocess_hw(hw):
    img = _tie_image() if hw == (10, 11) else \
        np.random.default_rng(hw[0]).integers(0, 256, (32, 32, 3)).astype(np.uint8)
    want = jax.jit(lambda a, h, w: j_preprocess(a, 40.0, 55.0, hw=(h, w)))(
        jnp.asarray(img), *hw)
    _eq(preprocess(torch.from_numpy(img), 40.0, 55.0, hw=hw), want)


def test_preprocess_mean_rounding_differs_from_native():
    """At the tie the traced count divides (mean 16, PIL's answer) where the
    native path's folded reciprocal gives 15: the port reproduces both."""
    img = _tie_image()[:10, :11]
    native = jax.jit(lambda a: j_preprocess(a, 40.0, 55.0))(jnp.asarray(img))
    bucketed = jax.jit(lambda a, h, w: j_preprocess(a, 40.0, 55.0, hw=(h, w)))(
        jnp.asarray(_tie_image()), 10, 11)
    assert not np.array_equal(np.asarray(native), np.asarray(bucketed)[:10, :11])
    _eq(preprocess(torch.from_numpy(img), 40.0, 55.0), native)


def test_preprocess_per_image():
    imgs = np.random.default_rng(3).integers(0, 256, (3, 24, 20, 3)).astype(np.uint8)
    imgs[1] = _tie_image()[:24, :20]
    hs, ws = np.array([24, 10, 7], np.int32), np.array([20, 11, 19], np.int32)
    want = jax.jit(jax.vmap(
        lambda a, h, w: j_preprocess(a, 40.0, 55.0, hw=(h, w))))(
        jnp.asarray(imgs), hs, ws)
    got = preprocess(torch.from_numpy(imgs), 40.0, 55.0,
                     hw=(torch.from_numpy(hs), torch.from_numpy(ws)))
    _eq(got, want)
    native = jax.jit(jax.vmap(lambda a: j_preprocess(a, 40.0, 55.0)))(
        jnp.asarray(imgs))
    _eq(preprocess(torch.from_numpy(imgs), 40.0, 55.0), native)


@pytest.mark.parametrize("margin", [0, 1, 2, 3, 13])
def test_blur_pyramid_hw(margin):
    """Margins 1-2 (less than the 5 and 7 px Gaussians' radius) reproduce
    the JAX package's difference from native-size blurs; 0 and >= 3 are
    exact against native size."""
    Hb, Wb = 40, 48
    h, w = Hb - margin, Wb - (margin if margin != 13 else 5)
    grey = _scene(margin, Hb, Wb)
    edges = (_scene(100 + margin, Hb, Wb) > 128).astype(np.uint8) * 255
    grey[h:], grey[:, w:] = 0, 0
    want = jax.jit(lambda g, e, hh, ww: j_blur_pyramid(g, e, 3, hw=(hh, ww)))(
        jnp.asarray(grey), jnp.asarray(edges), h, w)
    got = blur_pyramid(torch.from_numpy(grey), torch.from_numpy(edges), 3,
                       hw=(h, w))
    _eq(got, want)
    native = jax.jit(lambda g, e: j_blur_pyramid(g, e, 3))(
        jnp.asarray(grey[:h, :w]), jnp.asarray(edges[:h, :w]))
    content = np.asarray(want)[:, :h, :w]
    gauss = [7, 9]  # Gaussian k = 5 and 7
    if margin in (1, 2):
        assert any(not np.array_equal(content[v], np.asarray(native)[v])
                   for v in gauss)
    else:
        np.testing.assert_array_equal(content, np.asarray(native))


def test_blur_pyramid_per_image():
    grey = np.stack([_scene(s) for s in (5, 6)])
    edges = np.zeros_like(grey)
    hs, ws = np.array([39, 30], np.int32), np.array([48, 35], np.int32)
    want = jax.jit(jax.vmap(
        lambda g, e, h, w: j_blur_pyramid(g, e, 3, hw=(h, w))))(
        jnp.asarray(grey), jnp.asarray(edges), hs, ws)
    got = blur_pyramid(torch.from_numpy(grey), torch.from_numpy(edges), 3,
                       hw=(torch.from_numpy(hs), torch.from_numpy(ws)))
    _eq(got, want)


# --- Canny


@pytest.mark.parametrize("l2", [False, True])
@pytest.mark.parametrize("hw", [(40, 48), (33, 29)])
def test_canny_hw(l2, hw):
    img = np.stack([_scene(11), _scene(12), _scene(13)], axis=-1)
    want = jax.jit(lambda a, h, w: jcanny.canny(a, 50.0, 150.0, l2, iters=256,
                                                hw=(h, w)))(jnp.asarray(img), *hw)
    _eq(tcanny.canny(torch.from_numpy(img), 50.0, 150.0, l2, iters=256, hw=hw),
        want)
    grey = img[..., 0]
    want = jax.jit(lambda a, h, w: jcanny.canny(a, 40.0, 90.0, iters=256,
                                                hw=(h, w)))(jnp.asarray(grey), *hw)
    _eq(tcanny.canny(torch.from_numpy(grey), 40.0, 90.0, iters=256, hw=hw), want)


def test_canny_pool_hw_planes():
    planes = np.stack([_scene(20 + i) for i in range(6)])
    hs = np.array([40, 40, 31, 31, 22, 39], np.int32)
    ws = np.array([48, 47, 30, 30, 48, 3], np.int32)
    want = jax.jit(lambda p, h, w: jcanny.canny_pool(
        p, 50.0, 100.0, iters=256, hw_planes=(h, w)))(jnp.asarray(planes), hs, ws)
    got = tcanny.canny_pool(torch.from_numpy(planes), 50.0, 100.0, iters=256,
                            hw_planes=(torch.from_numpy(hs), torch.from_numpy(ws)))
    _eq(got, want)


@pytest.mark.parametrize("with_hw", [False, True])
def test_canny_rgb_pool(with_hw):
    imgs = np.stack([np.stack([_scene(30 + 3 * b + c) for c in range(3)], -1)
                     for b in range(3)])
    hs, ws = np.array([40, 25, 37], np.int32), np.array([48, 48, 20], np.int32)
    hw_j = (hs, ws) if with_hw else None
    hw_t = (torch.from_numpy(hs), torch.from_numpy(ws)) if with_hw else None
    want = jax.jit(lambda a, hb: jcanny.canny_rgb_pool(
        a, 50.0, 150.0, True, iters=256, hw_batch=hb))(jnp.asarray(imgs), hw_j)
    got = tcanny.canny_rgb_pool(torch.from_numpy(imgs), 50.0, 150.0, True,
                                iters=256, hw_batch=hw_t)
    _eq(got, want)


def test_pack_planes_round_trip():
    """The [G, 32, H, W] shift-and-sum packing: bit b of word g is plane
    32g + b, for a pool that fills one word and a part of another."""
    x = np.random.default_rng(9).random((45, 5, 7)) < 0.5
    words = tcanny.pack_planes(torch.from_numpy(x))
    assert words.shape == (2, 5, 7) and words.dtype == torch.int32
    w = words.numpy().astype(np.int64) & 0xFFFFFFFF
    for p in (0, 31, 32, 44):
        np.testing.assert_array_equal((w[p // 32] >> (p % 32)) & 1, x[p])
    assert not ((w[1] >> 13) != 0).any()
    np.testing.assert_array_equal(tcanny.unpack_planes(words, 45).numpy(), x)


# --- circle stages with per-plane content dims


@pytest.fixture(scope="module")
def plane_pool():
    """Unique planes of two diagrams in one 160 canvas (147 and 158 px,
    margins 13 and 2), with their per-plane content dims, through the JAX
    and the port's plane state."""
    jcfg = TINY
    cfg = _tcfg(jcfg)
    imgs = [synth_board(size=147, n=7, stones=((1, 2, 0), (3, 3, 255))),
            synth_board(size=158, n=7, stones=((2, 2, 0), (4, 3, 255)))]
    can, hs, ws = _canvas(imgs)
    grey, edges, variants = tdetect._pre_circles(
        torch.from_numpy(can), cfg, (torch.from_numpy(hs).long(),
                                     torch.from_numpy(ws).long()))
    keep, _ = tdetect._variant_dedup(cfg, variants.shape[1])
    planes = variants[:, keep].reshape(-1, *variants.shape[2:])
    Vu = len(keep)
    hsp, wsp = np.repeat(hs, Vu), np.repeat(ws, Vu)
    jst = jax.jit(lambda p, h, w: jdetect._plane_state_pool(p, jcfg, (h, w)))(
        jnp.asarray(planes.numpy()), hsp, wsp)
    tst = tdetect._plane_state_pool(planes, cfg, (torch.from_numpy(hsp).long(),
                                                  torch.from_numpy(wsp).long()))
    return jcfg, cfg, hsp, wsp, jst, tst


def test_plane_state_hw(plane_pool):
    _, _, _, _, jst, tst = plane_pool
    for k in ("emask", "sx", "sy", "acc"):
        _eq(tst[k], jst[k])


def test_propose_and_candidates_hw(plane_pool):
    jcfg, cfg, hsp, wsp, jst, tst = plane_pool
    thr, top_k = jcfg.circle_acc_threshold, jcfg.max_center_candidates
    jprop = jax.jit(jax.vmap(lambda a, h, w: jcircles.propose_from_acc(
        a, thr, top_k, hw=(h, w), threshold_factor=jcfg.propose_threshold_factor,
        margin_factor=jcfg.overflow_margin_factor)))(jst["acc"], hsp, wsp)
    hw = (tst["hs"], tst["ws"])
    tprop = tcircles.propose_from_acc(
        tst["acc"], thr, top_k, threshold_factor=jcfg.propose_threshold_factor,
        margin_factor=jcfg.overflow_margin_factor, hw=hw)
    _eq_live(tprop[:2], jprop[:2], tprop[2], jprop[2])
    _eq(tprop[3], jprop[3])
    H, W = tst["acc"].shape[1:]
    ys, xs, valid, _ = jprop
    jcand = jax.jit(jax.vmap(lambda e, a, b, y, x, v, h, w: jcircles.circle_candidates(
        e, a, b, y, x, v, jcfg.circle_min_radius, jcfg.circle_max_radius, thr,
        H, W, hw=(h, w), prov_budget=jcfg.max_ring_candidates,
        peak_budget=jcfg.max_peak_candidates)))(
        jst["emask"], jst["sx"], jst["sy"], ys, xs, valid, hsp, wsp)
    tcand = tcircles.circle_candidates(
        tst["emask"], tst["sx"], tst["sy"], tprop[0], tprop[1], tprop[2],
        cfg.circle_min_radius, cfg.circle_max_radius, thr, H, W,
        prov_budget=cfg.max_ring_candidates, peak_budget=cfg.max_peak_candidates,
        hw=hw)
    _eq_live(tcand[:3], jcand[:3], tcand[3], jcand[3])
    _eq(tcand[4], jcand[4])
    assert bool(np.asarray(jcand[3]).any())


def test_circles_from_state_hw(plane_pool):
    """The whole selection (proposals through finalize) with content dims."""
    jcfg, cfg, hsp, wsp, jst, tst = plane_pool
    jc, jv, js = jax.jit(lambda st, h, w: jdetect._circles_from_state(
        st, jcfg, (h, w), margin_filter=True))(jst, hsp, wsp)
    tc, tv, ts = tdetect._circles_from_state(tst, cfg, margin_filter=True)
    _eq(tc, jc)
    _eq(tv, jv)
    _eq(ts, js)


# --- post ops


def test_erase_circles_hw():
    rng = np.random.default_rng(4)
    edges = (rng.random((60, 64)) < 0.3).astype(np.uint8) * 255
    circ = np.stack([rng.uniform(0, 64, 12), rng.uniform(0, 60, 12),
                     rng.uniform(2, 8, 12)], -1).astype(np.float32)
    valid = rng.random(12) < 0.8
    want = jax.jit(lambda e, c, v, h, w: jerase.erase_circles(e, c, v, hw=(h, w)))(
        jnp.asarray(edges), jnp.asarray(circ), jnp.asarray(valid), 41, 50)
    _eq(terase.erase_circles(torch.from_numpy(edges), torch.from_numpy(circ),
                             torch.from_numpy(valid), hw=(41, 50)), want)


def test_identify_board_hw():
    """Windows of grid points near the content edge are clamped to the
    content dims, not the canvas."""
    rng = np.random.default_rng(5)
    grey = rng.integers(0, 256, (80, 90)).astype(np.uint8)
    hc = np.full(19, np.inf, np.float32)
    vc = np.full(19, np.inf, np.float32)
    hc[:5] = [8, 20, 32, 44, 56]
    vc[:6] = [10, 22, 34, 46, 58, 70]
    grid = dict(hcentres_complete=hc, vcentres_complete=vc, hsize=np.int32(6),
                vsize=np.int32(5), hspace=np.float32(12.0), vspace=np.float32(12.0))
    circ = np.array([[22, 20, 5], [70, 56, 5], [58, 44, 5]], np.float32)
    valid = np.array([True, True, True])
    want = jax.jit(lambda g, c, v, gr, h, w: jident.identify_board(
        g, c, v, gr, 100.0, 19, hw=(h, w)))(
        jnp.asarray(grey), jnp.asarray(circ), jnp.asarray(valid),
        {k: jnp.asarray(v) for k, v in grid.items()}, 59, 73)
    got = tident.identify_board(
        torch.from_numpy(grey), torch.from_numpy(circ), torch.from_numpy(valid),
        {k: torch.from_numpy(np.asarray(v)) for k, v in grid.items()}, 100.0, 19,
        hw=(59, 73))
    for k in want:
        _eq(got[k], want[k])
    native = jident.identify_board(jnp.asarray(grey), jnp.asarray(circ),
                                   jnp.asarray(valid),
                                   {k: jnp.asarray(v) for k, v in grid.items()},
                                   100.0, 19)
    assert not np.array_equal(np.asarray(native["intensities"]),
                              np.asarray(want["intensities"]))


# --- the entry points against the JAX package


AUTO_CASES = {  # size -> (lines, stones); 147 -> 160 and 101 -> 128
    147: (7, ((1, 2, 0), (3, 3, 255))),
    101: (5, ((1, 2, 0), (3, 3, 255))),
}


@pytest.fixture(scope="module")
def auto_results():
    out = {}
    for size, (n, stones) in AUTO_CASES.items():
        rgb = synth_board(size=size, n=n, stones=stones)
        out[size] = (rgb, jdetect.detect_board_auto(rgb, TINY, 24.0),
                     detect_board_auto(rgb, _tcfg(TINY), 24.0, device="cpu"))
    return out


@pytest.mark.parametrize("size", list(AUTO_CASES))
def test_detect_board_auto_every_field(auto_results, size):
    _, jres, tres = auto_results[size]
    _compare(jres, tres)
    assert tres.grey.shape == (size, size)
    assert bool(tres.board_ready)


@pytest.mark.parametrize("size", list(AUTO_CASES))
def test_detect_board_auto_equals_native(auto_results, size):
    """Margins 13 and 27: the fields tests/test_bucketed.py checks equal the
    port's native-size detect_board."""
    rgb, _, tres = auto_results[size]
    native = detect_board(rgb, _tcfg(TINY), 24.0, device="cpu")
    for f in ("full_board", "detected_board", "hsize", "vsize", "board_ready",
              "valid_grid", "num_black", "num_white", "side_to_move", "hspace",
              "vspace", "intensities", "stone_mask", "edges", "grey",
              "circles_removed"):
        assert torch.equal(getattr(native, f), getattr(tres, f)), f


def test_detect_board_content_hw_is_auto_uncropped(auto_results):
    rgb, _, tres = auto_results[147]
    canvas, _, _ = _canvas([rgb])
    res = detect_board(canvas[0], _tcfg(TINY), 24.0, (147, 147), device="cpu")
    assert res.grey.shape == (160, 160)
    assert torch.equal(res.grey[:147, :147], tres.grey)
    assert not res.edges[147:].any() and not res.circles_removed[:, 147:].any()
    assert torch.equal(res.full_board, tres.full_board)


BUCKET_IMGS = (  # margins 13 and 2 in the 160 canvas
    (147, 7, ((1, 2, 0), (3, 3, 255))),
    (158, 7, ((2, 2, 0), (4, 3, 255))),
)


@pytest.fixture(scope="module")
def bucket_batch():
    imgs = [synth_board(size=s, n=n, stones=st) for s, n, st in BUCKET_IMGS]
    can, hs, ws = _canvas(imgs)
    ths = np.full((len(imgs),), 24.0, np.float32)
    jres = jdetect.detect_board_bucket_batch(
        jnp.asarray(can), TINY, jnp.asarray(ths), jnp.asarray(hs), jnp.asarray(ws))
    tres = detect_board_bucket_batch(can, _tcfg(TINY), ths, hs, ws, device="cpu")
    return imgs, jres, tres


def test_detect_board_bucket_batch_every_field(bucket_batch):
    _, jres, tres = bucket_batch
    _compare(jres, tres)
    assert tres.full_board.shape == (2, 19, 19) and tres.grey.shape == (2, 160, 160)
    assert bool(tres.board_ready.all())


def test_bucket_batch_rows_equal_auto(bucket_batch):
    """Row i of the batch is the port's detect_board_auto of image i, the
    image-plane fields cropped."""
    imgs, _, tres = bucket_batch
    for i, im in enumerate(imgs):
        single = detect_board_auto(im, _tcfg(TINY), 24.0, device="cpu")
        h, w = im.shape[:2]
        for f in dataclasses.fields(single):
            row = getattr(tres, f.name)[i]
            if f.name in ("grey", "edges", "circles_removed"):
                row = row[:h, :w]
            assert torch.equal(row, getattr(single, f.name)), (i, f.name)


def test_detect_board_batch_every_field():
    imgs = [synth_board(size=128, n=7, stones=((1, 2, 0), (3, 3, 255))),
            synth_board(size=128, n=5, stones=((2, 1, 255),))]
    batch = np.stack(imgs)
    ths = np.array([24.0, 26.0], np.float32)
    jres = jdetect.detect_board_batch(jnp.asarray(batch), TINY, jnp.asarray(ths))
    tres = detect_board_batch(batch, _tcfg(TINY), ths, device="cpu")
    _compare(jres, tres)
    for i, im in enumerate(imgs):  # and each row is detect_board of its image
        single = detect_board(im, _tcfg(TINY), float(ths[i]), device="cpu")
        for f in dataclasses.fields(single):
            assert torch.equal(getattr(tres, f.name)[i], getattr(single, f.name))


def test_bucket_batch_overflow_rerun_every_field():
    """The noisy diagram (128 px, margin 0) beside a clean one (127 px,
    margin 1) at the OVERFLOW config: only the noisy image's planes
    saturate, so the rerun runs over planes of one image of the batch."""
    noisy = _noisy_board()
    clean = synth_board(size=127, n=4, stones=((1, 1, 0),))
    can, hs, ws = _canvas([noisy, clean])
    cfg = _tcfg(OVERFLOW)
    hw = (torch.from_numpy(hs).long(), torch.from_numpy(ws).long())
    _, _, v = tdetect._pre_circles(torch.from_numpy(can), cfg, hw)
    keep, _ = tdetect._variant_dedup(cfg, v.shape[1])
    Vu = len(keep)
    st = tdetect._plane_state_pool(
        v[:, keep].reshape(-1, *v.shape[2:]), cfg,
        tuple(t.repeat_interleave(Vu) for t in hw))
    _, _, sat = tdetect._circles_from_state(st, cfg, margin_filter=True)
    assert bool(sat[:Vu].any()) and not bool(sat[Vu:].any())
    ths = np.array([26.0, 24.0], np.float32)
    jres = jdetect.detect_board_bucket_batch(
        jnp.asarray(can), OVERFLOW, jnp.asarray(ths), jnp.asarray(hs),
        jnp.asarray(ws))
    tres = detect_board_bucket_batch(can, cfg, ths, hs, ws, device="cpu")
    _compare(jres, tres)


# --- the CLI's --batch


def _save_png(path, rgb):
    from PIL import Image

    Image.fromarray(rgb).save(path)


def test_cli_batch_cpu(tmp_path, capsys):
    """Mixed sizes in two buckets (margins 13, 2 and 27), one image whose
    board is not found, and a file that does not open: each SGF equals
    to_sgf of its row of detect_board_bucket_batch."""
    imgs = {
        "a": synth_board(size=147, n=7, stones=((1, 2, 0), (3, 3, 255))),
        "b": synth_board(size=158, n=9, stones=((2, 3, 0), (4, 4, 255))),
        "c": synth_board(size=101, n=5, stones=((1, 2, 0), (3, 3, 255))),
        "d": np.full((120, 100, 3), 240, np.uint8),
    }
    for name, rgb in imgs.items():
        _save_png(tmp_path / f"{name}.png", rgb)
    (tmp_path / "e.png").write_bytes(b"not an image")
    out = tmp_path / "out"
    rc = cli.main(["--batch", str(tmp_path / "*.png"), "-o", str(out),
                   "--batch-size", "2", "--device", "cpu"])
    text = capsys.readouterr()
    assert rc == 0, text.out
    assert "Error opening file" in text.err
    assert "3 converted, 1 not detected, 5 files" in text.out
    cfg = DetectionConfig()
    from img2sgf_tpu_torch import choose_line_threshold

    for name in ("a", "b", "c"):
        rgb = imgs[name]
        can, hs, ws = _canvas([rgb])
        thr = choose_line_threshold(*rgb.shape[:2])
        res = detect_board_bucket_batch(can, cfg, [thr], hs, ws, device="cpu")
        assert bool(res.board_ready[0]), name
        want = to_sgf(res.full_board[0], side_to_move=int(res.side_to_move[0]))
        assert (out / f"{name}.sgf").read_text() == want, name
    assert sorted(os.path.basename(p) for p in glob.glob(str(out / "*"))) == \
        ["a.sgf", "b.sgf", "c.sgf"]


def test_cli_batch_same_sgfs_as_jax_cli(bucket_batch, tmp_path, monkeypatch,
                                       capsys):
    """The JAX CLI's run_batch and the port's --batch write the same SGF
    files for the bucket batch's two images (margins 13 and 2 in the 160
    canvas), one batch of 2. Both CLIs run at the TINY config (the default
    config's JAX program takes too long to compile on the CPU), so the JAX
    side reuses the bucket_batch fixture's compiled program."""
    from img2sgf_tpu import cli as jcli
    from img2sgf_tpu import config as jconfig
    from img2sgf_tpu_torch import config as tconfig

    imgs = bucket_batch[0]
    for i, rgb in enumerate(imgs):
        _save_png(tmp_path / f"d{i}.png", rgb)
    cfg = _tcfg(TINY)
    monkeypatch.setattr(jcli, "_enable_compile_cache", lambda: None)
    monkeypatch.setattr(jconfig, "DetectionConfig", lambda: TINY)
    monkeypatch.setattr(tconfig, "DetectionConfig", lambda: cfg)
    pattern = str(tmp_path / "*.png")
    assert jcli.run_batch([pattern], str(tmp_path / "jax"), batch_size=2) == 0
    assert cli.main(["--batch", pattern, "-o", str(tmp_path / "port"),
                     "--batch-size", "2", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert text.count("2 converted, 0 not detected, 2 files") == 2, text
    for i in range(len(imgs)):
        want = (tmp_path / "jax" / f"d{i}.sgf").read_text()
        assert (tmp_path / "port" / f"d{i}.sgf").read_text() == want, i


def test_cli_batch_nothing_converted(tmp_path, capsys):
    _save_png(tmp_path / "blank.png", np.full((64, 64, 3), 240, np.uint8))
    assert cli.main(["--batch", str(tmp_path / "*.png"), "--device", "cpu"]) == 1
    assert cli.main(["--batch", str(tmp_path / "none*.png"), "--device",
                     "cpu"]) == 1
    assert "board not detected" in capsys.readouterr().out


def test_new_entry_points_need_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this pins the no-card error")
    rgb = synth_board(size=64, n=5, stones=())
    can, hs, ws = _canvas([rgb])
    for call in (lambda: detect_board_auto(rgb, DetectionConfig()),
                 lambda: detect_board_batch(rgb[None], DetectionConfig(), [20.0]),
                 lambda: detect_board_bucket_batch(can, DetectionConfig(), [20.0],
                                                   hs, ws)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_bad_content_dims_raise():
    can, _, _ = _canvas([synth_board(size=64, n=5, stones=())])
    with pytest.raises(ValueError, match="do not fit"):
        detect_board_bucket_batch(can, DetectionConfig(), [20.0], [129], [64],
                                  device="cpu")
    with pytest.raises(ValueError, match="line thresholds"):
        detect_board_batch(can, DetectionConfig(), [20.0, 21.0], device="cpu")
