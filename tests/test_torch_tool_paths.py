"""PyTorch port against the JAX package: the single-image circle functions
the JAX package's diagnostic tools call (circle_plane_state in both modes,
circle_propose, hough_circles_gradient), on one seeded plane, every output
bit for bit. One compiled JAX program computes all of them."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from img2sgf_tpu.hough import circles as jc

from img2sgf_tpu_torch.hough import circles as tc

# param1 (internal Canny), param2, minDist, radii, bins, budgets, sweeps
ARGS = dict(canny_high=100.0, acc_threshold=20.0, min_dist=10.0, min_r=1,
            max_r=30, num_bins=64, top_k=256, max_out=32, iters=16)
HW = (70, 61)  # content block of the canvas case


def _plane(seed=3, size=88):
    """A seeded grey plane: dark rings (stones), a few lines, noise."""
    rng = np.random.default_rng(seed)
    img = np.full((size, size), 225.0)
    yy, xx = np.mgrid[0:size, 0:size]
    for _ in range(6):
        cy, cx = rng.integers(10, size - 10, 2)
        r = rng.integers(5, 14)
        d = np.hypot(yy - cy, xx - cx)
        img = np.where(d < r, rng.integers(0, 140), img)
        img = np.where(np.abs(d - r) < 0.8, 15, img)
    for c in rng.integers(4, size - 4, 2):
        img[c, :] = 30
        img[:, c] = 30
    img += rng.normal(0, 5, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _jax_all(img, canvas):
    a = ARGS
    out = {}
    out["state"] = jc.circle_plane_state(img, a["canny_high"], a["min_r"],
                                         a["max_r"], a["num_bins"],
                                         hysteresis_iters=a["iters"])
    out["labels"] = jc.circle_plane_state(img, a["canny_high"], a["min_r"],
                                          a["max_r"], a["num_bins"],
                                          hysteresis_iters=a["iters"],
                                          with_acc=False)
    out["propose"] = jc.circle_propose(img, a["canny_high"],
                                       a["acc_threshold"], a["min_r"],
                                       a["max_r"], a["num_bins"], a["top_k"],
                                       a["iters"])
    out["propose_block_hw"] = jc.circle_propose(
        canvas, a["canny_high"], a["acc_threshold"], a["min_r"], a["max_r"],
        a["num_bins"], a["top_k"], a["iters"], hw=HW, block=2)
    out["hough"] = dict(zip(("circles", "valid"), jc.hough_circles_gradient(
        img, a["canny_high"], a["acc_threshold"], a["min_dist"], a["min_r"],
        a["max_r"], a["num_bins"], a["top_k"], a["max_out"], a["iters"])))
    return out


@pytest.fixture(scope="module")
def results():
    img = _plane()
    canvas = np.zeros((96, 80), np.uint8)
    canvas[:HW[0], :HW[1]] = _plane(seed=4)[:HW[0], :HW[1]]
    want = jax.jit(_jax_all)(jnp.asarray(img), jnp.asarray(canvas))
    want = jax.tree_util.tree_map(np.asarray, want)
    a = ARGS
    t, tv = torch.from_numpy(img), torch.from_numpy(canvas)
    got = {
        "state": tc.circle_plane_state(t, a["canny_high"], a["min_r"],
                                       a["max_r"], a["num_bins"],
                                       hysteresis_iters=a["iters"]),
        "labels": tc.circle_plane_state(t, a["canny_high"], a["min_r"],
                                        a["max_r"], a["num_bins"],
                                        hysteresis_iters=a["iters"],
                                        with_acc=False),
        "propose": tc.circle_propose(t, a["canny_high"], a["acc_threshold"],
                                     a["min_r"], a["max_r"], a["num_bins"],
                                     a["top_k"], a["iters"]),
        "propose_block_hw": tc.circle_propose(
            tv, a["canny_high"], a["acc_threshold"], a["min_r"], a["max_r"],
            a["num_bins"], a["top_k"], a["iters"], hw=HW, block=2),
        "hough": dict(zip(("circles", "valid"), tc.hough_circles_gradient(
            t, a["canny_high"], a["acc_threshold"], a["min_dist"],
            a["min_r"], a["max_r"], a["num_bins"], a["top_k"], a["max_out"],
            a["iters"]))),
    }
    return want, got


def _eq(got, want, mask=None):
    got = got.numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    if mask is not None:
        got, want = got[mask], want[mask]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("part,field", [
    ("state", "emask"), ("state", "sx"), ("state", "sy"), ("state", "acc"),
    ("labels", "emask"), ("labels", "sx"), ("labels", "sy"),
    ("labels", "lbl")])
def test_circle_plane_state(results, part, field):
    """Both modes: the accumulator, or the uint8 direction labels."""
    want, got = results
    assert set(got[part]) == set(want[part])
    _eq(got[part][field], want[part][field])


@pytest.mark.parametrize("field", ["emask", "sx", "sy", "ys", "xs", "valid",
                                   "sat"])
def test_circle_propose(results, field):
    """Proposals as a set in stream order: rows past the valid prefix are
    fill that no stage reads (compared under the valid mask)."""
    want, got = results
    mask = want["propose"]["valid"] if field in ("ys", "xs") else None
    _eq(got["propose"][field], want["propose"][field], mask)
    assert int(want["propose"]["valid"].sum()) > 0


@pytest.mark.parametrize("field", ["emask", "sx", "sy", "ys", "xs", "valid",
                                   "sat"])
def test_circle_propose_block_in_canvas(results, field):
    """Block proposals (propose_block 2) inside a canvas's content block:
    rows in vote order, every row compared."""
    want, got = results
    _eq(got["propose_block_hw"][field], want["propose_block_hw"][field])


@pytest.mark.parametrize("field", ["circles", "valid"])
def test_hough_circles_gradient(results, field):
    """The whole single-plane HOUGH_GRADIENT: circles in acceptance order."""
    want, got = results
    _eq(got["hough"][field], want["hough"][field])
    assert int(want["hough"]["valid"].sum()) >= 3
