"""The port's post stage over a batch against the JAX package's
jax.vmap(_post_circles), and against its own runs of one image, bit for bit
in every field; then each batched post module against jax.vmap of its JAX
counterpart.

Five seeded images on one 160x160 canvas, each with its own content dims
and line threshold, reach each outcome of grid validation: a board with
stones, no lines, one line (beside a vertical axis whose gap makes the grid
too big), lines too close together (clustering merges them into one line:
its cutoff is min_grid_spacing, so cluster centres are never closer, and
the TOO_CLOSE code is reached only by test_torch_post.py's direct cases),
and a complete grid larger than the board (board_size 7 keeps every case
inside the canvas). The JAX post program is compiled once, in a module
fixture."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from img2sgf_tpu.config import DetectionConfig as JaxConfig
from img2sgf_tpu.grid import cluster as jcluster
from img2sgf_tpu.grid import complete as jcomplete
from img2sgf_tpu.grid import identify as jidentify
from img2sgf_tpu.hough import erase as jerase
from img2sgf_tpu.hough import lines as jlines
from img2sgf_tpu.pipeline import detect as jdetect

from img2sgf_tpu_torch.config import from_jax_config
from img2sgf_tpu_torch.grid import cluster as tcluster
from img2sgf_tpu_torch.grid import complete as tcomplete
from img2sgf_tpu_torch.grid import identify as tidentify
from img2sgf_tpu_torch.hough import erase as terase
from img2sgf_tpu_torch.hough import lines as tlines
from img2sgf_tpu_torch.pipeline import detect as tdetect

from test_torch_pipeline import _compare, cap_torch_threads

cap_torch_threads()

JCFG = JaxConfig(board_size=7, max_lines=64, max_grid_lines=32)
TCFG = from_jax_config(dataclasses.asdict(JCFG))
H = W = 160
C = 40
KINDS = ("board", "no lines", "one line", "too close", "too big")
HS = (150, 160, 128, 160, 160)
WS = (144, 160, 160, 136, 160)
THS = (40.0, 30.0, 50.0, 44.0, 36.0)


def T(x):
    return torch.from_numpy(np.array(x))


def _eq(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _scene(kind, seed):
    """One image's post inputs: (grey, edges, circles [C, 3], valid [C])."""
    rng = np.random.default_rng(seed)
    grey = np.full((H, W), 225, np.uint8)
    edges = ((rng.random((H, W)) < 0.004) * 255).astype(np.uint8)
    circ = np.zeros((C, 3), np.float32)
    valid = np.zeros(C, bool)
    if kind == "board":
        ys = xs = 12 + 20 * np.arange(7)
    elif kind == "one line":
        ys, xs = np.array([70]), np.array([8, 23, 155])
    elif kind == "too close":
        ys = xs = 20 + 6 * np.arange(9)
    elif kind == "too big":
        ys = xs = 8 + 15 * np.arange(10)
    else:
        ys = xs = np.array([], int)
    for y in ys:
        edges[y, 5:W - 5] = 255
        grey[y, 5:W - 5] = 40
    for x in xs:
        edges[5:H - 5, x] = 255
        grey[5:H - 5, x] = 40
    yy, xx = np.mgrid[0:H, 0:W]
    if kind == "board":
        cells = rng.choice(49, 16, replace=False)
        for k, cell in enumerate(cells):
            i, j = divmod(int(cell), 7)
            cx, cy = xs[i] + 0.5, ys[j] + 0.5
            r = 8.0 if k < 14 else 4.0  # the last two fail the size filter
            d = np.hypot(xx + 0.5 - cx, yy + 0.5 - cy)
            grey[d <= r] = 20 if k % 2 else 235
            edges[np.abs(d - r) < 0.5] = 255
            circ[k] = (cx, cy, r)
            valid[k] = k != 5  # a dead slot among the live ones
    # a few circles on every image, some near the canvas edge
    for k in range(20, 26):
        circ[k] = (rng.integers(0, W) + 0.5, rng.integers(0, H) + 0.5,
                   rng.integers(4, 14) * 0.5)
        valid[k] = k % 3 != 0
    return grey, edges, circ, valid


@pytest.fixture(scope="module")
def inputs():
    scenes = [_scene(k, 30 + i) for i, k in enumerate(KINDS)]
    grey, edges, circ, valid = (np.stack(x) for x in zip(*scenes))
    return dict(grey=grey, edges=edges, circ=circ, valid=valid,
                ths=np.asarray(THS, np.float32), hs=np.asarray(HS, np.int32),
                ws=np.asarray(WS, np.int32))


@pytest.fixture(scope="module")
def jax_post(inputs):
    """jax.vmap(_post_circles) over the five images, with content dims."""
    fn = jax.jit(jax.vmap(lambda g, e, c, v, t, h, w: jdetect._post_circles(
        g, e, c, v, JCFG, t, (h, w))))
    i = inputs
    return fn(i["grey"], i["edges"], i["circ"], i["valid"], i["ths"],
              i["hs"], i["ws"])


def _port_post(inputs, rows=slice(None), hw=True):
    i = inputs
    return tdetect._post_circles(
        T(i["grey"][rows]), T(i["edges"][rows]), T(i["circ"][rows]),
        T(i["valid"][rows]), TCFG, T(i["ths"][rows]),
        (T(i["hs"][rows]).long(), T(i["ws"][rows]).long()) if hw else None)


def test_post_batch_equals_jax_vmap(inputs, jax_post):
    got = _port_post(inputs)
    _compare(jax_post, got)
    # each image reaches its own outcome
    assert got.board_ready.tolist() == [True, False, False, False, False]
    assert int(got.num_black[0]) >= 6 and int(got.num_white[0]) >= 7
    assert got.hreason.tolist()[:4] == [tcomplete.OK, tcomplete.NO_LINES,
                                        tcomplete.ONE_LINE,
                                        tcomplete.ONE_LINE]
    assert int(got.vreason[2]) == tcomplete.TOO_BIG
    assert bool(got.valid_grid[4]) and int(got.hsize[4]) > JCFG.board_size


@pytest.mark.parametrize("hw", [True, False])
def test_post_batch_equals_single_images(inputs, hw):
    """Row i of the batched pass equals the pass over image i alone (B = 1),
    with content dims and at native size."""
    batched = _port_post(inputs, hw=hw)
    for i in range(len(KINDS)):
        single = _port_post(inputs, slice(i, i + 1), hw=hw)
        for f in dataclasses.fields(batched):
            a, b = getattr(batched, f.name)[i], getattr(single, f.name)[0]
            assert a.dtype == b.dtype and torch.equal(a, b), (i, f.name)


def test_erase_circles_batched(inputs):
    i = inputs
    want = jax.jit(jax.vmap(lambda e, c, v, h, w: jerase.erase_circles(
        e, c, v, hw=(h, w))))(i["edges"], i["circ"], i["valid"], i["hs"],
                              i["ws"])
    got = terase.erase_circles(T(i["edges"]), T(i["circ"]), T(i["valid"]),
                               hw=(T(i["hs"]), T(i["ws"])))
    _eq(got, want)
    assert not np.array_equal(np.asarray(want), i["edges"])


@pytest.mark.parametrize("C", [1, 37, 200])
def test_erase_circles_chunks(C):
    """Dense circles on a 48 x 64 canvas, whose coverage test takes chunks
    of 27 circles (up to 8 chunks, the last one padded): three images with
    their own content dims against jax.vmap of the JAX erase."""
    rng = np.random.default_rng(C)
    B, H, W = 3, 48, 64
    edges = ((rng.random((B, H, W)) < 0.4) * 255).astype(np.uint8)
    circ = np.stack([rng.integers(-3, W + 3, (B, C)) + 0.5,
                     rng.integers(-3, H + 3, (B, C)) + 0.5,
                     rng.integers(0, 12, (B, C)) * 0.5], axis=-1)
    valid = rng.random((B, C)) < 0.8
    circ = np.where(valid[..., None], circ, 0.0).astype(np.float32)
    hs, ws = np.asarray([48, 40, 31], np.int32), np.asarray([64, 50, 64], np.int32)
    want = jax.jit(jax.vmap(lambda e, c, v, h, w: jerase.erase_circles(
        e, c, v, hw=(h, w))))(edges, circ, valid, hs, ws)
    got = terase.erase_circles(T(edges), T(circ), T(valid),
                               hw=(T(hs), T(ws)))
    _eq(got, want)
    assert terase._chunk(C, H, W) == min(C, 27)


@pytest.mark.parametrize("horizontal", [True, False])
def test_hough_lines_intercepts_batched(inputs, horizontal):
    i = inputs
    want = jax.jit(jax.vmap(lambda e, t: jlines.hough_lines_intercepts(
        e, t, horizontal, JCFG.angle_delta, JCFG.max_lines)))(
        i["edges"], i["ths"])
    got = tlines.hough_lines_intercepts(T(i["edges"]), T(i["ths"]),
                                        horizontal, JCFG.angle_delta,
                                        JCFG.max_lines)
    for g, w in zip(got, want):
        _eq(g, w)
    assert int(got[2][0]) >= 7


def _lines(inputs):
    """The JAX intercepts of both directions: [(values, valid)] x 2."""
    i = inputs
    out = []
    for horizontal in (True, False):
        v, m, _ = jax.jit(jax.vmap(lambda e, t: jlines.hough_lines_intercepts(
            e, t, horizontal, JCFG.angle_delta, JCFG.max_lines)))(
            i["edges"], i["ths"])
        out.append((np.asarray(v), np.asarray(m)))
    return out


def test_cluster_and_validate_grid_batched(inputs):
    """cluster_1d and validate_grid over the batch against jax.vmap, on the
    batch's own intercepts."""
    (hv, hm), (vv, vm) = _lines(inputs)
    clus = jax.jit(jax.vmap(lambda v, m: jcluster.cluster_1d(
        v, m, JCFG.min_grid_spacing, JCFG.max_grid_lines)))
    (jhc, jhn), (jvc, jvn) = clus(hv, hm), clus(vv, vm)
    thc, thn = tcluster.cluster_1d(T(hv), T(hm), JCFG.min_grid_spacing,
                                   JCFG.max_grid_lines)
    tvc, tvn = tcluster.cluster_1d(T(vv), T(vm), JCFG.min_grid_spacing,
                                   JCFG.max_grid_lines)
    for g, w in ((thc, jhc), (thn, jhn), (tvc, jvc), (tvn, jvn)):
        _eq(g, w)
    want = jax.jit(jax.vmap(lambda a, b, c, d: jcomplete.validate_grid(
        a, b, c, d, JCFG.board_size, JCFG.min_grid_spacing,
        JCFG.big_space_ratio)))(jhc, jhn, jvc, jvn)
    got = tcomplete.validate_grid(thc, thn, tvc, tvn, JCFG.board_size,
                                  JCFG.min_grid_spacing, JCFG.big_space_ratio)
    assert set(got) == set(want)
    for k in want:
        _eq(got[k], want[k])


def test_identify_board_batched(inputs, jax_post):
    """identify_board over the batch against jax.vmap, on the batch's grids
    and size-filtered circles, with content dims."""
    i = inputs
    r = jax_post
    grid = {k: np.asarray(getattr(r, k)) for k in (
        "hcentres_complete", "vcentres_complete", "hsize", "vsize", "hspace",
        "vspace")}
    cf = np.asarray(r.circles_filtered_valid)
    want = jax.jit(jax.vmap(lambda g, c, v, gr, h, w: jidentify.identify_board(
        g, c, v, gr, JCFG.black_stone_threshold, JCFG.board_size,
        hw=(h, w))))(i["grey"], i["circ"], cf, grid, i["hs"], i["ws"])
    got = tidentify.identify_board(
        T(i["grey"]), T(i["circ"]), T(cf), {k: T(v) for k, v in grid.items()},
        JCFG.black_stone_threshold, JCFG.board_size,
        hw=(T(i["hs"]).long(), T(i["ws"]).long()))
    assert set(got) == set(want)
    for k in want:
        _eq(got[k], want[k])
    assert int(got["stone_mask"][0].sum()) >= 13
