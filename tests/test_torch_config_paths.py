"""PyTorch port against the JAX package on the configuration values that
select paths off the default one, stage by stage, bit for bit on seeded
inputs: the per-offset accumulator (radius spans not divisible by 5),
circle_min_radius = 0 through the exact rescore and the radius stage,
block proposals (propose_block > 1) and their top_k_desc, direction bins
at counts other than 64, and the 3x3 recentre of the diagnostic tools.

JAX runs its XLA paths on the CPU (the Pallas kernels refuse min_r < 1);
the per-offset accumulator runs op by op, which its integer float32 sums
make equal to the compiled program."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from img2sgf_tpu.hough import circles as jc

from img2sgf_tpu_torch.hough import _bin_exceptions as bx
from img2sgf_tpu_torch.hough import circles as tc
from img2sgf_tpu_torch.hough import radius_cuda, rescore_cuda
from img2sgf_tpu_torch.ops.sobel import sobel3

from test_torch_circles import (_acc_planes, _k3_scan, _k3_window_walk,
                                _rescore_inputs)


def T(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _eq(got, want, mask=None):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if mask is not None:
        got, want = got[np.asarray(mask)], want[np.asarray(mask)]
    np.testing.assert_array_equal(got, want)


def _edge_plane(seed, H, W):
    """A seeded uint8 plane with rings and lines, its Sobel gradients and a
    sparse edge mask on nonzero gradients."""
    rng = np.random.default_rng(seed)
    img = np.full((H, W), 200.0)
    yy, xx = np.mgrid[0:H, 0:W]
    for _ in range(4):
        cy, cx, r = rng.integers(10, H - 10), rng.integers(10, W - 10), \
            rng.integers(5, 20)
        img = np.where(np.abs(np.hypot(yy - cy, xx - cx) - r) < 1.0, 20, img)
    img = np.clip(img + rng.normal(0, 20, img.shape), 0, 255).astype(np.uint8)
    dx, dy = (t.numpy() for t in sobel3(T(img)))
    emask = (rng.random((H, W)) < 0.3) & ((dx != 0) | (dy != 0))
    return img, emask, dx, dy


@pytest.mark.parametrize("min_r,max_r", [(1, 31), (1, 29), (3, 30), (0, 30)])
def test_vote_accumulator_offsets(min_r, max_r):
    """Radius spans not divisible by 5 take the exact per-offset
    accumulator in both packages (3-30 is a span of 28, 0-30 has the r = 0
    step); each plane of a pool equals JAX's vote_accumulator of it."""
    planes = [_edge_plane(seed, 64 + 8 * seed, 80) for seed in range(2)]
    H = min(p[0].shape[0] for p in planes)
    em = np.stack([p[1][:H] for p in planes])
    dx = np.stack([p[2][:H] for p in planes])
    dy = np.stack([p[3][:H] for p in planes])
    got = tc.vote_accumulator_pool(T(em), T(dx), T(dy), 64, min_r, max_r)
    assert (max_r - min_r + 1) % 5
    for p in range(2):
        want = jc.vote_accumulator(jnp.asarray(em[p]), jnp.asarray(dx[p]),
                                   jnp.asarray(dy[p]), 64, min_r, max_r)
        _eq(got[p], want)
        _eq(tc.vote_accumulator(T(em[p]), T(dx[p]), T(dy[p]), 64, min_r,
                                max_r), want)
    assert float(got.max()) > 10


def test_vote_accumulator_dispatch():
    """The pool dispatcher: the cascade for a span of 30 (JAX's cascade,
    here through its per-plane vote_accumulator), the per-offset sums for
    a span of 31."""
    _, em, dx, dy = _edge_plane(5, 64, 72)
    lbl = tc.direction_labels(T(em), T(dx), T(dy), 64)[None]
    cascade = tc.vote_accumulator_pool_labels(lbl, 64, 1, 30)
    _eq(cascade, tc.vote_accumulator_cascade_labels(lbl, 64, 1, 30))
    _eq(cascade[0], jc.vote_accumulator(jnp.asarray(em), jnp.asarray(dx),
                                        jnp.asarray(dy), 64, 1, 30))
    _eq(tc.vote_accumulator_pool_labels(lbl, 64, 1, 31),
        tc.vote_accumulator_offsets(lbl, 64, 1, 31))


@pytest.fixture(scope="module")
def all_pairs():
    v = np.arange(-1020, 1021, dtype=np.int32)
    dx = np.repeat(v, v.size).reshape(v.size, v.size)
    dy = np.tile(v, v.size).reshape(v.size, v.size)
    return dx, dy


@pytest.mark.parametrize("num_bins", [48, 63, 66, 127, 254])
def test_direction_bins_counts(all_pairs, num_bins):
    """Every Sobel gradient pair at counts with off-ray exceptions (48),
    whole tie rays (63: dx = 0; 66 and 126: the diagonals) and the largest
    count: the port's bin equals JAX's float32 one."""
    dx, dy = all_pairs
    want = np.asarray(jax.jit(
        lambda a, b: jc.direction_bins(a, b, num_bins))(dx, dy))
    _eq(tc.direction_bins(T(dx), T(dy), num_bins), want)
    ang = np.arctan2(dy.astype(np.float64), dx.astype(np.float64))
    f64 = np.mod(np.round(ang / (math.pi / num_bins)).astype(np.int64),
                 num_bins)
    on_ray = (dx == 0) | (dy == 0) | (np.abs(dx) == np.abs(dy))
    n_off = int(((f64 != want) & ~on_ray).sum())
    assert n_off == len(bx.PAIRS.get(num_bins, ()))
    if num_bins == 63:  # the dx = 0 rays tie at 31.5 and split
        assert int(((f64 != want) & (dx == 0)).sum()) == 2040


def test_direction_bins_table_shape():
    """The generated table covers every count labels allow, eight rays
    each; counts out of range raise."""
    assert sorted(bx.RAYS) == list(range(1, 255))
    assert all(len(r) == 8 and all(0 <= b < n for b in r)
               for n, r in bx.RAYS.items())
    assert all(0 <= b < n for n, ps in bx.PAIRS.items() for _, _, b in ps)
    for bad in (0, 255):
        with pytest.raises(ValueError):
            tc.direction_bins(T(np.zeros(2, np.int32)),
                              T(np.ones(2, np.int32)), bad)


@pytest.mark.parametrize("k", [1, 300, 4096, 5000, 20000])
def test_top_k_desc(k):
    """lax.top_k (k <= 4096) and the stable argsort (k > 4096) of the JAX
    package: vote-descending rows, ties to the smaller index; past the
    input's length, all of it."""
    rng = np.random.default_rng(k)
    score = np.where(rng.random((2, 12000)) < 0.5,
                     rng.integers(1, 12, (2, 12000)), -1).astype(np.float32)
    want_v, want_i = jax.jit(jax.vmap(lambda s: jc.top_k_desc(s, k)))(
        jnp.asarray(score))
    got_v, got_i = tc.top_k_desc(T(score), k)
    _eq(got_v, want_v)
    _eq(got_i, want_i)
    assert got_i.shape[-1] == min(k, 12000)


@pytest.mark.parametrize("with_hw", [False, True])
@pytest.mark.parametrize("block,top_k", [(2, 64), (2, 5000), (4, 64),
                                         (4, 100)])
def test_propose_from_acc_block(block, top_k, with_hw):
    """Block proposals: one maximum per tile, rows in vote order (all rows
    compared, dead ones too), counts of live tiles for the margin-gated
    saturation; with content dims per plane and without."""
    acc = _acc_planes(block * 100 + top_k)
    hs, ws = np.array([40, 33, 29]), np.array([52, 47, 38])
    kw = dict(threshold_factor=0.6, margin_factor=0.7, select_floor=19.5,
              block=block)
    if with_hw:
        f = jax.jit(jax.vmap(lambda a, h, w: jc.propose_from_acc(
            a, 30.0, top_k, hw=(h, w), **kw)))
        want = f(jnp.asarray(acc), jnp.asarray(hs), jnp.asarray(ws))
        got = tc.propose_from_acc(T(acc), 30.0, top_k, hw=(T(hs), T(ws)), **kw)
    else:
        want = jax.jit(jax.vmap(lambda a: jc.propose_from_acc(
            a, 30.0, top_k, **kw)))(jnp.asarray(acc))
        got = tc.propose_from_acc(T(acc), 30.0, top_k, **kw)
    for g, w in zip(got, want):
        _eq(g, w)
    assert bool(np.asarray(want[2]).any())
    if top_k == 64 and block == 2:
        assert bool(np.asarray(want[3])[0])


def _rescore_inputs_on_centres(seed):
    """test_torch_circles' rescore inputs, plus edge pixels (steps along x)
    on the first five centres of plane 0, which the r = 0 step reaches."""
    emask, sx, sy, ys, xs, valid = _rescore_inputs(seed)
    emask[0, ys[0, :5], xs[0, :5]] = True
    sx[0, ys[0, :5], xs[0, :5]] = 1024
    sy[0, ys[0, :5], xs[0, :5]] = 0
    return emask, sx, sy, ys, xs, valid


@pytest.mark.parametrize("cells", [3, 5])
def test_rescore_min_r_zero(cells):
    """circle_min_radius = 0: the r = 0 step lands a pixel on its own cell
    from both walks; the port equals JAX's XLA rescore on the valid rows
    and counts more than at min_r = 1 where edge pixels sit in the
    patch."""
    emask, sx, sy, ys, xs, valid = _rescore_inputs_on_centres(40 + cells)
    args = [T(emask), T(sx), T(sy), T(ys), T(xs), T(valid)]
    got = rescore_cuda.exact_rescore(*args, 0, 30, cells=cells).numpy()
    one = rescore_cuda.exact_rescore(*args, 1, 30, cells=cells).numpy()
    for p in range(2):
        xla = jc.exact_rescore(jnp.asarray(emask[p]), jnp.asarray(sx[p]),
                               jnp.asarray(sy[p]), jnp.asarray(ys[p]),
                               jnp.asarray(xs[p]), 0, 30, cells=cells,
                               valid=jnp.asarray(valid[p]))
        _eq(got[p], xla, mask=valid[p])
    assert (got >= one).all() and got.sum() > one.sum()


def test_radius_min_r_zero():
    """circle_min_radius = 0: the histogram's annulus is a disk, with edge
    pixels right next to the centres (their bin 7 anchors the lowest run);
    the port equals JAX's XLA radius stage."""
    rng = np.random.default_rng(11)
    P, K, H, W = 3, 24, 90, 104
    emask = rng.random((P, H, W)) < 0.1
    yy, xx = np.mgrid[0:H, 0:W]
    for (ry, rx, rr) in ((30, 30, 11), (60, 70, 23), (45, 52, 5)):
        emask[:, np.abs(np.hypot(yy - ry, xx - rx) - rr) < 0.6] = True
    ys = rng.integers(0, H, (P, K))
    xs = rng.integers(0, W, (P, K))
    ys[:, :3], xs[:, :3] = (30, 60, 45), (30, 70, 52)
    # plane 2: nothing but the four pixels around each of three centres,
    # at distance sqrt(0.5) from (cx+.5, cy+.5)
    emask[2] = False
    ys[2, :3], xs[2, :3] = (10, 45, 80), (15, 60, W - 1)
    for y, x in zip(ys[2, :3], xs[2, :3]):
        emask[2, y:y + 2, x:x + 2] = True
    want = np.arange(K)[None, :] < np.array([[K - 5], [10], [3]])
    r, s = radius_cuda.radius_support_pool(T(emask), T(ys), T(xs), T(want),
                                           0, 29)
    xr, xsup = jc.radius_support_pool(jnp.asarray(emask), jnp.asarray(ys),
                                      jnp.asarray(xs), jnp.asarray(want), 0,
                                      29, chunk=8)
    _eq(r, xr)
    _eq(s, xsup)
    assert float(s.max()) > 30
    # the centre on the last column keeps 2 of its 4 pixels in the plane
    assert r[2, :3].tolist() == [np.float32(0.3)] * 3
    assert s[2, :3].tolist() == [4.0, 4.0, 2.0]


def test_hist10_scan_r_cur_zero():
    """A run anchored at bin 1 has r_cur = 0 at min_r = 0 (no window
    reaches it; pinned on histograms directly): the port's scan equals
    XLA's, the first run winning through cnt*r_best >= max_count*0."""
    rng = np.random.default_rng(12)
    counts = np.zeros((6, 290), np.float32)
    counts[0, 1] = 3
    counts[1, [1, 40]] = (5, 2)
    counts[2, [1, 2, 15]] = (1, 1, 9)
    counts[3:, :] = (rng.random((3, 290)) < 0.05) * rng.integers(1, 4, (3, 290))
    counts[3:, 1] = 2
    wr, wc = jax.jit(lambda c: jc._hist10_scan(c, 0))(jnp.asarray(counts))
    gr, gc = radius_cuda._hist10_scan(T(counts), 0)
    _eq(gr, wr)
    _eq(gc, wc)
    assert float(gr[0]) == 0.0 and float(gc[0]) == 3.0


@pytest.mark.parametrize("seed", [0, 1])
def test_circle_recentre_3x3(seed):
    """The legacy 3x3 path: the best cell (first maximum) with its in-patch
    neighbours, out-of-patch ones passing at -1; ties included."""
    rng = np.random.default_rng(seed)
    P, K, H, W = 2, 60, 50, 45
    patch = rng.integers(25, 36, (P, K, 3, 3)).astype(np.float32)
    ys = rng.integers(0, H, (P, K))
    xs = rng.integers(0, W, (P, K))
    valid = rng.random((P, K)) < 0.8
    got = tc.circle_recentre(T(patch), T(ys), T(xs), T(valid), 30.0, H, W)
    for p in range(P):
        want = jc.circle_recentre(jnp.asarray(patch[p]), jnp.asarray(ys[p]),
                                  jnp.asarray(xs[p]), jnp.asarray(valid[p]),
                                  30.0, H, W)
        for g, w in zip(got, want):
            _eq(g[p], w)
    assert bool(got[3].any()) and not bool(got[3].all())


@pytest.mark.parametrize("radii", [(0, 29), (0, 30)])
def test_k3_row_spans_disk(radii):
    """At min_r = 0 K3's annulus is a disk about (cx+.5, cy+.5): one span
    per window row, every row but the first (max_r + 0.5 away), the centre
    rows too, nonempty, covering exactly the bin map's
    pixels; the kernel's clipped, aligned chunk reads (numpy emulation)
    count the histogram of a direct count at corner and middle windows."""
    min_r, max_r = radii
    bmap, win, nbins = radius_cuda._bin_map(min_r, max_r)
    spans = radius_cuda._row_spans(min_r, max_r)
    disk = bmap.reshape(win, win) >= 0
    assert (spans[1:, 0] <= spans[1:, 1]).all() and spans[0, 0] > spans[0, 1]
    assert (spans[:, 2] > spans[:, 3]).all()
    dx = np.arange(win) - max_r
    _eq((dx >= spans[:, :1]) & (dx <= spans[:, 1:2]), disk)
    assert disk[max_r, max_r] and disk[max_r + 1, max_r + 1]
    H, W = 40, 50
    emask = np.random.default_rng(max_r).random((H, W)) < 0.3
    du, dv = np.nonzero(disk)
    buf = np.zeros(7 + H * W + 32, np.uint8)
    buf[7:7 + H * W] = emask.ravel()
    for cy, cx in ((0, 0), (H - 1, W - 1), (H // 2, W // 2)):
        yy, xx = cy - max_r + du, cx - max_r + dv
        inp = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        edge = inp.copy()
        edge[inp] = emask[yy[inp], xx[inp]]
        want_hist = np.zeros(nbins, np.int64)
        np.add.at(want_hist, bmap[du[edge] * win + dv[edge]], 1)
        seen, hist = _k3_window_walk(buf, 7, spans, bmap, cy, cx, H, W,
                                     max_r, nbins)
        assert seen == set(zip(yy[inp].tolist(), xx[inp].tolist()))
        _eq(hist, want_hist)
        assert not hist[:7].any() and hist.sum() > 0  # no pixel below bin 7


def test_k3_scan_decomposition_min_r_zero():
    """K3's warp scan (numpy emulation, lane by lane) at min_r = 0, with
    runs anchored at bin 1 (r_cur = 0) and at bin 7 (the disk's first):
    equal to _hist10_scan."""
    rng = np.random.default_rng(13)
    hists = np.zeros((8, 290), np.int64)
    hists[0, 1] = 3
    hists[1, [1, 40]] = (5, 2)
    hists[2, [7, 8]] = (4, 1)
    hists[3, [1, 7, 100]] = (2, 2, 9)
    hists[4:] = (rng.random((4, 290)) < 0.05) * rng.integers(1, 4, (4, 290))
    want_r, want_c = radius_cuda._hist10_scan(
        torch.from_numpy(hists.astype(np.float32)), 0)
    got = [_k3_scan(h, 0) for h in hists]
    _eq(np.array([g[0] for g in got], np.float32), want_r.numpy())
    _eq(np.array([g[1] for g in got], np.float32), want_c.numpy())
    assert float(want_r[0]) == 0.0 and float(want_r[2]) == np.float32(0.35)
