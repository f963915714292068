"""PyTorch port against the JAX package: the circle detector's main-path
functions, stage by stage, on seeded inputs.

JAX runs as its own CPU tests run it: the XLA paths, and for kernels K2 and
K3 also the Pallas kernels in interpret mode. Outputs must be equal bit for
bit. One documented exception: rows outside a valid prefix carry values that
no later stage reads (the XLA rescore scores whole chunks, the counting
top-k fills dead rows with index 0); those rows are compared under the valid
mask."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from img2sgf_tpu.config import DetectionConfig as JaxConfig
from img2sgf_tpu.hough import circles as jc
from img2sgf_tpu.hough.radius_pallas import radius_support_pallas
from img2sgf_tpu.hough.rescore_pallas import exact_rescore_pallas
from img2sgf_tpu.pipeline import detect as jdetect

from chip_smoke import greedy_cases
from test_torch_greedy_walk import GEOMETRIES as GREEDY_GEOMETRIES
from test_torch_greedy_walk import greedy_walk
from img2sgf_tpu_torch.config import DetectionConfig
from img2sgf_tpu_torch.hough import circles as tc
from img2sgf_tpu_torch.hough import greedy_cuda, radius_cuda, rescore_cuda
from img2sgf_tpu_torch.pipeline import detect as tdetect


def T(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _eq(got, want, mask=None):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if mask is not None:
        got, want = got[np.asarray(mask)], want[np.asarray(mask)]
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def all_pairs():
    v = np.arange(-1020, 1021, dtype=np.int32)
    dx = np.repeat(v, v.size).reshape(v.size, v.size)
    dy = np.tile(v, v.size).reshape(v.size, v.size)
    return dx, dy


def test_direction_bins_all_pairs(all_pairs):
    """Every Sobel gradient pair: the port's bin equals JAX's float32 one.
    The port takes the float64 angle plus the generated table, which at 64
    bins lists the 6 pairs where float32 arctan2 rounds across a bin
    boundary (the count is pinned); 48 bins, once refused, equal too."""
    dx, dy = all_pairs
    want = np.asarray(jax.jit(lambda a, b: jc.direction_bins(a, b, 64))(dx, dy))
    got = tc.direction_bins(T(dx), T(dy), 64).numpy()
    np.testing.assert_array_equal(got, want)
    ang = np.arctan2(dy.astype(np.float64), dx.astype(np.float64))
    f64 = np.mod(np.round(ang / (math.pi / 64)).astype(np.int32), 64)
    assert int((f64 != want).sum()) == len(tc._bx.PAIRS[64]) == 6
    want48 = np.asarray(jax.jit(lambda a, b: jc.direction_bins(a, b, 48))(dx, dy))
    np.testing.assert_array_equal(tc.direction_bins(T(dx), T(dy), 48).numpy(),
                                  want48)


def test_pixel_steps_all_pairs(all_pairs):
    """Every Sobel gradient pair: walk steps equal JAX's bit for bit (8
    pairs per component round a .5 tie the other way under XLA:CPU's
    reciprocal-square-root rewrite; the table count is pinned)."""
    dx, dy = all_pairs
    wx, wy = jax.jit(jc.pixel_steps)(dx, dy)
    gx, gy = tc.pixel_steps(T(dx), T(dy))
    _eq(gx, wx)
    _eq(gy, wy)
    fx, fy = torch.from_numpy(dx).float(), torch.from_numpy(dy).float()
    mag = torch.clamp(torch.sqrt(fx * fx + fy * fy), min=1e-20)
    ieee = torch.round(1024.0 * fx / mag).int().numpy()
    assert int((ieee != np.asarray(wx)).sum()) == 8


def _scene(seed, size=80):
    rng = np.random.default_rng(seed)
    img = np.full((size, size), 220.0)
    yy, xx = np.mgrid[0:size, 0:size]
    for _ in range(7):
        cy, cx = rng.integers(8, size - 8, 2)
        r = rng.integers(4, 16)
        d = np.hypot(yy - cy, xx - cx)
        img = np.where(d < r, rng.integers(0, 120), img)
        img = np.where(np.abs(d - r) < 0.8, 15, img)
    for c in rng.integers(4, size - 4, 3):
        img[c, :] = 30
        img[:, c] = 30
    img += rng.normal(0, 6, img.shape)
    g = np.clip(img, 0, 255).astype(np.uint8)
    return np.repeat(g[:, :, None], 3, axis=2)


CFG_J = JaxConfig(max_center_candidates=96, overflow_center_candidates=0,
                  max_ring_candidates=64, max_peak_candidates=128,
                  max_circles_per_variant=24, hysteresis_iters=16)
CFG_T = DetectionConfig(**{f: getattr(CFG_J, f)
                           for f in CFG_J.__dataclass_fields__})


@pytest.fixture(scope="module")
def planes():
    """[8, 80, 80] unique blur-pyramid planes of two seeded scenes."""
    out = []
    for seed in (1, 2):
        v = tdetect._pre_circles(T(_scene(seed))[None], CFG_T)[2][0]
        keep, _ = tdetect._variant_dedup(CFG_T, v.shape[0])
        out.append(v[keep][:4])
    return torch.cat(out).numpy()


@pytest.fixture(scope="module")
def states(planes):
    """Plane state from both packages (JAX: the pooled byte-packed path)."""
    js = jax.jit(lambda p: jdetect._plane_state_pool(p, CFG_J, None))(
        jnp.asarray(planes))
    ts = tdetect._plane_state_pool(T(planes), CFG_T)
    return {k: np.asarray(v) for k, v in js.items()}, ts


@pytest.mark.parametrize("field", ["emask", "sx", "sy", "acc"])
def test_plane_state_pool(states, field):
    js, ts = states
    _eq(ts[field], js[field])
    if field == "acc":
        assert float(js["acc"].max()) > CFG_J.circle_acc_threshold


def test_cascade_accumulator_single_plane(planes, states):
    """The per-plane cascade (vote_accumulator_cascade) gives the same
    accumulator as the pooled byte-packed one and the port."""
    js, ts = states
    img = planes[3]
    st = jax.jit(lambda im: jc.circle_plane_state(
        im, 100.0, 1, 30, 64, hysteresis_iters=16))(jnp.asarray(img))
    _eq(ts["acc"][3], st["acc"])


def _acc_planes(seed, P=3, H=40, W=52):
    """Integer accumulators with many tied local maxima around the floor,
    margin and select levels (18, 19.5, 21 at the defaults)."""
    rng = np.random.default_rng(seed)
    acc = rng.integers(0, 26, (P, H, W)).astype(np.float32)
    acc[0, ::3, ::3] = 22  # a dense plane of tied maxima above the margin
    return acc


@pytest.mark.parametrize("top_k,margin,floor", [
    (64, 0.7, 0.65), (64, None, None), (4096, 0.7, 0.65), (200, 0.7, None),
    (30, 0.0, 0.65)])
def test_propose_from_acc(top_k, margin, floor):
    acc = _acc_planes(top_k)
    sel = None if floor is None else floor * 30.0
    f = jax.jit(jax.vmap(lambda a: jc.propose_from_acc(
        a, 30.0, top_k, threshold_factor=0.6, margin_factor=margin,
        select_floor=sel)))
    ys, xs, valid, sat = f(jnp.asarray(acc))
    gys, gxs, gvalid, gsat = tc.propose_from_acc(
        T(acc), 30.0, top_k, threshold_factor=0.6, margin_factor=margin,
        select_floor=sel)
    _eq(gvalid, valid)
    _eq(gsat, sat)
    _eq(gys, ys, mask=valid)
    _eq(gxs, xs, mask=valid)
    if top_k == 64:
        assert bool(np.asarray(sat).any())


@pytest.mark.parametrize("k", [1, 50, 700])
def test_top_k_set_by_count(k):
    rng = np.random.default_rng(k)
    score = np.where(rng.random((3, 600)) < 0.6,
                     rng.integers(1, 9, (3, 600)), -1).astype(np.float32)
    got = tc.top_k_set_by_count(T(score), k)
    for via in ("count", "sort"):
        want = jax.jit(jax.vmap(lambda s: jc.top_k_set_by_count(s, k, via=via)))(
            jnp.asarray(score))
        ok = np.asarray(want[2])
        _eq(got[2], ok)
        _eq(got[0], want[0], mask=ok)
        _eq(got[1], want[1], mask=ok)


def _rescore_inputs(seed, K=40, P=2, H=72, W=80):
    rng = np.random.default_rng(seed)
    emask = rng.random((P, H, W)) < 0.12
    ang = rng.uniform(0, 2 * np.pi, (P, H, W))
    sx = (np.rint(1024 * np.cos(ang)).astype(np.int32)) * emask
    sy = (np.rint(1024 * np.sin(ang)).astype(np.int32)) * emask
    ys = rng.integers(0, H, (P, K))  # border candidates included
    xs = rng.integers(0, W, (P, K))
    valid = np.arange(K)[None, :] < np.array([[K - 9], [3]])
    return emask, sx.astype(np.int32), sy.astype(np.int32), ys, xs, valid


@pytest.mark.parametrize("cells", [3, 5])
def test_rescore_plain_vs_xla_and_pallas(cells):
    emask, sx, sy, ys, xs, valid = _rescore_inputs(cells)
    got = rescore_cuda.exact_rescore(T(emask), T(sx), T(sy), T(ys), T(xs),
                                     T(valid), 1, 30, cells=cells).numpy()
    assert got.shape == (2, 40, cells, cells)
    assert not got[~valid].any()  # rows past the prefix are written as 0
    for p in range(2):
        args = (jnp.asarray(emask[p]), jnp.asarray(sx[p]), jnp.asarray(sy[p]),
                jnp.asarray(ys[p]), jnp.asarray(xs[p]), 1, 30)
        xla = jc.exact_rescore(*args, cells=cells, valid=jnp.asarray(valid[p]))
        _eq(got[p], xla, mask=valid[p])
        pal = exact_rescore_pallas(*args, valid=jnp.asarray(valid[p]),
                                   chunk=8, cells=cells, interpret=True)
        _eq(got[p], pal, mask=valid[p])
    assert got.sum() > 0


@pytest.mark.parametrize("cells", [3, 5])
@pytest.mark.parametrize("max_r", [55, 60])
def test_rescore_large_radius_vs_xla(max_r, cells):
    """Radii past the Pallas kernel's geometry (the JAX package takes its
    XLA rescore there): the port's windows of (2*max_r+2*reach+5)^2 words
    cover the whole plane and still equal XLA on the valid rows."""
    emask, sx, sy, ys, xs, valid = _rescore_inputs(max_r + cells, K=24,
                                                    H=110, W=96)
    got = rescore_cuda.exact_rescore(T(emask), T(sx), T(sy), T(ys), T(xs),
                                     T(valid), 1, max_r, cells=cells).numpy()
    assert not got[~valid].any()
    for p in range(2):
        xla = jc.exact_rescore(jnp.asarray(emask[p]), jnp.asarray(sx[p]),
                               jnp.asarray(sy[p]), jnp.asarray(ys[p]),
                               jnp.asarray(xs[p]), 1, max_r, cells=cells,
                               valid=jnp.asarray(valid[p]))
        _eq(got[p], xla, mask=valid[p])
    assert got.sum() > 0


def _radius_inputs(seed, P=2, K=24, H=90, W=104):
    rng = np.random.default_rng(seed)
    emask = rng.random((P, H, W)) < 0.1
    yy, xx = np.mgrid[0:H, 0:W]
    for (ry, rx, rr) in ((30, 30, 11), (60, 70, 23), (45, 52, 5)):
        emask[:, np.abs(np.hypot(yy - ry, xx - rx) - rr) < 0.6] = True
    ys = rng.integers(0, H, (P, K))
    xs = rng.integers(0, W, (P, K))
    ys[:, :3], xs[:, :3] = (30, 60, 45), (30, 70, 52)
    want = np.arange(K)[None, :] < np.array([[K - 5], [10]])
    return emask, ys, xs, want


def test_radius_plain_vs_xla_and_pallas():
    emask, ys, xs, want = _radius_inputs(9)
    r, s = radius_cuda.radius_support_pool(T(emask), T(ys), T(xs), T(want), 1, 30)
    args = (jnp.asarray(emask), jnp.asarray(ys), jnp.asarray(xs),
            jnp.asarray(want), 1, 30)
    xr, xs_ = jc.radius_support_pool(*args, chunk=8)
    _eq(r, xr)
    _eq(s, xs_)
    pr, ps = radius_support_pallas(*args, interpret=True)
    _eq(r, pr)
    _eq(s, ps)
    assert float(s.max()) > 30


def test_hist10_scan_rounding():
    """The run scan over seeded histograms with ties: the port's fused
    multiply-add run radius and comparisons equal XLA's bit for bit."""
    rng = np.random.default_rng(4)
    counts = (rng.random((4000, 290)) < 0.15) * rng.integers(0, 4, (4000, 290))
    counts[:500] = 0
    counts[500:1000, rng.integers(0, 290, 500)] = 1
    counts = counts.astype(np.float32)
    for min_r in (1, 2, 7):
        wr, wc = jax.jit(lambda c: jc._hist10_scan(c, min_r))(jnp.asarray(counts))
        gr, gc = radius_cuda._hist10_scan(T(counts), min_r)
        _eq(gr, wr)
        _eq(gc, wc)


def _k3_window_walk(buf, at0, spans, bmap, cy, cx, H, W, max_r, nbins):
    """K3's window walk in numpy: the plane's bytes start at buf[at0] (its
    alignment), each row's spans are clipped to the plane, and the aligned
    16-byte chunks that cover them are read whole, bytes outside the spans
    masked. Returns (set of (y, x) read inside the spans, histogram)."""
    win = 2 * max_r + 1
    nch = (win + 14) // 16 + 1
    seen, hist = set(), np.zeros(nbins, np.int64)
    for u in range(win):
        yy = cy - max_r + u
        if yy < 0 or yy >= H:
            continue
        a0, b0 = max(cx + spans[u, 0], 0), min(cx + spans[u, 1], W - 1)
        a1, b1 = max(cx + spans[u, 2], 0), min(cx + spans[u, 3], W - 1)
        e0, e1 = a0 <= b0, a1 <= b1
        if not (e0 or e1):
            continue
        lo, hi = (a0 if e0 else a1), (b1 if e1 else b0)
        at = at0 + yy * W + lo
        for c in range(nch):
            chunk = (at & ~15) + 16 * c
            if chunk > at + hi - lo:
                continue
            x = lo + chunk - at + np.arange(16)
            ins = ((x >= a0) & (x <= b0)) | ((x >= a1) & (x <= b1))
            assert ((x[ins] >= 0) & (x[ins] < W)).all()
            seen.update((yy, int(v)) for v in x[ins])
            edge = x[ins & (buf[chunk:chunk + 16] & 1 != 0)]
            np.add.at(hist, bmap[u * win + edge - cx + max_r], 1)
    return seen, hist


@pytest.mark.parametrize("radii", [(1, 30), (1, 60), (5, 44)])
def test_k3_bin_map_equals_onehot(radii):
    """K3's bin map, built without the one-hot, is the one-hot's column of
    each annulus offset and -1 elsewhere."""
    onehot, win, nbins = radius_cuda._hist10_tables(*radii)
    bmap, win_b, nbins_b = radius_cuda._bin_map(*radii)
    want = np.where(onehot.sum(axis=1) > 0, onehot.argmax(axis=1), -1)
    assert (win_b, nbins_b) == (win, nbins)
    np.testing.assert_array_equal(bmap, want)


@pytest.mark.parametrize("radii", [(1, 30), (1, 60), (5, 44), (1, 120)])
def test_k3_row_spans(radii):
    """K3's row-span table covers exactly the bin map's annulus, and the
    kernel's clipping and aligned chunk reads keep exactly the in-plane
    annulus pixels of windows at the four corners and the middle of a 40x50
    plane, at every alignment of the plane's first byte, with the
    histogram of a direct count."""
    min_r, max_r = radii
    bmap, win, nbins = radius_cuda._bin_map(min_r, max_r)
    spans = radius_cuda._row_spans(min_r, max_r)
    ann = bmap.reshape(win, win) >= 0
    dx = np.arange(win) - max_r
    covered = (((dx >= spans[:, :1]) & (dx <= spans[:, 1:2]))
               | ((dx >= spans[:, 2:3]) & (dx <= spans[:, 3:4])))
    np.testing.assert_array_equal(covered, ann)
    two = spans[:, 2] <= spans[:, 3]  # rows through the hole: left run first
    assert two.any() and (spans[two, 1] + 1 < spans[two, 2]).all()
    H, W = 40, 50
    emask = np.random.default_rng(max_r).random((H, W)) < 0.3
    du, dv = np.nonzero(ann)
    for at0 in (0, 1, 7, 15):
        buf = np.zeros(at0 + H * W + 32, np.uint8)
        buf[at0:at0 + H * W] = emask.ravel()
        for cy, cx in ((0, 0), (0, W - 1), (H - 1, 0), (H - 1, W - 1),
                       (H // 2, W // 2)):
            yy, xx = cy - max_r + du, cx - max_r + dv
            inp = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            want_hist = np.zeros(nbins, np.int64)
            edge = inp.copy()
            edge[inp] = emask[yy[inp], xx[inp]]
            np.add.at(want_hist, bmap[du[edge] * win + dv[edge]], 1)
            seen, hist = _k3_window_walk(buf, at0, spans, bmap, cy, cx, H, W,
                                         max_r, nbins)
            assert seen == set(zip(yy[inp].tolist(), xx[inp].tolist()))
            np.testing.assert_array_equal(hist, want_hist)
            assert hist.sum() > 0


def _k3_scan(hist, min_r):
    """K3's warp-parallel run scan in numpy, lane by lane: each of 32 lanes
    owns ceil(nbins/32) contiguous bins; the integer prefix comes from the
    lanes' sums and their scan and is then converted to float32, and the
    table of the highest nonempty bin in [1, b] from the lanes' own highest
    and their max-scan. Each anchor is that table at j. The run radius is
    rounded as the plain version rounds it."""
    f32 = np.float32
    hist = np.asarray(hist, np.int64)
    nbins = hist.size
    per = (nbins + 31) // 32
    lanes = [(min(lane * per, nbins), min(lane * per + per, nbins))
             for lane in range(32)]
    own = [int(hist[b0:b1].sum()) for b0, b1 in lanes]
    own_top = [max([b for b in range(b0, b1) if b >= 1 and hist[b] > 0],
                   default=-1) for b0, b1 in lanes]
    sums, highs = np.cumsum(own), np.maximum.accumulate(own_top)
    prefix = np.zeros(nbins, np.int64)
    top = np.zeros(nbins, np.int64)
    for lane, (b0, b1) in enumerate(lanes):
        run, above = sums[lane] - own[lane], highs[lane - 1] if lane else -1
        for b in range(b0, b1):
            run += hist[b]
            above = b if b >= 1 and hist[b] > 0 else above
            prefix[b], top[b] = run, above
    csum = prefix.astype(np.float32)

    j, r_best, max_count = nbins - 1, f32(0), f32(0)
    for _ in range((nbins - 2) // 11 + 1):
        anchor = int(top[j]) if j >= 1 else -1
        if anchor < 0:
            break
        j_after = max(anchor - 10, -1)
        hi, lo = csum[anchor], csum[max(j_after, 0)]
        cnt = f32(hi - (lo if j_after >= 0 else f32(0)))
        r_cur = f32((anchor + j_after) * radius_cuda._RUN_SCALE + min_r)
        if (f32(cnt * r_best) >= f32(max_count * r_cur)) or (
                r_best < f32(1.19e-7) and cnt >= max_count):
            r_best, max_count = r_cur, cnt
        j = anchor - 11
    return r_best, max_count


def _k3_scan_cases():
    rng = np.random.default_rng(17)
    cases = {}
    for nbins in (290, 590):
        dens = rng.uniform(0.005, 0.3, (150, 1))
        h = (rng.random((150, nbins)) < dens) * rng.integers(1, 7, (150, nbins))
        cases[f"random{nbins}"] = (h, (1, 2, 7))
    one = lambda bins, v: np.bincount(bins, v, 290)[None].astype(np.int64)
    cases["empty"] = (np.zeros((1, 290), np.int64), (1, 7))
    cases["bin0"] = (one([0], [5]), (1, 7))
    cases["one_bin"] = (one([137], [3]), (1, 7))
    cases["every_bin"] = (rng.integers(1, 4, (4, 290)), (1, 7))
    # bin 240 is j_after of the run at 250 (neither counted nor an anchor);
    # 239 is the next anchor, 11 below
    cases["runs_10_11"] = (np.stack([
        one([250, 240], [2, 4]), one([250, 239], [2, 4]),
        one([250, 240, 239, 228], [1, 1, 5, 9])])[:, 0], (1, 7))
    # at min_r 1 the runs anchored at 35 and 15 have radii 4.0 and 2.0, so
    # counts 2 and 1 tie: 1 * 4.0 == 2 * 2.0, and the later run wins
    cases["tie"] = (one([35, 15], [2, 1]), (1,))
    return cases


_K3_SCAN_CASES = _k3_scan_cases()


@pytest.mark.parametrize("case", sorted(_K3_SCAN_CASES))
def test_k3_scan_decomposition_equals_plain(case):
    """The numpy emulation of K3's warp scan (lane-split integer prefix and
    highest-nonempty-bin table) equals _hist10_scan bit for bit on seeded
    histograms at 290 and 590 bins and on hand-made ones."""
    hists, min_rs = _K3_SCAN_CASES[case]
    for min_r in min_rs:
        want_r, want_c = radius_cuda._hist10_scan(
            torch.from_numpy(hists.astype(np.float32)), min_r)
        got = [_k3_scan(h, min_r) for h in hists]
        _eq(np.array([g[0] for g in got], np.float32), want_r.numpy())
        _eq(np.array([g[1] for g in got], np.float32), want_c.numpy())
    if case == "tie":
        np.testing.assert_array_equal(want_r.numpy(), [2.0])
        np.testing.assert_array_equal(want_c.numpy(), [1.0])
    if case in ("empty", "bin0"):
        assert not want_r.any() and not want_c.any()


@pytest.fixture(scope="module")
def patches():
    emask, sx, sy, ys, xs, valid = _rescore_inputs(21, K=48)
    patch = rescore_cuda.exact_rescore(T(emask), T(sx), T(sy), T(ys), T(xs),
                                       T(valid), 1, 30, cells=5)
    return patch.numpy(), ys, xs, valid


def test_circle_recentre(patches):
    patch, ys, xs, valid = patches
    got = tc.circle_recentre(T(patch), T(ys), T(xs), T(valid), 6.0, 72, 80)
    for p in range(2):
        want = jc.circle_recentre(jnp.asarray(patch[p]), jnp.asarray(ys[p]),
                                  jnp.asarray(xs[p]), jnp.asarray(valid[p]),
                                  6.0, 72, 80)
        for g, w in zip(got, want):
            _eq(g[p], w)


@pytest.mark.parametrize("budget", [8, 256])
def test_provisional_ring(patches, budget):
    patch, ys, xs, valid = patches
    got = tc.provisional_ring(T(patch), T(ys), T(xs), T(valid), 6.0, 72, 80,
                              budget)
    for p in range(2):
        want = jc.provisional_ring(jnp.asarray(patch[p]), jnp.asarray(ys[p]),
                                   jnp.asarray(xs[p]), jnp.asarray(valid[p]),
                                   6.0, 72, 80, budget)
        ok = np.asarray(want[2])
        _eq(got[2][p], ok)
        _eq(got[3][p], want[3])
        _eq(got[0][p], want[0], mask=ok)
        _eq(got[1][p], want[1], mask=ok)
    if budget == 8:  # the exact saturation count exceeds the budget
        assert bool((got[3] > budget).any())


@pytest.mark.parametrize("dedupe_first", [False, True])
@pytest.mark.parametrize("budget", [12, 400])
def test_compact_candidates(dedupe_first, budget):
    rng = np.random.default_rng(budget)
    N = 300
    ys = rng.integers(0, 6, (2, N)).astype(np.int32)  # many duplicate cells
    xs = rng.integers(0, 5, (2, N)).astype(np.int32)
    votes = (ys * 7 + xs * 3 + 31).astype(np.float32)  # a function of the cell
    valid = rng.random((2, N)) < 0.3
    got = tc.compact_candidates(T(ys), T(xs), T(votes), T(valid), 80, budget,
                                dedupe=True, dedupe_first=dedupe_first)
    for p in range(2):
        want = jc.compact_candidates(
            jnp.asarray(ys[p]), jnp.asarray(xs[p]), jnp.asarray(votes[p]),
            jnp.asarray(valid[p]), 80, budget, dedupe=True,
            dedupe_first=dedupe_first)
        ok = np.asarray(want[3])
        _eq(got[3][p], ok)
        _eq(got[4][p], want[4])
        for g, w in zip(got[:3], want[:3]):
            _eq(g[p], w, mask=ok)
    got_nd = tc.compact_candidates(T(ys), T(xs), T(votes), T(valid), 80, budget)
    want_nd = jc.compact_candidates(jnp.asarray(ys[0]), jnp.asarray(xs[0]),
                                    jnp.asarray(votes[0]), jnp.asarray(valid[0]),
                                    80, budget)
    for g, w in zip(got_nd, want_nd):
        _eq(g[0], w)


@pytest.mark.parametrize("dedupe_first", [False, True])
@pytest.mark.parametrize("budgets", [(4, 16), (1024, 2048)])
def test_circle_candidates_and_flags(dedupe_first, budgets):
    """Stages 2a-2c with the saturation flag that decides the overflow rerun
    (ring over its budget, or unique peaks over theirs)."""
    prov, peak = budgets
    emask, sx, sy, ys, xs, valid = _rescore_inputs(33, K=48)
    got = tc.circle_candidates(T(emask), T(sx), T(sy), T(ys), T(xs), T(valid),
                               1, 30, 6.0, 72, 80, prov_budget=prov,
                               peak_budget=peak, dedupe_first=dedupe_first)
    sats = []
    for p in range(2):
        want = jax.jit(lambda e, a, b, y, x, v: jc.circle_candidates(
            e, a, b, y, x, v, 1, 30, 6.0, 72, 80, prov_budget=prov,
            peak_budget=peak, dedupe_first=dedupe_first))(
            emask[p], sx[p], sy[p], ys[p], xs[p], valid[p])
        ok = np.asarray(want[3])
        _eq(got[3][p], ok)
        _eq(got[4][p], want[4])
        for g, w in zip(got[:3], want[:3]):
            _eq(g[p], w, mask=ok)
        sats.append(bool(want[4]))
    assert any(sats) == (prov == 4)


@pytest.mark.parametrize("packed_sort", [True, False])
def test_circle_finalize(packed_sort):
    rng = np.random.default_rng(13)
    P, K = 2, 96
    ys = rng.integers(0, 60, (P, K)).astype(np.int32)
    xs = rng.integers(0, 60, (P, K)).astype(np.int32)
    r = (rng.integers(2, 8, (P, K)) * 2.5).astype(np.float32)
    support = rng.integers(28, 36, (P, K)).astype(np.float32)
    valid = rng.random((P, K)) < 0.85
    got_c, got_v = tc.circle_finalize(T(ys), T(xs), T(valid), T(r), T(support),
                                      30.0, 10.0, 40, packed_sort=packed_sort)
    for p in range(P):
        want_c, want_v = jax.jit(lambda *a: jc.circle_finalize(
            *a, 30.0, 10.0, 40, packed_sort=packed_sort))(
            ys[p], xs[p], valid[p], r[p], support[p])
        _eq(got_v[p], want_v)
        _eq(got_c[p], want_c)
    assert int(got_v.sum()) > 10


def test_greedy_min_dist():
    rng = np.random.default_rng(2)
    ys = rng.integers(0, 40, (3, 120)).astype(np.int32)
    xs = rng.integers(0, 40, (3, 120)).astype(np.int32)
    live = rng.random((3, 120)) < 0.7
    got = tc.greedy_min_dist(T(ys), T(xs), T(live), 10.0, 8)
    for p in range(3):
        want = jc.greedy_min_dist(jnp.asarray(ys[p]), jnp.asarray(xs[p]),
                                  jnp.asarray(live[p]), 10.0, max_out=8)
        _eq(got[p], want)


GREEDY_CASES = greedy_cases()


@pytest.mark.parametrize("case", range(len(GREEDY_CASES)),
                         ids=[c[0] for c in GREEDY_CASES])
def test_greedy_min_dist_edge_cases(case):
    """The plain version against the JAX package's greedy_min_dist (jitted
    alone, over the planes by vmap): ties at exactly min_dist, duplicates,
    more acceptances than max_out, an empty plane, live after dead, and the
    overflow rerun's K = 8192."""
    _, ys, xs, live, min_dist, max_out = GREEDY_CASES[case]
    want = jax.jit(jax.vmap(lambda y, x, lv: jc.greedy_min_dist(
        y, x, lv, min_dist, max_out=max_out)))(ys, xs, live)
    got = greedy_cuda.greedy_min_dist(T(ys), T(xs), T(live), min_dist, max_out)
    _eq(got, want)
    assert got.any(), "no case should accept nothing at all"


@pytest.mark.parametrize("geometry", ["kernel", "tiny"])
def test_greedy_kernel_walk_equals_plain(geometry):
    """The kernel's batch walk (test_torch_greedy_walk.greedy_walk) equals
    the plain version on every seeded case but K = 8192 (the JAX test above
    covers it): at the kernel's 32 candidates a batch and 8 warps, and at
    3 and 2, where a batch ends inside every run of acceptances."""
    for label, ys, xs, live, min_dist, max_out in GREEDY_CASES:
        if ys.shape[1] > 1024:
            continue
        want = greedy_cuda.greedy_min_dist_plain(T(ys), T(xs), T(live),
                                                 min_dist, max_out).numpy()
        for p in range(ys.shape[0]):
            got, _ = greedy_walk(ys[p], xs[p], live[p], min_dist, max_out,
                                 *GREEDY_GEOMETRIES[geometry])
            np.testing.assert_array_equal(got, want[p], err_msg=label)


def test_greedy_wrapper_checks():
    ys = torch.zeros((2, 5), dtype=torch.int64)
    live = torch.ones((2, 5), dtype=torch.bool)
    with pytest.raises(ValueError):
        greedy_cuda.greedy_min_dist(ys, ys, live, 10.0, 0)
    with pytest.raises(ValueError):
        greedy_cuda.greedy_min_dist(ys[:, :4], ys, live, 10.0, 8)
    with pytest.raises(TypeError):
        greedy_cuda.greedy_min_dist(ys, ys, live.int(), 10.0, 8)
    before = greedy_cuda.launches
    got = greedy_cuda.greedy_min_dist(ys, ys, live, 10.0, 8)  # the plain one
    assert greedy_cuda.launches == before
    assert got.tolist() == [[True, False, False, False, False]] * 2


def test_wrapper_checks():
    emask, sx, sy, ys, xs, valid = (T(a) for a in _rescore_inputs(1, K=4))
    with pytest.raises(ValueError):
        rescore_cuda.exact_rescore(emask, sx, sy, ys, xs, valid, 1, 30, cells=4)
    with pytest.raises(TypeError):
        rescore_cuda.exact_rescore(emask, sx.long(), sy, ys, xs, valid, 1, 30)
    with pytest.raises(ValueError):
        radius_cuda.radius_support_pool(emask, ys[:, :2], xs, valid, 1, 30)
    with pytest.raises(ValueError, match="prefix"):
        gap = valid.clone()
        gap[1, 0] = False
        rescore_cuda.exact_rescore(emask, sx, sy, ys, xs, gap, 1, 30)
    before = (rescore_cuda.launches, radius_cuda.launches)
    rescore_cuda.exact_rescore(emask, sx, sy, ys, xs, valid, 1, 30)
    radius_cuda.radius_support_pool(emask, ys, xs, valid, 1, 30)
    assert (rescore_cuda.launches, radius_cuda.launches) == before


def test_overflow_branch_equals_big_budget():
    """The Python-branch overflow rerun (_circles_pooled) gives, for every
    plane, what running the big budget directly gives: saturated planes are
    replaced by their big-budget results and the rest keep the base ones,
    which equal the big-budget results when nothing was truncated."""
    rng = np.random.default_rng(5)
    noisy = rng.integers(0, 256, (72, 72, 3)).astype(np.uint8)
    cfg = DetectionConfig(
        max_center_candidates=16, overflow_center_candidates=96,
        max_ring_candidates=16, overflow_ring_candidates=64,
        max_circles_per_variant=16, hysteresis_iters=4,
        overflow_margin_factor=0.0)
    v = tdetect._pre_circles(T(noisy)[None], cfg)[2][0]
    keep, _ = tdetect._variant_dedup(cfg, v.shape[0])
    st = tdetect._plane_state_pool(v[keep], cfg)
    _, _, sat = tdetect._circles_from_state(st, cfg, margin_filter=True)
    assert bool(sat.any()), "noise fixture no longer saturates 16 slots"
    got_c, got_v = tdetect._circles_pooled(st, cfg)
    want_c, want_v, _ = tdetect._circles_from_state(
        st, cfg, top_k=96, prov_budget=64,
        peak_budget=cfg.overflow_peak_candidates, dedupe_first=True,
        margin_filter=True)
    _eq(got_v, want_v.numpy())
    _eq(got_c, want_c.numpy())
