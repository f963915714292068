"""PyTorch port against the JAX package: Canny (colour and grey, L1 and L2),
the pooled internal Canny, and the hysteresis sweeps that kernel K1 keeps.

The staircase planes need one sweep per stair, so a cap of 1, 2 or 3 sweeps
binds: the port's plain sweeps must stop where the JAX package's do, not
only reach the same fixed point."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from img2sgf_tpu_torch.ops import hysteresis_cuda

# the ops packages re-export the canny function under the module's name
jcanny = importlib.import_module("img2sgf_tpu.ops.canny")
tcanny = importlib.import_module("img2sgf_tpu_torch.ops.canny")


def _eq(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _scene(seed, size=96):
    """Seeded greyscale scene with lines, discs and noise, as [H, W, 3]."""
    rng = np.random.default_rng(seed)
    img = np.full((size, size), 200.0)
    yy, xx = np.mgrid[0:size, 0:size]
    for _ in range(6):
        cy, cx, r = rng.integers(10, size - 10, 2).tolist() + [rng.integers(4, 14)]
        img[np.hypot(yy - cy, xx - cx) < r] = rng.integers(0, 256)
    for c in rng.integers(5, size - 5, 4):
        img[c, :] = 20
        img[:, c] = 20
    img += rng.normal(0, 12, img.shape)
    rgb = np.clip(np.stack([img, img * 0.9 + 10, img[::-1] * 0.5 + 60], -1),
                  0, 255)
    return rgb.astype(np.uint8)


def staircase(seed, H=64, W=96):
    """(strong, cand) planes needing one hysteresis sweep per stair: runs of
    1-3 pixels, each one diagonal hop below the previous, seeded at the
    first pixel, plus seeded candidate noise."""
    rng = np.random.default_rng(seed)
    cand = rng.random((H, W)) < 0.03
    cand[:, W // 2 - 2:W // 2 + 2] = False
    strong = np.zeros((H, W), bool)
    for start in (0, W // 2 + 2):
        y, x = 0, start
        strong[y, x] = True
        while y < H and x < start + W // 2 - 4:
            n = int(rng.integers(1, 4))
            cand[y, x:x + n] = True
            if y + 1 < H:
                cand[y + 1, x:x + n] = False
            x += n
            y += 1
    strong |= rng.random((H, W)) < 0.002
    return strong & cand, cand


@pytest.mark.parametrize("l2", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_canny_rgb(seed, l2):
    img = _scene(seed)
    want = jax.jit(lambda im: jcanny.canny(im, 50.0, 200.0, l2, iters=256))(
        jnp.asarray(img))
    _eq(tcanny.canny(torch.from_numpy(img), 50.0, 200.0, l2, iters=256), want)


def test_canny_grey():
    img = _scene(2)[..., 0]
    want = jax.jit(lambda im: jcanny.canny(im, 50.0, 100.0, iters=256))(
        jnp.asarray(img))
    _eq(tcanny.canny(torch.from_numpy(img), 50.0, 100.0, iters=256), want)


@pytest.mark.parametrize("iters", [2, 256])
def test_canny_pool_8_planes(iters):
    planes = np.stack([_scene(10 + i)[..., i % 3] for i in range(8)])
    want = jax.jit(lambda p: jcanny.canny_pool(p, 50.0, 100.0, iters=iters))(
        jnp.asarray(planes))
    got = tcanny.canny_pool(torch.from_numpy(planes), 50.0, 100.0, iters=iters)
    _eq(got, want)
    # the pool equals per-plane Canny (shared sweeps do not couple planes)
    for i in (0, 5):
        _eq(got[i], jax.jit(lambda p: jcanny.canny(p, 50.0, 100.0, iters=iters))(
            jnp.asarray(planes[i])))


@pytest.mark.parametrize("iters", [1, 2, 3, 256])
def test_plain_hysteresis_sweeps(iters):
    strong, cand = staircase(3)
    want = jax.jit(lambda s, c: jcanny.hysteresis(s, c, iters))(
        jnp.asarray(strong), jnp.asarray(cand))
    got = tcanny.hysteresis(torch.from_numpy(strong), torch.from_numpy(cand),
                            iters)
    _eq(got, want)
    if iters < 256:  # the cap binds: fewer sweeps give fewer edges
        full = tcanny.hysteresis(torch.from_numpy(strong),
                                 torch.from_numpy(cand), 256)
        assert int(got.sum()) < int(full.sum())


@pytest.mark.parametrize("iters", [1, 3, 256])
def test_plain_hysteresis_pool_sweeps(iters):
    pairs = [staircase(20 + i) for i in range(8)]
    strong = np.stack([s for s, _ in pairs])
    cand = np.stack([c for _, c in pairs])
    want = jax.jit(lambda s, c: jcanny.hysteresis_pool(s, c, iters))(
        jnp.asarray(strong), jnp.asarray(cand))
    got = tcanny.hysteresis_pool(torch.from_numpy(strong),
                                 torch.from_numpy(cand), iters)
    _eq(got, want)


def _scan_lanes(a, g, up):
    """A warp's shuffle scan over the last axis (32 lanes), as scan_up /
    scan_down in csrc/hysteresis.cu: log-step (a, g) composition."""
    a, g = a.copy(), g.copy()
    d = 1
    while d < 32:
        a0, g0 = a.copy(), g.copy()
        if up:
            a[..., d:] |= g0[..., d:] & a0[..., :-d]
            g[..., d:] &= g0[..., :-d]
        else:
            a[..., :-d] |= g0[..., :-d] & a0[..., d:]
            g[..., :-d] &= g0[..., d:]
        d *= 2
    return a, g


def _seq_fill(a, g, carry, forward):
    """f[i] = a[i] | g[i] & f[i -+ 1] along the last axis from `carry`."""
    out = np.empty_like(a)
    order = range(a.shape[-1]) if forward else reversed(range(a.shape[-1]))
    for k in order:
        carry = a[..., k] | (g[..., k] & carry)
        out[..., k] = carry
    return out


def _fill_lanes(a, g, carry, forward):
    """fill_fwd / fill_bwd of csrc/hysteresis.cu on [..., 32 lanes, words]:
    each lane scans its own words, a warp scan of the lane summaries gives
    each lane its carry, a second pass fills. Returns (fill, outgoing
    carry)."""
    zero = np.zeros(a.shape[:-1], np.int32)
    x, y = _scan_lanes(_seq_fill(a, g, zero, forward)[..., -1 if forward else 0],
                       np.bitwise_and.reduce(g, axis=-1), forward)
    c = carry[..., None]
    cin = np.empty_like(x)
    if forward:
        cin[..., 0], cin[..., 1:] = carry, x[..., :-1] | (y[..., :-1] & c)
    else:
        cin[..., -1], cin[..., :-1] = carry, x[..., 1:] | (y[..., 1:] & c)
    out = _seq_fill(a, g, cin, forward)
    edge = -1 if forward else 0
    return out, x[..., edge] | (y[..., edge] & carry)


def _compose(ff, bb, ga):
    """Carries into each unit of the last axis from the units' summaries."""
    n = ff.shape[-1]
    cf, cb = np.zeros_like(ff), np.zeros_like(bb)
    for j in range(1, n):
        cf[..., j] = ff[..., j - 1] | (ga[..., j - 1] & cf[..., j - 1])
    for j in range(n - 2, -1, -1):
        cb[..., j] = bb[..., j + 1] | (ga[..., j + 1] & cb[..., j + 1])
    return cf, cb


def _k1_row_fill(src, gate, per_lane):
    """K1's row phase: segments of 32 lanes x per_lane words, segment
    summaries, composed carries, forward then backward fill."""
    G, H, W = src.shape
    seg = 32 * per_lane
    nseg = -(-W // seg)
    pad = ((0, 0), (0, 0), (0, nseg * seg - W))
    shape = (G, H, nseg, 32, per_lane)
    a = np.pad(src, pad).reshape(shape)
    g = np.pad(gate, pad).reshape(shape)
    zero = np.zeros(shape[:3], np.int32)
    f, ff = _fill_lanes(a, g, zero, True)
    _, bb = _fill_lanes(f, g, zero, False)
    ga = np.bitwise_and.reduce(g.reshape(G, H, nseg, -1), axis=-1)
    cf, cb = _compose(ff, bb, ga)
    out = _fill_lanes(_fill_lanes(a, g, cf, True)[0], g, cb, False)[0]
    return out.reshape(G, H, -1)[..., :W]


def _k1_col_dilate(t, gate, band):
    """K1's column phase fused with the gated dilation: band summaries and
    composed carries; for the dilation, the row above a band is its forward
    carry and the row below its backward carry. Returns the new words."""
    G, H, W = t.shape
    nb = -(-H // band)
    pad = ((0, 0), (0, nb * band - H), (0, 0))
    a = np.moveaxis(np.pad(t, pad).reshape(G, nb, band, W), 2, -1)
    g = np.moveaxis(np.pad(gate, pad).reshape(G, nb, band, W), 2, -1)
    zero = np.zeros((G, nb, W), np.int32)
    cf, cb = (np.moveaxis(c, -1, 1) for c in _compose(
        np.moveaxis(_seq_fill(a, g, zero, True)[..., -1], 1, -1),
        np.moveaxis(_seq_fill(a, g, zero, False)[..., 0], 1, -1),
        np.moveaxis(np.bitwise_and.reduce(g, axis=-1), 1, -1)))
    tb = _seq_fill(_seq_fill(a, g, cf, True), g, cb, False)
    rows = np.concatenate([cf[..., None], tb, cb[..., None]], -1)
    hor = rows.copy()
    hor[:, :, 1:] |= rows[:, :, :-1]
    hor[:, :, :-1] |= rows[:, :, 1:]
    new = ((hor[..., :-2] | hor[..., 1:-1] | hor[..., 2:]) & g) | tb
    return np.moveaxis(new, -1, 2).reshape(G, -1, W)[:, :H]


def k1_emulate(edge0, gate, iters, per_lane, band):
    """numpy emulation of K1's decomposition (csrc/hysteresis.cu); returns
    (words, sweeps)."""
    edge = edge0
    for s in range(iters):
        new = _k1_col_dilate(_k1_row_fill(edge, gate, per_lane), gate, band)
        changed = bool((new != edge).any())
        edge = new
        if not changed:
            return edge, s + 1
    return edge, iters


@pytest.mark.parametrize("geometry", [(32, 32), (2, 4)])
@pytest.mark.parametrize("iters", [1, 2, 3, 256])
def test_k1_decomposition_equals_plain(iters, geometry):
    """K1's segment/band decomposition with composed carries equals the
    plain sweeps, sweep count included: the kernel's own segments (32 lanes
    x 32 words) and bands (32 rows), and small ones that split every line
    into many parts."""
    per_lane, band = geometry
    stairs = [staircase(40 + i, H=70, W=150) for i in range(5)]
    rng = np.random.default_rng(iters)
    cand = rng.random((70, 150)) < 0.45
    strong = cand & (rng.random(cand.shape) < 0.01)
    # full-length runs seeded at either end: one sweep fills each through
    # every segment and band, in both directions
    lines = np.zeros((70, 150), bool)
    lines[:, [3, 77]] = lines[[5, 60], :] = True
    lines[30:40, 3] = lines[5, 100:110] = False
    seeds = np.zeros_like(lines)
    seeds[[0, 69], [3, 77]] = seeds[[5, 60], [149, 0]] = True
    planes = [(s, c) for s, c in stairs] + [(strong, cand), (seeds, lines)]
    e0 = tcanny.pack_planes(torch.from_numpy(np.stack([s & c for s, c in planes])))
    gate = tcanny.pack_planes(torch.from_numpy(np.stack([c for _, c in planes])))
    want = hysteresis_cuda.hysteresis_packed_plain(e0, gate, iters)
    want_sweeps = hysteresis_cuda.last_sweeps()
    got, sweeps = k1_emulate(e0.numpy(), gate.numpy(), iters, per_lane, band)
    np.testing.assert_array_equal(got, want.numpy())
    assert sweeps == want_sweeps
    if iters == 256:
        assert 3 < sweeps < 256


def test_pack_unpack_round_trip():
    x = np.random.default_rng(5).random((40, 7, 9)) < 0.5
    words = tcanny.pack_planes(torch.from_numpy(x))
    assert words.shape == (2, 7, 9) and words.dtype == torch.int32
    _eq(tcanny.unpack_planes(words, 40), x)


def test_k1_wrapper_checks():
    e = torch.zeros((1, 8, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        hysteresis_cuda.hysteresis_packed(e.long(), e.long(), 3)
    with pytest.raises(ValueError):
        hysteresis_cuda.hysteresis_packed(e, e[0], 3)
    before = hysteresis_cuda.launches
    hysteresis_cuda.hysteresis_packed(e, e, 3)  # CPU: the plain version
    assert hysteresis_cuda.launches == before
