"""Kernel A's module (img2sgf_tpu_torch/hough/accumulator_cuda.py) on the
CPU: the offset table (vote_table) against both plain accumulators, a numpy
emulation of the kernel's tile walk against them, the port's pooled
accumulator against the JAX package's packed4 lax.map, and the argument
checks. The kernel itself is held against its plain versions on the card
by tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

from test_torch_pipeline import cap_torch_threads

from img2sgf_tpu_torch.hough import accumulator_cuda as acc
from img2sgf_tpu_torch.hough import circles as tc

cap_torch_threads()

T = torch.from_numpy

# (num_bins, min_r, max_r): cascades (spans divisible by 5) first, then
# per-offset spans
TABLE_CASES = [(64, 1, 30), (64, 0, 29), (48, 1, 30), (63, 1, 30),
               (254, 1, 30), (64, 1, 31), (64, 3, 19)]


def _labels(seed, shape, num_bins, density=0.08):
    """Seeded sparse labels: edge pixels of random bins, the num_bins
    sentinel elsewhere."""
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, num_bins, shape).astype(np.uint8)
    lab[rng.random(shape) >= density] = num_bins
    return lab


def _plain(lab, num_bins, min_r, max_r):
    if (max_r - min_r + 1) % 5:
        return acc.vote_accumulator_offsets(T(lab), num_bins, min_r, max_r)
    return acc.vote_accumulator_cascade_labels(T(lab), num_bins, min_r, max_r)


def _scatter(lab, num_bins, table):
    """The accumulator as a plain scatter from the table: each edge pixel q
    of bin d adds w at q + (dy, dx) inside the plane."""
    start, ent, _ = table
    P, H, W = lab.shape
    out = np.zeros((P, H, W), np.int64)
    for d in range(num_bins):
        p, y, x = np.nonzero(lab == d)
        for dy, dx, w in ent[:, start[d]:start[d + 1]].T:
            ty, tx = y + dy, x + dx
            ok = (ty >= 0) & (ty < H) & (tx >= 0) & (tx < W)
            np.add.at(out, (p[ok], ty[ok], tx[ok]), w)
    return out


@pytest.mark.parametrize("case", TABLE_CASES, ids=str)
def test_table_scatter_equals_plain(case):
    """A scatter from vote_table equals the plain cascade (spans divisible
    by 5) or the plain per-offset sums, exactly; q votes at q + o."""
    nb, lo, hi = case
    lab = _labels(sum(case), (2, 37, 45), nb)
    want = _plain(lab, nb, lo, hi)
    got = _scatter(lab, nb, acc.vote_table(nb, lo, hi))
    assert want.dtype == torch.float32
    np.testing.assert_array_equal(got, want.numpy().astype(np.int64))
    assert got.max() > 3


def test_table_sign_of_a_single_pixel():
    """One edge pixel of bin 0 (the +x direction) votes along its row at
    x + o: the accumulator is the table's row for bin 0, shifted to q."""
    lab = np.full((1, 9, 81), 64, np.uint8)
    lab[0, 4, 40] = 0
    start, ent, _ = acc.vote_table(64, 1, 30)
    got = _plain(lab, 64, 1, 30).numpy()
    row = ent[:, start[0]:start[1]]
    assert (row[0] == 0).all()
    want = np.zeros((9, 81), np.float32)
    want[4, 40 + row[1]] = row[2]
    np.testing.assert_array_equal(got[0], want)
    assert got[0, 4, 70] > 0 and got[0, 4, 10] > 0  # r = 30 both ways


@pytest.mark.parametrize("case", TABLE_CASES, ids=str)
def test_table_invariants(case):
    """Each bin's weights sum to the votes per edge pixel, 2 * n_r; its
    offsets are distinct; halo is the largest |offset|; the default table
    has 36-60 entries a bin, 3,616 in all."""
    nb, lo, hi = case
    start, ent, halo = acc.vote_table(nb, lo, hi)
    assert start.shape == (nb + 1,) and start[0] == 0
    assert ent.shape == (3, start[-1]) and ent.dtype == np.int32
    for d in range(nb):
        dy, dx, w = ent[:, start[d]:start[d + 1]]
        assert w.sum() == 2 * (hi - lo + 1) and (w > 0).all()
        assert len(set(zip(dy.tolist(), dx.tolist()))) == len(w)
    assert halo == np.abs(ent[:2]).max()
    assert not ent.flags.writeable
    if case == (64, 1, 30):
        counts = np.diff(start)
        assert (start[-1], counts.min(), counts.max(), halo) == (3616, 36, 60, 30)


def _emulate(lab, num_bins, table, tile=(8, 16), threads=16, cap=40):
    """The kernel's walk in numpy, at a small tile: per (plane, tile), the
    window (the tile grown by the halo, clipped to the plane) scanned
    `threads` pixels a step; edge pixels staged in a list of `cap` that is
    walked when the next step could overflow it or the window ends; each
    staged pixel's entries added where they land in the tile."""
    start, ent, halo = table
    P, H, W = lab.shape
    th_, tw_ = tile
    out = np.full((P, H, W), -1, np.int64)
    for p in range(P):
        for ty0 in range(0, H, th_):
            for tx0 in range(0, W, tw_):
                th, tw = min(th_, H - ty0), min(tw_, W - tx0)
                cnt = np.zeros((th_, tw_), np.int64)
                wy0, wy1 = max(ty0 - halo, 0), min(ty0 + th + halo, H)
                wx0 = max(tx0 - halo, 0)
                ww = min(tx0 + tw + halo, W) - wx0
                wn = (wy1 - wy0) * ww
                staged = []
                for base in range(0, wn, threads):
                    for i in range(base, min(base + threads, wn)):
                        y, x = wy0 + i // ww, wx0 + i % ww
                        if lab[p, y, x] < num_bins:
                            staged.append((y - ty0, x - tx0, lab[p, y, x]))
                    assert len(staged) <= cap
                    if len(staged) > cap - threads or base + threads >= wn:
                        for ry, rx, b in staged:
                            for dy, dx, w in ent[:, start[b]:start[b + 1]].T:
                                yy, xx = ry + dy, rx + dx
                                if 0 <= yy < th and 0 <= xx < tw:
                                    cnt[yy, xx] += w
                        staged = []
                out[p, ty0:ty0 + th, tx0:tx0 + tw] = cnt[:th, :tw]
    return out


@pytest.mark.parametrize("case", [
    ((64, 1, 30), (2, 37, 45), 0.08),   # halo past the plane
    ((64, 1, 6), (3, 21, 35), 0.15),    # tiles cut at both edges
    ((64, 3, 19), (1, 24, 40), 0.10),   # per-offset
    ((16, 1, 5), (1, 20, 33), 1.0),     # every pixel an edge
], ids=str)
def test_kernel_walk_equals_plain(case):
    """The emulated tile walk of kernel A equals the plain version."""
    (nb, lo, hi), shape, density = case
    lab = _labels(hi, shape, nb, density)
    if density == 1.0:
        lab[:] = 3  # all one bin
    got = _emulate(lab, nb, acc.vote_table(nb, lo, hi))
    np.testing.assert_array_equal(
        got, _plain(lab, nb, lo, hi).numpy().astype(np.int64))


def test_pool_equals_jax_packed4():
    """The port's vote_accumulator_pool_labels equals the JAX package's (the
    packed4 lax.map) on a seeded pool of 5 planes, which JAX pads to 8."""
    import jax.numpy as jnp

    from img2sgf_tpu.hough import circles as jc

    lab = _labels(5, (5, 40, 52), 64, 0.1)
    want = np.asarray(jc.vote_accumulator_pool_labels(jnp.asarray(lab), 64, 1, 30))
    before = acc.plain_calls
    got = tc.vote_accumulator_pool_labels(T(lab), 64, 1, 30)
    assert acc.plain_calls == before + 1
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() > 3


def test_argument_checks_raise():
    """Labels that are not uint8 or not [P, H, W], num_bins outside 1-254,
    CPU labels given to the kernel's wrapper, a device that is neither CPU
    nor CUDA, and inputs on several devices: each raises, and no kernel
    launches."""
    lab = T(_labels(0, (2, 9, 11), 64))
    before = acc.launches
    with pytest.raises(TypeError):
        tc.vote_accumulator_pool_labels(lab.to(torch.int32), 64, 1, 30)
    with pytest.raises(TypeError):
        acc.vote_accumulator_cuda(lab.to(torch.int32), 64, 1, 30)
    with pytest.raises(ValueError):
        tc.vote_accumulator_pool_labels(lab[0], 64, 1, 30)
    with pytest.raises(ValueError):
        acc.vote_accumulator_cuda(lab[None], 64, 1, 30)
    with pytest.raises(ValueError):
        tc.vote_accumulator_pool_labels(lab, 255, 1, 30)
    with pytest.raises(ValueError):
        acc.vote_accumulator_cuda(lab, 64, 1, 30)  # CPU labels
    with pytest.raises(ValueError):
        tc.vote_accumulator_pool_labels(lab.to("meta"), 64, 1, 30)
    em = torch.ones((1, 9, 11), dtype=torch.bool)
    d = torch.ones((1, 9, 11), dtype=torch.int32)
    with pytest.raises(ValueError, match="several devices"):
        tc.vote_accumulator_pool(em, d, d.to("meta"), 64, 1, 30)
    assert acc.launches == before
