"""Kernel G's walk (img2sgf_tpu_torch/csrc/greedy.cu) on the CPU: a numpy
emulation of the kernel's batch decomposition held equal to the plain
version (hough/greedy_cuda.py greedy_min_dist_plain), and the plain version
to the JAX package's greedy_min_dist, on seeded edge cases. The kernel itself is held against
the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py."""

import collections

import jax
import numpy as np
import pytest
import torch

from img2sgf_tpu.hough import circles as jc
from img2sgf_tpu_torch.hough import greedy_cuda

T = torch.from_numpy

# (candidates a batch, warps of the block): the kernel's, and small ones
# under which a batch ends inside every run of acceptances and each warp
# tests a share of several slots
GEOMETRIES = {"kernel": (32, 8), "small": (4, 3), "tiny": (3, 2)}


def _clash(a, f, md2):
    """Whether stored positions a [n, 2] lie closer than min_dist to f, in
    the kernel's float32 operations."""
    dy = a[:, 0] - f[0]
    dx = a[:, 1] - f[1]
    return dy * dy + dx * dx < md2


def greedy_walk(ys, xs, live, min_dist, max_out, batch, warps):
    """numpy emulation of csrc/greedy.cu over one plane: the live length
    (last live index + 1); candidates `batch` at a time, each tested at
    once against the stored prefix alone (slot s by warp s % warps, the
    results ORed) and against the batch's earlier candidates (candidate j
    by warp j % warps); then the batch decided in order with masks alone: a
    candidate is taken iff it is live, clashes with no stored position and
    with no earlier candidate of the batch that was taken and stored;
    taken ones are stored in order while fewer than max_out are. Returns
    (accepted, counts of what the walk met)."""
    K = live.shape[0]
    md2 = np.float32(greedy_cuda._md2(min_dist))
    stored = np.zeros((0, 2), np.float32)
    n_live = max((i + 1 for i in range(K) if live[i]), default=0)
    out = np.zeros(K, bool)
    met = collections.Counter()
    for base in range(0, n_live, batch):
        idx = base + np.arange(batch)
        lv = (idx < n_live) & live[np.minimum(idx, K - 1)]
        cand = np.where(lv[:, None], np.stack(
            [ys[np.minimum(idx, K - 1)], xs[np.minimum(idx, K - 1)]], 1),
            0).astype(np.float32)
        pre = np.zeros(batch, bool)
        for w in range(warps):
            share = stored[w::warps]
            pre |= [_clash(share, f, md2).any() for f in cand]
        conf = np.zeros(batch, np.int64)
        for c in range(batch):
            for j in range(c):  # candidate j by warp j % warps
                if _clash(cand[j:j + 1], cand[c], md2)[0]:
                    conf[c] |= 1 << j
        todo = lv & ~pre
        take = store = 0
        n_stored = len(stored)
        for k in range(batch):
            if todo[k] and not conf[k] & store:
                take |= 1 << k
                if n_stored < max_out:
                    store |= 1 << k
                    n_stored += 1
        met["blocked by the batch"] += sum(
            bool(todo[k] and (conf[k] & store)) for k in range(batch))
        for k in range(batch):
            if base + k < n_live:
                out[base + k] = take >> k & 1
        keep = [k for k in range(batch) if store >> k & 1]
        stored = np.concatenate([stored, cand[keep]])
        met["batches"] += 1
    met["past max_out"] += int(out.sum()) - len(stored)
    met["stored"] = len(stored)
    return out, met


def walk_cases():
    """Seeded [P, K] inputs at the walk's edges, as numpy (label, ys, xs,
    live, min_dist, max_out): pairs at exactly min_dist beside pairs just
    inside it; dead candidates interleaved with live ones; live runs that
    are not a prefix; more acceptances than max_out, with later duplicates
    of the unstored ones; min_dist 0, where duplicates do not clash."""
    rng = np.random.default_rng(17)
    cases = []
    # (6, 8) and (0, 10) lie exactly 10 away, (5, 8) and (0, 9) closer
    base = rng.integers(0, 15, (2, 20, 2)) * 30
    off = np.array([[0, 0], [6, 8], [0, 10], [5, 8], [0, 9], [-6, -8]])
    pts = (base[:, :, None, :] + off[None, None]).reshape(2, -1, 2)
    pts = pts[:, rng.permutation(pts.shape[1])]
    cases.append(("pairs at min_dist", pts[..., 0], pts[..., 1],
                  np.ones(pts.shape[:2], bool), 10.0, 384))
    ys = rng.integers(0, 90, (3, 200))
    xs = rng.integers(0, 90, (3, 200))
    live = np.zeros((3, 200), bool)
    live[0, ::2] = True
    live[1] = rng.random(200) < 0.3
    live[2, 50:60] = live[2, 120:140] = live[2, -1] = True
    cases.append(("dead interleaved, not a prefix", ys, xs, live, 12.0, 384))
    g = np.arange(12) * 15
    grid = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    cand = np.concatenate([grid, grid[rng.integers(20, 144, 60)]])
    cases.append(("past max_out", cand[None, :, 0], cand[None, :, 1],
                  np.ones((1, len(cand)), bool), 10.0, 20))
    ys = rng.integers(0, 6, (2, 70))
    xs = rng.integers(0, 6, (2, 70))
    cases.append(("min_dist 0", ys, xs, rng.random((2, 70)) < 0.8, 0.0, 50))
    return cases


WALK_CASES = walk_cases()


def _jax(ys, xs, live, min_dist, max_out):
    return np.asarray(jax.jit(jax.vmap(lambda y, x, lv: jc.greedy_min_dist(
        y, x, lv, min_dist, max_out=max_out)))(ys, xs, live))


@pytest.mark.parametrize("case", range(len(WALK_CASES)),
                         ids=[c[0] for c in WALK_CASES])
def test_plain_equals_jax_at_the_edges(case):
    """The plain version equals the JAX package's greedy_min_dist on each
    edge case, and the case reaches its edge."""
    label, ys, xs, live, min_dist, max_out = WALK_CASES[case]
    want = _jax(ys, xs, live, min_dist, max_out)
    got = greedy_cuda.greedy_min_dist(T(ys), T(xs), T(live), min_dist, max_out)
    np.testing.assert_array_equal(got.numpy(), want)
    if label == "pairs at min_dist":
        assert want.sum() > 40 and not want.all()
    if label == "past max_out":
        assert want.sum() > max_out
    if label == "min_dist 0":
        np.testing.assert_array_equal(want, live)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("case", range(len(WALK_CASES)),
                         ids=[c[0] for c in WALK_CASES])
def test_kernel_walk_equals_plain(case, geometry):
    """The emulated batch walk equals the plain version plane by plane on
    the edge cases, at the kernel's geometry and at small ones
    (tests/test_torch_circles.py holds it on chip_smoke's seeded cases)."""
    label, ys, xs, live, min_dist, max_out = WALK_CASES[case]
    want = greedy_cuda.greedy_min_dist_plain(
        T(ys), T(xs), T(live), min_dist, max_out).numpy()
    met = collections.Counter()
    for p in range(ys.shape[0]):
        got, m = greedy_walk(ys[p], xs[p], live[p], min_dist, max_out,
                             *GEOMETRIES[geometry])
        np.testing.assert_array_equal(got, want[p], err_msg=label)
        met += m
    if label in ("pairs at min_dist", "dead interleaved, not a prefix"):
        assert met["blocked by the batch"] > 0
    if label == "past max_out":
        assert met["past max_out"] > 0


def test_long_stored_prefix():
    """At the kernel's geometry, a list whose stored prefix passes a
    thousand positions (max_out 2000) equals the plain version and JAX."""
    rng = np.random.default_rng(23)
    ys = rng.integers(0, 900, (1, 3000))
    xs = rng.integers(0, 900, (1, 3000))
    live = rng.random((1, 3000)) < 0.9
    want = _jax(ys, xs, live, 10.0, 2000)
    got, met = greedy_walk(ys[0], xs[0], live[0], 10.0, 2000,
                           *GEOMETRIES["kernel"])
    np.testing.assert_array_equal(got, want[0])
    np.testing.assert_array_equal(greedy_cuda.greedy_min_dist_plain(
        T(ys), T(xs), T(live), 10.0, 2000).numpy(), want)
    assert met["stored"] > 1000 and met["blocked by the batch"] > 0
