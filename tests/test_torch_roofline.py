"""chip_smoke.py's roofline work counts (k2_walk_steps, k2_bytes, k3_work,
greedy_work, accumulator_work) against brute-force loops over small seeded
inputs: each kernel's bound counts only the pixels, steps and candidates its
inputs need."""

import numpy as np
import pytest
import torch

from chip_smoke import (
    GREEDY_OPS_PER_TEST, accumulator_work, greedy_work, k2_bytes, k2_walk_steps,
    k3_work)
from img2sgf_tpu_torch.hough import (
    accumulator_cuda, greedy_cuda, radius_cuda, rescore_cuda)

T = torch.from_numpy


def _inputs(seed, dtype=np.int64, P=3, H=23, W=29, K=6):
    """Edge planes [P, H, W] and K centres per plane (some at the border),
    with a mask of the slots in use."""
    rng = np.random.default_rng(seed)
    emask = rng.random((P, H, W)) < 0.3
    ys = rng.integers(0, H, (P, K)).astype(dtype)
    xs = rng.integers(0, W, (P, K)).astype(dtype)
    ys[0, 0], xs[0, 0] = 0, W - 1
    used = rng.random((P, K)) < 0.6
    used[0, 0] = True
    return emask, ys, xs, used


def _slots(used):
    return [(p, k) for p in range(used.shape[0]) for k in range(used.shape[1])
            if used[p, k]]


@pytest.mark.parametrize("cells", [3, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_k2_counts(cells, seed):
    emask, ys, xs, valid = _inputs(seed)
    P, H, W = emask.shape
    max_r, reach = 4, cells // 2
    kmax = rescore_cuda._geometry(1, max_r, cells)[6]
    ext = max_r + reach + 2
    covered = np.zeros_like(emask)
    edges = 0
    for p, k in _slots(valid):
        y, x = int(ys[p, k]), int(xs[p, k])
        for h in (ext, 2 * reach):
            edges += emask[p, max(y - h, 0):y + h + 1, max(x - h, 0):x + h + 1].sum()
        covered[p, max(y - ext, 0):y + ext + 1, max(x - ext, 0):x + ext + 1] = True
    assert k2_walk_steps(T(emask), T(ys), T(xs), T(valid), max_r, cells) \
        == edges * (2 * kmax + 1)
    want = (covered.sum() + 8 * (covered & emask).sum() + 9 * ys.size
            + 4 * P * ys.shape[1] * cells * cells)
    assert k2_bytes(T(emask), T(ys), T(xs), T(valid), max_r, cells) == want
    assert covered.sum() < emask.size  # the windows leave pixels unread


def _k3_brute(emask, ys, xs, want, min_r, max_r):
    """k3_work's (bytes, instructions) by a loop over every wanted window's
    annulus offsets."""
    P, H, W = emask.shape
    bmap, win, _ = radius_cuda._bin_map(min_r, max_r)
    offsets = [(i // win - max_r, i % win - max_r)
               for i in np.flatnonzero(bmap >= 0)]
    covered = np.zeros_like(emask)
    n_in = n_edge = 0
    for p, k in _slots(want):
        for dy, dx in offsets:
            y, x = int(ys[p, k]) + dy, int(xs[p, k]) + dx
            if 0 <= y < H and 0 <= x < W:
                covered[p, y, x] = True
                n_in += 1
                n_edge += int(emask[p, y, x])
    nbytes = (covered.sum() + 2 * ys.itemsize * want.sum() + 9 * want.size
              + 4 * win * win + 16 * win)
    return nbytes, n_in + 2 * n_edge


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("seed", [0, 1])
def test_k3_work(dtype, seed):
    emask, ys, xs, want = _inputs(seed, dtype)
    assert k3_work(T(emask), T(ys), T(xs), T(want), 2, 5) == \
        _k3_brute(emask, ys, xs, want, 2, 5)


@pytest.mark.parametrize("seed", [0, 1])
def test_k3_work_disk(seed):
    """circle_min_radius = 0: the annulus is a disk, centre pixel
    included."""
    emask, ys, xs, want = _inputs(seed)
    bmap, win, _ = radius_cuda._bin_map(0, 5)
    assert bmap[(win * win) // 2] >= 0
    assert k3_work(T(emask), T(ys), T(xs), T(want), 0, 5) == \
        _k3_brute(emask, ys, xs, want, 0, 5)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_greedy_work(dtype):
    """Bytes: live read and accepted written at every slot, ys and xs read
    at the live candidates alone; operations: a test of each live
    candidate against each position stored before it (at most max_out);
    steps: the largest live length (last live index + 1) of a plane, live
    or not in between."""
    _, ys, xs, live = _inputs(7, dtype, K=9)
    live[1] = False
    live[2, -1] = True
    ys[0, :] = 4 * np.arange(9)  # one plane that accepts past max_out
    xs[0, :] = 0
    live[0, :] = True
    max_out, md2 = 3, np.float32(9.0)
    P, K = live.shape
    accepted = np.zeros_like(live)
    tests = 0
    for p in range(P):
        stored = []
        for k in range(K):
            if not live[p, k]:
                continue
            tests += len(stored)
            if all(np.float32(ys[p, k] - a) ** 2 + np.float32(xs[p, k] - b) ** 2
                   >= md2 for a, b in stored):
                accepted[p, k] = True
                if len(stored) < max_out:
                    stored.append((ys[p, k], xs[p, k]))
    steps = max((k + 1 for p in range(P) for k in range(K) if live[p, k]),
                default=0)
    want = (2 * P * K + 2 * ys.itemsize * len(_slots(live)),
            GREEDY_OPS_PER_TEST * tests, steps)
    assert accepted[0].sum() > max_out
    assert torch.equal(greedy_cuda.greedy_min_dist_plain(
        T(ys), T(xs), T(live), 3.0, max_out), T(accepted))
    assert greedy_work(T(ys), T(xs), T(live), T(accepted), max_out) == want
    assert want[2] == K


@pytest.mark.parametrize("case", [(64, 1, 30), (48, 1, 31), (64, 0, 29)],
                         ids=str)
def test_accumulator_counts(case):
    """accumulator_work's votes: a loop over every edge pixel adding its
    bin's table weights; bytes: the labels, the float32 output and the
    table, once each."""
    nb, lo, hi = case
    rng = np.random.default_rng(sum(case))
    lab = rng.integers(0, nb + 3, (2, 13, 17)).astype(np.uint8)  # > nb: no vote
    start, entries, _ = accumulator_cuda.vote_table(nb, lo, hi)
    votes = 0
    for v in lab.reshape(-1):
        if v < nb:
            votes += int(sum(entries[2, start[v]:start[v + 1]]))
    nbytes = lab.size + 4 * lab.size + 4 * (nb + 1) + 12 * entries.shape[1]
    assert accumulator_work(T(lab), nb, lo, hi) == (nbytes, votes)
    assert votes == 2 * (hi - lo + 1) * int((lab < nb).sum())
