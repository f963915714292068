"""Kernel A's module (img2sgf_tpu_torch/hough/accumulator_cuda.py) on the
CPU: the offset table (vote_table) against both plain accumulators, a numpy
emulation of the kernel's tile walk against them, the port's pooled
accumulator against the JAX package's packed4 lax.map, and the argument
checks. The kernel itself is held against its plain versions on the card
by tests/test_torch_cuda.py and chip_smoke.py."""

import collections

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


# The geometry of the emulated walk: tile (rows, columns), chunks of 16
# bytes a round (the kernel's threads), rounds a segment, lanes of a warp,
# table entries a lane, pixels of a bin a warp takes, and the label
# buffer's address modulo 16 (the kernel aligns chunks on addresses)
SMALL = dict(tile=(8, 16), threads=8, rounds=32, lanes=8, per_lane=2,
             chunk=5, base=3)
BIAS = 1 << 14  # the kernel's kBias


def _tile_of_rank(r, tiles_x, tiles_y):
    """The kernel's tile_of_rank: the plane's interior tiles row-major,
    then its border ring (top row, bottom row, left and right columns)."""
    ix, iy = tiles_x - 2, tiles_y - 2
    if ix < 1 or iy < 1:
        return divmod(r, tiles_x)
    if r < ix * iy:
        return 1 + r // ix, 1 + r % ix
    r -= ix * iy
    if r < 2 * tiles_x:
        return (0, r) if r < tiles_x else (tiles_y - 1, r - tiles_x)
    r -= 2 * tiles_x
    return (1 + r, 0) if r < iy else (1 + r - iy, tiles_x - 1)


@pytest.mark.parametrize("tiles", [(1, 1), (2, 7), (3, 3), (6, 6), (7, 4),
                                   (10, 10), (1, 9)], ids=str)
def test_tile_order_covers_each_tile_once(tiles):
    """Kernel A's block order takes every tile of a plane once, the
    interior before the border ring."""
    tiles_x, tiles_y = tiles
    order = [_tile_of_rank(r, tiles_x, tiles_y) for r in range(tiles_x * tiles_y)]
    assert sorted(order) == [(y, x) for y in range(tiles_y) for x in range(tiles_x)]
    border = [y in (0, tiles_y - 1) or x in (0, tiles_x - 1) for y, x in order]
    assert border == sorted(border)


def _emulate(lab, num_bins, min_r, max_r, tile, threads, rounds, lanes,
             per_lane, chunk, base):
    """Kernel A's walk in numpy, at a small geometry: per (plane, tile), the
    window (the tile grown by the table's bounds, clipped to the plane) as
    16-byte chunks aligned on the buffer's addresses (bytes past either end
    of the buffer read as 255), masked by column, `threads` chunks a round
    and up to `rounds` rounds a segment. A counting pass finds each round's
    edge pixels that can reach the tile (their bin's span), a chunk's
    pixels of one label at a time; runs of rounds
    of at most 16 * threads such pixels form the pieces. Each piece's
    pixels are counted by bin, scanned and scattered into runs by bin; each
    run is cut into chunks of `chunk` pixels, each found by the kernel's
    search over the chunk prefixes; the bin's entries are held `lanes *
    per_lane` at a time (an empty slot's dy far off), and each vote is
    tested against the whole tile on the kernel's biased, packed
    coordinates (rows and columns past the plane are counted, never
    written; a vote outside goes to the padding column). Returns (accumulator, counts of what the walk
    met)."""
    start, ent, _ = acc.vote_table(num_bins, min_r, max_r)
    ext, (ymin, ymax, xmin, xmax) = acc.vote_extents(num_bins, min_r, max_r)
    ext = ext.astype(np.int64)
    P, H, W = lab.shape
    TH, TW = tile
    flat = lab.reshape(-1)
    n = flat.size
    group = lanes * per_lane
    out = np.full((P, H, W), -1, np.int64)
    met = collections.Counter()

    def reaching(p, ty0, tx0, th, tw, wy0, wx0, wx1, cpr, g):
        """The reaching edge pixels of chunk g, (bin, ry, rx) in order."""
        r, cc = divmod(g, cpr)
        y = wy0 + r
        row = (p * H + y) * W
        first = ((base + row + wx0) & ~15) - base + 16 * cc
        idx = first + np.arange(16)
        inside = (idx >= 0) & (idx < n)
        v = np.where(inside, flat[np.clip(idx, 0, n - 1)], 255)
        met["bytes past an end"] += int((~inside).sum())
        col = idx - row
        m = (col >= wx0) & (col < wx1) & (v < num_bins)
        found = []
        ry = y - ty0
        while m.any():  # a label at a time, its columns tested at once
            b = int(v[np.argmax(m)])
            same = m & (v == b)
            m &= ~same
            met["label runs"] += 1
            met["window edges"] += int(same.sum())
            e = ext[b]
            rx = col - tx0
            run = same & (rx + e[3] >= 0) & (rx + e[2] < tw)
            if not (ry + e[1] >= 0 and ry + e[0] < th):
                run[:] = False
            met["out of reach"] += int(same.sum() - run.sum())
            found += [(b, ry, int(x)) for x in rx[run]]
        return found

    tiles_y, tiles_x = -(-H // TH), -(-W // TW)
    for b in range(P * tiles_y * tiles_x):  # the kernel's block order
        p = b % P
        trow, tcol = _tile_of_rank(b // P, tiles_x, tiles_y)
        ty0, tx0 = trow * TH, tcol * TW
        th, tw = min(TH, H - ty0), min(TW, W - tx0)
        cnt = np.zeros((TH, TW + 1), np.int64)  # a padding column
        wy0, wy1 = max(ty0 - ymax, 0), min(ty0 + th - ymin, H)
        wx0, wx1 = max(tx0 - xmax, 0), min(tx0 + tw - xmin, W)
        cpr = (wx1 - wx0 + 30) >> 4
        n_chunks = (wy1 - wy0) * cpr if wy1 > wy0 and wx1 > wx0 else 0
        args = (p, ty0, tx0, th, tw, wy0, wx0, wx1, cpr)
        for g0 in range(0, n_chunks, rounds * threads):
            met["segments"] += 1
            seg = [[px for g in range(g0 + r * threads,
                                      min(g0 + (r + 1) * threads, n_chunks))
                    for px in reaching(*args, g)]
                   for r in range(min(rounds, -(-(n_chunks - g0) // threads)))]
            pieces, total = [[]], 0
            for rnd in seg:  # runs of rounds of at most 16 * threads
                if total + len(rnd) > 16 * threads:
                    pieces.append([])
                    total = 0
                pieces[-1] += rnd
                total += len(rnd)
            met["pieces"] += len(pieces)
            last_bins = set()
            for staged in pieces:
                hist = np.bincount([b for b, _, _ in staged],
                                   minlength=num_bins)
                pre_pix = np.concatenate([[0], np.cumsum(hist)])
                pre_chunk = np.concatenate(
                    [[0], np.cumsum((hist + chunk - 1) // chunk)])
                pos = pre_pix[:-1].copy()
                runs = [None] * len(staged)
                for b, ry, rx in staged:  # the scatter
                    runs[pos[b]] = (ry, rx)
                    pos[b] += 1
                bins = {b for b, _, _ in staged}
                met["bins cut by a piece"] += len(bins & last_bins)
                last_bins = bins
                for c in range(pre_chunk[-1]):
                    lo, hi = 0, num_bins - 1
                    while lo < hi:
                        mid = (lo + hi + 1) >> 1
                        lo, hi = ((mid, hi) if pre_chunk[mid] <= c
                                  else (lo, mid - 1))
                    k0 = pre_pix[lo] + (c - pre_chunk[lo]) * chunk
                    k1 = min(k0 + chunk, pre_pix[lo + 1])
                    met["chunks"] += 1
                    met["runs cut into chunks"] += int(c > pre_chunk[lo])
                    e1 = start[lo + 1]
                    for eb in range(start[lo], e1, group):
                        e = eb + np.arange(group)
                        held = e < e1
                        e = np.minimum(e, e1 - 1)
                        dy = np.where(held, ent[0, e], -(1 << 15))
                        dx, wt = ent[1, e].astype(np.int64), ent[2, e]
                        step = dy.astype(np.int64) * 65536 + dx
                        off = dy * (TW + 1) + dx
                        met["entry groups"] += 1
                        for ry, rx in runs[k0:k1]:
                            # the kernel's word: both halves biased,
                            # the target in the tile iff the bits
                            # of word ^ bias outside (TH - 1, TW -
                            # 1) are clear
                            q = (ry + BIAS) << 16 | (rx + BIAS)
                            v = (q + step) & 0xFFFFFFFF
                            ok = (v ^ (BIAS << 16 | BIAS)) & ~((TH - 1) << 16 | (TW - 1)) == 0
                            at = (q >> 16) * (TW + 1) + (q & 0xFFFF) + off[ok]
                            yy, xx = np.divmod(at - BIAS * (TW + 1) - BIAS, TW + 1)
                            assert (yy == ry + dy[ok]).all() and (xx == rx + dx[ok]).all()
                            np.add.at(cnt, (yy, xx), wt[ok])
                            # the rest into the lane's word of the
                            # padding column
                            lane = np.arange(group)[~ok] % lanes
                            np.add.at(cnt, (lane % TH, TW), wt[~ok])
        out[p, ty0:ty0 + th, tx0:tx0 + tw] = cnt[:th, :tw]
    return out, met


@pytest.mark.parametrize("case", [
    ((64, 1, 30), (2, 37, 45), 0.08, {}),   # halo past the plane
    ((64, 1, 6), (3, 21, 35), 0.15, {}),    # tiles cut at both edges
    ((64, 3, 19), (1, 24, 40), 0.10, {}),   # per-offset
    ((16, 1, 5), (1, 20, 33), 1.0, {}),     # every pixel an edge
    # a halo (30) far larger than a 4 x 8 tile, and the buffer's start on
    # a 16-byte boundary
    ((64, 1, 30), (1, 26, 29), 0.1, dict(tile=(4, 8), base=0)),
    # 254 bins: runs of one or two pixels, bins of 36-60 entries in
    # groups of 16
    ((254, 1, 30), (1, 30, 41), 0.2, dict(lanes=4, per_lane=4)),
    # rounds of 2 chunks, segments of 3 rounds and dense edges: pieces and
    # segments cut every bin's run; chunks of 3 pixels
    ((16, 1, 5), (2, 19, 37), 0.8,
     dict(threads=2, rounds=3, chunk=3, base=13)),
], ids=str)
def test_kernel_walk_equals_plain(case):
    """The emulated walk of kernel A (segments of rounds of chunks, the
    per-bin reach filter, pieces by count, the grouping by bin,
    register-held entries) equals the plain version, and meets what its
    case is for."""
    (nb, lo, hi), shape, density, geometry = case
    lab = _labels(hi, shape, nb, density)
    if density == 1.0:
        lab[:] = 3  # all one bin
    got, met = _emulate(lab, nb, lo, hi, **{**SMALL, **geometry})
    np.testing.assert_array_equal(
        got, _plain(lab, nb, lo, hi).numpy().astype(np.int64))
    assert met["out of reach"] > 0 or density == 1.0
    if density == 1.0:  # one label: a run a chunk
        assert met["label runs"] * 8 < met["window edges"]
    assert met["entry groups"] > met["chunks"] or hi < 30
    if geometry.get("threads") == 2:
        th, tw = geometry.get("tile", SMALL["tile"])
        tiles = shape[0] * -(-shape[1] // th) * -(-shape[2] // tw)
        assert met["pieces"] > met["segments"] > tiles
        assert met["bins cut by a piece"] > 0 and met["runs cut into chunks"] > 0
    if geometry.get("base") == 13:
        assert met["bytes past an end"] > 0


def test_extents_bound_the_table():
    """vote_extents: each bin's span is its entries' own, and the bounds
    span every bin; the default table's spans are about 30 |sin| by 30
    |cos|, so most bins reach far less than the halo one way."""
    for case in TABLE_CASES:
        start, ent, halo = acc.vote_table(*case)
        ext, bounds = acc.vote_extents(*case)
        assert ext.dtype == np.int16 and ext.shape == (case[0], 4)
        for d in range(case[0]):
            dy, dx = ent[:2, start[d]:start[d + 1]]
            assert tuple(ext[d]) == (dy.min(), dy.max(), dx.min(), dx.max())
        assert bounds == (ext[:, 0].min(), ext[:, 1].max(), ext[:, 2].min(),
                          ext[:, 3].max())
        assert max(map(abs, bounds)) == halo
    ext, _ = acc.vote_extents(64, 1, 30)
    assert tuple(ext[0]) == (0, 0, -30, 30) and tuple(ext[32]) == (-30, 30, 0, 0)
    assert (ext[:, 1] - ext[:, 0] + 1).sum() < 0.7 * 64 * 61


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


def test_kernel_refuses_a_halo_past_its_packing():
    """Kernel A packs tile-relative coordinates into 15-bit halves, so its
    wrapper refuses a table whose largest |offset| reaches MAX_HALO (one
    bin keeps the table small) and launches nothing; the plain version
    runs such a table."""
    lab = T(_labels(1, (1, 9, 11), 1))
    lo = acc.MAX_HALO - 10
    assert acc.vote_table(1, lo, lo + 9)[2] < acc.MAX_HALO
    before = acc.launches
    with pytest.raises(ValueError, match="offsets below"):
        acc.vote_accumulator_cuda(lab, 1, lo, lo + 10)
    assert acc.launches == before
    ext, bounds = acc.vote_extents(1, lo, lo + 10)
    assert bounds == (0, 0, -(lo + 10), lo + 10) and ext[0, 3] == lo + 10
    assert float(tc.vote_accumulator_pool_labels(lab, 1, lo, lo + 10).max()) == 0


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
