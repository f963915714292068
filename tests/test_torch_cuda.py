"""The port's CUDA kernels on the card: each kernel against its plain PyTorch
version on the same CUDA tensors, exactly equal, and detect_board on CUDA
against the CPU run. These need an NVIDIA card and skip without one. The file
imports no JAX, so on a card without JAX run it with
`python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`.
chip_smoke.py covers the same kernels at the main path's full shapes."""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import greedy_cases, staircase_plane
from img2sgf_tpu_torch.config import DetectionConfig
from img2sgf_tpu_torch.hough import (
    accumulator_cuda, greedy_cuda, radius_cuda, rescore_cuda, state_cuda)
from img2sgf_tpu_torch.ops import hysteresis_cuda
from img2sgf_tpu_torch.ops.canny import pack_planes
from img2sgf_tpu_torch.pipeline import detect_board, detect_board_bucket_batch
from img2sgf_tpu_torch.pipeline import detect as pipeline_detect

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def _k1_case(dev, strong, cand, iters):
    """K1 on the card against the plain loop: equal words, one launch per
    call and the plain loop's sweep count."""
    e0 = pack_planes(torch.from_numpy(strong & cand).to(dev))
    gate = pack_planes(torch.from_numpy(cand).to(dev))
    before = hysteresis_cuda.launches
    got = hysteresis_cuda.hysteresis_packed(e0, gate, iters)
    assert hysteresis_cuda.launches == before + 1
    sweeps = hysteresis_cuda.last_sweeps()
    want = hysteresis_cuda.hysteresis_packed_plain(e0, gate, iters)
    assert torch.equal(got, want)
    assert sweeps == hysteresis_cuda.last_sweeps()
    return sweeps


@pytest.mark.parametrize("iters", [1, 3, 256])
def test_k1_equals_plain(dev, iters):
    rng = np.random.default_rng(iters)
    cand = rng.random((12, 90, 130)) < 0.45
    strong = cand & (rng.random(cand.shape) < 0.01)
    _k1_case(dev, strong, cand, iters)


@pytest.mark.parametrize("iters", [1, 2, 3, 256])
def test_k1_staircase_equals_plain(dev, iters):
    """Planes wider than a row segment and taller than a column band, where
    the cap binds (iters < 256) or the sweeps run to the fixed point."""
    rng = np.random.default_rng(10 + iters)
    pairs = [staircase_plane(rng, 120, 1500) for _ in range(8)]
    strong = np.stack([s for s, _ in pairs])
    cand = np.stack([c for _, c in pairs])
    sweeps = _k1_case(dev, strong, cand, iters)
    assert sweeps == iters if iters < 256 else 3 < sweeps < 256


@pytest.mark.parametrize("P", [40, 70])
def test_k1_several_word_groups(dev, P):
    """[2, H, W] and [3, H, W] words (a batch's internal Canny packs 8
    planes per image, 128 planes at B = 16): staircases in some planes,
    random candidates in the others, and a last group only partly used."""
    rng = np.random.default_rng(P)
    cand = rng.random((P, 70, 90)) < 0.45
    strong = cand & (rng.random(cand.shape) < 0.01)
    for p in range(0, P, 7):
        strong[p], cand[p] = staircase_plane(rng, 70, 90)
    sweeps = _k1_case(dev, strong, cand, 256)
    assert sweeps > 3


def test_k1_past_the_old_line_cap(dev):
    """[1, 8, 6400] words: rows of 6400 words, past the 6144 cap of a kernel
    that held a whole line in shared memory."""
    rng = np.random.default_rng(6400)
    cand = rng.random((8, 8, 6400)) < 0.5
    cand[:, 3, :] = True  # one gated run along a whole row
    strong = np.zeros_like(cand)
    strong[:, 3, -1] = True
    strong |= cand & (rng.random(cand.shape) < 0.002)
    _k1_case(dev, strong, cand, 256)


@pytest.mark.parametrize("cells", [3, 5])
@pytest.mark.parametrize("max_r", [30, 60])
def test_k2_equals_plain(dev, cells, max_r):
    """One full plane, one all-invalid plane and a partial one; K = 333 is
    no multiple of the persistent grid, and at max_r 60 a window's edge
    list is flushed several times per candidate."""
    rng = np.random.default_rng(cells + max_r)
    P, H, W, K = 3, 160, 180, 333
    emask = rng.random((P, H, W)) < 0.12
    ang = rng.uniform(0, 2 * np.pi, (P, H, W))
    sx = (np.rint(1024 * np.cos(ang)).astype(np.int32)) * emask
    sy = (np.rint(1024 * np.sin(ang)).astype(np.int32)) * emask
    ys = rng.integers(0, H, (P, K))
    xs = rng.integers(0, W, (P, K))
    valid = np.arange(K)[None, :] < np.array([[K], [0], [77]])
    args = [torch.from_numpy(np.asarray(a)).to(dev)
            for a in (emask, sx.astype(np.int32), sy.astype(np.int32), ys, xs,
                      valid)]
    before = rescore_cuda.launches
    got = rescore_cuda.exact_rescore(*args, 1, max_r, cells=cells)
    assert rescore_cuda.launches == before + 1
    want = rescore_cuda.exact_rescore_plain(*args, 1, max_r, cells=cells)
    assert torch.equal(got, want)
    assert float(want.sum()) > 0


K3_CASES = {  # want mask, radius range, dtype of ys and xs, (P, H, W, K)
    "prefix": ("prefix", (1, 30), np.int64, (3, 100, 120, 300)),
    "random_bits": ("random", (1, 30), np.int64, (3, 100, 120, 300)),
    "max_r60": ("random", (1, 60), np.int64, (3, 100, 120, 300)),
    "max_r120": ("prefix", (1, 120), np.int64, (3, 100, 120, 300)),
    "int32": ("random", (5, 44), np.int32, (3, 100, 120, 300)),
    "int32_prefix": ("prefix", (1, 30), np.int32, (3, 100, 120, 300)),
    "none_wanted": ("none", (1, 30), np.int64, (3, 100, 120, 300)),
    "all_wanted": ("all", (1, 30), np.int64, (3, 100, 120, 300)),
    # past the 65535 planes of a grid's y dimension
    "p70000": ("all", (1, 10), np.int64, (70000, 8, 8, 2)),
}


@pytest.mark.parametrize("case", list(K3_CASES))
def test_k3_equals_plain(dev, case):
    """One launch per call and exactly the plain version's output: prefix
    and random want masks, no and every slot wanted, radii 30 to 120,
    int32 and int64 centres, and a pool of 70,000 tiny planes."""
    mask, (min_r, max_r), dtype, (P, H, W, K) = K3_CASES[case]
    rng = np.random.default_rng(list(K3_CASES).index(case))
    emask = rng.random((P, H, W)) < 0.1
    ys = rng.integers(0, H, (P, K)).astype(dtype)
    xs = rng.integers(0, W, (P, K)).astype(dtype)
    want_m = {
        "prefix": np.arange(K)[None, :] < np.array([[K], [0], [123]]),
        "random": rng.random((P, K)) < 0.4,
        "none": np.zeros((P, K), bool),
        "all": np.ones((P, K), bool),
    }[mask]
    args = [torch.from_numpy(a).to(dev) for a in (emask, ys, xs, want_m)]
    before = radius_cuda.launches
    got = radius_cuda.radius_support_pool(*args, min_r, max_r)
    assert radius_cuda.launches == before + 1
    want = radius_cuda.radius_support_pool_plain(*args, min_r, max_r)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (float(want[1].max()) > 0) == (mask != "none")


def test_k3_too_many_bins_raises(dev):
    """Radii 1 to 3000 need 29,990 bins, whose two int32 tables per warp
    exceed the card's shared memory per block: the call raises by name and
    launches nothing."""
    emask = torch.zeros((1, 8, 8), dtype=torch.bool, device=dev)
    ys = torch.full((1, 2), 4, dtype=torch.int64, device=dev)
    want = torch.ones((1, 2), dtype=torch.bool, device=dev)
    before = radius_cuda.launches
    with pytest.raises(ValueError, match="29990 histogram bins"):
        radius_cuda.radius_support_pool(emask, ys, ys, want, 1, 3000)
    assert radius_cuda.launches == before


def _diagram(size=192, n=9):
    """A grid of 1-px lines with two outlined stones (no JAX needed)."""
    img = np.full((size, size), 250, np.float32)
    coords = np.linspace(14, size - 14, n)
    for c in coords:
        img[int(round(c)), 14:size - 13] = 10
        img[14:size - 13, int(round(c))] = 10
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    r = (coords[1] - coords[0]) * 0.42
    for i, j, colour in ((2, 3, 0), (4, 4, 255)):
        d = np.hypot(xx - coords[i], yy - coords[j])
        inside = np.clip(r + 0.5 - d, 0, 1)
        img = img * (1 - inside) + colour * inside
        ring = np.clip(0.8 - np.abs(d - r), 0, 1)
        img = img * (1 - ring) + 10 * ring
    return np.repeat(img.astype(np.uint8)[:, :, None], 3, axis=2)


@pytest.mark.parametrize("max_r", [30, 55])
def test_detect_board_cuda_equals_cpu(dev, max_r):
    """The default radius range, and 55, which K2's window no longer has to
    fit in a fixed amount of shared memory for."""
    rgb = _diagram()
    cfg = DetectionConfig().replace(circle_max_radius=max_r)
    a = detect_board(rgb, cfg, 31, device=dev)
    b = detect_board(rgb, cfg, 31, device="cpu")
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name).cpu(), getattr(b, f.name)
        assert x.dtype == y.dtype and torch.equal(x, y), f.name


@pytest.mark.parametrize("cells", [3, 5])
def test_k2_min_r_zero_equals_plain(dev, cells):
    """circle_min_radius = 0: the r = 0 step, with edge pixels on the
    candidate centres."""
    rng = np.random.default_rng(40 + cells)
    P, H, W, K = 2, 120, 140, 200
    emask = rng.random((P, H, W)) < 0.12
    ys = rng.integers(0, H, (P, K))
    xs = rng.integers(0, W, (P, K))
    emask[0, ys[0, :50], xs[0, :50]] = True
    ang = rng.uniform(0, 2 * np.pi, (P, H, W))
    sx = (np.rint(1024 * np.cos(ang)).astype(np.int32)) * emask
    sy = (np.rint(1024 * np.sin(ang)).astype(np.int32)) * emask
    valid = np.arange(K)[None, :] < np.array([[K], [61]])
    args = [torch.from_numpy(np.asarray(a)).to(dev)
            for a in (emask, sx.astype(np.int32), sy.astype(np.int32), ys, xs,
                      valid)]
    before = rescore_cuda.launches
    got = rescore_cuda.exact_rescore(*args, 0, 30, cells=cells)
    assert rescore_cuda.launches == before + 1
    assert torch.equal(got, rescore_cuda.exact_rescore_plain(*args, 0, 30,
                                                             cells=cells))
    assert (got >= rescore_cuda.exact_rescore(*args, 1, 30, cells=cells)).all()


def test_k3_min_r_zero_equals_plain(dev):
    """circle_min_radius = 0: the disk's spans, with pixels at d < 1 of
    some centres, random and edge-clipped windows."""
    rng = np.random.default_rng(44)
    P, H, W, K = 3, 100, 120, 300
    emask = rng.random((P, H, W)) < 0.1
    ys = rng.integers(0, H, (P, K))
    xs = rng.integers(0, W, (P, K))
    emask[1, ys[1, :40], xs[1, :40]] = True
    want = rng.random((P, K)) < 0.5
    args = [torch.from_numpy(a).to(dev) for a in (emask, ys, xs, want)]
    before = radius_cuda.launches
    got = radius_cuda.radius_support_pool(*args, 0, 29)
    assert radius_cuda.launches == before + 1
    plain = radius_cuda.radius_support_pool_plain(*args, 0, 29)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])


@pytest.mark.parametrize("change", [
    dict(circle_max_radius=31), dict(circle_min_radius=0, circle_max_radius=29),
    dict(propose_block=2), dict(num_angle_bins=48), dict(num_angle_bins=63)],
    ids=["max_r31", "min_r0", "block2", "bins48", "bins63"])
def test_detect_board_config_cuda_equals_cpu(dev, change):
    """The config values off the default path: CUDA equal to the CPU run."""
    rgb = _diagram()
    cfg = DetectionConfig().replace(**change)
    a = detect_board(rgb, cfg, 31, device=dev)
    b = detect_board(rgb, cfg, 31, device="cpu")
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name).cpu(), getattr(b, f.name)
        assert x.dtype == y.dtype and torch.equal(x, y), f.name
    assert bool(a.board_ready)


def _two_image_planes(dev):
    """Two diagrams of mixed sizes in one 192 canvas (margins 0 and 2):
    (cfg, canvases, their 16 unique planes, the planes' content dims)."""
    imgs = [_diagram(192), _diagram(190, n=7)]
    can = np.zeros((2, 192, 192, 3), np.uint8)
    for i, im in enumerate(imgs):
        can[i, :im.shape[0], :im.shape[1]] = im
    cfg = DetectionConfig()
    hw = (torch.tensor([192, 190], device=dev), torch.tensor([192, 190], device=dev))
    _, _, v = pipeline_detect._pre_circles(torch.from_numpy(can).to(dev), cfg, hw)
    keep, _ = pipeline_detect._variant_dedup(cfg, v.shape[1])
    planes = v[:, keep].reshape(-1, 192, 192)
    return cfg, can, planes, tuple(t.repeat_interleave(len(keep)) for t in hw)


def _two_image_pool(dev):
    """The plane state of _two_image_planes: 16 planes with per-plane
    content dims."""
    cfg, can, planes, hwp = _two_image_planes(dev)
    return cfg, can, pipeline_detect._plane_state_pool(planes, cfg, hwp)


def test_k2_k3_on_a_two_image_pool(dev):
    """K2 at the proposals and ring cells and K3 at the compacted peaks of
    a pool holding both images' planes, against their plain versions."""
    from img2sgf_tpu_torch.hough.circles import propose_from_acc

    cfg, _, st = _two_image_pool(dev)
    hw = (st["hs"], st["ws"])
    ys, xs, valid, _ = propose_from_acc(
        st["acc"], cfg.circle_acc_threshold, cfg.max_center_candidates,
        threshold_factor=cfg.propose_threshold_factor, hw=hw)
    args = (st["emask"], st["sx"], st["sy"], ys, xs, valid,
            cfg.circle_min_radius, cfg.circle_max_radius)
    for cells in (5, 3):
        got = rescore_cuda.exact_rescore(*args, cells=cells)
        assert torch.equal(got, rescore_cuda.exact_rescore_plain(*args, cells=cells))
    ys_c, xs_c, want, _ = pipeline_detect._select_candidates(
        st, cfg, margin_filter=True)
    assert int(want[:8].sum()) > 0 and int(want[8:].sum()) > 0
    k3 = (st["emask"], ys_c, xs_c, want, cfg.circle_min_radius,
          cfg.circle_max_radius)
    got = radius_cuda.radius_support_pool(*k3)
    plain = radius_cuda.radius_support_pool_plain(*k3)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])


def test_detect_board_bucket_batch_cuda_equals_cpu(dev):
    """Two images of mixed sizes in one canvas: every field of the CUDA
    batch, run eagerly (timings=, with 2 K1, 2 K2 and 1 K3 launches) and
    from its CUDA graphs, equals the CPU batch."""
    cfg, can, _ = _two_image_pool(dev)
    hs = ws = [192, 190]
    counters = (hysteresis_cuda, rescore_cuda, radius_cuda)
    before = [m.launches for m in counters]
    a = detect_board_bucket_batch(can, cfg, [31, 31], hs, ws, device=dev,
                                  timings={})
    assert [m.launches - b for m, b in zip(counters, before)] == [2, 2, 1]
    g = detect_board_bucket_batch(can, cfg, [31, 31], hs, ws, device=dev)
    b = detect_board_bucket_batch(can, cfg, [31, 31], hs, ws, device="cpu")
    for f in dataclasses.fields(a):
        y = getattr(b, f.name)
        for x in (getattr(a, f.name).cpu(), getattr(g, f.name).cpu()):
            assert x.dtype == y.dtype and torch.equal(x, y), f.name
    assert bool(b.board_ready.all())


def test_k1_k3_from_two_threads(dev):
    """K1, K2 and K3 launched from two threads at once, each on its own
    stream of the one card (so K1's two cooperative launches, each sized to
    fill the card, must take turns): every output equals the plain version,
    each thread reads its own K1 sweep count, and no launch is lost from the
    counts."""
    import threading

    rng = np.random.default_rng(7)
    pairs = [staircase_plane(rng, 120, 1500) for _ in range(8)]
    e0 = pack_planes(torch.from_numpy(np.stack([s & c for s, c in pairs])).to(dev))
    gate = pack_planes(torch.from_numpy(np.stack([c for _, c in pairs])).to(dev))
    cfg, _, st = _two_image_pool(dev)
    ys_c, xs_c, want, _ = pipeline_detect._select_candidates(
        st, cfg, margin_filter=True)
    k2 = (st["emask"], st["sx"], st["sy"], ys_c, xs_c, want,
          cfg.circle_min_radius, cfg.circle_max_radius)
    k3 = (st["emask"], ys_c, xs_c, want, cfg.circle_min_radius,
          cfg.circle_max_radius)
    torch.cuda.synchronize(dev)
    reps, iters = 6, (5, 256)
    counters = (hysteresis_cuda, rescore_cuda, radius_cuda)
    before = [m.launches for m in counters]
    outs = [[] for _ in iters]
    barrier = threading.Barrier(len(iters))

    def work(k):
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            barrier.wait(timeout=60)
            for _ in range(reps):
                h = hysteresis_cuda.hysteresis_packed(e0, gate, iters[k])
                outs[k].append((h, hysteresis_cuda.last_sweeps(),
                                rescore_cuda.exact_rescore(*k2, cells=3),
                                radius_cuda.radius_support_pool(*k3)))
            torch.cuda.current_stream(dev).synchronize()

    threads = [threading.Thread(target=work, args=(k,)) for k in range(len(iters))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    n = reps * len(iters)
    assert [m.launches - b for m, b in zip(counters, before)] == [n, n, n]
    k2_plain = rescore_cuda.exact_rescore_plain(*k2, cells=3)
    k3_plain = radius_cuda.radius_support_pool_plain(*k3)
    for k, it in enumerate(iters):
        h_plain = hysteresis_cuda.hysteresis_packed_plain(e0, gate, it)
        sweeps = hysteresis_cuda.last_sweeps()
        for h, s, r2, r3 in outs[k]:
            assert torch.equal(h, h_plain) and s == sweeps
            assert torch.equal(r2, k2_plain)
            assert torch.equal(r3[0], k3_plain[0]) and torch.equal(r3[1], k3_plain[1])
    assert outs[0][0][1] == 5 and outs[1][0][1] > 5


def test_sharded_detector_two_streams_equals_batch(dev):
    """make_sharded_detector over [cuda:0, cuda:0] (two worker threads on two
    streams of one card) in the bucketed mode equals the one-device batch
    in every field, and launches each kernel from both threads: each
    shard's first call runs its graphs' warm-up eagerly, 2 K1, 4 K2 and
    2 K3 (the base selection and one rerun chunk), before the capture."""
    from img2sgf_tpu_torch.parallel import make_sharded_detector
    from img2sgf_tpu_torch.pipeline import graphs

    cfg, can, _ = _two_image_pool(dev)
    hs = ws = [192, 190]
    want = detect_board_bucket_batch(can, cfg, [31, 31], hs, ws, device=dev)
    graphs.clear()
    counters = (hysteresis_cuda, rescore_cuda, radius_cuda)
    before = [m.launches for m in counters]
    got = make_sharded_detector([dev, dev], cfg, bucketed=True)(can, [31, 31], hs, ws)
    assert [m.launches - b for m, b in zip(counters, before)] == [4, 8, 4]
    for f in dataclasses.fields(want):
        x, y = getattr(got, f.name), getattr(want, f.name)
        assert x.device == y.device and torch.equal(x, y), f.name


def test_sharded_detector_orders_its_streams(dev, monkeypatch):
    """The shards' streams wait for the caller's queued work on the images,
    and the caller reads a shard's results only once they are written: with
    the caller's stream (not the default one) held back (about half a
    second) before it writes the images, and each shard's stream held back
    before it writes every row it returns, the two-stream run still equals
    the one-device batch in every field."""
    from img2sgf_tpu_torch.parallel import make_sharded_detector, mesh

    cycles = 10**9
    cfg, can, _ = _two_image_pool(dev)
    hs = ws = [192, 190]
    want = detect_board_bucket_batch(can, cfg, [31, 31], hs, ws, device=dev)
    impl = mesh._detect_batch

    def slow_impl(*args):
        res = impl(*args)
        # every returned tensor holds a wrong value in every element (0
        # where res is not 0, 1 where it is) until the shard's stream, held
        # back, writes the right one
        rows = {f.name: (getattr(res, f.name) == 0).to(getattr(res, f.name).dtype)
                for f in dataclasses.fields(res)}
        torch.cuda._sleep(cycles)  # on the shard's stream
        for f in dataclasses.fields(res):
            rows[f.name].copy_(getattr(res, f.name))
        return type(res)(**rows)

    monkeypatch.setattr(mesh, "_detect_batch", slow_impl)
    run = make_sharded_detector([dev, dev], cfg, bucketed=True)
    src = torch.from_numpy(can).to(dev)
    torch.cuda.synchronize(dev)
    # the caller works on a stream of its own: the legacy default stream
    # would wait for the shards' streams, and they for it, unasked
    with torch.cuda.stream(torch.cuda.Stream(dev)):
        images = torch.full_like(src, 255)
        torch.cuda._sleep(cycles)  # on the caller's stream
        images.copy_(src)
        got = run(images, [31, 31], hs, ws)
    for f in dataclasses.fields(want):
        x, y = getattr(got, f.name), getattr(want, f.name)
        assert x.device == y.device and torch.equal(x, y), f.name


GREEDY_CASES = greedy_cases()


@pytest.mark.parametrize("case", range(len(GREEDY_CASES)),
                         ids=[c[0] for c in GREEDY_CASES])
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_greedy_equals_plain(dev, case, dtype):
    """The greedy kernel against its plain version on the seeded edge cases
    (ties at min_dist, duplicates, more than max_out, an empty plane, live
    after dead, K = 8192): equal, one launch per call."""
    _, ys, xs, live, min_dist, max_out = GREEDY_CASES[case]
    ys, xs = (torch.from_numpy(a).to(dev, dtype) for a in (ys, xs))
    live = torch.from_numpy(live).to(dev)
    before = greedy_cuda.launches
    got = greedy_cuda.greedy_min_dist(ys, xs, live, min_dist, max_out)
    assert greedy_cuda.launches == before + 1
    want = greedy_cuda.greedy_min_dist_plain(ys, xs, live, min_dist, max_out)
    assert torch.equal(got, want)


def test_greedy_large_max_out(dev):
    """A max_out whose accepted buffer passes 48 KB of shared memory (the
    kernel opts in to more) against the plain version."""
    rng = np.random.default_rng(11)
    ys = torch.from_numpy(rng.integers(0, 4000, (2, 20000))).to(dev)
    xs = torch.from_numpy(rng.integers(0, 4000, (2, 20000))).to(dev)
    live = torch.ones((2, 20000), dtype=torch.bool, device=dev)
    got = greedy_cuda.greedy_min_dist(ys, xs, live, 10.0, 8000)
    want = greedy_cuda.greedy_min_dist_plain(ys, xs, live, 10.0, 8000)
    assert torch.equal(got, want) and int(got.sum()) > 8000


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_greedy_long_stored_prefix(dev, dtype):
    """Planes whose stored prefix passes a thousand positions, one of them
    stopped one past 1024 by max_out (1025), beside a plane whose live
    candidates end early: equal to the plain version, one launch."""
    rng = np.random.default_rng(29)
    P, K = 4, 2500
    ys = rng.integers(0, 700, (P, K))
    xs = rng.integers(0, 700, (P, K))
    live = rng.random((P, K)) < 0.95
    live[2, 300:] = False
    ys_t, xs_t = (torch.from_numpy(a).to(dev, dtype) for a in (ys, xs))
    live_t = torch.from_numpy(live).to(dev)
    for max_out in (1025, 1500):
        before = greedy_cuda.launches
        got = greedy_cuda.greedy_min_dist(ys_t, xs_t, live_t, 10.0, max_out)
        assert greedy_cuda.launches == before + 1
        want = greedy_cuda.greedy_min_dist_plain(ys_t, xs_t, live_t, 10.0,
                                                 max_out)
        assert torch.equal(got, want)
        assert int(want[0].sum()) > 1100 and int(want[2].sum()) < 300


def test_greedy_capture_and_replay(dev):
    """The greedy kernel captured into a CUDA graph: the capture counts no
    launch, and each replay computes from the static inputs' current
    values."""
    _, ys, xs, live, min_dist, max_out = GREEDY_CASES[-1]
    rng = np.random.default_rng(5)
    other = (rng.integers(0, 768, ys.shape), rng.integers(0, 768, ys.shape),
             rng.random(ys.shape) < 0.6)
    static = [torch.from_numpy(a).to(dev) for a in (ys, xs, live)]
    greedy_cuda.greedy_min_dist(*static, min_dist, max_out)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = greedy_cuda.launches
    with torch.cuda.graph(graph):
        out = greedy_cuda.greedy_min_dist(*static, min_dist, max_out)
    assert greedy_cuda.launches == before
    for inputs in ((ys, xs, live), other):
        for t, a in zip(static, inputs):
            t.copy_(torch.from_numpy(a))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, greedy_cuda.greedy_min_dist_plain(
            *static, min_dist, max_out))


def test_greedy_makes_no_sync(dev):
    """A warm call synchronises nothing (sync debug mode "error")."""
    _, ys, xs, live, min_dist, max_out = GREEDY_CASES[3]  # K = 8192
    args = [torch.from_numpy(a).to(dev) for a in (ys, xs, live)]
    greedy_cuda.greedy_min_dist(*args, min_dist, max_out)
    torch.cuda.synchronize()
    before = greedy_cuda.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = greedy_cuda.greedy_min_dist(*args, min_dist, max_out)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert greedy_cuda.launches == before + 1
    assert torch.equal(out, greedy_cuda.greedy_min_dist_plain(
        *args, min_dist, max_out))


def _acc_labels(seed, shape, num_bins, density, one_bin=None):
    """Seeded labels on the card: edge pixels of random bins (or all of
    one_bin) at the given density, the num_bins sentinel elsewhere."""
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, num_bins, shape).astype(np.uint8)
    if one_bin is not None:
        lab[:] = one_bin
    lab[rng.random(shape) >= density] = num_bins
    return torch.from_numpy(lab).cuda()


def _acc_plain(lab, num_bins, min_r, max_r):
    if (max_r - min_r + 1) % 5:
        return accumulator_cuda.vote_accumulator_offsets(lab, num_bins, min_r,
                                                         max_r)
    return accumulator_cuda.vote_accumulator_cascade_labels(lab, num_bins,
                                                            min_r, max_r)


def _acc_check(lab, num_bins, min_r, max_r):
    """Kernel A equals its plain version exactly, in one launch."""
    before = accumulator_cuda.launches
    got = accumulator_cuda.vote_accumulator_cuda(lab, num_bins, min_r, max_r)
    assert accumulator_cuda.launches == before + 1
    want = _acc_plain(lab, num_bins, min_r, max_r)
    assert got.dtype == torch.float32 and torch.equal(got, want), \
        float((got - want).abs().max())
    return got


# (shape, num_bins, min_r, max_r, density, one bin): 6 % edges, every pixel
# an edge of one bin (the 135-degree bin, whose votes crowd a diagonal),
# 254 bins, r = 0, max_r 60, per-offset spans (31, and 68 with a 70-px
# halo), one plane, 130 planes, sizes that are no multiple of the 128 x 128
# tile, and the 1280 class
ACC_CASES = {
    "6% [8,300,420]": ((8, 300, 420), 64, 1, 30, 0.06, None),
    "100% one bin [2,256,256]": ((2, 256, 256), 64, 1, 30, 1.0, 48),
    "254 bins": ((3, 200, 260), 254, 1, 30, 0.1, None),
    "min_r 0": ((3, 200, 260), 64, 0, 29, 0.1, None),
    "max_r 60": ((3, 200, 260), 64, 1, 60, 0.1, None),
    "per-offset span 31": ((3, 200, 260), 64, 1, 31, 0.1, None),
    "per-offset span 68": ((2, 200, 260), 64, 3, 70, 0.1, None),
    "P=1 [1,77,131]": ((1, 77, 131), 64, 1, 30, 0.1, None),
    "P=130 [130,70,135]": ((130, 70, 135), 64, 1, 30, 0.06, None),
    "1280 [2,1280,1280]": ((2, 1280, 1280), 64, 1, 30, 0.06, None),
    # rows of W = 1 and 15 (mod 16) bytes, so every 16-byte chunk boundary
    # falls at another column of each row; planes shorter than a tile
    "W=1 mod 16 [3,50,177]": ((3, 50, 177), 64, 1, 30, 0.1, None),
    "W=15 mod 16 [5,33,767]": ((5, 33, 767), 64, 1, 30, 0.1, None),
    "H=7 [4,7,300]": ((4, 7, 300), 64, 1, 30, 0.2, None),
    # the widest staging: every pixel an edge of one bin at span 60
    "100% one bin 1280 span 60": ((1, 1280, 1280), 64, 1, 60, 1.0, 16),
    # a 200-px halo: windows of more chunks than one segment takes
    "max_r 200 [1,600,600]": ((1, 600, 600), 64, 1, 200, 0.03, None),
}


@pytest.mark.parametrize("case", list(ACC_CASES))
def test_accumulator_equals_plain(dev, case):
    shape, nb, lo, hi, density, one = ACC_CASES[case]
    got = _acc_check(_acc_labels(len(case), shape, nb, density, one), nb, lo,
                     hi)
    assert float(got.max()) > 0


def test_accumulator_on_the_diagram(dev):
    """The 768^2 smoke diagram's 8 label planes, with the cascade and the
    per-offset table; the dispatcher launches the kernel and calls no plain
    version."""
    from chip_smoke import render_diagram
    from img2sgf_tpu_torch.hough import circles
    from img2sgf_tpu_torch.pipeline.detect import _pre_circles, _variant_dedup

    cfg = DetectionConfig()
    rgb, _ = render_diagram()
    v = _pre_circles(torch.from_numpy(rgb).to(dev)[None], cfg)[2][0]
    keep, _ = _variant_dedup(cfg, v.shape[0])
    lbl = circles.circle_plane_state_pool(
        v[keep], cfg.circle_canny_high, 1, 30, cfg.num_angle_bins,
        cfg.hysteresis_iters, with_acc=False)["lbl"]
    assert lbl.shape == (8, 768, 768)
    for lo, hi in ((1, 30), (1, 31)):
        got = _acc_check(lbl, cfg.num_angle_bins, lo, hi)
        plain = accumulator_cuda.plain_calls
        before = accumulator_cuda.launches
        assert torch.equal(circles.vote_accumulator_pool_labels(
            lbl, cfg.num_angle_bins, lo, hi), got)
        assert accumulator_cuda.launches == before + 1
        assert accumulator_cuda.plain_calls == plain


def test_accumulator_capture_and_replay(dev):
    """Kernel A captured into a CUDA graph: the capture counts no launch,
    and each replay computes from the static input's current labels."""
    a = _acc_labels(1, (3, 150, 200), 64, 0.08)
    b = _acc_labels(2, (3, 150, 200), 64, 0.08)
    static = a.clone()
    accumulator_cuda.vote_accumulator_cuda(static, 64, 1, 30)  # the table
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = accumulator_cuda.launches
    with torch.cuda.graph(graph):
        out = accumulator_cuda.vote_accumulator_cuda(static, 64, 1, 30)
    assert accumulator_cuda.launches == before
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, _acc_plain(a, 64, 1, 30))
    static.copy_(b)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, _acc_plain(b, 64, 1, 30))


def test_accumulator_takes_an_unaligned_view(dev):
    """Labels whose first byte is not on a 16-byte boundary (a contiguous
    slice of a larger pool): chunks that cross the buffer's start and end
    are read byte by byte, and the result equals the plain version."""
    pool = _acc_labels(6, (3 * 61 * 131 + 5,), 64, 0.3)
    lab = pool[5:].view(3, 61, 131)
    assert lab.data_ptr() % 16 and lab.is_contiguous()
    _acc_check(lab, 64, 1, 30)


def test_accumulator_makes_no_sync(dev):
    """A warm call synchronises nothing (sync debug mode "error")."""
    lab = _acc_labels(4, (4, 128, 160), 64, 0.1)
    accumulator_cuda.vote_accumulator_cuda(lab, 64, 1, 31)
    torch.cuda.synchronize()
    before = accumulator_cuda.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = accumulator_cuda.vote_accumulator_cuda(lab, 64, 1, 31)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert accumulator_cuda.launches == before + 1
    assert torch.equal(out, _acc_plain(lab, 64, 1, 31))


def test_device_keyed_tables_name_the_card(dev):
    """The device-keyed table caches are keyed by str(tensor.device), which
    names the card's index, so each card keeps its own entry."""
    assert str(torch.empty(0, device=dev).device) == f"cuda:{dev.index}"
    assert str(torch.empty(0, device="cuda").device).startswith("cuda:")


def _cards(n_min=2):
    if torch.cuda.device_count() < n_min:
        pytest.skip(f"needs {n_min} or more cards")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def test_kernels_launch_on_the_tensors_card(dev):
    """K1, K2, K3, A, S1 and S2 on tensors of the last card, called while the
    thread's current device is card 0: each launches on its tensors' card
    and equals its plain version there."""
    last = _cards()[-1]
    rng = np.random.default_rng(3)
    pairs = [staircase_plane(rng, 120, 700) for _ in range(8)]
    e0 = pack_planes(torch.from_numpy(np.stack([s & c for s, c in pairs])).to(last))
    gate = pack_planes(torch.from_numpy(np.stack([c for _, c in pairs])).to(last))
    cfg, _, st = _two_image_pool(last)
    ys_c, xs_c, want, _ = pipeline_detect._select_candidates(
        st, cfg, margin_filter=True)
    k2 = (st["emask"], st["sx"], st["sy"], ys_c, xs_c, want,
          cfg.circle_min_radius, cfg.circle_max_radius)
    k3 = (st["emask"], ys_c, xs_c, want, cfg.circle_min_radius,
          cfg.circle_max_radius)
    with torch.cuda.device(0):
        h = hysteresis_cuda.hysteresis_packed(e0, gate, 256)
        r2 = rescore_cuda.exact_rescore(*k2, cells=5)
        r3 = radius_cuda.radius_support_pool(*k3)
        lab = _acc_labels(5, (3, 90, 140), 64, 0.1).to(last)
        ra = accumulator_cuda.vote_accumulator_cuda(lab, 64, 1, 30)
        planes = _state_pool(last, 6, 8, 70, 90)
        s1 = state_cuda.state_canny_cuda(planes, 100.0)
        s2 = state_cuda.state_steps_cuda(planes, s1[1], 64)
    torch.cuda.synchronize(last)
    assert h.device == r2.device == r3[0].device == ra.device == last
    assert s1[0].device == s2[0].device == last
    assert all(torch.equal(x, y) for x, y in zip(
        s1 + s2, state_cuda.state_canny_plain(planes, 100.0)
        + state_cuda.state_steps_plain(planes, s1[1], 64)))
    assert torch.equal(ra, _acc_plain(lab, 64, 1, 30))
    assert torch.equal(h, hysteresis_cuda.hysteresis_packed_plain(e0, gate, 256))
    assert torch.equal(r2, rescore_cuda.exact_rescore_plain(*k2, cells=5))
    plain = radius_cuda.radius_support_pool_plain(*k3)
    assert torch.equal(r3[0], plain[0]) and torch.equal(r3[1], plain[1])


def test_sharded_detector_across_cards(dev):
    """make_sharded_detector over every card (two or more) in the bucketed
    mode: K1 runs on every card, and the result equals the one-card batch
    in every field."""
    from chip_smoke import recording
    from img2sgf_tpu_torch.parallel import make_sharded_detector

    cards = _cards()
    cfg, can, _ = _two_image_pool(dev)
    n = len(cards)
    can_n = np.concatenate([can] * n)
    hs = ws = [192, 190] * n
    ths = [31] * (2 * n)
    want = detect_board_bucket_batch(can_n, cfg, ths, hs, ws, device=dev)
    with recording() as calls:
        got = make_sharded_detector(cards, cfg, bucketed=True)(can_n, ths, hs, ws)
    assert {a[0].device for a, _ in calls["K1"]} == set(cards)
    for f in dataclasses.fields(want):
        x, y = getattr(got, f.name), getattr(want, f.name)
        assert x.device == y.device and torch.equal(x, y), f.name


# --- kernels S1 and S2, the plane state's per-pixel work around K1


def _state_pool(dev, seed, P, H, W):
    """Seeded uint8 planes on the card: even planes a 5 x 5 box blur of
    noise with a dark disc (Canny edges and rings), odd planes raw noise
    (Sobel gradients out to |1020|)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    raw = torch.randint(0, 256, (P, H, W), generator=g, device=dev,
                        dtype=torch.uint8).float()
    smooth = torch.nn.functional.avg_pool2d(raw[:, None], 5, 1, 2)[:, 0]
    smooth = smooth * 0.6 + 60
    yy, xx = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    smooth[:, torch.hypot(yy - H / 2, xx - W / 3) < min(H, W) / 4] = 20
    even = (torch.arange(P, device=dev) % 2 == 0)[:, None, None]
    return torch.where(even, smooth.round(), raw).clamp(0, 255).to(torch.uint8)


def _state_dims(dev, kind, P, H, W, seed):
    """Content dims [P] int64 on the card: None (native), "bucket" (16
    images of 8 planes each, h and w in 641-768 but the first full), "random"
    (1..H, 1..W) or "extremes" (1 x 1, the full canvas, a column, a row)."""
    rng = np.random.default_rng(seed)
    if kind is None:
        return None
    if kind == "bucket":
        hs = np.repeat(rng.integers(641, H + 1, P // 8), 8)
        ws = np.repeat(rng.integers(641, W + 1, P // 8), 8)
        hs[:8], ws[:8] = H, W
    elif kind == "random":
        hs, ws = rng.integers(1, H + 1, P), rng.integers(1, W + 1, P)
    else:
        hs = np.resize([1, H, H, 1], P)
        ws = np.resize([1, W, 1, W], P)
    return tuple(torch.from_numpy(np.asarray(v, np.int64)).to(dev)
                 for v in (hs, ws))


# (P, H, W, content dims, num_angle_bins): the single image's 768^2 pool,
# the 768 bucket at B = 16, P = 40 (a last word group of 8 planes), content
# of 1 x 1 and of the whole canvas, and the extreme bin counts
STATE_CASES = {
    "768^2 P=8 native": (8, 768, 768, None, 64),
    "768 bucket B=16 P=128": (128, 768, 768, "bucket", 64),
    "P=40 random dims": (40, 130, 170, "random", 64),
    "1x1 and full content": (4, 90, 120, "extremes", 64),
    "bins 1": (8, 100, 140, "random", 1),
    "bins 254": (8, 100, 140, None, 254),
}


def _state_check(dev, planes, hw, nb, high=100.0):
    """S1 and S2 each equal their plain versions bit for bit on the card,
    one launch each, and the kernels call no plain version."""
    s1, s2 = state_cuda.s1_launches, state_cuda.s2_launches
    plain = state_cuda.plain_calls
    edge0, gate = state_cuda.state_canny_cuda(planes, high, hw)
    words = hysteresis_cuda.hysteresis_packed(edge0, gate, 256)
    got = state_cuda.state_steps_cuda(planes, words, nb, hw)
    assert (state_cuda.s1_launches, state_cuda.s2_launches) == (s1 + 1, s2 + 1)
    assert state_cuda.plain_calls == plain
    want = state_cuda.state_canny_plain(planes, high, hw)
    assert torch.equal(edge0, want[0]) and torch.equal(gate, want[1])
    for x, y in zip(got, state_cuda.state_steps_plain(planes, words, nb, hw)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    return got


@pytest.mark.parametrize("case", list(STATE_CASES))
def test_state_kernels_equal_plain(dev, case):
    P, H, W, kind, nb = STATE_CASES[case]
    planes = _state_pool(dev, len(case), P, H, W)
    emask, sx, _, lbl = _state_check(
        dev, planes, _state_dims(dev, kind, P, H, W, len(case)), nb)
    assert bool(emask.any()) and int(sx.abs().max()) <= 1024
    assert int(lbl.max()) == nb and int(lbl[emask].max()) < nb


@pytest.mark.parametrize("min_r", [0, 1])
def test_plane_state_pool_on_the_card(dev, min_r):
    """circle_plane_state_pool of a two-image pool (content dims per plane)
    on the card: S1, K1, S2 and A once each, no plain version, every field
    equal to the CPU run; circle_min_radius 0 included."""
    cfg, _, planes, hw = _two_image_planes(dev)
    counters = (state_cuda, accumulator_cuda, hysteresis_cuda)
    plain = [m.plain_calls for m in counters]
    before = (state_cuda.s1_launches, state_cuda.s2_launches,
              hysteresis_cuda.launches, accumulator_cuda.launches)
    from img2sgf_tpu_torch.hough.circles import circle_plane_state_pool

    args = (cfg.circle_canny_high, min_r, 29 if min_r == 0 else 30,
            cfg.num_angle_bins, cfg.hysteresis_iters)
    got = circle_plane_state_pool(planes, *args, hw_planes=hw)
    assert (state_cuda.s1_launches, state_cuda.s2_launches,
            hysteresis_cuda.launches, accumulator_cuda.launches) == tuple(
                b + 1 for b in before)
    assert [m.plain_calls for m in counters] == plain
    want = circle_plane_state_pool(planes.cpu(), *args,
                                   hw_planes=tuple(v.cpu() for v in hw))
    for k, v in want.items():
        assert torch.equal(got[k].cpu(), v), k


def test_state_capture_and_replay(dev):
    """S1 and S2 captured into a CUDA graph (their label table built
    before): the capture counts no launch, and each replay computes from
    the static input's current planes."""
    a = _state_pool(dev, 1, 8, 96, 130)
    b = _state_pool(dev, 2, 8, 96, 130)
    hw = _state_dims(dev, "random", 8, 96, 130, 3)
    static = a.clone()
    words = torch.zeros((1, 96, 130), dtype=torch.int32, device=dev)
    state_cuda.state_steps_cuda(static, words, 64, hw)  # the table
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = (state_cuda.s1_launches, state_cuda.s2_launches)
    with torch.cuda.graph(graph):
        edge0, gate = state_cuda.state_canny_cuda(static, 100.0, hw)
        out = state_cuda.state_steps_cuda(static, gate, 64, hw)
    assert (state_cuda.s1_launches, state_cuda.s2_launches) == before
    for planes in (a, b):
        static.copy_(planes)
        graph.replay()
        torch.cuda.synchronize()
        want = state_cuda.state_canny_plain(planes, 100.0, hw)
        assert torch.equal(edge0, want[0]) and torch.equal(gate, want[1])
        for x, y in zip(out, state_cuda.state_steps_plain(planes, want[1], 64,
                                                          hw)):
            assert torch.equal(x, y)


def test_state_makes_no_sync(dev):
    """Warm S1 and S2 calls synchronise nothing (sync debug mode
    "error")."""
    planes = _state_pool(dev, 4, 8, 128, 160)
    hw = _state_dims(dev, "random", 8, 128, 160, 4)
    words = hysteresis_cuda.hysteresis_packed(
        *state_cuda.state_canny_cuda(planes, 100.0, hw), 256)
    state_cuda.state_steps_cuda(planes, words, 64, hw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        e0, g = state_cuda.state_canny_cuda(planes, 100.0, hw)
        out = state_cuda.state_steps_cuda(planes, words, 64, hw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = state_cuda.state_steps_plain(planes, words, 64, hw)
    assert all(torch.equal(x, y) for x, y in zip(out, want))


# --- the captured CUDA graphs of the jitted entry points (pipeline/graphs.py)

def _equal_results(got, want, label):
    for f in dataclasses.fields(want):
        x, y = getattr(got, f.name), getattr(want, f.name)
        assert x.shape == y.shape and x.dtype == y.dtype, (label, f.name)
        assert torch.equal(x, y), (label, f.name)


def _graph_case(entry, overflow):
    """(graphed call, eager call) of an entry point on 256^2 diagrams: the
    noisy one saturates planes at the default config (the chunk graphs
    run); overflow=False turns the rerun off (one graph per call)."""
    from chip_smoke import noisy_diagram, render_diagram
    from img2sgf_tpu_torch.pipeline import (
        detect_board_auto, detect_board_batch, detect_board_jit)

    cfg = DetectionConfig()
    if not overflow:
        cfg = cfg.replace(overflow_center_candidates=0)
    noisy = noisy_diagram()
    clean, _ = render_diagram(size=240, n=9, n_stones=10, seed=5)
    if entry == "jit":
        return (lambda d: detect_board_jit(noisy, cfg, 30, device=d),
                lambda d: detect_board(noisy, cfg, 30, device=d))
    if entry == "auto":
        return (lambda d: detect_board_auto(clean, cfg, 30, device=d),
                lambda d: detect_board_auto(clean, cfg, 30, device=d,
                                            timings={}))
    if entry == "batch":
        imgs = np.stack([noisy, noisy[::-1].copy()])
        return (lambda d: detect_board_batch(imgs, cfg, [30, 29], device=d),
                lambda d: detect_board_batch(imgs, cfg, [30, 29], device=d,
                                             timings={}))
    can = np.zeros((2, 256, 256, 3), np.uint8)
    can[0] = noisy
    can[1, :240, :240] = clean
    args = (can, cfg, [30, 29], [256, 240], [256, 240])
    return (lambda d: detect_board_bucket_batch(*args, device=d),
            lambda d: detect_board_bucket_batch(*args, device=d, timings={}))


@pytest.mark.parametrize("overflow", [True, False], ids=["overflow", "off"])
@pytest.mark.parametrize("entry", ["jit", "auto", "batch", "bucket_batch"])
def test_graphed_entry_point_equals_eager(dev, entry, overflow):
    """Each graphed entry point equals its eager run in every field, on its
    first call (warm-up and capture, then a replay) and on a warm replay."""
    from img2sgf_tpu_torch.pipeline import graphs

    graphed, eager = _graph_case(entry, overflow)
    want = eager(dev)
    before = graphs.replays
    _equal_results(graphed(dev), want, "first call")
    _equal_results(graphed(dev), want, "warm replay")
    assert graphs.replays >= before + 2


def test_graph_replay_takes_new_inputs(dev):
    """A replay computes from its own inputs: the second image's result,
    not the captured one's."""
    from chip_smoke import render_diagram
    from img2sgf_tpu_torch.pipeline import detect_board_jit

    cfg = DetectionConfig()
    a, _ = render_diagram(size=224, n=9, n_stones=10, seed=1)
    b, _ = render_diagram(size=224, n=9, n_stones=10, seed=2)
    ra = detect_board_jit(a, cfg, 30, device=dev)
    rb = detect_board_jit(b, cfg, 29, device=dev)
    _equal_results(rb, detect_board(b, cfg, 29, device=dev), "second input")
    _equal_results(ra, detect_board(a, cfg, 30, device=dev), "first input")
    assert not torch.equal(ra.detected_board, rb.detected_board)


@pytest.mark.parametrize("overflow", [True, False], ids=["overflow", "off"])
def test_graph_replay_makes_no_sync(dev, overflow):
    """A warm replay makes no host synchronisation that PyTorch's sync
    debug mode sees; the saturation flags are read once (an event wait,
    which the mode does not see) with the rerun on, never with it off."""
    from img2sgf_tpu_torch.pipeline import graphs

    graphed, _ = _graph_case("auto", overflow)
    graphed(dev)
    graphed(dev)
    torch.cuda.synchronize()
    reads = pipeline_detect.flag_reads
    before = graphs.replays
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = graphed(dev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert graphs.replays > before
    assert pipeline_detect.flag_reads == reads + (1 if overflow else 0)
    assert bool(res.board_ready)


def test_graph_outlives_evicted_constants(dev):
    """Every device-constant cache drops its tables and their memory is
    handed out again and overwritten: a live graph still reads its own
    copies and gives the same result."""
    from img2sgf_tpu_torch.hough import circles, lines

    graphed, eager = _graph_case("jit", True)
    want = eager(dev)
    _equal_results(graphed(dev), want, "captured")
    for fn in (rescore_cuda._rhat_on, radius_cuda._tables_on,
               accumulator_cuda._table_on, state_cuda.label_table,
               lines._vote_bins, state_cuda._bin_exceptions_on,
               circles._centre_on, circles._ring_on):
        fn.cache_clear()
    junk = [torch.full((n,), -7, dtype=torch.int64, device=dev)
            for n in (8, 16, 64, 512, 4096, 65536) for _ in range(64)]
    _equal_results(graphed(dev), want, "after the caches dropped their tables")
    assert junk[-1].min() == -7


def test_graph_cache_drops_least_recent_key(dev, monkeypatch):
    """With room for two one-graph keys, a third key drops the least
    recently used one, which is captured again at its next call and still
    equals eager detection."""
    from chip_smoke import render_diagram
    from img2sgf_tpu_torch.pipeline import detect_board_jit, graphs

    monkeypatch.setattr(graphs, "MAX_GRAPHS", 2)
    graphs.clear()
    cfg = DetectionConfig(overflow_center_candidates=0)
    imgs = [render_diagram(size=s, n=9, n_stones=8, seed=s)[0]
            for s in (160, 176, 192)]
    for im in imgs:
        detect_board_jit(im, cfg, 25, device=dev)
    cache = graphs.cache_for(dev)
    assert [k[2] for k in cache.keys] == [176, 192]
    before = graphs.captures
    got = detect_board_jit(imgs[0], cfg, 25, device=dev)
    assert graphs.captures == before + 1
    assert [k[2] for k in cache.keys] == [192, 160]
    _equal_results(got, detect_board(imgs[0], cfg, 25, device=dev), "recaptured")
    graphs.clear()


@pytest.mark.parametrize("entry, overflow", [
    ("auto", True), ("auto", False), ("bucket_batch", True)])
def test_graphed_calls_alternating_inputs_equal_eager(dev, entry, overflow):
    """Graphed calls of one key that alternate two inputs back to back (no
    sync between them; with the rerun off no host read either) each equal
    the eager run of their own input in every field, and warm calls
    capture nothing (chip_smoke.alternating_calls: detect_board_auto at
    768^2 and 767 x 700 in the 768 bucket, detect_board_bucket_batch at
    B = 16)."""
    from chip_smoke import alternating_calls

    cfg = DetectionConfig()
    if not overflow:
        cfg = cfg.replace(overflow_center_candidates=0)
    rec = alternating_calls(dev, cfg, entry)
    assert rec["captures"] == 0


def test_graphed_call_takes_an_input_on_the_card(dev):
    """A CUDA input goes into the graph's static canvas with no host copy:
    detect_board_auto of a 767 x 700 page given as a CUDA tensor, after a
    call with a host image of the same key, equals the eager run."""
    from chip_smoke import page_diagram
    from img2sgf_tpu_torch.pipeline import detect_board_auto

    cfg = DetectionConfig()
    page = page_diagram(767, 700, 7)
    detect_board_auto(page[::-1].copy(), cfg, 30, device=dev)
    got = detect_board_auto(torch.from_numpy(page).to(dev), cfg, 30,
                            device=dev)
    _equal_results(got, detect_board_auto(page, cfg, 30, device=dev,
                                          timings={}), "CUDA input")


def test_to_sgf_of_a_board_on_the_card(dev):
    """to_sgf takes a CUDA tensor and writes what it writes for the same
    board on the host."""
    from img2sgf_tpu_torch.core import to_sgf

    board = np.random.default_rng(3).integers(0, 4, (19, 19)).astype(np.int32)
    for side in (1, 2):
        assert to_sgf(torch.from_numpy(board).to(dev), side) == \
            to_sgf(board, side)


def test_graphs_from_threads_sharing_a_stream(dev):
    """Four threads call detect_board_jit at once on the default stream
    (one graph cache, one set of static buffers) with two images in turns:
    each result is its own image's eager one."""
    import sys
    import threading

    from chip_smoke import render_diagram
    from img2sgf_tpu_torch.pipeline import detect_board_jit

    cfg = DetectionConfig()
    imgs = [render_diagram(size=208, n=9, n_stones=10, seed=s)[0]
            for s in (3, 4)]
    want = [detect_board(im, cfg, 28, device=dev) for im in imgs]
    detect_board_jit(imgs[0], cfg, 28, device=dev)  # capture
    bad, done = [], []

    def work(t):
        for i in range(6):
            k = (t + i) % 2
            got = detect_board_jit(imgs[k], cfg, 28, device=dev)
            if not all(torch.equal(getattr(got, f.name), getattr(want[k], f.name))
                       for f in dataclasses.fields(got)):
                bad.append((t, i))
        done.append(t)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads)
    assert sorted(done) == [0, 1, 2, 3] and not bad, bad


def _run_child(code):
    import subprocess
    import sys

    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600,
                          cwd=str(__import__("pathlib").Path(__file__)
                                  .resolve().parent.parent))


def test_k2_gap_fails_device_assert(dev):
    """A gap in K2's valid prefix fails a device assert on the card (in a
    child process: the assert ends its CUDA context)."""
    proc = _run_child(
        "import torch\n"
        "from img2sgf_tpu_torch.hough.rescore_cuda import exact_rescore\n"
        "d = torch.device('cuda', 0)\n"
        "e = torch.zeros((1, 32, 32), dtype=torch.bool, device=d)\n"
        "s = torch.zeros((1, 32, 32), dtype=torch.int32, device=d)\n"
        "y = torch.full((1, 4), 9, dtype=torch.int64, device=d)\n"
        "v = torch.tensor([[True, False, True, False]], device=d)\n"
        "exact_rescore(e, s, s, y, y, v, 1, 8)\n"
        "torch.cuda.synchronize()\n"
        "print('no assert')\n")
    assert proc.returncode != 0, proc.stdout
    assert "no assert" not in proc.stdout
    assert "assert" in (proc.stderr + proc.stdout).lower(), proc.stderr[-2000:]


def test_failed_capture_raises(dev):
    """A segment that reads a value back cannot be captured: the call
    raises (naming the capture) and runs nothing eagerly in its place (in
    a child process)."""
    proc = _run_child(
        "import numpy as np, torch\n"
        "from img2sgf_tpu_torch import DetectionConfig\n"
        "from img2sgf_tpu_torch.pipeline import detect, detect_board_jit\n"
        "post = detect._segment_post\n"
        "def reads(sel, *a, **k):\n"
        "    sel.grey.sum().item()\n"
        "    return post(sel, *a, **k)\n"
        "detect._segment_post = reads\n"
        "img = np.full((96, 96, 3), 200, np.uint8)\n"
        "cfg = DetectionConfig(overflow_center_candidates=0)\n"
        "try:\n"
        "    detect_board_jit(img, cfg, 20, device='cuda')\n"
        "except RuntimeError as e:\n"
        "    print('raised:', str(e)[:300])\n"
        "else:\n"
        "    print('ran')\n")
    assert "raised: CUDA graph capture of the detector failed" in proc.stdout, \
        proc.stdout + proc.stderr[-2000:]
