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

from chip_smoke import staircase_plane
from img2sgf_tpu_torch.config import DetectionConfig
from img2sgf_tpu_torch.hough import radius_cuda, rescore_cuda
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


def _two_image_pool(dev):
    """The plane state of two diagrams of mixed sizes in one 192 canvas
    (margins 0 and 2): 16 planes with per-plane content dims."""
    imgs = [_diagram(192), _diagram(190, n=7)]
    can = np.zeros((2, 192, 192, 3), np.uint8)
    for i, im in enumerate(imgs):
        can[i, :im.shape[0], :im.shape[1]] = im
    cfg = DetectionConfig()
    hw = (torch.tensor([192, 190], device=dev), torch.tensor([192, 190], device=dev))
    _, _, v = pipeline_detect._pre_circles(torch.from_numpy(can).to(dev), cfg, hw)
    keep, _ = pipeline_detect._variant_dedup(cfg, v.shape[1])
    planes = v[:, keep].reshape(-1, 192, 192)
    st = pipeline_detect._plane_state_pool(
        planes, cfg, tuple(t.repeat_interleave(len(keep)) for t in hw))
    return cfg, can, st


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
    batch equals the CPU batch, with 2 K1, 2 K2 and 1 K3 launches."""
    cfg, can, _ = _two_image_pool(dev)
    hs = ws = [192, 190]
    counters = (hysteresis_cuda, rescore_cuda, radius_cuda)
    before = [m.launches for m in counters]
    a = detect_board_bucket_batch(can, cfg, [31, 31], hs, ws, device=dev)
    assert [m.launches - b for m, b in zip(counters, before)] == [2, 2, 1]
    b = detect_board_bucket_batch(can, cfg, [31, 31], hs, ws, device="cpu")
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name).cpu(), getattr(b, f.name)
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
    in every field, and launches each kernel from both threads."""
    from img2sgf_tpu_torch.parallel import make_sharded_detector

    cfg, can, _ = _two_image_pool(dev)
    hs = ws = [192, 190]
    want = detect_board_bucket_batch(can, cfg, [31, 31], hs, ws, device=dev)
    counters = (hysteresis_cuda, rescore_cuda, radius_cuda)
    before = [m.launches for m in counters]
    got = make_sharded_detector([dev, dev], cfg, bucketed=True)(can, [31, 31], hs, ws)
    assert [m.launches - b for m, b in zip(counters, before)] == [4, 4, 2]
    for f in dataclasses.fields(want):
        x, y = getattr(got, f.name), getattr(want, f.name)
        assert x.device == y.device and torch.equal(x, y), f.name


def test_sharded_detector_orders_its_streams(dev, monkeypatch):
    """The shards' streams wait for the caller's queued work on the images,
    and the caller reads a shard's results only once they are written: with
    the caller's stream held back (about half a second) before it writes the
    images, and each shard's stream held back before it stacks its rows, the
    two-stream run still equals the one-device batch in every field."""
    from img2sgf_tpu_torch.parallel import make_sharded_detector, mesh

    cycles = 10**9
    cfg, can, _ = _two_image_pool(dev)
    hs = ws = [192, 190]
    want = detect_board_bucket_batch(can, cfg, [31, 31], hs, ws, device=dev)
    stack = mesh._stack

    def slow_stack(rows):
        torch.cuda._sleep(cycles)  # on the shard's stream
        return stack(rows)

    monkeypatch.setattr(mesh, "_stack", slow_stack)
    run = make_sharded_detector([dev, dev], cfg, bucketed=True)
    src = torch.from_numpy(can).to(dev)
    images = torch.full_like(src, 255)
    torch.cuda.synchronize(dev)
    torch.cuda._sleep(cycles)  # on the caller's stream
    images.copy_(src)
    got = run(images, [31, 31], hs, ws)
    for f in dataclasses.fields(want):
        x, y = getattr(got, f.name), getattr(want, f.name)
        assert x.device == y.device and torch.equal(x, y), f.name


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
    """K1, K2 and K3 on tensors of the last card, called while the thread's
    current device is card 0: each launches on its tensors' card and equals
    its plain version there."""
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
    torch.cuda.synchronize(last)
    assert h.device == r2.device == r3[0].device == last
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
