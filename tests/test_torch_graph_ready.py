"""The port's pipeline in the form its CUDA graphs capture (pipeline/
graphs.py), on the CPU: the overflow rerun in fixed chunks of planes (the
JAX package's lax.map/lax.cond form) equals the JAX package and the old
variable-size rerun, the three capture segments read nothing back to the
host, and detect_board_jit equals the JAX package's. The card-only checks
of the graphs themselves are in tests/test_torch_cuda.py."""

import collections
import dataclasses

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import jax.numpy as jnp

from img2sgf_tpu.pipeline import detect_board_jit as jax_detect_board_jit

from img2sgf_tpu_torch import detect_board_jit
from img2sgf_tpu_torch.config import from_jax_config
from img2sgf_tpu_torch.hough import greedy_cuda, radius_cuda, rescore_cuda
from img2sgf_tpu_torch.ops import hysteresis_cuda
from img2sgf_tpu_torch.pipeline import detect as tdetect
from test_torch_pipeline import (
    OVERFLOW, TINY, _compare, _noisy_board, cap_torch_threads, synth_board)

cap_torch_threads()


def _tcfg(jcfg):
    return from_jax_config(dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def overflow_state():
    """The noisy diagram's plane state at the OVERFLOW config (7 of its 8
    unique planes saturate the base budgets)."""
    cfg = _tcfg(OVERFLOW)
    sel = tdetect._segment_select(torch.from_numpy(_noisy_board())[None], cfg)
    return cfg, sel.pooled.st


def test_detect_board_jit_equals_jax():
    rgb = synth_board()
    jres = jax_detect_board_jit(jnp.asarray(rgb), TINY, 28.0)
    _compare(jres, detect_board_jit(rgb, _tcfg(TINY), 28.0, device="cpu"))


def test_chunked_overflow_equals_jax_every_field():
    """The chunked rerun (two chunks of four planes here, the second with
    an unsaturated plane in it) gives the JAX package's detect_board_jit
    in every field."""
    rgb = _noisy_board()
    jres = jax_detect_board_jit(jnp.asarray(rgb), OVERFLOW, 26.0)
    reads = tdetect.flag_reads
    _compare(jres, detect_board_jit(rgb, _tcfg(OVERFLOW), 26.0, device="cpu"))
    assert tdetect.flag_reads == reads + 1


def _variable_size_rerun(st, cfg):
    """The rerun as the port ran it before: the saturated planes' state
    gathered by a host read of their indices, one pass over them."""
    circles, valid, sat = tdetect._circles_from_state(st, cfg,
                                                      margin_filter=True)
    redo = sat.nonzero()[:, 0]
    sub = {k: v[redo] for k, v in st.items()}
    big_c, big_v, _ = tdetect._circles_from_state(
        sub, cfg, **tdetect._overflow_budgets(cfg))
    circles[redo] = big_c
    valid[redo] = big_v
    return circles, valid, sat


@pytest.mark.parametrize("chunk", [1, 2, 4, 8])
def test_chunked_rerun_equals_variable_size_rerun(overflow_state, chunk,
                                                  monkeypatch):
    """Chunks of 1 and 2 planes split the saturated planes over several
    chunks, 4 puts an unsaturated plane beside three saturated ones, 8
    holds all of them in one chunk: every width gives the variable-size
    rerun's circles and flags, and runs ceil(n_sat / chunk) chunks."""
    cfg, st = overflow_state
    want_c, want_v, sat = _variable_size_rerun(st, cfg)
    n_sat = int(sat.sum())
    assert 1 < n_sat < sat.numel()
    monkeypatch.setattr(tdetect, "_overflow_chunk", lambda P: chunk)
    ran = []
    run = tdetect._segment_chunk
    monkeypatch.setattr(tdetect, "_segment_chunk",
                        lambda p, idx, c: (ran.append(idx.tolist()), run(p, idx, c)))
    got_c, got_v = tdetect._circles_pooled(st, cfg)
    assert len(ran) == -(-n_sat // chunk)
    assert all(len(idx) == chunk for idx in ran)
    rerun = sorted(i for idx in ran for i in idx)
    assert set(sat.nonzero()[:, 0].tolist()) <= set(rerun)
    assert len(set(rerun)) == len(rerun)
    np.testing.assert_array_equal(got_c.numpy(), want_c.numpy())
    np.testing.assert_array_equal(got_v.numpy(), want_v.numpy())


def test_rerun_order_puts_saturated_planes_first(overflow_state):
    cfg, st = overflow_state
    pooled = tdetect._select_base(st, cfg)
    order, sat = pooled.order.tolist(), pooled.sat.tolist()
    n_sat = sum(sat)
    assert sorted(order) == list(range(len(sat)))
    assert all(sat[i] for i in order[:n_sat])
    assert not any(sat[i] for i in order[n_sat:])
    assert order[:n_sat] == sorted(order[:n_sat])  # stable


# the calls that read a tensor's value back to the host, or make a tensor
# from host data (an upload on a card)
HOST_READS = {"__bool__", "item", "tolist", "nonzero", "__int__", "__float__",
              "__index__", "numpy", "tensor", "as_tensor", "from_numpy"}
SEGMENTS = ("_segment_select", "_segment_chunk", "_segment_post")
# the plain versions of the kernels, and the CPU form of K2's prefix check:
# the card runs kernels (or a device assert) in their place
PLAIN = ((hysteresis_cuda, "hysteresis_packed_plain"),
         (rescore_cuda, "exact_rescore_plain"),
         (rescore_cuda, "_raise_on_gap"),
         (radius_cuda, "radius_support_pool_plain"),
         (greedy_cuda, "greedy_min_dist_plain"))


class _HostReadGuard(TorchFunctionMode):
    """Counts HOST_READS calls made inside a capture segment and outside
    the kernels' plain versions."""

    def __init__(self):
        super().__init__()
        self.seen = collections.Counter()
        self.segments = collections.Counter()
        self.depth = 0   # inside a segment
        self.paused = 0  # inside a plain version

    def note(self, name):
        if self.depth and not self.paused and name in HOST_READS:
            self.seen[name] += 1

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.note(getattr(func, "__name__", ""))
        return func(*args, **(kwargs or {}))


def _guarded(monkeypatch, guard):
    def segment(name, fn):
        def wrapped(*a, **kw):
            guard.segments[name] += 1
            guard.depth += 1
            try:
                return fn(*a, **kw)
            finally:
                guard.depth -= 1
        return wrapped

    def plain(fn):
        def wrapped(*a, **kw):
            guard.paused += 1
            try:
                return fn(*a, **kw)
            finally:
                guard.paused -= 1
        return wrapped

    for name in SEGMENTS:
        monkeypatch.setattr(tdetect, name, segment(name, getattr(tdetect, name)))
    for mod, name in PLAIN:
        monkeypatch.setattr(mod, name, plain(getattr(mod, name)))
    from_numpy = torch.from_numpy

    def counted_from_numpy(a):
        guard.note("from_numpy")
        return from_numpy(a)
    monkeypatch.setattr(torch, "from_numpy", counted_from_numpy)


@pytest.mark.parametrize("jcfg,rgb,reads", [
    (OVERFLOW, _noisy_board(), 1),
    (TINY, synth_board(), 0),
], ids=["overflow", "no_overflow"])
def test_segments_read_nothing_back(jcfg, rgb, reads, monkeypatch):
    """A warm CPU call with the capture segments under a guard: no value
    is read back and no host data is made into a tensor inside them; the
    call's one read of the saturation flags sits outside them, and a
    config without the rerun makes none."""
    cfg = _tcfg(jcfg)
    detect_board_jit(rgb, cfg, 26.0, device="cpu")  # warm
    guard = _HostReadGuard()
    _guarded(monkeypatch, guard)
    before = tdetect.flag_reads
    with guard:
        detect_board_jit(rgb, cfg, 26.0, device="cpu")
    assert tdetect.flag_reads == before + reads
    assert guard.segments["_segment_select"] == 1
    assert guard.segments["_segment_post"] == 1
    assert (guard.segments["_segment_chunk"] > 0) == bool(reads)
    assert not guard.seen, dict(guard.seen)


def test_guard_sees_host_reads(monkeypatch):
    """The guard is not blind: host reads made inside a segment count."""
    guard = _HostReadGuard()

    def reads(*_):
        x = torch.ones(3)
        bool(x[0]), x.sum().item(), x.tolist(), x.nonzero(), int(x[0])
        torch.tensor([1.0]), torch.from_numpy(np.ones(2))

    monkeypatch.setattr(tdetect, "_segment_post", reads)
    _guarded(monkeypatch, guard)
    with guard:
        tdetect._segment_post()
    assert set(guard.seen) == {"__bool__", "item", "tolist", "nonzero",
                               "__int__", "tensor", "from_numpy"}


def test_k2_prefix_check_raises_on_cpu():
    P, H, W, K = 2, 24, 24, 5
    emask = torch.zeros((P, H, W), dtype=torch.bool)
    sx = torch.zeros((P, H, W), dtype=torch.int32)
    ys = torch.full((P, K), 10, dtype=torch.int64)
    valid = torch.tensor([[True, True, False, False, False],
                          [True, False, True, False, False]])
    with pytest.raises(ValueError, match="prefix"):
        rescore_cuda.exact_rescore(emask, sx, sx, ys, ys, valid, 1, 8)
    rescore_cuda.exact_rescore(emask, sx, sx, ys, ys, valid[:1].expand(P, K),
                               1, 8)


@pytest.mark.parametrize("maxblur", [-1, 0, 3])
def test_take_equals_index_lists(maxblur):
    """The variant selection by slices equals indexing by the lists of
    _variant_dedup."""
    cfg = _tcfg(TINY).replace(maxblur=maxblur)
    V = 2 + 2 * (maxblur + 1)
    x = torch.arange(3 * V * 2).reshape(3, V, 2)
    keep, expand = tdetect._variant_dedup(cfg, V)
    u = tdetect._take(x, keep)
    assert torch.equal(u, x[:, keep])
    assert torch.equal(tdetect._take(u, expand), u[:, expand])


def test_detect_board_jit_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this pins the no-card error")
    with pytest.raises(RuntimeError, match="cuda"):
        detect_board_jit(synth_board(), _tcfg(TINY), 28.0)


@pytest.mark.parametrize("P, n_sat", [
    (8, 0), (8, 1), (8, 4), (8, 5), (8, 8), (128, 33)])
def test_chunks_to_run_counts_saturated_chunks(P, n_sat):
    """The rerun covers the first ceil(n_sat / chunk) chunks of the order,
    wherever the saturated planes lie, through one flag read a call; with
    the rerun off (no flags) there is no read and no chunk."""
    rng = np.random.default_rng(P * 1000 + n_sat)
    sat = torch.zeros(P, dtype=torch.bool)
    sat[torch.from_numpy(rng.permutation(P)[:n_sat])] = True
    pooled = tdetect._Pooled({}, torch.zeros((P, 3, 3)), torch.zeros((P, 3)),
                             sat)
    reads = tdetect.flag_reads
    assert tdetect._chunks_to_run(pooled) == -(-n_sat // pooled.chunk)
    assert tdetect.flag_reads == reads + 1
    pooled.sat = None
    assert tdetect._chunks_to_run(pooled) == 0
    assert tdetect.flag_reads == reads + 1
