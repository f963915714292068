"""Captured CUDA graphs of the detector: the port's counterpart of the JAX
package's jax.jit program cache (detect_board_jit, _detect_board_bucket_jit,
detect_board_batch, detect_board_bucket_batch).

A jitted JAX entry point is one compiled program per shape and config,
launched with no host round trip. Here it is a set of CUDA graphs per key
(native or bucketed, B, H, W, DetectionConfig) in a cache of each (device,
stream), captured at the key's first call and replayed after:

  * with the overflow rerun on, three graphs: _segment_select (pre, plane
    state, base selection), _segment_chunk (the big-budget rerun of one
    chunk of planes, whose indices it reads from a static device buffer)
    and _segment_post (merge, post). A call replays the first, reads the P
    saturation flags (its one host read), replays the chunk graph once per
    chunk that holds a saturated plane (lax.map with lax.cond), then the
    last;
  * with the rerun off, one graph of the whole call, and no host read.

The inputs are copied into the graphs' static buffers, and the outputs are
cloned after the replay: JAX returns fresh arrays, and the next replay
overwrites the static ones. The arithmetic is the eager segments', so the
results are bit-equal to _detect_batch_impl's.

First use of a key: one eager warm-up of the segments on a side stream
(it builds the kernels and fills the device-constant caches), then the
capture. A capture that fails raises; nothing runs eagerly in its place.

Memory: the graphs of one (device, stream) share one graph memory pool.
Replays on one stream run one after another and every value that crosses
a segment (inputs, the selection, outputs) stays allocated while its graph
lives, so sharing the pool is safe. A cache holds at most MAX_GRAPHS
graphs and drops its least recently used key to make room; dropping a key
frees its graphs. A graph reads each device constant (a cached table) at
its address during the capture, so each key keeps every such tensor its
capture took (_devconst.keep_device_constants), whatever its cache drops.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time

import torch

from .._devconst import keep_device_constants
from ..config import DetectionConfig
from ..ops.hysteresis_cuda import card_turn
from . import detect

MAX_GRAPHS = 8  # graphs per (device, stream) cache

# counts, added to under _lock: graphs captured and graph replays
captures = 0
replays = 0
_lock = threading.Lock()
_caches: dict = {}  # (device index, stream handle) -> _Cache
_capture_locks: dict = {}  # device index -> lock: one capture at a time


class _Key:
    """A key's graphs, their static inputs and outputs, and the device
    constants they read."""

    def __init__(self, rgb, cfg: DetectionConfig, ths, hw, cache: "_Cache"):
        dev = rgb.device
        self.cfg = cfg
        self.rgb = rgb.clone()
        self.ths = detect._to_device(ths, dev).clone()
        self.hw = None if hw is None else tuple(
            detect._to_device(v, dev).clone() for v in hw)
        self.overflow = detect._overflow_on(cfg)
        self.constants: list = []
        self.graphs: list = []
        t0 = time.perf_counter()
        self._warm_up(cache.stream)
        self._capture(cache)
        # the saturation flags' pinned buffer, one per key, reused each call
        self.flags = None if not self.overflow else torch.empty(
            self.sel.pooled.sat.shape, dtype=torch.bool, pin_memory=True)
        self.capture_s = time.perf_counter() - t0

    def _warm_up(self, side):
        """One eager run of every segment on the side stream (the rerun on
        the first chunk of the order, saturated or not)."""
        caller = torch.cuda.current_stream(self.rgb.device)
        side.wait_stream(caller)
        with torch.cuda.stream(side):
            sel = detect._segment_select(self.rgb, self.cfg, self.hw)
            if self.overflow:
                pooled = sel.pooled
                detect._segment_chunk(pooled, pooled.order[:pooled.chunk],
                                      self.cfg)
            detect._segment_post(sel, self.cfg, self.ths, self.hw)
        caller.wait_stream(side)

    def _graph(self, cache: "_Cache", fn, what: str):
        """Capture fn() into a new graph of the cache's pool; fn's value."""
        global captures
        g = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(g, pool=cache.pool, stream=cache.stream,
                                  capture_error_mode="thread_local"):
                out = fn()
        except Exception as e:
            raise RuntimeError(
                f"CUDA graph capture of {what} failed for {self.describe()}: "
                f"{e}") from e
        self.graphs.append(g)
        with _lock:
            captures += 1
        return out

    def _capture(self, cache: "_Cache"):
        cfg, hw = self.cfg, self.hw
        dev = self.rgb.device
        lock = _capture_locks.setdefault(dev.index, threading.Lock())
        with lock, keep_device_constants(self.constants):
            if not self.overflow:
                def whole():
                    sel = detect._segment_select(self.rgb, cfg, hw)
                    return sel, detect._segment_post(sel, cfg, self.ths, hw)
                self.sel, self.out = self._graph(cache, whole, "the detector")
                return
            self.sel = self._graph(
                cache, lambda: detect._segment_select(self.rgb, cfg, hw),
                "the select segment")
            self.idx = torch.zeros(self.sel.pooled.chunk, dtype=torch.int64,
                                   device=dev)
            self._graph(cache, lambda: detect._segment_chunk(
                self.sel.pooled, self.idx, cfg), "the overflow chunk")
            self.out = self._graph(cache, lambda: detect._segment_post(
                self.sel, cfg, self.ths, hw), "the post segment")

    def describe(self) -> str:
        B, H, W = self.rgb.shape[:3]
        kind = "native" if self.hw is None else "bucketed"
        return f"{kind} B={B} {H}x{W} on {self.rgb.device}"

    def replay(self, rgb, ths, hw) -> detect.BoardResult:
        """The call's result from the graphs: inputs into the static
        buffers, replays, fresh copies of the outputs."""
        global replays
        dev = rgb.device
        self.rgb.copy_(rgb)
        self.ths.copy_(detect._to_device(ths, dev))
        if hw is not None:
            for buf, v in zip(self.hw, hw):
                buf.copy_(detect._to_device(v, dev))
        n = 1
        with card_turn(dev):  # the first graph holds both K1 calls
            self.graphs[0].replay()
        if self.overflow:
            pooled = self.sel.pooled
            rp = pooled.chunk
            for c in range(detect._chunks_to_run(pooled, self.flags)):
                self.idx.copy_(pooled.order[c * rp:(c + 1) * rp])
                self.graphs[1].replay()
                n += 1
            self.graphs[2].replay()
            n += 1
        with _lock:
            replays += n
        return detect.BoardResult(**{
            f.name: getattr(self.out, f.name).clone()
            for f in dataclasses.fields(detect.BoardResult)})

    def free(self, device: torch.device):
        """Free the graphs once the device has run every replay queued."""
        torch.cuda.synchronize(device)
        for g in self.graphs:
            g.reset()
        self.graphs = []


class _Cache:
    """The keys of one (device, stream), least recently used first, their
    graph memory pool and the side stream that warms up and captures. Its
    lock holds one call at a time, from the lookup to the outputs' clone:
    threads that share a stream share its graphs' static buffers."""

    def __init__(self, device: torch.device):
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.keys: collections.OrderedDict = collections.OrderedDict()
        self.lock = threading.Lock()

    def n_graphs(self) -> int:
        return sum(len(k.graphs) for k in self.keys.values())

    def run(self, key, rgb, cfg, ths, hw) -> detect.BoardResult:
        """The call's result from the key's graphs, captured first if the
        cache does not hold them (dropping least recently used keys to
        keep within MAX_GRAPHS)."""
        with self.lock:
            entry = self.keys.get(key)
            if entry is not None:
                self.keys.move_to_end(key)
            else:
                need = 1 if not detect._overflow_on(cfg) else 3
                while self.keys and self.n_graphs() + need > MAX_GRAPHS:
                    self.keys.popitem(last=False)[1].free(rgb.device)
                entry = self.keys[key] = _Key(rgb, cfg, ths, hw, self)
            return entry.replay(rgb, ths, hw)


def cache_for(device: torch.device, stream=None) -> _Cache:
    """The graph cache of (device, stream), the device's current stream by
    default."""
    stream = torch.cuda.current_stream(device) if stream is None else stream
    k = (device.index, stream.cuda_stream)
    with _lock:
        if k not in _caches:
            _caches[k] = _Cache(device)
        return _caches[k]


def run(rgb, cfg: DetectionConfig, line_thresholds, hw) -> detect.BoardResult:
    """_detect_batch_impl(rgb, cfg, line_thresholds, hw, None) of a batch
    rgb [B, H, W, 3] uint8 on a card, from the graphs of its key in the
    cache of (rgb's card, its current stream)."""
    dev = rgb.device
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    B, H, W = rgb.shape[:3]
    key = (hw is not None, B, H, W, cfg)
    with torch.cuda.device(dev):
        return cache_for(dev).run(key, rgb, cfg, line_thresholds, hw)


def clear() -> None:
    """Drop every cache and free its graphs."""
    with _lock:
        caches = list(_caches.values())
        _caches.clear()
    for cache in caches:
        with cache.lock:
            for entry in cache.keys.values():
                entry.free(entry.rgb.device)
            cache.keys.clear()
