"""Data-parallel scale-out over CUDA devices (port of
img2sgf_tpu/parallel/mesh.py).

The only parallel axis in this domain is the image batch, and every
per-image result is independent, so no collective is needed. Where the JAX
package shards a [B, H, W, 3] batch over a 1-D mesh with shard_map, the port
splits it into contiguous per-device shards and runs each shard's batch
(_detect_batch: on a card, the replay of its CUDA graphs from the graph
cache of its device and stream, pipeline/graphs.py) on its own device, in
its own worker thread, on its own CUDA stream; the shards' results are
concatenated in batch order on one device. The batch must divide by the
device count, as in the JAX package.

Threads in one process share the interpreter lock. A batch makes thousands
of kernel launches and loops over its images in Python on the host, so the
threads overlap device work and native code but not the host's Python:
in-process sharding is for sharing one host thread's batches between
cards, and one process per card (feed_and_detect with RANK, WORLD_SIZE and
LOCAL_RANK, see feed.py) is the form that scales with cards.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses

import torch

from ..config import DetectionConfig
from ..pipeline.detect import (
    BoardResult,
    _as_images,
    _content_dims,
    _detect_batch,
    _thresholds,
    resolve_device,
)


def data_devices(devices=None) -> list[torch.device]:
    """The devices a batch is split over (the port's data_mesh): every
    visible CUDA device by default, which raises when there is none, or the
    given ones (a device may repeat: two shards on one card run on two
    streams). A card named without an index is the current one."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("data_devices: no CUDA device "
                               "(torch.cuda.is_available() is False)")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        out.append(dev)
    if not out:
        raise ValueError("data_devices: an empty device list")
    return out


def _split(n_items: int, n_shards: int):
    """Contiguous [start, stop) row ranges of equal size."""
    if n_items % n_shards:
        raise ValueError(f"a batch of {n_items} does not divide over "
                         f"{n_shards} devices")
    per = n_items // n_shards
    return [(i * per, (i + 1) * per) for i in range(n_shards)]


def shard_batch(devices, batch):
    """Contiguous per-device shards of a [B, ...] batch (numpy array or
    tensor), shard i on devices[i]."""
    devices = data_devices(devices)
    x = torch.from_numpy(batch) if not isinstance(batch, torch.Tensor) else batch
    return [x[a:b].to(dev)
            for (a, b), dev in zip(_split(x.shape[0], len(devices)), devices)]


def make_sharded_detector(devices, cfg: DetectionConfig, bucketed: bool = False):
    """Batched detector whose batch is split over `devices`.

    Returns run(images, thresholds) over [B, H, W, 3] uint8 images of one
    size and B line thresholds, or with bucketed=True run(canvases,
    thresholds, hs, ws) over canvases whose top-left [hs[i], ws[i]] blocks
    are the images (detect_board_bucket_batch). B must divide by the device
    count. Each shard runs _detect_batch on its device in its own worker
    thread, on its own stream (so on a card it replays graphs from the
    cache of that stream, and shards never share a graph memory pool); the result is one BoardResult with a
    leading [B] on every field, in batch order, on devices[0]. It equals
    detect_board_batch (detect_board_bucket_batch) of the whole batch on
    one device, field for field.
    """
    devices = data_devices(devices)
    out_dev = devices[0]
    streams = [torch.cuda.Stream(device=d) if d.type == "cuda" else None
               for d in devices]

    def shard(dev, stream, rgb, ths, hw, ready):
        with contextlib.ExitStack() as ctx:
            if stream is not None:
                ctx.enter_context(torch.cuda.device(dev))
                ctx.enter_context(torch.cuda.stream(stream))
            ctx.enter_context(torch.no_grad())
            if ready is not None:
                # the images are written by the caller's queued work. On
                # their own card the shard's stream reads them; from another
                # card they are copied on this thread's current stream of
                # theirs. Either stream waits for that work first.
                torch.cuda.current_stream(rgb.device).wait_event(ready)
            x = _as_images(rgb, dev, 4, "[B, H, W, 3]")
            res = _detect_batch(x, cfg, ths, hw, None)
            if stream is not None:
                # the pool's streams do not wait for the default stream, nor
                # it for them: the caller's thread reads (and copies to
                # out_dev) only what is written
                stream.synchronize()
            return res

    def run_shards(images, thresholds, hw):
        B = images.shape[0]
        ranges = _split(B, len(devices))
        ths = _thresholds(thresholds, B)
        ready = None
        if isinstance(images, torch.Tensor) and images.is_cuda:
            ready = torch.cuda.current_stream(images.device).record_event()
        with concurrent.futures.ThreadPoolExecutor(len(devices)) as pool:
            futs = [pool.submit(shard, dev, stream, images[a:b], ths[a:b],
                                None if hw is None else (hw[0][a:b], hw[1][a:b]),
                                ready)
                    for (a, b), dev, stream in zip(ranges, devices, streams)]
            parts = [f.result() for f in futs]
        out = BoardResult(**{
            f.name: torch.cat([getattr(p, f.name).to(out_dev) for p in parts])
            for f in dataclasses.fields(BoardResult)})
        # the copies to out_dev and the concatenation done before the
        # shards' tensors go back to their streams' allocator pools
        for dev in {d for d in devices if d.type == "cuda"}:
            torch.cuda.synchronize(dev)
        return out

    if bucketed:
        def run(canvases, thresholds, hs, ws):
            H, W = canvases.shape[1:3]
            hw = _content_dims(hs, ws, canvases.shape[0], H, W)
            return run_shards(canvases, thresholds, hw)
        return run

    def run(images, thresholds):
        return run_shards(images, thresholds, None)

    return run


def aggregate_metrics(result) -> dict:
    """Cross-batch summary, the JAX package's three sums (int32 0-d
    tensors): boards detected, black and white stones."""
    return {
        "boards_ready": result.board_ready.sum(dtype=torch.int32),
        "total_black": result.num_black.sum(dtype=torch.int32),
        "total_white": result.num_white.sum(dtype=torch.int32),
    }
