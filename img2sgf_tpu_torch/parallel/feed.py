"""Multi-process input feeding for the data-parallel detector (port of
img2sgf_tpu/parallel/feed.py).

Each process decodes only its own contiguous slice of the file list
(hostio.batch_loader's native decoder) and detects it on its own devices;
no data crosses processes and no collective is issued. A process learns its
place from torch.distributed when that is initialised, else from the RANK
and WORLD_SIZE environment variables (as torchrun sets them), else it is
process 0 of 1. One process per card is the form that scales (the pipeline
is host-bound, see mesh.py): start one per card with RANK, WORLD_SIZE and
LOCAL_RANK set, and give each `data_devices([f"cuda:{LOCAL_RANK}"])`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .mesh import data_devices, shard_batch


def _process_place():
    """(process index, process count)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return int(os.environ.get("RANK", 0)), int(os.environ.get("WORLD_SIZE", 1))


def local_file_slice(files, process_index: int | None = None,
                     process_count: int | None = None):
    """The contiguous slice of `files` this process should decode.

    Files are dealt in contiguous runs (not round-robin), so that the
    processes' rows, in process order, are the file list's order.
    """
    pi, pc = _process_place()
    pi = pi if process_index is None else process_index
    pc = pc if process_count is None else process_count
    per = -(-len(files) // pc)
    return files[pi * per : (pi + 1) * per]


def make_global_batch(devices, local_batch):
    """This process's [B_local, ...] batch split over its local devices:
    contiguous per-device shards (shard_batch), B_local divisible by their
    count.

    Torch has no global array spanning processes, unlike JAX's
    make_array_from_process_local_data: each process holds only its own
    rows, and the global batch is every process's shards in process order.
    """
    return shard_batch(devices, local_batch)


def feed_and_detect(devices, run, files, height: int, width: int,
                    thresholds=None):
    """Decode this process's file slice and run the sharded detector on it.

    run: a detector from make_sharded_detector over this process's devices.
    files: the GLOBAL file list (identical in every process); each process
    decodes only its contiguous slice, resized to height x width.
    thresholds, if given, is the GLOBAL per-file threshold list and is
    sliced identically (default: choose_line_threshold(height, width)).
    When len(files) does not divide by the process count, the tail is
    padded by repeating the last file so that every process has a slice of
    the same size; rows past the original len(files) are that repeat.
    Returns this process's rows (a BoardResult with a leading [B_local]).
    On cards the slice is decoded into pinned host memory.
    """
    from ..config import choose_line_threshold
    from ..hostio.batch_loader import decode_batch

    devices = data_devices(devices)
    pi, pc = _process_place()
    n_files = len(files)
    per = -(-n_files // pc)
    n_pad = pc * per - n_files
    files = list(files) + [files[-1]] * n_pad
    if thresholds is None:
        t = float(choose_line_threshold(height, width))
        thr_global = np.full((len(files),), t, np.float32)
    else:
        thr_global = np.asarray(thresholds, np.float32)
        if thr_global.shape[0] != n_files:
            raise ValueError("thresholds must match the global file list length")
        thr_global = np.concatenate(
            [thr_global, np.repeat(thr_global[-1:], n_pad)]
        ).astype(np.float32)

    mine = local_file_slice(files, pi, pc)
    local = torch.empty((len(mine), height, width, 3), dtype=torch.uint8,
                        pin_memory=any(d.type == "cuda" for d in devices))
    decode_batch(mine, height, width, out=local.numpy())
    return run(local, thr_global[pi * per : (pi + 1) * per])
