"""Device constants cached per card, and what a captured CUDA graph needs of
them.

A table that the detector builds on the host (an index list, a bin map) is
uploaded once per device and kept in a bounded cache (device_cache). A
captured CUDA graph reads such a tensor at the address it had during the
capture, so the tensor must outlive the graph even if its cache drops it.
Inside keep_device_constants(into), every value a device_cache function
returns, a hit or a miss, is appended to `into`; the graph runner
(pipeline/graphs.py) holds that list for as long as the graph lives.
"""

from __future__ import annotations

import contextlib
import functools
import threading

_active = threading.local()


def device_cache(maxsize: int):
    """functools.lru_cache(maxsize) whose values are recorded by an active
    keep_device_constants of the calling thread. The wrapped function's
    last argument names the device (str(tensor.device), "cuda:1"), so each
    card keeps its own entries."""
    def deco(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def wrapper(*args):
            out = cached(*args)
            keep = getattr(_active, "keep", None)
            if keep is not None:
                keep.append(out)
            return out

        wrapper.cache_clear = cached.cache_clear
        wrapper.cache_info = cached.cache_info
        return wrapper
    return deco


@contextlib.contextmanager
def keep_device_constants(into: list):
    """Append to `into` every device_cache value this thread takes inside
    the block."""
    prev = getattr(_active, "keep", None)
    _active.keep = into
    try:
        yield into
    finally:
        _active.keep = prev
