"""Batched image loading for the batch path (port of
img2sgf_tpu/hostio/batch_loader.py, same semantics).

Uses the native C++ loader (native/loader.cpp at the repository root:
libjpeg decode across a pthread pool and a bilinear resize straight into
the batch buffer) when it builds; PIL otherwise, and also for a batch in
which the native decoder could not read every file. The library is built
with g++ at first use into img2sgf_tpu_torch/_build/ (git-ignored), keyed
by a hash of the source, the flags and the host CPU (-march=native), as
_build.py does for the CUDA kernels; nothing is built at import.

`out` may be any C-contiguous uint8 [B, H, W, 3] array, for instance the
numpy view of a pinned CPU tensor, from which the caller can copy the batch
to the card without blocking.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import platform
import shutil
import threading

import numpy as np

from .. import _build

SOURCE = pathlib.Path(__file__).resolve().parents[2] / "native" / "loader.cpp"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")
LIBS = ("-ljpeg", "-lpthread")

_lock = threading.Lock()
_lib = None
_tried = False
build_error = None  # why the native loader is unavailable, if it is


def _cpu_features() -> bytes:
    """The host CPU's model and feature flags: -march=native builds for
    them, so a library built on another host must not be reused."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return platform.processor().encode()
    keep = [ln for ln in lines if ln.startswith((b"model name", b"flags"))]
    return b"\n".join(sorted(set(keep)))


def library_path() -> pathlib.Path:
    key = (SOURCE.read_bytes() + " ".join(CXX_FLAGS + LIBS).encode()
           + _cpu_features())
    return _build.cached_path("libimg2sgf_loader", key)


def _command():
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) on PATH")
    return [cxx, *CXX_FLAGS, str(SOURCE), *LIBS]


def _build_and_load():
    """The loaded library, or None with build_error saying why."""
    global build_error
    if not SOURCE.exists():
        build_error = f"{SOURCE} not found"
        return None
    path = library_path()
    try:
        _build.build_once(path, _command)
        lib = ctypes.CDLL(str(path))
    except (RuntimeError, OSError) as e:
        build_error = f"cannot build or load {path}: {e}"
        return None
    lib.i2s_decode_batch.restype = ctypes.c_int
    lib.i2s_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
    ]
    return lib


def native_available() -> bool:
    """Whether the native loader is built and loaded (building it on the
    first call)."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _lib = _build_and_load()
            _tried = True
    return _lib is not None


def decode_batch(paths, height: int, width: int, out: np.ndarray | None = None,
                 n_threads: int = 0) -> np.ndarray:
    """Decode+resize a list of image paths into a [B, H, W, 3] uint8 array
    (`out` if given, which is returned). n_threads 0: one per core."""
    n = len(paths)
    if out is None:
        out = np.empty((n, height, width, 3), np.uint8)
    if out.shape != (n, height, width, 3) or out.dtype != np.uint8 \
            or not out.flags.c_contiguous:
        raise ValueError(f"out must be C-contiguous uint8 {(n, height, width, 3)}"
                         f", got {out.dtype} {out.shape}")

    if native_available():
        arr = (ctypes.c_char_p * n)(*[os.fsencode(str(p)) for p in paths])
        ok = _lib.i2s_decode_batch(
            arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            height, width, n_threads,
        )
        if ok == n:
            return out
        # fall through to PIL, which decodes what libjpeg cannot (or raises
        # for a file that is missing or no image)

    from PIL import Image

    for i, p in enumerate(paths):
        with Image.open(p) as im:
            img = im.convert("RGB").resize((width, height), Image.BILINEAR)
        out[i] = np.asarray(img)
    return out
