"""Build and load the hand-written CUDA kernels in csrc/.

All csrc/*.cu files are compiled with nvcc into one shared library with a
plain C interface, keyed by a hash of the sources and flags and cached in
_build/ beside this file, then bound with ctypes. Nothing here runs at
import time: the first kernel launch builds the library, so machines
without nvcc can still import every module and run the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of each exported C function; every one returns an int, a
# cudaError_t except for the scratch-size query
_SIGNATURES = {
    # G, H, W -> int32 words of K1's scratch buffer
    "img2sgf_hysteresis_scratch": (_I, _I, _I),
    # edge0, edge, t, gate, scratch, G, H, W, iters, sweeps_out, stream
    "img2sgf_hysteresis": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P),
    # emask, sx, sy, ys, xs, nvalid, rhat, out, P, H, W, K, cells, min_r,
    # max_r, kmax, stream
    "img2sgf_rescore": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _I, _I, _I, _P),
    # emask, ys, xs, want, binmap, spans, r_out, s_out, P, H, W, K, min_r,
    # max_r, nbins, idx64, stream -> cudaError_t, or -1: too many bins
    "img2sgf_radius": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the nvcc run in this process, if any


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of img2sgf_tpu_torch are built from csrc/ at first use "
        "and need the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libimg2sgf_kernels_{h.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """Return the kernel library, building it first if needed."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    "nvcc failed:\n" + " ".join(cmd) + "\n" + proc.stdout
                    + proc.stderr)
            build_seconds = time.perf_counter() - t0
            os.replace(tmp, path)  # atomic: concurrent builders agree
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.img2sgf_error_string.argtypes = [ctypes.c_int]
        lib.img2sgf_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel call returned a CUDA error code."""
    if err != 0:
        name = _lib.img2sgf_error_string(err).decode() if _lib else ""
        raise RuntimeError(f"{what}: CUDA error {err} {name}")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
