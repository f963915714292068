"""Build and load the hand-written CUDA kernels in csrc/.

Each csrc/*.cu file is compiled by an nvcc of its own, all started at
once, and the objects are linked into one shared library with a plain C
interface, keyed by a hash of the sources and flags and cached in _build/
beside this file, then bound with ctypes. Nothing here runs at
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
    "--fmad=false", "-Xcompiler", "-fPIC",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of each exported C function; every one returns an int, a
# cudaError_t except for the scratch-size query
_SIGNATURES = {
    # G, H, W -> int32 words of K1's scratch buffer
    "img2sgf_hysteresis_scratch": (_I, _I, _I),
    # edge0, edge, t, gate, scratch, G, H, W, iters, sweeps_out (a device
    # int), stream
    "img2sgf_hysteresis": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P),
    # emask, sx, sy, ys, xs, nvalid, rhat, out, P, H, W, K, cells, min_r,
    # max_r, kmax, stream
    "img2sgf_rescore": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _I, _I, _I, _P),
    # emask, ys, xs, want, binmap, spans, r_out, s_out, P, H, W, K, min_r,
    # max_r, nbins, idx64, stream -> cudaError_t, or -1: too many bins
    "img2sgf_radius": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _I, _I, _I, _P),
    # ys, xs, live, accepted, P, K, max_out, md2, idx64, stream
    "img2sgf_greedy": (_P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    # labels, start, entries, E, ext, out, P, H, W, nb, ymin, ymax, xmin,
    # xmax, stream
    "img2sgf_accumulator": (_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, _P),
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the nvcc runs in this process, if any
# Held while a wrapper adds to its module's launch or plain-call count, so
# that threads launching at once (the sharded detector's workers) lose none.
# A call captured into a CUDA graph launches nothing and counts nothing
# (launching()); a graph's replays are counted by torch.profiler.
count_lock = threading.Lock()


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


def cached_path(stem: str, key: bytes) -> pathlib.Path:
    """BUILD_DIR/<stem>_<hash of key>.so: key holds the sources and flags
    that the library is built from."""
    return BUILD_DIR / f"{stem}_{hashlib.sha256(key).hexdigest()[:16]}.so"


def build_once(path: pathlib.Path, command) -> float | None:
    """Build the shared library `path` unless it exists. command() gives the
    compiler's command line, to which "-o <file>" is appended; it may raise
    RuntimeError (no compiler). Returns the compile's wall seconds, or None
    when the library was there; raises RuntimeError when the compiler
    fails."""
    if path.exists():
        return None
    cmd = command()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [*cmd, "-o", tmp]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{os.path.basename(cmd[0])} failed:\n"
                           + " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    seconds = time.perf_counter() - t0
    os.replace(tmp, path)  # atomic: concurrent builders agree
    return seconds


def library_path() -> pathlib.Path:
    key = b"".join(src.name.encode() + src.read_bytes() for src in _sources())
    flags = " ".join(NVCC_FLAGS) + " | " + " ".join(LINK_FLAGS)
    return cached_path("libimg2sgf_kernels", key + flags.encode())


def _compile_objects(tmp: str) -> list[str]:
    """Compile every source to an object in tmp, one nvcc process each, all
    running at once; raises RuntimeError naming every source that failed."""
    nvcc = _nvcc()
    jobs = []
    for src in _sources():
        obj = os.path.join(tmp, src.stem + ".o")
        jobs.append((obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for _, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(" ".join(proc.args) + "\n" + out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return [obj for obj, _ in jobs]


def load() -> ctypes.CDLL:
    """Return the kernel library, building it first if needed."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            linked = build_once(
                path, lambda: [_nvcc(), *LINK_FLAGS, *_compile_objects(tmp)])
        if linked is not None:
            build_seconds = time.perf_counter() - t0
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


def launching() -> bool:
    """Whether a kernel call made now launches its kernel: not while the
    current stream is captured into a CUDA graph, where the call records a
    graph node that each replay launches (wrappers count launches only)."""
    import torch

    return not torch.cuda.is_current_stream_capturing()


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
