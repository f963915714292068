"""The port's data parallelism (img2sgf_tpu_torch.parallel) on CPU devices:
the sharded detector on [cpu, cpu] against the one-device batch and the JAX
package in both modes, the feed helpers, the two-process feed (this file is
also its worker, run as a script), the kernel wrappers' counts under
threads, and that the port imports no JAX.

Run as a script, this file is one process of the two-process feed:
    RANK=r WORLD_SIZE=2 python tests/test_torch_parallel.py LIST H W OUT.npz
"""

import dataclasses
import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
# the feed test's configuration: 4 unique planes keep the CPU runs short
FEED_CFG = dict(maxblur=1, max_center_candidates=32, overflow_center_candidates=0,
                max_circles_per_variant=16, max_lines=128, hysteresis_iters=4)


def _feed_worker(listfile, h, w, out):
    """One process of the two-process feed: decode this process's slice
    (RANK, WORLD_SIZE from the environment), detect it on [cpu, cpu], save
    its slice and rows."""
    from img2sgf_tpu_torch.config import DetectionConfig
    from img2sgf_tpu_torch.parallel import (
        data_devices, feed_and_detect, local_file_slice, make_sharded_detector)

    files = [ln.strip() for ln in open(listfile) if ln.strip()]
    padded = files + [files[-1]] * ((-len(files)) % int(os.environ["WORLD_SIZE"]))
    devices = data_devices(["cpu", "cpu"])
    run = make_sharded_detector(devices, DetectionConfig(**FEED_CFG))
    res = feed_and_detect(devices, run, files, h, w)
    np.savez(out, slice=np.array([os.path.basename(f)
                                  for f in local_file_slice(padded)]),
             **{f.name: getattr(res, f.name).numpy()
                for f in dataclasses.fields(res)})


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _feed_worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    sys.exit(0)

import jax.numpy as jnp  # noqa: E402

from img2sgf_tpu.parallel import aggregate_metrics as j_aggregate_metrics  # noqa: E402
from img2sgf_tpu.pipeline import detect as jdetect  # noqa: E402

from img2sgf_tpu_torch.hough import radius_cuda, rescore_cuda  # noqa: E402
from img2sgf_tpu_torch.ops import hysteresis_cuda  # noqa: E402
from img2sgf_tpu_torch.ops.canny import pack_planes  # noqa: E402
from img2sgf_tpu_torch.parallel import (  # noqa: E402
    aggregate_metrics, data_devices, local_file_slice, make_global_batch,
    make_sharded_detector, shard_batch)
from img2sgf_tpu_torch.pipeline import (  # noqa: E402
    detect_board_batch, detect_board_bucket_batch)
from test_torch_bucketed import BUCKET_IMGS, _canvas, _tcfg  # noqa: E402
from test_torch_pipeline import TINY, _compare, synth_board  # noqa: E402

CPU2 = ["cpu", "cpu"]


def _equal_results(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype and torch.equal(x, y), f.name


# --- the kernel wrappers' counts under threads


def test_counts_exact_under_threads():
    """16 threads (more than this host's cores) each call the three
    wrappers 5 times on CPU tensors at once, with a tiny switch interval:
    every plain call is counted (no lost update), nothing is counted as a
    launch, and each thread reads its own K1 sweep count (iters 1-8 on a
    staircase that needs more, so the cap sets each thread's count)."""
    from chip_smoke import staircase_plane

    n_threads, calls = 16, 5
    strong, cand = staircase_plane(np.random.default_rng(0), 40, 64)
    e0 = pack_planes(torch.from_numpy(strong & cand)[None])
    gate = pack_planes(torch.from_numpy(cand)[None])
    rng = np.random.default_rng(1)
    emask = torch.from_numpy(rng.random((2, 24, 24)) < 0.2)
    steps = torch.from_numpy(rng.integers(-1024, 1025, (2, 2, 24, 24)).astype(np.int32))
    ys = torch.from_numpy(rng.integers(0, 24, (2, 3)))
    xs = torch.from_numpy(rng.integers(0, 24, (2, 3)))
    valid = torch.tensor([[True, True, False], [True, False, False]])
    mods = (hysteresis_cuda, rescore_cuda, radius_cuda)
    before = [(m.plain_calls, m.launches) for m in mods]
    seen = [[] for _ in range(n_threads)]
    barrier = threading.Barrier(n_threads)

    def work(k):
        barrier.wait(timeout=60)
        for _ in range(calls):
            hysteresis_cuda.hysteresis_packed(e0, gate, 1 + k % 8)
            seen[k].append(hysteresis_cuda.last_sweeps())
            rescore_cuda.exact_rescore(emask, steps[0], steps[1], ys, xs, valid,
                                       1, 6, cells=3)
            radius_cuda.radius_support_pool(emask, ys, xs, valid, 1, 6)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    total = n_threads * calls
    assert [(m.plain_calls - p, m.launches - n)
            for m, (p, n) in zip(mods, before)] == [(total, 0)] * 3
    assert seen == [[1 + k % 8] * calls for k in range(n_threads)]


# --- the sharded detector on [cpu, cpu], against the JAX package


@pytest.fixture(scope="module")
def native_batch():
    """The two 128^2 diagrams of test_torch_bucketed's detect_board_batch
    case (the same JAX program)."""
    imgs = [synth_board(size=128, n=7, stones=((1, 2, 0), (3, 3, 255))),
            synth_board(size=128, n=5, stones=((2, 1, 255),))]
    batch = np.stack(imgs)
    ths = np.array([24.0, 26.0], np.float32)
    jres = jdetect.detect_board_batch(jnp.asarray(batch), TINY, jnp.asarray(ths))
    return batch, ths, jres


@pytest.fixture(scope="module")
def bucket_batch():
    """test_torch_bucketed's bucket batch: margins 13 and 2 in the 160
    canvas (the same JAX program)."""
    imgs = [synth_board(size=s, n=n, stones=st) for s, n, st in BUCKET_IMGS]
    can, hs, ws = _canvas(imgs)
    ths = np.full((len(imgs),), 24.0, np.float32)
    jres = jdetect.detect_board_bucket_batch(
        jnp.asarray(can), TINY, jnp.asarray(ths), jnp.asarray(hs), jnp.asarray(ws))
    return can, ths, hs, ws, jres


def test_sharded_equals_jax_and_one_device(native_batch):
    batch, ths, jres = native_batch
    run = make_sharded_detector(data_devices(CPU2), _tcfg(TINY))
    res = run(batch, ths)
    _compare(jres, res)
    _equal_results(res, detect_board_batch(batch, _tcfg(TINY), ths, device="cpu"))
    m, jm = aggregate_metrics(res), j_aggregate_metrics(jres)
    assert {k: (int(v), v.dtype) for k, v in m.items()} == \
        {k: (int(v), torch.int32) for k, v in jm.items()}
    assert int(m["boards_ready"]) == 2


def test_sharded_two_images_a_shard(native_batch):
    """B = 4 over two devices, each shard a batch of two (the images in the
    order 0, 1, 1, 0): its rows are the JAX batch's rows in that order."""
    batch, ths, jres = native_batch
    order = [0, 1, 1, 0]
    res = make_sharded_detector(CPU2, _tcfg(TINY))(batch[order], ths[order])
    for f in dataclasses.fields(res):
        want = np.asarray(getattr(jres, f.name))[order]
        got = getattr(res, f.name).numpy()
        assert got.dtype == want.dtype, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)


def test_sharded_bucketed_equals_jax_and_one_device(bucket_batch):
    can, ths, hs, ws, jres = bucket_batch
    run = make_sharded_detector(CPU2, _tcfg(TINY), bucketed=True)
    res = run(can, ths, hs, ws)
    _compare(jres, res)
    _equal_results(res, detect_board_bucket_batch(can, _tcfg(TINY), ths, hs, ws,
                                                  device="cpu"))


def test_sharded_batch_must_divide(native_batch):
    batch, ths, _ = native_batch
    run = make_sharded_detector(["cpu"] * 3, _tcfg(TINY))
    with pytest.raises(ValueError, match="does not divide"):
        run(batch, ths)
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(CPU2, np.zeros((3, 4, 4, 3), np.uint8))


def test_default_devices_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this pins the no-card error")
    with pytest.raises(RuntimeError, match="CUDA"):
        data_devices()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_sharded_detector(None, _tcfg(TINY))
    with pytest.raises(RuntimeError, match="cuda"):
        data_devices(["cuda:0"])


# --- the feed helpers


def test_devices_and_shards():
    assert data_devices(CPU2) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError):
        data_devices([])
    x = np.arange(6 * 2 * 3).reshape(6, 2, 3).astype(np.uint8)
    shards = shard_batch(CPU2, x)
    assert [s.shape[0] for s in shards] == [3, 3]
    np.testing.assert_array_equal(torch.cat(shards).numpy(), x)
    shards = make_global_batch(["cpu"] * 3, torch.from_numpy(x))
    assert [s.numpy().tolist() for s in shards] == \
        [x[0:2].tolist(), x[2:4].tolist(), x[4:6].tolist()]


def test_local_file_slice(monkeypatch):
    files = [f"f{i}.jpg" for i in range(16)]
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert local_file_slice(files) == files
    assert local_file_slice(files, 0, 2) == files[:8]
    assert local_file_slice(files, 1, 2) == files[8:]
    assert local_file_slice(files[:7], 1, 2) == files[4:7]
    monkeypatch.setenv("RANK", "2")
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert local_file_slice(files) == files[8:12]


def test_feed_two_processes(tmp_path):
    """Two OS processes, RANK 0 and 1 of WORLD_SIZE 2, each feed_and_detect
    a 7-file list on [cpu, cpu], with no collective: rank 0 holds rows 0-3
    and rank 1 rows 4-7, its slice ending in the repeat of the last file,
    and every row equals the one-process detect_board_batch of the padded
    list."""
    from img2sgf_tpu_torch.config import DetectionConfig
    from img2sgf_tpu_torch.config import choose_line_threshold
    from img2sgf_tpu_torch.hostio.batch_loader import decode_batch
    from PIL import Image

    rng = np.random.default_rng(5)
    h = w = 96
    files = []
    for i in range(7):
        rgb = synth_board(size=h, n=5, stones=((1, 1 + i % 3, 0), (3, 2, 255)))
        rgb = np.clip(rgb.astype(np.int16) + rng.integers(-25, 26, rgb.shape),
                      0, 255).astype(np.uint8)
        p = tmp_path / f"img{i}.jpg"
        Image.fromarray(rgb).save(p, quality=90)
        files.append(str(p))
    listfile = tmp_path / "files.txt"
    listfile.write_text("\n".join(files) + "\n")

    env = {**os.environ, "WORLD_SIZE": "2", "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(listfile), str(h), str(w),
         str(tmp_path / f"rank{r}.npz")],
        env={**env, "RANK": str(r)}, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"

    parts = [np.load(tmp_path / f"rank{r}.npz") for r in (0, 1)]
    assert list(parts[0]["slice"]) == [f"img{i}.jpg" for i in range(4)]
    assert list(parts[1]["slice"]) == ["img4.jpg", "img5.jpg", "img6.jpg", "img6.jpg"]
    padded = files + [files[-1]]
    thr = [choose_line_threshold(h, w)] * 8
    ref = detect_board_batch(decode_batch(padded, h, w), DetectionConfig(**FEED_CFG),
                             thr, device="cpu")
    assert bool(ref.board_ready.any())
    for f in dataclasses.fields(ref):
        want = getattr(ref, f.name).numpy()
        for r, part in enumerate(parts):
            got = part[f.name]
            assert got.dtype == want.dtype, f.name
            np.testing.assert_array_equal(got, want[4 * r:4 * r + 4],
                                          err_msg=f"rank {r} {f.name}")


# --- no JAX in the port


def test_port_imports_no_jax():
    """Importing every module of img2sgf_tpu_torch (gui and parallel
    included) leaves jax and img2sgf_tpu out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import img2sgf_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')\n"
        "         if not m.name.endswith('__main__')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'img2sgf_tpu_torch.gui.app' in names, names\n"
        "assert 'img2sgf_tpu_torch.parallel.feed' in names, names\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'img2sgf_tpu'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
