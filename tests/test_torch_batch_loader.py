"""The port's batch loader (img2sgf_tpu_torch.hostio.batch_loader) on seeded
JPEGs written with PIL: the native decoder equal to the JAX package's byte
for byte (the same source built with the same flags), close to PIL, the PIL
path for files the native decoder cannot read, and the output buffer."""

import pathlib

import numpy as np
import pytest
from PIL import Image

import img2sgf_tpu.hostio.batch_loader as jbl

import img2sgf_tpu_torch.hostio.batch_loader as bl

INCLUDE_DIRS = ("/usr/include", "/usr/local/include")


@pytest.fixture(scope="module")
def jpeg_paths(tmp_path_factory):
    """Four seeded diagrams of different sizes, JPEG quality 95."""
    from test_torch_pipeline import synth_board

    d = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(11)
    paths = []
    for i, size in enumerate((150, 192, 211, 260)):
        rgb = synth_board(size=size).astype(np.int16)
        rgb += rng.integers(-20, 21, rgb.shape)
        p = d / f"d{i}.jpg"
        Image.fromarray(np.clip(rgb, 0, 255).astype(np.uint8)).save(p, quality=95)
        paths.append(str(p))
    return paths


@pytest.fixture(scope="module")
def native():
    """The native loader: skips where libjpeg's headers are absent, and
    fails where they are present but the build did not succeed."""
    if not any(pathlib.Path(d, "jpeglib.h").exists() for d in INCLUDE_DIRS):
        pytest.skip("libjpeg headers (jpeglib.h) not installed")
    assert bl.native_available(), bl.build_error
    return bl


def _pil(path, h, w):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB").resize((w, h), Image.BILINEAR))


def test_native_equals_jax_loader(native, jpeg_paths):
    if not jbl.native_available():
        pytest.skip("the JAX package's native loader is not available")
    for h, w in ((256, 256), (97, 131)):
        got = native.decode_batch(jpeg_paths, h, w)
        np.testing.assert_array_equal(got, jbl.decode_batch(jpeg_paths, h, w))


def test_native_close_to_pil(native, jpeg_paths):
    out = native.decode_batch(jpeg_paths, 256, 256)
    assert out.shape == (len(jpeg_paths), 256, 256, 3)
    for i, p in enumerate(jpeg_paths):
        diff = np.abs(out[i].astype(np.int32) - _pil(p, 256, 256))
        # different bilinear implementations: close, not identical (the
        # JAX package's test's bound)
        assert diff.mean() < 4.0, f"{p}: mean diff {diff.mean()}"


def test_native_library_built_in_the_port(native):
    """The port builds its own library under _build/ and never loads the
    JAX package's."""
    path = bl.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "img2sgf_tpu_torch"


def test_png_takes_the_pil_path(jpeg_paths, tmp_path):
    """A file libjpeg cannot read sends the batch through PIL: equal to
    PIL's resize exactly."""
    png = tmp_path / "d.png"
    Image.open(jpeg_paths[0]).save(png)
    paths = [jpeg_paths[1], str(png)]
    out = bl.decode_batch(paths, 64, 80)
    for i, p in enumerate(paths):
        np.testing.assert_array_equal(out[i], _pil(p, 64, 80))


def test_missing_file_raises(jpeg_paths, tmp_path):
    with pytest.raises(Exception):
        bl.decode_batch([jpeg_paths[0], str(tmp_path / "nope.jpg")], 64, 64)


def test_reuses_output_buffer(jpeg_paths):
    buf = np.empty((len(jpeg_paths), 128, 128, 3), np.uint8)
    out = bl.decode_batch(jpeg_paths, 128, 128, out=buf)
    assert out is buf
    np.testing.assert_array_equal(buf, bl.decode_batch(jpeg_paths, 128, 128))


def test_output_into_a_tensor_view(jpeg_paths):
    """`out` may be a CPU tensor's numpy view (pinned, on a card's host):
    the bytes land in the tensor."""
    import torch

    t = torch.zeros((len(jpeg_paths), 64, 64, 3), dtype=torch.uint8)
    bl.decode_batch(jpeg_paths, 64, 64, out=t.numpy())
    np.testing.assert_array_equal(t.numpy(), bl.decode_batch(jpeg_paths, 64, 64))


def test_bad_output_buffer_raises(jpeg_paths):
    n = len(jpeg_paths)
    for buf in (np.empty((n, 64, 64, 3), np.float32),
                np.empty((n, 64, 65, 3), np.uint8),
                np.empty((n, 64, 128, 3), np.uint8)[:, :, ::2]):
        with pytest.raises(ValueError):
            bl.decode_batch(jpeg_paths, 64, 64, out=buf)
