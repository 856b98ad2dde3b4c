"""Stdlib PNG reader/writer (data/image_io.py): byte-exact parity with
Pillow, which it replaces on the training path, on generated images and on
the committed docs/artifacts PNGs."""

import glob
import os

import numpy as np
import pytest

from burn_raymarching.data.image_io import (
    decode_png,
    encode_png,
    image_size,
    load_image_as_array,
    read_png,
    save_array_as_image,
)

ARTIFACTS = sorted(glob.glob(os.path.join(
    os.path.dirname(os.path.dirname(__file__)), "docs", "artifacts", "**",
    "*.png"), recursive=True))


def _pil():
    return pytest.importorskip("PIL.Image")


@pytest.mark.parametrize("path", ARTIFACTS,
                         ids=[os.path.basename(p) for p in ARTIFACTS])
def test_read_matches_pillow_on_committed_pngs(path):
    Image = _pil()
    with Image.open(path) as im:
        ref = np.asarray(im)
    np.testing.assert_array_equal(read_png(path), ref)
    assert image_size(path) == (ref.shape[1], ref.shape[0])


@pytest.mark.parametrize("channels", [3, 4])
def test_pillow_reads_what_we_write(tmp_path, channels):
    Image = _pil()
    rng = np.random.default_rng(channels)
    px = rng.integers(0, 256, (37, 53, channels), dtype=np.uint8)
    path = str(tmp_path / "ours.png")
    with open(path, "wb") as f:
        f.write(encode_png(px))
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), px)


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
@pytest.mark.parametrize("optimize", [False, True])
def test_we_read_what_pillow_writes(tmp_path, mode, optimize):
    """Pillow chooses adaptive per-row filters (None/Sub/Up/Average/Paeth):
    every filter type decodes byte-exactly."""
    Image = _pil()
    rng = np.random.default_rng(7)
    c = len(mode)
    # Smooth gradients plus noise exercise every filter choice.
    yy, xx = np.mgrid[0:41, 0:67]
    px = ((xx[..., None] * 3 + yy[..., None] * (1 + np.arange(c)) * 2
           + rng.integers(0, 9, (41, 67, c))) % 256).astype(np.uint8)
    path = str(tmp_path / "pil.png")
    Image.fromarray(px, mode).save(path, optimize=optimize)
    np.testing.assert_array_equal(read_png(path), px)


def test_gamma_save_matches_pillow_encoding(tmp_path):
    """save_array_as_image keeps the truncating-u8 gamma semantics: the
    pixels it writes are exactly (clip(x)^(1/2.2) * 255) cast to uint8."""
    rng = np.random.default_rng(0)
    img = rng.uniform(-0.2, 1.2, (24 * 16, 3)).astype(np.float32)
    path = str(tmp_path / "g.png")
    save_array_as_image(img, 24, 16, path)
    want = (np.clip(img, 0, 1) ** (1 / 2.2) * 255.0).astype(np.uint8)
    np.testing.assert_array_equal(read_png(path).reshape(-1, 3), want)
    back = load_image_as_array(path)
    np.testing.assert_allclose(back, (want / 255.0) ** 2.2, rtol=1e-6)


def test_rejects_unsupported_png():
    Image = pytest.importorskip("PIL.Image")
    import io

    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint8), "L").save(buf, format="PNG")
    with pytest.raises(ValueError, match="only 8-bit RGB/RGBA"):
        decode_png(buf.getvalue())
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a")
