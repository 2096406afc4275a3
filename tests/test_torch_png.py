"""The port's PNG reader and writer (volsurfs_tpu_torch/utils/png.py)
against PIL, which the JAX package reads its band textures with."""

import glob
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from volsurfs_tpu_torch.utils import png

TEXTURES = os.path.join(os.path.dirname(__file__), "..", "runs", "pipeline_tpu_256", "volsurfs",
                        "textures")


def test_read_matches_pil_on_committed_bands():
    """Byte for byte on all 45 committed band PNGs (8-bit RGBA; most rows
    Paeth-filtered, the rest Up and Sub)."""
    paths = sorted(glob.glob(os.path.join(TEXTURES, "*.png")))
    assert len(paths) == 45
    for path in paths:
        ours = png.read(path)
        ref = np.asarray(Image.open(path))
        assert ours.dtype == np.uint8 and ours.shape == ref.shape, path
        assert np.array_equal(ours, ref), path


@pytest.mark.parametrize("channels", [3, 4])
def test_write_read_round_trip(tmp_path, channels):
    """Exact, and PIL reads the written file to the same pixels."""
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (37, 53, channels), dtype=np.uint8)
    path = str(tmp_path / "img.png")
    png.write(path, img)
    assert np.array_equal(png.read(path), img)
    assert np.array_equal(np.asarray(Image.open(path)), img)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _encode(img, filters):
    """A PNG of img whose row y uses filter filters[y], filtered byte by
    byte as the PNG specification defines it."""
    H, W, C = img.shape
    data = img.reshape(H, W * C).astype(np.int64)
    raw = bytearray()
    for y in range(H):
        f = filters[y]
        raw.append(f)
        for i in range(W * C):
            a = data[y, i - C] if i >= C else 0
            b = data[y - 1, i] if y > 0 else 0
            c = data[y - 1, i - C] if y > 0 and i >= C else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[f]
            raw.append(int(data[y, i] - pred) % 256)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    header = struct.pack(">IIBBBBB", W, H, 8, 6 if C == 4 else 2, 0, 0, 0)
    return (png.SIGNATURE + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("filters", ["all", "rows"])
def test_read_every_filter_matches_pil(tmp_path, channels, filters):
    """All five row filters in turn down the image ("all"), or only None,
    Sub and Up ("rows"), on smooth and random pixels."""
    rng = np.random.default_rng(7)
    H, W = 23, 19
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    smooth = (yy[..., None] * 7 + xx[..., None] * 5 + np.arange(channels) * 40) % 256
    img = np.where(rng.uniform(size=(H, W, 1)) < 0.5, smooth,
                   rng.integers(0, 256, (H, W, channels))).astype(np.uint8)
    kinds = 5 if filters == "all" else 3
    path = str(tmp_path / "img.png")
    with open(path, "wb") as f:
        f.write(_encode(img, [y % kinds for y in range(H)]))
    ours = png.read(path)
    assert np.array_equal(ours, np.asarray(Image.open(path)))
    assert np.array_equal(ours, img)
