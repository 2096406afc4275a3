"""PNG reading and writing with the standard library (zlib) and numpy.

The baked scenes store their SH band textures as 8-bit PNGs. The port reads
them without PIL: ``read`` takes 8-bit, non-interlaced greyscale, greyscale
with alpha, RGB and RGBA images with any of the five row filters (palette
images and other bit depths raise), and ``write`` stores greyscale, RGB or
RGBA rows unfiltered (filter 0) at zlib level 1.

Undoing the filters: an image whose rows are all unfiltered (as ``write``
makes them) is used as it is. Otherwise, since Sub, Average and Paeth
predict each byte from the pixel to its left, a row cannot be undone at
once, so the image is undone one anti-diagonal at a time (all pixels with
x + y = d): every filter reads only the pixels left, above and above-left,
which lie on the two diagonals before. That is one vectorised step over
each of the H + W - 1 diagonals, not one a pixel.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (greyscale, RGB, greyscale + alpha, RGBA)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOUR_TYPE = {c: t for t, c in _CHANNELS.items()}


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file ends before IEND")


def _unfilter_diagonals(raw, filters, bpp):
    """Any filters, one anti-diagonal x + y = d at a time. The bytes are
    kept skewed, pixel (y, x) at [x + y, y], so that a diagonal and the
    left, above and above-left pixels it reads are contiguous slices."""
    H, stride = raw.shape
    W = stride // bpp
    D = H + W - 1
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    # skewed, with one zero column in front (y = -1): pixel (y, x) at [x+y, y+1]
    pix = np.zeros((D, H + 1, bpp), np.int16)
    pix[yy + xx, yy + 1] = raw.reshape(H, W, bpp)
    # reconstructed bytes, diagonal d at [d + 2]; diagonals -2, -1 are zero
    rec = np.zeros((D + 2, H + 1, bpp), np.int16)
    ft = np.asarray(filters, np.int16)[:, None, None]
    for d in range(D):
        y0, y1 = max(0, d - W + 1), min(H, d + 1)
        a = rec[d + 1, y0 + 1:y1 + 1]  # left: (y, x-1), zero where x = 0
        b = rec[d + 1, y0:y1]  # above: (y-1, x), zero where y = 0
        c = rec[d, y0:y1]  # above-left
        f = ft[y0:y1, 0]
        pa = np.abs(b - c)
        pb = np.abs(a - c)
        pc = np.abs(a + b - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(f == 4, pred, np.where(f == 3, (a + b) >> 1,
                                               np.where(f == 2, b, np.where(f == 1, a, 0))))
        rec[d + 2, y0 + 1:y1 + 1] = (pix[d, y0 + 1:y1 + 1] + pred) & 255
    return rec[yy + xx + 2, yy + 1].astype(np.uint8).reshape(H, stride)


def read(path: str) -> np.ndarray:
    """An 8-bit, non-interlaced greyscale, greyscale + alpha, RGB or RGBA
    PNG as uint8 [H, W, 1, 2, 3 or 4]."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, colour, compression, filtering, interlace = header
    if depth != 8 or colour not in _CHANNELS or compression or filtering or interlace:
        raise ValueError(
            f"{path}: only 8-bit non-interlaced greyscale, RGB and RGBA PNGs (with or "
            f"without alpha) are read (bit depth "
            f"{depth}, colour type {colour}, interlace {interlace})")
    bpp = _CHANNELS[colour]
    stride = W * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes of pixel data, expected {H * (stride + 1)}")
    raw = raw.reshape(H, stride + 1)
    filters = raw[:, 0]
    if filters.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown row filter {int(filters.max())}")
    rows = raw[:, 1:]
    img = _unfilter_diagonals(rows, filters, bpp) if filters.any() else rows
    return np.ascontiguousarray(img).reshape(H, W, bpp)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write(path: str, img: np.ndarray) -> None:
    """Write uint8 [H, W], [H, W, 1], [H, W, 3] or [H, W, 4] as an 8-bit
    greyscale, RGB or RGBA PNG, every row unfiltered (filter 0), compressed
    at zlib level 1 (fast; random texels do not compress anyway)."""
    img = np.ascontiguousarray(img)
    if img.ndim == 2:
        img = img[..., None]
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (1, 3, 4):
        raise ValueError(f"write: expected uint8 [H, W(, 1|3|4)], got {img.dtype} {img.shape}")
    H, W, C = img.shape
    rows = np.concatenate([np.zeros((H, 1), np.uint8), img.reshape(H, W * C)], axis=1)
    header = struct.pack(">IIBBBBB", W, H, 8, _COLOUR_TYPE[C], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + _chunk(b"IEND", b""))
