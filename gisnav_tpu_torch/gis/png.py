"""PNG decoding and encoding in numpy and ``zlib`` (no OpenCV, no Pillow).

The JAX package decodes WMS rasters with ``cv2.imdecode``; the card
machine has no OpenCV, so the port reads PNG itself:

- non-interlaced PNG of bit depth 8 or 16, grey (type 0), RGB (2) and
  RGBA (6); chunk CRCs are checked;
- the five row filters (None, Sub, Up, Average, Paeth). Rows of the first
  three decode a row at a time; an image with Average or Paeth rows
  decodes along anti-diagonals, all rows at once, since a pixel of those
  needs its left, upper and upper-left neighbours decoded first;
- ``to_gray`` converts colour with OpenCV's fixed-point weights
  (``cv2.COLOR_BGR2GRAY`` in OpenCV 5: 9798 R + 19235 G + 3735 B over
  2^15, rounded), alpha ignored.

Anything else (palette and grey + alpha images, depths under 8, Adam7
interlacing, JPEG or any non-PNG bytes) raises ``ValueError`` naming what it
found (``gis/jpeg.py`` ``decode_image`` chooses between PNG and JPEG).
``encode_png`` writes an 8-bit grey or colour PNG with filter None on every
row.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["decode_png", "encode_png", "to_gray", "PNG_SIGNATURE"]

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}
_JPEG_SOI = b"\xff\xd8\xff"


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError("truncated PNG chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG without IEND")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """(h, 1 + w * bpp) filtered scanlines -> (h, w, bpp) uint8 bytes."""
    ftype = raw[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {int(ftype.max())} is not one of "
                         "the five")
    data = raw[:, 1:].reshape(h, w, bpp).astype(np.int32)
    # a zero row above and a zero column left: PNG's neighbours outside
    out = np.zeros((h + 1, w + 1, bpp), np.int32)
    if ftype.max(initial=0) <= 2:
        for y in range(h):
            f, row = ftype[y], data[y]
            if f == 1:
                row = np.cumsum(row, axis=0)
            elif f == 2:
                row = row + out[y, 1:]
            out[y + 1, 1:] = row & 0xFF
        return out[1:, 1:].astype(np.uint8)
    for d in range(h + w - 1):  # anti-diagonals: x + y = d
        y = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - y
        a, b, c = out[y + 1, x], out[y, x + 1], out[y, x]
        f = ftype[y][:, None]
        pred = np.select([f == 0, f == 1, f == 2, f == 3],
                         [0, a, b, (a + b) >> 1], _paeth(a, b, c))
        out[y + 1, x + 1] = (data[y, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) or (H, W, C) uint8 / uint16, channels in the
    file's order (RGB, RGBA)."""
    if not data.startswith(PNG_SIGNATURE):
        found = "JPEG" if data.startswith(_JPEG_SOI) else repr(data[:8])
        raise ValueError(f"not a PNG image ({found}); gis/jpeg.py "
                         "decode_image reads PNG and JPEG")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or depth not in (8, 16):
        raise ValueError(f"PNG colour type {ctype} at bit depth {depth} is "
                         "not supported (grey, RGB, RGBA at 8 or 16 bits)")
    if interlace:
        raise ValueError("interlaced (Adam7) PNG is not supported")
    channels = _CHANNELS[ctype]
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError("PNG image data does not match its header")
    px = _unfilter(raw.reshape(h, 1 + w * bpp), h, w, bpp)
    if depth == 16:
        px = px.reshape(h, w, channels, 2).astype(np.uint16)
        px = (px[..., 0] << 8) | px[..., 1]
    else:
        px = px.reshape(h, w, channels)
    return px[..., 0] if channels == 1 else px


def to_gray(img: np.ndarray) -> np.ndarray:
    """RGB or RGBA -> grey, OpenCV's rounding; a grey image passes
    through."""
    if img.ndim == 2:
        return img
    c = img[..., :3].astype(np.int64)
    g = (c[..., 0] * 9798 + c[..., 1] * 19235 + c[..., 2] * 3735
         + (1 << 14)) >> 15
    return g.astype(img.dtype)


def encode_png(img: np.ndarray) -> bytes:
    """(H, W) or (H, W, 3|4) uint8 -> PNG bytes (filter None)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png writes uint8, got {img.dtype}")
    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}[channels]
    rows = np.zeros((h, 1 + w * channels), np.uint8)
    rows[:, 1:] = img.reshape(h, w * channels)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))
