"""Image writers for tests and fixtures (numpy and ``zlib``): PNG of every
colour type and depth PNG allows, Adam7 interlacing, the five row filters
and any extra chunks, which neither ``cv2.imwrite`` nor Pillow writes all
of; and EXIF orientation spliced into JPEG bytes."""
import struct
import zlib

import numpy as np

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _rows(samples: np.ndarray, depth: int, filters) -> bytes:
    """(h, w, c) samples -> filtered scanlines, row y with filter
    ``filters[y % len(filters)]``."""
    h, w, c = samples.shape
    if depth == 16:
        data = samples.astype(">u2").view(np.uint8).reshape(h, w * c * 2)
    elif depth == 8:
        data = samples.reshape(h, w * c).astype(np.uint8)
    else:  # MSB first, the last byte zero-padded
        per = 8 // depth
        flat = samples.reshape(h, w * c).astype(np.uint8)
        flat = np.pad(flat, ((0, 0), (0, -flat.shape[1] % per)))
        flat = flat.reshape(h, -1, per)
        data = np.zeros(flat.shape[:2], np.uint8)
        for k in range(per):
            data |= flat[..., k] << (8 - depth * (k + 1))
    bpp = max(1, c * depth // 8)
    cur = data.astype(np.int32)
    out = bytearray()
    for y in range(h):
        f = filters[y % len(filters)]
        row = cur[y]
        a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        b = cur[y - 1] if y else np.zeros_like(row)
        cc = np.concatenate([np.zeros(bpp, np.int32), b[:-bpp]])
        pred = [0, a, b, (a + b) >> 1, _paeth(a, b, cc)][f]
        out.append(f)
        out += ((row - pred) & 0xFF).astype(np.uint8).tobytes()
    return bytes(out)


def write_png(samples: np.ndarray, depth: int, ctype: int,
              interlace: bool = False, palette=None, trns: bytes = None,
              before=(), after=(), filters=(0, 1, 2, 3, 4)) -> bytes:
    """Samples (h, w) or (h, w, c) in the file's channel order -> PNG
    bytes. ``before`` chunks go after IHDR, ``after`` ones after IDAT."""
    c = CHANNELS[ctype]
    h, w = samples.shape[:2]
    samples = samples.reshape(h, w, c)
    if interlace:
        raw = b"".join(
            _rows(samples[y0::dy, x0::dx], depth, filters)
            for x0, y0, dx, dy in ADAM7
            if samples[y0::dy, x0::dx].size)
    else:
        raw = _rows(samples, depth, filters)
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    out += b"".join(before)
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    out += chunk(b"IDAT", zlib.compress(raw, 9))
    out += b"".join(after)
    return out + chunk(b"IEND", b"")


def exif_tiff(orient: int, order: bytes = b"MM") -> bytes:
    """A TIFF body holding IFD0 with one Orientation (SHORT) entry."""
    e = "<" if order == b"II" else ">"
    return (order + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIH", 0x0112, 3, 1, orient) + b"\0\0"
            + struct.pack(e + "I", 0))


def with_exif_app1(jpeg: bytes, tiff: bytes) -> bytes:
    """JPEG bytes with an APP1 ``Exif`` segment after SOI (and after a JFIF
    APP0 where there is one)."""
    seg = b"Exif\0\0" + tiff
    app1 = b"\xff\xe1" + struct.pack(">H", len(seg) + 2) + seg
    at = 2
    if jpeg[2:4] == b"\xff\xe0":
        at = 4 + struct.unpack(">H", jpeg[4:6])[0]
    return jpeg[:at] + app1 + jpeg[at:]
