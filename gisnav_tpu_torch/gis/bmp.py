"""BMP read as OpenCV 5 reads it (``grfmt_bmp.cpp``; no OpenCV).

``decode_bmp(data, gray)`` is ``cv2.imdecode`` of BMP bytes under
``IMREAD_UNCHANGED`` or ``IMREAD_GRAYSCALE``, with OpenCV's rules (found by
asking cv2):

- headers: OS/2 ``BITMAPCOREHEADER`` (12 bytes: 1, 4, 8, 24 and 32 bits,
  3-byte palette entries) and ``BITMAPINFOHEADER`` and its V4 / V5
  extensions (36 bytes or more: 1, 4, 8, 24, 32 bits uncompressed, 16 and
  32 bits uncompressed or bitfields, RLE8 at 8 and RLE4 at 4 bits); a
  negative height is top-down;
- type: a palette of grey entries (every one of its 2^bits, unused ones
  zero) and every OS/2 file give grey (H, W); 32 bits with bitfields give
  BGRA (after a 40-byte header the bytes as they are, after a V4 / V5 one
  through its R, G, B and A masks, byte masks only, alpha 255 where its
  mask is 0), every other file BGR; 16 bits are 5-5-5 unless bitfields
  say 5-6-5 (masks read just after the 40-byte header's end: a V4 / V5
  header's own masks are not, and any other masks give None);
- grey, from a colour file or a palette, is OpenCV's fixed-point
  ``icvCvt_BGR2Gray`` (``gis/coders.py`` ``bgr_to_gray``), but for V4 / V5
  bitfields: floor(0.299 R + 0.587 G + 0.114 B) in float32;
- RLE8 / RLE4 through ``native/imgcodecs.cpp``, as OpenCV fills skipped
  pixels (palette entry 0; RLE4's end-of-bitmap ends only its row and its
  delta moves dx only); a run
  past its row's end, or data cut short, gives None.
"""
from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from gisnav_tpu_torch.gis import coders

__all__ = ["decode_bmp", "BMP_SIGNATURE"]

BMP_SIGNATURE = b"BM"
_RGB, _RLE8, _RLE4, _BITFIELDS = 0, 1, 2, 3


class _Bad(Exception):
    pass


def _expand16(words: np.ndarray, bits: int) -> np.ndarray:
    """15 / 16-bit words -> (..., 3) BGR as OpenCV's icvCvt_BGR5552BGR /
    BGR5652BGR."""
    v = words.astype(np.int32)
    b = (v << 3) & 0xF8
    if bits == 15:
        g, r = (v >> 2) & 0xF8, (v >> 7) & 0xF8
    else:
        g, r = (v >> 3) & 0xFC, (v >> 8) & 0xF8
    return np.stack([b, g, r], axis=-1).astype(np.uint8)


def _masked(words: np.ndarray, masks) -> np.ndarray:
    """32-bit words through a V4 / V5 header's R, G, B, A masks -> BGRA,
    each field scaled to 8 bits as OpenCV scales it: v * (255 / its
    largest value) in float32, truncated (alpha 255 where its mask is
    0)."""
    r, g, b, a = masks
    out = np.empty(words.shape + (4,), np.uint8)
    for k, m in enumerate((b, g, r, a)):
        if not m:
            out[..., k] = 255 if k == 3 else 0
            continue
        shift = (m & -m).bit_length() - 1
        top = np.float32(m >> shift)
        v = ((words & np.uint32(m)) >> np.uint32(shift)).astype(np.float32)
        out[..., k] = (v * (np.float32(255) / top)).astype(np.uint8)
    return out


def _decode(data: bytes, gray: bool) -> np.ndarray:
    if len(data) < 18:
        raise _Bad
    offset = struct.unpack_from("<i", data, 10)[0]
    size = struct.unpack_from("<i", data, 14)[0]
    pos = 18
    palette = np.zeros((256, 3), np.uint8)  # BGR
    colour = False
    if size >= 36:
        if pos + 32 > len(data):
            raise _Bad
        width, height, planes_bpp, code = struct.unpack_from("<iiIi", data,
                                                             pos)
        bpp = planes_bpp >> 16
        clr_used = struct.unpack_from("<i", data, pos + 28)[0]
        pos += 32 + size - 36
        ok = width > 0 and height != 0 and (
            (bpp in (1, 4, 8, 24, 32) and code == _RGB)
            or (bpp in (16, 32) and code in (_RGB, _BITFIELDS))
            or (bpp == 4 and code == _RLE4) or (bpp == 8 and code == _RLE8))
        if not ok:
            raise _Bad
        colour = True
        masks = None
        if bpp == 32 and code == _BITFIELDS and size >= 56:
            masks = struct.unpack_from("<4I", data, 54)
        if bpp <= 8:
            if not 0 <= clr_used <= 256:
                raise _Bad
            n = clr_used or (1 << bpp)
            if pos + 4 * n > len(data):
                raise _Bad
            entries = np.frombuffer(data, np.uint8, 4 * n, pos).reshape(n, 4)
            palette[:n] = entries[:, :3]
            used = palette[:1 << bpp]
            colour = bool(((used[:, 0] != used[:, 1])
                           | (used[:, 0] != used[:, 2])).any())
        elif bpp == 16 and code == _BITFIELDS:
            if pos + 12 > len(data):
                raise _Bad
            r, g, b = struct.unpack_from("<III", data, pos)
            if (b, g, r) == (0x1F, 0x3E0, 0x7C00):
                bpp = 15
            elif (b, g, r) != (0x1F, 0x7E0, 0xF800):
                raise _Bad
        elif bpp == 16:
            bpp = 15
    elif size == 12:
        masks = None
        if pos + 8 > len(data):
            raise _Bad
        width, height, planes_bpp = struct.unpack_from("<HHI", data, pos)
        bpp = planes_bpp >> 16
        code = _RGB
        if not (width > 0 and height != 0 and bpp in (1, 4, 8, 24, 32)):
            raise _Bad
        pos += 8
        if bpp <= 8:
            n = 1 << bpp
            if pos + 3 * n > len(data):
                raise _Bad
            palette[:n] = np.frombuffer(data, np.uint8, 3 * n,
                                        pos).reshape(n, 3)
    else:
        raise _Bad
    channels = (4 if bpp == 32 and code != _RGB else 3) if colour else 1
    if gray:
        channels = 1
    bottom_up = height > 0
    height = abs(height)
    coders.check_image_size(width, height, "BMP")
    if offset < 0:
        raise _Bad
    if code in (_RLE4, _RLE8):
        idx = coders.bmp_rle(data[offset:], code == _RLE4, width, height)
        if idx is None:
            raise _Bad
        px = palette[idx]
    else:
        pitch = ((width * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & ~3
        if offset + pitch * height > len(data):
            raise _Bad
        rows = np.frombuffer(data, np.uint8, pitch * height,
                             offset).reshape(height, pitch)
        if bpp < 8:
            per = 8 // bpp
            shifts = (8 - bpp) - bpp * np.arange(per, dtype=np.uint8)
            idx = ((rows[..., None] >> shifts) & ((1 << bpp) - 1)
                   ).reshape(height, -1)[:, :width]
            px = palette[idx]
        elif bpp == 8:
            idx = rows[:, :width]
            px = palette[idx]
        elif bpp in (15, 16):
            px = _expand16(rows[:, :2 * width].view("<u2"), bpp)
        elif masks is not None:
            px = _masked(rows[:, :4 * width].view("<u4"), masks)
        else:
            px = rows[:, :width * bpp // 8].reshape(height, width, bpp // 8)
    if bottom_up:
        px = px[::-1]
    if masks is not None and channels == 1:
        # OpenCV's float grey of the masked BGRA, truncated
        c = px[..., :3].astype(np.float32)
        return np.floor(c[..., 2] * np.float32(0.299)
                        + c[..., 1] * np.float32(0.587)
                        + c[..., 0] * np.float32(0.114)).astype(np.uint8)
    if channels == 1:
        if bpp <= 8:  # the palette's grey (CvtPaletteToGray)
            grey = coders.bgr_to_gray(palette)
            return grey[idx[::-1] if bottom_up else idx]
        return coders.bgr_to_gray(px)
    if channels == 3:
        return np.ascontiguousarray(px[..., :3])
    return np.ascontiguousarray(px)


def decode_bmp(data: bytes, gray: bool) -> Optional[np.ndarray]:
    """BMP bytes -> ``cv2.imdecode``'s array under ``IMREAD_GRAYSCALE``
    (``gray``) or ``IMREAD_UNCHANGED``; None where cv2 gives None."""
    try:
        return _decode(bytes(data), gray)
    except (_Bad, struct.error):
        return None
