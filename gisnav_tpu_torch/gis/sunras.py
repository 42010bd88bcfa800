"""Sun raster read as OpenCV 5.0 reads it (``grfmt_sunras.cpp``; no
OpenCV).

``decode_sunras(data, gray)`` is ``cv2.imdecode`` under
``IMREAD_UNCHANGED`` or ``IMREAD_GRAYSCALE``. OpenCV 5.0's decoder, asked
file by file, reads less than the format holds, and the port reads what it
reads:

- the 32-byte big-endian header; 1, 8, 24 and 32 bits; types 0 (old) and 1
  (standard) only: byte-encoded (RLE, type 2) and RGB (type 3) files give
  None;
- a colour map (``RMT_EQUAL_RGB``, up to 2^bits entries, the rest zero)
  gives BGR, or grey (H, W) where every entry is grey; under the grey flag
  the map's grey is OpenCV's fixed-point ``icvCvt_BGR2Gray``;
- 1 and 8-bit files without a map read as zeros (OpenCV's grey table is
  left empty);
- 24 bits are B, G, R as stored, 32 bits skip each pixel's first byte;
  under the grey flag both are OpenCV's fixed-point grey of those bytes;
- rows are padded to 16 bits; data cut short gives None.
"""
from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from gisnav_tpu_torch.gis import coders

__all__ = ["decode_sunras", "SUNRAS_SIGNATURE"]

SUNRAS_SIGNATURE = b"\x59\xa6\x6a\x95"


class _Bad(Exception):
    pass


def _decode(data: bytes, gray: bool) -> np.ndarray:
    if len(data) < 32:
        raise _Bad
    _, w, h, bpp, _, kind, maptype, maplength = struct.unpack_from(">8I",
                                                                  data, 0)
    if not (0 < w < 1 << 31 and 0 < h < 1 << 31 and bpp in (1, 8, 24, 32)):
        raise _Bad
    if kind not in (0, 1):
        raise _Bad
    pal_size = 3 << bpp if bpp <= 8 else 0
    if (maptype == 0) != (maplength == 0) or maptype not in (0, 1) or (
            maptype and not 0 < maplength <= pal_size):
        raise _Bad
    palette = np.zeros((256, 3), np.uint8)  # BGR
    colour = bpp > 8
    if maplength:
        if 32 + maplength > len(data):
            raise _Bad
        n = maplength // 3
        cmap = np.frombuffer(data, np.uint8, 3 * n, 32).reshape(3, n)
        palette[:n] = cmap[::-1].T
        used = palette[:1 << bpp]
        colour = bool(((used[:, 0] != used[:, 1])
                       | (used[:, 0] != used[:, 2])).any())
    coders.check_image_size(w, h, "Sun raster")
    pitch = ((w * bpp + 7) // 8 + 1) & ~1
    at = 32 + maplength
    if at + pitch * h > len(data):
        raise _Bad
    rows = np.frombuffer(data, np.uint8, pitch * h, at).reshape(h, pitch)
    if bpp <= 8:
        idx = (np.unpackbits(rows, axis=1)[:, :w] if bpp == 1
               else rows[:, :w])
        if not maplength:
            return np.zeros((h, w, 3) if colour and not gray else (h, w),
                            np.uint8)
        if gray or not colour:
            return coders.bgr_to_gray(palette)[idx]
        return palette[idx]
    px = rows[:, :w * bpp // 8].reshape(h, w, bpp // 8)[..., -3:]
    if gray:
        return coders.bgr_to_gray(px)
    return np.ascontiguousarray(px)


def decode_sunras(data: bytes, gray: bool) -> Optional[np.ndarray]:
    """Sun raster bytes -> ``cv2.imdecode``'s array; None where cv2 gives
    None."""
    try:
        return _decode(bytes(data), gray)
    except _Bad:
        return None
