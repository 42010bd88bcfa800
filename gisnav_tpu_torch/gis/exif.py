"""EXIF orientation as OpenCV reads and applies it (no OpenCV here).

``cv2.imread`` / ``cv2.imdecode`` turn an image upright by its EXIF
Orientation tag under every flag but ``IMREAD_UNCHANGED``: a JPEG's first
APP1 segment that starts ``Exif\\0\\0`` (before the first scan) and a PNG's
first valid ``eXIf`` chunk. ``orientation(tiff)`` reads that TIFF body as
OpenCV's ``ExifReader`` does:

- the byte order from the first two bytes (``II`` little-endian, anything
  else big-endian), 42 at offset 2, IFD0 at the offset in bytes 4-7; the
  IFD's entries are read in order and IFD1 is never followed;
- Orientation (0x0112) is the 16 bits at the entry's value field whatever
  its type (a LONG in big-endian order therefore reads 0); the first one
  counts;
- the string tags (ImageDescription, Make, Model, Software, DateTime,
  Copyright) and the rational ones (X/YResolution, WhitePoint,
  PrimaryChromaticities, YCbCrCoefficients, ReferenceBlackWhite) are
  followed to their data, and ResolutionUnit and YCbCrPositioning read
  their value field: a read past the end stops the parse there, and
  entries read before it stand (an Orientation after a Make whose string
  lies past the end is lost, one before it is applied);
- any other tag is skipped unread, a value outside 1-8 means upright.

``apply_orientation(img, o)`` is OpenCV's ``ApplyExifOrientation``: flips
and transposes, (H, W) or (H, W, C).
"""
from __future__ import annotations

import numpy as np

__all__ = ["orientation", "apply_orientation", "ORIENTATION_TAG"]

ORIENTATION_TAG = 0x0112
_STRING_TAGS = frozenset({0x010E, 0x010F, 0x0110, 0x0131, 0x0132, 0x8298})
# tag -> number of unsigned rationals read through the value's offset
_RATIONAL_TAGS = {0x011A: 1, 0x011B: 1, 0x013E: 2, 0x013F: 6, 0x0211: 3,
                  0x0214: 6}
_SHORT_TAGS = frozenset({0x0128, 0x0213})  # ResolutionUnit, YCbCrPositioning
_ENTRY = 12


class _PastEnd(Exception):
    pass


def orientation(tiff: bytes) -> int:
    """The EXIF Orientation (1-8) of a TIFF body as OpenCV reads it; 1 when
    it has none or OpenCV's parse stops before it."""
    n = len(tiff)
    order = "little" if (n >= 1 and tiff[0] == 0x49
                         and (n == 1 or tiff[1] == 0x49)) else "big"

    def u16(off: int) -> int:
        if off + 1 >= n:
            raise _PastEnd
        return int.from_bytes(tiff[off:off + 2], order)

    def u32(off: int) -> int:
        if off + 3 >= n:
            raise _PastEnd
        return int.from_bytes(tiff[off:off + 4], order)

    try:
        if u16(2) != 42:
            return 1
        ifd = u32(4)
        for i in range(u16(ifd)):
            off = ifd + 2 + _ENTRY * i
            tag = u16(off)
            if tag == ORIENTATION_TAG:
                value = u16(off + 8)
                return value if 1 <= value <= 8 else 1
            if tag in _STRING_TAGS:
                size = u32(off + 4)
                data = 8 if size <= 4 else u32(off + 8)
                if data > n or data + size > n:
                    raise _PastEnd
            elif tag in _RATIONAL_TAGS:
                at = u32(off + 8)
                for k in range(_RATIONAL_TAGS[tag]):
                    u32((at + 8 * k) & 0xFFFFFFFF)
                    u32((at + 8 * k + 4) & 0xFFFFFFFF)
            elif tag in _SHORT_TAGS:
                u16(off + 8)
    except _PastEnd:
        pass
    return 1


def apply_orientation(img: np.ndarray, o: int) -> np.ndarray:
    """``img`` turned upright for EXIF orientation ``o``, as OpenCV turns
    it (5-8 transpose first, then flip)."""
    if o in (5, 6, 7, 8):
        img = img.swapaxes(0, 1)
    if o in (2, 6):
        img = img[:, ::-1]
    elif o in (3, 7):
        img = img[::-1, ::-1]
    elif o in (4, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)
