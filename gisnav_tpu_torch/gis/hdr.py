"""Radiance HDR (RGBE) read as OpenCV 5 reads it (``grfmt_hdr.cpp`` over
its ``rgbe.cpp``; no OpenCV).

``decode_hdr(data, gray)`` is ``cv2.imdecode`` under ``IMREAD_UNCHANGED``
((H, W, 3) float32 BGR) or ``IMREAD_GRAYSCALE``:

- the header is read as OpenCV 5.0's ``RGBE_ReadHeader`` reads it, a line
  at a time (127 bytes at most, as ``fgets`` into its 128-byte buffer):
  lines up to an empty one, one of them exactly
  ``FORMAT=32-bit_rle_rgbe`` (else None; ``EXPOSURE`` and ``GAMMA`` change
  no pixel), then ``-Y <height> +X <width>`` (other orientations give
  None);
- the pixels through ``native/imgcodecs.cpp`` ``hdr_rle``: new-style
  run-length scanlines (2, 2, width) of 8 to 32767 pixels, else flat
  RGBE; the first scanline that is not run-length coded and everything
  after it are read flat (old-style runs are not expanded, as in
  ``rgbe.cpp``); each pixel is (R, G, B) * 2^(E - 136), 0 where E is 0;
- under the grey flag the BGR floats times 255 are saturated to uint8
  (``gis/coders.py`` ``saturate_u8``: past int32's range 0, as
  ``cvRound`` makes it), then ``cv2.cvtColor``'s grey (``gis/png.py``
  ``to_gray``);
- pixel data that is cut short or a corrupt scanline gives None.
"""
from __future__ import annotations

import re
from typing import Optional

import numpy as np

from gisnav_tpu_torch.gis import coders
from gisnav_tpu_torch.gis.png import to_gray

__all__ = ["decode_hdr", "HDR_SIGNATURES"]

HDR_SIGNATURES = (b"#?RADIANCE", b"#?RGBE")
_FORMAT = b"FORMAT=32-bit_rle_rgbe\n"
_SIZE = re.compile(rb"-Y\s*([+-]?\d+)\s*\+X\s*([+-]?\d+)")


class _Bad(Exception):
    pass


def _lines(data: bytes):
    """``fgets`` into a 128-byte buffer: (line, position after it)."""
    pos = 0
    while pos < len(data):
        end = data.find(b"\n", pos, pos + 127)
        stop = end + 1 if end >= 0 else min(pos + 127, len(data))
        yield data[pos:stop], stop
        pos = stop


def _decode(data: bytes, gray: bool) -> np.ndarray:
    lines = _lines(data)
    found = False
    for line, _ in lines:
        if line in (b"", b"\n") or line.startswith(b"\0"):
            break
        found = found or line == _FORMAT
    else:
        raise _Bad  # the data ends inside the header
    if not found or line != b"\n":
        raise _Bad
    size, pos = next(lines, (None, 0))
    m = _SIZE.match(size or b"")
    if m is None:
        raise _Bad
    h, w = int(m.group(1)), int(m.group(2))
    if h <= 0 or w <= 0:
        raise _Bad
    coders.check_image_size(w, h, "Radiance HDR")
    rgbe = coders.hdr_rle(data[pos:], w, h)
    if rgbe is None:
        raise _Bad
    rgbe = rgbe.astype(np.float32)
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0).astype(np.float32)
    img = np.ascontiguousarray((rgbe[..., :3] * scale[..., None])[..., ::-1])
    if not gray:
        return img
    with np.errstate(over="ignore"):  # past float32: 0, as cv2 makes it
        scaled = img * np.float32(255)
    return to_gray(coders.saturate_u8(scaled)[..., ::-1])


def decode_hdr(data: bytes, gray: bool) -> Optional[np.ndarray]:
    """Radiance bytes -> ``cv2.imdecode``'s array; None where cv2 gives
    None."""
    try:
        return _decode(bytes(data), gray)
    except _Bad:
        return None
