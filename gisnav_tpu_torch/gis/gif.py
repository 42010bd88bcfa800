"""GIF read as OpenCV 5 reads it (its own ``grfmt_gif.cpp``; no giflib,
no OpenCV).

``decode_gif(data, gray)`` is ``cv2.imdecode`` of GIF bytes under
``IMREAD_UNCHANGED`` or ``IMREAD_GRAYSCALE``; the rules below were found by
asking cv2:

- the whole stream is walked to its trailer (``;``): a block OpenCV does
  not know, or the data ending before the trailer, gives None; only the
  first image is decoded (global or local colour table, interlace, LZW
  through ``native/imgcodecs.cpp``; a short or corrupt stream, or one
  whose codes write past the image before its end code, gives None);
- the image is drawn on the logical screen, which starts as the background
  colour (the global table's entry, black without a global table; an index
  past the table gives None); an image reaching past the screen, or an
  index past its colour table, gives None;
- a graphic control extension anywhere in the file with its transparency
  flag set makes the result BGRA: the screen's alpha 0, the first image's
  pixels alpha 255 but its transparent index, which keeps the screen;
  otherwise BGR (H, W, 3), grey palettes included;
- ``IMREAD_GRAYSCALE`` is ``cv2.cvtColor``'s grey of that (``gis/png.py``
  ``to_gray``), not OpenCV's fixed-point decoder grey.
"""
from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from gisnav_tpu_torch.gis import coders
from gisnav_tpu_torch.gis.png import to_gray

__all__ = ["decode_gif", "GIF_SIGNATURES"]

GIF_SIGNATURES = (b"GIF87a", b"GIF89a")


class _Bad(Exception):
    pass


def _blocks(data: bytes, pos: int):
    """Data sub-blocks from ``pos``: (joined bytes, position after the
    terminator)."""
    out = []
    while True:
        if pos >= len(data):
            raise _Bad
        n = data[pos]
        pos += 1
        if n == 0:
            return b"".join(out), pos
        if pos + n > len(data):
            raise _Bad
        out.append(data[pos:pos + n])
        pos += n


def _table(data: bytes, pos: int, flags: int):
    """A colour table of 2^(flags & 7 + 1) entries at ``pos`` -> (RGB
    array or None, position after it)."""
    if not flags & 0x80:
        return None, pos
    n = 2 << (flags & 7)
    if pos + 3 * n > len(data):
        raise _Bad
    return np.frombuffer(data, np.uint8, 3 * n, pos).reshape(n, 3), pos + 3 * n


def _interlaced_rows(h: int) -> np.ndarray:
    """The stored order of an interlaced image's rows."""
    return np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                           np.arange(2, h, 4), np.arange(1, h, 2)])


def _decode(data: bytes) -> np.ndarray:
    if len(data) < 13:
        raise _Bad
    sw, sh, flags, bg = struct.unpack_from("<HHBB", data, 6)
    gct, pos = _table(data, 13, flags)
    image = None
    transparent_anywhere = False
    transparent: Optional[int] = None
    while True:
        if pos >= len(data):
            raise _Bad  # no trailer
        kind = data[pos]
        pos += 1
        if kind == 0x3B:
            break
        if kind == 0x21:
            if pos >= len(data):
                raise _Bad
            label = data[pos]
            body, pos = _blocks(data, pos + 1)
            if label == 0xF9 and len(body) >= 4:
                if body[0] & 1:
                    transparent_anywhere = True
                    if image is None:
                        transparent = body[3]
                elif image is None:
                    transparent = None
            continue
        if kind != 0x2C:
            raise _Bad
        if pos + 9 > len(data):
            raise _Bad
        left, top, w, h, iflags = struct.unpack_from("<HHHHB", data, pos)
        lct, pos = _table(data, pos + 9, iflags)
        if pos >= len(data):
            raise _Bad
        mcs = data[pos]
        lzw, pos = _blocks(data, pos + 1)
        if image is None:
            image = (left, top, w, h, iflags, lct, mcs, lzw, transparent)
    if image is None:
        raise _Bad
    coders.check_image_size(sw, sh, "GIF")  # the header OpenCV read
    left, top, w, h, iflags, lct, mcs, lzw, transparent = image
    if left + w > sw or top + h > sh or not w or not h:
        raise _Bad
    if gct is not None:
        if bg >= len(gct):
            raise _Bad
        bg_rgb = gct[bg]
    else:
        bg_rgb = np.zeros(3, np.uint8)
    palette = lct if lct is not None else gct
    if palette is None:
        raise _Bad
    try:
        idx = coders.gif_lzw(lzw, mcs, w * h).reshape(h, w)
    except ValueError as e:
        raise _Bad from e
    if int(idx.max()) >= len(palette):
        raise _Bad
    if iflags & 0x40:
        rows = np.empty_like(idx)
        rows[_interlaced_rows(h)] = idx
        idx = rows
    channels = 4 if transparent_anywhere else 3
    bgr = np.ascontiguousarray(palette[:, ::-1])
    if channels == 3 and (w, h) == (sw, sh):
        return bgr[idx]
    screen = np.empty((sh, sw, channels), np.uint8)
    screen[..., :3] = bg_rgb[::-1]
    if channels == 4:
        screen[..., 3] = 0
    px = np.empty((h, w, channels), np.uint8)
    px[..., :3] = bgr[idx]
    if channels == 4:
        px[..., 3] = 255
    region = screen[top:top + h, left:left + w]
    if transparent is not None:
        keep = idx != transparent
        region[keep] = px[keep]
    else:
        region[...] = px
    return screen


def decode_gif(data: bytes, gray: bool) -> Optional[np.ndarray]:
    """GIF bytes -> ``cv2.imdecode``'s array under ``IMREAD_GRAYSCALE``
    (``gray``: (H, W) uint8) or ``IMREAD_UNCHANGED`` (BGR or BGRA); None
    where cv2 gives None."""
    try:
        img = _decode(bytes(data))
    except (_Bad, struct.error):
        return None
    if gray:
        return to_gray(img[..., 2::-1])
    return img
