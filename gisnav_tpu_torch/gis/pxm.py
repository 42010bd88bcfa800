"""Netpbm (PBM, PGM, PPM, PAM) and PFM read as OpenCV 5 reads them
(``grfmt_pxm.cpp``, ``grfmt_pam.cpp``, ``grfmt_pfm.cpp``; no OpenCV).

``decode_pxm(data, gray)``, ``decode_pam`` and ``decode_pfm`` are
``cv2.imdecode`` under ``IMREAD_UNCHANGED`` or ``IMREAD_GRAYSCALE``, with
OpenCV's rules (found by asking cv2):

- P1-P6: the header's numbers after any whitespace and ``#`` comments;
  one byte after maxval starts the raster. 1-bit images read 0 as white;
  ASCII samples under 256 are scaled to 0-255 by ``v * 255 / maxval`` and
  clamped at maxval first, binary ones are kept as they are (a maxval of
  100 is not rescaled); maxval over 255 gives uint16 (big-endian in the
  file), turned to its high byte under the grey flag; colour is BGR, its
  grey OpenCV's fixed-point ``icvCvt_BGR2Gray``; data that ends early
  gives None;
- P7 (PAM): ``WIDTH``, ``HEIGHT``, ``DEPTH``, ``MAXVAL``, ``TUPLTYPE`` and
  ``ENDHDR`` lines; a ``TUPLTYPE`` that does not fit ``DEPTH`` gives None;
  the samples are given as the file holds them (an RGB PAM stays in R, G,
  B order); under the grey flag RGB is OpenCV's fixed-point grey, grey +
  alpha each pixel's first sample three times over (OpenCV's
  ``basic_conversion`` writes three samples a pixel into the grey row), and
  RGBA raises ``ValueError`` (OpenCV leaves part of each row unwritten);
  ``BLACKANDWHITE`` (or maxval 1) rows are read as packed bits;
- PFM: ``Pf`` grey or ``PF`` colour float32, rows bottom-up, a negative
  scale little-endian; the samples multiplied by 1 / |scale| (float32),
  colour as BGR; under the grey flag rounded to uint8, colour kept as
  three channels.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from gisnav_tpu_torch.gis import coders

__all__ = ["decode_pxm", "decode_pam", "decode_pfm", "encode_pgm", "is_pxm",
           "is_pam", "is_pfm"]

_SPACE = b" \t\n\v\f\r"
_TUPLTYPES = {b"BLACKANDWHITE": 1, b"GRAYSCALE": 1, b"GRAYSCALE_ALPHA": 2,
              b"RGB": 3, b"RGB_ALPHA": 4}


class _Bad(Exception):
    pass


def is_pxm(sig: bytes) -> bool:
    """OpenCV's PxM signature: ``P1``-``P6`` and a white-space byte."""
    return len(sig) >= 3 and sig[0:1] == b"P" and sig[1:2] in b"123456" \
        and sig[2:3] in _SPACE


def is_pam(sig: bytes) -> bool:
    return len(sig) >= 3 and sig[:2] == b"P7" and sig[2:3] in _SPACE


def is_pfm(sig: bytes) -> bool:
    return len(sig) >= 3 and sig[:2] in (b"Pf", b"PF") and \
        sig[2:3] in _SPACE


class _Stream:
    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise _Bad
        b = self.data[self.pos]
        self.pos += 1
        return b

    def number(self, maxdigits: int = 0) -> int:
        """OpenCV's ReadNumber: skip whitespace and comments, read digits,
        and the byte after them."""
        c = self.byte()
        while not 48 <= c <= 57:
            if c == 35:  # '#': to the end of the line
                while c not in (10, 13):
                    c = self.byte()
                c = self.byte()
            elif c in _SPACE:
                while c in _SPACE:
                    c = self.byte()
            else:
                raise _Bad
        val = digits = 0
        while True:
            val = val * 10 + c - 48
            if val > 0x7FFFFFFF:
                raise _Bad
            digits += 1
            if maxdigits and digits >= maxdigits:
                break
            c = self.byte()
            if not 48 <= c <= 57:
                break
        return val

    def take(self, n: int) -> np.ndarray:
        if self.pos + n > len(self.data):
            raise _Bad
        out = np.frombuffer(self.data, np.uint8, n, self.pos)
        self.pos += n
        return out


def _pxm(data: bytes, gray: bool) -> np.ndarray:
    s = _Stream(data, 1)
    kind = s.byte() - 48
    bpp = {1: 1, 4: 1, 2: 8, 5: 8, 3: 24, 6: 24}[kind]
    binary = kind >= 4
    width, height = s.number(), s.number()
    maxval = s.number() if bpp > 1 else 1
    if maxval > 65535 or width <= 0 or height <= 0 or maxval <= 0:
        raise _Bad
    coders.check_image_size(width, height, "PxM")
    nch = 3 if bpp == 24 else 1
    wide = maxval > 255
    if bpp == 1:
        if binary:
            rows = s.take(((width + 7) // 8) * height).reshape(height, -1)
            bits = np.unpackbits(rows, axis=1)[:, :width]
        else:
            bits = np.array([[s.number(1) != 0 for _ in range(width)]
                             for _ in range(height)], np.uint8)
        return np.where(bits != 0, 0, 255).astype(np.uint8)
    n = width * height * nch
    if binary:
        px = s.take(n * (2 if wide else 1))
        px = px.view(">u2").astype(np.uint16) if wide else px
    else:
        vals = np.array([s.number() for _ in range(n)], np.int64)
        vals = np.minimum(vals, maxval)
        if wide:
            px = vals.astype(np.uint16)
        else:
            px = (vals * 255 // maxval).astype(np.uint8)
    px = px.reshape(height, width, nch)
    if gray and wide:
        px = (px >> 8).astype(np.uint8)
    if nch == 1:
        return np.ascontiguousarray(px[..., 0])
    if not gray:
        return np.ascontiguousarray(px[..., ::-1])
    if px.dtype == np.uint8:
        return coders.bgr_to_gray(px, rgb=True)
    c = px.astype(np.int64)
    return ((c[..., 0] * 4899 + c[..., 1] * 9617 + c[..., 2] * 1868
             + (1 << 13)) >> 14).astype(np.uint16)


def _pam_header(data: bytes) -> Tuple[dict, int]:
    if len(data) < 3 or data[2] not in (10, 13):
        raise _Bad
    pos = 3
    fields: dict = {}
    while True:
        end = data.find(b"\n", pos)
        if end < 0:
            raise _Bad
        line = data[pos:end].strip(b" \t\r")
        pos = end + 1
        if not line or line.startswith(b"#"):
            continue
        key, _, value = line.partition(b" ")
        key = key.upper()
        if key == b"ENDHDR":
            return fields, pos
        if key not in (b"WIDTH", b"HEIGHT", b"DEPTH", b"MAXVAL",
                       b"TUPLTYPE"):
            raise _Bad
        if key != b"TUPLTYPE" and key in fields:
            raise _Bad
        fields[key] = value.strip()


def _pam(data: bytes, gray: bool) -> np.ndarray:
    fields, pos = _pam_header(data)
    try:
        w, h = int(fields[b"WIDTH"]), int(fields[b"HEIGHT"])
        depth, maxval = int(fields[b"DEPTH"]), int(fields[b"MAXVAL"])
    except (KeyError, ValueError) as e:
        raise _Bad from e
    if maxval > 65535 or not 1 <= depth <= 4 or w <= 0 or h <= 0:
        raise _Bad
    if b"TUPLTYPE" in fields:
        tupl = fields[b"TUPLTYPE"].upper()
        if _TUPLTYPES.get(tupl) != depth:
            raise _Bad
        bw = tupl == b"BLACKANDWHITE" or maxval == 1
    elif depth in (1, 3) and maxval < 256:
        bw = depth == 1 and maxval == 1
    else:
        raise _Bad
    coders.check_image_size(w, h, "PAM")
    if bw:  # OpenCV reads a row's bytes as packed bits, 1 white
        if pos + w * h > len(data):
            raise _Bad
        rows = np.frombuffer(data, np.uint8, w * h, pos).reshape(h, w)
        bits = np.unpackbits(rows[:, :(w + 7) // 8], axis=1)[:, :w]
        return (bits * 255).astype(np.uint8)
    wide = maxval > 255
    n = w * h * depth * (2 if wide else 1)
    if pos + n > len(data):
        raise _Bad
    px = np.frombuffer(data, np.uint8, n, pos)
    px = (px.view(">u2").astype(np.uint16) if wide else px).reshape(
        h, w, depth)
    if not gray:
        return np.ascontiguousarray(px if depth > 1 else px[..., 0])
    if wide:
        px = (px >> 8).astype(np.uint8)
    if depth == 1:
        return np.ascontiguousarray(px[..., 0])
    if depth == 3:
        return coders.bgr_to_gray(px, rgb=True)
    if depth == 4:
        raise ValueError("PAM RGB_ALPHA under IMREAD_GRAYSCALE: OpenCV "
                         "leaves part of each row unwritten")
    # grey + alpha: OpenCV writes each pixel's first sample three times
    # into the grey row
    return np.ascontiguousarray(px[:, np.arange(w) // 3, 0])


def _pfm(data: bytes, gray: bool) -> np.ndarray:
    colour = data[1:2] == b"F"
    if data[2:3] != b"\n":
        raise _Bad
    pos = 3

    def token():
        nonlocal pos
        start = pos
        while pos < len(data) and data[pos] not in _SPACE:
            if data[pos] >= 128:
                raise _Bad
            pos += 1
        if pos >= len(data):
            raise _Bad
        tok = data[start:pos]
        pos += 1
        return tok.decode()

    try:
        w, h, scale = int(token()), int(token()), float(token())
    except ValueError as e:
        raise _Bad from e
    if w <= 0 or h <= 0 or scale == 0:
        raise _Bad
    coders.check_image_size(w, h, "PFM")
    c = 3 if colour else 1
    n = w * h * c * 4
    if pos + n > len(data):
        raise _Bad
    px = np.frombuffer(data, "<f4" if scale < 0 else ">f4", w * h * c,
                       pos).astype(np.float32).reshape(h, w, c)[::-1]
    if colour:
        px = px[..., ::-1]
    px = px * np.float32(1.0 / abs(scale))
    if gray:
        out = coders.saturate_u8(px)
        return np.ascontiguousarray(out[..., 0] if c == 1 else out)
    return np.ascontiguousarray(px[..., 0] if c == 1 else px)


def _guard(fn, data: bytes, gray: bool) -> Optional[np.ndarray]:
    try:
        return fn(bytes(data), gray)
    except _Bad:
        return None


def decode_pxm(data: bytes, gray: bool) -> Optional[np.ndarray]:
    """P1-P6 bytes -> ``cv2.imdecode``'s array; None where cv2 gives
    None."""
    return _guard(_pxm, data, gray)


def decode_pam(data: bytes, gray: bool) -> Optional[np.ndarray]:
    """P7 bytes -> ``cv2.imdecode``'s array; None where cv2 gives None."""
    return _guard(_pam, data, gray)


def decode_pfm(data: bytes, gray: bool,
               file: bool = False) -> Optional[np.ndarray]:
    """PFM bytes -> ``cv2.imdecode``'s array (``file``: ``cv2.imread``'s,
    which is None for a colour PFM under the grey flag: its buffer check
    fails on the three channels); None where cv2 gives None."""
    if file and gray and bytes(data[:2]) == b"PF":
        return None
    return _guard(_pfm, data, gray)


def encode_pgm(img: np.ndarray) -> bytes:
    """(H, W) uint8 -> binary PGM (P5, maxval 255) bytes."""
    img = np.ascontiguousarray(img)
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"encode_pgm writes (H, W) uint8, got {img.shape} "
                         f"{img.dtype}")
    return b"P5\n%d %d\n255\n" % (img.shape[1], img.shape[0]) + img.tobytes()
