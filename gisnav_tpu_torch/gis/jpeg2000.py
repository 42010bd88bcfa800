"""JPEG 2000 decoding as OpenCV does it (no OpenCV, no OpenJPEG).

The JAX package reads WMS replies and replay files with ``cv2.imdecode`` /
``cv2.imread``, which read JP2 files and raw J2K codestreams through
OpenJPEG 2.5 (OpenCV's ``Jpeg2KOpjDecoder``). The card machine has
neither, so the port carries a decoder of its own (``native/jpeg2000.cpp``:
OpenJPEG's codestream decoding and JP2 layer, built at first use with the
host C++ compiler and bound here with ``ctypes``). This module applies
OpenCV 5.0's ``readHeader`` / ``readData`` rules to the components the
library returns; each rule below was read off cv2 on the fixture named
(``tests/test_torch_jpeg2000*.py`` holds them all):

- Size: ``loadsave.cpp``'s limits (2^20 columns and rows, 2^30 pixels);
  None past them, before any decoding.
- Header (the codestream's components, before any JP2 palette): 1 to 4
  components, none signed (Pillow's ``signed=True`` file: None), the
  highest precision at least 8 (a ``SIZ`` patched to 4 or 7 bits: None).
  It sets the depth: 8 bits give ``uint8``, 9-16 ``uint16``, more a float
  depth that ``readData`` refuses (None under ``IMREAD_UNCHANGED``);
  ``IMREAD_GRAYSCALE`` asks for one ``uint8`` channel whatever the header.
- Two channels asked for (a grey + alpha ``LA`` file under
  ``IMREAD_UNCHANGED``): None.
- Colour space: JP2 ``colr`` enumerated 16 (sRGB), 17 (grey) or 18 (sYCC);
  anything else, an ICC profile and a raw codestream are "unknown, sRGB
  assumed"; CMYK (12) and e-sYCC (24): None.
- Every component after decoding (and after the palette) at full size with
  origin 0: a sub-sampled component or an image offset (``SIZ`` patched):
  None.
- Values: each sample shifted right by the highest header precision less
  the output depth (a 12-bit DEM under ``IMREAD_GRAYSCALE``: ``v >> 4``;
  under ``IMREAD_UNCHANGED`` the 16-bit depth keeps it: ``uint16`` as
  coded).
- sRGB: BGR(A) from components (2, 1, 0[, 3]); one or two components to
  three channels repeat component 0; three or more to one channel is
  ``cv2.cvtColor``'s grey of the shifted BGR (Pillow's ``RGB`` file under
  ``IMREAD_GRAYSCALE``).
- Grey: component 0, repeated where three channels are asked.
- sYCC (Pillow's ``YCbCr`` file): component 0 alone for one channel, else
  components (0, 1, 2) shifted and turned by ``cv2.cvtColor``'s
  ``COLOR_YUV2BGR`` (14-bit fixed point).

The library decodes HTJ2K (JPEG 2000 Part 15: CAP and CPF markers, HT
code-blocks with their cleanup, SigProp and MagRef passes) as OpenJPEG
2.5.3's HT block decoder does, its failures included (an RGN shift,
mixed mode, a later layer's passes in the cleanup's segment: None).

``decode_jpeg2000`` returns None wherever cv2 gives None;
``is_jpeg2000`` is OpenCV's signature test;
``last_decode_timing`` reads the library's timer of the calling thread's
last decode (whole call, tier 1, inverse wavelet).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional

import numpy as np

from gisnav_tpu_torch.gis.png import to_gray
from gisnav_tpu_torch.native import build_native_lib

__all__ = ["is_jpeg2000", "decode_jpeg2000", "jpeg2000_header",
           "last_decode_timing", "J2K_SIGNATURE", "JP2_SIGNATURE"]

J2K_SIGNATURE = b"\xff\x4f\xff\x51"
JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
_MSG_LEN = 256
_MAX_COMPS = 16384
# OpenJPEG's opj_image colour spaces
_UNKNOWN, _SRGB, _GRAY, _SYCC = -1, 1, 2, 3


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The loaded decoder, its C entry points typed."""
    lib = ctypes.CDLL(build_native_lib("jpeg2000"))
    ip, u64 = ctypes.POINTER(ctypes.c_int), ctypes.c_uint64
    lib.gj2k_header.restype = ctypes.c_int
    lib.gj2k_header.argtypes = [ctypes.c_char_p, u64, ip, ctypes.c_int,
                                ctypes.c_char_p, ctypes.c_int]
    lib.gj2k_decode.restype = ctypes.c_void_p
    lib.gj2k_decode.argtypes = [ctypes.c_char_p, u64, ip, ctypes.c_int, ip,
                                ctypes.c_char_p, ctypes.c_int]
    lib.gj2k_free.restype = None
    lib.gj2k_free.argtypes = [ctypes.c_void_p]
    lib.gj2k_timing.restype = None
    lib.gj2k_timing.argtypes = [ctypes.POINTER(ctypes.c_double)]
    return lib


def last_decode_timing() -> dict:
    """The calling thread's last decode in the library, in seconds: the
    whole call (``total``), tier 1 (``tier1``: the MQ or HT code-blocks)
    and the inverse wavelet (``wavelet``); read after the decode, off its
    path."""
    out = (ctypes.c_double * 3)()
    _lib().gj2k_timing(out)
    return {"total": out[0], "tier1": out[1], "wavelet": out[2]}


def is_jpeg2000(head: bytes) -> bool:
    """OpenCV's test: a raw codestream's ``SOC SIZ`` or the JP2 signature
    box."""
    return bytes(head[:12]).startswith((J2K_SIGNATURE, JP2_SIGNATURE))


def jpeg2000_header(data: bytes) -> Optional[dict]:
    """``opj_read_header``: the codestream's components (prec, sgnd, dx, dy
    each), the image area and the JP2 colour space, or None where OpenJPEG
    fails."""
    data = bytes(data)
    cap = 6 + 4 * _MAX_COMPS
    info = (ctypes.c_int * cap)()
    msg = ctypes.create_string_buffer(_MSG_LEN)
    status = _lib().gj2k_header(data, len(data), info, cap, msg, _MSG_LEN)
    if status:
        return None
    n = info[0]
    return {"numcomps": n, "colour_space": info[1],
            "area": tuple(info[2:6]),
            "comps": [dict(zip(("prec", "sgnd", "dx", "dy"),
                               info[6 + 4 * c:10 + 4 * c]))
                      for c in range(n)]}


@contextlib.contextmanager
def _components(data: bytes):
    """``opj_decode`` as a context: (colour space, [(component info, int32
    samples)]) or None, the samples viewing the library's buffer, which is
    freed on leaving."""
    lib = _lib()
    cap = 2 + 9 * _MAX_COMPS
    info = (ctypes.c_int * cap)()
    status = ctypes.c_int()
    msg = ctypes.create_string_buffer(_MSG_LEN)
    ptr = lib.gj2k_decode(data, len(data), info, cap, ctypes.byref(status),
                          msg, _MSG_LEN)
    if not ptr:
        yield None
        return
    try:
        comps, off = [], 0
        for c in range(info[0]):
            q = info[2 + 9 * c:11 + 9 * c]
            meta = dict(zip(("w", "h", "x0", "y0", "dx", "dy", "prec", "sgnd",
                             "alpha"), q))
            n = meta["w"] * meta["h"]
            buf = (ctypes.c_int32 * n).from_address(ptr + 4 * off)
            comps.append((meta, np.frombuffer(buf, np.int32).reshape(
                meta["h"], meta["w"])))
            off += n
        yield info[1], comps
    finally:
        lib.gj2k_free(ptr)


def _size_ok(w: int, h: int) -> bool:
    """``loadsave.cpp``'s ``validateInputImageSize``: at most 2^20 columns
    and rows and 2^30 pixels."""
    return 0 < w <= 1 << 20 and 0 < h <= 1 << 20 and w * h <= 1 << 30


def _copy(planes, shift: int, dtype) -> np.ndarray:
    """OpenCV's ``copyToMat``: each sample shifted right, cast to the
    depth (a new array, whatever the planes view)."""
    h, w = planes[0].shape
    out = np.empty((h, w, len(planes)), dtype)
    for k, p in enumerate(planes):
        out[..., k] = (p >> shift) if shift else p
    return out[..., 0] if len(planes) == 1 else out


def _yuv2bgr(yuv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_YUV2BGR)`` on uint8 or uint16."""
    top = np.iinfo(yuv.dtype).max
    half = (top + 1) // 2
    y, u, v = (yuv[..., k].astype(np.int64) for k in range(3))
    u, v = u - half, v - half

    def descale(x):
        return (x + (1 << 13)) >> 14

    b = y + descale(u * 33292)
    g = y + descale(u * -6472 + v * -9519)
    r = y + descale(v * 18678)
    return np.clip(np.stack([b, g, r], axis=-1), 0, top).astype(yuv.dtype)


def decode_jpeg2000(data: bytes, gray: bool = False) -> Optional[np.ndarray]:
    """JP2 or J2K bytes -> ``cv2.imdecode(data, IMREAD_UNCHANGED)``
    (``gray``: ``IMREAD_GRAYSCALE``); None where cv2 gives None."""
    data = bytes(data)
    head = jpeg2000_header(data)
    if head is None:
        return None
    n = head["numcomps"]
    x0, y0, x1, y1 = head["area"]
    if not _size_ok(x1 - x0, y1 - y0):
        return None
    if not 1 <= n <= 4 or any(c["sgnd"] for c in head["comps"]):
        return None
    max_prec = max(c["prec"] for c in head["comps"])
    if max_prec < 8:
        return None
    depth = 8 if max_prec == 8 else 16 if max_prec <= 16 else 32
    channels = n
    if gray:
        depth, channels = 8, 1
    with _components(data) as decoded:
        if decoded is None or channels == 2:
            return None
        return _as_opencv(*decoded, channels, depth, max_prec,
                          (x1 - x0, y1 - y0))


def _as_opencv(space: int, comps: list, channels: int, depth: int,
               max_prec: int, size: tuple) -> Optional[np.ndarray]:
    """``readData``'s checks and its ``decodeSRGBData`` /
    ``decodeGrayscaleData`` / ``decodeSYCCData`` on the decoded
    components."""
    if space not in (_UNKNOWN, _SRGB, _GRAY, _SYCC) or depth == 32:
        return None
    if any((m["dx"], m["dy"], m["x0"], m["y0"], m["w"], m["h"])
           != (1, 1, 0, 0, *size) for m, _ in comps):
        return None
    shift = 0 if depth > max_prec else max_prec - depth
    dtype = np.uint8 if depth == 8 else np.uint16
    planes = [p for _, p in comps]
    k = len(planes)
    if space == _GRAY:
        if channels in (1, 3):
            return _copy([planes[0]] * channels, shift, dtype)
        return None
    if space == _SYCC:
        if channels == 1:
            return _copy(planes[:1], shift, dtype)
        if channels == 3 and k >= 3:
            return _yuv2bgr(_copy(planes[:3], shift, dtype))
        return None
    # sRGB, or unknown taken as sRGB
    if channels == 1:
        if k <= 2:
            return _copy(planes[:1], shift, dtype)
        return to_gray(_copy([planes[0], planes[1], planes[2]], shift,
                             dtype))
    if channels == 3:
        if k <= 2:
            return _copy([planes[0]] * 3, shift, dtype)
        return _copy([planes[2], planes[1], planes[0]], shift, dtype)
    if channels == 4 and k >= 4:
        return _copy([planes[2], planes[1], planes[0], planes[3]], shift,
                     dtype)
    return None
