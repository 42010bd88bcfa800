"""JPEG decoding and encoding as OpenCV does them, and format detection.

The JAX package reads WMS replies and replay files with ``cv2.imdecode`` /
``cv2.imread`` and writes GetMap replies with ``cv2.imencode``; the card
machine has no OpenCV, so the port carries a JPEG codec of its own
(``native/jpeg.cpp``, built at first use with the host C++ compiler and
bound here with ``ctypes``). It follows libjpeg-turbo's integer arithmetic
at OpenCV's defaults:

- ``decode_jpeg(data)`` equals ``cv2.imdecode(data, cv2.IMREAD_UNCHANGED)``
  (grey (H, W) or BGR (H, W, 3) uint8) for sequential and progressive
  Huffman files of 1, 3 or 4 components; ``grayscale=True`` equals
  ``cv2.IMREAD_GRAYSCALE`` but for the EXIF turn (``decode_image`` makes
  it): libjpeg's grey output, the Y plane of a YCbCr file (not ``to_gray``
  of the colour decode). A CMYK or YCCK file goes through OpenCV's own
  CMYK-to-BGR and CMYK-to-grey conversions. Bytes that cv2 cannot decode
  (truncated, garbage) give None, as ``cv2.imdecode`` does; arithmetic-coded,
  lossless, hierarchical and 12-bit files, and a progressive file cut
  short whose unknown coefficients libjpeg-turbo would block-smooth, raise
  ``ValueError`` naming the variant.
- ``encode_jpeg(img, quality=95)`` equals ``cv2.imencode(".jpg", img)``
  byte for byte for grey and BGR uint8 images (4:2:0 for colour).
- ``decode_image(data, flag)`` chooses PNG (``gis/png.py``
  ``png_as_opencv``) or JPEG by the magic bytes, as ``cv2.imdecode`` does,
  and returns cv2's array for ``IMREAD_UNCHANGED`` and ``IMREAD_GRAYSCALE``:
  under the grey flag the image is turned upright by its EXIF orientation
  (a JPEG's Exif APP1, a PNG's eXIf chunk; ``gis/exif.py``) as OpenCV
  turns it; bytes that are neither format give None. ``read_image(path,
  flag)`` is ``cv2.imread``: the same, but a JPEG file cut short reads as
  libjpeg's stdio source reads it (an EOI marker after its last byte: grey,
  or block-smoothed coefficients, past the cut), where ``cv2.imdecode``
  gives None.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np

from gisnav_tpu_torch.gis.exif import apply_orientation, orientation
from gisnav_tpu_torch.gis.png import PNG_SIGNATURE, png_as_opencv
from gisnav_tpu_torch.native import build_native_lib

__all__ = ["decode_jpeg", "encode_jpeg", "decode_image", "read_image",
           "JPEG_SOI", "IMREAD_UNCHANGED", "IMREAD_GRAYSCALE"]

JPEG_SOI = b"\xff\xd8"
IMREAD_UNCHANGED = -1  # cv2's flag values
IMREAD_GRAYSCALE = 0
_MODE_UNCHANGED, _MODE_GRAY = 0, 1  # jpeg.cpp gjpeg_decode modes
_MSG_LEN = 256


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The loaded codec, its C entry points typed."""
    lib = ctypes.CDLL(build_native_lib("jpeg"))
    u8p, ip = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int)
    u64 = ctypes.c_uint64
    lib.gjpeg_decode.restype = ctypes.c_void_p
    lib.gjpeg_decode.argtypes = [ctypes.c_char_p, u64, ctypes.c_int,
                                 ctypes.c_int, ip, ip, ip,
                                 ctypes.POINTER(u64), ip, ctypes.c_char_p,
                                 ctypes.c_int]
    lib.gjpeg_encode.restype = ctypes.c_void_p
    lib.gjpeg_encode.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int,
                                 ctypes.POINTER(u64), ctypes.c_char_p,
                                 ctypes.c_int]
    lib.gjpeg_free.restype = None
    lib.gjpeg_free.argtypes = [ctypes.c_void_p]
    return lib


def _take(lib: ctypes.CDLL, ptr: int, shape) -> np.ndarray:
    """Copy a malloc'd buffer into a new array and free it."""
    out = np.empty(shape, np.uint8)
    try:
        ctypes.memmove(out.ctypes.data, ptr, out.nbytes)
    finally:
        lib.gjpeg_free(ptr)
    return out


def _decode(data: bytes, grayscale: bool, file: bool = False):
    """(image or None, the Exif APP1's TIFF body or b""); ``file``: read
    as ``cv2.imread`` reads a file (its end is a fake EOI marker)."""
    lib = _lib()
    h, w, c, status = (ctypes.c_int() for _ in range(4))
    exif = (ctypes.c_uint64 * 2)()
    msg = ctypes.create_string_buffer(_MSG_LEN)
    ptr = lib.gjpeg_decode(data, len(data),
                           _MODE_GRAY if grayscale else _MODE_UNCHANGED,
                           int(file), ctypes.byref(h), ctypes.byref(w),
                           ctypes.byref(c), exif, ctypes.byref(status), msg,
                           _MSG_LEN)
    if status.value == 2:
        raise ValueError(msg.value.decode())
    if not ptr:
        return None, b""
    shape = (h.value, w.value) if c.value == 1 else (h.value, w.value,
                                                     c.value)
    return _take(lib, ptr, shape), data[exif[0]:exif[0] + exif[1]]


def decode_jpeg(data: bytes, grayscale: bool = False) -> Optional[np.ndarray]:
    """JPEG bytes -> (H, W) grey or (H, W, 3) BGR uint8, as
    ``cv2.imdecode`` with ``IMREAD_UNCHANGED`` (or ``IMREAD_GRAYSCALE``,
    the EXIF orientation not applied); None where cv2 gives None."""
    return _decode(bytes(data), grayscale)[0]


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """(H, W) grey or (H, W, 3) BGR uint8 -> JPEG bytes, equal to
    ``cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])``."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_jpeg writes uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode_jpeg takes (H, W) or (H, W, 3), got "
                         f"{img.shape}")
    lib = _lib()
    size = ctypes.c_uint64()
    msg = ctypes.create_string_buffer(_MSG_LEN)
    h, w = img.shape[:2]
    ptr = lib.gjpeg_encode(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        1 if img.ndim == 2 else 3, int(np.clip(quality, 0, 100)),
        ctypes.byref(size), msg, _MSG_LEN)
    if not ptr:
        raise ValueError(f"JPEG encode failed: {msg.value.decode()}")
    return _take(lib, ptr, (size.value,)).tobytes()


def _decode_image(data: bytes, flag: int,
                  file: bool) -> Optional[np.ndarray]:
    if flag not in (IMREAD_UNCHANGED, IMREAD_GRAYSCALE):
        raise ValueError(f"decode_image flag {flag}: IMREAD_UNCHANGED (-1) "
                         "or IMREAD_GRAYSCALE (0)")
    gray = flag == IMREAD_GRAYSCALE
    if data.startswith(PNG_SIGNATURE):
        return png_as_opencv(data, gray)
    if not data.startswith(JPEG_SOI):
        return None
    img, exif = _decode(data, gray, file)
    if img is None or not gray or not exif:
        return img
    return apply_orientation(img, orientation(exif))


def decode_image(data: bytes,
                 flag: int = IMREAD_UNCHANGED) -> Optional[np.ndarray]:
    """PNG or JPEG bytes, chosen by content as ``cv2.imdecode`` chooses ->
    ``cv2.imdecode(data, flag)``'s array (grey (H, W), colour BGR(A); under
    ``IMREAD_GRAYSCALE`` turned upright by the EXIF orientation); None for
    bytes of neither format or a JPEG cv2 cannot decode."""
    return _decode_image(bytes(data), flag, file=False)


def read_image(path: str, flag: int = IMREAD_UNCHANGED
               ) -> Optional[np.ndarray]:
    """``cv2.imread(path, flag)`` for PNG and JPEG files, chosen by
    content: as ``decode_image``, but a JPEG file cut short reads as if an
    EOI marker followed its last byte (libjpeg's stdio source; cv2 warns on
    stderr)."""
    with open(path, "rb") as f:
        return _decode_image(f.read(), flag, file=True)
