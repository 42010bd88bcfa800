"""JPEG decoding and encoding as OpenCV does them.

The JAX package reads WMS replies and replay files with ``cv2.imdecode`` /
``cv2.imread`` and writes GetMap replies with ``cv2.imencode``; the card
machine has no OpenCV, so the port carries a JPEG codec of its own
(``native/jpeg.cpp``, built at first use with the host C++ compiler and
bound here with ``ctypes``). It follows libjpeg-turbo's integer arithmetic
at OpenCV's defaults:

- ``decode_jpeg(data)`` equals ``cv2.imdecode(data, cv2.IMREAD_UNCHANGED)``
  (grey (H, W) or BGR (H, W, 3) uint8) for sequential and progressive
  files, Huffman- or arithmetic-coded, and lossless files of 2 to 8 bits
  (their samples as they are, a 4-bit file 0-15), of 1, 3 or 4
  components; ``grayscale=True`` equals ``cv2.IMREAD_GRAYSCALE`` but for
  the EXIF turn (``decode_image`` makes it): libjpeg's grey output, the Y
  plane of a YCbCr file (not ``to_gray`` of the colour decode). A CMYK or
  YCCK file goes through OpenCV's own CMYK-to-BGR and CMYK-to-grey
  conversions. Bytes that cv2 cannot decode (truncated, garbage, a
  lossless file that would need a colour conversion: YCbCr, or RGB under
  the grey flag) give None, as ``cv2.imdecode`` does, and so do the
  variants cv2 5.0's libjpeg-turbo refuses: lossless arithmetic-coded
  (SOF11), hierarchical, 12-bit and 9- to 16-bit lossless files
  (``jpeg_variant`` names them).
- ``encode_jpeg(img, quality=95)`` equals ``cv2.imencode(".jpg", img)``
  byte for byte for grey and BGR uint8 images (4:2:0 for colour).
- ``decode_image(data, flag)`` and ``read_image(path, flag)`` are
  ``gis/imgcodecs.py``'s (``cv2.imdecode`` / ``cv2.imread`` of every format
  the port reads, JPEG among them: under ``IMREAD_GRAYSCALE`` turned
  upright by the Exif APP1's orientation; a JPEG file cut short reads as
  libjpeg's stdio source reads it, an EOI marker after its last byte),
  re-exported here.
- ``decode_jpeg_for_tiff`` decodes a TIFF strip's JPEG stream as libtiff's
  JPEG codec asks libjpeg to (``gis/tiff.py``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np

from gisnav_tpu_torch.gis.coders import (IMREAD_GRAYSCALE, IMREAD_UNCHANGED,
                                         check_image_size)
from gisnav_tpu_torch.native import build_native_lib

__all__ = ["decode_jpeg", "encode_jpeg", "decode_jpeg_for_tiff",
           "jpeg_variant",
           "decode_image", "read_image",
           "JPEG_SOI", "IMREAD_UNCHANGED", "IMREAD_GRAYSCALE"]

JPEG_SOI = b"\xff\xd8"
# jpeg.cpp gjpeg_decode modes (_MODE_BGR: cv2.IMREAD_COLOR's pixels)
_MODE_UNCHANGED, _MODE_GRAY, _MODE_BGR, _MODE_RAW, _MODE_YCBCR = 0, 1, 2, 3, 4
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


def _decode(data: bytes, grayscale: bool, file: bool = False,
            mode: Optional[int] = None):
    """(image or None, the Exif APP1's TIFF body or b""); ``file``: read
    as ``cv2.imread`` reads a file (its end is a fake EOI marker); ``mode``
    one of jpeg.cpp's modes in place of ``grayscale``'s (a TIFF strip's:
    no cv2 size check, a header over it gives None)."""
    lib = _lib()
    h, w, c, status = (ctypes.c_int() for _ in range(4))
    exif = (ctypes.c_uint64 * 2)()
    msg = ctypes.create_string_buffer(_MSG_LEN)
    if mode is None:
        mode = _MODE_GRAY if grayscale else _MODE_UNCHANGED
    ptr = lib.gjpeg_decode(data, len(data), mode,
                           int(file), ctypes.byref(h), ctypes.byref(w),
                           ctypes.byref(c), exif, ctypes.byref(status), msg,
                           _MSG_LEN)
    if not ptr:  # status 2: a variant libjpeg-turbo refuses, None in cv2
        if status.value == 3 and mode in (_MODE_UNCHANGED, _MODE_GRAY,
                                          _MODE_BGR):
            check_image_size(w.value, h.value, "JPEG")  # cv2.error
        return None, b""
    shape = (h.value, w.value) if c.value == 1 else (h.value, w.value,
                                                     c.value)
    return _take(lib, ptr, shape), data[exif[0]:exif[0] + exif[1]]


def jpeg_variant(data: bytes) -> Optional[str]:
    """The name of the variant in ``data`` that cv2 5.0's libjpeg-turbo
    does not read (its decode gives None), or None."""
    lib = _lib()
    h, w, c, status = (ctypes.c_int() for _ in range(4))
    exif = (ctypes.c_uint64 * 2)()
    msg = ctypes.create_string_buffer(_MSG_LEN)
    ptr = lib.gjpeg_decode(bytes(data), len(data), _MODE_UNCHANGED, 0,
                           ctypes.byref(h), ctypes.byref(w), ctypes.byref(c),
                           exif, ctypes.byref(status), msg, _MSG_LEN)
    lib.gjpeg_free(ptr)
    return msg.value.decode() if status.value == 2 else None


def decode_jpeg(data: bytes, grayscale: bool = False) -> Optional[np.ndarray]:
    """JPEG bytes -> (H, W) grey or (H, W, 3) BGR uint8, as
    ``cv2.imdecode`` with ``IMREAD_UNCHANGED`` (or ``IMREAD_GRAYSCALE``,
    the EXIF orientation not applied); None where cv2 gives None."""
    return _decode(bytes(data), grayscale)[0]


def decode_jpeg_for_tiff(data: bytes, ycbcr: bool) -> Optional[np.ndarray]:
    """A TIFF strip's or tile's JPEG stream as libtiff's JPEG codec decodes
    it for ``TIFFReadRGBA*``: ``ycbcr``: YCbCr to RGB whatever the markers
    say (``JPEGCOLORMODE_RGB``), (H, W, 3) RGB; else the components as they
    are (``JCS_UNKNOWN``), (H, W, C)."""
    img = _decode(bytes(data), False, mode=_MODE_YCBCR if ycbcr
                  else _MODE_RAW)[0]
    if img is None or not ycbcr:
        return img
    return np.ascontiguousarray(img[..., ::-1])


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


def decode_image(data: bytes,
                 flag: int = IMREAD_UNCHANGED) -> Optional[np.ndarray]:
    """``gis/imgcodecs.py`` ``decode_image`` (``cv2.imdecode`` of every
    format the port reads), kept here for its callers."""
    from gisnav_tpu_torch.gis.imgcodecs import decode_image as decode

    return decode(data, flag)


def read_image(path: str, flag: int = IMREAD_UNCHANGED
               ) -> Optional[np.ndarray]:
    """``gis/imgcodecs.py`` ``read_image`` (``cv2.imread``)."""
    from gisnav_tpu_torch.gis.imgcodecs import read_image as read

    return read(path, flag)
