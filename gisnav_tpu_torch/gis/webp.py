"""WebP decoding as OpenCV does it (no OpenCV, no libwebp).

The JAX package reads WMS replies and replay files with ``cv2.imdecode`` /
``cv2.imread``, which read WebP through libwebp. The card machine has
neither, so the port carries a decoder of its own (``native/webp.cpp``:
VP8L, VP8, ALPH, VP8X and the first frame of an animation, libwebp's
arithmetic; built at first use with the host C++ compiler and bound here
with ``ctypes``):

- ``is_webp(head)`` is OpenCV's signature test: libwebp's
  ``WebPGetFeatures`` accepts the first 32 bytes (a RIFF ``WEBP`` file, or
  a raw VP8 or VP8L bitstream).
- ``decode_webp(data, gray)`` equals ``cv2.imdecode``: BGR (H, W, 3), or
  BGRA (H, W, 4) where the header says the image has alpha (the VP8X alpha
  flag, or the VP8L header's alpha bit), not premultiplied; an animation
  gives its first frame on a transparent black canvas. Under
  ``IMREAD_GRAYSCALE`` the grey is ``cv2.cvtColor``'s of the decoded BGR,
  turned upright by the first EXIF chunk's orientation, which OpenCV's
  demuxer keeps only when the VP8X EXIF flag is set (the chunk is a bare
  TIFF body). Bytes cv2 gives None for give None.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np

from gisnav_tpu_torch.gis.coders import check_image_size
from gisnav_tpu_torch.gis.exif import apply_orientation, orientation
from gisnav_tpu_torch.gis.png import to_gray
from gisnav_tpu_torch.native import build_native_lib

__all__ = ["is_webp", "decode_webp", "webp_features", "HEADER_SIZE"]

HEADER_SIZE = 32  # OpenCV's WEBP_HEADER_SIZE: the bytes its test reads
_MSG_LEN = 256


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The loaded decoder, its C entry points typed."""
    lib = ctypes.CDLL(build_native_lib("webp"))
    ip, u64 = ctypes.POINTER(ctypes.c_int), ctypes.c_uint64
    lib.gwebp_features.restype = ctypes.c_int
    lib.gwebp_features.argtypes = [ctypes.c_char_p, u64, ip]
    lib.gwebp_decode.restype = ctypes.c_void_p
    lib.gwebp_decode.argtypes = [ctypes.c_char_p, u64, ip,
                                 ctypes.POINTER(u64), ip, ctypes.c_char_p,
                                 ctypes.c_int]
    lib.gwebp_free.restype = None
    lib.gwebp_free.argtypes = [ctypes.c_void_p]
    return lib


def webp_features(data: bytes) -> Optional[dict]:
    """libwebp's ``WebPGetFeatures`` on ``data``: width, height, has_alpha
    and has_animation, or None where it fails."""
    info = (ctypes.c_int * 4)()
    if _lib().gwebp_features(bytes(data), len(data), info) != 0:
        return None
    return dict(zip(("width", "height", "has_alpha", "has_animation"),
                    info))


def is_webp(head: bytes) -> bool:
    """OpenCV's WebP signature test on a file's first bytes. libwebp
    accepts nothing that starts otherwise than ``RIFF``, ``ALPH``, ``VP8 ``,
    ``VP8L``, a VP8L signature byte or a VP8 start code at byte 3, so other
    formats' files are told apart without the decoder's library."""
    head = bytes(head[:HEADER_SIZE])
    if len(head) < HEADER_SIZE or not (
            head[:4] in (b"RIFF", b"ALPH", b"VP8 ", b"VP8L")
            or head[0] == 0x2f or head[3:6] == b"\x9d\x01\x2a"):
        return False
    return webp_features(head) is not None


def decode_webp(data: bytes, gray: bool = False) -> Optional[np.ndarray]:
    """WebP bytes -> ``cv2.imdecode(data, IMREAD_UNCHANGED)`` (``gray``:
    ``IMREAD_GRAYSCALE``); None where cv2 gives None."""
    data = bytes(data)
    # OpenCV's readHeader: WebPGetFeatures on the first 32 bytes (an
    # animation's header is the demuxer's, which refuses what this passes)
    features = webp_features(data[:HEADER_SIZE])
    if features is not None and not features["has_animation"]:
        check_image_size(features["width"], features["height"], "WebP")
    lib = _lib()
    info = (ctypes.c_int * 4)()
    exif = (ctypes.c_uint64 * 2)()
    status = ctypes.c_int()
    msg = ctypes.create_string_buffer(_MSG_LEN)
    ptr = lib.gwebp_decode(data, len(data), info, exif, ctypes.byref(status),
                           msg, _MSG_LEN)
    if not ptr:
        return None
    w, h, alpha = info[0], info[1], info[2]
    bgra = np.empty((h, w, 4), np.uint8)
    try:
        ctypes.memmove(bgra.ctypes.data, ptr, bgra.nbytes)
    finally:
        lib.gwebp_free(ptr)
    if not gray:
        return bgra if alpha else np.ascontiguousarray(bgra[..., :3])
    img = to_gray(bgra[..., 2::-1])
    if exif[1]:
        img = apply_orientation(img, orientation(data[exif[0]:exif[0]
                                                      + exif[1]]))
    return np.ascontiguousarray(img)
