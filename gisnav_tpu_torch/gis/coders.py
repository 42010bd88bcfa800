"""The byte coders of ``native/imgcodecs.cpp`` bound with ``ctypes``, and
OpenCV's fixed-point colour conversions that its decoders share.

The C++ library is built at first use (``native/__init__.py``
``build_native_lib("imgcodecs")``). Each decoder here returns a uint8 array
of the size asked for and raises ``ValueError`` naming the coder on a
corrupt stream or one that ends early (``bmp_rle`` and ``hdr_rle`` give
None there: OpenCV gives None for those files).

``ccitt`` decodes one strip or tile of a CCITT-coded TIFF (RLE, RLEW,
Group 3 and Group 4) with ``native/fax3.cpp`` (``build_native_lib("fax3")``)
as libtiff's ``tif_fax3.c`` does, damage included: it never raises.

``bgr_to_gray`` is OpenCV's ``icvCvt_BGR2Gray_8u_C3C1R`` (``utils.cpp``:
4899 R + 9617 G + 1868 B over 2^14, rounded), which the BMP, PxM, Sun
raster and TIFF decoders apply under ``IMREAD_GRAYSCALE``; it is not
``cv2.cvtColor``'s grey (``gis/png.py`` ``to_gray``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np

from gisnav_tpu_torch.native import build_native_lib

__all__ = ["tiff_lzw", "packbits", "ccitt", "ccitt_runs", "gif_lzw", "bmp_rle", "hdr_rle",
           "predictor2", "predictor3", "bgr_to_gray", "saturate_u8",
           "IMREAD_UNCHANGED", "IMREAD_GRAYSCALE"]

IMREAD_UNCHANGED = -1  # cv2's flag values
IMREAD_GRAYSCALE = 0
_CORRUPT, _SHORT = -1, -2
_CR, _CG, _CB = 4899, 9617, 1868  # 0.299, 0.587 and the rest of 2^14


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_native_lib("imgcodecs"))
    u8p, u64, i32 = ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int
    out = ctypes.c_void_p
    for name, args in (("gic_tiff_lzw", [u8p, u64, out, u64]),
                       ("gic_packbits", [u8p, u64, out, u64]),
                       ("gic_gif_lzw", [u8p, u64, i32, out, u64]),
                       ("gic_bmp_rle", [u8p, u64, i32, i32, i32, out]),
                       ("gic_hdr_rle", [u8p, u64, i32, i32, out])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_int64, args
    for name in ("gic_predictor2", "gic_predictor3"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [out, u64, u64, i32, i32]
    return lib


@functools.lru_cache(maxsize=None)
def _fax_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_native_lib("fax3"))
    i32, i64 = ctypes.c_int, ctypes.c_int64
    lib.gfax_decode.restype = i32
    lib.gfax_decode.argtypes = [i32, i32, ctypes.c_char_p, ctypes.c_uint64,
                                i32, ctypes.c_void_p, i64, i64, i32,
                                ctypes.c_void_p, ctypes.c_uint32]
    return lib


def _run(what: str, fn, data: bytes, size: int, *args) -> np.ndarray:
    out = np.zeros(size, np.uint8)
    n = fn(bytes(data), len(data), *args, out.ctypes.data, size)
    if n == _CORRUPT:
        raise ValueError(f"{what}: corrupt stream")
    if n == _SHORT:
        raise ValueError(f"{what}: the stream ends before its data")
    return out


def tiff_lzw(data: bytes, size: int) -> np.ndarray:
    """TIFF LZW (new-style or old-style, as libtiff tells them) -> ``size``
    bytes."""
    return _run("TIFF LZW", _lib().gic_tiff_lzw, data, size)


def packbits(data: bytes, size: int) -> np.ndarray:
    """PackBits -> ``size`` bytes."""
    return _run("PackBits", _lib().gic_packbits, data, size)


def ccitt_runs(rowpixels: int, two_d: bool) -> np.ndarray:
    """The run arrays libtiff's CCITT codec allocates for rows of
    ``rowpixels`` (``Fax3SetupState``: the row's width plus one rounded up
    to 32, twice that for a reference line, and twice again) and Group 3's
    no-EOL flag, zeroed: the codec state that lasts from strip to strip."""
    nruns = (rowpixels + 1 + 31) // 32 * 32 * (2 if two_d else 1)
    return np.zeros(2 * nruns + 1, np.uint32)


def ccitt(data: bytes, scheme: int, two_d: bool, odd_start: bool,
          rows: int, rowbytes: int, rowpixels: int,
          runs: np.ndarray) -> np.ndarray:
    """One strip or tile of CCITT ``scheme`` (2 RLE, 32771 RLEW, 3 Group 3,
    4 Group 4; ``two_d``: Group 3's 2-D coding, T4Options bit 0) from
    MSB-first ``data`` -> (rows, rowbytes) packed 1-bit rows, 1 for black;
    where the stream is damaged or ends early, what libtiff's decoder left
    (zero bits past it). ``odd_start``: the data lies at an odd address,
    which RLEW's word alignment reads; ``runs``: ``ccitt_runs``' array,
    carried from strip to strip."""
    if rowbytes * 8 < rowpixels or runs.dtype != np.uint32 or \
            not runs.flags.c_contiguous or len(runs) < 2 * rowpixels + 3:
        raise ValueError("CCITT: rows narrower than their pixels, or not "
                         "ccitt_runs' array")
    out = np.zeros((rows, rowbytes), np.uint8)
    _fax_lib().gfax_decode(scheme, int(two_d), bytes(data), len(data),
                           int(odd_start), out.ctypes.data, out.size,
                           rowbytes, rowpixels, runs.ctypes.data,
                           (len(runs) - 1) // 2)
    return out


def gif_lzw(data: bytes, min_code_size: int, size: int) -> np.ndarray:
    """A GIF image's LZW data (sub-blocks joined) -> ``size`` indices."""
    return _run("GIF LZW", _lib().gic_gif_lzw, data, size, min_code_size)


def bmp_rle(data: bytes, rle4: bool, width: int, height: int
            ) -> Optional[np.ndarray]:
    """BMP RLE4 / RLE8 -> (height, width) palette indices, the file's first
    row first, as OpenCV fills them (index 0 where a delta, end of line or
    end of bitmap skips); None where OpenCV gives up (a run past its row's
    end, a stream ending before the bitmap does)."""
    out = np.zeros((height, width), np.uint8)
    n = _lib().gic_bmp_rle(bytes(data), len(data), int(rle4), width, height,
                           out.ctypes.data)
    return None if n < 0 else out


def hdr_rle(data: bytes, width: int, height: int) -> Optional[np.ndarray]:
    """Radiance pixel data -> (height, width, 4) RGBE bytes; None where the
    data ends early or a scanline is corrupt (OpenCV gives None)."""
    out = np.zeros((height, width, 4), np.uint8)
    n = _lib().gic_hdr_rle(bytes(data), len(data), width, height,
                           out.ctypes.data)
    return None if n < 0 else out


def predictor2(samples: np.ndarray, stride: int) -> np.ndarray:
    """TIFF predictor 2 undone in place on (rows, row samples) native-order
    integer samples, ``stride`` samples per pixel."""
    samples = np.ascontiguousarray(samples)
    rows, n = samples.shape
    if _lib().gic_predictor2(samples.ctypes.data, rows, n, stride,
                             samples.dtype.itemsize):
        raise ValueError(f"TIFF predictor 2 on {samples.dtype} samples")
    return samples


def predictor3(rows: np.ndarray, stride: int, size: int) -> np.ndarray:
    """TIFF predictor 3 undone on (rows, row bytes) uint8: -> the same bytes
    as little-endian samples of ``size`` bytes."""
    rows = np.ascontiguousarray(rows, np.uint8)
    if _lib().gic_predictor3(rows.ctypes.data, rows.shape[0], rows.shape[1],
                             stride, size):
        raise ValueError("TIFF predictor 3: a row is not whole samples")
    return rows


def bgr_to_gray(img: np.ndarray, rgb: bool = False) -> np.ndarray:
    """(..., 3 or more) uint8 B, G, R (``rgb``: R, G, B) -> OpenCV's
    ``icvCvt_BGR2Gray_8u``, (...) uint8."""
    c = img[..., :3].astype(np.int32)
    b, r = (c[..., 2], c[..., 0]) if rgb else (c[..., 0], c[..., 2])
    return ((b * _CB + c[..., 1] * _CG + r * _CR + (1 << 13)) >> 14
            ).astype(np.uint8)


def saturate_u8(x: np.ndarray) -> np.ndarray:
    """float32 -> uint8 as OpenCV's ``saturate_cast<uchar>``: rounded half
    to even, clamped to 0-255; NaN and values out of int32's range (which
    ``cvRound`` turns into INT_MIN) give 0."""
    r = np.rint(x.astype(np.float32))
    bad = ~(np.abs(r) < np.float32(2 ** 31))
    return np.where(bad, 0, np.clip(np.nan_to_num(r), 0, 255)).astype(
        np.uint8)
