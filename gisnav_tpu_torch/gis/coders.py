"""The byte coders of ``native/imgcodecs.cpp`` bound with ``ctypes``, and
OpenCV's fixed-point colour conversions that its decoders share.

The C++ library is built at first use (``native/__init__.py``
``build_native_lib("imgcodecs")``). Each decoder here returns a uint8 array
of the size asked for and raises ``ValueError`` naming the coder on a
corrupt stream or one that ends early (``bmp_rle`` and ``hdr_rle`` give
None there: OpenCV gives None for those files). TIFF's strip decoders
(``tiff_lzw``, ``packbits``, ``tiff_inflate`` over the system's zlib,
``thunder``) never raise: they give the buffer libtiff 4.7's decoder
leaves and whether it succeeded.

``ccitt`` decodes one strip or tile of a CCITT-coded TIFF (RLE, RLEW,
Group 3 and Group 4) with ``native/fax3.cpp`` (``build_native_lib("fax3")``)
as libtiff's ``tif_fax3.c`` does, damage included: it never raises.

``check_image_size`` is ``loadsave.cpp``'s ``validateInputImageSize``,
which ``cv2.imdecode`` / ``cv2.imread`` apply to every header a decoder
accepts: ``cv2.error`` there, ``ValueError`` naming the limit here.

``bgr_to_gray`` is OpenCV's ``icvCvt_BGR2Gray_8u_C3C1R`` (``utils.cpp``:
4899 R + 9617 G + 1868 B over 2^14, rounded), which the BMP, PxM, Sun
raster and TIFF decoders apply under ``IMREAD_GRAYSCALE``; it is not
``cv2.cvtColor``'s grey (``gis/png.py`` ``to_gray``).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import zlib
from typing import Optional, Tuple

import numpy as np

from gisnav_tpu_torch.native import build_native_lib

__all__ = ["check_image_size", "tiff_lzw", "packbits", "tiff_inflate",
           "thunder", "ccitt", "ccitt_runs", "gif_lzw", "bmp_rle", "hdr_rle",
           "predictor2", "predictor3", "bgr_to_gray", "saturate_u8",
           "IMREAD_UNCHANGED", "IMREAD_GRAYSCALE"]

IMREAD_UNCHANGED = -1  # cv2's flag values
IMREAD_GRAYSCALE = 0
_CORRUPT, _SHORT = -1, -2
_CR, _CG, _CB = 4899, 9617, 1868  # 0.299, 0.587 and the rest of 2^14
# loadsave.cpp's CV_IO_MAX_IMAGE_WIDTH / _HEIGHT / _PIXELS
MAX_IMAGE_WIDTH = MAX_IMAGE_HEIGHT = 1 << 20
MAX_IMAGE_PIXELS = 1 << 30


def check_image_size(width: int, height: int, fmt: str) -> None:
    """``validateInputImageSize``: cv2 raises ``cv2.error`` for a header
    of no rows or columns, over 2^20 of either or over 2^30 pixels, after
    the decoder accepted it; so does the port, with ``ValueError``."""
    for ok, limit in ((width > 0, "width > 0"),
                      (width <= MAX_IMAGE_WIDTH, "CV_IO_MAX_IMAGE_WIDTH"),
                      (height > 0, "height > 0"),
                      (height <= MAX_IMAGE_HEIGHT, "CV_IO_MAX_IMAGE_HEIGHT"),
                      (width * height <= MAX_IMAGE_PIXELS,
                       "CV_IO_MAX_IMAGE_PIXELS")):
        if not ok:
            raise ValueError(f"{fmt} header of {width}x{height}: over "
                             f"cv2's {limit} (cv2.imdecode raises "
                             "cv2.error there)")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_native_lib("imgcodecs"))
    u8p, u64, i32 = ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int
    out = ctypes.c_void_p
    for name, args in (("gic_tiff_lzw", [u8p, u64, out, u64, i32]),
                       ("gic_packbits", [u8p, u64, out, u64]),
                       ("gic_gif_lzw", [u8p, u64, i32, out, u64]),
                       ("gic_thunder", [u8p, u64, out, u64, u64]),
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


def tiff_lzw(data: bytes, size: int, compat: bool
             ) -> Tuple[np.ndarray, bool]:
    """A TIFF LZW strip as libtiff 4.7 decodes it into a zeroed buffer of
    ``size`` bytes: (the buffer, whether the decoder succeeded). ``compat``
    takes libtiff's old-style decoder (LZWDecodeCompat). A failed strip
    holds what the decoder wrote before its error (the rest zero)."""
    out = np.zeros(size, np.uint8)
    n = _lib().gic_tiff_lzw(bytes(data), len(data), out.ctypes.data, size,
                            int(compat))
    return out, n >= 0


def packbits(data: bytes, size: int) -> Tuple[np.ndarray, bool]:
    """A TIFF PackBits strip as libtiff 4.7 decodes it: (the buffer, whether
    it succeeded); a short strip's rest is zero."""
    out = np.zeros(size, np.uint8)
    n = _lib().gic_packbits(bytes(data), len(data), out.ctypes.data, size)
    return out, n >= 0


def thunder(data: bytes, rows: int, width: int) -> Tuple[np.ndarray, bool]:
    """A ThunderScan strip of ``rows`` rows of ``width`` 4-bit pixels as
    libtiff 4.7 decodes it: (the packed rows, whether it succeeded)."""
    out = np.zeros(rows * ((width + 1) // 2), np.uint8)
    n = _lib().gic_thunder(bytes(data), len(data), out.ctypes.data, rows,
                           width)
    return out, n >= 0


class _ZStream(ctypes.Structure):
    _fields_ = [("next_in", ctypes.c_void_p), ("avail_in", ctypes.c_uint),
                ("total_in", ctypes.c_ulong), ("next_out", ctypes.c_void_p),
                ("avail_out", ctypes.c_uint), ("total_out", ctypes.c_ulong),
                ("msg", ctypes.c_char_p), ("state", ctypes.c_void_p),
                ("zalloc", ctypes.c_void_p), ("zfree", ctypes.c_void_p),
                ("opaque", ctypes.c_void_p), ("data_type", ctypes.c_int),
                ("adler", ctypes.c_ulong), ("reserved", ctypes.c_ulong)]


@functools.lru_cache(maxsize=None)
def _zlib() -> ctypes.CDLL:
    """The system's zlib (the library Python's own ``zlib`` module uses)."""
    lib = ctypes.CDLL(ctypes.util.find_library("z") or "libz.so.1")
    lib.zlibVersion.restype = ctypes.c_char_p
    lib.inflateInit_.argtypes = [ctypes.POINTER(_ZStream), ctypes.c_char_p,
                                 ctypes.c_int]
    lib.inflate.argtypes = [ctypes.POINTER(_ZStream), ctypes.c_int]
    lib.inflateEnd.argtypes = [ctypes.POINTER(_ZStream)]
    return lib


def tiff_inflate(data: bytes, size: int) -> Tuple[np.ndarray, bool]:
    """A TIFF deflate strip as libtiff 4.7's ZIPDecode decodes it with
    zlib: (the buffer, whether it succeeded). zlib writes each symbol as it
    decodes it, so a corrupt stream leaves the bytes before the bad symbol
    (the rest zero, as ZIPDecode zeroes them); a stream that decodes the
    whole buffer but then fails its check value still fails. A stream
    that decodes goes through Python's ``zlib`` (the same library, without
    ctypes' cost of a call); one that fails is decoded again here, to keep
    what zlib wrote before the error."""
    try:
        whole = zlib.decompressobj().decompress(bytes(data), size)
    except zlib.error:
        whole = b""
    if len(whole) == size:
        return np.frombuffer(whole, np.uint8), True
    z = _zlib()
    out = np.zeros(size, np.uint8)
    src = bytes(data)  # zlib reads it in place
    strm = _ZStream()
    if z.inflateInit_(ctypes.byref(strm), z.zlibVersion(),
                      ctypes.sizeof(_ZStream)) != 0:
        raise MemoryError("zlib inflateInit failed")
    try:
        strm.next_in = ctypes.cast(ctypes.c_char_p(src),
                                   ctypes.c_void_p).value
        strm.avail_in = len(data)
        strm.next_out = out.ctypes.data
        strm.avail_out = size
        while strm.avail_out:
            state = z.inflate(ctypes.byref(strm), 1)  # Z_PARTIAL_FLUSH
            if state == 1:  # Z_STREAM_END: short if the buffer is not full
                break
            if state != 0:  # a data error, or no progress (Z_BUF_ERROR)
                return out, False
        return out, strm.avail_out == 0
    finally:
        z.inflateEnd(ctypes.byref(strm))


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
