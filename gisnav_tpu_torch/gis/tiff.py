"""TIFF read as OpenCV 5 reads it (``grfmt_tiff.cpp`` over libtiff 4.7),
with no OpenCV and no libtiff.

GDAL writes DEMs and orthophotos as GeoTIFFs (tiled, deflate, LZW or ZSTD
with a predictor, float32 or int16 heights), and MapServer answers
``image/tiff`` with them; the JAX package reads them with
``cv2.imdecode`` / ``cv2.imread``. ``decode_tiff(data, gray, file)`` gives
the same arrays:

- the container: both byte orders, classic TIFF and BigTIFF, the first
  IFD only (``imread`` reads page 0), strips and tiles (edge tiles
  cropped), ``PlanarConfiguration`` 1 and 2, ``FillOrder`` 2;
- compression none, LZW (new and old style), deflate (8 and 32946),
  PackBits, ThunderScan 4-bit (``native/imgcodecs.cpp`` and the system's
  zlib), JPEG (``native/
  jpeg.cpp``, ``JPEGTables`` spliced in front of each strip's stream,
  separate planes a stream each) and CCITT RLE, RLEW, Group 3 (1-D and
  2-D) and Group 4 (``native/fax3.cpp``: libtiff's decoders, damaged
  streams as libtiff leaves them); predictors 2 (8 to 64-bit integers) and
  3 (floating point) under LZW and deflate only, the codecs that install
  libtiff's predictor (any other compression gives the samples as stored);
- OpenCV's choice of type (``TiffDecoder::readHeader``): 1-bit and 8-bit
  samples as uint8 (int8 where ``SampleFormat`` is signed), 10- to 16-bit
  as uint16 / int16 (10, 12 and 14 bits unpacked MSB first and shifted to
  16, signed ones saturated), 32-bit as float32 / int32 / uint32, 64-bit
  as float64; grey kinds (MinIsWhite, MinIsBlack) as one channel whatever
  their extra samples, others as their sample count (1-4); samples over 8
  bits of a palette, separated or YCbCr image, or of 2 or over 4 samples,
  as 8 bits;
- under ``IMREAD_GRAYSCALE``, and for every 8-bit type, the pixels of
  libtiff's ``TIFFReadRGBA*`` (``tif_getimage.c``: 16-bit grey to its high
  byte, 16-bit colour to (v + 128) / 257, MinIsWhite inverted, palettes
  through ``ColorMap`` (16-bit entries to their high byte), CMYK to RGB as
  (255 - k)(255 - c) / 255, YCbCr through libtiff's tables or libjpeg
  (4x4 strips of an odd number of units a row short of their last bytes,
  as ``TIFFScanlineSize`` rounds), unassociated alpha premultiplied), then
  OpenCV's BGR(A) or its fixed-point grey (``gis/coders.py``
  ``bgr_to_gray``); a type libtiff's RGBA reader refuses (10 to 14, 32 or
  64-bit samples: a float DEM under the grey flag, 2 or 4-bit grey) gives
  None, as cv2 does;
- over 8 bits, under ``IMREAD_UNCHANGED``, the samples as they are, RGB(A)
  turned BGR(A);
- the ``Orientation`` tag, applied under both flags as OpenCV applies it;
  ``read_image`` (``file=True``) gives None for the orientations that
  transpose (5-8) a non-square image, as ``cv2.imread`` does (its check
  that the decoder kept its buffer fails).

- CIELab (photometric 8, 8 or 16 bits) through the RGBA reader's
  ``TIFFCIELab16ToXYZ`` and ``TIFFXYZToRGB`` in float (the file's
  WhitePoint, D50 by default; ``display_sRGB``), 8-bit under both flags
  (int8 for signed a*/b*);
- SGILog (``tif_luv.c``: ``LogL16Decode``, ``LogLuvDecode32`` /
  ``24`` and ``uv_decode``): LogL as 8-bit grey (``L16toGry``) under both
  flags, int8 for SampleFormat 2; LogLuv as RGB bytes (``XYZtoRGB24``)
  under the grey flag and, under ``IMREAD_UNCHANGED``, OpenCV's HDR read:
  float32 XYZ turned by the Orientation tag, then ``COLOR_XYZ2BGR`` with
  its SSE and row-tail float sums; a row short of data zero under the
  RGBA reader, None unchanged.

None, as cv2 gives it, also for every image of a codec cv2 5.0's libtiff is
built without (old-style JPEG, PixarLog, JBIG, LERC, LZMA, ZSTD, WebP: "not
configured"; a ZSTD DEM under the GIS node gives it a zero DEM, as in
JAX), for one its codec's setup refuses (CCITT of other than 1-bit
samples, ThunderScan of other than 4, NeXT, SGILog of a photometric other
than LogL / LogLuv, LogL of other than one sample, LogLuv of other than
three contiguous ones, a predictor LZW or deflate cannot undo), and under
``IMREAD_UNCHANGED`` over 8 bits for a compression libtiff has no codec
for or JPEG of other than 8 bits (their strips do not decode; under the
RGBA reader they read as zero samples, as libtiff leaves its strip
buffer). Still refused with ``ValueError`` naming the variant, where cv2
reads the file: JPEG of a subsampled non-YCbCr image or of separate YCbCr
planes, separate planes over 8 bits under ``IMREAD_UNCHANGED`` (cv2's
pixels there are undefined).

Damaged files read as libtiff 4.7 under OpenCV's ``TiffDecoder`` reads
them. The directory as ``TIFFReadDirectory`` reads it (``_DirReader``): a
read error of the fields that size the image (count, type, value or bytes
past the file) fails it, and a bad value of the others drops the field;
byte counts estimated where libtiff estimates them, one uncompressed
strip cut into 8 KiB strips. A strip whose bytes lie past the file's end
fails the image, as do OpenCV's buffer limits. A strip that does not
decode (libtiff's LZW, deflate, PackBits, ThunderScan decoders, their
partial output and zero fill included) fails the image under the direct
route (``TIFFReadEncodedStrip``, over 8 bits), while the RGBA route (8-bit
output) paints what the decoder left, undone by no predictor; separate
planes after the first may be unreadable there (zeros). A header over
cv2's size limits raises ``ValueError`` (``cv2.error`` in cv2).
"""
from __future__ import annotations

import functools
import math
import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from gisnav_tpu_torch.gis import coders
from gisnav_tpu_torch.gis.jpeg import decode_jpeg_for_tiff

__all__ = ["decode_tiff", "encode_tiff", "TIFF_SIGNATURES"]

TIFF_SIGNATURES = (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+")
# field type -> (numpy kind, size)
_TYPES = {1: ("u", 1), 2: ("u", 1), 3: ("u", 2), 4: ("u", 4), 5: ("r", 4),
          6: ("i", 1), 7: ("u", 1), 8: ("i", 2), 9: ("i", 4), 10: ("s", 4),
          11: ("f", 4), 12: ("f", 8), 13: ("u", 4), 16: ("u", 8),
          17: ("i", 8), 18: ("u", 8)}
# libtiff 4.7's codecs (tif_codec.c); any other compression has none: its
# strips do not decode ("strip decoding is not implemented")
_CODECS = {1: "none", 2: "CCITT RLE", 3: "CCITT fax 3", 4: "CCITT fax 4",
           5: "LZW", 6: "old-style JPEG", 7: "JPEG", 8: "deflate",
           32766: "NeXT", 32771: "CCITT RLEW", 32773: "PackBits",
           32809: "ThunderScan", 32909: "PixarLog", 32946: "deflate",
           34661: "JBIG", 34676: "SGILog", 34677: "SGILog24", 34887: "LERC",
           34925: "LZMA", 50000: "ZSTD", 50001: "WebP"}
# the codecs cv2 5.0's libtiff is built without ("compression support is
# not configured"): cv2 gives None for any image they code
_NOT_CONFIGURED = frozenset({6, 32909, 34661, 34887, 34925, 50000, 50001})
_CCITT = frozenset({2, 3, 4, 32771})
_PREDICTED = frozenset({5, 8, 32946})  # the codecs that undo a Predictor
_LOGL, _LOGLUV = 32844, 32845
_MINISWHITE, _MINISBLACK, _RGB, _PALETTE = 0, 1, 2, 3
_SEPARATED, _YCBCR, _CIELAB = 5, 6, 8
_UNASSOC = 2
_NO_ROWS = 0xFFFFFFFF
_RGBA_RAW_TILE_UNIT = 1024  # see _Tiff.rgba
_BITDEPTH_16_TO_8 = ((np.arange(65536) + 128) // 257).astype(np.uint8)
_BIT_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                        np.uint8)
_SGILOG = (34676, 34677)
# tif_luv.c's (u', v') grid for 24-bit LogLuv (uvcode.h): each row's first
# u' and its number of cells, rows of UV_SQSIZ from UV_VSTART
_UV_USTART = np.array("""
0.247663 0.243779 0.241684 0.237874 0.235906 0.232153 0.228352
0.226259 0.222371 0.22041 0.21471 0.212714 0.210721 0.204976 0.202986
0.199245 0.195525 0.19356 0.189878 0.186216 0.186216 0.182592 0.179003
0.175466 0.172001 0.172001 0.168612 0.168612 0.163575 0.158642
0.158642 0.158642 0.153815 0.153815 0.149097 0.149097 0.142746
0.142746 0.142746 0.13827 0.13827 0.13827 0.132166 0.132166 0.126204
0.126204 0.126204 0.120381 0.120381 0.120381 0.120381 0.112962
0.112962 0.112962 0.10745 0.10745 0.10745 0.10745 0.100343 0.100343
0.100343 0.095126 0.095126 0.095126 0.095126 0.088276 0.088276
0.088276 0.088276 0.081523 0.081523 0.081523 0.081523 0.074861
0.074861 0.074861 0.074861 0.06829 0.06829 0.06829 0.06829 0.063573
0.063573 0.063573 0.063573 0.057219 0.057219 0.057219 0.057219
0.050985 0.050985 0.050985 0.050985 0.050985 0.044859 0.044859
0.044859 0.044859 0.040571 0.040571 0.040571 0.040571 0.036339
0.036339 0.036339 0.036339 0.032139 0.032139 0.032139 0.032139
0.027947 0.027947 0.027947 0.023739 0.023739 0.023739 0.023739
0.019504 0.019504 0.019504 0.016976 0.016976 0.016976 0.016976
0.012639 0.012639 0.012639 0.009991 0.009991 0.009991 0.009016
0.009016 0.009016 0.006217 0.006217 0.005097 0.005097 0.005097
0.003909 0.003909 0.00234 0.002389 0.001068 0.001653 0.000717 0.001614
0.00027 0.000484 0.001103 0.001242 0.001188 0.001011 0.000709 0.000301
0.002416 0.003251 0.003246 0.004141 0.005963 0.008839 0.01049 0.016994
0.023659""".split(), np.float32).astype(np.float64)
_UV_NCUM = np.concatenate([[0], np.cumsum([int(v) for v in """
4 6 7 9 10 12 14 15 17 18 21 22 23 26 27 29 31 32 34 36 36 38 40 42 44
44 46 46 49 52 52 52 55 55 58 58 62 62 62 65 65 65 69 69 73 73 73 77
77 77 77 82 82 82 86 86 86 86 91 91 91 95 95 95 95 100 100 100 100 105
105 105 105 110 110 110 110 115 115 115 115 119 119 119 119 124 124
124 124 129 129 129 129 129 134 134 134 134 138 138 138 138 142 142
142 142 146 146 146 146 150 150 150 154 154 154 154 158 158 158 161
161 161 161 165 165 165 168 168 168 170 170 170 173 173 175 175 175
177 177 177 170 164 157 150 143 136 129 123 115 109 103 97 89 82 76 69
62 55 47 40 31 21""".split()])[:-1]]).astype(np.int64)
_UV_SQSIZ = float(np.float32(0.0035))
_UV_VSTART = float(np.float32(0.01694))
_UV_NDIVS = 16289


class _Ifd:
    """The first IFD of a TIFF: its entries as stored (``entries``, which
    ``_DirReader`` reads as libtiff does)."""

    def __init__(self, data: bytes):
        order = data[:2]
        if order not in (b"II", b"MM") or len(data) < 8:
            raise _NotRead("not a TIFF header")
        self.e = "<" if order == b"II" else ">"
        e = self.e
        magic = struct.unpack_from(e + "H", data, 2)[0]
        if magic == 42:
            big, ifd = False, struct.unpack_from(e + "I", data, 4)[0]
        elif magic == 43 and len(data) >= 16:
            if struct.unpack_from(e + "HH", data, 4) != (8, 0):
                raise _NotRead("bad BigTIFF header")
            big, ifd = True, struct.unpack_from(e + "Q", data, 8)[0]
        else:
            raise _NotRead("not a TIFF header")
        count_fmt, ent, inline = ("Q", 20, 8) if big else ("H", 12, 4)
        if ifd + struct.calcsize(count_fmt) > len(data):
            raise _NotRead("the first IFD lies past the end")
        n = struct.unpack_from(e + count_fmt, data, ifd)[0]
        pos = ifd + struct.calcsize(count_fmt)
        if pos + n * ent > len(data):
            raise _NotRead("the first IFD is cut short")
        if n > 4096:  # TIFFFetchDirectory's sanity check on the count
            raise _NotRead("an IFD of over 4096 entries")
        self.big, self.size = big, len(data)
        # (tag, type, count, the value's offset in the file) in file order
        self.entries = []
        for i in range(n):
            at = pos + i * ent
            tag, ftype = struct.unpack_from(e + "HH", data, at)
            count = struct.unpack_from(e + ("Q" if big else "I"), data,
                                       at + 4)[0]
            size = _TYPES[ftype][1] * (2 if _TYPES[ftype][0] in "rs" else 1) \
                if ftype in _TYPES else 0
            if size * count <= inline:
                voff = at + 4 + (8 if big else 4)
            else:
                voff = struct.unpack_from(e + ("Q" if big else "I"), data,
                                          at + 4 + (8 if big else 4))[0]
            self.entries.append((tag, ftype, count, voff))


class _NotRead(Exception):
    """libtiff cannot open or read the file: cv2 gives None."""


# _TIFFGetMaxColorChannels: the colour channels of each photometric
_COLOUR_CHANNELS = {0: 1, 1: 1, 3: 1, 4: 1, 32844: 1, 2: 3, 6: 3, 8: 3,
                    9: 3, 10: 3, 32845: 3, 5: 4, 34892: 4}
_INTEGER_TYPES = frozenset({1, 3, 4, 6, 8, 9, 16, 17})  # ReadDirEntryShort
_LONG_TYPES = _INTEGER_TYPES | {13, 18}  # ReadDirEntryLong: IFD, IFD8 too


class _DirError(Exception):
    """A TIFFReadDirEntry* error: count, type, I/O, size or value."""


class _DirReader:
    """TIFFReadDirectory's reading of the fields the port uses, entry by
    entry as libtiff 4.7 reads them (tif_dirread.c): the first of a
    duplicated tag; a scalar of count 1 and an integer type in range; an
    array within 2^31 bytes and inside the file. A read error fails the
    directory for the fields that size the image (``fatal``), and drops
    the field (its default) for the others."""

    def __init__(self, ifd: "_Ifd", data: bytes):
        self.ifd, self.data = ifd, data
        self.spp = 1  # SamplesPerPixel, once read: per-sample counts
        self.first: Dict[int, tuple] = {}
        for entry in ifd.entries:
            self.first.setdefault(entry[0], entry)

    def _values(self, entry, limit: Optional[int] = None) -> np.ndarray:
        tag, ftype, count, voff = entry
        if ftype not in _TYPES:
            raise _DirError("type")
        kind, size = _TYPES[ftype]
        width = size * (2 if kind in "rs" else 1)
        if limit is not None:
            count = min(count, limit)
        if count > 0x7FFFFFFF // width:
            raise _DirError("size")
        if voff + count * width > self.ifd.size:
            raise _DirError("I/O")
        e = self.ifd.e
        if kind in "rs":
            signed = "u" if kind == "r" else "i"
            raw = np.frombuffer(self.data, np.dtype(f"{e}{signed}4"),
                                count * 2, voff).astype(np.float64)
            return raw[0::2] / np.where(raw[1::2] == 0, 1, raw[1::2])
        return np.frombuffer(self.data, np.dtype(f"{e}{kind}{size}"), count,
                             voff)

    def _integers(self, entry, types, top: int, persample: int = 0):
        tag, ftype, count, _ = entry
        if ftype not in types:
            raise _DirError("type")
        if persample:
            if count < persample:
                raise _DirError("count")
        elif count != 1:
            raise _DirError("count")
        vals = self._values(entry)
        if vals.dtype.kind == "f" or (vals.size and (
                vals.min() < 0 or vals.max() > top)):
            raise _DirError("value")
        if persample and len(set(int(v) for v in vals[:persample])) > 1:
            raise _DirError("values differ per sample")
        return int(vals[0])

    def _get(self, tag, default, fatal, read):
        entry = self.first.get(tag)
        if entry is None:
            return default
        try:
            return read(entry)
        except _DirError as err:
            if fatal:
                raise _NotRead(f"tag {tag}: {err}") from err
            return default

    def short(self, tag: int, default, fatal: bool = False,
              persample: bool = False):
        """A SHORT field (TIFFReadDirEntryShort, then for ``persample`` a
        per-sample array of equal values)."""
        def read(entry):
            try:
                return self._integers(entry, _INTEGER_TYPES, 0xFFFF)
            except _DirError as err:
                if not persample or str(err) != "count":
                    raise
                return self._integers(entry, _INTEGER_TYPES, 0xFFFF,
                                      self.spp)
        return self._get(tag, default, fatal, read)

    def long(self, tag: int, default, fatal: bool = False):
        """A LONG field (TIFFReadDirEntryLong)."""
        return self._get(tag, default, fatal, lambda e: self._integers(
            e, _LONG_TYPES, 0xFFFFFFFF))

    def extra_samples(self) -> list:
        """ExtraSamples: at most SamplesPerPixel values of 0-2 (999 is
        Corel's 2), else the directory fails."""
        def read(entry):
            if entry[1] not in _INTEGER_TYPES:
                raise _DirError("type")
            vals = [int(v) for v in self._values(entry)]
            if len(vals) > self.spp:
                raise _DirError("count")
            vals = [2 if v == 999 else v for v in vals]
            if any(not 0 <= v <= 2 for v in vals):
                raise _DirError("value")
            return vals
        return self._get(338, [], True, read)

    def shorts(self, tag: int, n: int, default):
        """An array field of ``n`` SHORTs (fewer: dropped)."""
        def read(entry):
            if entry[1] not in _INTEGER_TYPES or entry[2] < n:
                raise _DirError("count")
            return tuple(int(v) for v in self._values(entry)[:n])
        return self._get(tag, default, False, read)

    def floats(self, tag: int, n: int):
        """An array field of ``n`` numbers (fewer: dropped)."""
        def read(entry):
            if entry[2] < n:
                raise _DirError("count")
            return self._values(entry)[:n].astype(np.float64)
        return self._get(tag, None, False, read)

    def white_point(self):
        """WhitePoint (two rationals) as libtiff reads them: float
        numerator over float denominator, 0 over 0."""
        def read(entry):
            if entry[2] < 2 or entry[1] != 5:
                raise _DirError("count")
            if entry[3] + 16 > self.ifd.size:
                raise _DirError("I/O")
            raw = np.frombuffer(self.data, np.dtype(f"{self.ifd.e}u4"), 4,
                                entry[3]).astype(np.float32)
            den = np.where(raw[1::2] == 0, np.float32(1), raw[1::2])
            return np.where(raw[1::2] == 0, np.float32(0), raw[0::2] / den)
        return self._get(318, None, False, read)

    def bytes_(self, tag: int):
        def read(entry):
            return self._values(entry).astype(np.uint8).tobytes()
        return self._get(tag, None, False, read)

    def colormap(self, bits: int):
        """ColorMap: 3 * 2^bits SHORTs exactly, read only after
        BitsPerSample and for at most 24 bits."""
        entry = self.first.get(320)
        if entry is None or bits > 24:
            return None
        order = [e[0] for e in self.ifd.entries]
        if 258 not in order or order.index(258) > order.index(320):
            return None  # "Ignoring ColorMap since BitsPerSample tag not found"
        if entry[2] != 3 << bits or entry[1] not in _INTEGER_TYPES:
            return None
        try:
            vals = self._values(entry)
        except _DirError:
            return None
        if vals.min() < 0 or vals.max() > 0xFFFF:
            return None
        return vals.astype(np.int64)

    def strip_array(self, tags, nstrips: int):
        """StripOffsets / TileOffsets (or the byte counts): the last of the
        pair in the directory, nstrips values (fewer padded with 0); None
        where absent."""
        entries = [e for e in self.ifd.entries if e[0] in tags]
        seen = set()
        entries = [e for e in entries if not (e[0] in seen or seen.add(e[0]))]
        if not entries:
            return None
        entry = entries[-1]
        if entry[1] not in _LONG_TYPES:  # TIFFReadDirEntryLong8Array
            raise _NotRead(f"tag {entry[0]}: type")
        try:
            vals = self._values(entry, limit=nstrips).astype(np.int64)
        except _DirError as err:
            raise _NotRead(f"tag {entry[0]}: {err}") from err
        if vals.size and vals.min() < 0:
            raise _NotRead(f"tag {entry[0]}: value")
        if len(vals) < nstrips:
            if nstrips > 1000000:
                raise _NotRead("too few strip or tile offsets")
            vals = np.concatenate([vals, np.zeros(nstrips - len(vals),
                                                  np.int64)])
        return vals


def _unpack_bits(raw: np.ndarray, rows: int, n: int, bits: int
                 ) -> np.ndarray:
    """(rows, rowbytes) bytes -> (rows, n) samples of ``bits`` < 8, MSB
    first."""
    per = 8 // bits
    shifts = (8 - bits) - bits * np.arange(per, dtype=np.uint8)
    px = (raw[..., None] >> shifts) & ((1 << bits) - 1)
    return px.reshape(rows, -1)[:, :n]


def _unpack_wide(raw: np.ndarray, n: int, bits: int) -> np.ndarray:
    """(rows, rowbytes) bytes -> (rows, n) uint16 of 10, 12 or 14-bit
    samples, MSB first, scaled to 16 bits as OpenCV unpacks them (v <<
    (16 - bits))."""
    b = np.unpackbits(raw, axis=1)[:, :n * bits].reshape(len(raw), n, bits)
    weights = (1 << np.arange(15, 15 - bits, -1)).astype(np.uint16)
    return (b.astype(np.uint16) * weights).sum(axis=2, dtype=np.uint16)


class _Tiff:
    """A parsed TIFF's first image: header fields and a decoder of its
    samples."""

    def __init__(self, data: bytes, mapped: bool = False):
        self.data = data
        self.mapped = mapped  # read from a file (libtiff maps it)
        self._runs = None  # the CCITT codec's run arrays
        self._lzw_compat: Optional[bool] = None  # libtiff's LZW decoder
        # the direct route (TIFFReadEncodedStrip): a strip that does not
        # decode fails the image; the RGBA route paints what it holds
        self.strict = False
        d = self.ifd = _Ifd(data)
        r = _DirReader(d, data)
        # TIFFReadDirectory's passes: SamplesPerPixel, Compression, then
        # the fields that size the strips; a read error of any of these,
        # or of the sample fields, fails the directory (cv2 gives None)
        self.spp = r.spp = r.short(277, 1, fatal=True)
        if self.spp == 0:
            raise _NotRead("SamplesPerPixel 0")
        self.compression = r.short(259, 1, fatal=True, persample=True)
        self.width = r.long(256, 0, fatal=True)
        self.height = r.long(257, 0, fatal=True)
        tw = r.long(322, None, fatal=True)
        th = r.long(323, None, fatal=True)
        self.planar = r.short(284, 1, fatal=True)
        if self.planar not in (1, 2):
            raise _NotRead(f"PlanarConfiguration {self.planar}")
        rps = r.long(278, _NO_ROWS, fatal=True)
        if rps == 0:
            raise _NotRead("RowsPerStrip 0")
        self.rps = rps
        self.extra = r.extra_samples()
        self.bits = r.short(258, 1, fatal=True, persample=True)
        self.sample_format = r.short(339, 1, fatal=True, persample=True)
        if not 1 <= self.sample_format <= 6:
            raise _NotRead(f"SampleFormat {self.sample_format}")
        for tag in (280, 281, 32996):  # Min/MaxSampleValue, DataType
            r.short(tag, 0, fatal=True, persample=True)
        self.photometric = r.short(262, None)
        self.predictor = r.short(317, 1) if self.compression in _PREDICTED \
            else 1
        self.orientation = r.short(274, 1)
        if not 1 <= self.orientation <= 8:
            self.orientation = 1
        self.fill_order = r.short(266, 1)
        if self.fill_order not in (1, 2):
            self.fill_order = 1
        self.t4 = r.long(292, 0) if self.compression == 3 else 0
        self.inkset = r.short(332, 1)
        self.colormap = r.colormap(self.bits)
        self.subsampling = r.shorts(530, 2, (2, 2))
        self.luma = r.floats(529, 3)
        self.refbw = r.floats(532, 6)
        self.white = r.white_point() if self.photometric == _CIELAB else None
        self.jpeg_tables = r.bytes_(347) if self.compression == 7 else None
        if not self.width or not self.height:
            raise _NotRead("missing ImageWidth / ImageLength")
        self.tiled = tw is not None or th is not None
        if self.tiled:
            self.tw, self.th = tw or 0, th or 0
            if not self.tw or not self.th:
                raise _NotRead("a tile size of 0")
        else:
            self.tw = self.width
            self.th = self.height if rps in (_NO_ROWS,) or \
                rps > self.height else rps
        self.across = -(-self.width // self.tw)
        self.down = -(-self.height // self.th)
        planes = self.spp if self.planar == 2 else 1
        nstrips = self.across * self.down * planes
        # _TIFFGetMaxColorChannels: channels past the colours are extra
        colours = _COLOUR_CHANNELS.get(self.photometric, 0)
        if colours and self.spp - len(self.extra) > colours:
            self.extra += [0] * (self.spp - colours - len(self.extra))
        if self.photometric == _PALETTE and self.colormap is None:
            if self.bits >= 8:  # libtiff's guess for a palette without map
                self.photometric = _RGB if self.spp == 3 else _MINISBLACK
            else:
                raise _NotRead("a palette image without ColorMap")
        offsets = r.strip_array((324, 273), nstrips)
        if offsets is None:
            raise _NotRead("missing strip or tile offsets")
        counts = r.strip_array((325, 279), nstrips)
        self.offsets = [int(v) for v in offsets]
        if self.photometric == _YCBCR and self.planar == 1 and (
                self.subsampling[0] not in (1, 2, 4)
                or self.subsampling[1] not in (1, 2, 4)):
            raise _NotRead("Invalid YCbCr subsampling")
        if self._scanline_size() == 0:
            raise _NotRead("zero scanline size")
        if counts is None:
            if (self.planar == 1 and nstrips > 1) or (
                    self.planar == 2 and nstrips != self.spp):
                raise _NotRead("missing StripByteCounts")
            counts = self._estimate_counts(d, nstrips)
        elif nstrips == 1 and not self.tiled and self._count_looks_bad(
                int(counts[0])):
            counts = self._estimate_counts(d, nstrips)
        elif self.planar == 1 and nstrips > 2 and self.compression == 1 \
                and counts[0] != counts[1] and counts[0] and counts[1]:
            counts = self._estimate_counts(d, nstrips)
        self.counts = [int(v) for v in counts]
        if self.planar == 1 and nstrips == 1 and self.compression == 1 \
                and not self.tiled:
            self._chop_single_strip()

    # -- libtiff's directory fix-ups -----------------------------------

    def _scanline_size(self) -> int:
        """TIFFScanlineSize64: a row's bytes (of one plane); a YCbCr
        row of sub-sampled units its share of a unit row."""
        if self.photometric == _YCBCR and self.planar == 1:
            hs, vs = self.subsampling
            units = -(-self.width // hs)
            unit_row = (units * (hs * vs + 2) * self.bits + 7) // 8
            return unit_row // vs
        spp = self.spp if self.planar == 1 else 1
        return (self.width * spp * self.bits + 7) // 8

    def _strip_size(self, rows: int) -> int:
        """TIFFVStripSize64 of ``rows`` rows (one plane)."""
        if self.photometric == _YCBCR and self.planar == 1:
            hs, vs = self.subsampling
            units = -(-self.width // hs)
            unit_row = (units * (hs * vs + 2) * self.bits + 7) // 8
            return -(-rows // vs) * unit_row
        return rows * self._scanline_size()

    def _count_looks_bad(self, count: int) -> bool:
        """ByteCountLooksBad for the one strip."""
        if self.offsets[0] == 0:
            return False
        if count == 0:
            return True
        if self.compression != 1:
            return False
        if self.offsets[0] <= len(self.data) and \
                count > len(self.data) - self.offsets[0]:
            return True
        return count < self._scanline_size() * self.height

    def _estimate_counts(self, d: "_Ifd", nstrips: int) -> list:
        """EstimateStripByteCounts."""
        if self.compression != 1:
            big = d.big
            space = (16 + 8 + len(d.entries) * 20 + 8) if big else \
                (8 + 2 + len(d.entries) * 12 + 4)
            for _, ftype, count, _ in d.entries:
                if ftype not in _TYPES:
                    raise _NotRead("an entry of an unknown type")
                kind, size = _TYPES[ftype]
                n = size * (2 if kind in "rs" else 1) * count
                if n > (8 if big else 4):
                    space += n
            filesize = len(self.data)
            space = 0 if filesize < space else filesize - space
            if self.planar == 2:
                space //= self.spp
            counts = [space] * nstrips
            last = self.offsets[nstrips - 1] if nstrips <= len(
                self.offsets) else 0
            if last + counts[-1] > filesize:
                counts[-1] = 0 if last >= filesize else filesize - last
            return counts
        if self.tiled:
            return [self._strip_size(self.th)] * nstrips
        per = self.height // nstrips if self.planar == 1 else \
            self.height // (nstrips // self.spp)
        return [self._scanline_size() * per] * nstrips

    def _chop_single_strip(self) -> None:
        """ChopUpSingleUncompressedStrip: one uncompressed strip as strips
        of about 8 KiB (libtiff's default STRIPCHOP)."""
        block = 1
        if self.photometric == _YCBCR:
            block = self.subsampling[1]
        block_bytes = self._strip_size(block)
        if block_bytes > 8192:
            rows, strip_bytes = block, block_bytes
        elif block_bytes > 0:
            per = 8192 // block_bytes
            rows, strip_bytes = per * block, per * block_bytes
        else:
            return
        if rows >= self.th or rows == 0:
            return
        n = -(-self.height // rows)
        offset, left = self.offsets[0], self.counts[0]
        offsets, counts = [], []
        for _ in range(n):
            c = min(strip_bytes, left)
            offsets.append(offset)
            counts.append(c)
            offset += c
            left -= c
        self.th, self.down, self.rps = rows, n, rows
        self.offsets, self.counts = offsets, counts

    def opencv_buffer_ok(self, elem: int) -> bool:
        """TiffDecoder::readData's tile buffer: a strip of RowsPerStrip
        rows (all of them where the tag is absent) or a tile, of ``elem``
        bytes a pixel, under 2^24 rows and columns and 2^30 bytes."""
        if self.tiled:
            tw, th = self.tw, self.th
        else:
            tw, th = self.width, self.height if self.rps == _NO_ROWS \
                else self.rps
        return tw < 1 << 24 and th < 1 << 24 and tw * th * elem <= 1 << 30

    # -- samples -------------------------------------------------------

    def _raw(self, index: int, size: int = 0) -> bytes:
        """TIFFFillStrip / TIFFFillTile: the strip's bytes; ``_NotRead``
        where libtiff cannot read them (a byte count of 0, bytes past the
        file's end; a count over 1 MiB and 10 strips is cut to that first).
        ``size``: the direct route's uncompressed strip, which libtiff reads
        whole from its offset, whatever its count, when it reads from
        memory (TIFFReadEncodedStrip's shortcut)."""
        off, cnt = self.offsets[index], self.counts[index]
        if size and self.compression == 1 and not self.mapped:
            cnt = size
        elif cnt == 0:
            raise _NotRead(f"strip or tile {index} of 0 bytes")
        else:
            full = self._strip_size(self.th) if not self.tiled else \
                self._tile_bytes()
            if cnt > 1 << 20 and full and (cnt - 4096) // 10 > full:
                cnt = full * 10 + 4096
        if off + cnt > len(self.data):
            raise _NotRead(f"strip or tile {index} lies past the end of "
                           "the file")
        raw = self.data[off:off + cnt]
        if self.fill_order == 2:
            raw = _BIT_REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
        return raw

    def refused_by_codec(self) -> bool:
        """libtiff's codec refuses the image before it decodes a byte (its
        setup or predecode fails): cv2 gives None under both flags."""
        c, bits = self.compression, self.bits
        if c in _NOT_CONFIGURED:
            return True
        if c in _CCITT:
            return bits != 1  # "Bits/sample must be 1"
        if c == 32809:
            return bits != 4  # ThunderScan's 4-bit codes
        if c == 32766:
            return bits != 2  # NeXT's 2-bit codes
        if c in _SGILOG:  # "Inappropriate photometric"; its init states
            if self.photometric == _LOGL:
                return self.spp != 1
            if self.photometric == _LOGLUV:
                return self.spp != 3 or self.planar != 1
            return True
        if c in _PREDICTED:  # PredictorSetup
            if self.predictor == 2:
                return bits not in (8, 16, 32, 64)
            if self.predictor == 3:
                return self.sample_format != 3 or bits not in (16, 24, 32,
                                                               64)
            return self.predictor != 1
        return False

    def undecodable(self) -> bool:
        """Every strip fails to decode: there is no codec for the
        compression ("strip decoding is not implemented"), or it is JPEG of
        other than 8 bits, which cv2's libjpeg does not read."""
        return self.compression not in _CODECS or (self.compression == 7 and
                                                    self.bits != 8) or (
            self.compression == 32809 and self.tiled)  # no tile decoder

    def _decompress(self, raw: bytes, size: int, rows: int = 0,
                    rowbytes: int = 0, index: int = 0
                    ) -> Tuple[np.ndarray, bool]:
        """A strip's ``size`` bytes as libtiff's codec decodes them into a
        zeroed buffer: (buffer, whether the codec succeeded). A failed
        strip holds what the codec wrote before its error; the direct
        route (``self.strict``) gives None for it."""
        c = self.compression
        if self.undecodable():
            # libtiff's RGBA reader goes on with the strip buffer it zeroed
            buf, ok = np.zeros(size, np.uint8), False
        elif c == 1:  # DumpModeDecode: a short strip copies nothing
            ok = len(raw) >= size
            buf = np.frombuffer(raw, np.uint8, size) if ok else \
                np.zeros(size, np.uint8)
        elif c == 5:
            if self._lzw_compat is None:  # libtiff keeps its first choice
                self._lzw_compat = len(raw) >= 2 and raw[0] == 0 and \
                    bool(raw[1] & 1)
            buf, ok = coders.tiff_lzw(raw, size, self._lzw_compat)
        elif c in (8, 32946):
            buf, ok = coders.tiff_inflate(raw, size)
        elif c == 32773:
            buf, ok = coders.packbits(raw, size)
        elif c == 32809:  # ThunderDecodeRow (refused_by_codec: 4-bit)
            buf, ok = coders.thunder(raw, rows, self.tw)
        elif c in _CCITT:
            two_d = c == 4 or (c == 3 and self.t4 & 1)
            if self._runs is None:
                self._runs = coders.ccitt_runs(self.tw, two_d)
            # RLEW aligns to the data's address: a file is mapped (its
            # strip at its offset), bytes in memory are read into a buffer
            odd = self.mapped and self.offsets[index] % 2 == 1
            buf, ok = coders.ccitt(raw, c, two_d, odd, rows, rowbytes,
                                   self.tw, self._runs).ravel(), True
        else:
            raise ValueError(f"TIFF {_CODECS[c]} compression is not read by "
                             "the port (cv2's libtiff reads it)")
        if not ok and self.strict:
            raise _NotRead("a strip or tile does not decode")
        return buf, ok

    def _dtype(self) -> np.dtype:
        kind = {1: "u", 2: "i", 3: "f"}.get(self.sample_format, "u")
        if self.bits in (10, 12, 14) and kind != "f":
            return np.dtype(f"{kind}2")
        if self.bits not in (8, 16, 32, 64) or (
                kind == "f" and self.bits not in (16, 32, 64)):
            raise ValueError(f"TIFF {self.bits}-bit samples of format "
                             f"{self.sample_format}")
        return np.dtype(f"{kind}{self.bits // 8}")

    def samples(self, grey_skew: bool = False) -> np.ndarray:
        """(H, W, spp) samples as stored (native order; uint8 under 8
        bits), rows from the file's first. ``grey_skew``: the right edge
        tiles read as libtiff's RGBA grey readers read them
        (``putgreytile``, ``putagreytile``, ``put16bitbwtile``): each row
        ``tile width - clipped width`` bytes (not pixels) past the last."""
        if self.compression == 7 and not self.undecodable():
            raise ValueError("TIFF JPEG is read through libtiff's RGBA "
                             "path only")
        h, w, spp, bits = self.height, self.width, self.spp, self.bits
        planes = spp if self.planar == 2 else 1
        per_plane = 1 if self.planar == 2 else spp
        small = bits < 8
        if small and bits not in (1, 2, 4):
            raise ValueError(f"TIFF {bits}-bit samples")
        packed = bits in (10, 12, 14)
        # libtiff undoes a predictor in the codecs that install one only
        # (refused_by_codec has turned away the ones it cannot undo)
        predictor = self.predictor if self.compression in _PREDICTED else 1
        dt = np.dtype(np.uint8) if small else self._dtype()
        out = np.zeros((h, w, spp), dt)
        index = 0
        for p in range(planes):
            for ty in range(self.down):
                y0 = ty * self.th
                rows = self.th if self.tiled else min(self.th, h - y0)
                for tx in range(self.across):
                    x0 = tx * self.tw
                    n = self.tw * per_plane
                    rowbytes = (n * bits + 7) // 8
                    size = rows * rowbytes
                    # gtStripSeparate / gtTileSeparate read the planes after
                    # the first with TIFFReadEncodedStrip / Tile, going on
                    # past one they cannot read (zeros)
                    later = p > 0 and not self.strict
                    try:
                        raw = self._raw(index, size if self.strict or later
                                        else 0)
                    except _NotRead:
                        if not later:
                            raise
                        raw = None
                    if raw is None:
                        buf, ok = np.zeros(size, np.uint8), False
                    else:
                        buf, ok = self._decompress(raw, size, rows, rowbytes,
                                                   index)
                    index += 1
                    block = buf.reshape(rows, rowbytes)
                    if small:
                        block = _unpack_bits(block, rows, n, bits)
                    elif packed:  # signed: saturated to int16, as OpenCV
                        block = _unpack_wide(block, n, bits)
                        if dt.kind == "i":
                            block = np.minimum(block, 32767)
                        block = block.astype(dt)
                    elif not ok:  # no predictor, no byte swap: as decoded
                        block = block.view(dt.newbyteorder("<")).astype(
                            dt.newbyteorder("="))
                    elif predictor == 3:
                        block = coders.predictor3(
                            block, per_plane, dt.itemsize).view(
                                dt.newbyteorder("<"))
                    else:
                        block = block.view(dt.newbyteorder(self.ifd.e))
                        block = block.astype(dt.newbyteorder("="))
                        if predictor == 2:
                            block = coders.predictor2(
                                block.view(f"u{dt.itemsize}"),
                                per_plane).view(dt)
                    block = block.reshape(rows, self.tw, per_plane)
                    ch, cw = min(rows, h - y0), min(self.tw, w - x0)
                    if grey_skew and self.tiled and cw < self.tw and \
                            (bits == 16 or per_plane > 1):
                        nb = np.ascontiguousarray(block).view(np.uint8)
                        block = np.ndarray(
                            (rows, cw, per_plane), block.dtype, nb.ravel(),
                            0, (cw * per_plane * dt.itemsize + self.tw - cw,
                                per_plane * dt.itemsize, dt.itemsize))
                    out[y0:y0 + ch, x0:x0 + cw, p:p + per_plane] = \
                        block[:ch, :cw]
        return out.astype(dt.newbyteorder("="), copy=False)

    # -- libtiff's TIFFReadRGBA* -----------------------------------------

    def rgba(self, file: bool) -> Optional[np.ndarray]:
        """(H, W, 4) uint8 RGBA as libtiff's RGBA reader gives it, rows
        from the file's first (a grey kind's (H, W) grey plane, which is
        what OpenCV's grey of its RGBA gives); None where libtiff refuses
        the image (``file``: read from a file, not from memory)."""
        bits, spp, ph = self.bits, self.spp, self.photometric
        if bits not in (1, 2, 4, 8, 16):
            return None  # "can not handle images with N-bit samples"
        colours = spp - len(self.extra)
        alpha = 0
        if self.extra:
            if self.extra[0] == 0 and spp > 3:
                alpha = 1
            elif self.extra[0] in (1, 2):
                alpha = self.extra[0]
        elif spp == 4 and ph == _RGB:
            alpha, colours = 1, 3
        if ph in (_MINISWHITE, _MINISBLACK, _PALETTE):
            if self.planar == 1 and spp != 1 and bits < 8:
                return None
        elif ph == _RGB:
            if colours < 3:
                return None
        elif ph == _SEPARATED:
            if self.inkset != 1 or spp < 4 or bits != 8:
                return None
        elif ph == _YCBCR:
            if bits != 8 or (self.compression != 7 and self.planar == 2 and
                             self.subsampling != (1, 1)):
                return None
        elif ph == _CIELAB:
            if spp != 3 or colours != 3 or bits not in (8, 16) or \
                    self.planar != 1:
                return None
        elif ph == _LOGL:
            if self.compression != 34676:
                return None  # "LogL data must have Compression=SGILog"
        elif ph == _LOGLUV:
            if self.compression not in _SGILOG or self.planar != 1:
                return None
        else:
            return None  # TIFFRGBAImageOK: "can not handle" the photometric
        if not file and self.tiled and self.compression == 1 and \
                self._tile_bytes() % _RGBA_RAW_TILE_UNIT:
            # libtiff 4.7's RGBA tile reader fails on an uncompressed tile
            # that is not whole KiB ("Invalid tile byte count") when it
            # reads from memory (cv2.imdecode), and cv2 with it
            return None
        if self.compression == 7 and not self.undecodable():
            return self._jpeg_rgba()
        if ph == _YCBCR:
            return self._ycbcr_rgba()
        if ph == _CIELAB:
            return self._cielab_rgba()
        if ph == _LOGL:  # libtiff's 8-bit LogL: grey (L16toGry)
            return _logl_grey(self.sgilog()[0])
        if ph == _LOGLUV:  # 8-bit LogLuv: RGB (XYZtoRGB24)
            out = np.empty((self.height, self.width, 4), np.uint8)
            out[..., 3] = 255
            out[..., :3] = _xyz_rgb_bytes(_luv_xyz(self.sgilog()[0],
                                                   self.compression))
            return out
        s = self.samples(grey_skew=ph in (_MINISWHITE, _MINISBLACK))
        if bits >= 8:
            s = s.view(f"u{bits // 8}")
        if ph in (_MINISWHITE, _MINISBLACK):
            # r = g = b: the grey plane itself (alpha changes no grey)
            v = s[..., 0] >> 8 if bits == 16 else s[..., 0]
            top = 255 if bits == 16 else (1 << bits) - 1
            if ph == _MINISBLACK and top == 255:
                return np.ascontiguousarray(v, np.uint8)
            lut = np.arange(top + 1, dtype=np.int64)
            lut = ((top - lut) if ph == _MINISWHITE else lut) * 255 // top
            return lut.astype(np.uint8)[v]
        h, w = self.height, self.width
        out = np.empty((h, w, 4), np.uint8)
        out[..., 3] = 255
        if ph == _PALETTE:
            cmap = self.colormap
            if bits == 16 or cmap is None:
                return None
            cmap = cmap.reshape(3, -1)
            if (cmap >= 256).any():  # a 16-bit colour map
                cmap = cmap >> 8
            out[..., :3] = cmap.T.astype(np.uint8)[s[..., 0]]
            return out
        if ph == _SEPARATED:
            c = s[..., :4].astype(np.uint16)
            k = 255 - c[..., 3]
            for i in range(3):
                out[..., i] = k * (255 - c[..., i]) // 255
            return out
        # RGB, 16 bits to (v + 128) / 257, unassociated alpha premultiplied
        c = s[..., :4 if alpha else 3]
        if bits == 16:
            c = _BITDEPTH_16_TO_8[c]
        out[..., :c.shape[2]] = c
        if alpha == _UNASSOC:
            a = c[..., 3].astype(np.uint16)
            for i in range(3):
                out[..., i] = (c[..., i] * a + 127) // 255
        return out

    def sgilog(self) -> Tuple[np.ndarray, bool]:
        """(H, W) SGILog codes of every strip or tile (``_sgilog_rows``;
        rows after one short of data zero) and whether every row
        decoded."""
        h, w = self.height, self.width
        out = np.zeros((h, w), np.int64)
        whole, index = True, 0
        for ty in range(self.down):
            y0 = ty * self.th
            rows = self.th if self.tiled else min(self.th, h - y0)
            for tx in range(self.across):
                x0 = tx * self.tw
                try:
                    raw = self._raw(index)
                except _NotRead:
                    if self.strict:
                        raise
                    raw = b""
                index += 1
                codes, done = _sgilog_rows(raw, rows, self.tw,
                                           self.compression,
                                           self.photometric == _LOGL)
                whole = whole and done == rows
                ch, cw = min(rows, h - y0), min(self.tw, w - x0)
                out[y0:y0 + ch, x0:x0 + cw] = codes[:ch, :cw]
        return out, whole

    def _cielab_rgba(self) -> Optional[np.ndarray]:
        """CIELab through ``initCIELabConversion``: the file's WhitePoint
        (D50 by default) as the reference white, ``display_sRGB``."""
        f32 = np.float32
        wp = self.white
        if wp is None:
            total = _D50[0] + _D50[1] + _D50[2]
            wp = (_D50[0] / total, _D50[1] / total)
        if wp[1] == 0:
            return None  # "Invalid value for WhitePoint tag."
        white = (wp[0] / wp[1] * f32(100.0), f32(100.0),
                 (f32(1.0) - wp[0] - wp[1]) / wp[1] * f32(100.0))
        s = self.samples().view(f"u{self.bits // 8}")
        out = np.empty((self.height, self.width, 4), np.uint8)
        out[..., 3] = 255
        out[..., :3] = _cielab_rgb(s, self.bits, white)
        return out

    def _tile_bytes(self) -> int:
        """The bytes of one uncompressed tile (of one plane)."""
        if self.photometric == _YCBCR and self.planar == 1 and \
                self.compression != 7:
            hs, vs = self.subsampling
            return -(-self.tw // hs) * -(-self.th // vs) * (hs * vs + 2) \
                * self.bits // 8
        spp = self.spp if self.planar == 1 else 1
        return (self.tw * spp * self.bits + 7) // 8 * self.th

    def _ycbcr_rgba(self) -> np.ndarray:
        """Uncompressed / LZW / deflate YCbCr through libtiff's tables
        (``TIFFYCbCrToRGBInit``), chroma repeated over each sampling
        block."""
        if self.spp != 3:
            raise ValueError(f"TIFF YCbCr with {self.spp} samples")
        hs, vs = self.subsampling if self.planar == 1 else (1, 1)
        h, w = self.height, self.width
        if (hs, vs) == (1, 1):
            s = self.samples().astype(np.int64)
            y, cb, cr = s[..., 0], s[..., 1], s[..., 2]
        else:
            if (hs, vs) not in ((4, 4), (4, 2), (4, 1), (2, 2), (2, 1),
                                (1, 2)):
                raise ValueError(f"TIFF YCbCr subsampling {hs}x{vs}")
            y, cb, cr = self._ycbcr_units(hs, vs)
        out = np.empty((h, w, 4), np.uint8)
        out[..., 3] = 255
        out[..., :3] = _ycbcr_to_rgb(y, cb, cr, self.luma, self.refbw)
        return out

    def _ycbcr_units(self, hs: int, vs: int):
        """Subsampled YCbCr data units -> full Y, Cb and Cr planes."""
        h, w = self.height, self.width
        unit = hs * vs + 2
        y = np.zeros((h, w), np.int64)
        cb = np.zeros((h, w), np.int64)
        cr = np.zeros((h, w), np.int64)
        index = 0
        for ty in range(self.down):
            y0 = ty * self.th
            rows = self.th if self.tiled else min(self.th, h - y0)
            urows = -(-rows // vs)
            for tx in range(self.across):
                x0 = tx * self.tw
                ucols = -(-self.tw // hs)
                buf, _ = self._decompress(self._raw(index),
                                          urows * ucols * unit)
                index += 1
                if not self.tiled:
                    # TIFFReadRGBAStrip decodes rows times TIFFScanlineSize
                    # (a unit row's bytes over vs, rounded down): of 4x4
                    # units an odd number a row, it leaves the strip's last
                    # 2 bytes a unit row in its zeroed buffer
                    done = urows * vs * (ucols * unit // vs)
                    if done < len(buf):
                        buf = buf.copy()
                        buf[done:] = 0
                ch, cw = min(rows, h - y0), min(self.tw, w - x0)
                if (hs, vs) == (4, 4) and cw < self.tw:
                    # putcontig8bitYCbCr44tile skips (tw - cw) / 4 units of
                    # 10 bytes, not 18, after each unit row of a clipped tile
                    used = -(-cw // 4)
                    u = np.ndarray((urows, used, unit), np.uint8, buf, 0,
                                   (used * unit + (self.tw - cw) // 4 * 10,
                                    unit, 1)).astype(np.int64)
                    u = np.pad(u, ((0, 0), (0, ucols - used), (0, 0)))
                else:
                    u = buf.reshape(urows, ucols, unit).astype(np.int64)
                ys = u[..., :hs * vs].reshape(urows, ucols, vs, hs)
                ys = ys.transpose(0, 2, 1, 3).reshape(urows * vs, ucols * hs)
                cbs = np.repeat(np.repeat(u[..., -2], vs, 0), hs, 1)
                crs = np.repeat(np.repeat(u[..., -1], vs, 0), hs, 1)
                y[y0:y0 + ch, x0:x0 + cw] = ys[:ch, :cw]
                cb[y0:y0 + ch, x0:x0 + cw] = cbs[:ch, :cw]
                cr[y0:y0 + ch, x0:x0 + cw] = crs[:ch, :cw]
        return y, cb, cr

    def _jpeg_rgba(self) -> np.ndarray:
        """JPEG strips or tiles through the port's libjpeg-turbo codec:
        ``JPEGTables`` (SOI, tables, EOI) spliced in front of each stream;
        YCbCr to RGB as libtiff asks libjpeg (``JPEGCOLORMODE_RGB``), other
        kinds' components as they are."""
        if self.planar != 1 and self.photometric != _RGB:
            raise ValueError("TIFF JPEG with separate planes of photometric "
                             f"{self.photometric}")
        if self.bits != 8:
            raise ValueError(f"TIFF JPEG of {self.bits}-bit samples")
        ph = self.photometric
        tables = self.jpeg_tables or b""
        if tables.endswith(b"\xff\xd9"):
            tables = tables[:-2]
        h, w = self.height, self.width
        out = np.zeros((h, w, 4), np.uint8)
        out[..., 3] = 255
        per_plane = self.across * self.down
        planes = min(self.spp, 3) if self.planar == 2 else 1
        for index in range(per_plane * planes):
            plane, at = divmod(index, per_plane)
            ty, tx = divmod(at, self.across)
            y0, x0 = ty * self.th, tx * self.tw
            try:
                stream = self._raw(index)
            except _NotRead:
                if not plane:
                    raise
                continue  # a later plane: TIFFReadEncodedStrip's zeros
            if tables and stream.startswith(b"\xff\xd8"):
                stream = tables + stream[2:]
            img = decode_jpeg_for_tiff(stream, ycbcr=ph == _YCBCR)
            if img is None:  # libjpeg's error in JPEGPreDecode / JPEGDecode
                if not plane:
                    raise _NotRead(f"TIFF JPEG strip or tile {index} does "
                                   "not decode")
                continue
            if img.ndim == 2:
                img = img[..., None]
            ch, cw = min(self.th, h - y0), min(self.tw, w - x0)
            if img.shape[0] < ch or img.shape[1] < cw:
                raise ValueError("TIFF JPEG: a strip or tile smaller than "
                                 "its place")
            img = img[:ch, :cw]
            if self.planar == 2:  # one plane's component a stream
                out[y0:y0 + ch, x0:x0 + cw, plane] = img[..., 0]
            elif ph == _YCBCR or (ph == _RGB and img.shape[2] >= 3):
                out[y0:y0 + ch, x0:x0 + cw, :3] = img[..., :3]
            elif ph in (_MINISBLACK, _MINISWHITE) and img.shape[2] == 1:
                v = img[..., 0]
                if ph == _MINISWHITE:
                    v = 255 - v
                out[y0:y0 + ch, x0:x0 + cw, :3] = v[..., None]
            elif ph == _SEPARATED and img.shape[2] == 4:
                c = img.astype(np.int64)
                k = 255 - c[..., 3]
                for i in range(3):
                    out[y0:y0 + ch, x0:x0 + cw, i] = \
                        k * (255 - c[..., i]) // 255
            else:
                raise ValueError(f"TIFF JPEG with photometric {ph} and "
                                 f"{img.shape[2]} components")
        return out


def _ycbcr_to_rgb(y, cb, cr, coefs, refbw) -> np.ndarray:
    """libtiff's TIFFYCbCrToRGBInit / TIFFYCbCrtoRGB on 8-bit planes (C
    float arithmetic) -> (..., 3) uint8 RGB."""
    f32 = np.float32
    luma = [f32(v) for v in (coefs if coefs is not None and len(coefs) >= 3
                             else (0.299, 0.587, 0.114))]
    ref = [f32(v) for v in (refbw if refbw is not None and len(refbw) >= 6
                            else (0, 255, 128, 255, 128, 255))]

    def fix(x) -> int:
        return int(float(f32(x) * f32(65536)) + 0.5)

    def clamp(x, lo, hi):
        return min(max(x, lo), hi)

    lr, lg, lb = luma
    f1 = f32(2) - f32(2) * lr
    d1 = fix(clamp(f1, f32(0), f32(2)))
    f2 = lr * f1 / lg
    d2 = -fix(clamp(f2, f32(0), f32(2)))
    f3 = f32(2) - f32(2) * lb
    d3 = fix(clamp(f3, f32(0), f32(2)))
    f4 = lb * f3 / lg
    d4 = -fix(clamp(f4, f32(0), f32(2)))

    def code2v(c, rb, rw, cr_):
        den = rw - rb if rw - rb != 0 else f32(1)
        return f32(f32(c - int(rb)) * f32(cr_)) / den

    half = 1 << 15
    cr_r, cb_b, cr_g, cb_g, y_tab = (np.zeros(256, np.int64)
                                     for _ in range(5))
    for i in range(256):
        x = i - 128
        crv = int(clamp(code2v(x, ref[4] - f32(128), ref[5] - f32(128), 127),
                        f32(-4096), f32(4096)))
        cbv = int(clamp(code2v(x, ref[2] - f32(128), ref[3] - f32(128), 127),
                        f32(-4096), f32(4096)))
        cr_r[i] = (d1 * crv + half) >> 16
        cb_b[i] = (d3 * cbv + half) >> 16
        cr_g[i] = d2 * crv
        cb_g[i] = d4 * cbv + half
        y_tab[i] = int(clamp(code2v(x + 128, ref[0], ref[1], 255),
                             f32(-4096), f32(4096)))
    yy = y_tab[np.minimum(y, 255)]
    cb = np.clip(cb, 0, 255)
    cr = np.clip(cr, 0, 255)
    r = yy + cr_r[cr]
    g = yy + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = yy + cb_b[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


# -- CIELab and SGILog as libtiff converts them (tif_color.c, tif_luv.c) ----

# tif_getimage.c's display_sRGB: the XYZ -> luminance matrix, luminance of
# reference white and of black, white's pixel value, each gun's gamma
_SRGB_MAT = np.array([[3.2410, -1.5374, -0.4986], [-0.9692, 1.8760, 0.0416],
                      [0.0556, -0.2040, 1.0570]], np.float32)
_SRGB_YC, _SRGB_Y0, _SRGB_VWHITE, _SRGB_GAMMA = 100.0, 1.0, 255, 2.4
_CIELAB_RANGE = 1500
_D50 = (np.float32(96.4250), np.float32(100.0), np.float32(82.4680))


@functools.lru_cache(maxsize=None)
def _cielab_table() -> Tuple[np.ndarray, np.float32]:
    """``TIFFCIELabToRGBInit``'s luminance -> value table (one for the
    three guns, whose display values agree) and its step."""
    f32 = np.float32
    step = f32(f32(_SRGB_YC) - f32(_SRGB_Y0)) / f32(_CIELAB_RANGE)
    gamma = 1.0 / float(f32(_SRGB_GAMMA))
    tab = np.array([f32(_SRGB_VWHITE) * f32(math.pow(i / _CIELAB_RANGE,
                                                      gamma))
                    for i in range(_CIELAB_RANGE + 1)], np.float32)
    return tab, f32(step)


def _cielab_rgb(lab: np.ndarray, bits: int, white) -> np.ndarray:
    """(..., 3) CIE L*a*b* samples (8-bit: L unsigned, a* b* signed bytes;
    16-bit: L unsigned, a* b* signed, 256 times) -> RGB bytes, as
    ``TIFFCIELab16ToXYZ`` and ``TIFFXYZToRGB`` compute them in float."""
    f32 = np.float32
    if bits == 8:
        lv = lab[..., 0].astype(np.uint32) * 257
        a = lab[..., 1].astype(np.uint8).view(np.int8).astype(np.int32) * 256
        b = lab[..., 2].astype(np.uint8).view(np.int8).astype(np.int32) * 256
    else:
        lv = lab[..., 0].astype(np.uint32)
        a = lab[..., 1].astype(np.uint16).view(np.int16).astype(np.int32)
        b = lab[..., 2].astype(np.uint16).view(np.int16).astype(np.int32)
    x0, y0, z0 = white
    L = lv.astype(f32) * f32(100.0) / f32(65535.0)
    low = L < f32(8.856)
    y_low = (L * y0) / f32(903.292)
    cby = np.where(low, f32(7.787) * (y_low / y0) + f32(16.0) / f32(116.0),
                   (L + f32(16.0)) / f32(116.0))
    Y = np.where(low, y_low, y0 * cby * cby * cby)

    def back(t, w0):
        return np.where(t < f32(0.2069), w0 * (t - f32(0.13793)) / f32(7.787),
                        w0 * t * t * t)

    X = back(a.astype(f32) / f32(256.0) / f32(500.0) + cby, x0)
    Z = back(cby - b.astype(f32) / f32(256.0) / f32(200.0), z0)
    tab, step = _cielab_table()
    out = []
    for row in _SRGB_MAT:
        v = row[0] * X + row[1] * Y + row[2] * Z
        v = np.minimum(np.maximum(v, f32(_SRGB_Y0)), f32(_SRGB_YC))
        i = np.minimum(((v - f32(_SRGB_Y0)) / step).astype(np.int64),
                       _CIELAB_RANGE)
        r = tab[i].astype(np.float64)
        c = np.where(r > 0, r + 0.5, r - 0.5).astype(np.int64)
        out.append(np.minimum(c & 0xFFFFFFFF, _SRGB_VWHITE))
    return np.stack(out, -1).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _logl_tables() -> Tuple[np.ndarray, np.ndarray]:
    """``LogL16toY`` of every 15-bit code and ``LogL10toY`` of every
    10-bit one (libm's exp, as libtiff calls it)."""
    ln2 = math.log(2.0)
    y16 = np.array([0.0] + [math.exp(ln2 / 256.0 * (le + 0.5) - ln2 * 64.0)
                            for le in range(1, 32768)])
    y10 = np.array([0.0] + [math.exp(ln2 / 64.0 * (p + 0.5) - ln2 * 12.0)
                            for p in range(1, 1024)])
    return y16, y10


def _gamma_bytes(v: np.ndarray) -> np.ndarray:
    """tif_luv.c's 8-bit output of a linear value: 0, 255, or
    256 sqrt(v) truncated."""
    with np.errstate(invalid="ignore"):
        r = np.where(v <= 0.0, 0.0, np.where(v >= 1.0, 255.0,
                                             np.floor(256.0 * np.sqrt(
                                                 np.maximum(v, 0.0)))))
    return r.astype(np.uint8)


def _logl_grey(codes: np.ndarray) -> np.ndarray:
    """``L16toGry``: 16-bit LogL codes -> grey bytes."""
    y16, _ = _logl_tables()
    c = codes.astype(np.int64) & 0xFFFF
    y = y16[c & 0x7FFF] * np.where(c & 0x8000, -1.0, 1.0)
    return _gamma_bytes(y)


def _luv_xyz(codes: np.ndarray, kind: int) -> np.ndarray:
    """``LogLuv32toXYZ`` / ``LogLuv24toXYZ`` (compression 34676 / 34677):
    (..., 3) float32 XYZ, in double until the last cast."""
    y16, y10 = _logl_tables()
    p = codes.astype(np.int64) & 0xFFFFFFFF
    if kind == 34676:
        hi = p >> 16
        L = y16[hi & 0x7FFF] * np.where(hi & 0x8000, -1.0, 1.0)
        u = 1.0 / 410.0 * (((p >> 8) & 0xFF) + 0.5)
        v = 1.0 / 410.0 * ((p & 0xFF) + 0.5)
    else:  # uv_decode over the grid; neutral outside it
        L = y10[(p >> 14) & 0x3FF]
        ce = p & 0x3FFF
        vi = np.searchsorted(_UV_NCUM, ce, side="right") - 1
        u = _UV_USTART[vi] + (ce - _UV_NCUM[vi] + 0.5) * _UV_SQSIZ
        v = _UV_VSTART + (vi + 0.5) * _UV_SQSIZ
        out = ce >= _UV_NDIVS
        u, v = np.where(out, 0.210526316, u), np.where(out, 0.473684211, v)
    with np.errstate(all="ignore"):
        s = 1.0 / (6.0 * u - 16.0 * v + 12.0)
        x, y = 9.0 * u * s, 4.0 * v * s
        xyz = np.stack([(x / y * L).astype(np.float32), L.astype(np.float32),
                        ((1.0 - x - y) / y * L).astype(np.float32)], -1)
    xyz[L <= 0] = 0
    return xyz


def _xyz_rgb_bytes(xyz: np.ndarray) -> np.ndarray:
    """``XYZtoRGB24``: float XYZ -> RGB bytes (CCIR-709 primaries, gamma
    2 as a square root), in double."""
    x, y, z = (xyz[..., k].astype(np.float64) for k in range(3))
    r = 2.690 * x + -1.276 * y + -0.414 * z
    g = -1.022 * x + 1.978 * y + 0.044 * z
    b = 0.061 * x + -0.224 * y + 1.163 * z
    return np.stack([_gamma_bytes(r), _gamma_bytes(g), _gamma_bytes(b)], -1)


# OpenCV's XYZ2BGR (float, sRGB D65 rows for B, G, R): four pixels a step
# as x c0 + (y c1 + z c2) in SSE, the row's last width % 4 as
# (x c0 + y c1) + z c2, each product and sum rounded to float
_XYZ2BGR = np.array([[0.055648, -0.204043, 1.057311],
                     [-0.969256, 1.875991, 0.041556],
                     [3.240479, -1.53715, -0.498535]], np.float32)


def _xyz_to_bgr(xyz: np.ndarray) -> np.ndarray:
    w = xyz.shape[1]
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    lanes = np.arange(w) < w - w % 4
    out = np.empty_like(xyz)
    for k, (c0, c1, c2) in enumerate(_XYZ2BGR):
        out[..., k] = np.where(lanes, x * c0 + (y * c1 + z * c2),
                               (x * c0 + y * c1) + z * c2)
    return out


def _sgilog_rows(raw: bytes, rows: int, npix: int, kind: int,
                 logl: bool) -> Tuple[np.ndarray, int]:
    """A strip or tile of SGILog data, row by row as ``LogL16Decode`` /
    ``LogLuvDecode32`` (each row's byte planes from the highest, runs of
    ``128 + n - 2`` then a byte, or a count then literals) or
    ``LogLuvDecode24`` (3 bytes a pixel) read it: (codes, rows decoded);
    a row short of data ends the strip there (its codes zero)."""
    codes = np.zeros((rows, npix), np.int64)
    bp, cc = 0, len(raw)
    for r in range(rows):
        if cc == 0:
            return codes, r
        tp = codes[r]
        if not logl and kind == 34677:
            n = min(npix, cc // 3)
            if n:
                b = np.frombuffer(raw, np.uint8, 3 * n, bp).astype(
                    np.int64).reshape(n, 3)
                tp[:n] = b[:, 0] << 16 | b[:, 1] << 8 | b[:, 2]
            bp, cc = bp + 3 * n, cc - 3 * n
            if n != npix:
                tp[:] = 0
                return codes, r
            continue
        for shft in ((8, 0) if logl else (24, 16, 8, 0)):
            i = 0
            while i < npix and cc > 0:
                c = raw[bp]
                if c >= 128:  # a run
                    if cc < 2:
                        break
                    rc = c + 2 - 128
                    b = raw[bp + 1] << shft
                    bp += 2
                    cc -= 2
                    end = min(npix, i + rc)
                    tp[i:end] |= b
                    i = end
                else:  # literals; libtiff counts the count byte first
                    rc = c
                    bp += 1
                    while True:
                        cc -= 1
                        if not cc or not rc or i >= npix:
                            rc -= 1
                            break
                        rc -= 1
                        tp[i] |= raw[bp] << shft
                        i += 1
                        bp += 1
            if i != npix:
                tp[:] = 0
                return codes, r
    return codes, rows


def _opencv_type(t: _Tiff) -> Tuple[np.dtype, int]:
    """``TiffDecoder::readHeader``'s type: (dtype, channels)."""
    ph, spp = t.photometric, t.spp
    grey = ph in (_MINISWHITE, _MINISBLACK)
    bits = t.bits
    if bits > 8 and (ph > 2 or spp not in (1, 3, 4)):
        bits = 8
    fmt = t.sample_format
    if not 1 <= spp <= 4 and not (grey and bits <= 8):
        raise _NotRead(f"{spp} samples a pixel")
    if bits == 1:
        if spp != 1 or fmt not in (1, 2):
            raise _NotRead("1-bit samples")
        return np.dtype(np.int8 if fmt == 2 else np.uint8), 1
    if bits == 8:
        if fmt not in (1, 2):
            raise _NotRead("8-bit samples of a float format")
        dt = np.dtype(np.int8 if fmt == 2 else np.uint8)
        if ph == _PALETTE:
            return dt, 3
        if ph > 1 and not 1 <= spp <= 4:
            raise _NotRead(f"{spp} samples a pixel")
        return dt, (spp if ph > 1 else 1)
    if bits == 4:
        if ph == _PALETTE and spp == 1:
            return np.dtype(np.uint8), 3
        raise _NotRead(f"{bits}-bit samples")
    if bits in (10, 12, 14, 16):
        if fmt not in (1, 2):
            raise _NotRead("16-bit samples of a float format")
        return np.dtype(np.int16 if fmt == 2 else np.uint16), \
            (spp if not grey else 1)
    if bits == 32:
        dt = {3: np.float32, 2: np.int32, 1: np.uint32}.get(fmt)
        if dt is None:
            raise _NotRead("32-bit samples of an unknown format")
        return np.dtype(dt), spp
    if bits == 64:
        dt = {3: np.float64, 2: np.int64, 1: np.uint64}.get(fmt)
        if dt is None:
            raise _NotRead("64-bit samples of an unknown format")
        return np.dtype(dt), spp
    raise _NotRead(f"{bits}-bit samples")


def _orient(img: np.ndarray, o: int) -> np.ndarray:
    """OpenCV's fixOrientation: the image as the Orientation tag shows it
    (5-8 transpose first, then flip)."""
    if o in (5, 6, 7, 8):
        img = img.swapaxes(0, 1)
    if o in (2, 6):
        img = img[:, ::-1]
    elif o in (3, 7):
        img = img[::-1, ::-1]
    elif o in (4, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def _orient_rgba(img: np.ndarray, o: int, tile_w: int) -> np.ndarray:
    """An 8-bit image read through ``TIFFReadRGBA*`` as OpenCV lays it out
    and turns it: libtiff mirrors each strip or tile it reads (not the
    image) for orientations 2, 3, 6 and 7, OpenCV flips the rows for 3, 4,
    7 and 8 and transposes 5-8 (``fixOrientationPartial``)."""
    if o in (2, 3, 6, 7):
        if tile_w:
            img = img.copy()
            for x0 in range(0, img.shape[1], tile_w):
                img[:, x0:x0 + tile_w] = img[:, x0:x0 + tile_w][:, ::-1]
        else:
            img = img[:, ::-1]
    if o in (3, 4, 7, 8):
        img = img[::-1]
    if o in (6, 8):
        img = img[::-1, ::-1]
    if o >= 5:
        img = img.swapaxes(0, 1)
    return np.ascontiguousarray(img)


def decode_tiff(data: bytes, gray: bool, file: bool = False
                ) -> Optional[np.ndarray]:
    """TIFF bytes -> ``cv2.imdecode(data, flag)``'s array (``file``:
    ``cv2.imread``'s) for ``IMREAD_GRAYSCALE`` (``gray``) or
    ``IMREAD_UNCHANGED``; None where cv2 gives None."""
    try:
        return _decode_tiff(bytes(data), gray, file)
    except _NotRead:
        return None


def _decode_tiff(data: bytes, gray: bool, file: bool
                 ) -> Optional[np.ndarray]:
    t = _Tiff(data, mapped=file)
    if t.photometric is None:  # OpenCV asks for it
        return None
    if t.photometric == _LOGLUV and not gray:
        return _logluv_float(t, file)
    dtype, channels = _opencv_type(t)
    coders.check_image_size(t.width, t.height, "TIFF")
    if t.refused_by_codec():
        return None
    if gray:
        dtype, channels = np.dtype(np.uint8), 1
    o = t.orientation
    if file and o >= 5 and t.width != t.height:
        return None  # imread's check that the decoder kept its buffer
    if not t.opencv_buffer_ok(4 if dtype.itemsize == 1 else
                              t.spp * dtype.itemsize):
        return None
    if dtype.itemsize == 1:
        rgba = t.rgba(file)
        if rgba is None:
            return None
        if rgba.ndim == 2:
            img = rgba
        elif channels == 1:
            img = coders.bgr_to_gray(rgba, rgb=True)
        elif channels == 3:
            img = rgba[..., 2::-1]
        elif channels == 4:
            img = rgba[..., [2, 1, 0, 3]]
        else:
            return None
        return _orient_rgba(img.view(dtype), o, t.tw if t.tiled else 0)
    if t.undecodable():
        return None  # TIFFReadEncodedStrip fails, and OpenCV with it
    if t.planar == 2 and t.spp > 1:
        raise ValueError(f"TIFF PlanarConfiguration 2 of {t.spp} "
                         f"{t.bits}-bit samples: OpenCV 5.0 reads the first "
                         "plane's strips as whole pixels (undefined pixels)")
    t.strict = True
    s = t.samples()
    if s.dtype.itemsize != dtype.itemsize:
        return None
    s = s.view(dtype)
    if channels == 1:
        if t.spp == 1:
            img = s[..., 0]
        elif dtype.itemsize == 2:  # icvCvt_BGRA2Gray_16u_CnC1R
            c = s[..., :3].astype(np.int64)
            img = ((c[..., 2] * 1868 + c[..., 1] * 9617 + c[..., 0] * 4899
                    + (1 << 13)) >> 14).astype(dtype)
        else:
            img = s[..., 0]
    elif channels == 3:
        img = s[..., 2::-1] if t.spp >= 3 else np.repeat(s[..., :1], 3, 2)
    elif channels == 4:
        img = s[..., [2, 1, 0, 3]]
    else:
        img = s[..., :channels]
    return _orient(img, o)


def _logluv_float(t: _Tiff, file: bool) -> Optional[np.ndarray]:
    """LogLuv under ``IMREAD_UNCHANGED``: OpenCV's HDR read (float32 XYZ
    of libtiff's ``SGILOGDATAFMT_FLOAT``, turned by the Orientation tag,
    then ``COLOR_XYZ2BGR``); None where a strip does not decode."""
    coders.check_image_size(t.width, t.height, "TIFF")
    if t.refused_by_codec() or t.compression not in _SGILOG:
        return None
    if file and t.orientation >= 5 and t.width != t.height:
        return None
    t.strict = True
    codes, whole = t.sgilog()
    if not whole:
        return None  # a strip that does not decode fails the read
    xyz = _orient(_luv_xyz(codes, t.compression), t.orientation)
    return _xyz_to_bgr(xyz)


def encode_tiff(img: np.ndarray, compression: int = 1, predictor: int = 1,
                tile: Optional[Tuple[int, int]] = None,
                geo: Optional[Tuple[float, float, float, float]] = None
                ) -> bytes:
    """A single-band (H, W) uint8, uint16, int16 or float32 raster ->
    little-endian TIFF bytes, strips of 16 rows or ``tile`` (tw, th) tiles,
    ``compression`` 1 (none) or 8 (deflate), ``predictor`` 1, 2 (integers)
    or 3 (floats); ``geo`` (left, top, deg per px east, deg per px south)
    adds GeoTIFF's EPSG:4326 tags as GDAL writes them."""
    img = np.ascontiguousarray(img)
    if img.ndim != 2 or img.dtype not in (np.uint8, np.uint16, np.int16,
                                          np.float32):
        raise ValueError(f"encode_tiff writes (H, W) uint8, uint16, int16 or "
                         f"float32, got {img.shape} {img.dtype}")
    if compression not in (1, 8) or predictor not in (1, 2, 3) or (
            predictor == 3) != (img.dtype == np.float32 and predictor != 1):
        raise ValueError(f"compression {compression} with predictor "
                         f"{predictor} on {img.dtype}")
    h, w = img.shape
    tw, th = tile if tile else (w, min(16, h))
    dt = img.dtype.newbyteorder("<")
    chunks = []
    for y in range(0, h, th):
        for x in range(0, w, tw):
            block = img[y:y + th, x:x + tw]
            if tile:
                block = np.pad(block, ((0, th - block.shape[0]),
                                       (0, tw - block.shape[1])))
            if predictor == 2:
                d = block.copy()
                d[:, 1:] = block[:, 1:] - block[:, :-1]
                raw = d.astype(dt).tobytes()
            elif predictor == 3:
                be = block.astype(">f4").view(np.uint8).reshape(
                    block.shape[0], -1, 4).transpose(0, 2, 1).reshape(
                        block.shape[0], -1)
                d = be.copy()
                d[:, 1:] = be[:, 1:] - be[:, :-1]
                raw = d.tobytes()
            else:
                raw = block.astype(dt).tobytes()
            chunks.append(zlib.compress(raw, 6) if compression == 8 else raw)
    fmt = {"u": 1, "i": 2, "f": 3}[img.dtype.kind]
    # (tag, type, values): SHORT 3, LONG 4, DOUBLE 12
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [dt.itemsize * 8]),
               (259, 3, [compression]), (262, 3, [1]), (277, 3, [1]),
               (284, 3, [1]), (339, 3, [fmt])]
    if predictor != 1:
        entries.append((317, 3, [predictor]))
    if tile:
        entries += [(322, 4, [tw]), (323, 4, [th]),
                    (324, 4, [0] * len(chunks)),
                    (325, 4, [len(c) for c in chunks])]
    else:
        entries += [(273, 4, [0] * len(chunks)), (278, 4, [th]),
                    (279, 4, [len(c) for c in chunks])]
    if geo is not None:
        left, top, dx, dy = geo
        entries += [(33550, 12, [dx, dy, 0.0]),
                    (33922, 12, [0.0, 0.0, 0.0, left, top, 0.0]),
                    (34735, 3, [1, 1, 0, 3, 1024, 0, 1, 2, 1025, 0, 1, 1,
                                2048, 0, 1, 4326])]
    entries.sort()
    codes = {3: "H", 4: "I", 12: "d"}
    ifd_len = 2 + 12 * len(entries) + 4
    blob_at = 8 + ifd_len
    blobs = bytearray()
    placed = {}
    for tag, ftype, values in entries:
        size = struct.calcsize(codes[ftype]) * len(values)
        if size > 4:
            placed[tag] = blob_at + len(blobs)
            blobs += b"\0" * (size + (size & 1))
    at = blob_at + len(blobs)
    offsets = []
    for c in chunks:
        offsets.append(at)
        at += len(c)
    ifd = bytearray(struct.pack("<H", len(entries)))
    for tag, ftype, values in entries:
        if tag in (273, 324):
            values = offsets
        payload = struct.pack(f"<{len(values)}{codes[ftype]}", *values)
        ifd += struct.pack("<HHI", tag, ftype, len(values))
        if tag in placed:
            ifd += struct.pack("<I", placed[tag])
            off = placed[tag] - blob_at
            blobs[off:off + len(payload)] = payload
        else:
            ifd += payload.ljust(4, b"\0")
    ifd += b"\0\0\0\0"
    return (b"II" + struct.pack("<HI", 42, 8) + bytes(ifd) + bytes(blobs)
            + b"".join(chunks))
