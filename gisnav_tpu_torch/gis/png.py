"""PNG decoding and encoding in numpy and ``zlib`` (no OpenCV, no Pillow).

The JAX package decodes WMS rasters and replay files with ``cv2.imdecode``
/ ``cv2.imread`` (OpenCV over libpng); the card machine has no OpenCV, so
the port reads PNG itself:

- every colour type (grey, RGB, palette, grey + alpha, RGBA) at every
  depth PNG allows (1, 2, 4, 8, 16), plain or Adam7-interlaced; critical
  chunks' CRCs are checked, an ancillary chunk that fails its CRC is
  dropped (libpng's default);
- the five row filters (None, Sub, Up, Average, Paeth). Rows of the first
  three decode a row at a time; an image with Average or Paeth rows
  decodes along anti-diagonals, all rows at once, since a pixel of those
  needs its left, upper and upper-left neighbours decoded first;
- ``decode_png`` gives the file's samples: grey (H, W), grey + alpha
  (H, W, 2), RGB(A) (H, W, 3|4), a palette image through its palette (RGB,
  RGBA with ``tRNS``), depths under 8 scaled to 0-255 as libpng's expand
  scales them;
- ``png_as_opencv(data, gray)`` is ``cv2.imdecode`` with
  ``IMREAD_UNCHANGED`` or ``IMREAD_GRAYSCALE``. Unchanged: grey (tRNS
  ignored), colour as BGR, BGRA where the file has alpha or a ``tRNS``
  (grey + alpha as B = G = R), 16 bits kept. Grey: libpng's
  ``png_set_rgb_to_gray(0.299, 0.587)`` (9797 R + 19234 G + 3737 B over
  2^15, truncated at 8 bits, rounded at 16; through libpng's gamma tables
  where a ``gAMA`` or ``sRGB`` chunk before PLTE and IDAT gives a gamma
  other than 1: 8-bit ones, or at 16 bits its 11-bit-indexed 16-bit
  tables), alpha dropped, 16 bits to the high byte, then the image turned
  upright by its first valid ``eXIf`` chunk (``gis/exif.py``);
- ``to_gray`` is ``cv2.cvtColor``'s grey (OpenCV 5: 9798 R + 19235 G +
  3735 B over 2^15, rounded), alpha ignored: what the JAX package applies
  to a colour raster it holds (``cv2.cvtColor(img, COLOR_BGR2GRAY)``), not
  what ``imread``'s grey flag gives.

Damaged files are read as libpng 1.6 under OpenCV's ``PngDecoder`` reads
them: ``png_as_opencv`` gives None wherever libpng stops with
``png_error`` (input ending before IEND, a chunk name of other than
letters, an unknown critical chunk, a critical chunk failing its CRC, too
little or corrupt image data, a bad row filter) and the image where it
only warns (an ancillary chunk's CRC, IEND's CRC or length, data past the
image, a corrupt stream end past the last row, IDAT after the image);
a header over cv2's size limits raises ``ValueError`` (``cv2.error`` in
cv2). ``decode_png`` raises ``ValueError`` (``PngError``) on a damaged
file and on non-PNG bytes (``gis/imgcodecs.py`` ``decode_image`` chooses
the decoder by content).
``encode_png`` writes an 8-bit grey or colour PNG with filter None on
every row.
"""
from __future__ import annotations

import math
import struct
import zlib
from typing import List, Optional

import numpy as np

from gisnav_tpu_torch.gis.coders import check_image_size
from gisnav_tpu_torch.gis.exif import apply_orientation, orientation

__all__ = ["decode_png", "png_as_opencv", "encode_png", "to_gray",
           "PngError", "PNG_SIGNATURE"]

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
_JPEG_SOI = b"\xff\xd8\xff"
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_GAMMA_UNIT = 100000  # libpng's png_fixed_point 1.0
_SRGB_GAMMA = 45455


class PngError(ValueError):
    """A file libpng stops on with ``png_error`` (cv2 gives None)."""


def _chunk_name_ok(kind: bytes) -> bool:
    """libpng's png_check_chunk_name: four ASCII letters, the third (the
    reserved bit) upper case."""
    return all(65 <= c <= 90 or 97 <= c <= 122 for c in kind) and \
        not kind[2] & 0x20


def _chunks(data: bytes):
    """(kind, body, CRC holds) of each chunk up to IEND; ``PngError`` where
    libpng's reader stops: input ending before IEND's CRC, a length over
    2^31 - 1 or a chunk name of other than letters."""
    pos = len(PNG_SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise PngError("PNG input ends before IEND")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if length > 0x7FFFFFFF:
            raise PngError("PNG chunk length out of range")
        if not _chunk_name_ok(kind):
            raise PngError(f"PNG chunk name {kind!r} is invalid")
        end = pos + 12 + length
        if end > len(data):
            raise PngError("truncated PNG chunk")
        body = data[pos + 8:pos + 8 + length]
        crc = struct.unpack(">I", data[end - 4:end])[0]
        yield kind, body, zlib.crc32(kind + body) == crc
        if kind == b"IEND":
            return
        pos = end


_IDAT_READ = 8192  # libpng's PNG_IDAT_READ_SIZE: the input of one inflate
_CHECK_BUF = 1024  # PNG_INFLATE_BUF_SIZE: the output of one check inflate
_CHUNK_MAX = 8000000  # PNG_USER_CHUNK_MALLOC_MAX, OpenCV's read_chunk limit


def _inflate_idat(run: List[bytes], need: int) -> bytes:
    """The first ``need`` bytes of the zlib stream over one run of IDAT
    chunks, as libpng's png_read_IDAT_data gives them: ``PngError`` where
    the stream is corrupt or ends (or the run does) before them. Then
    png_read_finish_IDAT's check of the stream's end: data past the image
    and a corrupt end are warnings, a run ending before the stream's end
    an error. Input is fed as libpng feeds it (8 KiB of a chunk at a time),
    so that a corrupt end is seen where libpng sees it: zlib reads past the
    image's last byte as far as its input goes."""
    stream = b"".join(run)
    # the ends in ``stream`` of the pieces libpng reads
    ends = np.cumsum([min(_IDAT_READ, len(c) - k) for c in run
                      for k in range(0, len(c), _IDAT_READ)], dtype=np.int64)
    d = zlib.decompressobj()
    out: List[bytes] = []
    got, i, tail = 0, 0, b""
    if need > 1:
        # all but the image's last byte in one call: zlib stops on its
        # output limit at that byte's code, as it would piece by piece;
        # then on from that piece as libpng feeds it
        try:
            part = d.decompress(stream, need - 1)
        except zlib.error as err:
            raise PngError(f"PNG IDAT: {err}") from err
        out.append(part)
        got = len(part)
        used = len(stream) - len(d.unconsumed_tail)
        i = int(np.searchsorted(ends, used, side="right"))
        if i < len(ends):
            tail, i = stream[used:ends[i]], i + 1
        if d.eof and got < need:
            raise PngError("PNG: not enough image data")

    def more() -> bytes:
        nonlocal i
        if i == len(ends):
            raise PngError("PNG: not enough image data")
        i += 1
        return stream[ends[i - 2] if i > 1 else 0:ends[i - 1]]

    while got < need:
        if not tail:
            tail = more()
        try:
            part = d.decompress(tail, need - got)
        except zlib.error as err:
            raise PngError(f"PNG IDAT: {err}") from err
        tail = d.unconsumed_tail
        out.append(part)
        got += len(part)
        if d.eof and got < need:
            raise PngError("PNG: not enough image data")
    extra = 0
    while not d.eof:
        if not tail:
            tail = more()
        try:
            extra += len(d.decompress(tail, _CHECK_BUF))
        except zlib.error:
            break  # a benign error once the image is whole
        tail = d.unconsumed_tail
        if not extra:
            break
    return b"".join(out)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """(h, 1 + w * bpp) filtered scanlines -> (h, w, bpp) uint8 bytes (a
    low-depth row is w bytes of bpp 1)."""
    ftype = raw[:, 0]
    if ftype.max(initial=0) > 4:
        raise PngError(f"PNG row filter {int(ftype.max())} is not one of "
                       "the five")
    data = raw[:, 1:].reshape(h, w, bpp).astype(np.int32)
    # a zero row above and a zero column left: PNG's neighbours outside
    out = np.zeros((h + 1, w + 1, bpp), np.int32)
    if ftype.max(initial=0) <= 2:
        for y in range(h):
            f, row = ftype[y], data[y]
            if f == 1:
                row = np.cumsum(row, axis=0)
            elif f == 2:
                row = row + out[y, 1:]
            out[y + 1, 1:] = row & 0xFF
        return out[1:, 1:].astype(np.uint8)
    for d in range(h + w - 1):  # anti-diagonals: x + y = d
        y = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - y
        a, b, c = out[y + 1, x], out[y, x + 1], out[y, x]
        f = ftype[y][:, None]
        pred = np.select([f == 0, f == 1, f == 2, f == 3],
                         [0, a, b, (a + b) >> 1], _paeth(a, b, c))
        out[y + 1, x + 1] = (data[y, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def _samples(raw: np.ndarray, h: int, w: int, channels: int,
             depth: int) -> np.ndarray:
    """One image's (or Adam7 pass's) filtered rows -> (h, w, channels)
    samples, uint8 (depths to 8, unscaled) or uint16."""
    rowbytes = (w * channels * depth + 7) // 8
    bpp = max(1, channels * depth // 8)
    px = _unfilter(raw.reshape(h, 1 + rowbytes), h, rowbytes // bpp, bpp)
    px = px.reshape(h, rowbytes)
    if depth == 16:
        px = px.reshape(h, w * channels, 2).astype(np.uint16)
        px = (px[..., 0] << 8) | px[..., 1]
    elif depth < 8:  # MSB first
        per = 8 // depth
        shifts = (8 - depth) - depth * np.arange(per, dtype=np.uint8)
        px = (px[..., None] >> shifts) & ((1 << depth) - 1)
        px = px.reshape(h, rowbytes * per)[:, :w * channels]
    return px.reshape(h, w, channels)


class _Png:
    """A parsed PNG: its header, samples (H, W, C) and the chunks that
    OpenCV's reading depends on."""

    def __init__(self, data: bytes, size_check: bool = False):
        if not data.startswith(PNG_SIGNATURE):
            found = "JPEG" if data.startswith(_JPEG_SOI) else repr(data[:8])
            raise ValueError(f"not a PNG image ({found}); gis/jpeg.py "
                             "decode_image reads PNG and JPEG")
        header = None
        run: List[bytes] = []  # the first run of IDAT chunks
        idat = after = False  # in the first run; past it
        self.palette: Optional[np.ndarray] = None
        self.trns: Optional[bytes] = None
        self.exif: Optional[bytes] = None
        gama: Optional[int] = None
        srgb = False
        # the largest colour depth of a valid sBIT (libpng's sig_bit)
        self.sig_bit: Optional[int] = None
        sbit_seen = False
        # OpenCV's PngDecoder::readHeader reads up to the first IDAT: what
        # fails there gives None before cv2's size check, a critical
        # chunk's CRC and all that follows fail after it (in readData)
        late: Optional[str] = None
        for kind, body, crc_ok in _chunks(data):
            critical = not kind[0] & 0x20
            if not (idat or after) and kind not in (b"IDAT", b"tEXt") and \
                    len(body) + 12 > _CHUNK_MAX:
                raise PngError(f"PNG chunk {kind!r} over OpenCV's limit")
            if header is None:  # OpenCV reads a 13-byte IHDR first itself
                if kind != b"IHDR" or len(body) != 13:
                    raise PngError("PNG without IHDR first")
                if not crc_ok:
                    raise PngError("PNG chunk IHDR fails its CRC")
                header = struct.unpack(">IIBBBBB", body)
                self._check_header(header)
                continue
            if kind == b"IDAT" and not (idat or after):
                if header[3] == 3 and self.palette is None:
                    raise PngError("palette PNG without PLTE before IDAT")
                if size_check:
                    check_image_size(header[0], header[1], "PNG")
                if late:
                    raise PngError(late)
            if kind == b"IDAT":
                if not crc_ok:
                    raise PngError("PNG chunk IDAT fails its CRC")
                if after:
                    continue  # "Too many IDATs found": a warning
                idat = True
                run.append(body)
                continue
            if idat:
                idat, after = False, True
            if kind == b"IEND":
                # after the image, libpng reads IEND's CRC as an ancillary
                # chunk's and its length as a warning
                if not after:
                    raise PngError("PNG IEND before IDAT")
                break
            if critical:
                if kind == b"IHDR" or kind not in (b"PLTE",):
                    raise PngError(f"PNG critical chunk {kind!r} is out of "
                                   "place or unknown")
                if not crc_ok:
                    late = late or f"PNG chunk {kind!r} fails its CRC"
                    if after:
                        raise PngError(late)
                if after:
                    continue  # PLTE after IDAT: "out of place", a warning
                if self.palette is not None:
                    raise PngError("a second PNG PLTE")
                if len(body) % 3 or not 0 < len(body) <= 768:
                    if header[3] == 3:
                        raise PngError("bad PNG palette")
                    continue  # a benign error in a colour image
                self.palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
                continue
            if not crc_ok:
                continue  # an ancillary chunk failing its CRC is dropped
            if kind == b"tRNS" and self.trns is None and not after:
                # libpng ignores a tRNS of the wrong size or place
                ctype = header[3]
                if (ctype == 0 and len(body) == 2) or (
                        ctype == 2 and len(body) == 6) or (
                        ctype == 3 and self.palette is not None
                        and 0 < len(body) <= len(self.palette)):
                    self.trns = body
            elif kind == b"eXIf" and self.exif is None:
                if body[:4] in (b"II*\0", b"MM\0*"):  # libpng's check
                    self.exif = body
            elif kind == b"sBIT" and not sbit_seen and not after and (
                    self.palette is None):
                sbit_seen = True  # png_handle_sBIT: one, before PLTE, IDAT
                ctype, depth = header[3], header[2]
                want, top = ((3, 8) if ctype == 3
                             else (_CHANNELS[ctype], depth))
                if len(body) == want and all(0 < v <= top for v in body):
                    self.sig_bit = max(body[:3]) if ctype & 2 else body[0]
            elif kind in (b"gAMA", b"sRGB") and not after and (
                    self.palette is None):
                if kind == b"sRGB":
                    srgb = srgb or (len(body) == 1 and body[0] < 4)
                elif gama is None and len(body) == 4:
                    g = struct.unpack(">I", body)[0]
                    gama = g if 16 <= g <= 625000000 else None
        if not run:
            raise PngError("PNG without IDAT")
        w, h, depth, ctype, _, _, interlace = header
        self.width, self.height, self.depth, self.ctype = w, h, depth, ctype
        self.gamma = _SRGB_GAMMA if srgb else gama
        channels = _CHANNELS[ctype]
        passes = [(0, 0, 1, 1, w, h)] if not interlace else [
            (x0, y0, dx, dy, -(-(w - x0) // dx), -(-(h - y0) // dy))
            for x0, y0, dx, dy in _ADAM7]
        passes = [p for p in passes if p[4] > 0 and p[5] > 0]
        sizes = [ph * (1 + (pw * channels * depth + 7) // 8)
                 for *_, pw, ph in passes]
        raw = np.frombuffer(_inflate_idat(run, sum(sizes)), np.uint8)
        dtype = np.uint16 if depth == 16 else np.uint8
        self.samples = np.zeros((h, w, channels), dtype)
        pos = 0
        for (x0, y0, dx, dy, pw, ph), n in zip(passes, sizes):
            self.samples[y0::dy, x0::dx] = _samples(raw[pos:pos + n], ph, pw,
                                                    channels, depth)
            pos += n

    @staticmethod
    def _check_header(header) -> None:
        """libpng's png_check_IHDR (its default limits of 10^6 columns and
        rows)."""
        w, h, depth, ctype, compression, filtering, interlace = header
        if not (0 < w <= 1000000 and 0 < h <= 1000000):
            raise PngError(f"PNG size {w}x{h} is over libpng's limits")
        if ctype not in _DEPTHS or depth not in _DEPTHS[ctype]:
            raise PngError(f"PNG colour type {ctype} at bit depth {depth} "
                           "is not a valid PNG")
        if compression or filtering:
            raise PngError("PNG compression or filter method other than 0")
        if interlace > 1:
            raise PngError(f"PNG interlace method {interlace} is unknown")

    def expanded(self) -> np.ndarray:
        """The samples as libpng's expand gives them: palette through PLTE
        (and tRNS as alpha), grey under 8 bits scaled to 0-255."""
        px = self.samples
        if self.ctype == 3:
            pal = np.zeros((256, 4), np.uint8)
            pal[:, 3] = 255
            pal[:len(self.palette), :3] = self.palette
            if self.trns is not None:
                t = np.frombuffer(self.trns, np.uint8)
                pal[:len(t), 3] = t
            return pal[px[..., 0]][..., :4 if self.trns is not None else 3]
        if self.depth < 8:
            px = px * np.uint8(255 // ((1 << self.depth) - 1))
        return px

    def rgb_alpha_from_trns(self, rgb: np.ndarray) -> Optional[np.ndarray]:
        """An RGB file's tRNS colour as an alpha plane (0 where it matches,
        full elsewhere), or None without a usable tRNS."""
        if self.ctype != 2 or self.trns is None:
            return None
        key = np.array(struct.unpack(">3H", self.trns))
        if self.depth == 8:
            key &= 0xFF
        full = np.iinfo(rgb.dtype).max
        return np.where((rgb == key.astype(rgb.dtype)).all(-1), 0,
                        full).astype(rgb.dtype)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) or (H, W, C) uint8 / uint16, channels in the
    file's order (grey + alpha, RGB, RGBA); a palette image as RGB(A)."""
    px = _Png(data).expanded()
    return px[..., 0] if px.shape[2] == 1 else px


def _gamma_table(gamma: int) -> np.ndarray:
    """libpng's png_build_8bit_table: 255 * (i / 255) ^ (gamma / 1e5),
    rounded, 0 and 255 kept; the identity for a gamma within 5 % of 1."""
    table = np.arange(256, dtype=np.int64)
    if _significant(gamma):
        for i in range(1, 255):
            table[i] = int(math.floor(255 * math.pow(i / 255.0,
                                                     gamma * 1e-5) + 0.5))
    return table


def _reciprocal(gamma: int) -> int:
    """libpng's png_reciprocal in fixed point."""
    return int(math.floor(1e10 / gamma + 0.5))


def _significant(gamma: int) -> bool:
    return abs(gamma - _GAMMA_UNIT) > 5000


def _gamma_shift(sig_bit: Optional[int]) -> int:
    """png_build_gamma_table's gamma_shift for OpenCV's 16-bit grey read:
    the insignificant bits of the sBIT chunk's largest colour depth, at
    least 16 - PNG_MAX_GAMMA_8 (11) under png_set_strip_16, at most 8."""
    shift = 16 - sig_bit if sig_bit and sig_bit < 16 else 0
    return min(max(shift, 16 - 11), 8)


def _gamma_table16(gamma: int, shift: int) -> np.ndarray:
    """libpng's png_build_16bit_table over the value >> shift (the index
    its table[(v & 0xff) >> shift][v >> 8] reads)."""
    top = (1 << (16 - shift)) - 1
    ig = np.arange(top + 1, dtype=np.int64)
    if not _significant(gamma):
        return (ig * 65535 + (1 << (15 - shift))) // top
    return np.array([int(math.floor(65535.0 * math.pow(i * (1.0 / top),
                                                       gamma * 1e-5) + 0.5))
                     for i in range(top + 1)], np.int64)


def _gamma_16_to_8(gamma: int, shift: int) -> np.ndarray:
    """libpng's png_build_16to8_table over the value >> shift: the 16-bit
    value (i * 257) of the 8-bit output i whose bounds hold it."""
    top = (1 << (16 - shift)) - 1
    table = np.full(top + 1, 65535, np.int64)
    last = 0
    for i in range(255):
        out = i * 257
        bound = out + 128  # png_gamma_16bit_correct(out + 128, gamma)
        if 0 < bound < 65535:
            bound = int(math.floor(65535 * math.pow(bound / 65535.0,
                                                    gamma * 1e-5) + 0.5))
        bound = (bound * top + 32768) // 65535 + 1
        table[last:bound] = out
        last = max(last, bound)
    return table


def _product(a: int, b: int) -> int:
    """libpng's png_product2 in fixed point."""
    return int(math.floor(a * 1e-5 * b + 0.5))


def _libpng_gray(rgb: np.ndarray, gamma: Optional[int],
                 sig_bit: Optional[int] = None) -> np.ndarray:
    """libpng's png_do_rgb_to_gray with OpenCV's coefficients (0.299,
    0.587 -> 9797, 19234, 3737 over 2^15) on (H, W, 3) RGB. With a file
    gamma other than 1 libpng takes screen gamma as its reciprocal and
    converts through its gamma_to_1 / gamma_from_1 tables: 8-bit ones, or
    at 16 bits the 11-bit-indexed gamma_16_to_1 / gamma_16_from_1, a grey
    pixel through the 16-to-8 gamma_16_table, of which OpenCV's strip_16
    keeps the high byte."""
    rc, gc, bc = 9797, 19234, 3737
    c = rgb.astype(np.int64)
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    grey = r == g
    grey &= r == b
    if rgb.dtype == np.uint16:
        if gamma is None or not _significant(gamma):
            return ((rc * r + gc * g + bc * b + 16384) >> 15).astype(
                np.uint16)
        s = _gamma_shift(sig_bit)
        screen = _reciprocal(gamma)
        to_1 = _gamma_table16(_reciprocal(gamma), s)
        from_1 = _gamma_table16(_reciprocal(screen), s)
        same = _gamma_16_to_8(_product(gamma, screen), s)
        grey16 = (rc * to_1[r >> s] + gc * to_1[g >> s] + bc * to_1[b >> s]
                  + 16384) >> 15
        return np.where(grey, same[r >> s], from_1[grey16 >> s]).astype(
            np.uint16)
    if gamma is None or not _significant(gamma):
        out = (rc * r + gc * g + bc * b) >> 15
    else:  # gamma_to_1, the sum rounded, gamma_from_1
        to_1 = _gamma_table(_reciprocal(gamma))
        from_1 = _gamma_table(_reciprocal(_reciprocal(gamma)))
        out = from_1[(rc * to_1[r] + gc * to_1[g] + bc * to_1[b] + 16384)
                     >> 15]
    return np.where(grey, r, out).astype(np.uint8)


def png_as_opencv(data: bytes, gray: bool) -> np.ndarray:
    """PNG bytes as ``cv2.imdecode`` gives them with ``IMREAD_GRAYSCALE``
    (``gray``) or ``IMREAD_UNCHANGED``: grey (H, W), colour BGR(A); None
    where cv2 gives None (a damaged file, module docstring)."""
    try:
        png = _Png(data, size_check=True)
    except PngError:
        return None  # OpenCV's PngDecoder gives false after libpng's error
    px = png.expanded()
    colour = px.shape[2] >= 3
    if gray:
        if colour:
            px = _libpng_gray(px[..., :3], png.gamma, png.sig_bit)
        else:
            px = px[..., 0]
        if px.dtype == np.uint16:
            px = (px >> 8).astype(np.uint8)
        o = orientation(png.exif) if png.exif is not None else 1
        return apply_orientation(px, o)
    if px.shape[2] == 1:
        return np.ascontiguousarray(px[..., 0])
    if px.shape[2] == 2:  # grey + alpha -> BGRA
        return np.ascontiguousarray(px[..., [0, 0, 0, 1]])
    alpha = png.rgb_alpha_from_trns(px)
    if alpha is not None:
        px = np.concatenate([px, alpha[..., None]], axis=2)
    return np.ascontiguousarray(px[..., [2, 1, 0, 3][:px.shape[2]]])


def to_gray(img: np.ndarray) -> np.ndarray:
    """RGB or RGBA -> grey, OpenCV's ``cvtColor`` rounding; a grey image
    passes through."""
    if img.ndim == 2:
        return img
    c = img[..., :3].astype(np.int64)
    g = (c[..., 0] * 9798 + c[..., 1] * 19235 + c[..., 2] * 3735
         + (1 << 14)) >> 15
    return g.astype(img.dtype)


def encode_png(img: np.ndarray) -> bytes:
    """(H, W) or (H, W, 3|4) uint8 -> PNG bytes (filter None)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png writes uint8, got {img.dtype}")
    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}[channels]
    rows = np.zeros((h, 1 + w * channels), np.uint8)
    rows[:, 1:] = img.reshape(h, w * channels)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))
