"""Image writers for tests and fixtures (numpy and ``zlib``): PNG of every
colour type and depth PNG allows, Adam7 interlacing, the five row filters
and any extra chunks, which neither ``cv2.imwrite`` nor Pillow writes all
of; EXIF orientation spliced into JPEG bytes; and WebP's RIFF chunks (VP8X,
ALPH, ANIM, ANMF, EXIF) assembled around bitstreams that cv2 or Pillow
wrote, for the variants neither writes; and libwebp's own encoder (the
shared library Pillow bundles, through ``ctypes``) for the encoder
settings neither cv2 nor Pillow exposes. For JPEG 2000: OpenJPEG's encoder
(Pillow's bundled ``libopenjp2``, through ``ctypes``) for the code-block
styles, tile-parts, POC, SOP/EPH, ROI, sub-sampling and offsets Pillow
does not expose; JP2 boxes written around a codestream; and patches of a
codestream's ``SIZ`` and ``COD`` fields. For JPEG: libjpeg-turbo's own
encoder and transcoder (Pillow's bundled ``libjpeg``, through a small C
shim built with the host compiler against ``jpeglib.h``) for lossless,
arithmetic-coded and DAC-conditioned files, which cv2 does not write; and
a lossless writer of its own for the sampling ratios, scan splits and
colour markers libjpeg's lossless encoder does not write. ``damage_ops``
damages a file on a seed (cuts, byte flips, zeroed runs), the same bytes
on every machine."""
import ctypes
import functools
import glob
import hashlib
import io
import os
import struct
import subprocess
import sys
import tempfile
import zlib

import numpy as np

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _rows(samples: np.ndarray, depth: int, filters) -> bytes:
    """(h, w, c) samples -> filtered scanlines, row y with filter
    ``filters[y % len(filters)]``."""
    h, w, c = samples.shape
    if depth == 16:
        data = samples.astype(">u2").view(np.uint8).reshape(h, w * c * 2)
    elif depth == 8:
        data = samples.reshape(h, w * c).astype(np.uint8)
    else:  # MSB first, the last byte zero-padded
        per = 8 // depth
        flat = samples.reshape(h, w * c).astype(np.uint8)
        flat = np.pad(flat, ((0, 0), (0, -flat.shape[1] % per)))
        flat = flat.reshape(h, -1, per)
        data = np.zeros(flat.shape[:2], np.uint8)
        for k in range(per):
            data |= flat[..., k] << (8 - depth * (k + 1))
    bpp = max(1, c * depth // 8)
    cur = data.astype(np.int32)
    out = bytearray()
    for y in range(h):
        f = filters[y % len(filters)]
        row = cur[y]
        a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        b = cur[y - 1] if y else np.zeros_like(row)
        cc = np.concatenate([np.zeros(bpp, np.int32), b[:-bpp]])
        pred = [0, a, b, (a + b) >> 1, _paeth(a, b, cc)][f]
        out.append(f)
        out += ((row - pred) & 0xFF).astype(np.uint8).tobytes()
    return bytes(out)


def write_png(samples: np.ndarray, depth: int, ctype: int,
              interlace: bool = False, palette=None, trns: bytes = None,
              before=(), after=(), filters=(0, 1, 2, 3, 4)) -> bytes:
    """Samples (h, w) or (h, w, c) in the file's channel order -> PNG
    bytes. ``before`` chunks go after IHDR, ``after`` ones after IDAT."""
    c = CHANNELS[ctype]
    h, w = samples.shape[:2]
    samples = samples.reshape(h, w, c)
    if interlace:
        raw = b"".join(
            _rows(samples[y0::dy, x0::dx], depth, filters)
            for x0, y0, dx, dy in ADAM7
            if samples[y0::dy, x0::dx].size)
    else:
        raw = _rows(samples, depth, filters)
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    out += b"".join(before)
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    out += chunk(b"IDAT", zlib.compress(raw, 9))
    out += b"".join(after)
    return out + chunk(b"IEND", b"")


def exif_tiff(orient: int, order: bytes = b"MM") -> bytes:
    """A TIFF body holding IFD0 with one Orientation (SHORT) entry."""
    e = "<" if order == b"II" else ">"
    return (order + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIH", 0x0112, 3, 1, orient) + b"\0\0"
            + struct.pack(e + "I", 0))


def with_exif_app1(jpeg: bytes, tiff: bytes) -> bytes:
    """JPEG bytes with an APP1 ``Exif`` segment after SOI (and after a JFIF
    APP0 where there is one)."""
    seg = b"Exif\0\0" + tiff
    app1 = b"\xff\xe1" + struct.pack(">H", len(seg) + 2) + seg
    at = 2
    if jpeg[2:4] == b"\xff\xe0":
        at = 4 + struct.unpack(">H", jpeg[4:6])[0]
    return jpeg[:at] + app1 + jpeg[at:]


# --- TIFF ------------------------------------------------------------------

_BIT_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                        np.uint8)
_TIFF_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "I", 6: "b", 7: "B", 8: "h",
               9: "i", 10: "i", 11: "f", 12: "d", 16: "Q"}


def lzw_encode(data: bytes, old: bool = False) -> bytes:
    """TIFF LZW as libtiff writes it: MSB-first codes, 9 to 12 bits, a
    wider code from the entry before each power of two ("early change"),
    or ``old``: the LSB-first codes of old libtiff, widened one entry
    later."""
    out = bytearray()
    acc = nacc = 0

    def emit(code):
        nonlocal acc, nacc
        if old:
            acc |= code << nacc
            nacc += width
            while nacc >= 8:
                out.append(acc & 0xFF)
                acc >>= 8
                nacc -= 8
        else:
            acc = (acc << width) | code
            nacc += width
            while nacc >= 8:
                nacc -= 8
                out.append((acc >> nacc) & 0xFF)
                acc &= (1 << nacc) - 1

    late = 1 if old else 0
    width, table, nxt = 9, {}, 258
    emit(256)
    prefix = -1

    def added():
        nonlocal width, table, nxt
        nxt += 1
        if nxt == 4094:
            emit(256)
            width, table, nxt = 9, {}, 258
        elif nxt > (1 << width) - 1 + late and width < 12:
            width += 1

    for c in data:
        if prefix < 0:
            prefix = c
            continue
        key = (prefix << 8) | c
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        table[key] = nxt
        prefix = c
        added()
    if prefix >= 0:
        emit(prefix)
        added()
    emit(257)
    if nacc:
        out.append(acc & 0xFF if old else (acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    """PackBits: runs of 2-128 equal bytes as (1 - n, byte), else literals
    of up to 128 bytes as (n - 1, bytes)."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i + 1
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 2:
            out += bytes([(257 - (j - i)) & 0xFF, data[i]])
            i = j
            continue
        j = i + 1
        while j < n and j - i < 128 and not (
                j + 1 < n and data[j] == data[j + 1]):
            j += 1
        out.append(j - i - 1)
        out += data[i:j]
        i = j
    return bytes(out)


def _pack_bits(samples: np.ndarray, bits: int) -> np.ndarray:
    """(h, n) samples of ``bits`` (not a multiple of 8) -> (h, ceil(n *
    bits / 8)) bytes, MSB first, each row from a byte boundary (TIFF 6.0,
    BitsPerSample)."""
    h, n = samples.shape
    shifts = np.arange(bits - 1, -1, -1)
    b = (samples.astype(np.int64)[..., None] >> shifts) & 1
    return np.packbits(b.reshape(h, n * bits).astype(np.uint8), axis=1)


# ITU-T T.4 Modified Huffman codes: (white, black) terminating codes for
# runs 0-63, make-up codes for 64-1728 and the shared ones for 1792-2560
_MH_TERM = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 "
    "001000 000011 110100 110101 101010 101011 0100111 0001100 0001000 "
    "0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 "
    "00000010 00000011 00011010 00011011 00010010 00010011 00010100 "
    "00010101 00010110 00010111 00101000 00101001 00101010 00101011 "
    "00101100 00101101 00000100 00000101 00001010 00001011 01010010 "
    "01010011 01010100 01010101 00100100 00100101 01011000 01011001 "
    "01011010 01011011 01001010 01001011 00110010 00110011 00110100",
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 "
    "0000111 00000100 00000111 000011000 0000010111 0000011000 0000001000 "
    "00001100111 00001101000 00001101100 00000110111 00000101000 "
    "00000010111 00000011000 000011001010 000011001011 000011001100 "
    "000011001101 000001101000 000001101001 000001101010 000001101011 "
    "000011010010 000011010011 000011010100 000011010101 000011010110 "
    "000011010111 000001101100 000001101101 000011011010 000011011011 "
    "000001010100 000001010101 000001010110 000001010111 000001100100 "
    "000001100101 000001010010 000001010011 000000100100 000000110111 "
    "000000111000 000000100111 000000101000 000001011000 000001011001 "
    "000000101011 000000101100 000001011010 000001100110 000001100111")
_MH_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 "
    "01101000 01100111 011001100 011001101 011010010 011010011 011010100 "
    "011010101 011010110 011010111 011011000 011011001 011011010 011011011 "
    "010011000 010011001 010011010 011000 010011011",
    "0000001111 000011001000 000011001001 000001011011 000000110011 "
    "000000110100 000000110101 0000001101100 0000001101101 0000001001010 "
    "0000001001011 0000001001100 0000001001101 0000001110010 "
    "0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 "
    "0000001010101 0000001011010 0000001011011 0000001100100 "
    "0000001100101")
_MH_EXTRA = ("00000001000 00000001100 00000001101 000000010010 000000010011 "
             "000000010100 000000010101 000000010110 000000010111 "
             "000000011100 000000011101 000000011110 000000011111").split()
_EOL = "000000000001"


def _mh_run(n: int, black: int) -> str:
    term, makeup = _MH_TERM[black].split(), _MH_MAKEUP[black].split()
    out = ""
    while n > 2560:
        out += _MH_EXTRA[-1]
        n -= 2560
    if n >= 64:
        m = n // 64
        out += makeup[m - 1] if m <= 27 else _MH_EXTRA[m - 28]
        n -= m * 64
    return out + term[n]


def mh_row(row: np.ndarray) -> str:
    """One row of 0 (white) / 1 (black) pixels -> its Modified Huffman code
    bits (white and black runs in turn, from white)."""
    bits, colour, x, w = "", 0, 0, len(row)
    while x < w:
        n = 0
        while x < w and row[x] == colour:
            n, x = n + 1, x + 1
        bits += _mh_run(n, colour)
        colour ^= 1
    return bits


def _bits_bytes(bits: str) -> bytes:
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


def ccitt_1d(rows: np.ndarray, scheme: int, eol: bool = True,
             fill: bool = False, rtc: bool = False) -> bytes:
    """(h, w) 0 / 1 pixels -> one strip or tile of CCITT 1-D data: scheme 2
    (RLE: each row byte-aligned), 32771 (RLEW: each row aligned to 16
    bits from the strip's start) or 3 (Group 3 1-D: an EOL before each row
    (``eol``), EOLs ending on a byte boundary (``fill``: T4Options bit 2),
    six EOLs at the end (``rtc``))."""
    if scheme in (2, 32771):
        out = b""
        for row in rows:
            out += _bits_bytes(mh_row(row))
            if scheme == 32771 and len(out) % 2:
                out += b"\0"
        return out
    bits = ""
    for row in rows:
        if eol:
            if fill:
                bits += "0" * (-(len(bits) + 12) % 8)
            bits += _EOL
        bits += mh_row(row)
    if rtc:
        bits += _EOL * 6
    return _bits_bytes(bits)


def _predict(block: np.ndarray, predictor: int, stride: int) -> bytes:
    """(rows, n) native samples -> differenced file bytes (predictor 2:
    per sample; 3: libtiff's floating-point byte planes, MSB first)."""
    rows = block.shape[0]
    if predictor == 2:
        d = block.copy()
        d[:, stride:] = block[:, stride:] - block[:, :-stride]
        return d
    bps = block.dtype.itemsize
    be = block.astype(block.dtype.newbyteorder(">")).view(np.uint8)
    be = be.reshape(rows, -1, bps).transpose(0, 2, 1).reshape(rows, -1)
    d = be.copy()
    d[:, stride:] = be[:, stride:] - be[:, :-stride]
    return d


def _ycbcr_units(block: np.ndarray, hs: int, vs: int) -> np.ndarray:
    """(rows, w, 3) Y, Cb, Cr -> rows of YCbCr data units (hs * vs Y, then
    the Cb and Cr of the unit's first pixel), the edges repeated."""
    rows, w = block.shape[:2]
    ur, uc = -(-rows // vs), -(-w // hs)
    full = np.pad(block, ((0, ur * vs - rows), (0, uc * hs - w), (0, 0)),
                  mode="edge")
    ys = full[..., 0].reshape(ur, vs, uc, hs).transpose(0, 2, 1, 3)
    units = np.concatenate([ys.reshape(ur, uc, vs * hs),
                            full[::vs, ::hs, 1:]], axis=2)
    return units.reshape(ur, -1)


def write_tiff(samples: np.ndarray, order: bytes = b"II",
               bigtiff: bool = False, photometric: int = None,
               compression: int = 1, predictor: int = 1, planar: int = 1,
               tile=None, rows_per_strip: int = None, bits: int = None,
               sample_format: int = None, extra_samples=None,
               colormap=None, orientation: int = None, extra_tags=(),
               lzw_old: bool = False, fill_order: int = 1,
               subsampling=None, omit=(), ccitt=None, strips=None) -> bytes:
    """Samples (h, w) or (h, w, c) -> TIFF bytes, the first IFD only.

    ``bits`` not a multiple of 8 (1-7, 10, 12, 14) packs the samples MSB
    first; ``tile`` (tw, th) writes tiles (edge tiles padded with zeros)
    instead of strips; ``compression`` 1 none, 2 / 32771 / 3 CCITT 1-D
    (1-bit samples, ``ccitt``: ``ccitt_1d``'s keywords), 5 LZW
    (``lzw_old``: the old LSB-first form), 8 / 32946 deflate, 32773
    PackBits; ``predictor`` 2 (integer) or 3 (floating point);
    ``fill_order`` 2 stores each byte's bits reversed; ``subsampling``
    (hs, vs) writes YCbCr samples as subsampled data units;
    ``extra_tags``: (tag, type, values) entries; ``omit``: tags left out;
    ``strips``: bytes written as the strips or tiles in place of the
    encoded samples (``samples`` then gives only the layout)."""
    e = "<" if order == b"II" else ">"
    h, w = samples.shape[:2]
    s = samples.reshape(h, w, -1)
    c = s.shape[2]
    dt = s.dtype
    bits = bits or dt.itemsize * 8
    if sample_format is None:
        sample_format = {"u": 1, "i": 2, "f": 3}[dt.kind]
    if photometric is None:
        photometric = 2 if c >= 3 else 1
    fdt = dt.newbyteorder(e)
    tw, th = tile if tile else (w, rows_per_strip or h)
    planes = [s] if planar == 1 else [s[..., k:k + 1] for k in range(c)]
    chunks = list(strips or [])
    for plane in planes if strips is None else []:
        pc = plane.shape[2]
        for y in range(0, h, th):
            for x in range(0, w, tw):
                block = plane[y:y + th, x:x + tw]
                if tile:
                    block = np.pad(block, ((0, th - block.shape[0]),
                                           (0, tw - block.shape[1]), (0, 0)))
                rows = block.shape[0]
                flat = block.reshape(rows, -1)
                if subsampling is not None:
                    flat = _ycbcr_units(block, *subsampling)
                    rows = flat.shape[0]
                if predictor in (2, 3):
                    flat = _predict(flat, predictor, pc)
                if compression in (2, 3, 32771):
                    raw = ccitt_1d(flat, compression, **(ccitt or {}))
                elif predictor == 3:
                    raw = np.ascontiguousarray(flat).tobytes()
                elif bits % 8:
                    raw = _pack_bits(flat, bits).tobytes()
                else:
                    raw = np.ascontiguousarray(flat.astype(fdt)).tobytes()
                if compression == 5:
                    raw = lzw_encode(raw, lzw_old)
                elif compression in (8, 32946):
                    raw = zlib.compress(raw)
                elif compression == 32773:
                    rb = len(raw) // rows
                    raw = b"".join(packbits_encode(raw[r * rb:(r + 1) * rb])
                                   for r in range(rows))
                if fill_order == 2:
                    raw = _BIT_REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
                chunks.append(raw)
    off_type = 16 if bigtiff else 4
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * c),
            259: (3, [compression]), 262: (3, [photometric]),
            277: (3, [c]), 284: (3, [planar]), 339: (3, [sample_format] * c)}
    if predictor != 1:
        tags[317] = (3, [predictor])
    if tile:
        tags[322], tags[323] = (4, [tw]), (4, [th])
    else:
        tags[278] = (4, [th])
    if extra_samples is not None:
        tags[338] = (3, list(extra_samples))
    if colormap is not None:
        tags[320] = (3, list(np.asarray(colormap, np.uint16).T.ravel()))
    if orientation is not None:
        tags[274] = (3, [orientation])
    if fill_order != 1:
        tags[266] = (3, [fill_order])
    if subsampling is not None:
        tags[530] = (3, list(subsampling))
    for tag, ftype, values in extra_tags:
        tags[tag] = (ftype, list(values))
    offsets_tag, counts_tag = (324, 325) if tile else (273, 279)
    tags[offsets_tag] = (off_type, [0] * len(chunks))
    tags[counts_tag] = (off_type, [len(b) for b in chunks])
    for tag in omit:
        tags.pop(tag, None)
    ent = 20 if bigtiff else 12
    cnt_fmt, val_size = ("Q", 8) if bigtiff else ("I", 4)
    head = 16 if bigtiff else 8
    ifd_len = (8 if bigtiff else 2) + ent * len(tags) + val_size
    data_at = head + ifd_len
    blobs = bytearray()
    blob_at = {}
    for tag, (ftype, values) in sorted(tags.items()):
        size = struct.calcsize(_TIFF_TYPES[ftype]) * len(values)
        if size > val_size:
            blob_at[tag] = data_at + len(blobs)
            blobs += b"\0" * (size + (size & 1))
    pix_at = data_at + len(blobs)
    offs, pos = [], pix_at
    for b in chunks:
        offs.append(pos)
        pos += len(b)
    if offsets_tag in tags:
        tags[offsets_tag] = (off_type, offs)
    ifd = bytearray(struct.pack(e + ("Q" if bigtiff else "H"), len(tags)))
    for tag, (ftype, values) in sorted(tags.items()):
        payload = struct.pack(e + str(len(values)) + _TIFF_TYPES[ftype],
                              *values)
        ifd += struct.pack(e + "HH" + cnt_fmt, tag, ftype,
                           len(values) // (2 if ftype in (5, 10) else 1))
        if tag in blob_at:
            ifd += struct.pack(e + cnt_fmt, blob_at[tag])
            at = blob_at[tag] - data_at
            blobs[at:at + len(payload)] = payload
        else:
            ifd += payload.ljust(val_size, b"\0")
    ifd += b"\0" * val_size
    if bigtiff:
        header = order + struct.pack(e + "HHHQ", 43, 8, 0, head)
    else:
        header = order + struct.pack(e + "HI", 42, head)
    return bytes(header + ifd + blobs) + b"".join(chunks)


_PILLOW_TIFF = """
import io, sys, numpy as np
from PIL import Image
a = np.load(io.BytesIO(sys.stdin.buffer.read()))
kw = eval(sys.argv[2])
im = Image.fromarray(a, sys.argv[1] or None) if sys.argv[1] != "1" else \\
    Image.fromarray(a.astype(bool))
b = io.BytesIO()
im.save(b, "TIFF", **kw)
sys.stdout.buffer.write(b.getvalue())
"""


def pillow_tiff(img: np.ndarray, mode: str = "", **save) -> bytes:
    """``img`` saved as TIFF by Pillow's libtiff (``save``: Pillow's TIFF
    keywords, e.g. ``compression="group4"``, ``tiffinfo={tag: value}``;
    ``mode`` "1" for a bilevel image of ``img != 0``, else Pillow's mode or
    "" for its default). Run in a subprocess: Pillow's libtiff and cv2's
    cannot share one process."""
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(img))
    return subprocess.run(
        [sys.executable, "-c", _PILLOW_TIFF, mode, repr(save)],
        input=buf.getvalue(), check=True, capture_output=True,
        timeout=120).stdout


# --- ThunderScan -----------------------------------------------------------

def thunder_encode(rows: np.ndarray, raw_only: bool = False) -> bytes:
    """(h, w) 4-bit pixels -> ThunderScan codes, each row on its own (as
    libtiff decodes them): runs of the last pixel, three 2-bit or two 3-bit
    deltas from it, raw pixels otherwise (``raw_only``: every pixel raw)."""
    out = bytearray()
    for row in np.asarray(rows, np.int64):
        last, i, w = 0, 0, len(row)
        while i < w:
            if raw_only:
                out.append(0xC0 | int(row[i]))
                last, i = int(row[i]), i + 1
                continue
            run = 0
            while i + run < w and run < 63 and row[i + run] == last:
                run += 1
            if run >= 2 and i % 2 == 0:
                out.append(run)
                i += run
                continue
            d = [int(v) - p for v, p in zip(row[i:i + 3],
                                              [last] + list(row[i:i + 2]))]
            if len(d) == 3 and all(v in (-1, 0, 1) for v in d):
                code = {0: 0, 1: 1, -1: 3}
                out.append(0x40 | code[d[0]] << 4 | code[d[1]] << 2
                           | code[d[2]])
                last, i = int(row[i + 2]), i + 3
                continue
            if len(d) >= 2 and all(-3 <= v <= 3 for v in d[:2]):
                code = {0: 0, 1: 1, 2: 2, 3: 3, -3: 5, -2: 6, -1: 7}
                out.append(0x80 | code[d[0]] << 3 | code[d[1]])
                last, i = int(row[i + 1]), i + 2
                continue
            out.append(0xC0 | int(row[i]))
            last, i = int(row[i]), i + 1
    return bytes(out)


# --- GIF -------------------------------------------------------------------

def _sgilog_rle(plane: np.ndarray) -> bytes:
    """One byte plane of an SGILog row as ``tif_luv.c`` reads it: a run
    byte ``128 + n - 2`` then the value (n 2 to 129), or a count byte
    n < 128 then n literal bytes."""
    out, i, n = bytearray(), 0, len(plane)
    v = plane.tolist()
    while i < n:
        j = i
        while j < n and v[j] == v[i] and j - i < 129:
            j += 1
        if j - i >= 3:
            out += bytes([128 + j - i - 2, v[i]])
            i = j
            continue
        k = i
        while k < n and k - i < 127 and not (
                k + 2 < n and v[k] == v[k + 1] == v[k + 2]):
            k += 1
        out += bytes([k - i]) + bytes(v[i:k])
        i = k
    return bytes(out)


def sgilog_encode(codes: np.ndarray, kind: str) -> bytes:
    """A strip of SGILog codes (rows x pixels): ``kind`` "L16" (16-bit
    LogL codes, each row's high bytes then low bytes, run-length coded),
    "Luv32" (32-bit LogLuv codes, four byte planes a row from the highest)
    or "Luv24" (24-bit LogLuv codes packed in 3 bytes, no runs)."""
    c = np.asarray(codes).astype(np.int64) & 0xFFFFFFFF
    if kind == "Luv24":
        return np.stack([(c >> 16) & 255, (c >> 8) & 255, c & 255],
                        -1).astype(np.uint8).tobytes()
    shifts = (8, 0) if kind == "L16" else (24, 16, 8, 0)
    return b"".join(_sgilog_rle(((row >> sh) & 255).astype(np.uint8))
                    for row in c for sh in shifts)


def gif_lzw_encode(indices: bytes, min_code_size: int) -> bytes:
    """GIF LZW: LSB-first codes from min_code_size + 1 bits, a clear code
    first and whenever the table fills, the end code last."""
    clear, eoi = 1 << min_code_size, (1 << min_code_size) + 1
    out = bytearray()
    acc = nacc = 0

    def emit(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += width
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    width, table, nxt = min_code_size + 1, {}, eoi + 1
    emit(clear)
    prefix = -1
    for c in indices:
        if prefix < 0:
            prefix = c
            continue
        key = (prefix << 8) | c
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        prefix = c
        if nxt < 4096:
            table[key] = nxt
            nxt += 1
            if nxt > (1 << width) and width < 12:
                width += 1
        else:
            emit(clear)
            width, table, nxt = min_code_size + 1, {}, eoi + 1
    if prefix >= 0:
        emit(prefix)
    emit(eoi)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\0"


def gif_frame(indices: np.ndarray, left: int = 0, top: int = 0,
              local_palette=None, interlace: bool = False,
              transparent: int = None, disposal: int = 0,
              min_code_size: int = None) -> bytes:
    """A graphic control extension (where ``transparent`` or ``disposal``
    is set) and an image descriptor with its (h, w) indices."""
    h, w = indices.shape
    out = b""
    if transparent is not None or disposal:
        flags = (disposal << 2) | (transparent is not None)
        out += b"\x21\xf9\x04" + struct.pack("<BHB", flags, 0,
                                             transparent or 0) + b"\0"
    flags = 0
    if local_palette is not None:
        pal = np.asarray(local_palette, np.uint8)
        bits = max(1, int(np.ceil(np.log2(len(pal)))))
        flags |= 0x80 | (bits - 1)
        pal = np.pad(pal, ((0, (1 << bits) - len(pal)), (0, 0)))
    if interlace:
        flags |= 0x40
        order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                                np.arange(2, h, 4), np.arange(1, h, 2)])
        indices = indices[order]
    out += b"\x2c" + struct.pack("<HHHHB", left, top, w, h, flags)
    if local_palette is not None:
        out += pal.tobytes()
    mcs = min_code_size or max(2, int(indices.max()).bit_length())
    return out + bytes([mcs]) + _sub_blocks(
        gif_lzw_encode(indices.astype(np.uint8).tobytes(), mcs))


def write_gif(screen, frames, global_palette=None, background: int = 0,
              version: bytes = b"89a", extensions=()) -> bytes:
    """A GIF of logical screen (h, w), ``frames`` from :func:`gif_frame`,
    a global colour table where given; ``extensions``: raw blocks before
    the first frame."""
    h, w = screen
    flags = 0
    pal = b""
    if global_palette is not None:
        gp = np.asarray(global_palette, np.uint8)
        bits = max(1, int(np.ceil(np.log2(len(gp)))))
        flags = 0x80 | 0x70 | (bits - 1)
        pal = np.pad(gp, ((0, (1 << bits) - len(gp)), (0, 0))).tobytes()
    return (b"GIF" + version + struct.pack("<HHBBB", w, h, flags, background,
                                           0)
            + pal + b"".join(extensions) + b"".join(frames) + b"\x3b")


# --- BMP -------------------------------------------------------------------

def bmp_rle_encode(idx: np.ndarray, rle4: bool) -> bytes:
    """(h, w) palette indices, the first row the file's first -> an RLE8
    or RLE4 stream: runs of equal pixels (pairs in RLE4) as encoded runs,
    others as absolute runs, an end-of-line after each row and an
    end-of-bitmap."""
    out = bytearray()
    for row in idx:
        row = [int(v) for v in row]
        x, w = 0, len(row)
        while x < w:
            if rle4:  # runs alternate two values: look for a repeating pair
                a = row[x]
                b = row[x + 1] if x + 1 < w else a
                n = 1
                while x + n < w and n < 255 and row[x + n] == (
                        a if n % 2 == 0 else b):
                    n += 1
                if n >= 4 or x + n == w:
                    out += bytes([n, (a << 4) | (b if n > 1 else 0)])
                    x += n
                    continue
                n = min(w - x, 255)
                n = max(3, min(n, 64)) if w - x >= 3 else n
                if n < 3:
                    out += bytes([n, (row[x] << 4) | (row[x + 1] if n > 1
                                                      else 0)])
                    x += n
                    continue
                lit = row[x:x + n] + [0]
                packed = bytes((lit[i] << 4) | lit[i + 1]
                               for i in range(0, n, 2))
                out += bytes([0, n]) + packed
                if len(packed) % 2:
                    out.append(0)
                x += n
            else:
                n = 1
                while x + n < w and n < 255 and row[x + n] == row[x]:
                    n += 1
                if n >= 2 or w - x < 3:
                    out += bytes([n, row[x]])
                    x += n
                    continue
                n = 3
                while x + n < w and n < 255 and row[x + n] != row[x + n - 1]:
                    n += 1
                out += bytes([0, n]) + bytes(row[x:x + n])
                if n % 2:
                    out.append(0)
                x += n
        out += b"\0\0"
    return bytes(out[:-2]) + b"\0\1"


def write_bmp(pixels: np.ndarray, bits: int, palette=None,
              header: int = 40, compression: int = 0,
              top_down: bool = False, masks=None, data: bytes = None,
              clr_used: int = None) -> bytes:
    """A BMP of (h, w) palette indices (bits 1-8), (h, w) 16-bit words or
    (h, w, 3|4) BGR(A) bytes, rows top first; ``header`` 12 (OS/2 core),
    40, 108 (V4) or 124 (V5); ``compression`` 1 / 2 (RLE8 / RLE4, ``data``
    the stream) or 3 (bitfields, ``masks`` (r, g, b[, a])); ``palette``
    (n, 3) RGB."""
    h, w = pixels.shape[:2]
    rows = pixels if top_down else pixels[::-1]
    if data is None:
        pitch = ((w * bits + 7) // 8 + 3) & ~3
        if bits < 8:
            packed = _pack_bits(rows.reshape(h, w), bits)
        elif bits == 16:
            packed = rows.astype("<u2").view(np.uint8).reshape(h, -1)
        else:
            packed = rows.reshape(h, -1).astype(np.uint8)
        data = np.pad(packed, ((0, 0), (0, pitch - packed.shape[1]))
                      ).tobytes()
    pal = b""
    if palette is not None:
        p = np.asarray(palette, np.uint8)[:, ::-1]
        if header == 12:
            pal = p.tobytes()
        else:
            pal = np.pad(p, ((0, 0), (0, 1))).tobytes()
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h,
                           1, bits, compression, len(data), 2835, 2835,
                           len(pal) // 4 if clr_used is None else clr_used,
                           0)
        extra = b""
        if masks is not None and header > 40:
            extra = struct.pack("<4I", *(list(masks) + [0])[:4])
        info = (info + extra).ljust(header, b"\0")
        if masks is not None and header == 40:
            info += struct.pack(f"<{len(masks)}I", *masks)
    off = 14 + len(info) + len(pal)
    return (b"BM" + struct.pack("<IHHI", off + len(data), 0, 0, off) + info
            + pal + data)


# --- Sun raster and Radiance -------------------------------------------------

def sun_rle_encode(data: bytes) -> bytes:
    """Sun raster byte encoding: runs of 3 or more as 0x80, n - 1, v; a lone
    0x80 as 0x80 0."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i + 1
        while j < n and j - i < 256 and data[j] == data[i]:
            j += 1
        if j - i >= 3 or (data[i] == 0x80 and j - i >= 2):
            out += bytes([0x80, j - i - 1, data[i]])
        else:
            for _ in range(j - i):
                out += b"\x80\x00" if data[i] == 0x80 else bytes([data[i]])
        i = j
    return bytes(out)


def write_sun(pixels: np.ndarray, bits: int, palette=None, kind: int = 1,
              rows: bytes = None) -> bytes:
    """A Sun raster of (h, w) indices or (h, w, 3|4) bytes in file order,
    ``kind`` 1 standard, 2 byte-encoded (RLE), 3 RGB; ``palette`` (n, 3)
    RGB as a RMT_EQUAL_RGB map; ``rows``: the raster bytes as given."""
    h, w = pixels.shape[:2]
    if rows is None:
        pitch = ((w * bits + 7) // 8 + 1) & ~1
        if bits == 1:
            packed = _pack_bits(pixels.reshape(h, w), 1)
        else:
            packed = pixels.reshape(h, -1).astype(np.uint8)
        rows = np.pad(packed, ((0, 0), (0, pitch - packed.shape[1])))
        rows = rows.tobytes()
        if kind == 2:
            rows = sun_rle_encode(rows)
    cmap = b"" if palette is None else np.asarray(
        palette, np.uint8).T.tobytes()
    return (struct.pack(">8I", 0x59A66A95, w, h, bits, len(rows), kind,
                        1 if palette is not None else 0, len(cmap))
            + cmap + rows)


def hdr_rle_line(rgbe: np.ndarray) -> bytes:
    """One (w, 4) RGBE scanline in the new run-length form."""
    w = rgbe.shape[0]
    out = bytearray([2, 2, w >> 8, w & 0xFF])
    for c in range(4):
        plane = rgbe[:, c].tobytes()
        i = 0
        while i < w:
            j = i + 1
            while j < w and j - i < 127 and plane[j] == plane[i]:
                j += 1
            if j - i >= 3:
                out += bytes([128 + j - i, plane[i]])
                i = j
                continue
            j = i + 1
            while j < w and j - i < 128 and not (
                    j + 2 < w and plane[j] == plane[j + 1] == plane[j + 2]):
                j += 1
            out += bytes([j - i]) + plane[i:j]
            i = j
    return bytes(out)


HDR_HEADER = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"


def write_hdr(rgbe: np.ndarray, rle: bool = True,
              header: bytes = HDR_HEADER) -> bytes:
    """A Radiance file of (h, w, 4) RGBE bytes, scanlines run-length coded
    (``rle``) or flat."""
    h, w = rgbe.shape[:2]
    body = b"".join(hdr_rle_line(r) for r in rgbe) if rle else rgbe.tobytes()
    return header + b"-Y %d +X %d\n" % (h, w) + body


# -- WebP: RIFF chunks around bitstreams cv2 or Pillow wrote ----------------

def webp_chunk(tag: bytes, payload: bytes) -> bytes:
    """A RIFF chunk, padded to an even size."""
    body = tag + struct.pack("<I", len(payload)) + payload
    return body + (b"\0" if len(payload) & 1 else b"")


def webp_riff(chunks) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def webp_chunks(data: bytes):
    """The (tag, payload) chunks of a RIFF WebP file."""
    out, at = [], 12
    while at + 8 <= len(data):
        tag, n = data[at:at + 4], struct.unpack("<I", data[at + 4:at + 8])[0]
        out.append((tag, data[at + 8:at + 8 + n]))
        at += 8 + n + (n & 1)
    return out


def webp_vp8x(flags: int, width: int, height: int) -> bytes:
    """VP8X: flags (0x10 alpha, 0x08 EXIF, 0x02 animation) and canvas."""
    return webp_chunk(b"VP8X", struct.pack("<I", flags)
                      + (width - 1).to_bytes(3, "little")
                      + (height - 1).to_bytes(3, "little"))


def webp_anim(background: int = 0xffffffff, loops: int = 0) -> bytes:
    return webp_chunk(b"ANIM", struct.pack("<IH", background, loops))


def webp_anmf(x: int, y: int, width: int, height: int, frame: bytes,
              duration: int = 100, bits: int = 0) -> bytes:
    """ANMF: an (even) offset, the frame's size, blend / dispose ``bits``
    and the frame's ALPH / VP8 / VP8L chunks."""
    return webp_chunk(b"ANMF", (x // 2).to_bytes(3, "little")
                      + (y // 2).to_bytes(3, "little")
                      + (width - 1).to_bytes(3, "little")
                      + (height - 1).to_bytes(3, "little")
                      + duration.to_bytes(3, "little") + bytes([bits])
                      + frame)


# libwebp 1.x's WebPConfig fields (ints at these byte offsets) that
# libwebp_encode sets; WebPPicture's width, height, writer and custom_ptr
_WEBP_CONFIG = {"lossless": 0, "method": 8, "segments": 24,
                "sns_strength": 28, "filter_strength": 32,
                "filter_sharpness": 36, "filter_type": 40, "autofilter": 44,
                "alpha_compression": 48, "alpha_filtering": 52,
                "alpha_quality": 56, "pass": 60, "preprocessing": 68,
                "partitions": 72, "exact": 96}
_WEBP_ABI = 0x0210  # the encoder ABI of libwebp 1.5 and 1.6


def _libwebp() -> ctypes.CDLL:
    import PIL

    libs = os.path.join(os.path.dirname(PIL.__file__), os.pardir,
                        "pillow.libs")
    for dep in glob.glob(os.path.join(libs, "libsharpyuv-*.so*")):
        ctypes.CDLL(dep, mode=ctypes.RTLD_GLOBAL)
    found = glob.glob(os.path.join(libs, "libwebp-*.so*"))
    if not found:
        raise RuntimeError(f"no libwebp beside Pillow in {libs}")
    return ctypes.CDLL(found[0])


def libwebp_encode(img: np.ndarray, quality: float = 75.0, **config
                   ) -> bytes:
    """An (h, w, 3) RGB or (h, w, 4) RGBA uint8 image as libwebp's
    ``WebPEncode`` writes it with ``config``'s WebPConfig fields (filter
    type, strength and sharpness, token partitions, segments, alpha
    compression and filtering...), a RIFF file."""
    lib = _libwebp()
    cfg = (ctypes.c_uint8 * 512)()
    if not lib.WebPConfigInitInternal(cfg, 0, ctypes.c_float(quality),
                                      _WEBP_ABI):
        raise RuntimeError("WebPConfigInit failed")
    fields = np.frombuffer(cfg, np.int32)
    for name, value in config.items():
        fields[_WEBP_CONFIG[name] // 4] = value
    if not lib.WebPValidateConfig(cfg):
        raise ValueError(f"libwebp refuses the config {config}")
    pic = (ctypes.c_uint8 * 1024)()
    if not lib.WebPPictureInitInternal(pic, _WEBP_ABI):
        raise RuntimeError("WebPPictureInit failed")
    h, w, c = img.shape
    np.frombuffer(pic, np.int32)[2:4] = (w, h)
    px = np.ascontiguousarray(img, np.uint8)
    imp = lib.WebPPictureImportRGBA if c == 4 else lib.WebPPictureImportRGB
    writer = (ctypes.c_uint8 * 64)()
    lib.WebPMemoryWriterInit(writer)
    try:
        if not imp(pic, px.ctypes.data_as(ctypes.c_void_p), w * c):
            raise RuntimeError("WebPPictureImport failed")
        ctypes.c_void_p.from_buffer(pic, 96).value = ctypes.cast(
            lib.WebPMemoryWrite, ctypes.c_void_p).value
        ctypes.c_void_p.from_buffer(pic, 104).value = ctypes.addressof(writer)
        if not lib.WebPEncode(cfg, pic):
            raise RuntimeError(f"WebPEncode failed with {config}")
        return ctypes.string_at(ctypes.c_void_p.from_buffer(writer, 0).value,
                                ctypes.c_size_t.from_buffer(writer, 8).value)
    finally:
        lib.WebPMemoryWriterClear(writer)
        lib.WebPPictureFree(pic)


# -- JPEG 2000 ----------------------------------------------------------------

def _libopenjp2() -> ctypes.CDLL:
    import PIL

    libs = os.path.join(os.path.dirname(PIL.__file__), os.pardir,
                        "pillow.libs")
    found = glob.glob(os.path.join(libs, "libopenjp2-*.so*"))
    if not found:
        raise RuntimeError(f"no libopenjp2 beside Pillow in {libs}")
    lib = ctypes.CDLL(found[0])
    vp = ctypes.c_void_p
    lib.opj_image_create.restype = vp
    lib.opj_image_create.argtypes = [ctypes.c_uint32, vp, ctypes.c_int]
    lib.opj_create_compress.restype = vp
    lib.opj_create_compress.argtypes = [ctypes.c_int]
    lib.opj_setup_encoder.argtypes = [vp, vp, vp]
    lib.opj_stream_create_default_file_stream.restype = vp
    lib.opj_stream_create_default_file_stream.argtypes = [ctypes.c_char_p,
                                                          ctypes.c_int]
    for name in ("opj_start_compress",):
        getattr(lib, name).argtypes = [vp, vp, vp]
    lib.opj_encode.argtypes = [vp, vp]
    lib.opj_end_compress.argtypes = [vp, vp]
    lib.opj_stream_destroy.argtypes = [vp]
    lib.opj_destroy_codec.argtypes = [vp]
    lib.opj_image_destroy.argtypes = [vp]
    lib.opj_set_default_encoder_parameters.argtypes = [vp]
    return lib


class _OpjImageComp(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in
                ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd",
                 "resno_decoded", "factor")] + [
        ("data", ctypes.POINTER(ctypes.c_int32)), ("alpha", ctypes.c_uint16)]


class _OpjImage(ctypes.Structure):
    _fields_ = [("x0", ctypes.c_uint32), ("y0", ctypes.c_uint32),
                ("x1", ctypes.c_uint32), ("y1", ctypes.c_uint32),
                ("numcomps", ctypes.c_uint32), ("color_space", ctypes.c_int),
                ("comps", ctypes.POINTER(_OpjImageComp)),
                ("icc_profile_buf", ctypes.c_void_p),
                ("icc_profile_len", ctypes.c_uint32)]


_PROGRESSIONS = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}
_POC_SIZE = 148  # sizeof(opj_poc_t) in OpenJPEG 2.5


def _opj_offsets(raw: bytes) -> dict:
    """Byte offsets of the opj_cparameters_t fields openjpeg_encode sets,
    found in the defaults opj_set_default_encoder_parameters writes
    (numresolution 6, code-blocks 64 x 64, roi_compno -1; sub-sampling 1,
    formats -1) and the layout of what follows the formats (the JPWL
    fields, cinema, sizes and profile, then the tile-part chars)."""
    ints = np.frombuffer(raw[:len(raw) // 4 * 4], np.int32)
    key = np.array([6, 64, 64, 0, 0, -1, 0, 0], np.int32)
    at = [i for i in range(len(ints) - 8) if (ints[i:i + 8] == key).all()]
    if len(at) != 1:
        raise RuntimeError("opj_cparameters_t layout not recognised")
    numres = at[0]
    key2 = np.array([0, 0, 1, 1, -1, -1], np.int32)
    at2 = [i for i in range(numres + 74, len(ints) - 6)
           if (ints[i:i + 6] == key2).all()]
    if not at2:
        raise RuntimeError("opj_cparameters_t layout not recognised")
    sub = at2[0]
    mct = 4 * (sub + 127) + 2
    poc = 56
    if 4 * (numres - 202) != poc + 32 * _POC_SIZE:
        raise RuntimeError("opj_poc_t layout not recognised")
    return {"tile_size_on": 0, "cp_tx0": 4, "cp_ty0": 8, "cp_tdx": 12,
            "cp_tdy": 16, "cp_disto_alloc": 20, "csty": 48,
            "prog_order": 52, "POC": poc, "numpocs": 4 * (numres - 202),
            "tcp_numlayers": 4 * (numres - 201),
            "tcp_rates": 4 * (numres - 200), "numresolution": 4 * numres,
            "cblockw_init": 4 * numres + 4, "cblockh_init": 4 * numres + 8,
            "mode": 4 * numres + 12, "irreversible": 4 * numres + 16,
            "roi_compno": 4 * numres + 20, "roi_shift": 4 * numres + 24,
            "res_spec": 4 * numres + 28, "prcw_init": 4 * numres + 32,
            "prch_init": 4 * numres + 32 + 4 * 33,
            "image_offset_x0": 4 * sub, "image_offset_y0": 4 * sub + 4,
            "subsampling_dx": 4 * sub + 8, "subsampling_dy": 4 * sub + 12,
            "tp_on": mct - 2, "tp_flag": mct - 1, "tcp_mct": mct}


def openjpeg_encode(img: np.ndarray, *, jp2: bool = False, prec: int = 8,
                    sgnd: bool = False, colour_space: int = 0,
                    irreversible: bool = False, numres: int = 6,
                    cblk=(64, 64), mode: int = 0, rates=(0.0,),
                    progression: str = "LRCP", precincts=None, tiles=None,
                    tile_parts=None, sop: bool = False, eph: bool = False,
                    roi=None, pocs=(), subsampling=(1, 1), offset=(0, 0),
                    mct=None) -> bytes:
    """(h, w) or (h, w, c) samples as OpenJPEG's encoder writes them: a raw
    J2K codestream, or a JP2 file (``jp2``; ``colour_space`` is
    OpenJPEG's OPJ_CLRSPC_*). ``mode`` is the code-block style (1 bypass,
    2 reset, 4 termall, 8 vertically causal, 16 predictable termination,
    32 segmentation symbols); ``rates`` one compression ratio a quality
    layer (0: lossless); ``precincts`` (w, h) exponents from the top
    resolution down; ``tiles`` (w, h); ``tile_parts`` "R", "L" or "C" (a
    tile-part per resolution, layer or component); ``roi`` (component,
    shift); ``pocs`` (tile, res0, comp0, lay1, res1, comp1, progression)
    each; ``subsampling`` and ``offset`` the grid's (dx, dy) and (x0, y0)."""
    import tempfile

    lib = _libopenjp2()
    raw = (ctypes.c_uint8 * 65536)()
    lib.opj_set_default_encoder_parameters(raw)
    off = _opj_offsets(bytes(raw))
    fields = np.frombuffer(raw, np.uint8)

    def put(name, value, index=0):
        struct.pack_into("<i", raw, off[name] + 4 * index, int(value))

    def putf(name, value, index=0):
        struct.pack_into("<f", raw, off[name] + 4 * index, float(value))

    planes = img[..., None] if img.ndim == 2 else img
    h, w, nc = planes.shape
    dx, dy = subsampling
    x0, y0 = offset
    put("tcp_numlayers", len(rates))
    for i, r in enumerate(rates):
        putf("tcp_rates", r, i)
    put("cp_disto_alloc", 1)
    put("numresolution", numres)
    put("cblockw_init", cblk[0])
    put("cblockh_init", cblk[1])
    put("mode", mode)
    put("irreversible", int(irreversible))
    put("prog_order", _PROGRESSIONS[progression])
    put("csty", (2 if sop else 0) | (4 if eph else 0))
    if precincts:
        put("csty", ((2 if sop else 0) | (4 if eph else 0)) | 1)
        put("res_spec", len(precincts))
        for i, (pw, ph) in enumerate(precincts):
            put("prcw_init", 1 << pw, i)
            put("prch_init", 1 << ph, i)
    if tiles:
        put("tile_size_on", 1)
        put("cp_tdx", tiles[0])
        put("cp_tdy", tiles[1])
        put("cp_tx0", x0 if len(tiles) < 3 else tiles[2])
        put("cp_ty0", y0 if len(tiles) < 3 else tiles[3])
    if tile_parts:
        fields[off["tp_on"]] = 1
        fields[off["tp_flag"]] = ord(tile_parts)
    fields[off["tcp_mct"]] = (nc >= 3) if mct is None else mct
    if roi:
        put("roi_compno", roi[0])
        put("roi_shift", roi[1])
    put("image_offset_x0", x0)
    put("image_offset_y0", y0)
    put("subsampling_dx", dx)
    put("subsampling_dy", dy)
    if pocs:
        put("numpocs", len(pocs))
        for i, (tile, r0, c0, l1, r1, c1, prg) in enumerate(pocs):
            base = off["POC"] + i * _POC_SIZE
            struct.pack_into("<5I", raw, base, r0, c0, l1, r1, c1)
            struct.pack_into("<i", raw, base + 32, _PROGRESSIONS[prg])
            struct.pack_into("<I", raw, base + 48, tile)
    parms = (ctypes.c_uint32 * (9 * nc))()
    for c in range(nc):
        parms[9 * c:9 * c + 9] = [dx, dy, w, h, x0, y0, prec, prec,
                                  int(sgnd)]
    image = lib.opj_image_create(nc, parms, colour_space)
    if not image:
        raise RuntimeError("opj_image_create failed")
    im = _OpjImage.from_address(image)
    im.x0, im.y0 = x0, y0
    im.x1, im.y1 = x0 + (w - 1) * dx + 1, y0 + (h - 1) * dy + 1
    for c in range(nc):
        comp = im.comps[c]
        cw = -(-im.x1 // dx) - (-(-x0 // dx))
        ch = -(-im.y1 // dy) - (-(-y0 // dy))
        comp.w, comp.h = cw, ch
        comp.x0, comp.y0 = -(-x0 // dx), -(-y0 // dy)
        src = np.ascontiguousarray(planes[:ch, :cw, c], np.int32)
        ctypes.memmove(comp.data, src.ctypes.data, src.nbytes)
    codec = lib.opj_create_compress(2 if jp2 else 0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "out.jp2").encode()
        try:
            if not lib.opj_setup_encoder(codec, raw, image):
                raise ValueError("opj_setup_encoder refuses the parameters")
            stream = lib.opj_stream_create_default_file_stream(path, 0)
            try:
                ok = (lib.opj_start_compress(codec, image, stream)
                      and lib.opj_encode(codec, stream)
                      and lib.opj_end_compress(codec, stream))
            finally:
                lib.opj_stream_destroy(stream)
            if not ok:
                raise ValueError("OpenJPEG's encoder failed")
        finally:
            lib.opj_destroy_codec(codec)
            lib.opj_image_destroy(image)
        with open(path, "rb") as f:
            return f.read()


def jp2_box(kind: bytes, body: bytes, length=None) -> bytes:
    """A JP2 box: its length (``length`` overrides it: 0 runs to the end,
    1 writes an XLBox), type and body."""
    if length == 1:
        return (struct.pack(">I", 1) + kind + struct.pack(">Q", 16 + len(body))
                + body)
    n = 8 + len(body) if length is None else length
    return struct.pack(">I", n) + kind + body


def jp2_ihdr(h: int, w: int, nc: int, bpc: int) -> bytes:
    return jp2_box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc, 7, 0, 0))


def jp2_colr(enumcs: int = None, icc: bytes = None) -> bytes:
    if icc is not None:
        return jp2_box(b"colr", bytes([2, 0, 0]) + icc)
    return jp2_box(b"colr", bytes([1, 0, 0]) + struct.pack(">I", enumcs))


def jp2_pclr(entries: np.ndarray, sizes, signs=None) -> bytes:
    """entries (n, channels) and each channel's bit depth."""
    n, nch = entries.shape
    signs = signs or [0] * nch
    body = struct.pack(">HB", n, nch) + bytes(
        (s - 1) | (0x80 if g else 0) for s, g in zip(sizes, signs))
    for row in entries:
        for v, s in zip(row, sizes):
            k = min((s + 7) // 8, 4)
            body += int(v).to_bytes(k, "big")
    return jp2_box(b"pclr", body)


def jp2_cmap(maps) -> bytes:
    """(cmp, mtyp, pcol) each."""
    return jp2_box(b"cmap", b"".join(struct.pack(">HBB", *m) for m in maps))


def jp2_cdef(defs) -> bytes:
    """(cn, typ, asoc) each."""
    return jp2_box(b"cdef", struct.pack(">H", len(defs)) + b"".join(
        struct.pack(">HHH", *d) for d in defs))


JP2_SIGNATURE_BOX = jp2_box(b"jP  ", b"\r\n\x87\n")
JP2_FTYP_BOX = jp2_box(b"ftyp", b"jp2 \0\0\0\0jp2 ")


def jp2_wrap(codestream: bytes, header_boxes, before=(), after=(),
             jp2c_length=None) -> bytes:
    """A JP2 file: signature, ftyp, ``before`` boxes, a jp2h of
    ``header_boxes``, ``after`` boxes and the codestream box."""
    return (JP2_SIGNATURE_BOX + JP2_FTYP_BOX + b"".join(before)
            + jp2_box(b"jp2h", b"".join(header_boxes)) + b"".join(after)
            + jp2_box(b"jp2c", codestream, jp2c_length))


def j2k_codestream(data: bytes) -> bytes:
    """The codestream of a JP2 file (its jp2c box's body to the end), or
    the bytes of a raw codestream."""
    at = data.find(b"jp2c")
    return data[at + 4:] if data[:2] != b"\xff\x4f" and at >= 4 else data


def j2k_marker(cs: bytes, marker: int) -> int:
    """The offset of the first marker segment ``marker`` in the main
    header (walking segment lengths from SIZ)."""
    at = 2
    while at + 4 <= len(cs):
        m, n = struct.unpack(">HH", cs[at:at + 4])
        if m == marker:
            return at
        if m == 0xff90:
            break
        at += 2 + n
    raise KeyError(hex(marker))


def j2k_patch_precision(cs: bytes, prec: int, sgnd: bool = False) -> bytes:
    """Every component's Ssiz set to ``prec`` bits."""
    at = j2k_marker(cs, 0xff51)
    nc = struct.unpack(">H", cs[at + 38:at + 40])[0]
    out = bytearray(cs)
    for c in range(nc):
        out[at + 40 + 3 * c] = (prec - 1) | (0x80 if sgnd else 0)
    return bytes(out)


def j2k_patch_cod(cs: bytes, style=None, progression=None,
                  mct=None) -> bytes:
    """COD's code-block style byte, progression order or MCT set."""
    at = j2k_marker(cs, 0xff52)
    out = bytearray(cs)
    if progression is not None:
        out[at + 5] = progression
    if mct is not None:
        out[at + 8] = mct
    if style is not None:
        out[at + 12] = style
    return bytes(out)


def j2k_with_coc(cs: bytes, comp: int, qmfbid: int) -> bytes:
    """A COC marker for component ``comp`` in the main header: COD's
    coding style and SPcod with the wavelet set to ``qmfbid`` (1: 5/3,
    0: 9/7), which the decoder then applies to that component's data."""
    at = j2k_marker(cs, 0xff52)
    n = struct.unpack(">H", cs[at + 2:at + 4])[0]
    body = cs[at + 4:at + 2 + n]
    spcod = body[5:]
    spcoc = spcod[:4] + bytes([qmfbid]) + spcod[5:]
    return j2k_insert(cs, j2k_segment(0xff53, bytes([comp, body[0] & 1])
                                      + spcoc))


def j2k_insert(cs: bytes, segment: bytes, before: int = 0xff90) -> bytes:
    """A marker segment inserted in the main header before ``before``
    (the first tile-part by default)."""
    at = j2k_marker(cs, before) if before != 0xff90 else cs.index(
        b"\xff\x90", 2)
    return cs[:at] + segment + cs[at:]


def j2k_segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", marker, 2 + len(body)) + body


class _Bits:
    """A packet-header bit reader: after a 0xFF byte, 7 bits."""

    def __init__(self, data: bytes, at: int):
        self.data, self.at, self.buf, self.ct = data, at, 0, 0

    def bit(self) -> int:
        if self.ct == 0:
            self.buf = (self.buf << 8) & 0xffff
            self.ct = 7 if self.buf == 0xff00 else 8
            if self.at < len(self.data):
                self.buf |= self.data[self.at]
                self.at += 1
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self) -> int:
        if (self.buf & 0xff) == 0xff:
            self.bit()
            self.ct = 0
        self.ct = 0
        return self.at


class _TagTree:
    def __init__(self, w: int, h: int):
        self.parent, self.value, self.low = [], [], []
        sizes, n = [], None
        while n != 1:
            sizes.append((w, h))
            n = w * h
            w, h = (w + 1) // 2, (h + 1) // 2
        offs = np.cumsum([0] + [a * b for a, b in sizes]).tolist()
        for lvl, (lw, lh) in enumerate(sizes):
            for y in range(lh):
                for x in range(lw):
                    up = -1 if lvl + 1 == len(sizes) else (
                        offs[lvl + 1] + (y // 2) * sizes[lvl + 1][0] + x // 2)
                    self.parent.append(up)
        self.value = [999] * len(self.parent)
        self.low = [0] * len(self.parent)

    def decode(self, bits: _Bits, leaf: int, threshold: int) -> bool:
        path, node = [], leaf
        while self.parent[node] >= 0:
            path.append(node)
            node = self.parent[node]
        low = 0
        while True:
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold and low < self.value[node]:
                if bits.bit():
                    self.value[node] = low
                else:
                    low += 1
            self.low[node] = low
            if not path:
                break
            node = path.pop()
        return self.value[node] < threshold


def j2k_packets(cs: bytes) -> tuple:
    """A raw codestream whose tiles each come in one tile-part (LRCP or
    RLCP, one precinct a resolution, code-block style 0, no SOP / EPH) cut
    into (main header, [(the tile-part's SOT..SOD bytes, [(packet header,
    packet body)] in stream order)], EOC and after): its packet headers
    read as Annex B reads them (tag trees, passes, Lblock, one codeword
    segment a code-block)."""
    siz = j2k_marker(cs, 0xff51)
    w, h, x0, y0, tdx, tdy, tx0, ty0 = struct.unpack(">8I",
                                                     cs[siz + 6:siz + 38])
    nc = struct.unpack(">H", cs[siz + 38:siz + 40])[0]
    cod = j2k_marker(cs, 0xff52)
    scod, prg, layers, _mct, levels, cbw, cbh, style = struct.unpack(
        ">BBHBBBBB", cs[cod + 4:cod + 13])
    if scod or prg not in (0, 1) or style or x0 or y0:
        raise ValueError("j2k_packets: LRCP / RLCP, no precincts, style 0")
    nres = levels + 1
    tw = -(-(w - tx0) // tdx)

    def ceil_pow2(a, b):
        return -(-a // (1 << b))

    def blocks(t0, t1, lev, xb, e):
        """Code-blocks along one axis of a band: (count) or 0 if empty."""
        b0 = ceil_pow2(t0 - (xb << lev), lev + 1) if lev >= 0 else t0
        b1 = ceil_pow2(t1 - (xb << lev), lev + 1) if lev >= 0 else t1
        if b1 <= b0:
            return 0
        return ceil_pow2(b1, e) - (b0 >> e)

    parts, at = [], cs.index(b"\xff\x90\x00\x0a")
    head = cs[:at]
    while cs[at:at + 2] == b"\xff\x90":
        isot, psot, tpsot, tnsot = struct.unpack(">HIBB", cs[at + 4:at + 12])
        if tpsot != 0 or tnsot not in (0, 1):
            raise ValueError("j2k_packets: one tile-part a tile")
        sod = cs.index(b"\xff\x93", at) + 2
        px, py = isot % tw, isot // tw
        x0t, x1t = max(tx0 + px * tdx, 0), min(tx0 + (px + 1) * tdx, w)
        y0t, y1t = max(ty0 + py * tdy, 0), min(ty0 + (py + 1) * tdy, h)
        state = {}
        for r in range(nres):
            lev = nres - 1 - r
            if r == 0:
                e = (min(cbw + 2, 15), min(cbh + 2, 15))
                dims = [(blocks(ceil_pow2(x0t, lev), ceil_pow2(x1t, lev),
                                -1, 0, e[0]),
                         blocks(ceil_pow2(y0t, lev), ceil_pow2(y1t, lev),
                                -1, 0, e[1]))]
            else:
                e = (min(cbw + 2, 14), min(cbh + 2, 14))
                dims = [(blocks(x0t, x1t, lev, xb, e[0]),
                         blocks(y0t, y1t, lev, yb, e[1]))
                        for xb, yb in ((1, 0), (0, 1), (1, 1))]
            for c in range(nc):  # (inclusion, zero bit-planes, blocks)
                state[r, c] = [(_TagTree(cw, ch), _TagTree(cw, ch),
                                [[False, 3] for _ in range(cw * ch)])
                               for cw, ch in dims if cw and ch]
        order = ([(l, r, c) for l in range(layers) for r in range(nres)
                  for c in range(nc)] if prg == 0 else
                 [(l, r, c) for r in range(nres) for l in range(layers)
                  for c in range(nc)])
        packets, pos = [], sod
        for l, r, c in order:
            bits = _Bits(cs, pos)
            lengths = []
            if bits.bit():
                for incl, imsb, blks in state[r, c]:
                    for k, blk in enumerate(blks):
                        if not blk[0]:
                            inc = incl.decode(bits, k, l + 1)
                        else:
                            inc = bits.bit()
                        if not inc:
                            continue
                        if not blk[0]:
                            i = 0
                            while not imsb.decode(bits, k, i):
                                i += 1
                            blk[0] = True
                        if not bits.bit():
                            passes = 1
                        elif not bits.bit():
                            passes = 2
                        else:
                            n = bits.read(2)
                            if n != 3:
                                passes = 3 + n
                            else:
                                n = bits.read(5)
                                passes = (6 + n if n != 31
                                          else 37 + bits.read(7))
                        while bits.bit():
                            blk[1] += 1
                        lengths.append(bits.read(
                            blk[1] + int(np.floor(np.log2(passes)))))
            head_end = bits.align()
            body_end = head_end + sum(lengths)
            packets.append((cs[pos:head_end], cs[head_end:body_end]))
            pos = body_end
        if pos != at + psot:
            raise ValueError(f"j2k_packets: packets end at {pos}, not "
                             f"{at + psot}")
        parts.append((cs[at:sod], packets))
        at += psot
    return head, parts, cs[at:]


def _split(data: bytes, parts: int) -> list:
    step = -(-len(data) // parts) if data else 1
    return [data[i:i + step] for i in range(0, max(len(data), 1), step)]


def j2k_with_ppt(cs: bytes, markers: int = 1) -> bytes:
    """``cs`` (see ``j2k_packets``) with each tile-part's packet headers
    moved into PPT markers in its header (``markers`` of them, Zppt 0,
    1...)."""
    head, parts, tail = j2k_packets(cs)
    out = head
    for tph, packets in parts:
        headers = b"".join(p[0] for p in packets)
        ppt = b"".join(j2k_segment(0xff61, bytes([z]) + chunk)
                       for z, chunk in enumerate(_split(headers, markers)))
        body = b"".join(p[1] for p in packets)
        sot = bytearray(tph[:-2] + ppt + tph[-2:])
        sot[6:10] = struct.pack(">I", len(sot) + len(body))
        out += bytes(sot) + body
    return out + tail


def j2k_with_ppm(cs: bytes, markers: int = 1) -> bytes:
    """``cs`` (see ``j2k_packets``) with its packet headers moved into PPM
    markers in the main header: one Nppm / Ippm pair a tile-part in stream
    order, the run cut over ``markers`` markers (Zppm 0, 1...)."""
    head, parts, tail = j2k_packets(cs)
    data, out = b"", b""
    for tph, packets in parts:
        headers = b"".join(p[0] for p in packets)
        data += struct.pack(">I", len(headers)) + headers
        body = b"".join(p[1] for p in packets)
        sot = bytearray(tph)
        sot[6:10] = struct.pack(">I", len(sot) + len(body))
        out += bytes(sot) + body
    ppm = b"".join(j2k_segment(0xff60, bytes([z]) + chunk)
                   for z, chunk in enumerate(_split(data, markers)))
    return head + ppm + out + tail



# -- JPEG: libjpeg-turbo's encoder, and a lossless writer -------------------

# libjpeg's colour spaces (J_COLOR_SPACE)
JCS_GRAYSCALE, JCS_RGB, JCS_YCBCR, JCS_CMYK, JCS_YCCK = 1, 2, 3, 4, 5

_LIBJPEG_SHIM = r"""
#include <setjmp.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>

/* libjpeg-turbo 3 entry points that an older jpeglib.h does not declare */
void jpeg_enable_lossless(j_compress_ptr cinfo, int psv, int pt);
JDIMENSION jpeg12_write_scanlines(j_compress_ptr cinfo, short **rows,
                                  JDIMENSION n);
JDIMENSION jpeg16_write_scanlines(j_compress_ptr cinfo,
                                  unsigned short **rows, JDIMENSION n);

struct err {
  struct jpeg_error_mgr pub;
  jmp_buf jb;
  char *msg;
};

static void on_error(j_common_ptr c) {
  struct err *e = (struct err *)c->err;
  (*c->err->format_message)(c, e->msg);
  longjmp(e->jb, 1);
}

static void quiet(j_common_ptr c) { (void)c; }

static void conditioning(j_compress_ptr c, const int *cond) {
  if (!cond) return;
  for (int t = 0; t < 2; t++) {
    c->arith_dc_L[t] = (UINT8)cond[3 * t];
    c->arith_dc_U[t] = (UINT8)cond[3 * t + 1];
    c->arith_ac_K[t] = (UINT8)cond[3 * t + 2];
  }
}

/* px: h rows of w * nc samples, uint8 (precision <= 8) or uint16 */
int wj_encode(const void *px, int h, int w, int nc, int in_space,
              int jpeg_space, int precision, int quality, int psv, int pt,
              int restart_interval, int restart_rows, int arith,
              int progressive, int optimize, const int *samp,
              const int *cond, unsigned char **out, unsigned long *outlen,
              char *msg) {
  struct jpeg_compress_struct c;
  struct err e;
  void *volatile row = NULL;
  c.err = jpeg_std_error(&e.pub);
  e.pub.error_exit = on_error;
  e.pub.output_message = quiet;
  e.msg = msg;
  *out = NULL;
  *outlen = 0;
  if (setjmp(e.jb)) {
    jpeg_destroy_compress(&c);
    free(row);
    return 1;
  }
  jpeg_create_compress(&c);
  jpeg_mem_dest(&c, out, outlen);
  c.image_width = (JDIMENSION)w;
  c.image_height = (JDIMENSION)h;
  c.input_components = nc;
  c.in_color_space = (J_COLOR_SPACE)in_space;
  c.data_precision = precision;
  jpeg_set_defaults(&c);
  c.data_precision = precision;
  jpeg_set_colorspace(&c, (J_COLOR_SPACE)jpeg_space);
  if (psv > 0)
    jpeg_enable_lossless(&c, psv, pt);
  else
    jpeg_set_quality(&c, quality, TRUE);
  if (samp)
    for (int i = 0; i < c.num_components; i++) {
      c.comp_info[i].h_samp_factor = samp[2 * i];
      c.comp_info[i].v_samp_factor = samp[2 * i + 1];
    }
  c.restart_interval = (unsigned)restart_interval;
  c.restart_in_rows = restart_rows;
  c.arith_code = arith ? TRUE : FALSE;
  c.optimize_coding = optimize ? TRUE : FALSE;
  conditioning(&c, cond);
  if (progressive) jpeg_simple_progression(&c);
  jpeg_start_compress(&c, TRUE);
  size_t n = (size_t)w * nc;
  row = malloc(n * 2 + 16);
  while (c.next_scanline < c.image_height) {
    size_t y = c.next_scanline;
    if (precision <= 8) {
      JSAMPROW r = (JSAMPROW)((const unsigned char *)px + y * n);
      jpeg_write_scanlines(&c, &r, 1);
    } else if (precision <= 12) {
      short *r = (short *)row;
      const unsigned short *s = (const unsigned short *)px + y * n;
      for (size_t i = 0; i < n; i++) r[i] = (short)s[i];
      jpeg12_write_scanlines(&c, &r, 1);
    } else {
      unsigned short *r = (unsigned short *)px + y * n;
      jpeg16_write_scanlines(&c, &r, 1);
    }
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  free(row);
  return 0;
}

/* jpegtran's lossless transcode: the same quantised coefficients with the
   entropy coding, progression and restarts chosen here; APPn and COM
   markers copied as "jpegtran -copy all" copies them */
int wj_transcode(const unsigned char *in, unsigned long n, int arith,
                 int progressive, int optimize, int restart_interval,
                 int restart_rows, const int *cond, unsigned char **out,
                 unsigned long *outlen, char *msg) {
  struct jpeg_decompress_struct d;
  struct jpeg_compress_struct c;
  struct err e;
  d.err = jpeg_std_error(&e.pub);
  c.err = d.err;
  e.pub.error_exit = on_error;
  e.pub.output_message = quiet;
  e.msg = msg;
  *out = NULL;
  *outlen = 0;
  jpeg_create_decompress(&d);
  jpeg_create_compress(&c);
  if (setjmp(e.jb)) {
    jpeg_destroy_compress(&c);
    jpeg_destroy_decompress(&d);
    return 1;
  }
  jpeg_mem_src(&d, in, n);
  jpeg_save_markers(&d, JPEG_COM, 0xFFFF);
  for (int m = 0; m < 16; m++) jpeg_save_markers(&d, JPEG_APP0 + m, 0xFFFF);
  jpeg_read_header(&d, TRUE);
  jvirt_barray_ptr *coefs = jpeg_read_coefficients(&d);
  jpeg_mem_dest(&c, out, outlen);
  jpeg_copy_critical_parameters(&d, &c);
  c.arith_code = arith ? TRUE : FALSE;
  c.optimize_coding = optimize ? TRUE : FALSE;
  c.restart_interval = (unsigned)restart_interval;
  c.restart_in_rows = restart_rows;
  conditioning(&c, cond);
  if (progressive) jpeg_simple_progression(&c);
  jpeg_write_coefficients(&c, coefs);
  for (jpeg_saved_marker_ptr m = d.marker_list; m; m = m->next) {
    if (c.write_JFIF_header && m->marker == JPEG_APP0 &&
        m->data_length >= 5 && !memcmp(m->data, "JFIF", 5))
      continue;
    if (c.write_Adobe_marker && m->marker == JPEG_APP0 + 14 &&
        m->data_length >= 5 && !memcmp(m->data, "Adobe", 5))
      continue;
    jpeg_write_marker(&c, m->marker, m->data, m->data_length);
  }
  jpeg_finish_compress(&c);
  jpeg_finish_decompress(&d);
  jpeg_destroy_compress(&c);
  jpeg_destroy_decompress(&d);
  return 0;
}

void wj_free(void *p) { free(p); }
"""


@functools.lru_cache(maxsize=None)
def _libjpeg_writer() -> ctypes.CDLL:
    """The shim over Pillow's bundled libjpeg-turbo, built once into the
    temporary directory (keyed by its source and the library's name)."""
    import PIL

    libs = os.path.abspath(os.path.join(os.path.dirname(PIL.__file__),
                                        os.pardir, "pillow.libs"))
    found = glob.glob(os.path.join(libs, "libjpeg-*.so*"))
    if not found:
        raise RuntimeError(f"no libjpeg beside Pillow in {libs}")
    name = os.path.basename(found[0])
    key = hashlib.sha256((_LIBJPEG_SHIM + name).encode()).hexdigest()[:16]
    path = os.path.join(tempfile.gettempdir(), f"gisnav_libjpeg_writer_"
                                               f"{key}.so")
    if not os.path.exists(path):
        with tempfile.TemporaryDirectory() as tmp:
            src = os.path.join(tmp, "shim.c")
            with open(src, "w") as f:
                f.write(_LIBJPEG_SHIM)
            out = os.path.join(tmp, "shim.so")
            subprocess.run([os.environ.get("CC", "gcc"), "-shared", "-fPIC",
                            "-O2", src, "-o", out, f"-L{libs}", f"-l:{name}",
                            f"-Wl,-rpath,{libs}"], check=True,
                           capture_output=True)
            os.replace(out, path)
    lib = ctypes.CDLL(path)
    vp, i = ctypes.c_void_p, ctypes.c_int
    ret = [vp, ctypes.POINTER(vp), ctypes.POINTER(ctypes.c_ulong),
           ctypes.c_char_p]
    lib.wj_encode.argtypes = [vp] + [i] * 14 + [vp] + ret
    lib.wj_transcode.argtypes = [ctypes.c_char_p, ctypes.c_ulong] + [i] * 5 \
        + ret
    lib.wj_free.argtypes = [vp]
    return lib


def _libjpeg_call(fn, *args) -> bytes:
    lib = _libjpeg_writer()
    out, n = ctypes.c_void_p(), ctypes.c_ulong()
    msg = ctypes.create_string_buffer(200)
    rc = fn(*args, ctypes.byref(out), ctypes.byref(n), msg)
    try:
        if rc:
            raise ValueError(f"libjpeg: {msg.value.decode()}")
        return ctypes.string_at(out.value, n.value)
    finally:
        if out.value:
            lib.wj_free(out)


def _conditioning(cond):
    """(L, U, Kx) of arithmetic tables 0 and 1 -> the shim's int[6]."""
    return None if cond is None else (ctypes.c_int * 6)(*np.ravel(cond))


def libjpeg_encode(img: np.ndarray, *, quality: int = 75, lossless=None,
                   pt: int = 0, precision: int = 8, restart: int = 0,
                   restart_rows: int = 0, arith: bool = False,
                   progressive: bool = False, optimize: bool = False,
                   sampling=None, conditioning=None, in_space=None,
                   jpeg_space=None) -> bytes:
    """(h, w[, c]) samples (uint8, or uint16 above 8 bits of precision),
    RGB / CMYK in that order, as libjpeg-turbo's encoder writes them:
    ``lossless`` a predictor 1-7 (with point transform ``pt``, 2 to 16
    bits; libjpeg keeps the input colour space and 1x1 sampling), else DCT
    at ``quality``; ``arith`` arithmetic coding with DAC ``conditioning``
    ((L, U, Kx) of tables 0 and 1); ``restart`` MCUs or ``restart_rows``
    MCU rows; ``sampling`` (h, v) a component."""
    img = np.ascontiguousarray(img, np.uint8 if precision <= 8
                               else np.uint16)
    h, w = img.shape[:2]
    nc = 1 if img.ndim == 2 else img.shape[2]
    in_space = in_space or {1: JCS_GRAYSCALE, 3: JCS_RGB, 4: JCS_CMYK}[nc]
    jpeg_space = jpeg_space or {1: JCS_GRAYSCALE, 3: JCS_YCBCR,
                                4: JCS_CMYK}[nc]
    samp = None if sampling is None else (ctypes.c_int * 8)(
        *np.ravel(sampling))
    lib = _libjpeg_writer()
    return _libjpeg_call(lib.wj_encode, img.ctypes.data, h, w, nc, in_space,
                         jpeg_space, precision, quality, lossless or 0, pt,
                         restart, restart_rows, int(arith), int(progressive),
                         int(optimize), samp, _conditioning(conditioning))


def libjpeg_transcode(data: bytes, *, arith: bool = True,
                      progressive: bool = False, optimize: bool = False,
                      restart: int = 0, restart_rows: int = 0,
                      conditioning=None) -> bytes:
    """A DCT JPEG rewritten with the same quantised coefficients (jpegtran):
    arithmetic-coded (DAC ``conditioning`` as ``libjpeg_encode``'s) or
    Huffman, sequential or ``progressive`` (``jpeg_simple_progression``),
    restarts every ``restart`` MCUs or ``restart_rows`` MCU rows, its APPn
    and COM segments copied."""
    lib = _libjpeg_writer()
    return _libjpeg_call(lib.wj_transcode, bytes(data), len(data),
                         int(arith), int(progressive), int(optimize),
                         restart, restart_rows, _conditioning(conditioning))


def _categories(diffs: np.ndarray):
    """Lossless differences (mod 2^16) -> (category, its extra bits, their
    number): H.1.2.2's SSSS, 16 for 32768 with no extra bits."""
    d = np.asarray(diffs, np.int64).ravel() & 0xFFFF
    s = np.where(d >= 32768, d - 65536, d)
    mag = np.abs(s)
    size = np.zeros(s.shape, np.int64)
    for b in range(16):
        size += mag >= (1 << b)
    size = np.where(s == -32768, 16, size)
    nbits = np.where(size == 16, 0, size)
    return size, np.where(s > 0, s, s - 1) & ((1 << nbits) - 1), nbits


def _optimal_table(freq) -> tuple:
    """jchuff.c jpeg_gen_optimal_table: (counts of codes of length 1..16,
    symbols) for symbol frequencies, lengths limited to 16, no all-ones
    code."""
    freq = [int(f) for f in freq] + [0] * (257 - len(freq))
    freq[256] = 1  # the reserved all-ones code
    size, others = [0] * 257, [-1] * 257
    while True:
        live = [i for i in range(257) if freq[i]]
        c1 = min(live, key=lambda i: (freq[i], -i))
        rest = [i for i in live if i != c1]
        if not rest:
            break
        c2 = min(rest, key=lambda i: (freq[i], -i))
        freq[c1] += freq[c2]
        freq[c2] = 0
        for c in (c1, c2):
            size[c] += 1
            while others[c] >= 0:
                c = others[c]
                size[c] += 1
        c = c1
        while others[c] >= 0:
            c = others[c]
        others[c] = c2
    bits = [0] * 33
    for n in size:
        if n:
            bits[n] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1
    symbols = [s for n in range(1, 33) for s in range(256) if size[s] == n]
    return bits[1:17], symbols


def _lossless_segment(diffs: np.ndarray, codes: np.ndarray,
                      lengths: np.ndarray) -> bytes:
    """An entropy-coded segment of lossless differences (in stream order):
    each category's Huffman code (``codes`` / ``lengths`` by category),
    then its extra bits; 0xFF stuffed, padded with ones."""
    size, extra, nbits = _categories(diffs)
    code = (codes[size] << nbits) | extra
    length = lengths[size] + nbits
    end = np.cumsum(length)
    total = int(end[-1]) if len(end) else 0
    bits = np.ones(-(-total // 8) * 8, np.uint8)  # padding ones
    start = end - length
    for j in range(int(length.max(initial=0))):
        on = length > j
        bits[start[on] + j] = (code[on] >> (length[on] - 1 - j)) & 1
    out = np.packbits(bits)
    return np.insert(out, np.flatnonzero(out == 0xFF) + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def lossless_jpeg(planes, sampling, *, size=None, psv: int = 1,
                  pt: int = 0, precision: int = 8, restart_rows: int = 0,
                  scans=None, ids=None, jfif: bool = False,
                  adobe=None) -> bytes:
    """A lossless (SOF3) JPEG of ``planes``, one (hib, wib) array of
    samples a component at its own size (``sampling`` (h, v) each; the
    image's (height, width) ``size``, by default the largest the planes
    cover), as libjpeg-turbo decodes it: predictor ``psv``, point transform
    ``pt`` (the planes' samples are shifted down by it), a restart every
    ``restart_rows`` MCU rows, ``scans`` the component indices of each scan
    (default one interleaved scan), component ``ids``, a JFIF APP0 or an
    Adobe APP14 with transform ``adobe``. One Huffman table, optimal for
    the file's differences (jchuff.c's method). Differences follow libjpeg's
    decoder (jddiffct.c / jdlossls.c): the 1-D first row after the scan's
    start and after an iMCU row that held a restart."""
    nc = len(planes)
    max_h = max(h for h, _ in sampling)
    max_v = max(v for _, v in sampling)
    height, width = size or (
        max(-(-p.shape[0] * max_v // v) for p, (_, v) in zip(planes,
                                                              sampling)),
        max(-(-p.shape[1] * max_h // h) for p, (h, _) in zip(planes,
                                                             sampling)))
    ids = ids or list(range(1, nc + 1))
    out = b"\xff\xd8"
    if jfif:
        out += _segment(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    if adobe is not None:
        out += _segment(0xEE, b"Adobe\0\x64\0\0\0\0" + bytes([adobe]))
    out += _segment(0xC3, struct.pack(">BHHB", precision, height, width, nc)
                    + b"".join(bytes([ids[i], h << 4 | v, 0])
                               for i, (h, v) in enumerate(sampling)))
    mcus_x, mcus_y = -(-width // max_h), -(-height // max_v)
    init = 1 << (precision - pt - 1)

    def diffs(plane, first_rows):  # (rows, wib) differences, mod 2^16
        px = plane.astype(np.int64) >> pt
        a = np.pad(px, ((0, 0), (1, 0)))[:, :-1]
        b = np.pad(px, ((1, 0), (0, 0)))[:-1]
        c = np.pad(px, ((1, 0), (1, 0)))[:-1, :-1]
        pred = {1: a, 2: b, 3: c, 4: a + b - c, 5: a + ((b - c) >> 1),
                6: b + ((a - c) >> 1), 7: (a + b) >> 1}[psv].copy()
        pred[:, 0] = b[:, 0]
        first = sorted(first_rows)
        pred[first, 0] = init
        pred[first, 1:] = px[first, :-1]
        return (px - pred) & 0xFFFF

    coded = []  # (scan, its MCU rows' differences in stream order)
    for scan in scans or [list(range(nc))]:
        ns = len(scan)
        # the iMCU row of each MCU row: restarts reset the predictor for
        # the whole iMCU row they fall in (jddiffct.c undifferences after)
        v0 = sampling[scan[0]][1]
        imcu = (np.arange(mcus_y) if ns > 1
                else np.arange(planes[scan[0]].shape[0]) // v0)
        restarted = {int(imcu[k]) for k in range(len(imcu))
                     if restart_rows and k and k % restart_rows == 0}
        rows = []  # the MCU rows' differences in stream order
        for i in scan:
            h, v = sampling[i]
            first = {y for y in range(planes[i].shape[0])
                     if y == 0 or (y % v == 0 and y // v in restarted)}
            d = diffs(planes[i], first)
            if ns == 1:
                rows = list(d)
                continue
            pad = np.zeros((mcus_y * v, mcus_x * h), np.int64)
            pad[:d.shape[0], :d.shape[1]] = d
            rows.append(pad.reshape(mcus_y, v, mcus_x, h).transpose(
                0, 2, 1, 3).reshape(mcus_y, mcus_x, v * h))
        if ns > 1:
            rows = list(np.concatenate(rows, axis=2).reshape(mcus_y, -1))
        coded.append((scan, rows))
    # one table for every scan, optimal for these differences
    counts, symbols = _optimal_table(np.bincount(np.concatenate(
        [_categories(np.concatenate(r))[0] for _, r in coded]),
        minlength=17))
    out += _segment(0xC4, b"\x00" + bytes(counts) + bytes(symbols))
    codes, lengths = np.zeros(17, np.int64), np.zeros(17, np.int64)
    code, k = 0, 0
    for n, count in enumerate(counts, 1):
        for _ in range(count):
            codes[symbols[k]], lengths[symbols[k]] = code, n
            code, k = code + 1, k + 1
        code <<= 1
    for scan, rows in coded:
        ns = len(scan)
        per_row = mcus_x if ns > 1 else planes[scan[0]].shape[1]
        if restart_rows:
            out += _segment(0xDD, struct.pack(">H", restart_rows * per_row))
        out += _segment(0xDA, bytes([ns]) + b"".join(
            bytes([ids[i], 0]) for i in scan) + bytes([psv, 0, pt]))
        step = restart_rows or len(rows)
        for k in range(0, len(rows), step):
            if k:
                out += bytes([0xFF, 0xD0 + (k // step - 1) % 8])
            out += _lossless_segment(np.concatenate(rows[k:k + step]),
                                     codes, lengths)
    return out + b"\xff\xd9"


DAMAGE_SEED = 24
DAMAGE_CUTS = (25, 50, 75, 95, 99)  # per cent of the file kept
DAMAGE_FLIPS = 8  # single bytes XORed with a non-zero byte
DAMAGE_MULTI = 3  # runs of 4 bytes XORed
DAMAGE_ZEROED = 2  # runs of 8 bytes set to 0


def damage_ops(name: str, data: bytes) -> list:
    """Seeded damage of one file, keyed by its name: [(operation, bytes)]
    of cuts at ``DAMAGE_CUTS`` per cent, then ``DAMAGE_FLIPS`` single-byte
    flips, ``DAMAGE_MULTI`` 4-byte flips and ``DAMAGE_ZEROED`` zeroed
    8-byte runs. The operation's name holds its offsets and values, so
    ``damage_ops(name, data)`` remakes the same bytes anywhere (the
    committed digests hold these counts)."""
    rng = np.random.default_rng([DAMAGE_SEED, zlib.crc32(name.encode())])
    n = len(data)
    ops = [(f"cut{c}", data[:n * c // 100]) for c in DAMAGE_CUTS]
    for k, width, kind in ((DAMAGE_FLIPS, 1, "xor"), (DAMAGE_MULTI, 4, "xor"),
                           (DAMAGE_ZEROED, 8, "zero")):
        for _ in range(k):
            at = int(rng.integers(0, max(1, n - width)))
            if kind == "zero":
                vals = [0] * width
            else:
                vals = [int(v) for v in rng.integers(1, 256, width)]
            b = bytearray(data)
            for i, v in enumerate(vals):
                if at + i < n:
                    b[at + i] = 0 if kind == "zero" else b[at + i] ^ v
            ops.append((f"{kind}{at}_" + "".join(f"{v:02x}" for v in vals),
                        bytes(b)))
    return ops


DAMAGE_SETS = ("torch_images", "torch_webp", "torch_jp2", "torch_jpegx",
               "torch_tiffx", "torch_htj2k")
DAMAGE_MAX_BYTES = 200_000


def damage_fixtures(data_dir: str) -> dict:
    """The committed fixtures the damage sweep runs over: every file under
    ``DAMAGE_MAX_BYTES`` in ``DAMAGE_SETS`` (not their flights or
    digests), keyed "set/name"."""
    out = {}
    for sub in DAMAGE_SETS:
        folder = os.path.join(data_dir, sub)
        for name in sorted(os.listdir(folder)):
            path = os.path.join(folder, name)
            if name.endswith(".json") or not os.path.isfile(path) or \
                    os.path.getsize(path) >= DAMAGE_MAX_BYTES:
                continue
            with open(path, "rb") as f:
                out[f"{sub}/{name}"] = f.read()
    return out


def damage_digest(img) -> object:
    """One decode's outcome as the damage digests hold it: None, the word
    "raises" (``cv2.error`` / the port's size-limit ``ValueError``), or
    "sha256:shape:dtype" of the array's bytes."""
    if img is None or isinstance(img, str):
        return img
    a = np.ascontiguousarray(img)
    return (hashlib.sha256(a.tobytes()).hexdigest() + ":"
            + "x".join(str(n) for n in a.shape) + ":" + str(a.dtype))


def idat_flipped(png: bytes) -> bytes:
    """A PNG with the first byte of its first IDAT's data flipped: the
    chunk fails its CRC (libpng's error; cv2 gives None)."""
    at = png.index(b"IDAT") + 4
    return png[:at] + bytes([png[at] ^ 0x40]) + png[at + 1:]


def strip_corrupted(tiff: bytes) -> bytes:
    """A little-endian classic TIFF with the byte in the middle of its
    second strip's data inverted (the first strip stays whole): an LZW
    strip's decoder stops there (libtiff's RGBA reader keeps the rows
    before it, zeros after)."""
    ifd = struct.unpack_from("<I", tiff, 4)[0]
    fields = {}
    for i in range(struct.unpack_from("<H", tiff, ifd)[0]):
        tag, ftype, count, value = struct.unpack_from("<HHII", tiff,
                                                      ifd + 2 + 12 * i)
        size = {3: 2, 4: 4}[ftype] * count
        fmt = "<" + ("H" if ftype == 3 else "I") * count
        fields[tag] = struct.unpack_from(
            fmt, tiff, ifd + 10 + 12 * i if size <= 4 else value)
    at = fields[273][1] + fields[279][1] // 2
    return tiff[:at] + bytes([tiff[at] ^ 0xFF]) + tiff[at + 1:]


# ---------------------------------------------------------------------------
# HTJ2K (ITU-T T.814 | ISO/IEC 15444-15): a writer of HT codestreams, which
# neither cv2 nor Pillow writes (their OpenJPEG only decodes HT)

# The CxtVLC codewords of T.814 Annex C, 7 hex digits each: c_q (3 bits),
# rho (4), u_off (1), e_k (4), e_1 (4), the codeword (7 bits, the first
# read lowest) and its length (3); for the quads of a code-block's first
# row pair, then for the quads of the later ones
_HT_VLC_FIRST = (
    "008003400c45ff01000030148bff018008d01c8aff01cc4ff0200013025109e0280075"
    "02d111e02d447f030001e034037f038017f03c806e03c8a7f040002304621ee04800ee"
    "04c016e050000d05621ae0568bbf05801bf05c404e05c46bf06000f506710ae067212e"
    "06730bf068033f06c453f06d523f06f603f07003df0748a5f076a02e07791df07802df"
    "07e64df07eeb5f07f88ce07f9b9f07fc59f07fd14e07fd45f07fe1ce07ff15f0800002"
    "088007408c44ff090003409489de09800de09c01ee0a000540a5115e0a8005e0ad119e"
    "0ad47ff0b0009e0b4011e0b801ff0bc801e0bc8aff0c000140c620ee0c8016e0cc006e"
    "0d001ae0d620ae0d68b7f0d8017f0dc408e0dc467f0e0000d0e6212e0e7102e0e8007f"
    "0ec44bf0ed51ce0ef63bf0f001bf0f48abf0f6a0ce0f7933f0f8003f0fe213f0fe884e"
    "0fee14e0ff918e0ffc63f1000002108007410c44de110003411489ff118015e11c459e"
    "11ccbff1200054125105e128000d12d449e12d511e12d557f130001e13402ff13800ff"
    "13c8b7f13cc48e13dd1bf1400014146227f14801ee14c00ee150016e154006e158007f"
    "15c81ae15c8bbf16000ae165112e16722bf16800bf16e202e16f11ce16f473f170013f"
    "17480ce1748bdf178023f17c444e17cc83f17dd18e17fc54e17fe1df18000031880024"
    "18c45ee19000651948a7f19800ee19c442e19ccbff1a000b51a5116e1a800351ad446e"
    "1ad51ae1ad54d51b001ff1b512ff1b588ff1b8037f1bd90ae1bd997f1bdc52e1bdc87f"
    "1bdcfbf1c000551c6203f1c801ce1cc45bf1ce62bf1d000ce1d6214e1d688bf1d8033f"
    "1dc463f1dcc84e1dec53f1dee3df1e0018e1e5108e1e721df1e802df1ee64df1ef450e"
    "1ef500e1ef555f1ef625f1ef735f1f0005f1f5109f1f721f61f7899f1f7939f1f8029f"
    "1fea8761fee71f1ff991f1ffc4e51ffc9761ffce1f1ffd0151ffd4f61ffe0951fff01f"
    "2000002208007420c45ff210003421488de218015e21c89ee21cc7ff220005422512ff"
    "228005e22c019e230009e234011e23800ff23d001e23d137f240001424620ee248008e"
    "24c03bf250000d256896e256a06e256a97f258027f25c01ae25ec87f26000ae266212e"
    "26711bf26802bf26c402e26c443f27000bf27511ce27720ce2778b3f278013f27dc84e"
    "27ddbdf27e454e27e663f27ee18e27fd1df280000328800d528c47ff290005529488ee"
    "298016e29cc5ff29cc9ce29cceff2a000952a510ff2a8006e2ad11ae2ad477f2b000ae"
    "2b4892e2b5917f2b8027f2bd902e2bd9abf2bdc5bf2bdcbbf2bdcc7f2c000152c620ce"
    "2c801362ce20bf2ce473f2d000e52d6884e2d6a18e2d6a94e2d8013f2de608e2de643f"
    "2dec7df2dec90e2dece3f2e0000e2e621f62e711df2e802df2ee60f62ee675f2ef455f"
    "2ef51762ef54df2f0025f2f5985f2f788762f7929f2f7a1b62f7a99f2f7b39f2f8009f"
    "2fdd71f2fdd8b62fdde1f2ff641f2ffc4362ffc8252ffcfef2ffd0652ffe0a52ffe9ef"
    "2fff11f3000003308002430c441e3100065314886e31800d531cc4ee31cc96e31ccdee"
    "320005532511ff32801ae32c44ae32d53ff330012e3348aff33590ff338037f33d902e"
    "33d9a7f33dc5b633dcbbf33dcd7f3400095346207f34801ce34c45bf34e62bf35000ce"
    "354894e356a0bf358033f35e444e35e663f35ec98e35ee3df35ee93f360008e36711df"
    "367210e367303f36802df36d500e36d559f36f20df36f475f370015f374885f3778a5f"
    "377929f377a1f6377b39f378009f37d98f637ee71f37fa97637fc4e537fc81537fcc76"
    "37fd13637fd51f37fe03637ff0b63800095388002e38c47ff39001ce39489ff39802ff"
    "39cc57f39ccb7f39cccff3a0027f3a5107f3a802bf3ac44ce3ad53bf3b001bf3b4014e"
    "3b800bf3bd9b3f3bdc44e3bdca3f3bdcd3f3bdd03f3bdd4df3c003df3c621df3c802df"
    "3cc018e3d0029f3d4888e3d6a35f3d8015f3de665f3dec79f3dec90e3decc5f3dee09f"
    "3dee99f3e0031f3e6211f3e7121f3e8001f3ee67ef3ef440e3ef51f63ef56ef3ef60ef"
    "3ef71ef3f0036f3f5996f3f788f63f793af3f7a0763f7a86f3f7b26f3f800af3ffc404"
    "3ffc8643ffcc553ffd0443ffd4d53ffd9b63ffdeaf3ffe0243ffe5763ffe8153ffed2f"
    "3fff0b63fff5af3fffb2f3fffc35")
_HT_VLC_LATER = (
    "008000300c453e010003301488be018006d01c01de0200013025103e02800ad02c015e"
    "030000d03403ff03800ff03c00de0400023046202d04800cd04c009e050004d056205e"
    "05689ff05802ff05c019e060008d066211e067137f068007f06c001e070017f07501ee"
    "075127f07803bf07c40ee07c45bf0800001088002c08c47ff090004c09488ff09800ed"
    "09c45ff09ccaff0a0006d0a511bf0a8001e0ac037f0b0017f0b4027f0b8007f0bc03bf"
    "0c0000c0c620bf0c8005e0cc02bf0d0019e0d4033f0d8013f0dc015f0e0009e0e4023f"
    "0e8003f0ec03df0f001df0f402df0f800df0fd011e0fd135f1000001108004c10c47ff"
    "110000c114891e11801ee11c89ff11cc4ff12000ad12512ff128001e12c037f130017f"
    "134027f138007f13c00bf140002d14623bf14801bf14c02bf15000ee156896e156a33f"
    "156abdf158013f15c003f15eca3f160006e16401df16802df16c00df170035f175025f"
    "175115f178005f17d139f17d459f17dca9f17fe09f1800002188005418c445e1900014"
    "194891e198007519cc49e19cc99e19ccfff1a000b51a511ff1a8001e1ac45ee1ad50ff"
    "1b000ee1b402ff1b8016e1bd117f1bd44f61bdcb7f1c000351c6227f1c8006e1cc01ae"
    "1d000ae1d4892e1d6a07f1d8002e1de21ce1dec7bf1dec8ce1deccbf1e0014e1e4004e"
    "1e801bf1ed018e1ed12bf1f0033f1f5113f1f7223f1f78b5f1f8008e1fd983f1fdcfdf"
    "1fea2df1ffc5f61ffc90e1ffd15f1ffd4df1ffe00e1ffe9df2000001208006d20c47ff"
    "21000ad21489ff21802ff21c037f220004c225111e228019e22c00ff230009e234017f"
    "238027f23c02bf240000c246207f24803bf24c01bf25000ee25400bf258033f25c035f"
    "260002d267103f267223f267313f26803df26c01df27002df274801e27488df278015f"
    "27c465f27cc1ee27cc85f280000228800f528c45de290005529489ff29800de29c005e"
    "2a000142a5115e2a800752ad119e2ad47ff2b0009e2b4037f2b8011e2bc80ae2bc8aff"
    "2c000b52c6201e2c801ee2cc00ff2d000ee2d4016e2d8006e2dc41ae2dc467f2e00035"
    "2e5112e2e7217f2e8002e2ec47bf2ed51ce2ef607f2f000ce2f48abf2f6a00e2f791bf"
    "2f800d52fdd93f2fe64bf2ff573f2ffc54e2ffc90e2ffcc3f2ffd18e2ffe08e2ffea3f"
    "2fff04e3000003308001430c441e310006431489ee31800ee31c886e31cc7ff3200024"
    "325116e328005532d11ae32d457f33000ae33489ff33592ff338012e33c894e33cc4ff"
    "33dd37f34000b5346202e34801ce34c00ce3500035356884e356a27f356a87f3580076"
    "35c89bf35ea2bf35ec63f35ecbbf36000d5367113f367233f36730bf368018e36d13df"
    "36f21df36f455f36f503f370008e37510df377899f37792df377a10e377ab5f378000e"
    "37cce5f37dd85f37ee69f37fc51f37fc9f637fd17637fd49f37fe0f637feb9f37ff31f"
    "3800024388019e38c449e390011e3948bff398001e39c45ff39ccb7f3a0016e3a512ff"
    "3a800b53ac45ee3ad50ff3b000ee3b403bf3b800353bd127f3bdc46e3bdcabf3bdcc7f"
    "3bdd17f3c001ae3c621bf3c800ae3cc013f3d0012e3d4014e3d800d53dc473f3dcc82e"
    "3dec4bf3dee3df3e001ce3e400ce3e800653ec443f3ed504e3ef463f3ef60df3f0018e"
    "3f48adf3f6a1f63f789df3f7905f3f800033fdd90e3fee4f63ffc4153ffc8553ffcc8e"
    "3ffd0e53ffd5763ffdd5f3ffe0953ffe80e3ffee5f3fff0763ffff5f")
_HT_MEL_EXP = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5)


def ht_vlc_rows(first: bool) -> list:
    """The CxtVLC table as rows (c_q, rho, u_off, e_k, e_1, codeword,
    length), for the first row pair's quads or the later ones'."""
    text = _HT_VLC_FIRST if first else _HT_VLC_LATER
    rows = []
    for i in range(0, len(text), 7):
        v = int(text[i:i + 7], 16)
        rows.append((v >> 23, (v >> 19) & 15, (v >> 18) & 1, (v >> 14) & 15,
                     (v >> 10) & 15, (v >> 3) & 127, v & 7))
    return rows


@functools.lru_cache(maxsize=None)
def _ht_vlc_choice(first: bool) -> dict:
    """(c_q, rho, emb) -> (codeword, length, e_k, e_1): emb 0 takes the
    u_off 0 codeword; a non-zero emb (the samples at the quad's largest
    exponent, u_off 1) takes the codeword whose e_k covers most samples
    with e_1 equal to emb there (OpenJPH's choice)."""
    out, best = {}, {}
    for c, rho, u, ek, e1, cwd, n in ht_vlc_rows(first):
        if not u:
            out[c, rho, 0] = (cwd, n, 0, 0)
            continue
        for emb in range(1, 16):
            if emb & ~rho or (emb & ek) != e1:
                continue
            k = bin(ek).count("1")
            if k >= best.get((c, rho, emb), -1):
                best[c, rho, emb] = k
                out[c, rho, emb] = (cwd, n, ek, e1)
    return out


class _HtFwd:
    """A forward HT bit-stream (MagSgn, SigProp): bits from the lowest of
    each byte, 7 bits after a 0xFF byte."""

    def __init__(self):
        self.buf, self.tmp, self.used, self.max = bytearray(), 0, 0, 8

    def put(self, v: int, n: int):
        while n > 0:
            t = min(self.max - self.used, n)
            self.tmp |= (v & ((1 << t) - 1)) << self.used
            self.used += t
            v >>= t
            n -= t
            if self.used == self.max:
                self.buf.append(self.tmp)
                self.max = 7 if self.tmp == 0xFF else 8
                self.tmp = self.used = 0

    def end_ones(self) -> bytes:
        """MagSgn's end: the last byte padded with ones, dropped where it
        (or a whole last byte) is 0xFF, which the decoder's fill repeats."""
        if self.used:
            self.tmp |= (0xFF & ((1 << (self.max - self.used)) - 1)) \
                << self.used
            if self.tmp != 0xFF:
                self.buf.append(self.tmp)
        elif self.max == 7:
            self.buf.pop()
        return bytes(self.buf)

    def end_zeros(self) -> bytes:
        if self.used:
            self.buf.append(self.tmp)
        return bytes(self.buf)


class _HtRev:
    """A backward HT bit-stream (VLC, MagRef): bytes from the segment's end
    down, bits from the lowest, a byte after one over 0x8F holding 7 bits
    when those are all ones. VLC starts in the high nibble of the byte
    before the last (the last byte and that low nibble hold Scup)."""

    def __init__(self, vlc: bool):
        self.buf = bytearray([0xFF]) if vlc else bytearray()
        self.tmp, self.used, self.gt8f = (0xF, 4, True) if vlc else \
            (0, 0, True)

    def put(self, v: int, n: int):
        while n > 0:
            avail = 8 - self.gt8f - self.used
            t = min(avail, n)
            self.tmp |= (v & ((1 << t) - 1)) << self.used
            self.used += t
            avail -= t
            n -= t
            v >>= t
            if avail == 0:
                if self.gt8f and self.tmp != 0x7F:
                    self.gt8f = False
                    continue
                self.buf.append(self.tmp)
                self.gt8f = self.tmp > 0x8F
                self.tmp = self.used = 0

    def bits(self, bits):
        for b in bits:
            self.put(b, 1)

    def end(self) -> bytes:
        if self.used:
            self.buf.append(self.tmp)
        return bytes(self.buf[::-1])


class _HtMel:
    """The MEL coder (T.814 7.3.3): adaptive run lengths of quad events,
    bits from the highest of each byte, 7 bits after a 0xFF byte."""

    def __init__(self):
        self.buf, self.tmp, self.rem = bytearray(), 0, 8
        self.run, self.k, self.thr = 0, 0, 1

    def emit(self, v: int):
        self.tmp = (self.tmp << 1) | v
        self.rem -= 1
        if self.rem == 0:
            self.buf.append(self.tmp)
            self.rem = 7 if self.tmp == 0xFF else 8
            self.tmp = 0

    def event(self, bit: bool):
        if not bit:
            self.run += 1
            if self.run >= self.thr:
                self.emit(1)
                self.run = 0
                self.k = min(12, self.k + 1)
                self.thr = 1 << _HT_MEL_EXP[self.k]
            return
        self.emit(0)
        t = _HT_MEL_EXP[self.k]
        while t > 0:
            t -= 1
            self.emit((self.run >> t) & 1)
        self.run = 0
        self.k = max(0, self.k - 1)
        self.thr = 1 << _HT_MEL_EXP[self.k]


def _ht_mel_vlc_end(mel: _HtMel, vlc: _HtRev) -> bytes:
    """MEL and VLC closed where they meet, their last partial bytes fused
    into one where the bits allow (OpenJPH's ``terminate_mel_vlc``):
    MEL's bytes, then VLC's in stream order."""
    if mel.run > 0:
        mel.emit(1)
    mtmp = (mel.tmp << mel.rem) & 0xFF
    mel_mask = (0xFF << mel.rem) & 0xFF
    vlc_mask = 0xFF >> (8 - vlc.used)
    if mel_mask | vlc_mask:
        fuse = mtmp | vlc.tmp
        if ((((fuse ^ mtmp) & mel_mask) | ((fuse ^ vlc.tmp) & vlc_mask))
                == 0 and fuse != 0xFF and len(vlc.buf) > 1):
            mel.buf.append(fuse)
        else:
            mel.buf.append(mtmp)
            vlc.buf.append(vlc.tmp)
    return bytes(mel.buf) + bytes(vlc.buf[::-1])


def _ht_uvlc(d: int) -> tuple:
    """A u value's prefix bits and (suffix, its length) (T.814 Table 3)."""
    if d == 1:
        return (1,), (0, 0)
    if d == 2:
        return (0, 1), (0, 0)
    if d <= 4:
        return (0, 0, 1), (d - 3, 1)
    if d > 36:
        raise ValueError("ht: u over 36")
    return (0, 0, 0), (d - 5, 5)


def _ht_cleanup(mu: np.ndarray, neg: np.ndarray) -> bytes:
    """One code-block's HT cleanup segment (MagSgn, MEL, VLC; Scup in its
    last two bytes) of magnitudes ``mu`` and signs ``neg``."""
    h, w = mu.shape
    m = np.zeros((h + (h & 1), w + (w & 1)), np.int64)
    s = np.zeros_like(m)
    m[:h, :w] = mu
    s[:h, :w] = neg
    sig = m > 0
    # E: 1 + the bit length of mu - 1
    E = np.where(m > 1, np.floor(np.log2(np.maximum(m - 1, 1))).astype(
        np.int64) + 2, sig.astype(np.int64))

    def quads(a):
        return np.stack([a[0::2, 0::2], a[1::2, 0::2], a[0::2, 1::2],
                         a[1::2, 1::2]], -1)

    qm, qs, qE = quads(m).tolist(), quads(s).tolist(), quads(E).tolist()
    qsig = quads(sig.astype(np.int64))
    rho = (qsig * np.array([1, 2, 4, 8])).sum(-1).tolist()
    qh, qw = len(rho), len(rho[0])
    mel, vlc, ms = _HtMel(), _HtRev(True), _HtFwd()
    for qy in range(qh):
        first = qy == 0
        table = _ht_vlc_choice(first)
        if not first:
            up_sig = [0] + sig[2 * qy - 1].astype(int).tolist() + [0, 0]
            up_E = [0] + E[2 * qy - 1].tolist() + [0, 0]
        c_next = 0
        for qx0 in range(0, qw, 2):
            us, ctxs = [], []
            for qx in (qx0, qx0 + 1):
                if qx >= qw:
                    us.append(0)
                    ctxs.append(None)
                    continue
                r = rho[qy][qx]
                if first:
                    c = c_next
                    kappa = 1
                else:
                    x = 2 * qx
                    c = (up_sig[x] | up_sig[x + 1]) | (c_next & 2) | \
                        ((up_sig[x + 2] | up_sig[x + 3]) << 2)
                    emax = max(up_E[x:x + 4])
                    kappa = max(1, emax - 1) if r & (r - 1) else 1
                eq = max(qE[qy][qx])
                U = max(kappa, eq)
                u = U - kappa
                emb = 0
                if u:
                    emb = sum(1 << n for n in range(4) if qE[qy][qx][n] == U)
                if c == 0:
                    mel.event(r != 0)
                if c != 0 or r != 0:
                    cwd, n, ek, e1 = table[c, r, emb]
                    vlc.put(cwd, n)
                else:
                    ek = e1 = 0
                ctxs.append((U, ek, e1))
                us.append(u)
                if first:
                    c_next = (r & 1) | ((r >> 1) & 1) | ((r >> 2) << 1)
                else:
                    c_next = (((r >> 2) & 1) | ((r >> 3) & 1)) << 1
            u0, u1 = us
            mode = (u0 > 0) | ((u1 > 0) << 1)
            if mode == 1 or mode == 2:
                pfx, (sfx, sn) = _ht_uvlc(u0 if mode == 1 else u1)
                vlc.bits(pfx)
                vlc.put(sfx, sn)
            elif mode == 3:
                if first and u0 > 2 and u1 > 2:
                    mel.event(True)
                    p0, (s0, n0) = _ht_uvlc(u0 - 2)
                    p1, (s1, n1) = _ht_uvlc(u1 - 2)
                    vlc.bits(p0)
                    vlc.bits(p1)
                    vlc.put(s0, n0)
                    vlc.put(s1, n1)
                else:
                    if first:
                        mel.event(False)
                    p0, (s0, n0) = _ht_uvlc(u0)
                    vlc.bits(p0)
                    if first and u0 > 2:
                        vlc.put(u1 - 1, 1)
                        vlc.put(s0, n0)
                    else:
                        p1, (s1, n1) = _ht_uvlc(u1)
                        vlc.bits(p1)
                        vlc.put(s0, n0)
                        vlc.put(s1, n1)
            for k, qx in enumerate((qx0, qx0 + 1)):
                if ctxs[k] is None:
                    continue
                U, ek, e1 = ctxs[k]
                for n in range(4):
                    mu_n = qm[qy][qx][n]
                    if not mu_n:
                        continue
                    v = 2 * (mu_n - 1) + qs[qy][qx][n]
                    mn = U - ((ek >> n) & 1)
                    if (ek >> n) & 1:
                        assert (v >> mn) == ((e1 >> n) & 1), "ht: e_1"
                    else:
                        assert v >> mn == 0, "ht: U_q"
                    ms.put(v, mn)
    magsgn = ms.end_ones()
    melvlc = _ht_mel_vlc_end(mel, vlc)
    scup = len(melvlc)
    if scup > 4079:
        raise ValueError("ht: MEL and VLC over 4079 bytes")
    out = bytearray(magsgn + melvlc)
    out[-1] = scup >> 4
    out[-2] = (out[-2] & 0xF0) | (scup & 0xF)
    return bytes(out)


def _ht_refinement(mag: np.ndarray, neg: np.ndarray, p: int, passes: int,
                   causal: bool) -> bytes:
    """SigProp (and with 3 passes MagRef) of bit-plane p - 1 after a
    cleanup at plane p (T.814 7.4, 7.5): the stripes of 4 rows in groups
    of 4 columns, column by column; a SigProp member is an insignificant
    sample with a significant neighbour (the stripe below only under the
    cleanup's significance, and not at all when ``causal``); a group's
    signs follow its significance bits."""
    h, w = mag.shape
    sig = (mag >> p) > 0
    bit = (mag >> (p - 1)) & 1
    new = np.zeros((h, w), bool)
    sp = _HtFwd()
    for y0 in range(0, h, 4):
        y1 = min(y0 + 4, h)
        for gx in range(0, w, 4):
            signs = []
            for x in range(gx, min(gx + 4, w)):
                for y in range(y0, y1):
                    if sig[y, x]:
                        continue
                    member = False
                    for dy in (-1, 0, 1):
                        for dx in (-1, 0, 1):
                            ny, nx = y + dy, x + dx
                            if (dy, dx) == (0, 0) or not (
                                    0 <= ny < h and 0 <= nx < w):
                                continue
                            if ny >= y1 and causal and y1 == y0 + 4:
                                continue
                            if sig[ny, nx] or new[ny, nx]:
                                member = True
                    if member:
                        sp.put(int(bit[y, x]), 1)
                        if bit[y, x]:
                            new[y, x] = True
                            signs.append(int(neg[y, x]))
            for sgn in signs:
                sp.put(sgn, 1)
    out = sp.end_zeros()
    if passes < 3:
        return out
    mr = _HtRev(False)
    for y0 in range(0, h, 4):
        for gx in range(0, w, 4):
            for x in range(gx, min(gx + 4, w)):
                for y in range(y0, min(y0 + 4, h)):
                    if sig[y, x]:
                        mr.put(int(bit[y, x]), 1)
    return out + mr.end()


def _ht_lift(x: np.ndarray, start: int, step) -> None:
    """One lifting step over axis 0 at positions start, start + 2, ..:
    x[p] from x[p - 1] and x[p + 1], mirrored at the ends (F.3.7)."""
    n = x.shape[0]
    for q in range(start, n, 2):
        left = x[q - 1] if q > 0 else x[q + 1]
        right = x[q + 1] if q + 1 < n else x[q - 1]
        x[q] = step(x[q], left, right)


_HT_97 = (-1.586134342, -0.052980118, 0.882911075, 0.443506852)
_HT_K = 1.230174105


def _ht_fdwt(a: np.ndarray, origin: int, reversible: bool) -> tuple:
    """The forward 5/3 (integers) or 9/7 (floats) over axis 0 of samples
    at ``origin``, ..: (low band, high band), inverse to OpenJPEG's
    inverse (lows at even coordinates)."""
    n = a.shape[0]
    cas = origin % 2
    x = a.copy()
    if n == 1:
        if not cas:
            return x, x[:0]
        return x[:0], (x * 2 if reversible else x)
    if reversible:
        _ht_lift(x, 1 - cas, lambda d, l, r: d - ((l + r) >> 1))
        _ht_lift(x, cas, lambda d, l, r: d + ((l + r + 2) >> 2))
    else:
        for k, c in enumerate(_HT_97):
            _ht_lift(x, (1 - cas) if k % 2 == 0 else cas,
                     lambda d, l, r, c=c: d + (l + r) * c)
        x[cas::2] /= _HT_K
        x[1 - cas::2] /= 2.0 / _HT_K
    return x[cas::2], x[1 - cas::2]


def _ceil_pow2(a: int, b: int) -> int:
    return -((-a) >> b)


def _ht_bands(comp: np.ndarray, x0: int, y0: int, levels: int,
              reversible: bool) -> dict:
    """(resolution, band number) -> coefficients of one tile-component
    with origin (x0, y0): columns then rows at each level (OpenJPEG's
    inverse runs rows then columns)."""
    bands, cur = {}, comp
    for lev in range(1, levels + 1):
        rx0, ry0 = _ceil_pow2(x0, lev - 1), _ceil_pow2(y0, lev - 1)
        if cur.shape[0]:
            lo, hi = _ht_fdwt(cur, ry0, reversible)
        else:
            lo, hi = cur, cur
        out = []
        for part in (lo, hi):
            if part.shape[0] and part.shape[1]:
                a, b = _ht_fdwt(part.T, rx0, reversible)
                out += [a.T, b.T]
            else:
                nl = _ceil_pow2(rx0 + part.shape[1], 1) - _ceil_pow2(rx0, 1)
                out += [part[:, :nl], part[:, nl:]]
        ll, hl, lh, hh = out
        r = levels - lev + 1
        bands[r, 1], bands[r, 2], bands[r, 3] = hl, lh, hh
        cur = ll
    bands[0, 0] = cur
    return bands


class _BioOut:
    """OpenJPEG's packet-header bit writer (bio.c): a byte after 0xFF
    holds 7 bits."""

    def __init__(self):
        self.out, self.buf, self.ct = bytearray(), 0, 8

    def _byteout(self):
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        self.out.append(self.buf >> 8)

    def put(self, v: int, n: int = 1):
        for i in range(n - 1, -1, -1):
            if self.ct == 0:
                self._byteout()
            self.ct -= 1
            self.buf |= ((v >> i) & 1) << self.ct

    def flush(self) -> bytes:
        self._byteout()
        if self.ct == 7:
            self._byteout()
        return bytes(self.out)


class _TagTreeOut:
    """A tag tree's encoder (tgt.c ``opj_tgt_encode``) over leaf values."""

    def __init__(self, w: int, h: int, leaves):
        if not w * h:
            raise ValueError("tag tree: no leaves")
        self.parent, sizes, n = [], [], None
        lw, lh = w, h
        while n != 1:
            sizes.append((lw, lh))
            n = lw * lh
            lw, lh = (lw + 1) // 2, (lh + 1) // 2
        offs = np.cumsum([0] + [a * b for a, b in sizes]).tolist()
        for lvl, (lw, lh) in enumerate(sizes):
            for y in range(lh):
                for x in range(lw):
                    self.parent.append(-1 if lvl + 1 == len(sizes) else (
                        offs[lvl + 1] + (y // 2) * sizes[lvl + 1][0]
                        + x // 2))
        self.value = list(leaves) + [1 << 30] * (len(self.parent) - w * h)
        for i in range(len(self.parent)):
            if self.parent[i] >= 0:
                j = self.parent[i]
                self.value[j] = min(self.value[j], self.value[i])
        self.low = [0] * len(self.parent)
        self.known = [False] * len(self.parent)

    def encode(self, bio: _BioOut, leaf: int, threshold: int):
        path, node = [], leaf
        while self.parent[node] >= 0:
            path.append(node)
            node = self.parent[node]
        low = 0
        while True:
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold:
                if low >= self.value[node]:
                    if not self.known[node]:
                        bio.put(1)
                        self.known[node] = True
                    break
                bio.put(0)
                low += 1
            self.low[node] = low
            if not path:
                break
            node = path.pop()


def _ht_npasses(bio: _BioOut, n: int):
    if n == 1:
        bio.put(0, 1)
    elif n == 2:
        bio.put(2, 2)
    elif n <= 5:
        bio.put(0xC | (n - 3), 4)
    elif n <= 36:
        bio.put(0x1E0 | (n - 6), 9)
    else:
        bio.put(0xFF80 | (n - 37), 16)


def _ht_step(delta: float, rb: int) -> tuple:
    """(exponent, mantissa) of the step nearest ``delta`` (E-3) and the
    step the decoder derives from them."""
    e = int(np.floor(np.log2(delta)))
    mant = int(round((delta / 2.0 ** e - 1) * 2048))
    if mant == 2048:
        e, mant = e + 1, 0
    expn = rb - e
    if not 0 <= expn <= 31:
        raise ValueError(f"ht: step {delta} out of range")
    return expn, mant, float(np.float32((1 + mant / 2048) * 2.0 ** e))


def htj2k_encode(img: np.ndarray, *, levels: int = 5,
                 reversible: bool = True, step: float = 1.0,
                 cblk=(64, 64), tile=None, precincts=None, mct=None,
                 passes: int = 1, drop: int = 0, guard: int = 2,
                 prec=None, signed=None, cap: bool = True,
                 cpf: bool = False, style: int = 0, roi=None,
                 empty_included: bool = False, layers: int = 1,
                 late: bool = False, jp2: bool = False) -> bytes:
    """An HTJ2K codestream (or with ``jp2`` a JP2 file) of ``img`` ((h, w)
    or (h, w, components), any integer type): one quality layer, LRCP,
    ``levels`` of the 5/3 in integers (``reversible``) or the 9/7 in
    floats with base step ``step`` (quantised as E.1, a finer step for
    each coarser level), RCT / ICT over three components (``mct``, on by
    default then), tiles of ``tile`` (w, h), precinct exponents
    ``precincts`` ((PPx, PPy) a resolution from the lowest), code-blocks of
    ``cblk`` (w, h) with style 0x40 | ``style``, ``passes`` 1 (cleanup), 2
    (+ SigProp) or 3 (+ MagRef) per code-block, the cleanup ``drop``
    planes above the refinement's, ``guard`` bits, a CAP marker (``cap``)
    and a CPF marker (``cpf``), an RGN shift ``roi`` (component, shift)
    written but not applied. Code-blocks with nothing to code are left out
    of the packets, or with ``empty_included`` carry an empty cleanup.
    With ``layers`` 2 the refinement passes come in the second layer, and
    with ``late`` every other code-block comes first in the second."""
    a = np.asarray(img)
    if a.ndim == 2:
        a = a[..., None]
    h, w, nc = a.shape
    if prec is None:
        prec = 8 * a.dtype.itemsize
    if signed is None:
        signed = a.dtype.kind == "i"
    if mct is None:
        mct = nc >= 3
    tw, th = tile or (w, h)
    comps = a.astype(np.int64)
    if not signed:
        comps = comps - (1 << (prec - 1))
    comps = comps.astype(np.int64 if reversible else np.float64)
    if mct:
        r, g, b = comps[..., 0], comps[..., 1], comps[..., 2]
        if reversible:
            y, u, v = (r + 2 * g + b) >> 2, b - g, r - g
        else:
            y = 0.299 * r + 0.587 * g + 0.114 * b
            u = -0.16875 * r - 0.331260 * g + 0.5 * b
            v = 0.5 * r - 0.41869 * g - 0.08131 * b
        comps = comps.copy()
        comps[..., 0], comps[..., 1], comps[..., 2] = y, u, v
    # quantisation: (exponent, mantissa, step) per subband index
    nbands = 3 * levels + 1
    qnt = []
    for sidx in range(nbands):
        if sidx == 0:
            lev, bandno = levels, 0
        else:
            lev, bandno = levels - (sidx - 1) // 3, (sidx - 1) % 3 + 1
        if reversible:
            gain = (0, 1, 1, 2)[bandno]
            qnt.append((prec + gain, 0, 1.0))
        else:
            delta = step / 2.0 ** (lev if bandno == 0 else lev - 1) * (
                1.4 if bandno == 3 else 1.0)
            qnt.append(_ht_step(delta, prec))
    xcb, ycb = (int(np.log2(cblk[0])), int(np.log2(cblk[1])))
    pp = precincts or [(15, 15)] * (levels + 1)
    p_cl = drop + (1 if passes > 1 else 0)
    body = bytearray()
    ntx, nty = -(-w // tw), -(-h // th)
    for t in range(ntx * nty):
        tx0, ty0 = (t % ntx) * tw, (t // ntx) * th
        tx1, ty1 = min(tx0 + tw, w), min(ty0 + th, h)
        packets, order = [], {}
        per_comp = []
        for c in range(nc):
            bands = _ht_bands(comps[ty0:ty1, tx0:tx1, c], tx0, ty0, levels,
                              reversible)
            per_comp.append(bands)
        for r in range(levels + 1):
            lev = levels - r
            rx0, ry0 = _ceil_pow2(tx0, lev), _ceil_pow2(ty0, lev)
            rx1, ry1 = _ceil_pow2(tx1, lev), _ceil_pow2(ty1, lev)
            pdx, pdy = pp[r]
            tlpx, tlpy = (rx0 >> pdx) << pdx, (ry0 >> pdy) << pdy
            pw = 0 if rx0 == rx1 else (_ceil_pow2(rx1, pdx) << pdx
                                       ) - tlpx >> pdx
            ph = 0 if ry0 == ry1 else (_ceil_pow2(ry1, pdy) << pdy
                                       ) - tlpy >> pdy
            if r == 0:
                tlcbgx, tlcbgy, cbgw, cbgh = tlpx, tlpy, pdx, pdy
            else:
                tlcbgx, tlcbgy = _ceil_pow2(tlpx, 1), _ceil_pow2(tlpy, 1)
                cbgw, cbgh = pdx - 1, pdy - 1
            cbw, cbh = min(xcb, cbgw), min(ycb, cbgh)
            precinct = {}
            for c in range(nc):
                for pn in range(pw * ph):
                    chosen = []  # ([(Z, segments, first layer)], cw, ch)
                    for bandno in ((0,) if r == 0 else (1, 2, 3)):
                        if r == 0:
                            bx0, by0, bx1, by1 = rx0, ry0, rx1, ry1
                        else:
                            xb, yb = bandno & 1, bandno >> 1
                            bx0 = _ceil_pow2(tx0 - (xb << lev), lev + 1)
                            by0 = _ceil_pow2(ty0 - (yb << lev), lev + 1)
                            bx1 = _ceil_pow2(tx1 - (xb << lev), lev + 1)
                            by1 = _ceil_pow2(ty1 - (yb << lev), lev + 1)
                        if bx1 <= bx0 or by1 <= by0:
                            continue
                        coef = per_comp[c][r, bandno]
                        sidx = 0 if r == 0 else 3 * r - 2 + bandno - 1
                        expn, _mant, delta = qnt[sidx]
                        mb = guard + expn - 1
                        gx = tlcbgx + (pn % pw) * (1 << cbgw)
                        gy = tlcbgy + (pn // pw) * (1 << cbgh)
                        px0, py0 = max(gx, bx0), max(gy, by0)
                        px1 = min(gx + (1 << cbgw), bx1)
                        py1 = min(gy + (1 << cbgh), by1)
                        tlcx, tlcy = (px0 >> cbw) << cbw, (py0 >> cbh) << cbh
                        cw = max(0, (_ceil_pow2(px1, cbw) << cbw) - tlcx
                                 >> cbw)
                        ch = max(0, (_ceil_pow2(py1, cbh) << cbh) - tlcy
                                 >> cbh)
                        if not cw * ch:
                            continue
                        blocks = []
                        for k in range(cw * ch):
                            cx = tlcx + (k % cw) * (1 << cbw)
                            cy = tlcy + (k // cw) * (1 << cbh)
                            x0b, y0b = max(cx, px0), max(cy, py0)
                            x1b = min(cx + (1 << cbw), px1)
                            y1b = min(cy + (1 << cbh), py1)
                            blk = coef[y0b - by0:y1b - by0,
                                       x0b - bx0:x1b - bx0]
                            if reversible:
                                q = blk.astype(np.int64)
                            else:
                                q = (np.sign(blk) * np.floor(
                                    np.abs(blk) / delta)).astype(np.int64)
                            mag, neg = np.abs(q), (q < 0).astype(np.int64)
                            if mag.size and mag.max() >> mb:
                                raise ValueError(
                                    f"ht: magnitude {mag.max()} over "
                                    f"{mb} bit-planes")
                            p = min(p_cl, mb - 1)
                            z = mb - 1 - p
                            coded = mag.size and (mag >> p).any()
                            if not coded and not empty_included:
                                blocks.append((z, (), layers))
                                continue
                            segs = [_ht_cleanup(mag >> p, neg)]
                            if passes > 1 and p >= 1:
                                segs.append(_ht_refinement(
                                    mag, neg, p, passes,
                                    bool(style & 0x08)))
                            nblk = len(blocks) + sum(len(b) for b, _, _ in
                                                     chosen)
                            first_layer = min(layers - 1, late * (nblk % 2))
                            blocks.append((z, tuple(segs), first_layer))
                        chosen.append((blocks, cw, ch))
                    trees = [(_TagTreeOut(cw, ch, [b[2] for b in blocks]),
                              _TagTreeOut(cw, ch, [b[0] for b in blocks]))
                             for blocks, cw, ch in chosen]
                    precinct[c, pn] = (chosen, trees,
                                       [[3] * len(b) for b, _, _ in chosen])
            for c in range(nc):
                for pn in range(pw * ph):
                    order[r, c, pn] = precinct[c, pn]
        for layer in range(layers):
            for (r, c, pn), (chosen, trees, lblocks) in order.items():
                bio = _BioOut()
                parts = []  # (block, [segment indices]) in this layer
                for bi, (blocks, _cw, _ch) in enumerate(chosen):
                    for k, (z, segs, fl) in enumerate(blocks):
                        if not segs or layer < fl:
                            continue
                        # the cleanup in its first layer, the refinement
                        # in the next one when there are two layers
                        if layers > 1 and len(segs) > 1:
                            idx = [0] if layer == fl else (
                                [1] if layer == fl + 1 else [])
                        else:
                            idx = [0, 1][:len(segs)] if layer == fl else []
                        if idx:
                            parts.append((bi, k, idx))
                bio.put(int(bool(parts)))
                data = bytearray()
                if parts:
                    todo = {(bi, k): idx for bi, k, idx in parts}
                    for bi, (blocks, _cw, _ch) in enumerate(chosen):
                        incl, imsb = trees[bi]
                        for k, (z, segs, fl) in enumerate(blocks):
                            idx = todo.get((bi, k))
                            if layer <= fl or not segs:
                                incl.encode(bio, k, layer + 1)
                            else:
                                bio.put(int(idx is not None))
                            if idx is None:
                                continue
                            if layer == fl:
                                imsb.encode(bio, k, 999)
                            npass = sum(1 if i == 0 else passes - 1
                                        for i in idx)
                            _ht_npasses(bio, npass)
                            lens = [len(segs[i]) for i in idx]
                            extra = [0 if i == 0 else int(np.floor(np.log2(
                                passes - 1))) for i in idx]
                            lblock = lblocks[bi][k]
                            inc = 0
                            while any(n >> (lblock + inc + e) for n, e in
                                      zip(lens, extra)):
                                inc += 1
                            bio.put((1 << (inc + 1)) - 2, inc + 1)
                            lblock += inc
                            lblocks[bi][k] = lblock
                            for n, e in zip(lens, extra):
                                bio.put(n, lblock + e)
                            data += b"".join(segs[i] for i in idx)
                packets.append(bio.flush() + bytes(data))
        tile_body = b"".join(packets)
        body += struct.pack(">HHHIBB", 0xFF90, 10, t, 14 + len(tile_body),
                            0, 1) + b"\xff\x93" + tile_body
    siz = struct.pack(">HIIIIIIIIH", 0x4000 if cap else 0, w, h, 0, 0, tw,
                      th, 0, 0, nc) + bytes(
        [(prec - 1) | (0x80 if signed else 0), 1, 1] * nc)
    scod = 1 if precincts else 0
    cod = struct.pack(">BBHBBBBBB", scod, 0, layers, int(mct), levels, xcb - 2,
                      ycb - 2, 0x40 | style, int(reversible))
    if precincts:
        cod += bytes((py << 4) | px for px, py in pp)
    if reversible:
        qcd = bytes([guard << 5]) + bytes(e << 3 for e, _, _ in qnt)
    else:
        qcd = bytes([(guard << 5) | 2]) + b"".join(
            struct.pack(">H", (e << 11) | m) for e, m, _ in qnt)
    head = b"\xff\x4f" + j2k_segment(0xFF51, siz)
    if cap:
        head += j2k_segment(0xFF50, struct.pack(">IH", 0x00020000, 0))
    head += j2k_segment(0xFF52, cod) + j2k_segment(0xFF5C, qcd)
    if cpf:
        head += j2k_segment(0xFF59, struct.pack(">H", 0))
    if roi:
        head += j2k_segment(0xFF5E, bytes([roi[0], 0, roi[1]]))
    cs = head + bytes(body) + b"\xff\xd9"
    if not jp2:
        return cs
    enum = 16 if nc >= 3 else 17
    return jp2_wrap(cs, [jp2_ihdr(h, w, nc, (prec - 1) | (
        0x80 if signed else 0)), jp2_colr(enum)])
