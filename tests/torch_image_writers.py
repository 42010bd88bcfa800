"""Image writers for tests and fixtures (numpy and ``zlib``): PNG of every
colour type and depth PNG allows, Adam7 interlacing, the five row filters
and any extra chunks, which neither ``cv2.imwrite`` nor Pillow writes all
of; EXIF orientation spliced into JPEG bytes; and WebP's RIFF chunks (VP8X,
ALPH, ANIM, ANMF, EXIF) assembled around bitstreams that cv2 or Pillow
wrote, for the variants neither writes; and libwebp's own encoder (the
shared library Pillow bundles, through ``ctypes``) for the encoder
settings neither cv2 nor Pillow exposes."""
import ctypes
import glob
import os
import struct
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
    """(h, n) samples under 8 bits -> (h, ceil(n * bits / 8)) bytes, MSB
    first."""
    h, n = samples.shape
    per = 8 // bits
    flat = np.pad(samples.astype(np.uint8), ((0, 0), (0, -n % per)))
    flat = flat.reshape(h, -1, per)
    out = np.zeros(flat.shape[:2], np.uint8)
    for k in range(per):
        out |= (flat[..., k] & ((1 << bits) - 1)) << (8 - bits * (k + 1))
    return out


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
               subsampling=None, omit=()) -> bytes:
    """Samples (h, w) or (h, w, c) -> TIFF bytes, the first IFD only.

    ``bits`` under 8 packs uint8 samples MSB first; ``tile`` (tw, th) writes
    tiles (edge tiles padded with zeros) instead of strips; ``compression``
    1 none, 5 LZW (``lzw_old``: the old LSB-first form), 8 / 32946 deflate,
    32773 PackBits; ``predictor`` 2 (integer) or 3 (floating point);
    ``fill_order`` 2 stores each byte's bits reversed; ``subsampling``
    (hs, vs) writes YCbCr samples as subsampled data units;
    ``extra_tags``: (tag, type, values) entries; ``omit``: tags left out."""
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
    chunks = []
    for plane in planes:
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
                if predictor == 3:
                    raw = np.ascontiguousarray(flat).tobytes()
                elif bits < 8:
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


# --- GIF -------------------------------------------------------------------

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
