"""The TIFF variants of ``gis/tiff.py`` over ``native/fax3.cpp``, the BMP
bitfields of ``gis/bmp.py`` and the ZSTD DEM behind the WMS path, against
cv2 5.0 (libtiff 4.7) on the CPU. Tolerance: 0 levels, equal shapes and
dtypes; None exactly where cv2 gives None. Each file is read by
``decode_image`` and ``read_image`` under ``IMREAD_UNCHANGED`` and
``IMREAD_GRAYSCALE`` against ``cv2.imdecode`` and ``cv2.imread``.

- ``CODECS``: every compression libtiff knows and a few it does not, on
  8-bit grey and RGB, 1-bit MinIsBlack and MinIsWhite, 16-bit and float32
  strips of seeded bytes, with cv2's verdict and libtiff's message asked
  of cv2: None for the codecs its libtiff is built without and for the
  pairings their setup refuses, zero samples under libtiff's RGBA reader
  (None over 8 bits unchanged) for a compression with no codec.
- Real ZSTD and LZMA files (Pillow's libtiff) give None, and a ZSTD DEM
  behind a loopback WMS gives both packages' ``request_orthoimage`` the
  same image and a zero DEM; the port's ``GISNode`` publishes over it.
- ``Predictor`` is undone under LZW and deflate only; a value they cannot
  undo gives None.
- CCITT RLE, RLEW, Group 3 1-D and 2-D and Group 4 (Pillow's libtiff and
  ``tests/torch_image_writers.py`` ``ccitt_1d``): strips, tiles,
  ``FillOrder`` 2, MinIsWhite, EOL fill bits, no EOLs (libtiff's retry),
  RTC, RLEW at an odd offset (``cv2.imread`` maps the file, so its word
  alignment differs from ``cv2.imdecode``'s), T4Options bit 1, and seeded
  damage: flipped bits, replaced bytes, cut byte counts.
- 10-, 12- and 14-bit samples: grey, RGB and RGBA, both byte orders,
  strips and tiles, none / LZW / deflate / PackBits, signed, MinIsWhite.
- YCbCr 4x4 strips of every width 1-25; BMP V4 / V5 bitfields whose masks
  are not whole bytes; JPEG-in-TIFF with separate planes (RGB, YCbCr at
  every subsampling) and of 12 and 16 bits, and streams whose component
  count or sampling libtiff's ``JPEGPreDecode`` refuses.
- CIELab (photometric 8) through libtiff's RGBA reader's
  ``TIFFCIELab16ToXYZ`` / ``TIFFXYZToRGB`` (the file's WhitePoint or D50,
  ``display_sRGB``): 8 and 16 bits, signed a*/b* (SampleFormat 2 gives
  int8 under ``IMREAD_UNCHANGED``), orientations, strips and tiles,
  Pillow's LAB writer; None for extra samples, separate planes and one
  sample.
- SGILog (``sgilog_encode``): LogL through ``L16toGry`` under both flags
  (int8 for SampleFormat 2, None for a float format), LogLuv32 and
  LogLuv24 as 8-bit RGB (``XYZtoRGB24``) under the grey flag and as float32
  XYZ turned by ``COLOR_XYZ2BGR`` under ``IMREAD_UNCHANGED`` (the SSE
  lanes' and the row tail's float sums), orientations, strips, tiles, cut
  strips (rows after the cut zero under the RGBA reader, None unchanged).
- The committed fixtures (``tests/data/torch_tiffx``, written by
  ``tools/make_torch_image_fixtures.py --tiffx-out``): cv2's digests
  unchanged, and the port's decodes equal to them.
"""
import hashlib
import json
import os
import struct
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from urllib.parse import parse_qs, urlparse

import cv2
import numpy as np
import pytest

from gisnav_tpu.gis import wms as jax_wms
from gisnav_tpu_torch.gis.imgcodecs import decode_image, read_image
from gisnav_tpu_torch.gis.tiff import encode_tiff
from gisnav_tpu_torch.gis.wms import WMSClient, request_orthoimage
from tests.torch_image_writers import (ccitt_1d, libjpeg_encode, pillow_tiff,
                                       sgilog_encode, write_bmp, write_tiff)

cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_SILENT)
FLAGS = (cv2.IMREAD_UNCHANGED, cv2.IMREAD_GRAYSCALE)
FIXTURES = os.path.join(os.path.dirname(__file__), "data", "torch_tiffx")


def _rng(name: str) -> np.random.Generator:
    return np.random.default_rng(sum(map(ord, name)))


def _same(ref, got) -> bool:
    return (ref is None) == (got is None) and (ref is None or (
        got.dtype == ref.dtype and got.shape == ref.shape
        and np.array_equal(got, ref)))


def _check(data: bytes, what: str = ""):
    """decode_image = cv2.imdecode and read_image = cv2.imread, both
    flags."""
    buf = np.frombuffer(data, np.uint8)
    for flag in FLAGS:
        ref, got = cv2.imdecode(buf, flag), decode_image(data, flag)
        assert _same(ref, got), (what, "imdecode", flag,
                                 None if ref is None else ref.shape,
                                 None if got is None else got.shape)
    with tempfile.NamedTemporaryFile(suffix=".bin", delete=False) as f:
        f.write(data)
    try:
        for flag in FLAGS:
            ref, got = cv2.imread(f.name, flag), read_image(f.name, flag)
            assert _same(ref, got), (what, "imread", flag)
    finally:
        os.unlink(f.name)


def _verdicts(data: bytes):
    buf = np.frombuffer(data, np.uint8)
    return tuple(cv2.imdecode(buf, flag) is not None for flag in FLAGS)


def _strips(data: bytes):
    """(offsets, byte counts) of a little-endian classic TIFF's strips or
    tiles."""
    from gisnav_tpu_torch.gis.tiff import _DirReader, _Ifd

    ifd = _Ifd(data)
    r = _DirReader(ifd, data)
    n = next(e[2] for e in ifd.entries if e[0] in (273, 324))
    return ([int(v) for v in r.strip_array((324, 273), n)],
            [int(v) for v in r.strip_array((325, 279), n)])


def _patch_counts(data: bytes, counts) -> bytes:
    """``data`` with its StripByteCounts / TileByteCounts set to
    ``counts`` (a little-endian classic TIFF)."""
    out = bytearray(data)
    ifd = struct.unpack_from("<I", data, 4)[0]
    for i in range(struct.unpack_from("<H", data, ifd)[0]):
        at = ifd + 2 + 12 * i
        tag, ftype, n = struct.unpack_from("<HHI", data, at)
        if tag in (279, 325):
            code = "<H" if ftype == 3 else "<I"
            size = struct.calcsize(code)
            base = at + 8 if n * size <= 4 else struct.unpack_from(
                "<I", data, at + 8)[0]
            for k, c in enumerate(counts):
                struct.pack_into(code, out, base + k * size, c)
    return bytes(out)


# -- 1. the codecs: None where cv2 gives None ----------------------------

# compression -> (libtiff's name, what cv2 5.0's libtiff logs for 8-bit
# grey strips of it under IMREAD_GRAYSCALE, and cv2's verdict on the KINDS
# below: "none" under both flags, "1-bit only" an array for 1-bit samples
# and None for the others, "zeros" zero samples under libtiff's RGBA
# reader and None over 8 bits unchanged; _expected spells it out)
_FAX = "Fax3SetupState: Bits/sample must be 1 for Group 3/4 " \
    "encoding/decoding"
_LOGLUV = "LogLuvSetupDecode: Inappropriate photometric interpretation 1 " \
    "for SGILog compression; must be either LogLUV or LogL"
CODECS = {
    2: ("CCITT RLE", _FAX, "1-bit only"),
    3: ("CCITT Group 3", _FAX, "1-bit only"),
    4: ("CCITT Group 4", _FAX, "1-bit only"),
    6: ("Old-style JPEG", "Old-style JPEG compression support is not "
        "configured", "none"),
    32766: ("NeXT", "NeXTPreDecode: Unsupported BitsPerSample = 8", "none"),
    32771: ("CCITT RLE/W", _FAX, "1-bit only"),
    32809: ("ThunderScan", "ThunderSetupDecode: Wrong bitspersample value "
            "(8), Thunder decoder only supports 4bits per sample.", "none"),
    32908: ("no codec (PixarFilm)", "Compression scheme 32908 strip "
            "decoding is not implemented", "zeros"),
    32909: ("PixarLog", "PixarLog compression support is not configured",
            "none"),
    34661: ("ISO JBIG", "ISO JBIG compression support is not configured",
            "none"),
    34676: ("SGILog", _LOGLUV, "none"),
    34677: ("SGILog24", _LOGLUV, "none"),
    34712: ("no codec (JPEG 2000)", "Compression scheme 34712 strip "
            "decoding is not implemented", "zeros"),
    34887: ("LERC", "LERC compression support is not configured", "none"),
    34925: ("LZMA", "LZMA compression support is not configured", "none"),
    50000: ("ZSTD", "ZSTD compression support is not configured", "none"),
    50001: ("WEBP", "WEBP compression support is not configured", "none"),
    50002: ("no codec (JPEG XL)", "Compression scheme 50002 strip decoding "
            "is not implemented", "zeros"),
    7777: ("no codec", "Compression scheme 7777 strip decoding is not "
           "implemented", "zeros"),
}
KINDS = {
    "u8_grey": (lambda r: r.integers(0, 256, (9, 11)).astype(np.uint8), {}),
    "u8_rgb": (lambda r: r.integers(0, 256, (9, 11, 3)).astype(np.uint8),
               {}),
    "bits1": (lambda r: r.integers(0, 2, (9, 11)).astype(np.uint8),
              {"bits": 1}),
    "bits1_miniswhite": (lambda r: r.integers(0, 2, (9, 11)).astype(
        np.uint8), {"bits": 1, "photometric": 0}),
    "u16_grey": (lambda r: r.integers(0, 65536, (9, 11)).astype(np.uint16),
                 {}),
    "f32_grey": (lambda r: r.random((9, 11)).astype(np.float32), {}),
}


def _expected(verdict: str, kind: str):
    """cv2's (UNCHANGED, GRAYSCALE) verdicts for ``verdict`` on ``kind``."""
    if verdict == "none" or (verdict == "1-bit only"
                             and not kind.startswith("bits1")):
        return (False, False)
    if kind == "f32_grey":  # libtiff's RGBA reader refuses 32 bits
        return (verdict != "zeros", False)
    if kind == "u16_grey" and verdict == "zeros":
        return (False, True)  # TIFFReadEncodedStrip fails; RGBA reads 0
    return (True, True)


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("code", sorted(CODECS))
def test_codec_verdicts_as_cv2(code, kind):
    make, kw = KINDS[kind]
    data = write_tiff(make(_rng(f"{code}{kind}")), extra_tags=[
        (259, 3, [code])], **kw)
    assert _verdicts(data) == _expected(CODECS[code][2], kind), CODECS[code]
    _check(data, f"{code} {kind}")
    if CODECS[code][2] == "zeros" and kind == "u8_grey":
        assert not decode_image(data).any()


ZSTD_KINDS = {  # Pillow mode, array
    "dem_u16": ("I;16", lambda r: r.integers(0, 3000, (40, 48)).astype(
        np.uint16)),
    "dem_f32": ("F", lambda r: (r.random((40, 48)) * 300).astype(
        np.float32)),
    "grey": ("L", lambda r: r.integers(0, 256, (40, 48)).astype(np.uint8)),
    "rgb": ("RGB", lambda r: r.integers(0, 256, (40, 48, 3)).astype(
        np.uint8)),
}


@pytest.mark.parametrize("predictor", [1, 2])
@pytest.mark.parametrize("compression", ["zstd", "lzma"])
@pytest.mark.parametrize("kind", sorted(ZSTD_KINDS))
def test_zstd_and_lzma_give_none(kind, compression, predictor):
    """GDAL's COG defaults (ZSTD or LZMA, a predictor): cv2's libtiff has
    neither codec, and cv2 gives None under both flags; so does the
    port (it raised before)."""
    mode, make = ZSTD_KINDS[kind]
    data = pillow_tiff(make(_rng(kind)), mode, compression=compression,
                       tiffinfo={317: predictor} if predictor != 1 else {})
    assert _verdicts(data) == (False, False)
    for flag in FLAGS:
        assert decode_image(data, flag) is None
    _check(data, kind)


# -- 2. the predictor ----------------------------------------------------

PREDICTED = [(comp, pred, dtype)
             for comp in (1, 32773, 5, 8) for pred in (2, 3, 4)
             for dtype in ("u1", "u2", "f4", "bits1", "palette4")]


@pytest.mark.parametrize("comp,pred,dtype", PREDICTED,
                         ids=lambda v: str(v))
def test_predictor_only_where_libtiff_applies_it(comp, pred, dtype):
    """A ``Predictor`` tag is undone by LZW and deflate only (libtiff's
    codecs that install it); a value they cannot undo (4, 2 on samples
    under 8 bits, 3 on integers) gives None there. Uncompressed and
    PackBits strips read as stored, whatever the tag says."""
    r = _rng(f"{comp}{pred}{dtype}")
    kw = {}
    if dtype == "bits1":
        a, kw = r.integers(0, 2, (9, 11)).astype(np.uint8), {"bits": 1}
    elif dtype == "palette4":
        a = r.integers(0, 16, (9, 11)).astype(np.uint8)
        kw = {"bits": 4, "photometric": 3,
              "colormap": r.integers(0, 65536, (16, 3))}
    elif dtype == "f4":
        a = r.random((9, 11)).astype(np.float32)
    else:
        a = r.integers(0, 256 if dtype == "u1" else 65536, (9, 11)).astype(
            dtype)
    data = write_tiff(a, compression=comp, extra_tags=[(317, 3, [pred])],
                      **kw)
    _check(data, f"{comp} {pred} {dtype}")


def test_predictor_on_uncompressed_strips_reads_the_samples():
    """The seeded 9x11 uint8 of the record: cv2 returns the raw samples
    under both flags (the port undid the predictor before)."""
    a = np.random.default_rng(9).integers(0, 256, (9, 11)).astype(np.uint8)
    data = write_tiff(a, extra_tags=[(317, 3, [2])])
    for flag in FLAGS:
        np.testing.assert_array_equal(decode_image(data, flag), a)
    _check(data)


# -- 3. CCITT --------------------------------------------------------------

def _bilevel(name: str, h: int, w: int) -> np.ndarray:
    """Seeded 0 / 1 pixels: a third of each row one run, the rest noise,
    a few rows white."""
    r = _rng(name)
    a = (r.random((h, w)) < 0.35).astype(np.uint8)
    a[:, :w // 3] = a[:, :1]
    a[::7] = 0
    return a


PILLOW_CCITT = {
    "rle": dict(compression="tiff_ccitt"),
    "rlew": dict(compression="tiff_raw_16"),
    "g3": dict(compression="group3"),
    "g3_2d": dict(compression="group3", tiffinfo={292: 1}),
    "g3_2d_fill": dict(compression="group3", tiffinfo={292: 5}),
    "g3_fill": dict(compression="group3", tiffinfo={292: 4}),
    "g4": dict(compression="group4"),
}
CCITT_LAYOUTS = {
    "one_strip": {},
    "strips7": {278: 7},
    "fill_order2": {266: 2},
    "miniswhite": {262: 0},
}


def _pillow_ccitt(scheme: str, layout: str, h: int = 37, w: int = 53
                  ) -> bytes:
    kw = dict(PILLOW_CCITT[scheme])
    info = {**kw.pop("tiffinfo", {}), **CCITT_LAYOUTS[layout]}
    return pillow_tiff(_bilevel(scheme + layout, h, w), "1", tiffinfo=info,
                       **kw)


@pytest.mark.parametrize("layout", sorted(CCITT_LAYOUTS))
@pytest.mark.parametrize("scheme", sorted(PILLOW_CCITT))
def test_ccitt_as_cv2(scheme, layout):
    """Pillow's libtiff files of each scheme (RLEW's words aligned to its
    encoder's buffer, not the decoder's: cv2 logs a bad code word on the
    37x53 file and reads on)."""
    data = _pillow_ccitt(scheme, layout)
    assert _verdicts(data) == (True, True)
    _check(data, f"{scheme} {layout}")


@pytest.mark.parametrize("w", [1, 8, 1728, 2300])
@pytest.mark.parametrize("scheme", ["rlew", "g3_2d", "g4"])
def test_ccitt_widths_as_cv2(scheme, w):
    """Runs past 1728 (the make-up codes shared by both colours) and
    rows of one pixel."""
    data = pillow_tiff(_bilevel(f"{scheme}{w}", 9, w), "1",
                       **PILLOW_CCITT[scheme])
    _check(data, f"{scheme} {w}")


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("scheme", sorted(PILLOW_CCITT))
def test_ccitt_random_damage_as_cv2(scheme, seed):
    """Seeded damage in the strips (flipped bits, replaced bytes, a strip's
    byte count cut): what libtiff's decoder leaves after its error (a bad
    code word closes the row and decoding goes on; Group 3 that loses its
    EOLs is decoded again from the strip's start without them)."""
    data = _pillow_ccitt(scheme, "strips7" if seed % 2 else "one_strip",
                         45, 70)
    offs, counts = _strips(data)
    for trial in range(6):
        r = np.random.default_rng(1000 * seed + trial)
        b = bytearray(data)
        for _ in range(r.integers(1, 6)):
            k = r.integers(0, len(offs))
            at = offs[k] + r.integers(0, counts[k])
            if r.random() < 0.5:
                b[at] ^= 1 << r.integers(0, 8)
            else:
                b[at] = r.integers(0, 256)
        damaged = bytes(b)
        if trial % 3 == 2:
            k = r.integers(0, len(offs))
            cut = list(counts)
            cut[k] = int(r.integers(1, counts[k]))
            damaged = _patch_counts(damaged, cut)
        _check(damaged, f"{scheme} seed {seed} trial {trial}")


ONE_D = {  # ccitt_1d's layouts of each 1-D scheme
    "rle": (2, {}),
    "rlew": (32771, {}),
    "g3": (3, {}),
    "g3_fill_rtc": (3, {"fill": True, "rtc": True}),
    "g3_no_eol": (3, {"eol": False}),
}


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("name", sorted(ONE_D))
def test_ccitt_1d_writer_as_cv2(name, tiled):
    """The 1-D schemes as ``ccitt_1d`` writes them, in strips of 5 rows
    and in 32x16 tiles (libtiff decodes a tile's rows at its width); Group
    3 without EOLs reads through libtiff's retry without them."""
    scheme, kw = ONE_D[name]
    a = _bilevel(name, 37, 53)
    data = write_tiff(a, bits=1, compression=scheme, ccitt=kw,
                      photometric=0, rows_per_strip=5,
                      tile=(32, 16) if tiled else None)
    assert _verdicts(data) == (True, True)
    _check(data, name)


def test_ccitt_t4_options_uncompressed_flag_as_cv2():
    """T4Options bit 1 (uncompressed mode allowed) on 1-D data: cv2 reads
    the file as without it; an extension code word (uncompressed mode
    itself, which libtiff does not decode) in a 2-D stream closes its row
    as cv2 closes it."""
    a = _bilevel("t4", 21, 40)
    for opts in (2, 3, 6):
        data = write_tiff(a, bits=1, compression=3, rows_per_strip=21,
                          extra_tags=[(292, 4, [opts])])
        assert _verdicts(data) == (True, True)
        _check(data, f"T4Options {opts}")
    g3 = _pillow_ccitt("g3_2d", "one_strip")
    offs, counts = _strips(g3)
    b = bytearray(g3)
    b[offs[0] + counts[0] // 2] = 0x02  # 0000001 0: the extension code
    _check(bytes(b), "extension code")


def _shift_strips(data: bytes, pad: int) -> bytes:
    """``data`` (a little-endian classic TIFF, strips after the IFD's
    values) with ``pad`` bytes before its first strip, offsets moved."""
    offs, _ = _strips(data)
    out = bytearray(data[:offs[0]] + b"\0" * pad + data[offs[0]:])
    ifd = struct.unpack_from("<I", data, 4)[0]
    for i in range(struct.unpack_from("<H", data, ifd)[0]):
        at = ifd + 2 + 12 * i
        tag, _, n = struct.unpack_from("<HHI", data, at)
        if tag in (273, 324):
            base = at + 8 if n == 1 else struct.unpack_from("<I", data,
                                                            at + 8)[0]
            for k in range(n):
                v = struct.unpack_from("<I", out, base + 4 * k)[0]
                struct.pack_into("<I", out, base + 4 * k, v + pad)
    return bytes(out)


@pytest.mark.parametrize("source", ["writer", "pillow"])
@pytest.mark.parametrize("pad", [0, 1, 2, 3])
def test_rlew_at_odd_offsets_as_cv2(pad, source):
    """RLEW aligns each row to the data's address: ``cv2.imread`` maps the
    file (the strip at its offset), ``cv2.imdecode`` reads the strip into a
    buffer of its own, and their pixels differ where the offset is odd."""
    a = _bilevel(f"odd{pad}", 37, 53)
    data = write_tiff(a, bits=1, compression=32771, rows_per_strip=5)
    if source == "pillow":  # Pillow's strips in write_tiff's layout
        pillow = pillow_tiff(a, "1", compression="tiff_raw_16",
                             tiffinfo={278: 5})
        offs, counts = _strips(pillow)
        data = write_tiff(a, bits=1, rows_per_strip=5, strips=[
            pillow[o:o + c] for o, c in zip(offs, counts)],
            extra_tags=[(259, 3, [32771])])
    first = _strips(data)[0][0]
    data = _shift_strips(data, pad)
    assert _strips(data)[0][0] == first + pad
    _check(data, f"pad {pad}")


def test_ccitt_of_8bit_samples_gives_none():
    """CCITT of 8-bit samples: libtiff's setup refuses it ("Bits/sample
    must be 1"), and cv2 gives None (the port raised before)."""
    a = np.random.default_rng(3).integers(0, 256, (9, 11)).astype(np.uint8)
    for code in (2, 3, 4, 32771):
        data = write_tiff(a, extra_tags=[(259, 3, [code])])
        for flag in FLAGS:
            assert decode_image(data, flag) is None
        _check(data)


# -- 4. 10- to 14-bit samples --------------------------------------------

WIDE = [(bits, spp, order, comp, tiled)
        for bits in (10, 12, 14) for spp in (1, 3, 4)
        for order in (b"II", b"MM") for comp in (1, 5, 8)
        for tiled in (False, True)]


@pytest.mark.parametrize("bits,spp,order,comp,tiled", WIDE,
                         ids=lambda v: v.decode() if isinstance(v, bytes)
                         else str(v))
def test_wide_samples_as_cv2(bits, spp, order, comp, tiled):
    """GDAL's ``NBITS``: cv2 unpacks 10, 12 and 14-bit samples MSB first
    into uint16 shifted to 16 bits under ``IMREAD_UNCHANGED`` (its BGR(A)
    for colour) and gives None under the grey flag (libtiff's RGBA reader
    takes 1, 2, 4, 8 and 16 bits only)."""
    r = _rng(f"{bits}{spp}{order}{comp}{tiled}")
    a = r.integers(0, 1 << bits, (13, 17, spp)).astype(np.uint16)
    data = write_tiff(a, order=order, bits=bits, compression=comp,
                      extra_samples=[2] if spp == 4 else None,
                      rows_per_strip=5, tile=(16, 16) if tiled else None)
    want = (a << (16 - bits)).astype(np.uint16)
    want = want[..., [0] if spp == 1 else [2, 1, 0, 3][:spp]]
    want = want[..., 0] if spp == 1 else want
    np.testing.assert_array_equal(decode_image(data), want)
    assert decode_image(data, cv2.IMREAD_GRAYSCALE) is None
    _check(data)


@pytest.mark.parametrize("case", ["signed", "miniswhite", "packbits",
                                  "pred2_lzw", "pred2_none", "planar2"])
@pytest.mark.parametrize("bits", [10, 12, 14])
def test_wide_sample_kinds_as_cv2(bits, case):
    """Signed samples (saturated to int16), MinIsWhite (not inverted),
    PackBits, a predictor (None under LZW, which cannot undo it; ignored
    uncompressed) and separate planes (refused over 8 bits unchanged: cv2's
    pixels there are undefined)."""
    r = _rng(f"{bits}{case}")
    spp = 3 if case == "planar2" else 1
    a = r.integers(0, 1 << bits, (13, 17, spp)).astype(np.uint16)
    kw = {"signed": dict(sample_format=2),
          "miniswhite": dict(photometric=0),
          "packbits": dict(compression=32773),
          "pred2_lzw": dict(compression=5, extra_tags=[(317, 3, [2])]),
          "pred2_none": dict(extra_tags=[(317, 3, [2])]),
          "planar2": dict(planar=2)}[case]
    data = write_tiff(a, bits=bits, rows_per_strip=4, **kw)
    if case == "planar2":
        assert _verdicts(data) == (True, False)
        with pytest.raises(ValueError, match="PlanarConfiguration 2"):
            decode_image(data)
        assert decode_image(data, cv2.IMREAD_GRAYSCALE) is None
        return
    _check(data, case)


# -- 5. the small reads ----------------------------------------------------

@pytest.mark.parametrize("w", range(1, 26))
def test_ycbcr44_strips_every_width_as_cv2(w):
    """4x4 YCbCr strips: ``TIFFReadRGBAStrip`` decodes rows times
    ``TIFFScanlineSize`` (a unit row's bytes / 4, rounded down), so a strip
    of an odd number of units a row reads its last bytes from the zeroed
    buffer (the port refused widths not a multiple of 4 before)."""
    r = _rng(f"ycbcr{w}")
    for rps in (None, 1, 4, 5, 8):
        for comp in (1, 8):
            a = r.integers(0, 256, (13, w, 3)).astype(np.uint8)
            data = write_tiff(a, photometric=6, subsampling=(4, 4),
                              compression=comp,
                              **({} if rps is None else
                                 {"rows_per_strip": rps}))
            _check(data, f"w {w} rps {rps} comp {comp}")


BMP_MASKS = {  # (r, g, b, a)
    "10_10_10_2": (0x3FF00000, 0xFFC00, 0x3FF, 0xC0000000),
    "5_5_5_1": (0x7C00, 0x3E0, 0x1F, 0x8000),
    "4_4_4_4": (0xF00, 0xF0, 0xF, 0xF000),
    "3_3_3": (0x7, 0x38, 0x1C0, 0),
    "5_6_5": (0xF800, 0x7E0, 0x1F, 0),
    "12_10_10": (0xFFF00000, 0xFFC00, 0x3FF, 0),
    "1_1_1_1": (0x1, 0x2, 0x4, 0x8),
    "6_6_6_6": (0x3F, 0xFC0, 0x3F000, 0xFC0000),
    "bytes_abgr": (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
    "11_11_10": (0x7FF, 0x3FF800, 0xFFC00000, 0),
}


@pytest.mark.parametrize("header", [108, 124])
@pytest.mark.parametrize("name", sorted(BMP_MASKS))
def test_bmp_bitfield_masks_as_cv2(name, header):
    """V4 / V5 32-bit bitfields: each field scaled to 8 bits as OpenCV
    scales it (v * (255 / its largest value) in float32, truncated: 7 of a
    3-bit field is 254), the grey from those (the port refused masks that
    are not whole bytes before)."""
    r = _rng(name)
    words = r.integers(0, 2 ** 32, (7, 9), dtype=np.uint64).astype(np.uint32)
    words[0, :4] = (0, 0xFFFFFFFF, 0x7, 0x3FF)
    data = write_bmp(words.view(np.uint8).reshape(7, 9, 4), 32,
                     header=header, compression=3, masks=BMP_MASKS[name])
    assert _verdicts(data) == (True, True)
    _check(data, name)


@pytest.mark.parametrize("rps", [24, 7])
def test_jpeg_in_tiff_separate_planes_as_cv2(rps):
    """JPEG-in-TIFF with ``PlanarConfiguration`` 2: a grey JPEG a plane's
    strip (the port refused it before)."""
    r = _rng(f"planes{rps}")
    img = cv2.GaussianBlur(r.integers(0, 256, (24, 40, 3)).astype(np.uint8),
                           (5, 5), 2)
    streams = [cv2.imencode(".jpg", np.ascontiguousarray(
        img[y:y + rps, :, p]))[1].tobytes()
        for p in range(3) for y in range(0, 24, rps)]
    data = write_tiff(np.zeros((24, 40, 3), np.uint8), strips=streams,
                      rows_per_strip=rps, planar=2,
                      extra_tags=[(259, 3, [7])])
    assert _verdicts(data) == (True, True)
    _check(data, f"rps {rps}")


_S420, _S422, _S444 = (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)
# (photometric, YCbCrSubsampling or None, planar, stream sampling or None
# for grey streams a plane, tiled, cv2 reads it)
JPEG_SAMPLING = {
    "rgb_420": (2, None, 1, _S420, False, False),
    "rgb_422": (2, None, 1, _S422, False, False),
    "rgb_444": (2, None, 1, _S444, False, True),
    "rgb_420_tiles": (2, None, 1, _S420, True, False),
    "ycbcr11_420": (6, (1, 1), 1, _S420, False, False),
    "ycbcr11_444": (6, (1, 1), 1, _S444, False, True),
    "ycbcr22_420": (6, (2, 2), 1, _S420, False, True),
    "ycbcr22_422": (6, (2, 2), 1, _S422, False, False),
    "ycbcr21_422": (6, (2, 1), 1, _S422, False, True),
    "ycbcr_default_420_tiles": (6, None, 1, _S420, True, True),
    "rgb_grey_stream": (2, None, 1, None, False, False),
    "planar_rgb_colour_streams": (2, None, 2, _S444, False, False),
    "planar_ycbcr11": (6, (1, 1), 2, None, False, True),
    "planar_ycbcr11_tiles": (6, (1, 1), 2, None, True, True),
    "planar_ycbcr22": (6, (2, 2), 2, None, False, False),
    "planar_ycbcr_default": (6, None, 2, None, False, False),
}


@pytest.mark.parametrize("name", sorted(JPEG_SAMPLING))
def test_jpeg_in_tiff_sampling_as_cv2(name):
    """JPEG-in-TIFF streams held to libtiff's ``JPEGPreDecode``: the
    stream's component count and sampling against the file's (None where
    they differ, which the port read before), and separate YCbCr planes
    (read through the YCbCr tables at 1,1, which the port refused before;
    None at any other subsampling)."""
    ph, sub, planar, sf, tiled, reads = JPEG_SAMPLING[name]
    r = _rng(name)
    img = cv2.GaussianBlur(r.integers(0, 256, (32, 48, 3)).astype(np.uint8),
                           (5, 5), 2)
    blocks = [(y, x) for y in range(0, 32, 16) for x in range(0, 48, 16)] \
        if tiled else [(0, 0)]
    size = 16 if tiled else None

    def enc(a, y, x):
        if size:
            a = a[y:y + size, x:x + size]
        p = [] if sf is None else [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sf]
        return cv2.imencode(".jpg", np.ascontiguousarray(a), p)[1].tobytes()

    if planar == 1:
        streams = [enc(img if sf is not None else img[..., 0], y, x)
                   for y, x in blocks]
    else:
        streams = [enc(img if sf is not None else img[..., p], y, x)
                   for p in range(3) for y, x in blocks]
    tags = [(259, 3, [7])] + ([(530, 3, list(sub))] if sub else [])
    data = write_tiff(np.zeros((32, 48, 3), np.uint8), photometric=ph,
                      planar=planar, strips=streams,
                      tile=(16, 16) if tiled else None, extra_tags=tags)
    assert _verdicts(data) == (reads, reads)
    _check(data, name)


@pytest.mark.parametrize("bits", [12, 16])
def test_jpeg_in_tiff_over_8_bits_as_cv2(bits):
    """JPEG-in-TIFF of 12 bits (libjpeg-turbo's 12-bit DCT) and 16 bits
    (lossless): cv2's libtiff decodes 8-bit JPEG only; None, but for 16
    bits under the grey flag, where libtiff's RGBA reader goes on with
    the zeroed strip buffer."""
    img = _rng(f"j{bits}").integers(0, 1 << bits, (16, 24)).astype(
        np.uint16)
    stream = (libjpeg_encode(img, precision=12, quality=90) if bits == 12
              else libjpeg_encode(img, precision=16, lossless=1))
    data = write_tiff(np.zeros((16, 24), np.uint8), strips=[stream],
                      extra_tags=[(259, 3, [7]), (258, 3, [bits])])
    assert _verdicts(data) == (False, bits == 16)
    _check(data, str(bits))


def test_thunderscan_palette_is_refused_naming_it():
    """ThunderScan 4-bit palettes, once refused naming the variant, read
    as cv2 reads them (libtiff's ThunderDecode)."""
    r = _rng("thunder")
    idx = r.integers(0, 16, (5, 7)).astype(np.uint8)
    raw = np.array([0xC0 | v for v in idx.ravel()], np.uint8)[None]
    cmap = r.integers(0, 65536, (16, 3))
    data = write_tiff(raw, photometric=3, extra_tags=[
        (258, 3, [4]), (256, 4, [7]), (257, 4, [5]), (278, 4, [5]),
        (259, 3, [32809]),
        (320, 3, list(np.asarray(cmap, np.uint16).T.ravel()))])
    assert _verdicts(data) == (True, True)
    _check(data, "ThunderScan")


# -- CIELab and SGILog ------------------------------------------------------

def _cielab_case(seed: int) -> bytes:
    r = np.random.default_rng([25, 8, seed])
    h, w = (int(v) for v in r.integers(1, 40, 2))
    kind = seed % 8
    if kind in (0, 1, 2, 3):
        lab = r.integers(0, 256, (h, w, 3)).astype(np.uint8)
        if kind == 1:  # signed a*/b*: SampleFormat 2
            lab = lab.view(np.int8)
        kw = {}
        if kind == 2:
            kw["extra_tags"] = [(318, 5, [3127, 10000, 3290, 10000])]
        if kind == 3:
            kw = {"order": b"MM", "orientation": int(r.integers(1, 9)),
                  "rows_per_strip": int(r.integers(1, 9))}
        return write_tiff(lab, photometric=8, **kw)
    if kind == 4:  # 16 bits
        return write_tiff(r.integers(0, 65536, (h, w, 3)).astype(np.uint16),
                          photometric=8, rows_per_strip=3)
    if kind == 5:  # tiles of whole KiB (compressed: any size)
        lab = r.integers(0, 256, (h, w, 3)).astype(np.uint8)
        return write_tiff(lab, photometric=8, tile=(32, 32),
                          compression=int(r.choice([1, 5, 8])))
    if kind == 6:  # what libtiff's RGBA reader refuses
        lab = r.integers(0, 256, (h, w, 4)).astype(np.uint8)
        return write_tiff(lab, photometric=8, extra_samples=[2])
    lab = r.integers(0, 256, (h, w, 3)).astype(np.uint8)
    return write_tiff(lab, photometric=8, planar=2)


@pytest.mark.parametrize("seed", range(24))
def test_cielab_as_cv2(seed):
    _check(_cielab_case(seed), f"CIELab {seed}")


def test_cielab_of_one_sample_and_no_white_give_none():
    lab = _rng("lab1").integers(0, 256, (9, 11, 3)).astype(np.uint8)
    for data in (write_tiff(lab[..., 0], photometric=8),
                 write_tiff(lab, photometric=8, extra_tags=[
                     (318, 5, [3127, 10000, 0, 1])])):
        _check(data, "CIELab")
        assert decode_image(data) is None


@pytest.mark.parametrize("compression", ["raw", "tiff_lzw"])
def test_cielab_pillow_as_cv2(compression):
    """Pillow's LAB writer (its bytes as GIS tools write L*a*b* rasters)."""
    r = _rng("pillow_lab" + compression)
    lab = np.stack([r.integers(0, 256, (23, 31)),
                    r.integers(0, 256, (23, 31)),
                    r.integers(0, 256, (23, 31))], -1).astype(np.uint8)
    data = pillow_tiff(lab, "LAB", compression=compression)
    assert struct.unpack_from("<H", data, 0)[0] in (0x4949, 0x4D4D)
    _check(data, f"Pillow LAB {compression}")
    assert decode_image(data) is not None


def _sgilog_case(seed: int) -> bytes:
    r = np.random.default_rng([25, 34676, seed])
    h, w = (int(v) for v in r.integers(1, 30, 2))
    kind = seed % 6
    if kind in (0, 1):  # LogL, SampleFormat 1 / 2 / 3, strips, a cut
        codes = r.integers(0, 65536, (h, w))
        rps = int(r.integers(1, h + 1))
        strips = [sgilog_encode(codes[y:y + rps], "L16")
                  for y in range(0, h, rps)]
        if kind == 1:
            strips[-1] = strips[-1][:len(strips[-1]) * 2 // 3]
        return write_tiff(np.zeros((h, w), np.uint16), photometric=32844,
                          compression=34676, rows_per_strip=rps,
                          sample_format=int(r.choice([1, 1, 2, 3])),
                          orientation=int(r.integers(1, 9)), strips=strips)
    if kind == 2:  # LogL in tiles
        codes = r.integers(0, 65536, (32, 48))
        return write_tiff(np.zeros((h, w), np.uint16), photometric=32844,
                          compression=34676, tile=(16, 16), strips=[
                              sgilog_encode(codes[y:y + 16, x:x + 16], "L16")
                              for y in range(0, -(-h // 16) * 16, 16)
                              for x in range(0, -(-w // 16) * 16, 16)])
    comp, enc = ((34676, "Luv32") if kind in (3, 5) else (34677, "Luv24"))
    if enc == "Luv32":
        codes = (r.integers(0, 65536, (h, w)) << 16) | r.integers(
            0, 65536, (h, w))
    else:
        codes = (r.integers(0, 1024, (h, w)) << 14) | r.integers(
            0, 16384, (h, w))
    rps = int(r.integers(1, h + 1))
    strips = [sgilog_encode(codes[y:y + rps], enc) for y in range(0, h, rps)]
    if kind == 5:
        strips[0] = strips[0][:len(strips[0]) // 2]
    return write_tiff(np.zeros((h, w, 3), np.uint16), photometric=32845,
                      compression=comp, rows_per_strip=rps,
                      sample_format=int(r.choice([1, 2, 3])),
                      orientation=int(r.integers(1, 9)), strips=strips)


@pytest.mark.parametrize("seed", range(36))
def test_sgilog_as_cv2(seed):
    _check(_sgilog_case(seed), f"SGILog {seed}")


def test_sgilog_types_as_cv2():
    """LogL reads as 8 bits (int8 for SampleFormat 2) under both flags,
    LogLuv as float32 BGR under IMREAD_UNCHANGED; LogL of three samples,
    LogL under SGILog24, LogLuv of four samples or separate planes give
    None."""
    r = _rng("sgilog")
    codes = r.integers(0, 65536, (5, 7))
    luv = (codes << 16) | r.integers(0, 65536, (5, 7))
    logl = write_tiff(np.zeros((5, 7), np.uint16), photometric=32844,
                      compression=34676, sample_format=2,
                      strips=[sgilog_encode(codes, "L16")])
    assert decode_image(logl).dtype == np.int8
    assert decode_image(logl, cv2.IMREAD_GRAYSCALE).dtype == np.uint8
    luv32 = write_tiff(np.zeros((5, 7, 3), np.uint16), photometric=32845,
                       compression=34676, strips=[sgilog_encode(luv, "Luv32")])
    got = decode_image(luv32)
    assert got.dtype == np.float32 and got.shape == (5, 7, 3)
    for data in (
            write_tiff(np.zeros((5, 7, 3), np.uint16), photometric=32844,
                       compression=34676,
                       strips=[sgilog_encode(codes, "L16")]),
            write_tiff(np.zeros((5, 7), np.uint16), photometric=32844,
                       compression=34677,
                       strips=[sgilog_encode(codes, "L16")]),
            write_tiff(np.zeros((5, 7, 4), np.uint16), photometric=32845,
                       compression=34676,
                       strips=[sgilog_encode(luv, "Luv32")]),
            write_tiff(np.zeros((5, 7, 3), np.uint16), photometric=32845,
                       compression=34676, planar=2,
                       strips=[sgilog_encode(luv, "Luv32")] * 3)):
        _check(data, "SGILog refused")
        assert decode_image(data) is None


# -- the ZSTD DEM behind a WMS -------------------------------------------

class _Layers(BaseHTTPRequestHandler):
    """GetMap: ``server.replies[layer]`` (content type, body)."""

    def log_message(self, *args):
        pass

    def do_GET(self):
        q = {k.lower(): v[0] for k, v in parse_qs(
            urlparse(self.path).query).items()}
        ctype, body = self.server.replies[q.get("layers", "")]
        self.server.asked.append(q.get("layers"))
        self.send_response(200)
        self.send_header("content-type", ctype)
        self.send_header("content-length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


@pytest.fixture(scope="module")
def zstd_dem_wms():
    """A loopback WMS: the imagery layer a tiled deflate GeoTIFF with
    predictor 2, the DEM a uint16 ZSTD GeoTIFF (Pillow's libtiff)."""
    r = _rng("wms")
    grey = r.integers(0, 256, (64, 64)).astype(np.uint8)
    dem = pillow_tiff(r.integers(0, 3000, (64, 64)).astype(np.uint16),
                      "I;16", compression="zstd", tiffinfo={317: 2})
    server = HTTPServer(("127.0.0.1", 0), _Layers)
    server.replies = {
        "imagery": ("image/tiff", encode_tiff(grey, 8, 2, tile=(32, 32))),
        "dem": ("image/tiff", dem)}
    server.asked = []
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}/wms", grey, server
    server.shutdown()
    server.server_close()
    thread.join(timeout=5)


def test_zstd_dem_orthoimage_equals_jax(zstd_dem_wms):
    """Both packages' ``request_orthoimage``: the same image and a zero DEM
    (cv2 gives None for the ZSTD DEM; the port raised before)."""
    url, grey, _ = zstd_dem_wms
    bb = (24.0, 60.0, 24.01, 60.01)
    got = request_orthoimage(WMSClient(url), bb, (64, 64), ["imagery"],
                             ["dem"], format_="image/tiff")
    want = jax_wms.request_orthoimage(jax_wms.WMSClient(url), bb, (64, 64),
                                      ["imagery"], ["dem"],
                                      format_="image/tiff")
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0], grey)
    assert got[1].dtype == np.float32 and not got[1].any()


def test_gis_node_publishes_over_a_zstd_dem(zstd_dem_wms):
    """The port's GIS node asking for ``image/tiff`` with a DEM layer that
    is ZSTD: it publishes the map with a zero DEM (it published nothing
    before: the decode raised inside its handler)."""
    from gisnav_tpu_torch.geometry.bbox import BBox
    from gisnav_tpu_torch.nodes.bus import LocalBus
    from gisnav_tpu_torch.nodes.gis_node import TOPIC_ORTHOIMAGE, GISNode

    url, _, server = zstd_dem_wms
    bus = LocalBus()
    got = []
    bus.subscribe(TOPIC_ORTHOIMAGE, got.append)
    node = GISNode(bus, params={"wms_url": url, "wms_format": "image/tiff",
                                "wms_layers": ["imagery"],
                                "wms_dem_layers": ["dem"]})
    node._camera_info_cb({"width": 48, "height": 32})
    node._bbox_cb({"stamp_us": 1_000_000, "bbox": BBox(24.0, 60.0, 24.01,
                                                        60.01)})
    del server.asked[:]
    node.tick()
    assert server.asked == ["imagery", "dem"]
    assert len(got) == 1
    msg = got[0]
    assert msg["image"].shape == msg["dem"].shape == (64, 64)
    assert msg["dem"].dtype == np.float32 and not msg["dem"].any()


# -- the committed fixtures --------------------------------------------------

def _fixtures():
    path = os.path.join(FIXTURES, "digests.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def _digest(img):
    if img is None:
        return None
    return {"shape": list(img.shape), "dtype": str(img.dtype),
            "sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes())
            .hexdigest()}


@pytest.mark.parametrize("name", sorted(_fixtures()))
def test_fixture_digests_as_cv2(name):
    """Each committed fixture: its bytes, cv2's digests (no drift) and the
    port's decodes, equal to ``digests.json``."""
    want = _fixtures()[name]
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    assert hashlib.sha256(data).hexdigest() == want["file_sha256"]
    buf = np.frombuffer(data, np.uint8)
    for key, flag in (("unchanged", cv2.IMREAD_UNCHANGED),
                      ("grayscale", cv2.IMREAD_GRAYSCALE)):
        assert _digest(cv2.imdecode(buf, flag)) == want[key], key
        assert _digest(decode_image(data, flag)) == want[key], key
