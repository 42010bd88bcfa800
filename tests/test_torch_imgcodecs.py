"""The port's readers of every other format OpenCV reads (``gis/
imgcodecs.py`` over ``gis/tiff.py``, ``gif.py``, ``bmp.py``, ``pxm.py``,
``sunras.py``, ``hdr.py`` and ``native/imgcodecs.cpp``) against cv2 5.0
(libtiff 4.7 and OpenCV's own decoders), on the CPU. Tolerance: 0 levels,
equal shapes and dtypes, float32 bit for bit; None exactly where cv2 gives
None.

- Seeded variants of each format (``tests/torch_image_writers.py``, cv2's
  own writers), decoded by ``decode_image`` and ``read_image`` under
  ``IMREAD_UNCHANGED`` and ``IMREAD_GRAYSCALE`` against ``cv2.imdecode``
  and ``cv2.imread``: TIFF (type x depth x compression x predictor x
  layout x byte order x orientation), GIF, BMP, PBM / PGM / PPM / PAM, PFM,
  Sun raster, Radiance HDR.
- The variants cv2 reads and the port refuses raise ``ValueError`` naming
  them (``tests/test_torch_tiff_variants.py`` holds the TIFFs cv2 gives
  None for); the signature dispatch; bytes after a matching signature that
  fail their header give None.
- ``replay.load_dataset`` of both packages on a GIS export (a tiled
  deflate GeoTIFF map, float32 and int16 GeoTIFF DEMs, TIFF / PGM / BMP
  frames), and both packages' WMS clients on ``image/tiff`` and
  ``image/gif`` replies (a float DEM reply comes back as zeros in both).
"""
import os
import tempfile

import cv2
import numpy as np
import pytest

from gisnav_tpu.gis import wms as jax_wms
from gisnav_tpu import replay as jreplay
from gisnav_tpu_torch import replay as treplay
from gisnav_tpu_torch.gis.imgcodecs import (decode_image, image_format,
                                            read_image)
from gisnav_tpu_torch.gis.png import decode_png
from gisnav_tpu_torch.gis.tiff import encode_tiff
from gisnav_tpu_torch.gis.wms import WMSClient, request_orthoimage
from gisnav_tpu_torch.utils.world_wms import World, write_replay_dataset
from tests.test_torch_nodes import _serve
from tests.torch_image_writers import (bmp_rle_encode, gif_frame,
                                       hdr_rle_line, thunder_encode,
                                       write_bmp, write_gif, write_hdr,
                                       write_sun, write_tiff)

cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_SILENT)
FLAGS = (cv2.IMREAD_UNCHANGED, cv2.IMREAD_GRAYSCALE)
H, W = 13, 17


def _rng(name: str) -> np.random.Generator:
    return np.random.default_rng(sum(map(ord, name)))


def _assert_same(ref, got, what):
    assert (ref is None) == (got is None), what
    if ref is not None:
        assert got.dtype == ref.dtype and got.shape == ref.shape, (
            what, got.dtype, got.shape, ref.dtype, ref.shape)
        np.testing.assert_array_equal(got, ref, err_msg=what)


def _check(data: bytes):
    """decode_image = cv2.imdecode and read_image = cv2.imread, both
    flags."""
    buf = np.frombuffer(data, np.uint8)
    for flag in FLAGS:
        _assert_same(cv2.imdecode(buf, flag), decode_image(data, flag),
                     f"imdecode flag {flag}")
    with tempfile.NamedTemporaryFile(suffix=".bin", delete=False) as f:
        f.write(data)
    try:
        for flag in FLAGS:
            _assert_same(cv2.imread(f.name, flag), read_image(f.name, flag),
                         f"imread flag {flag}")
    finally:
        os.unlink(f.name)


# -- TIFF ----------------------------------------------------------------

_DTYPES = ("u1", "i1", "u2", "i2", "u4", "i4", "f4", "f8")


def _samples(rng, dtype, c):
    dt = np.dtype(dtype)
    top = 256 if dt.itemsize == 1 else 70000
    a = rng.integers(0, top, (H, W, c))
    if dt.kind == "f":
        return (a * 0.37 - 900).astype(dt)
    return a.astype(dt)


TIFF_BASE = [(d, c, comp, pred)
             for d in _DTYPES for c in (1, 3, 4)
             for comp, pred in ((1, 1), (5, 2), (8, 1), (32946, 3),
                                (32773, 1))
             if not (pred == 3 and d[0] != "f")
             and not (pred == 2 and d[0] == "f")]


@pytest.mark.parametrize("order", [b"II", b"MM"], ids=["II", "MM"])
@pytest.mark.parametrize("dtype,c,comp,pred", TIFF_BASE,
                         ids=lambda v: str(v))
def test_tiff_types_as_cv2(dtype, c, comp, pred, order):
    rng = _rng(f"{dtype}{c}{comp}{pred}")
    extra = [2] if c == 4 else None
    _check(write_tiff(_samples(rng, dtype, c), order=order,
                      compression=comp, predictor=pred, extra_samples=extra,
                      rows_per_strip=5))


TIFF_LAYOUTS = {
    "tiles16": dict(tile=(16, 16)),
    "tiles32x16_raw": dict(tile=(32, 16)),  # imdecode None, imread reads
    "tiles32": dict(tile=(32, 32)),
    "bigtiff": dict(bigtiff=True),
    "bigtiff_mm_tiles": dict(bigtiff=True, order=b"MM", tile=(16, 16)),
    "strip1": dict(rows_per_strip=1),
    "lzw_old": dict(compression=5, lzw_old=True, rows_per_strip=4),
    "fill_order2": dict(fill_order=2, compression=5),
}


@pytest.mark.parametrize("c", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", ["u1", "u2", "f4"])
@pytest.mark.parametrize("layout", sorted(TIFF_LAYOUTS))
def test_tiff_layouts_as_cv2(layout, dtype, c):
    kw = dict(TIFF_LAYOUTS[layout])
    rng = _rng(f"{layout}{dtype}{c}")
    if c == 2:
        kw["extra_samples"] = [2]
    if dtype == "u1" and "compression" not in kw:
        kw["compression"] = 8
        kw["predictor"] = 2
    data = write_tiff(_samples(rng, dtype, c), **kw)
    if c == 2 and dtype == "f4":  # cv2: None (8-bit sample format check)
        assert decode_image(data) is None
        return
    _check(data)


@pytest.mark.parametrize("square", [False, True], ids=["13x17", "17x17"])
@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("dtype,c", [("u1", 1), ("u1", 3), ("u2", 1),
                                     ("u2", 3), ("i2", 1), ("f4", 1)])
@pytest.mark.parametrize("o", range(1, 9))
def test_tiff_orientation_as_cv2(o, dtype, c, tiled, square):
    """cv2.imread gives None where a transposing orientation changes the
    image's shape (a square one is turned in place)."""
    rng = _rng(f"o{o}{dtype}{c}")
    kw = dict(tile=(16, 16), compression=8) if tiled else dict(
        rows_per_strip=4)
    a = _samples(rng, dtype, c)
    if square:
        a = np.concatenate([a, a[:4]])
    _check(write_tiff(a, orientation=o, **kw))


TIFF_KINDS = {
    "bits1": lambda r: write_tiff(r.integers(0, 2, (H, W)).astype(
        np.uint8), bits=1),
    "bits1_miniswhite": lambda r: write_tiff(r.integers(0, 2, (H, W))
                                             .astype(np.uint8), bits=1,
                                             photometric=0),
    "bits2_grey": lambda r: write_tiff(r.integers(0, 4, (H, W)).astype(
        np.uint8), bits=2),
    "bits4_grey": lambda r: write_tiff(r.integers(0, 16, (H, W)).astype(
        np.uint8), bits=4),
    "miniswhite8": lambda r: write_tiff(r.integers(0, 256, (H, W)).astype(
        np.uint8), photometric=0, compression=5),
    "miniswhite16": lambda r: write_tiff(r.integers(0, 65536, (H, W))
                                         .astype(np.uint16), photometric=0),
    "palette8": lambda r: write_tiff(r.integers(0, 256, (H, W)).astype(
        np.uint8), photometric=3, colormap=r.integers(0, 65536, (256, 3))),
    "palette8_8bit_map": lambda r: write_tiff(
        r.integers(0, 256, (H, W)).astype(np.uint8), photometric=3,
        colormap=r.integers(0, 256, (256, 3))),
    "palette4_tiles": lambda r: write_tiff(
        r.integers(0, 16, (H, W)).astype(np.uint8), bits=4, photometric=3,
        colormap=r.integers(0, 65536, (16, 3)), tile=(16, 16),
        compression=8),
    "palette2": lambda r: write_tiff(r.integers(0, 4, (H, W)).astype(
        np.uint8), bits=2, photometric=3,
        colormap=r.integers(0, 65536, (4, 3))),
    "palette1": lambda r: write_tiff(r.integers(0, 2, (H, W)).astype(
        np.uint8), bits=1, photometric=3,
        colormap=r.integers(0, 65536, (2, 3))),
    "cmyk8": lambda r: write_tiff(r.integers(0, 256, (H, W, 4)).astype(
        np.uint8), photometric=5, compression=5),
    "cmyk16": lambda r: write_tiff(r.integers(0, 65536, (H, W, 4)).astype(
        np.uint16), photometric=5),
    "rgba_assoc": lambda r: write_tiff(r.integers(0, 256, (H, W, 4))
                                       .astype(np.uint8), extra_samples=[1]),
    "rgba_no_extra": lambda r: write_tiff(r.integers(0, 256, (H, W, 4))
                                          .astype(np.uint8)),
    "rgba16_unassoc_tiles": lambda r: write_tiff(
        r.integers(0, 65536, (H, W, 4)).astype(np.uint16),
        extra_samples=[2], tile=(16, 16), compression=8, predictor=2),
    "grey_alpha8_tiles": lambda r: write_tiff(
        r.integers(0, 256, (H, W, 2)).astype(np.uint8), extra_samples=[2],
        tile=(16, 16), compression=8),
    "grey_2extra16": lambda r: write_tiff(
        r.integers(0, 65536, (H, W, 3)).astype(np.uint16), photometric=1,
        extra_samples=[0, 0]),
    "rgb_planar2_u8": lambda r: write_tiff(
        r.integers(0, 256, (H, W, 3)).astype(np.uint8), planar=2,
        compression=8, predictor=2),
    "rgba_planar2_u8_tiles": lambda r: write_tiff(
        r.integers(0, 256, (H, W, 4)).astype(np.uint8), planar=2,
        extra_samples=[2], tile=(16, 16), compression=5),
    "five_samples": lambda r: write_tiff(
        r.integers(0, 256, (H, W, 5)).astype(np.uint8),
        extra_samples=[0, 0]),
    "f16": lambda r: write_tiff(r.random((H, W)).astype(np.float16)),
    "no_photometric": lambda r: write_tiff(
        r.integers(0, 256, (H, W)).astype(np.uint8), omit=[262]),
    "no_bits": lambda r: write_tiff(r.integers(0, 2, (H, W)).astype(
        np.uint8), bits=1, omit=[258]),
    "int16_dem_tiles_mm": lambda r: write_tiff(
        r.integers(-400, 3000, (H, W)).astype(np.int16), order=b"MM",
        tile=(16, 16), compression=8, predictor=2),
    "f64_pred3": lambda r: write_tiff(r.random((H, W, 3)) * 9,
                                      compression=8, predictor=3),
    "u64_pred2": lambda r: write_tiff(r.integers(0, 1 << 40, (H, W)).astype(
        np.uint64), compression=8, predictor=2),
    "truncated": lambda r: write_tiff(r.integers(0, 256, (H, W)).astype(
        np.uint8))[:40],
    "zero_bytecount": lambda r: write_tiff(
        r.integers(0, 256, (H, W)).astype(np.uint8),
        extra_tags=[(279, 4, [0])]),
    "encode_tiff_f32_geo": lambda r: encode_tiff(
        r.random((H, W)).astype(np.float32), 8, 3, tile=(16, 16),
        geo=(24.0, 60.0, 1e-4, 5e-5)),
    "encode_tiff_u16": lambda r: encode_tiff(
        r.integers(0, 65536, (H, W)).astype(np.uint16), 8, 2),
}
for _ss in ((1, 1), (2, 1), (2, 2), (4, 2), (4, 1), (1, 2)):
    for _kw in ({}, {"rows_per_strip": 4}, {"tile": (16, 16)}):
        TIFF_KINDS[f"ycbcr{_ss[0]}{_ss[1]}_{sorted(_kw)}"] = (
            lambda r, ss=_ss, kw=_kw: write_tiff(
                r.integers(0, 256, (H, W, 3)).astype(np.uint8),
                photometric=6, subsampling=ss, compression=8, **kw))
TIFF_KINDS["ycbcr44_strips_odd_width"] = lambda r: write_tiff(
    r.integers(0, 256, (H, W, 3)).astype(np.uint8), photometric=6,
    subsampling=(4, 4))
TIFF_KINDS["ccitt_fax4"] = lambda r: _pillow_tiff("1", compression="group4")
TIFF_KINDS["ycbcr44_tiles"] = lambda r: write_tiff(
    r.integers(0, 256, (H, W, 3)).astype(np.uint8), photometric=6,
    subsampling=(4, 4), tile=(16, 16), compression=8)
TIFF_KINDS["ycbcr22_refbw"] = lambda r: write_tiff(
    r.integers(0, 256, (16, 16, 3)).astype(np.uint8), photometric=6,
    subsampling=(2, 2), extra_tags=[
        (532, 5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1]),
        (529, 5, [299, 1000, 587, 1000, 114, 1000])])


@pytest.mark.parametrize("kind", sorted(TIFF_KINDS))
def test_tiff_kinds_as_cv2(kind):
    _check(TIFF_KINDS[kind](_rng(kind)))


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("mode", ["L", "RGB", "YCbCr", "CMYK"])
def test_tiff_jpeg_as_cv2(mode, tiled):
    """JPEG-in-TIFF as libtiff writes it (Pillow), with JPEGTables, in
    strips and in tiles."""
    kw = {"compression": "jpeg"}
    if tiled:
        kw["tile"] = (16, 16)
    _check(_pillow_tiff(mode, **kw))


def _thunderscan(kind: str, r):
    """A 4-bit palette ThunderScan TIFF: raw codes, runs and deltas (the
    writer's), random codes (libtiff's damage rules), or 5-row strips."""
    idx = np.cumsum(r.integers(-1, 2, (H, W)), axis=1) % 16
    idx[:, :W // 3] = idx[:, :1]
    rps = 5 if kind == "strips" else H
    strips = [thunder_encode(idx[y:y + rps], raw_only=kind == "raw")
              for y in range(0, H, rps)]
    if kind == "random":
        strips = [r.integers(0, 256, len(s)).astype(np.uint8).tobytes()
                  for s in strips]
    return write_tiff(np.zeros((H, W), np.uint8), strips=strips,
                      photometric=3, extra_tags=[
        (258, 3, [4]), (259, 3, [32809]), (278, 4, [rps]),
        (320, 3, list(np.asarray(r.integers(0, 65536, (16, 3)),
                                 np.uint16).T.ravel()))])


@pytest.mark.parametrize("kind", ["raw", "deltas", "strips", "random"])
def test_tiff_thunderscan_as_cv2(kind):
    """ThunderScan 4-bit palettes (libtiff's ThunderDecode, quirks and
    damage included) read as cv2 reads them."""
    _check(_thunderscan(kind, _rng("thunderscan_" + kind)))


# the variants cv2 reads that the port refuses (band-interleaved samples
# over 8 bits: cv2's pixels are undefined there)
REFUSED_TIFF = {
    "planar2_u16": (lambda r: write_tiff(
        r.integers(0, 65536, (H, W, 3)).astype(np.uint16), planar=2),
        "PlanarConfiguration 2", (cv2.IMREAD_UNCHANGED,)),
    "planar2_f32_tiles": (lambda r: write_tiff(
        r.random((H, W, 3)).astype(np.float32), planar=2, tile=(16, 16)),
        "PlanarConfiguration 2", (cv2.IMREAD_UNCHANGED,)),
}


def _pillow_tiff(mode: str, **kw) -> bytes:
    """A TIFF written by Pillow's libtiff in a subprocess (Pillow's libtiff
    and cv2's cannot share one process) from a seeded 37x53 image."""
    import subprocess
    import sys

    script = (
        "import io, sys, numpy as np\nfrom PIL import Image\n"
        "rng = np.random.default_rng(5)\n"
        "src = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)\n"
        "src[:, :20] = src[:, :1]\n"
        f"im = Image.fromarray(src).convert({mode!r})\n"
        "b = io.BytesIO()\n"
        f"im.save(b, 'TIFF', **{kw!r})\n"
        "sys.stdout.buffer.write(b.getvalue())\n")
    return subprocess.run([sys.executable, "-c", script], check=True,
                          capture_output=True, timeout=60).stdout


@pytest.mark.parametrize("name", sorted(REFUSED_TIFF))
def test_tiff_refusals_name_the_variant(name):
    build, what, flags = REFUSED_TIFF[name]
    data = build(_rng(name))
    for flag in flags:
        assert cv2.imdecode(np.frombuffer(data, np.uint8), flag) is not None
        with pytest.raises(ValueError, match=what):
            decode_image(data, flag)


# -- GIF -----------------------------------------------------------------

def _gif(name):
    r = _rng(name)
    pal = r.integers(0, 256, (256, 3))
    n = 16 if "16" in name else 256
    idx = r.integers(0, n, (H, W)).astype(np.uint8)
    idx[:, :6] = idx[:, :1]
    frames = {
        "plain16": [gif_frame(idx)],
        "plain256": [gif_frame(idx)],
        "interlace16": [gif_frame(idx, interlace=True)],
        "transparent16": [gif_frame(idx, transparent=3)],
        "local16": [gif_frame(idx, local_palette=pal[16:32])],
        "sub_screen16": [gif_frame(idx, left=2, top=3)],
        "sub_screen_transparent16": [gif_frame(idx, left=4, top=1,
                                               transparent=0)],
        "second_frame_transparent16": [gif_frame(idx),
                                       gif_frame(idx, transparent=1)],
        "index_past_table16": [gif_frame(idx)],
    }[name]
    screen = (H + 5, W + 7) if "sub_screen" in name else (H, W)
    gct = None if name.startswith("local") else pal[:n]
    if name == "index_past_table16":
        gct = pal[:8]
    return write_gif(screen, frames, gct, background=5 if gct is not None
                     and len(gct) > 5 else 0)


GIFS = ["plain16", "plain256", "interlace16", "transparent16", "local16",
        "sub_screen16", "sub_screen_transparent16",
        "second_frame_transparent16", "index_past_table16"]


@pytest.mark.parametrize("name", GIFS)
def test_gif_as_cv2(name):
    _check(_gif(name))


@pytest.mark.parametrize("what", ["no_trailer", "cut", "junk_block",
                                  "87a", "cv2_bgr", "cv2_bgra"])
def test_gif_stream_rules_as_cv2(what):
    r = _rng(what)
    base = _gif("plain16")
    data = {"no_trailer": base[:-1], "cut": base[:len(base) // 2],
            "junk_block": base[:-1] + b"\x00\x3b",
            "87a": base[:3] + b"87a" + base[6:]}.get(what)
    if data is None:
        img = r.integers(0, 256, (H, W, 3)).astype(np.uint8)
        if what == "cv2_bgra":
            img = np.concatenate([img, (img[..., :1] > 128).astype(
                np.uint8) * 255], axis=2)
        data = cv2.imencode(".gif", img)[1].tobytes()
    _check(data)


# -- BMP -----------------------------------------------------------------

def _bmp(bits, header, palette_kind, top_down, r):
    if bits <= 8:
        idx = r.integers(0, 1 << bits, (H, W)).astype(np.uint8)
        pal = r.integers(0, 256, (1 << bits, 3))
        if palette_kind == "grey":
            pal = np.repeat(pal[:, :1], 3, axis=1)
        return write_bmp(idx, bits, pal, header=header, top_down=top_down)
    if bits == 16:
        return write_bmp(r.integers(0, 65536, (H, W)).astype(np.uint16), 16,
                         header=header, top_down=top_down)
    return write_bmp(r.integers(0, 256, (H, W, bits // 8)).astype(np.uint8),
                     bits, header=header, top_down=top_down)


BMP_FILES = [(bits, header, kind, down)
             for bits in (1, 4, 8, 16, 24, 32) for header in (12, 40, 108, 124)
             for kind in (("colour", "grey") if bits <= 8 else ("colour",))
             for down in (False, True)
             if not (header == 12 and (down or bits == 16))]


@pytest.mark.parametrize("bits,header,palette_kind,top_down", BMP_FILES,
                         ids=lambda v: str(v))
def test_bmp_as_cv2(bits, header, palette_kind, top_down):
    _check(_bmp(bits, header, palette_kind, top_down,
                _rng(f"{bits}{header}{palette_kind}")))


BMP_BITFIELDS = {
    "16_565": (16, (0xF800, 0x7E0, 0x1F), 40),
    "16_555": (16, (0x7C00, 0x3E0, 0x1F), 40),
    "16_444": (16, (0xF00, 0xF0, 0xF), 40),
    "16_565_v4": (16, (0xF800, 0x7E0, 0x1F, 0), 108),
    "32_40": (32, (0xFF0000, 0xFF00, 0xFF), 40),
    "32_v5_alpha": (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000), 124),
    "32_v5_no_alpha": (32, (0xFF0000, 0xFF00, 0xFF, 0), 124),
    "32_v4_rgba": (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000), 108),
    "32_v5_argb": (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF), 124),
}


@pytest.mark.parametrize("name", sorted(BMP_BITFIELDS))
def test_bmp_bitfields_as_cv2(name):
    bits, masks, header = BMP_BITFIELDS[name]
    r = _rng(name)
    px = (r.integers(0, 65536, (H, W)).astype(np.uint16) if bits == 16
          else r.integers(0, 256, (H, W, 4)).astype(np.uint8))
    _check(write_bmp(px, bits, compression=3, masks=masks, header=header))


BMP_RLE = {
    "rle8_eof_early": (8, [3, 5, 0, 1]),
    "rle8_eol_early": (8, [3, 5, 0, 0, 2, 7, 0, 0, 0, 1]),
    "rle8_delta": (8, [2, 5, 0, 2, 3, 1, 2, 9, 0, 1]),
    "rle8_run_wraps": (8, [15, 6, 0, 0, 3, 3, 0, 1]),
    "rle8_run_fills_row_then_eol": (8, [10, 6, 0, 0, 3, 3, 0, 1]),
    "rle8_absolute": (8, [0, 3, 1, 2, 3, 0, 0, 4, 4, 5, 6, 7, 0, 0, 0, 1]),
    "rle8_no_eof": (8, [10, 6, 10, 7]),
    "rle4_full": (4, [10, 0x12, 0, 0] * 5 + [10, 0x12, 0, 1]),
    "rle4_eof_mid_bitmap": (4, [10, 0x12, 0, 0] * 3 + [0, 1]),
    "rle4_delta_dy": (4, [2, 0x55, 0, 2, 3, 1, 2, 0x99, 0, 0]
                      + [10, 0x12, 0, 0] * 3 + [0, 1]),
    "rle4_delta_dx": (4, [2, 0x55, 0, 2, 3, 0, 2, 0x99, 0, 0]
                      + [10, 0x12, 0, 0] * 4 + [0, 1]),
    "rle4_absolute": (4, [0, 3, 0x12, 0x30, 0, 5, 0x45, 0x67, 0x80, 0, 0, 0]
                      + [10, 0x12, 0, 0] * 4 + [0, 1]),
}


@pytest.mark.parametrize("name", sorted(BMP_RLE))
def test_bmp_rle_streams_as_cv2(name):
    bits, stream = BMP_RLE[name]
    pal = _rng(name).integers(0, 256, (1 << bits, 3))
    _check(write_bmp(np.zeros((6, 10), np.uint8), bits, pal,
                     compression=1 if bits == 8 else 2, data=bytes(stream)))


@pytest.mark.parametrize("k", [2, 5, 16])
@pytest.mark.parametrize("bits", [4, 8])
def test_bmp_rle_encoded_images_as_cv2(bits, k):
    r = _rng(f"rle{bits}{k}")
    idx = r.integers(0, k, (H, W)).astype(np.uint8)
    idx[:, 4:11] = 1
    pal = r.integers(0, 256, (1 << bits, 3))
    _check(write_bmp(idx, bits, pal, compression=1 if bits == 8 else 2,
                     data=bmp_rle_encode(idx[::-1], bits == 4)))


@pytest.mark.parametrize("img", ["grey", "bgr", "bgra", "bgra_bitfields"])
def test_bmp_cv2_written_as_cv2(img):
    r = _rng(img)
    a = r.integers(0, 256, (H, W, 4)).astype(np.uint8)
    a = {"grey": a[..., 0], "bgr": a[..., :3]}.get(img, a)
    params = [cv2.IMWRITE_BMP_COMPRESSION,
              cv2.IMWRITE_BMP_COMPRESSION_BITFIELDS] if "bitfields" in img \
        else []
    _check(cv2.imencode(".bmp", a, params)[1].tobytes())


# -- Netpbm, PAM, PFM ------------------------------------------------------

@pytest.mark.parametrize("binary", [0, 1])
@pytest.mark.parametrize("kind", ["pgm8", "pgm16", "ppm8", "ppm16", "pbm"])
def test_pxm_cv2_written_as_cv2(kind, binary):
    r = _rng(kind)
    img = r.integers(0, 65536 if "16" in kind else 256, (H, W, 3)).astype(
        np.uint16 if "16" in kind else np.uint8)
    img = img if kind.startswith("ppm") else img[..., 0]
    if kind == "pbm":
        img = (img > 127).astype(np.uint8) * 255
    ext = "." + kind[:3]
    _check(cv2.imencode(ext, img, [cv2.IMWRITE_PXM_BINARY, binary])[1]
           .tobytes())


def _pnm(kind, maxval, body, comment=b""):
    head = b"P%d\n%s%d %d\n" % (kind, comment, W, H)
    return head + (b"%d\n" % maxval if maxval is not None else b"") + body


def _ascii(values):
    return b" ".join(b"%d" % v for v in np.asarray(values).ravel()) + b"\n"


PNM = {
    "p5_maxval100": lambda r: _pnm(5, 100, r.integers(0, 101, (H, W))
                                   .astype(np.uint8).tobytes()),
    "p5_maxval100_over": lambda r: _pnm(5, 100, r.integers(0, 256, (H, W))
                                        .astype(np.uint8).tobytes()),
    "p2_maxval100": lambda r: _pnm(2, 100, _ascii(r.integers(0, 101,
                                                              (H, W)))),
    "p2_over_maxval": lambda r: _pnm(2, 100, _ascii(r.integers(0, 256,
                                                                (H, W)))),
    "p2_no_final_newline": lambda r: _pnm(2, 255, _ascii(
        r.integers(0, 256, (H, W)))[:-1]),
    "p2_comments": lambda r: _pnm(2, 255, b"# in the data\n" + _ascii(
        r.integers(0, 256, (H, W))), comment=b"# a comment\n"),
    "p3_maxval1000": lambda r: _pnm(3, 1000, _ascii(r.integers(0, 1001,
                                                                (H, W, 3)))),
    "p6_maxval1000": lambda r: _pnm(6, 1000, r.integers(
        0, 1001, (H, W, 3)).astype(">u2").tobytes()),
    "p5_short": lambda r: _pnm(5, 255, r.integers(0, 256, (H, W)).astype(
        np.uint8).tobytes()[:-5]),
    "p1_packed_digits": lambda r: b"P1\n%d %d\n" % (W, H) + b"".join(
        b"%d" % v for v in r.integers(0, 2, H * W)) + b"\n",
    "p4_cut": lambda r: _pnm(4, None, np.packbits(r.integers(
        0, 2, (H, W)).astype(bool), axis=1).tobytes()[:-1]),
    "p5_tabs": lambda r: b"P5\t%d\t%d\t255\t" % (W, H) + r.integers(
        0, 256, (H, W)).astype(np.uint8).tobytes(),
    "pam_grey100": lambda r: (
        b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH 1\nMAXVAL 100\nTUPLTYPE GRAYSCALE"
        b"\nENDHDR\n" % (W, H) + r.integers(0, 101, (H, W)).astype(
            np.uint8).tobytes()),
    "pam_rgb_no_tupltype": lambda r: (
        b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH 3\nMAXVAL 255\nENDHDR\n" % (W, H)
        + r.integers(0, 256, (H, W, 3)).astype(np.uint8).tobytes()),
    "pam_rgb16": lambda r: (
        b"P7\n# c\nWIDTH %d\nHEIGHT %d\nDEPTH 3\nMAXVAL 65535\nTUPLTYPE RGB"
        b"\nENDHDR\n" % (W, H) + r.integers(0, 65536, (H, W, 3)).astype(
            ">u2").tobytes()),
    "pam_grey_alpha": lambda r: (
        b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH 2\nMAXVAL 255\nTUPLTYPE "
        b"GRAYSCALE_ALPHA\nENDHDR\n" % (W, H) + r.integers(
            0, 256, (H, W, 2)).astype(np.uint8).tobytes()),
    "pam_blackandwhite": lambda r: (
        b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH 1\nMAXVAL 1\nTUPLTYPE BLACKANDWHITE"
        b"\nENDHDR\n" % (W, H) + r.integers(0, 256, (H, W)).astype(
            np.uint8).tobytes()),
    "pam_tupltype_mismatch": lambda r: (
        b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH 3\nMAXVAL 255\nTUPLTYPE GRAYSCALE"
        b"\nENDHDR\n" % (W, H) + r.integers(0, 256, (H, W, 3)).astype(
            np.uint8).tobytes()),
    "pfm_grey_le_scale2": lambda r: b"Pf\n%d %d\n-2.0\n" % (W, H) + (
        r.random((H, W)) * 500).astype("<f4").tobytes(),
    "pfm_grey_be_half": lambda r: b"Pf\n%d %d\n0.5\n" % (W, H) + (
        r.random((H, W)) * 100).astype(">f4").tobytes(),
    "pfm_rgb_le": lambda r: b"PF\n%d %d\n-1.0\n" % (W, H) + (
        r.random((H, W, 3)) * 300 - 20).astype("<f4").tobytes(),
    "pfm_rgb_be_scale3": lambda r: b"PF\n%d %d\n3\n" % (W, H) + (
        r.random((H, W, 3)) * 300 - 20).astype(">f4").tobytes(),
    "pfm_cv2": lambda r: cv2.imencode(".pfm", (r.random((H, W, 3)) * 2)
                                      .astype(np.float32))[1].tobytes(),
}


@pytest.mark.parametrize("name", sorted(PNM))
def test_pnm_pam_pfm_as_cv2(name):
    _check(PNM[name](_rng(name)))


def test_pam_rgba_grey_is_refused():
    """cv2 leaves part of each grey row of an RGB_ALPHA PAM unwritten."""
    data = cv2.imencode(".pam", _rng("rgba").integers(
        0, 256, (H, W, 4)).astype(np.uint8), [
        cv2.IMWRITE_PAM_TUPLETYPE, cv2.IMWRITE_PAM_FORMAT_RGB_ALPHA])[1]
    _assert_same(cv2.imdecode(data, cv2.IMREAD_UNCHANGED),
                 decode_image(data.tobytes()), "unchanged")
    with pytest.raises(ValueError, match="RGB_ALPHA"):
        decode_image(data.tobytes(), cv2.IMREAD_GRAYSCALE)


# -- Sun raster and Radiance ------------------------------------------------

SUN = {
    "map8": lambda r: write_sun(r.integers(0, 256, (H, W)).astype(np.uint8),
                                8, r.integers(0, 256, (256, 3))),
    "greymap8": lambda r: write_sun(r.integers(0, 256, (H, W)).astype(
        np.uint8), 8, np.repeat(np.arange(256)[:, None], 3, axis=1)),
    "map8_short": lambda r: write_sun(r.integers(0, 100, (H, W)).astype(
        np.uint8), 8, r.integers(0, 256, (100, 3))),
    "nomap8": lambda r: write_sun(r.integers(0, 256, (H, W)).astype(
        np.uint8), 8),
    "map1": lambda r: write_sun(r.integers(0, 2, (H, W)).astype(np.uint8),
                                1, r.integers(0, 256, (2, 3))),
    "nomap1": lambda r: write_sun(r.integers(0, 2, (H, W)).astype(
        np.uint8), 1),
    "bgr24": lambda r: write_sun(r.integers(0, 256, (H, W, 3)).astype(
        np.uint8), 24),
    "xbgr32": lambda r: write_sun(r.integers(0, 256, (H, W, 4)).astype(
        np.uint8), 32),
    "old_type0": lambda r: write_sun(r.integers(0, 256, (H, W, 3)).astype(
        np.uint8), 24, kind=0),
    "rle_type2": lambda r: write_sun(r.integers(0, 4, (H, W)).astype(
        np.uint8), 8, r.integers(0, 256, (256, 3)), kind=2),
    "rgb_type3": lambda r: write_sun(r.integers(0, 256, (H, W, 3)).astype(
        np.uint8), 24, kind=3),
    "cv2_grey": lambda r: cv2.imencode(".ras", r.integers(0, 256, (H, W))
                                       .astype(np.uint8))[1].tobytes(),
    "cv2_bgr": lambda r: cv2.imencode(".ras", r.integers(
        0, 256, (H, W, 3)).astype(np.uint8))[1].tobytes(),
    "cut": lambda r: write_sun(r.integers(0, 256, (H, W, 3)).astype(
        np.uint8), 24)[:-3],
}


@pytest.mark.parametrize("name", sorted(SUN))
def test_sun_raster_as_cv2(name):
    _check(SUN[name](_rng(name)))


def _rgbe(r, h=H, w=W, exponents=(0, 256)):
    rgbe = r.integers(0, 256, (h, w, 4)).astype(np.uint8)
    rgbe[..., 3] = r.integers(*exponents, (h, w))
    rgbe[:, :w // 3, :3] = 7  # runs
    return rgbe


HDR = {
    "rle": lambda r: write_hdr(_rgbe(r)),
    "rle_mid_exponents": lambda r: write_hdr(_rgbe(r, exponents=(120, 140))),
    "flat": lambda r: write_hdr(_rgbe(r), rle=False),
    "rgbe_signature": lambda r: write_hdr(
        _rgbe(r), header=b"#?RGBE\nFORMAT=32-bit_rle_rgbe\n\n"),
    "narrow_flat": lambda r: write_hdr(_rgbe(r, w=5), rle=False),
    "wide_rle": lambda r: write_hdr(_rgbe(r, h=3, w=300)),
    "rle_then_flat": lambda r: (
        b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y %d +X %d\n" % (H, W)
        + hdr_rle_line(_rgbe(r)[0]) + _rgbe(r)[1:].tobytes()),
    "old_style_run": lambda r: write_hdr(np.concatenate(
        [_rgbe(r)[:1], np.full((1, W, 4), 1, np.uint8), _rgbe(r)[2:]]),
        rle=False),
    "exposure_gamma": lambda r: write_hdr(_rgbe(r), header=(
        b"#?RADIANCE\nEXPOSURE=2.0\nFORMAT=32-bit_rle_rgbe\nGAMMA=2.2\n\n")),
    "long_header_line": lambda r: write_hdr(_rgbe(r), header=(
        b"#?RADIANCE\n" + b"A" * 200 + b"\nFORMAT=32-bit_rle_rgbe\n\n")),
    "xyze": lambda r: write_hdr(_rgbe(r), header=(
        b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n")),
    "no_format": lambda r: write_hdr(_rgbe(r), header=b"#?RADIANCE\n\n"),
    "plus_y": lambda r: b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n+Y %d +X %d"
                        b"\n" % (H, W) + _rgbe(r).tobytes(),
    "cut": lambda r: write_hdr(_rgbe(r), rle=False)[:-10],
    "cv2": lambda r: cv2.imencode(".hdr", (r.random((H, W, 3)) * 3).astype(
        np.float32))[1].tobytes(),
    "cv2_flat": lambda r: cv2.imencode(".hdr", (r.random((H, W, 3)) * 3)
                                       .astype(np.float32), [
        cv2.IMWRITE_HDR_COMPRESSION,
        cv2.IMWRITE_HDR_COMPRESSION_NONE])[1].tobytes(),
}


@pytest.mark.parametrize("name", sorted(HDR))
def test_radiance_as_cv2(name):
    _check(HDR[name](_rng(name)))


# -- dispatch ---------------------------------------------------------------

SIGNED = {
    "BMP": b"BM", "HDR": b"#?RADIANCE\n", "JPEG": b"\xff\xd8\xff\xe0",
    "Sun raster": b"\x59\xa6\x6a\x95", "PxM": b"P5\n", "PAM": b"P7\n",
    "PFM": b"Pf\n", "TIFF": b"II*\0", "PNG": b"\x89PNG\r\n\x1a\n",
    "GIF": b"GIF89a",
}


@pytest.mark.parametrize("fmt", sorted(SIGNED))
def test_signature_then_bad_header_gives_none(fmt):
    """A matching signature decides the decoder; a bad header after it is
    None in cv2 (no other decoder is tried) and in the port (``decode_png``
    alone raises on a malformed PNG)."""
    data = SIGNED[fmt] + b"\xee" * 40
    assert image_format(data) == fmt
    for flag in FLAGS:
        assert cv2.imdecode(np.frombuffer(data, np.uint8), flag) is None
        assert decode_image(data, flag) is None
    if fmt == "PNG":
        with pytest.raises(ValueError):
            decode_png(data)


@pytest.mark.parametrize("data", [b"P5x", b"P8\n", b"#?RGB", b"MM\0+",
                                  b"GIF88a", b"\x59\xa6\x6a", b"B",
                                  b"\0\0\0\0", b"Pf"],
                         ids=lambda d: repr(d))
def test_near_signatures_are_no_format(data):
    data = data + b"\0" * 64 if data != b"MM\0+" else data
    assert image_format(data) in (None, "TIFF")
    for flag in FLAGS:
        ref = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
        assert ref is None
        assert decode_image(data, flag) is None


@pytest.mark.parametrize("fmt", ["WebP", "JPEG 2000", "AVIF"])
def test_formats_not_ported_raise(fmt):
    """AVIF, which cv2 reads, raises naming itself; WebP (``gis/webp.py``)
    and JPEG 2000 (``gis/jpeg2000.py``) are read as cv2 reads them."""
    img = _rng(fmt).integers(0, 256, (64, 64, 3)).astype(np.uint8)
    ext = {"WebP": ".webp", "JPEG 2000": ".jp2", "AVIF": ".avif"}[fmt]
    data = cv2.imencode(ext, img)[1].tobytes()
    assert cv2.imdecode(np.frombuffer(data, np.uint8), -1) is not None
    if fmt in ("WebP", "JPEG 2000"):
        for flag in FLAGS:
            _assert_same(cv2.imdecode(np.frombuffer(data, np.uint8), flag),
                         decode_image(data, flag), fmt)
        return
    with pytest.raises(ValueError, match=fmt):
        decode_image(data)


# -- the paths: replay and the WMS client ----------------------------------

@pytest.fixture(scope="module")
def world():
    return World.make(seed=7, size_px=1024, gsd_m=1.36)


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dem", ["float32", "int16"])
def test_gis_export_dataset_loads_as_jax(world, tmp_path, dem):
    """A dataset as a GIS exports it: the map a tiled deflate GeoTIFF with
    predictor 2, the DEM a float32 or int16 GeoTIFF, frames TIFF, PGM and
    BMP: both packages' ``load_dataset`` give equal arrays, equal to the
    PNG dataset's pixels."""
    png, gis = str(tmp_path / "png"), str(tmp_path / "gis")
    write_replay_dataset(world, png, frames=3)
    write_replay_dataset(world, gis, frames=3, image_format="tiff")
    with open(os.path.join(gis, "map.png"), "rb") as f:
        assert f.read(4) == b"II*\0"
    frames = sorted(os.listdir(os.path.join(gis, "frames")))
    path = os.path.join(gis, "frames", frames[2])
    bmp = cv2.imencode(".bmp", cv2.imread(path, 0))[1].tobytes()
    with open(path, "wb") as f:  # a BMP frame
        f.write(bmp)
    if dem == "int16":
        ref = jreplay.load_dataset(gis)
        heights = (np.arange(ref["ortho"].size).reshape(ref["ortho"].shape)
                   % 3000 - 500).astype(np.int16)
        with open(os.path.join(gis, "dem.tif"), "wb") as f:
            f.write(encode_tiff(heights, 8, 2, tile=(256, 256)))
    ours, ref, base = (treplay.load_dataset(gis), jreplay.load_dataset(gis),
                       treplay.load_dataset(png))
    _equal(ours["ortho"], ref["ortho"])
    _equal(ours["dem"], ref["dem"])
    _equal(ours["ortho"], base["ortho"])
    if dem == "float32":
        _equal(ours["dem"], base["dem"])
    for a, b in zip(ours["poses"], base["poses"]):
        got = read_image(a["frame_path"], cv2.IMREAD_GRAYSCALE)
        _equal(got, cv2.imread(a["frame_path"], cv2.IMREAD_GRAYSCALE))
        _equal(got, read_image(b["frame_path"], cv2.IMREAD_GRAYSCALE))


def test_transposing_tiff_map_is_refused_as_jax(world, tmp_path):
    """``cv2.imread`` gives None for a TIFF whose orientation transposes a
    map that is not square: the JAX replay raises, and so does the
    port's."""
    root = str(tmp_path)
    write_replay_dataset(world, root, frames=1)
    ortho = cv2.imread(os.path.join(root, "map.png"), 0)[:, 8:]
    with open(os.path.join(root, "map.png"), "wb") as f:
        f.write(write_tiff(ortho, orientation=6, compression=8))
    with pytest.raises(FileNotFoundError):
        jreplay.load_dataset(root)
    with pytest.raises(ValueError, match="not an image OpenCV would read"):
        treplay.load_dataset(root)


def _replies():
    r = _rng("replies")
    grey = r.integers(0, 256, (8, 8)).astype(np.uint8)
    return {
        "geotiff": ("image/tiff", encode_tiff(grey, geo=(24, 60, 1e-3,
                                                         1e-3))),
        "tiff_rgb_lzw": ("image/tiff", write_tiff(
            r.integers(0, 256, (8, 8, 3)).astype(np.uint8), compression=5,
            predictor=2)),
        "tiff_u16": ("image/tiff", write_tiff(
            r.integers(0, 65536, (8, 8)).astype(np.uint16))),
        "tiff_float_dem": ("image/tiff", encode_tiff(
            (r.random((8, 8)) * 300).astype(np.float32), 8, 3)),
        "gif": ("image/gif", write_gif((8, 8), [gif_frame(grey)], r.integers(
            0, 256, (256, 3)))),
        "gif_transparent": ("image/gif", write_gif(
            (8, 8), [gif_frame(grey >> 4, transparent=2)],
            r.integers(0, 256, (16, 3)))),
    }


@pytest.mark.parametrize("reply", sorted(_replies()))
def test_wms_replies_equal_jax(reply):
    ctype, body = _replies()[reply]
    server = _serve(ctype, body)
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/wms"
        ours, ref = WMSClient(url), jax_wms.WMSClient(url)
        bb = (24.0, 60.0, 24.01, 60.01)
        for grey in (False, True):
            got = ours.get_map(["x"], bb, (8, 8), grayscale=grey)
            want = ref.get_map(["x"], bb, (8, 8), grayscale=grey)
            assert (got is None) == (want is None)
            if want is not None:
                _equal(got, want)
        got = request_orthoimage(ours, bb, (8, 8), ["x"], ["dem"],
                                 format_=ctype)
        want = jax_wms.request_orthoimage(ref, bb, (8, 8), ["x"], ["dem"],
                                          format_=ctype)
        for a, b in zip(got, want):
            _equal(a, b)
        if reply == "tiff_float_dem":  # cv2: None under the grey flag
            assert not got[1].any()
    finally:
        server.shutdown()
        server.server_close()


def test_stub_wms_answers_geotiff(world):
    """The stub WMS answers ``image/tiff`` with an uncompressed GeoTIFF
    of the raster it serves as PNG; both packages' clients decode it."""
    from gisnav_tpu_torch.gis.geotiff import read_geotiff
    from gisnav_tpu_torch.utils.world_wms import WorldWMS

    left, top = world.to_lonlat(100, 100)
    right, bottom = world.to_lonlat(400, 350)
    bb = (left, bottom, right, top)
    with WorldWMS(world) as wms:
        client = WMSClient(wms.url)
        got = client.get_map(["imagery"], bb, (40, 48), format_="image/tiff")
        _equal(got, world.crop(bb, 40, 48))
        want = jax_wms.WMSClient(wms.url).get_map(["imagery"], bb, (40, 48),
                                                  format_="image/tiff")
        _equal(got, want)
        assert wms.formats.get("image/tiff") == 2
        raw = client._get({"service": "WMS", "request": "GetMap",
                           "version": "1.1.1", "layers": "imagery",
                           "bbox": ",".join(map(str, bb)), "width": "48",
                           "height": "40", "format": "image/tiff",
                           "srs": "EPSG:4326"})[1]
    with tempfile.NamedTemporaryFile(suffix=".tif", delete=False) as f:
        f.write(raw)
    try:
        raster, geo = read_geotiff(f.name)
    finally:
        os.unlink(f.name)
    _equal(raster, world.crop(bb, 40, 48))
    assert abs(geo.left - left) < 1e-12 and abs(geo.top - top) < 1e-12
