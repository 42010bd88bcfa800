"""The port's image readers (``gis/png.py``, ``gis/jpeg.py``
``decode_image`` / ``read_image``) against OpenCV's (cv2 5.0 over libpng
1.6 and libjpeg-turbo 3.1), on the CPU. Tolerance: 0 levels, equal shapes
and dtypes.

- The committed fixtures (``tools/make_torch_image_fixtures.py``): their
  bytes and cv2's pixel digests under ``IMREAD_UNCHANGED`` and
  ``IMREAD_GRAYSCALE`` are those in ``digests.json`` (a drift of OpenCV or
  of a file fails here); the port decodes each to those digests, and
  ``read_image`` each file to ``cv2.imread``'s array.
- PNG of every colour type and depth (palette 1-8 bits with and without
  tRNS, grey 1-16 bits with tRNS, grey + alpha, RGB with a tRNS colour,
  RGBA), plain and Adam7, every row filter, against ``cv2.imdecode``. The
  grey flag on colour and palette images is libpng's conversion, exactly
  (with gAMA / sRGB through libpng's gamma tables; the chunk rules libpng
  applies: sRGB over gAMA, neither after PLTE or IDAT, iCCP and cICP
  ignored), at 16 bits through its 16-bit tables and the gamma shift an
  sBIT chunk sets; an ancillary chunk that fails its CRC is dropped, a
  critical one gives None as in cv2.
- eXIf orientation as cv2 applies it (grey flag only; libpng's checks: the
  first valid chunk, a TIFF header, a good CRC; before or after IDAT).
- A loopback WMS serving a progressive JPEG, CMYK and palette PNG replies:
  the port's client and ``request_orthoimage`` equal the JAX package's.
"""
import hashlib
import json
import os
import struct

import cv2
import numpy as np
import pytest

from gisnav_tpu.gis import wms as jax_wms
from gisnav_tpu_torch.gis import jpeg as tjpeg
from gisnav_tpu_torch.gis.png import decode_png, png_as_opencv
from gisnav_tpu_torch.gis.wms import WMSClient, request_orthoimage
from tests.test_torch_nodes import _serve
from tests.torch_image_writers import chunk, exif_tiff, write_png

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "torch_images")
with open(os.path.join(FIXTURES, "digests.json")) as _f:
    DIGESTS = json.load(_f)
FLAGS = {"unchanged": cv2.IMREAD_UNCHANGED,
         "grayscale": cv2.IMREAD_GRAYSCALE}
FIXTURE_LIMIT = 512 * 1024


def _digest(img):
    if img is None:
        return None
    return {"shape": list(img.shape), "dtype": str(img.dtype),
            "sha256": hashlib.sha256(
                np.ascontiguousarray(img).tobytes()).hexdigest()}


def _read(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def test_fixture_set_is_whole():
    names = sorted(os.listdir(FIXTURES))
    assert names == sorted([*DIGESTS, "digests.json"])
    total = sum(os.path.getsize(os.path.join(FIXTURES, n)) for n in names)
    assert total < FIXTURE_LIMIT, total


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixture_digests_are_cv2s(name):
    data = _read(name)
    assert hashlib.sha256(data).hexdigest() == DIGESTS[name]["file_sha256"]
    buf = np.frombuffer(data, np.uint8)
    for key, flag in FLAGS.items():
        assert _digest(cv2.imdecode(buf, flag)) == DIGESTS[name][key], key


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixture_decodes_as_cv2(name):
    data, path = _read(name), os.path.join(FIXTURES, name)
    for key, flag in FLAGS.items():
        assert _digest(tjpeg.decode_image(data, flag)) == DIGESTS[name][key]
        ref, got = cv2.imread(path, flag), tjpeg.read_image(path, flag)
        assert (got is None) == (ref is None), key
        if ref is not None:
            assert got.dtype == ref.dtype and got.shape == ref.shape
            np.testing.assert_array_equal(got, ref)


def _as_cv2(data):
    for flag in FLAGS.values():
        ref = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
        got = tjpeg.decode_image(data, flag)
        assert ref is not None
        assert got.dtype == ref.dtype, (flag, got.dtype, ref.dtype)
        assert got.shape == ref.shape, (flag, got.shape, ref.shape)
        np.testing.assert_array_equal(got, ref, err_msg=f"flag {flag}")


H, W = 29, 43
VARIANTS = ([(0, d, t) for d in (1, 2, 4, 8, 16) for t in (False, True)]
            + [(3, d, t) for d in (1, 2, 4, 8) for t in (False, True)]
            + [(c, d, t) for c in (2, 4, 6) for d in (8, 16)
               for t in (False, True)])


def _samples(ctype, depth, seed):
    rng = np.random.default_rng(seed)
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    top = (1 << depth) if ctype != 3 else min(1 << depth, 100)
    return rng.integers(0, top, (H, W, channels)).astype(
        np.uint16 if depth == 16 else np.uint8)


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("ctype,depth,trns", VARIANTS,
                         ids=lambda v: str(v))
def test_png_variants_as_cv2(ctype, depth, trns, interlace):
    s = _samples(ctype, depth, seed=ctype * 100 + depth)
    palette, t = None, None
    if ctype == 3:
        n = min(1 << depth, 100)
        palette = np.random.default_rng(depth).integers(0, 256, (n, 3))
        t = bytes(range(0, 256, 7))[:max(1, n // 2)] if trns else None
    elif trns and ctype == 0:
        t = struct.pack(">H", int(s[3, 4, 0]))
    elif trns and ctype == 2:
        t = struct.pack(">3H", *map(int, s[3, 4]))
    _as_cv2(write_png(s, depth, ctype, interlace, palette=palette, trns=t))


@pytest.mark.parametrize("size", [(1, 1), (1, 9), (9, 1), (2, 3), (5, 5),
                                  (8, 8), (17, 3)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_adam7_small_images_as_cv2(size):
    """Passes that are empty at these sizes have no rows at all."""
    rng = np.random.default_rng(size[0] * 31 + size[1])
    _as_cv2(write_png(rng.integers(0, 256, (*size, 3)).astype(np.uint8), 8,
                      2, True))
    _as_cv2(write_png(rng.integers(0, 16, size).astype(np.uint8), 4, 3,
                      True, palette=rng.integers(0, 256, (16, 3))))


def _gama(value):
    return chunk(b"gAMA", struct.pack(">I", value))


SRGB = chunk(b"sRGB", b"\0")
GAMMA_CASES = {
    "gama_45455": ([_gama(45455)], []),
    "gama_50000": ([_gama(50000)], []),
    "gama_220000": ([_gama(220000)], []),
    "gama_1": ([_gama(100000)], []),
    "gama_near_1": ([_gama(96000)], []),
    "gama_0": ([_gama(0)], []),
    "srgb": ([SRGB], []),
    "srgb_over_gama": ([_gama(50000), SRGB], []),
    "gama_over_iccp": ([chunk(b"iCCP", b"x\0\0" + b"\x78\x9c\x03\0\0\0\0\x01"),
                        _gama(50000)], []),
    "cicp_ignored": ([chunk(b"cICP", bytes([1, 13, 0, 1]))], []),
    "gama_after_idat": ([], [_gama(50000)]),
}


@pytest.mark.parametrize("kind", ["rgb", "palette", "grey"])
@pytest.mark.parametrize("case", sorted(GAMMA_CASES))
def test_png_gamma_as_cv2(case, kind):
    before, after = GAMMA_CASES[case]
    rng = np.random.default_rng(7)
    if kind == "rgb":
        data = write_png(rng.integers(0, 256, (H, W, 3)).astype(np.uint8), 8,
                         2, before=before, after=after)
    elif kind == "palette":
        data = write_png(rng.integers(0, 64, (H, W)).astype(np.uint8), 8, 3,
                         palette=rng.integers(0, 256, (64, 3)),
                         before=before, after=after)
    else:
        data = write_png(rng.integers(0, 256, (H, W)).astype(np.uint8), 8, 0,
                         before=before, after=after)
    _as_cv2(data)


def test_png_gamma_after_plte_is_out_of_place():
    """libpng drops a gAMA after PLTE: the truncating conversion stays."""
    rng = np.random.default_rng(8)
    data = write_png(rng.integers(0, 64, (H, W)).astype(np.uint8), 8, 3,
                     palette=rng.integers(0, 256, (64, 3)))
    at = data.index(b"IDAT") - 4
    _as_cv2(data[:at] + _gama(45455) + data[at:])


def test_png_16bit_colour_gamma_refused_under_grey_flag():
    """The refusal this held is lifted: a 16-bit colour PNG with a gamma
    other than 1 reads under the grey flag as cv2 reads it (libpng's 16-bit
    gamma tables); the file of the former refusal, and one at gamma 1."""
    rng = np.random.default_rng(9)
    data = write_png(rng.integers(0, 65536, (H, W, 3)).astype(np.uint16),
                     16, 2, before=[_gama(45455)])
    _as_cv2(data)
    _as_cv2(write_png(rng.integers(0, 65536, (H, W, 3)).astype(np.uint16),
                      16, 2, before=[_gama(100000)]))


def _sbit(*depths):
    return chunk(b"sBIT", bytes(depths))


# gamma and sBIT chunks of a 16-bit colour PNG: libpng's gamma_16_to_1 /
# gamma_16_from_1 (indexed by the value >> gamma_shift: 5 under OpenCV's
# strip_16, 8 for an 8-bit sBIT) and its 16-to-8 table for grey pixels
GAMMA16_CASES = {
    "gama_1_2.2": [_gama(45455)],
    "gama_1_1.8": [_gama(55556)],
    "srgb": [SRGB],
    "gama_1": [_gama(100000)],
    "gama_2.2": [_gama(220000)],
    "gama_near_1": [_gama(96000)],
    "sbit_8": [_sbit(8, 8, 8), _gama(45455)],
    "sbit_12": [_sbit(12, 12, 12), _gama(45455)],
    "sbit_mixed": [_sbit(10, 11, 9), _gama(55556)],
    "sbit_invalid": [_sbit(8, 8), _gama(45455)],
}


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("ctype", [2, 6], ids=["rgb", "rgba"])
@pytest.mark.parametrize("case", list(GAMMA16_CASES))
def test_png_16bit_colour_gamma_as_cv2(case, ctype, interlace):
    """Every value class: grey pixels (R = G = B, through the 16-to-8
    table), a ramp over the whole 16-bit range, random colour."""
    rng = np.random.default_rng(len(case) + ctype)
    px = rng.integers(0, 65536, (H, W, 4)).astype(np.uint16)
    px[::3, ::2, 1:3] = px[::3, ::2, :1]
    px[0, :, :3] = np.linspace(0, 65535, W).astype(np.uint16)[:, None]
    sbit = [c for c in GAMMA16_CASES[case] if c[4:8] == b"sBIT"]
    if sbit and ctype == 6:  # an sBIT has a depth a channel, alpha too
        body = sbit[0][8:-4]
        sbit = [_sbit(*body, 16) if len(body) == 3 else _sbit(*body)]
    chunks = sbit + [c for c in GAMMA16_CASES[case] if c[4:8] != b"sBIT"]
    _as_cv2(write_png(px[..., :3 if ctype == 2 else 4], 16, ctype,
                      interlace=interlace, before=chunks))


def _exif_chunk(body, crc_ok=True):
    c = chunk(b"eXIf", body)
    return c if crc_ok else c[:-1] + bytes([c[-1] ^ 0xFF])


EXIF_PNG = {
    "o6_before_idat": ([_exif_chunk(exif_tiff(6))], []),
    "o6_after_idat": ([], [_exif_chunk(exif_tiff(6))]),
    "o3_ii": ([_exif_chunk(exif_tiff(3, b"II"))], []),
    "o8_ii": ([_exif_chunk(exif_tiff(8, b"II"))], []),
    "exif_prefixed": ([_exif_chunk(b"Exif\0\0" + exif_tiff(6))], []),
    "first_wins": ([_exif_chunk(exif_tiff(6)), _exif_chunk(exif_tiff(3))],
                   []),
    "bad_crc_dropped": ([_exif_chunk(exif_tiff(6), crc_ok=False)], []),
    "value_cut": ([_exif_chunk(exif_tiff(6)[:-7])], []),
}


@pytest.mark.parametrize("kind", ["grey", "rgb", "palette"])
@pytest.mark.parametrize("case", sorted(EXIF_PNG))
def test_png_exif_as_cv2(case, kind):
    before, after = EXIF_PNG[case]
    rng = np.random.default_rng(10)
    if kind == "grey":
        data = write_png(rng.integers(0, 256, (H, W)).astype(np.uint8), 8, 0,
                         before=before, after=after)
    elif kind == "rgb":
        data = write_png(rng.integers(0, 256, (H, W, 3)).astype(np.uint8), 8,
                         2, before=before, after=after)
    else:
        data = write_png(rng.integers(0, 4, (H, W)).astype(np.uint8), 2, 3,
                         palette=rng.integers(0, 256, (4, 3)),
                         before=before, after=after)
    _as_cv2(data)


def _palette_edge_cases():
    rng = np.random.default_rng(12)
    idx = rng.integers(0, 16, (9, 11)).astype(np.uint8)
    pal = rng.integers(0, 256, (8, 3))
    rgb = rng.integers(0, 256, (9, 11, 3)).astype(np.uint8)
    plte = chunk(b"PLTE", pal.astype(np.uint8).tobytes())
    return {
        "index_past_palette": write_png(idx, 8, 3, palette=pal),
        "trns_longer_than_palette": write_png(idx % 8, 8, 3, palette=pal,
                                              trns=bytes(range(10))),
        "trns_empty": write_png(idx % 8, 8, 3, palette=pal, trns=b""),
        "trns_before_plte": write_png(idx % 8, 8, 3, before=[
            chunk(b"tRNS", b"\x10\x20"), plte]),
        "trns_after_idat": write_png(idx % 8, 8, 3, palette=pal, after=[
            chunk(b"tRNS", b"\x10\x20")]),
        "grey_trns_wrong_size": write_png(idx, 8, 0, trns=b"\x00"),
        "rgb_trns_wrong_size": write_png(rgb, 8, 2, trns=b"\x00\x01"),
        "rgba_with_trns": write_png(
            np.concatenate([rgb, rgb[..., :1]], axis=2), 8, 6,
            trns=b"\x00\x01\x00\x01\x00\x01"),
        "two_plte": write_png(idx % 8, 8, 3, palette=pal, before=[plte]),
    }


@pytest.mark.parametrize("case", sorted(_palette_edge_cases()))
def test_palette_and_trns_rules_as_cv2(case):
    """libpng's rules: a tRNS of the wrong size or place is ignored, an
    index past the palette reads black, a second PLTE is an error (None
    from cv2 and ``decode_image``; ``decode_png`` raises)."""
    data = _palette_edge_cases()[case]
    if case == "two_plte":
        assert cv2.imdecode(np.frombuffer(data, np.uint8), -1) is None
        assert tjpeg.decode_image(data) is None
        with pytest.raises(ValueError, match="PLTE"):
            decode_png(data)
        return
    _as_cv2(data)


def test_png_crc_rules():
    """An ancillary chunk failing its CRC is dropped as libpng drops it; a
    critical one gives None as in cv2 (``decode_png`` raises)."""
    img = np.random.default_rng(11).integers(0, 256, (H, W)).astype(np.uint8)
    bad_text = chunk(b"tEXt", b"k\0v")[:-1] + b"\0"
    _as_cv2(write_png(img, 8, 0, before=[bad_text]))
    data = bytearray(write_png(img, 8, 0))
    data[data.index(b"IDAT") + 6] ^= 0xFF
    assert cv2.imdecode(np.frombuffer(bytes(data), np.uint8), -1) is None
    assert tjpeg.decode_image(bytes(data)) is None
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(data))


def test_decode_png_gives_the_files_samples():
    """``decode_png``: file channel order, a palette through PLTE (alpha
    from tRNS), grey under 8 bits scaled as libpng expands it."""
    pal = np.array([[10, 20, 30], [200, 100, 50], [0, 0, 0], [255, 255, 9]])
    idx = np.array([[0, 1, 2, 3], [3, 2, 1, 0]], np.uint8)
    np.testing.assert_array_equal(
        decode_png(write_png(idx, 2, 3, palette=pal)), pal[idx])
    rgba = decode_png(write_png(idx, 2, 3, palette=pal, trns=b"\x00\x80"))
    np.testing.assert_array_equal(rgba[..., :3], pal[idx])
    np.testing.assert_array_equal(rgba[..., 3], [[0, 128, 255, 255],
                                                 [255, 255, 128, 0]])
    np.testing.assert_array_equal(decode_png(write_png(idx, 2, 0)), idx * 85)
    la = np.stack([idx * 9, idx], axis=2)
    np.testing.assert_array_equal(decode_png(write_png(la, 8, 4)), la)
    assert png_as_opencv(write_png(la, 8, 4), gray=False).shape == (2, 4, 4)


@pytest.fixture
def replies():
    """(content type, body) of WMS replies users meet beyond baseline JPEG
    and 8-bit grey or colour PNG."""
    return {
        "progressive": ("image/jpeg", _read("prog_bgr420_217x301.jpg")),
        "progressive_grey": ("image/jpeg", _read("prog_grey_217x301.jpg")),
        "cmyk": ("image/jpeg", _read("cmyk_444.jpg")),
        # MapServer's image/png; mode=8bit: an 8-bit palette PNG
        "palette": ("image/png; mode=8bit", _read("pillow_pal.png")),
        "palette_grey": ("image/png", _read("pal8_grey256_217x301.png")),
        "adam7": ("image/png", _read("adam7_rgb8.png")),
    }


@pytest.mark.parametrize("reply", ["progressive", "progressive_grey",
                                   "cmyk", "palette", "palette_grey",
                                   "adam7"])
def test_wms_replies_equal_jax(replies, reply):
    ctype, body = replies[reply]
    server = _serve(ctype, body)
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/wms"
        ours, ref = WMSClient(url), jax_wms.WMSClient(url)
        bb = (24.0, 60.0, 24.01, 60.01)
        for grey in (False, True):
            got = ours.get_map(["x"], bb, (8, 8), grayscale=grey)
            want = ref.get_map(["x"], bb, (8, 8), grayscale=grey)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
        got = request_orthoimage(ours, bb, (8, 8), ["x"], ["dem"])
        want = jax_wms.request_orthoimage(ref, bb, (8, 8), ["x"], ["dem"])
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    finally:
        server.shutdown()
        server.server_close()
