"""The port's JPEG decoder (``native/jpeg.cpp`` through ``gis/jpeg.py`` and
``gis/imgcodecs.py``) on lossless and arithmetic-coded files, against
OpenCV's (cv2 5.0 over libjpeg-turbo 3.1), on the CPU. Tolerance: 0 levels,
equal shapes and dtypes, None where cv2 gives None.

Files come from libjpeg-turbo's own encoder and transcoder (Pillow's
bundled library, ``tests/torch_image_writers.py`` ``libjpeg_encode`` /
``libjpeg_transcode``) and, for what its lossless encoder does not write
(subsampled components, a scan per component, JFIF / Adobe markers), from
``lossless_jpeg``; each writer is held by cv2 reading its output.

- Lossless (SOF3): predictors 1-7, point transforms, restarts (whole MCU
  rows, and one that is not: None), 1, 3 and 4 components, sampling ratios
  and scan splits, precisions 2-8 (the samples as they are) and 9-16
  (None, as cv2 gives, the variant named), under ``IMREAD_UNCHANGED``, ``IMREAD_GRAYSCALE``
  and ``IMREAD_COLOR`` (the codec's BGR mode: a lossless grey or YCbCr file
  is None there, as libjpeg does no lossy colour conversion of one), and
  from a file through ``read_image`` as ``cv2.imread`` reads it.
- Arithmetic coding (SOF9, SOF10, DAC): transcodes of cv2's files at every
  sampling, sequential and progressive, with restarts and DAC
  conditioning; CMYK and YCCK; EXIF-rotated through ``decode_image`` and
  ``read_image``.
- Truncated, corrupt and garbage-tailed streams of both, and progressive
  arithmetic files cut short and closed by EOI (block smoothing), as cv2.
- A WMS reply of each through the port's client and the JAX package's.
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
from gisnav_tpu_torch.gis.imgcodecs import decode_image, read_image
from gisnav_tpu_torch.gis.wms import WMSClient
from tests.test_torch_nodes import _serve
from tests.torch_image_writers import (JCS_CMYK, JCS_RGB, exif_tiff,
                                       libjpeg_encode, libjpeg_transcode,
                                       lossless_jpeg, with_exif_app1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "torch_images")
# cv2 flag -> the codec's mode for the same pixels (EXIF not applied)
MODES = {cv2.IMREAD_UNCHANGED: tjpeg._MODE_UNCHANGED,
         cv2.IMREAD_GRAYSCALE: tjpeg._MODE_GRAY,
         cv2.IMREAD_COLOR: tjpeg._MODE_BGR}
SIZES = [(1, 1), (7, 9), (37, 53)]
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def _image(h, w, channels, seed=0, top=255):
    """Smooth structure plus noise, in 0..top."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = 0.5 + 0.25 * np.sin(x / 7.0) + 0.2 * np.cos(y / 5.0)
    img = base[..., None] + rng.normal(0, 0.1, (h, w, channels))
    img = np.clip(np.round(img * top), 0, top)
    img = img.astype(np.uint8 if top < 256 else np.uint16)
    return img[..., 0] if channels == 1 else img


def _equal_or_none(got, ref, what):
    if ref is None:
        assert got is None, (what, got.shape)
        return
    assert got is not None, what
    assert got.dtype == ref.dtype and got.shape == ref.shape, what
    np.testing.assert_array_equal(got, ref, err_msg=str(what))


def _assert_as_cv2(data, tmp_path=None):
    """The codec's pixels under each flag, ``decode_image`` (EXIF turned),
    and with ``tmp_path`` ``read_image`` of the file, against cv2."""
    buf = np.frombuffer(data, np.uint8)
    for flag, mode in MODES.items():
        _equal_or_none(tjpeg._decode(data, False, mode=mode)[0],
                       cv2.imdecode(buf, flag | cv2.IMREAD_IGNORE_ORIENTATION),
                       ("codec", flag))
    for flag in (cv2.IMREAD_UNCHANGED, cv2.IMREAD_GRAYSCALE):
        _equal_or_none(decode_image(data, flag), cv2.imdecode(buf, flag),
                       ("decode_image", flag))
    if tmp_path is not None:
        path = str(tmp_path / "f.jpg")
        with open(path, "wb") as f:
            f.write(data)
        for flag in (cv2.IMREAD_UNCHANGED, cv2.IMREAD_GRAYSCALE):
            _equal_or_none(read_image(path, flag), cv2.imread(path, flag),
                           ("read_image", flag))


def _cv2(data, flag=cv2.IMREAD_UNCHANGED):
    return cv2.imdecode(np.frombuffer(data, np.uint8), flag)


def _lossless(kind, h, w, seed=0, **kw):
    """A libjpeg-turbo lossless file: grey, RGB (kept RGB: libjpeg's
    lossless encoder does no colour conversion) or CMYK."""
    if kind == "grey":
        return libjpeg_encode(_image(h, w, 1, seed), **kw)
    space = JCS_RGB if kind == "rgb" else JCS_CMYK
    return libjpeg_encode(_image(h, w, 3 if kind == "rgb" else 4, seed),
                          in_space=space, jpeg_space=space, **kw)


# -- lossless --------------------------------------------------------------

@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("pt", [0, 3])
@pytest.mark.parametrize("psv", range(1, 8))
@pytest.mark.parametrize("kind", ["grey", "rgb", "cmyk"])
def test_lossless_predictors_as_cv2(kind, psv, pt, size):
    _assert_as_cv2(_lossless(kind, *size, seed=psv, lossless=psv, pt=pt))


@pytest.mark.parametrize("precision", range(2, 17))
def test_lossless_precisions_as_cv2(precision):
    """cv2 reads 2- to 8-bit lossless files through libjpeg's 8-bit API as
    uint8 samples as they are (0-15 at 4 bits), and none above 8 bits:
    those give None, as cv2 gives, and ``jpeg_variant`` names their
    precision."""
    img = _image(19, 23, 1, precision, top=(1 << precision) - 1)
    data = libjpeg_encode(img, lossless=6, precision=precision)
    if precision <= 8:
        np.testing.assert_array_equal(_cv2(data), img)
        _assert_as_cv2(data)
        return
    for flag, mode in MODES.items():
        assert _cv2(data, flag) is None
        assert tjpeg._decode(data, False, mode=mode)[0] is None
    assert f"{precision}-bit lossless" in tjpeg.jpeg_variant(data)


@pytest.mark.parametrize("psv", [1, 4, 7])
@pytest.mark.parametrize("rows", [1, 2, 5])
@pytest.mark.parametrize("kind", ["grey", "rgb"])
def test_lossless_restarts_as_cv2(kind, rows, psv, tmp_path):
    """A restart every ``rows`` MCU rows (the predictor restarts from
    2^(P - Pt - 1) on the row after it)."""
    data = _lossless(kind, 29, 31, seed=rows, lossless=psv, pt=1,
                     restart_rows=rows)
    assert b"\xff\xdd" in data
    _assert_as_cv2(data, tmp_path)


def test_lossless_restart_not_a_whole_row_is_none():
    """libjpeg refuses a lossless restart interval that is no multiple of
    the MCUs in a row (jddiffct.c): cv2 gives None."""
    data = bytearray(_lossless("grey", 16, 20, lossless=1, restart_rows=2))
    at = bytes(data).index(b"\xff\xdd")
    data[at + 4:at + 6] = struct.pack(">H", 30)  # 1.5 rows of 20
    for flag in MODES:
        assert _cv2(bytes(data), flag) is None
    _assert_as_cv2(bytes(data))


def _box(plane, sy, sx, h, w):
    """jdsample.c's box upsampling of a component to (h, w)."""
    return np.repeat(np.repeat(plane, sy, 0), sx, 1)[:h, :w]


# (h, v) a component, and the colour markers: Adobe transform 0 makes
# three components RGB, a JFIF APP0 YCbCr (which libjpeg will not convert
# in lossless mode: None under every flag), none CMYK for four
LOSSLESS_LAYOUTS = {
    "rgb420": ([(2, 2), (1, 1), (1, 1)], dict(adobe=0)),
    "rgb422": ([(2, 1), (1, 1), (1, 1)], dict(adobe=0)),
    "rgb440": ([(1, 2), (1, 1), (1, 1)], dict(adobe=0)),
    "rgb411": ([(4, 1), (1, 1), (1, 1)], dict(adobe=0)),
    "rgb_ids": ([(1, 1), (2, 2), (1, 1)], dict(ids=[82, 71, 66])),
    "ycbcr420": ([(2, 2), (1, 1), (1, 1)], dict(jfif=True)),
    "grey22": ([(2, 2)], {}),
    "cmyk420": ([(2, 2), (1, 1), (1, 1), (2, 2)], {}),
}


def _layout_planes(sampling, h, w, seed):
    max_h = max(s[0] for s in sampling)
    max_v = max(s[1] for s in sampling)
    rng = np.random.default_rng(seed)
    return [np.clip(_image(-(-h * sv // max_v), -(-w * sh // max_h), 1,
                           seed + i) + rng.integers(-3, 4, 1), 0,
                    255).astype(np.uint8)
            for i, (sh, sv) in enumerate(sampling)]


@pytest.mark.parametrize("scans", ["one", "each"])
@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("layout", list(LOSSLESS_LAYOUTS))
def test_lossless_layouts_as_cv2(layout, restart, scans, tmp_path):
    """Sampling ratios, one interleaved scan or a scan a component, JFIF /
    Adobe colour markers, restarts: cv2 reads each (the writer held: the
    planes box-upsampled, as they are), and the port as cv2."""
    sampling, markers = LOSSLESS_LAYOUTS[layout]
    h, w = 21, 34
    planes = _layout_planes(sampling, h, w, len(layout))
    data = lossless_jpeg(planes, sampling, size=(h, w), psv=restart + 2,
                         restart_rows=restart,
                         scans=None if scans == "one" else [
                             [i] for i in range(len(planes))], **markers)
    ref = _cv2(data)
    if layout.startswith("ycbcr"):
        assert ref is None
    elif layout.startswith("cmyk"):
        assert ref is not None and ref.shape == (h, w, 3)
    else:
        max_h = max(s[0] for s in sampling)
        max_v = max(s[1] for s in sampling)
        want = np.stack([_box(p, max_v // sv, max_h // sh, h, w)
                         for p, (sh, sv) in zip(planes, sampling)], -1)
        np.testing.assert_array_equal(
            ref, want[..., ::-1][..., :3] if want.shape[2] == 3
            else want[..., 0])
    _assert_as_cv2(data, tmp_path)


@pytest.mark.parametrize("pt", [0, 2])
@pytest.mark.parametrize("kind", ["grey", "rgb"])
def test_lossless_writers_held_by_cv2(kind, pt):
    """Both writers' lossless files decode in cv2 to their samples (shifted
    by the point transform)."""
    img = _image(23, 41, 1 if kind == "grey" else 3, pt)
    lib = _lossless(kind, 23, 41, seed=pt, lossless=5, pt=pt)
    own = lossless_jpeg([img] if kind == "grey" else [
        img[..., i] for i in range(3)], [(1, 1)] * (1 if kind == "grey"
                                                    else 3),
        psv=5, pt=pt, adobe=None if kind == "grey" else 0)
    want = (img >> pt) << pt
    if kind == "rgb":
        want = want[..., ::-1]
    np.testing.assert_array_equal(_cv2(lib), want)
    np.testing.assert_array_equal(_cv2(own), want)


# -- arithmetic coding -----------------------------------------------------

def _arith_source(kind, quality, size, seed=0):
    """cv2's Huffman file of a seeded image: grey or BGR at a sampling."""
    if kind == "grey":
        img, params = _image(*size, 1, seed), []
    else:
        img = _image(*size, 3, seed)
        params = [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[kind]]
    ok, buf = cv2.imencode(".jpg", img,
                           [cv2.IMWRITE_JPEG_QUALITY, quality, *params])
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("size", [(1, 1), (17, 33), (97, 81)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("progressive", [False, True],
                         ids=["sequential", "progressive"])
@pytest.mark.parametrize("quality", [10, 75, 95])
@pytest.mark.parametrize("kind", ["grey"] + list(SAMPLING))
def test_arithmetic_as_cv2(kind, quality, progressive, restart, size):
    src = _arith_source(kind, quality, size, seed=quality)
    data = libjpeg_transcode(src, progressive=progressive, restart=restart)
    assert data[data.index(b"\xff\xc9" if not progressive
                           else b"\xff\xca") + 1] in (0xC9, 0xCA)
    # the writer held: the same coefficients give the Huffman file's pixels
    np.testing.assert_array_equal(_cv2(data), _cv2(src))
    _assert_as_cv2(data)


# DAC conditioning (L, U, Kx) of tables 0 and 1
CONDITIONING = {"default": ((0, 1, 5), (0, 1, 5)),
                "wide_dc": ((0, 15, 1), (1, 1, 63)),
                "narrow_dc": ((3, 4, 20), (2, 7, 0)),
                "equal_lu": ((5, 5, 9), (0, 0, 30))}


@pytest.mark.parametrize("progressive", [False, True],
                         ids=["sequential", "progressive"])
@pytest.mark.parametrize("conditioning", list(CONDITIONING))
def test_arithmetic_conditioning_as_cv2(conditioning, progressive):
    src = _arith_source("420", 85, (45, 61), seed=3)
    data = libjpeg_transcode(src, progressive=progressive,
                             conditioning=CONDITIONING[conditioning])
    assert b"\xff\xcc" in data  # a DAC segment
    np.testing.assert_array_equal(_cv2(data), _cv2(src))
    _assert_as_cv2(data)


@pytest.mark.parametrize("value", [b"\x00\x12", b"\x20\x05",
                                   b"\x00\x01\x10"],
                         ids=["l_over_u", "bad_index", "odd_length"])
def test_bad_dac_as_cv2(value):
    """A DAC with L > U, a table index over 31 or an odd length: cv2 gives
    None."""
    data = libjpeg_transcode(_arith_source("grey", 75, (16, 16)))
    at = data.index(b"\xff\xda")
    dac = b"\xff\xcc" + struct.pack(">H", len(value) + 2) + value
    _assert_as_cv2(data[:at] + dac + data[at:])
    assert _cv2(data[:at] + dac + data[at:]) is None


@pytest.mark.parametrize("progressive", [False, True],
                         ids=["sequential", "progressive"])
@pytest.mark.parametrize("name", ["cmyk_444.jpg", "cmyk_420_prog.jpg",
                                  "ycck_444.jpg"])
def test_arithmetic_cmyk_as_cv2(name, progressive, tmp_path):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        src = f.read()
    data = libjpeg_transcode(src, progressive=progressive, restart=2)
    _assert_as_cv2(data, tmp_path)


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("progressive", [False, True],
                         ids=["sequential", "progressive"])
def test_arithmetic_exif_as_cv2(progressive, orientation, tmp_path):
    """EXIF orientation turns an arithmetic-coded file under the grey flag
    (the APP1 copied by the transcode, or spliced after it)."""
    src = with_exif_app1(_arith_source("420", 80, (24, 40)),
                         exif_tiff(orientation, b"II"))
    _assert_as_cv2(libjpeg_transcode(src, progressive=progressive),
                   tmp_path)
    plain = libjpeg_transcode(_arith_source("grey", 80, (24, 40)),
                              progressive=progressive)
    _assert_as_cv2(with_exif_app1(plain, exif_tiff(orientation)), tmp_path)


# -- damaged streams -------------------------------------------------------

def _damage_source(kind, rst):
    img = _image(64, 80, 1 if "grey" in kind else 3, seed=5)
    if kind.startswith("lossless"):
        return _lossless(kind.split("_")[1], 64, 80, seed=5, lossless=4,
                         restart_rows=rst)
    ok, buf = cv2.imencode(".jpg", img)
    return libjpeg_transcode(buf.tobytes(), progressive="prog" in kind,
                             restart=rst)


@pytest.mark.parametrize("rst", [0, 2])
@pytest.mark.parametrize("kind", ["arith_grey", "arith_bgr", "arith_prog",
                                  "lossless_grey", "lossless_rgb"])
def test_truncated_and_corrupt_as_cv2(kind, rst, tmp_path):
    """Cut (None from memory; libjpeg's fake EOI from a file), cut and
    closed by EOI (zero data to the end: arithmetic decoding goes on, a
    lossless file turns 128 after the damaged segment), bytes flipped (a
    bad arithmetic code stops a segment's output), garbage after EOI."""
    data = _damage_source(kind, rst)
    n = len(data)
    for cut in (2, 10, 100, 200, 300, n // 2, n - 3, n - 2, n - 1):
        _assert_as_cv2(data[:cut])
        _assert_as_cv2(data[:cut] + b"\xff\xd9")
    _assert_as_cv2(data[:n // 2], tmp_path)
    for pos in (400, 600, n // 2, n - 10):
        flipped = bytearray(data)
        flipped[pos] ^= 0x5A
        _assert_as_cv2(bytes(flipped))
    _assert_as_cv2(data + b"trailing garbage")


DAMAGE_KINDS = ["huffman", "huffman_prog_rst3", "arith", "arith_rst3",
                "arith_prog", "arith_prog_rst3", "lossless_rgb",
                "lossless_grey_rst"]


@pytest.mark.parametrize("kind", DAMAGE_KINDS)
def test_random_damage_as_cv2(kind):
    """30 seeded damages of 1-3 random bytes in the entropy data: wild
    coefficients (decoded through the IDCT's 16-bit overflow and
    saturation, as libjpeg-turbo's SIMD IDCT takes them), bad arithmetic
    codes, markers appearing mid-scan, a second SOF, a table index out of
    range in a scan that does not read that table."""
    rng = np.random.default_rng(DAMAGE_KINDS.index(kind))
    rst = 3 if "rst" in kind else 0
    if kind.startswith("lossless"):
        data = (_lossless("rgb", 48, 72, lossless=5) if "rgb" in kind else
                _lossless("grey", 48, 72, lossless=2, restart_rows=1))
    else:
        params = [cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
        if "prog" in kind:
            params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
        ok, buf = cv2.imencode(".jpg", _image(48, 72, 3, seed=11), params)
        data = buf.tobytes()
        if kind.startswith("arith"):
            data = libjpeg_transcode(data, progressive="prog" in kind,
                                     restart=rst)
    start = data.index(b"\xff\xda")
    for _ in range(30):
        damaged = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            damaged[int(rng.integers(start, len(data) - 2))] = int(
                rng.integers(0, 256))
        _assert_as_cv2(bytes(damaged))


def test_progressive_arithmetic_cut_short_as_cv2():
    """A progressive arithmetic file cut at each scan boundary and inside
    each scan, closed by EOI: libjpeg-turbo block-smooths what it lacks."""
    data = libjpeg_transcode(_arith_source("420", 90, (48, 72), seed=2),
                             progressive=True)
    scans = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    for a, b in zip(scans, scans[1:] + [len(data) - 2]):
        for cut in (a, (a + b) // 2, b):
            _assert_as_cv2(data[:cut] + b"\xff\xd9")


# -- the committed fixtures (chip_smoke.py path 18) ---------------------------

JPEGX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                     "torch_jpegx")


def _digest(img):
    if img is None:
        return None
    return {"shape": list(img.shape), "dtype": str(img.dtype),
            "sha256": hashlib.sha256(
                np.ascontiguousarray(img).tobytes()).hexdigest()}


def test_jpegx_fixtures_are_cv2s():
    """``tests/data/torch_jpegx``: each file's bytes and cv2's digests
    under both flags are ``digests.json``'s, the flight's files are cv2's
    grey digests in ``flight.json`` (a drift of OpenCV or of a file fails
    here), and the set stays under its 2.5 MiB."""
    with open(os.path.join(JPEGX, "digests.json")) as f:
        digests = json.load(f)
    for name, want in digests.items():
        with open(os.path.join(JPEGX, name), "rb") as f:
            data = f.read()
        assert hashlib.sha256(data).hexdigest() == want["file_sha256"]
        for key, flag in (("unchanged", cv2.IMREAD_UNCHANGED),
                          ("grayscale", cv2.IMREAD_GRAYSCALE)):
            assert _digest(_cv2(data, flag)) == want[key], (name, key)
    with open(os.path.join(JPEGX, "flight", "flight.json")) as f:
        flight = json.load(f)
    for name, want in flight["jpegx_cv2"].items():
        with open(os.path.join(JPEGX, "flight", name), "rb") as f:
            assert _digest(_cv2(f.read(), cv2.IMREAD_GRAYSCALE)) == want
    size = sum(os.path.getsize(os.path.join(d, n))
               for d, _, names in os.walk(JPEGX) for n in names)
    assert size <= 2560 * 1024


def test_chip_smoke_jpegx_fixtures_on_cpu():
    """Path 18 (a) as the card machine runs it: every fixture and flight
    file decoded by the port to cv2's digests, and the 1088x1920 lossless
    frame written from the first frame's pixels to the fixture tool's
    bytes and decoded to cv2's digests."""
    import chip_smoke

    out = chip_smoke.jpegx_fixtures()
    assert out["mismatches"] == 0 and out["decodes"] == 64


# -- the WMS path ----------------------------------------------------------

@pytest.fixture
def variant_replies():
    src = _arith_source("420", 90, (64, 96), seed=8)
    return {"arithmetic": libjpeg_transcode(src),
            "arithmetic_progressive": libjpeg_transcode(src, progressive=True),
            "lossless_grey": _lossless("grey", 64, 96, lossless=1),
            "lossless_rgb": _lossless("rgb", 64, 96, lossless=7, pt=1)}


@pytest.mark.parametrize("reply", ["arithmetic", "arithmetic_progressive",
                                   "lossless_grey", "lossless_rgb"])
def test_wms_variant_replies_equal_jax(variant_replies, reply):
    """An ``image/jpeg`` GetMap reply of each variant: the port's client
    gives the JAX package's (cv2's) rasters, colour and grey."""
    server = _serve("image/jpeg", variant_replies[reply])
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/wms"
        ours, ref = WMSClient(url), jax_wms.WMSClient(url)
        bb = (24.0, 60.0, 24.01, 60.01)
        for grey in (False, True):
            got = ours.get_map(["x"], bb, (96, 64), grayscale=grey)
            want = ref.get_map(["x"], bb, (96, 64), grayscale=grey)
            _equal_or_none(got, want, ("wms", grey))
    finally:
        server.shutdown()
        server.server_close()
