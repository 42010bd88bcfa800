"""The port's JPEG codec (``native/jpeg.cpp`` through ``gis/jpeg.py``)
against OpenCV's (cv2 over libjpeg-turbo), on the CPU. Tolerance: 0 levels
and equal bytes.

- Decode equals ``cv2.imdecode`` exactly, with ``IMREAD_UNCHANGED`` and
  ``IMREAD_GRAYSCALE`` (the Y plane of a colour file): grey and BGR files
  at 4:4:4, 4:2:2, 4:2:0, 4:4:0 and 4:1:1, qualities 10 to 100, odd sizes
  (1x1, 7x9, 17x33, 801x799: every edge path of the upsampling and the
  partial MCUs); restart intervals, optimised Huffman tables; streams
  edited by hand: 16-bit DQT, APPn (EXIF included) and COM segments, fill
  bytes before markers, no DHT (libjpeg-turbo's standard tables), RGB
  component ids, an Adobe marker.
- Progressive files (``IMWRITE_JPEG_PROGRESSIVE``) decode as cv2 at every
  sampling and size, with restarts; a complete one gives the baseline
  file's pixels; one cut short and closed by EOI is block-smoothed as
  libjpeg-turbo smooths it (every scan boundary and inside every scan).
  Arithmetic-coded and lossless headers decode as cv2 decodes them;
  lossless arithmetic-coded, hierarchical, 12-bit and 16-bit lossless
  headers give None, as cv2 gives (it reads none of them), and
  ``jpeg_variant`` names each. Truncated,
  cut and corrupt streams and garbage give what cv2 gives (None, or the
  image with grey past a damaged segment); read as a file they give what
  ``cv2.imread`` gives (libjpeg's fake EOI past the end).
- EXIF orientation: 1-8 (and 0, 9) in both TIFF byte orders, under both
  flags, through ``decode_image`` and ``read_image`` against
  ``cv2.imdecode`` and ``cv2.imread``, and malformed Exif bodies (cut IFDs,
  tags past the end, other APP1 segments, odd byte-order marks) as cv2
  reads them. CMYK and YCCK files (the committed fixtures, Adobe markers
  edited) as cv2.
- Encode equals ``cv2.imencode(".jpg")`` byte for byte, grey and BGR, at
  the same qualities and sizes; the encoder's and decoder's digests that
  ``chip_smoke.py`` holds the card machine's build to are OpenCV's.
- ``decode_image`` chooses PNG or JPEG by content; the shared build helper
  survives processes building the library at once.
"""
import hashlib
import os
import struct
import subprocess
import sys

import cv2
import numpy as np
import pytest

import chip_smoke
from gisnav_tpu_torch import native
from gisnav_tpu_torch.gis import jpeg as tjpeg
from gisnav_tpu_torch.gis.png import encode_png

SIZES = [(1, 1), (7, 9), (17, 33), (801, 799)]
QUALITIES = [10, 50, 75, 95, 100]
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def _image(h, w, channels, seed=0):
    """Smooth structure plus noise: coefficients in every band."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = 128 + 60 * np.sin(x / 7.0) + 50 * np.cos(y / 5.0)
    img = base[..., None] + rng.normal(0, 25, (h, w, channels))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def _assert_decodes_as_cv2(data):
    for flag, grey in ((cv2.IMREAD_UNCHANGED, False),
                       (cv2.IMREAD_GRAYSCALE, True)):
        ref = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
        got = tjpeg.decode_jpeg(data, grayscale=grey)
        if ref is None:
            assert got is None, (flag, got.shape)
            continue
        assert got is not None and got.dtype == np.uint8
        assert got.shape == ref.shape, flag
        np.testing.assert_array_equal(got, ref, err_msg=f"flag {flag}")


def _encode(img, *params):
    ok, buf = cv2.imencode(".jpg", img, list(params))
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("kind", ["grey"] + [f"bgr{s}" for s in SAMPLING])
def test_decode_equals_cv2(kind, quality, size):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if kind != "grey":
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[kind[3:]]]
    img = _image(*size, 1 if kind == "grey" else 3, seed=quality)
    _assert_decodes_as_cv2(_encode(img, *params))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("option", ["rst1", "rst3", "rst7", "optimize",
                                    "optimize_rst2"])
@pytest.mark.parametrize("kind", ["grey", "bgr420", "bgr422"])
def test_decode_restarts_and_optimised_tables(kind, option, size):
    params = []
    if "rst" in option:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, int(option[-1])]
    if "optimize" in option:
        params += [cv2.IMWRITE_JPEG_OPTIMIZE, 1]
    if kind != "grey":
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[kind[3:]]]
    img = _image(*size, 1 if kind == "grey" else 3, seed=len(option))
    _assert_decodes_as_cv2(_encode(img, *params))


def _segments(data):
    """(marker, start, end) of each segment before the entropy data."""
    out, pos = [], 2
    while True:
        marker = data[pos + 1]
        end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        out.append((marker, pos, end))
        if marker == 0xDA:
            return out
        pos = end


def _edit(data, kind):
    data = bytes(data)
    segs = _segments(data)
    if kind == "dqt16":  # each DQT rewritten with 16-bit entries
        out = data[:2]
        for marker, start, end in segs:
            body = data[start + 4:end]
            if marker == 0xDB:
                body = bytes([0x10 | body[0]]) + b"".join(
                    int(v).to_bytes(2, "big") for v in body[1:])
            out += data[start:start + 2] + (len(body) + 2).to_bytes(
                2, "big") + body
        return out + data[segs[-1][2]:]
    if kind == "app_com":  # EXIF, ICC-like APP2 and a comment after SOI
        exif = b"Exif\x00\x00MM\x00\x2a\x00\x00\x00\x08\x00\x00"
        extra = b"".join(b"\xff" + bytes([m]) + (len(p) + 2).to_bytes(
            2, "big") + p for m, p in ((0xE1, exif), (0xE2, b"ICC" * 9),
                                       (0xFE, b"a comment")))
        return data[:2] + extra + data[2:]
    if kind == "fill":  # 0xFF fill bytes before every header marker
        out = data[:2]
        for _, start, end in segs:
            out += b"\xff\xff\xff" + data[start:end]
        return out + data[segs[-1][2]:]
    if kind == "no_dht":  # Motion-JPEG style: the standard tables
        return b"".join([data[:2]] + [data[s:e] for m, s, e in segs
                                      if m != 0xC4]) + data[segs[-1][2]:]
    raise ValueError(kind)


def _with_ids(data, ids, strip_jfif=False, adobe=None):
    data = bytearray(data)
    for marker, start, _ in _segments(bytes(data)):
        if marker == 0xC0:
            for k, cid in enumerate(ids):
                data[start + 10 + 3 * k] = cid
        elif marker == 0xDA:
            for k, cid in enumerate(ids):
                data[start + 5 + 2 * k] = cid
    data = bytes(data)
    if strip_jfif:
        data = data[:2] + data[20:]
    if adobe is not None:
        data = (data[:2] + b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00"
                + bytes([adobe]) + data[2:])
    return data


@pytest.mark.parametrize("edit", ["dqt16", "app_com", "fill", "no_dht"])
@pytest.mark.parametrize("kind", ["grey", "bgr420", "bgr444"])
def test_decode_hand_edited_streams(kind, edit):
    params = ([] if kind == "grey" else
              [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[kind[3:]]])
    img = _image(37, 45, 1 if kind == "grey" else 3, seed=3)
    data = _edit(_encode(img, cv2.IMWRITE_JPEG_QUALITY, 90, *params), edit)
    ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    assert ref is not None
    _assert_decodes_as_cv2(data)


@pytest.mark.parametrize("colour", [
    dict(ids=[82, 71, 66]), dict(ids=[82, 71, 66], strip_jfif=True),
    dict(ids=[1, 2, 3], strip_jfif=True, adobe=0),
    dict(ids=[1, 2, 3], strip_jfif=True, adobe=1),
    dict(ids=[5, 6, 7], strip_jfif=True)],
    ids=["rgb_ids_jfif", "rgb_ids", "adobe0", "adobe1", "odd_ids"])
def test_decode_colour_space_as_libjpeg_guesses(colour):
    """A JFIF marker means YCbCr; else an Adobe marker's transform; else
    'R', 'G', 'B' component ids mean RGB."""
    img = _image(16, 24, 3, seed=4)
    data = _encode(img, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["444"])
    _assert_decodes_as_cv2(_with_ids(data, **colour))


def _sof_edit(data, marker, precision=8, scan=None):
    """A baseline file with its SOF0 marker (and precision) rewritten, and
    its scan's Ss, Se and Ah/Al set to ``scan``: headers of the variants
    the codec refuses."""
    data = bytearray(data)
    at = bytes(data).index(b"\xff\xc0")
    data[at + 1], data[at + 4] = marker, precision
    if scan is not None:
        sos = bytes(data).index(b"\xff\xda")
        p = sos + 5 + 2 * data[sos + 4]
        data[p:p + 3] = bytes(scan)
    return bytes(data)


# (SOF marker, precision, scan's Ss/Se/AhAl) -> (the port's name of it,
# whether cv2 reads it): libjpeg-turbo 3.1 in OpenCV 5.0 refuses lossless
# arithmetic-coded, hierarchical, 12-bit and 9- to 16-bit lossless files;
# the port gives None as cv2 does and ``jpeg_variant`` names them
REFUSED = {
    "lossless_arithmetic": ((0xCB, 8, (1, 0, 0)), "lossless arithmetic",
                            False),
    "hierarchical": ((0xC5, 8, None), "hierarchical", False),
    "hierarchical_progressive": ((0xC6, 8, None), "hierarchical", False),
    "hierarchical_arithmetic": ((0xCD, 8, None), "hierarchical", False),
    "12bit": ((0xC1, 12, None), "12-bit", False),
    "16bit_lossless": ((0xC3, 16, (1, 0, 0)), "16-bit lossless", False),
}
# headers of variants the port once refused and now reads: the baseline
# file's Huffman data read as arithmetic-coded or lossless data, as cv2
# reads it (tests/test_torch_jpeg_variants.py holds real files of each)
READ_NOW = {
    "arithmetic": (0xC9, 8, None),
    "arithmetic_progressive": (0xCA, 8, (0, 0, 0)),
    "lossless": (0xC3, 8, (1, 0, 0)),
}


def test_progressive_raises_naming_it():
    """Progressive files decode (the refusal this held until progressive
    decoding came is lifted: see ``test_progressive_decodes_as_cv2``), and
    so do arithmetic-coded and lossless headers (``READ_NOW``, lifted
    since); the variants cv2 does not read either give None, as cv2
    gives, and ``jpeg_variant`` names them."""
    data = _encode(_image(32, 40, 3), cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    _assert_decodes_as_cv2(data)
    base = _encode(_image(32, 40, 1))
    for sof, precision, scan in READ_NOW.values():
        edited = _sof_edit(base, sof, precision, scan)
        assert cv2.imdecode(np.frombuffer(edited, np.uint8),
                            cv2.IMREAD_UNCHANGED) is not None
        _assert_decodes_as_cv2(edited)
    for (sof, precision, scan), name, cv2_reads in REFUSED.values():
        edited = _sof_edit(base, sof, precision, scan)
        for flag in (cv2.IMREAD_UNCHANGED, cv2.IMREAD_GRAYSCALE):
            ref = cv2.imdecode(np.frombuffer(edited, np.uint8), flag)
            assert (ref is not None) == cv2_reads, name
            assert tjpeg.decode_image(edited, flag) is None, name
        assert name in tjpeg.jpeg_variant(edited)


@pytest.mark.parametrize("rst", [0, 2])
@pytest.mark.parametrize("kind", ["grey", "bgr420"])
def test_truncated_and_corrupt_as_cv2(kind, rst):
    img = _image(64, 80, 1 if kind == "grey" else 3, seed=5)
    data = _encode(img, cv2.IMWRITE_JPEG_RST_INTERVAL, rst)
    n = len(data)
    for cut in (2, 10, 100, 200, 300, n // 2, n - 3, n - 2, n - 1):
        _assert_decodes_as_cv2(data[:cut])  # truncated: None
        # cut short but closed by EOI: grey past the damage
        _assert_decodes_as_cv2(data[:cut] + b"\xff\xd9")
    for pos in (400, 600, n // 2, n - 10):
        flipped = bytearray(data)
        flipped[pos] ^= 0x5A
        _assert_decodes_as_cv2(bytes(flipped))
    _assert_decodes_as_cv2(data + b"trailing garbage")


def test_garbage_as_cv2():
    rng = np.random.default_rng(6)
    for data in (b"\xff", b"\xff\xd8", b"\xff\xd8garbage", b"garbage",
                 b"\xff\xd8\xff\xd9", rng.integers(0, 256, 1000).astype(
                     np.uint8).tobytes()):
        _assert_decodes_as_cv2(data)


@pytest.mark.parametrize("size", SIZES + [(16, 16), (2, 3)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("channels", [1, 3], ids=["grey", "bgr"])
def test_encode_bytes_equal_cv2(channels, quality, size):
    img = _image(*size, channels, seed=quality + 1)
    assert tjpeg.encode_jpeg(img, quality) == _encode(
        img, cv2.IMWRITE_JPEG_QUALITY, quality)
    if quality == 95:
        assert tjpeg.encode_jpeg(img) == _encode(img)


def test_digests_chip_smoke_holds():
    """The encoder's bytes and the decoder's pixels on chip_smoke.py's
    seeded image are OpenCV's, and their sha256 the digests it pins."""
    img = chip_smoke.jpeg_digest_image()
    ours, ref = tjpeg.encode_jpeg(img), _encode(img)
    assert ours == ref
    assert hashlib.sha256(ref).hexdigest() == chip_smoke.JPEG_DIGEST
    _assert_decodes_as_cv2(ref)
    buf = np.frombuffer(ref, np.uint8)
    assert hashlib.sha256(
        cv2.imdecode(buf, cv2.IMREAD_UNCHANGED).tobytes()
        + cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE).tobytes()
    ).hexdigest() == chip_smoke.JPEG_DECODE_DIGEST == (
        chip_smoke.jpeg_decode_digest(ref))


def test_encode_refusals_and_round_trip():
    for bad in (np.zeros((4, 4), np.uint16), np.zeros((4, 4, 4), np.uint8),
                np.zeros((0, 4), np.uint8)):
        with pytest.raises(ValueError):
            tjpeg.encode_jpeg(bad)
    img = _image(200, 300, 3, seed=7)
    np.testing.assert_array_equal(
        tjpeg.decode_jpeg(tjpeg.encode_jpeg(img)),
        cv2.imdecode(cv2.imencode(".jpg", img)[1], cv2.IMREAD_UNCHANGED))


def test_decode_image_chooses_by_content():
    bgr = _image(20, 30, 3, seed=8)
    grey = _image(20, 30, 1, seed=8)
    for img in (bgr, grey):
        for data in (_encode(img), encode_png(img[..., ::-1] if img.ndim == 3
                                              else img)):
            for flag in (tjpeg.IMREAD_UNCHANGED, tjpeg.IMREAD_GRAYSCALE):
                got = tjpeg.decode_image(data, flag)
                if data.startswith(tjpeg.JPEG_SOI):
                    want = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
                    np.testing.assert_array_equal(got, want)
                elif flag == tjpeg.IMREAD_UNCHANGED:
                    np.testing.assert_array_equal(got, img)
                else:  # colour PNG: libpng's grey, as cv2.imdecode gives it
                    np.testing.assert_array_equal(got, cv2.imdecode(
                        np.frombuffer(data, np.uint8), flag))
    assert tjpeg.decode_image(b"GIF89a") is None
    with pytest.raises(ValueError):
        tjpeg.decode_image(_encode(grey), 1)


_BUILD = """
import sys
from gisnav_tpu_torch import native
native.NATIVE_BUILD_DIR = sys.argv[1]
print(native.build_native_lib("jpeg"))
"""


def test_concurrent_builds_leave_one_library(tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)],
                              cwd=root, stdout=subprocess.PIPE, text=True)
             for _ in range(4)]
    paths = {p.communicate(timeout=180)[0].strip() for p in procs}
    assert [p.returncode for p in procs] == [0] * 4
    assert len(paths) == 1, paths
    path = paths.pop()
    assert os.path.dirname(path) == str(tmp_path)
    assert os.listdir(tmp_path) == [os.path.basename(path)]
    assert os.path.basename(path).startswith("libjpeg_")


# -- progressive, EXIF, CMYK (this file's second half) --------------------

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "torch_images")
PROGRESSIVE = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]


def _assert_image_as_cv2(data, path=None):
    """``decode_image`` equals ``cv2.imdecode`` under both flags; with a
    ``path`` (the same bytes on disk) ``read_image`` equals
    ``cv2.imread``."""
    for flag in (cv2.IMREAD_UNCHANGED, cv2.IMREAD_GRAYSCALE):
        pairs = [(cv2.imdecode(np.frombuffer(data, np.uint8), flag),
                  tjpeg.decode_image(data, flag))]
        if path is not None:
            with open(path, "wb") as f:
                f.write(data)
            pairs.append((cv2.imread(path, flag),
                          tjpeg.read_image(path, flag)))
        for ref, got in pairs:
            if ref is None:
                assert got is None, flag
                continue
            assert got is not None and got.dtype == ref.dtype
            assert got.shape == ref.shape, (flag, got.shape, ref.shape)
            np.testing.assert_array_equal(got, ref, err_msg=f"flag {flag}")


def _sos_offsets(data):
    return [s for m, s, _ in _all_segments(data) if m == 0xDA]


def _all_segments(data):
    """(marker, start, end) of every marker segment, scans included (the
    entropy data after an SOS is skipped to the next marker)."""
    out, pos = [], 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF or data[pos + 1] in (0, 0xFF) or (
                0xD0 <= data[pos + 1] <= 0xD7):
            pos += 1
            continue
        marker = data[pos + 1]
        if marker == 0xD9:
            break
        end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        out.append((marker, pos, end))
        pos = end
    return out


@pytest.mark.parametrize("size", [(1, 1), (7, 9), (33, 17), (217, 301)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("option", ["plain", "rst2", "q30"])
@pytest.mark.parametrize("kind", ["grey", "bgr420", "bgr444", "bgr422",
                                  "bgr440", "bgr411"])
def test_progressive_decodes_as_cv2(kind, option, size):
    params = list(PROGRESSIVE)
    if kind != "grey":
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[kind[3:]]]
    if option == "rst2":
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]
    elif option == "q30":
        params += [cv2.IMWRITE_JPEG_QUALITY, 30]
    img = _image(*size, 1 if kind == "grey" else 3, seed=11)
    data = _encode(img, *params)
    assert data[2:].find(b"\xff\xc2") >= 0
    _assert_decodes_as_cv2(data)


@pytest.mark.parametrize("kind", ["grey", "bgr420", "bgr444"])
def test_progressive_equals_baseline_pixels(kind):
    """Same image, same quality (same tables and coefficients): the
    progressive file decodes to the baseline file's pixels exactly."""
    params = ([] if kind == "grey" else
              [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[kind[3:]]])
    img = _image(121, 173, 1 if kind == "grey" else 3, seed=12)
    base = _encode(img, *params)
    prog = _encode(img, *params, *PROGRESSIVE)
    assert base != prog
    for grey in (False, True):
        np.testing.assert_array_equal(tjpeg.decode_jpeg(prog, grey),
                                      tjpeg.decode_jpeg(base, grey))


@pytest.mark.parametrize("rst", [0, 3])
@pytest.mark.parametrize("kind", ["grey", "bgr420", "bgr444"])
def test_progressive_cut_short_as_cv2(kind, rst, tmp_path):
    """Cut at every scan boundary and inside every scan: without EOI None
    (imdecode) and libjpeg's fake EOI (imread); closed with EOI, the
    coefficients still unknown block-smoothed as libjpeg-turbo smooths
    them (DC alone: the DC interpolation too)."""
    params = list(PROGRESSIVE) + [cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
    if kind != "grey":
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[kind[3:]]]
    data = _encode(_image(77, 130, 1 if kind == "grey" else 3, seed=13),
                   *params)
    sos = _sos_offsets(data) + [len(data) - 2]
    path = str(tmp_path / "cut.jpg")
    for k in range(1, len(sos)):
        for cut in (sos[k], (sos[k - 1] + sos[k]) // 2):
            _assert_image_as_cv2(data[:cut], path)
            _assert_image_as_cv2(data[:cut] + b"\xff\xd9")


@pytest.mark.parametrize("kind", ["grey", "bgr420"])
def test_truncated_file_reads_as_imread(kind, tmp_path):
    """A baseline file cut short: None from ``decode_image`` (imdecode),
    grey past the cut from ``read_image`` (imread's fake EOI)."""
    data = _encode(_image(64, 80, 1 if kind == "grey" else 3, seed=14))
    path = str(tmp_path / "cut.jpg")
    for cut in (150, 300, len(data) // 2, len(data) - 2):
        _assert_image_as_cv2(data[:cut], path)
    _assert_image_as_cv2(data[:len(data) // 2] + b"\xff", path)


def _tiff(entries, order=b"MM", ifd=8, count=None, tail=b"\0\0\0\0",
          header=None):
    e = "<" if order == b"II" else ">"
    body = struct.pack(e + "H", len(entries) if count is None else count)
    for tag, typ, n, value in entries:
        body += struct.pack(e + "HHI", tag, typ, n) + value
    return ((header or order + struct.pack(e + "H", 42))
            + struct.pack(e + "I", ifd) + body + tail)


def _short(v, e=">"):
    return struct.pack(e + "H", v) + b"\0\0"


def _app1(body):
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def _after_app0(jpeg, *segments):
    at = 4 + int.from_bytes(jpeg[4:6], "big")
    return jpeg[:at] + b"".join(segments) + jpeg[at:]


@pytest.mark.parametrize("orient", range(10))
@pytest.mark.parametrize("order", [b"MM", b"II"], ids=["MM", "II"])
@pytest.mark.parametrize("kind", ["grey", "bgr420", "progressive"])
def test_exif_orientation_as_cv2(kind, order, orient, tmp_path):
    img = _image(24, 40, 1 if kind == "grey" else 3, seed=15)
    jpeg = _encode(img, *(PROGRESSIVE if kind == "progressive" else []))
    e = "<" if order == b"II" else ">"
    tagged = _after_app0(jpeg, _app1(b"Exif\0\0" + _tiff(
        [(0x0112, 3, 1, _short(orient, e))], order)))
    _assert_image_as_cv2(tagged, str(tmp_path / "tagged.jpg"))
    got = tjpeg.decode_image(tagged, tjpeg.IMREAD_GRAYSCALE)
    assert got.shape == ((40, 24) if orient in (5, 6, 7, 8) else (24, 40))


_O6 = [(0x0112, 3, 1, _short(6))]
_FAR = struct.pack(">I", 5000)
EXIF_CASES = {
    "xmp_first": [_app1(b"http://ns.adobe.com/xap/1.0/\0<x/>"),
                  _app1(b"Exif\0\0" + _tiff(_O6))],
    "two_exif_6_then_3": [_app1(b"Exif\0\0" + _tiff(_O6)),
                          _app1(b"Exif\0\0" + _tiff(
                              [(0x0112, 3, 1, _short(3))]))],
    "no_exif_id": [_app1(b"Abcd\0\0" + _tiff(_O6))],
    "exif_id_0_1": [_app1(b"Exif\0\1" + _tiff(_O6))],
    "exif_in_app2": [b"\xff\xe2" + struct.pack(">H", 34) + b"Exif\0\0"
                     + _tiff(_O6)],
    "long_mm": [_app1(b"Exif\0\0" + _tiff(
        [(0x0112, 4, 1, struct.pack(">I", 6))]))],
    "long_ii": [_app1(b"Exif\0\0" + _tiff(
        [(0x0112, 4, 1, struct.pack("<I", 6))], b"II"))],
    "count_3_ends_after_o": [_app1(b"Exif\0\0" + _tiff(_O6, count=3,
                                                        tail=b""))],
    "value_cut": [_app1(b"Exif\0\0" + _tiff(_O6, tail=b"")[:-3])],
    "make_past_end_then_o": [_app1(b"Exif\0\0" + _tiff(
        [(0x010F, 2, 100, _FAR)] + _O6))],
    "o_then_make_past_end": [_app1(b"Exif\0\0" + _tiff(
        _O6 + [(0x010F, 2, 100, _FAR)]))],
    "xres_past_end_then_o": [_app1(b"Exif\0\0" + _tiff(
        [(0x011A, 5, 1, _FAR)] + _O6))],
    "whitepoint_past_end_then_o": [_app1(b"Exif\0\0" + _tiff(
        [(0x013E, 5, 2, _FAR)] + _O6))],
    "resunit_then_o": [_app1(b"Exif\0\0" + _tiff(
        [(0x0128, 3, 1, _FAR)] + _O6))],
    "exif_ifd_pointer_then_o": [_app1(b"Exif\0\0" + _tiff(
        [(0x8769, 4, 1, _FAR)] + _O6))],
    "short_make_in_place_then_o": [_app1(b"Exif\0\0" + _tiff(
        [(0x010F, 2, 4, b"abc\0")] + _O6))],
    "huge_make_then_o": [_app1(b"Exif\0\0" + _tiff(
        [(0x010F, 2, 0xFFFFFFF0, struct.pack(">I", 20))] + _O6))],
    "ifd_past_end": [_app1(b"Exif\0\0" + _tiff(_O6, ifd=4000))],
    "xx_header": [_app1(b"Exif\0\0" + _tiff(_O6, header=b"XX\0\x2a"))],
    "not_42": [_app1(b"Exif\0\0" + _tiff(_O6, header=b"MM\0\x2b"))],
    "empty_app1": [_app1(b"")],
    "exif_id_only": [_app1(b"Exif\0\0")],
    "one_byte_tiff": [_app1(b"Exif\0\0M")],
    "o_in_ifd1_only": [_app1(b"Exif\0\0" + _tiff(
        [(0x0100, 3, 1, _short(6))], tail=struct.pack(">I", 26)
        + struct.pack(">H", 1) + struct.pack(">HHI", 0x0112, 3, 1)
        + _short(6) + b"\0\0\0\0"))],
}


@pytest.mark.parametrize("case", sorted(EXIF_CASES))
def test_exif_malformed_as_cv2(case, tmp_path):
    jpeg = _encode(_image(24, 40, 1, seed=16))
    _assert_image_as_cv2(_after_app0(jpeg, *EXIF_CASES[case]),
                         str(tmp_path / "exif.jpg"))


def test_exif_between_scans_is_not_read():
    """OpenCV reads the Exif APP1s before the first scan only."""
    data = _encode(_image(24, 40, 1, seed=17), *PROGRESSIVE)
    sos = _sos_offsets(data)
    app1 = _app1(b"Exif\0\0" + _tiff(_O6))
    for at in (sos[0], sos[1]):
        _assert_image_as_cv2(data[:at] + app1 + data[at:])


def _adobe(data, transform=None):
    """The Adobe APP14 transform set, or the segment removed (None)."""
    at = data.index(b"Adobe") - 4
    end = at + 2 + int.from_bytes(data[at + 2:at + 4], "big")
    if transform is None:
        return data[:at] + data[end:]
    return data[:at + 15] + bytes([transform]) + data[at + 16:]


@pytest.mark.parametrize("edit", ["cmyk", "ycck", "transform1", "no_adobe",
                                  "progressive"])
def test_cmyk_as_cv2(edit):
    """Four-component files: CMYK (Adobe transform 0 or no marker), YCCK
    (transform 2, or another value libjpeg assumes to be YCCK), through
    OpenCV's own CMYK conversions."""
    name = "cmyk_420_prog.jpg" if edit == "progressive" else "cmyk_444.jpg"
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    data = {"cmyk": data, "progressive": data, "ycck": _adobe(data, 2),
            "transform1": _adobe(data, 1), "no_adobe": _adobe(data)}[edit]
    _assert_image_as_cv2(data)
    assert tjpeg.decode_image(data).shape[2] == 3
