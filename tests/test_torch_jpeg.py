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
- A progressive file raises ``ValueError`` naming it. Truncated, cut and
  corrupt streams and garbage give what cv2 gives (None, or the image with
  grey past a damaged segment).
- Encode equals ``cv2.imencode(".jpg")`` byte for byte, grey and BGR, at
  the same qualities and sizes; the encoder's and decoder's digests that
  ``chip_smoke.py`` holds the card machine's build to are OpenCV's.
- ``decode_image`` chooses PNG or JPEG by content; the shared build helper
  survives processes building the library at once.
"""
import hashlib
import os
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


def test_progressive_raises_naming_it():
    data = _encode(_image(32, 40, 3), cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    assert cv2.imdecode(np.frombuffer(data, np.uint8),
                        cv2.IMREAD_UNCHANGED) is not None
    with pytest.raises(ValueError, match="progressive"):
        tjpeg.decode_jpeg(data)
    with pytest.raises(ValueError, match="progressive"):
        tjpeg.decode_image(data)


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
                else:  # colour PNG: cvtColor's grey, not libpng's
                    np.testing.assert_array_equal(got, cv2.cvtColor(
                        img, cv2.COLOR_BGR2GRAY) if img.ndim == 3 else img)
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
