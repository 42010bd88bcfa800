"""The port's WebP decoder (``gis/webp.py`` over ``native/webp.cpp``)
against OpenCV's (libwebp), on the CPU.

- ``decode_image`` and ``read_image`` equal ``cv2.imdecode`` and
  ``cv2.imread`` exactly under ``IMREAD_UNCHANGED`` and
  ``IMREAD_GRAYSCALE`` (None where cv2 gives None) on a seeded corpus:
  cv2's files (VP8L; VP8 at qualities 1, 50, 90 and 100; grey, BGR and
  BGRA; 1x1, thin and odd sizes that are no multiple of 16, one 1088x1920
  frame); Pillow's (``method`` 0-6 lossy and lossless, ``exact``,
  ``alpha_quality``, lossless images of 2, 4, 16 and 256 colours, and
  animations); VP8X files assembled around their bitstreams (EXIF
  orientations 1-8 in both byte orders with the EXIF flag set or not, ALPH
  raw with each filter, a short or malformed ALPH, two ALPH chunks, the
  alpha flag without ALPH, unknown chunks, a canvas of another size);
  animations with a first frame at an offset, with each blend and dispose
  bit, with alpha, lossy with ALPH, and malformed ones; raw VP8L
  bitstreams; and files cut short, with a RIFF size that disagrees, with
  trailing bytes, or with a seeded byte changed.
- The committed WebP fixtures (``tests/data/torch_webp``, written by
  ``tools/make_torch_image_fixtures.py``) have cv2's digests, and the port
  decodes them to those digests; the set stays under 1 MiB. Its flight
  (``flight/``, ``chip_smoke.py``'s path 16) holds the PNG dataset's
  arrays by sha256 and cv2's grey digest of each WebP file.
- Both routes through both packages on the same bytes: ``load_dataset``
  and the ``harris_lg5`` replay on a WebP dataset (the replay tests'
  gates), and ``request_orthoimage`` over a stub WMS that answers WebP.
"""
import hashlib
import io
import json
import os
import shutil

import cv2
import numpy as np
import pytest
from PIL import Image

from gisnav_tpu.gis import wms as jax_wms
from gisnav_tpu import replay as jreplay
from gisnav_tpu_torch import replay as treplay
from gisnav_tpu_torch.gis.imgcodecs import (decode_image, image_format,
                                            read_image)
from gisnav_tpu_torch.gis.webp import is_webp, webp_features
from gisnav_tpu_torch.gis.wms import WMSClient, request_orthoimage
from gisnav_tpu_torch.utils.world_wms import World, write_replay_dataset
from tests.test_torch_nodes import _serve
from tests.torch_image_writers import (exif_tiff, libwebp_encode,
                                       webp_anim, webp_anmf, webp_chunk,
                                       webp_chunks, webp_riff, webp_vp8x)

cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_SILENT)
FLAGS = (cv2.IMREAD_UNCHANGED, cv2.IMREAD_GRAYSCALE)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "torch_webp")
FIXTURE_LIMIT = 1024 * 1024  # the set with its flight


def _rng(name: str) -> np.random.Generator:
    return np.random.default_rng(sum(map(ord, name)))


def _scene(name: str, h: int, w: int, c: int = 3) -> np.ndarray:
    """Smooth seeded content with some grain (what a map or frame holds)."""
    rng = _rng(name)
    base = cv2.resize(rng.integers(0, 256, (max(h // 8, 2), max(w // 8, 2),
                                            c)).astype(np.uint8), (w, h),
                      interpolation=cv2.INTER_CUBIC).reshape(h, w, c)
    img = np.clip(base.astype(int) + rng.integers(-12, 13, (h, w, c)), 0,
                  255).astype(np.uint8)
    return img[..., 0] if c == 1 else img


def _cv2(img, *params) -> bytes:
    ok, buf = cv2.imencode(".webp", img, list(params))
    assert ok
    return buf.tobytes()


def _pil(img, **kw) -> bytes:
    f = io.BytesIO()
    Image.fromarray(img).save(f, "WEBP", **kw)
    return f.getvalue()


def _pil_anim(frames, **kw) -> bytes:
    f = io.BytesIO()
    ims = [Image.fromarray(x) for x in frames]
    ims[0].save(f, "WEBP", save_all=True, append_images=ims[1:], **kw)
    return f.getvalue()


def _assert_same(ref, got, what):
    assert (ref is None) == (got is None), what
    if ref is not None:
        assert got.dtype == ref.dtype and got.shape == ref.shape, (
            what, got.shape, ref.shape)
        assert np.array_equal(got, ref), (
            what, np.argwhere(got != ref)[:4].tolist())


def _check(data: bytes, path=None):
    """decode_image == cv2.imdecode and, with ``path``, read_image ==
    cv2.imread, under both flags."""
    buf = np.frombuffer(data, np.uint8)
    for flag in FLAGS:
        _assert_same(cv2.imdecode(buf, flag), decode_image(data, flag),
                     f"imdecode flag {flag}")
    if path is not None:
        with open(path, "wb") as f:
            f.write(data)
        for flag in FLAGS:
            _assert_same(cv2.imread(path, flag), read_image(path, flag),
                         f"imread flag {flag}")


# -- cv2's and Pillow's files ----------------------------------------------

SIZES = [(1, 1), (1, 7), (5, 1), (17, 33), (31, 15), (100, 129)]
KINDS = ["bgr", "grey", "bgra"]
QUALITIES = [None, 1, 50, 90, 100]  # None: cv2's default, lossless VP8L


@pytest.mark.parametrize("quality", QUALITIES, ids=str)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("size", SIZES, ids=str)
def test_cv2_files(size, kind, quality, tmp_path):
    img = _scene(f"{size}{kind}", *size, {"bgr": 3, "grey": 1,
                                          "bgra": 4}[kind])
    params = () if quality is None else (cv2.IMWRITE_WEBP_QUALITY, quality)
    data = _cv2(img, *params)
    assert image_format(data) == "WebP"
    _check(data, str(tmp_path / "f.webp"))


def test_cv2_full_width_frame(tmp_path):
    """One 1088x1920 frame at quality 90 (the replay path's frames)."""
    _check(_cv2(_scene("frame", 1088, 1920), cv2.IMWRITE_WEBP_QUALITY, 90),
           str(tmp_path / "frame.webp"))


@pytest.mark.parametrize("method", range(7))
@pytest.mark.parametrize("kind", ["lossy", "lossless", "lossy_rgba",
                                  "lossless_rgba"])
def test_pillow_methods(method, kind):
    img = _scene(f"pil{method}{kind}", 60, 77, 4 if "rgba" in kind else 3)
    _check(_pil(img, method=method, **({"lossless": True}
                                       if kind.startswith("lossless")
                                       else {"quality": 70})))


@pytest.mark.parametrize("options", [
    {"lossless": True, "exact": True}, {"quality": 60, "alpha_quality": 0},
    {"quality": 60, "alpha_quality": 10}, {"quality": 60,
                                           "alpha_quality": 50},
    {"quality": 60, "alpha_quality": 100}], ids=str)
def test_pillow_alpha_options(options):
    img = _scene("alpha" + str(options), 48, 70, 4)
    img[..., 3][img[..., 3] < 60] = 0  # transparent pixels keep no colour
    _check(_pil(img, **options))


@pytest.mark.parametrize("colours", [2, 3, 4, 5, 16, 17, 256])
@pytest.mark.parametrize("writer", ["pil", "cv2"])
def test_colour_indexed(colours, writer):
    """Lossless images of few colours: colour indexing with 8, 4, 2 and 1
    pixels a byte."""
    rng = _rng(f"palette{colours}")
    palette = rng.integers(0, 256, (colours, 3)).astype(np.uint8)
    img = palette[rng.integers(0, colours, (57, 83))]
    _check(_pil(img, lossless=True) if writer == "pil"
           else _cv2(np.ascontiguousarray(img[..., ::-1])))


@pytest.mark.parametrize("kind", ["lossless", "lossy", "lossy_rgba",
                                  "lossless_rgba"])
def test_pillow_animations(kind, tmp_path):
    """An animation decodes to its first frame."""
    c = 4 if "rgba" in kind else 3
    frames = [_scene(f"anim{kind}{i}", 40, 50, c) for i in range(3)]
    _check(_pil_anim(frames, duration=50, **(
        {"lossless": True} if kind.startswith("lossless")
        else {"quality": 60})), str(tmp_path / "a.webp"))


@pytest.mark.parametrize("config", [
    {"filter_type": 0, "filter_strength": 60},  # the simple loop filter
    {"filter_type": 0, "filter_strength": 100, "filter_sharpness": 3},
    {"filter_type": 0, "filter_strength": 30, "filter_sharpness": 7},
    {"filter_type": 1, "filter_strength": 80, "filter_sharpness": 1},
    {"filter_type": 1, "filter_strength": 100, "filter_sharpness": 5},
    {"filter_strength": 0, "autofilter": 0},  # no loop filter
    {"autofilter": 1},
    {"partitions": 1}, {"partitions": 2}, {"partitions": 3},
    {"segments": 1}, {"segments": 2, "sns_strength": 100},
    {"segments": 4, "sns_strength": 0, "preprocessing": 1},
    {"method": 0, "pass": 10}], ids=str)
@pytest.mark.parametrize("quality", [5, 60, 97])
def test_libwebp_encoder_settings(config, quality):
    """libwebp's encoder settings cv2 and Pillow do not expose: the simple
    loop filter, sharpness, 2, 4 and 8 token partitions, segment counts."""
    img = _scene(f"libwebp{sorted(config.items())}{quality}", 70, 93)
    _check(libwebp_encode(img, quality, **config))


@pytest.mark.parametrize("config", [
    {"alpha_compression": 0, "alpha_filtering": 0},
    {"alpha_compression": 0, "alpha_filtering": 1},
    {"alpha_compression": 0, "alpha_filtering": 2},
    {"alpha_compression": 1, "alpha_filtering": 2, "alpha_quality": 100},
    {"alpha_compression": 1, "alpha_filtering": 1, "alpha_quality": 30}],
    ids=str)
def test_libwebp_alpha_settings(config):
    """ALPH raw (the encoder's chosen filter) and compressed."""
    img = _scene(f"libwebp_alpha{sorted(config.items())}", 45, 66, 4)
    _check(libwebp_encode(img, 70, **config))


# -- VP8X files assembled around cv2's bitstreams ---------------------------

def _bitstreams():
    img, rgba = _scene("bits", 33, 47), _scene("bits_a", 33, 47, 4)
    lossy_a = _pil(rgba[..., [2, 1, 0, 3]], quality=70)
    chunks = dict(webp_chunks(lossy_a))
    return {"vp8l": webp_chunks(_cv2(img))[0][1],
            "vp8": webp_chunks(_cv2(img, cv2.IMWRITE_WEBP_QUALITY, 80))[0][1],
            "alph": chunks[b"ALPH"], "vp8_a": chunks[b"VP8 "],
            "alpha_plane": rgba[..., 3]}


@pytest.mark.parametrize("order", [b"II", b"MM"], ids=["II", "MM"])
@pytest.mark.parametrize("flag", [0x08, 0], ids=["exif_flag", "no_flag"])
@pytest.mark.parametrize("orient", range(0, 10))
def test_exif_orientation(orient, flag, order, tmp_path):
    """OpenCV's demuxer keeps an EXIF chunk only under the VP8X EXIF flag;
    its orientation turns the grey read (a (33, 47) image becomes (47, 33)
    at 5-8), not the unchanged one."""
    b = _bitstreams()
    data = webp_riff([webp_vp8x(flag, 47, 33), webp_chunk(b"VP8L", b["vp8l"]),
                      webp_chunk(b"EXIF", exif_tiff(orient, order))])
    _check(data, str(tmp_path / "e.webp"))


def _extended():
    b = _bitstreams()
    plane = b["alpha_plane"].tobytes()
    cases = {
        "exif_first_of_two": [webp_vp8x(0x08, 47, 33),
                              webp_chunk(b"EXIF", exif_tiff(6, b"II")),
                              webp_chunk(b"VP8 ", b["vp8"]),
                              webp_chunk(b"EXIF", exif_tiff(3, b"II"))],
        "exif_prefixed": [webp_vp8x(0x08, 47, 33),
                          webp_chunk(b"VP8L", b["vp8l"]),
                          webp_chunk(b"EXIF", b"Exif\0\0"
                                     + exif_tiff(6, b"II"))],
        "exif_reserved_flag": [webp_vp8x(0x09, 47, 33),
                               webp_chunk(b"VP8L", b["vp8l"]),
                               webp_chunk(b"EXIF", exif_tiff(6, b"II"))],
        "alph_lossy": [webp_vp8x(0x10, 47, 33), webp_chunk(b"ALPH", b["alph"]),
                       webp_chunk(b"VP8 ", b["vp8_a"])],
        "alph_without_flag": [webp_vp8x(0, 47, 33),
                              webp_chunk(b"ALPH", b["alph"]),
                              webp_chunk(b"VP8 ", b["vp8_a"])],
        "flag_without_alph": [webp_vp8x(0x10, 47, 33),
                              webp_chunk(b"VP8 ", b["vp8"])],
        "flag_on_vp8l": [webp_vp8x(0x10, 47, 33),
                         webp_chunk(b"VP8L", b["vp8l"])],
        "two_alph": [webp_vp8x(0x10, 47, 33),
                     webp_chunk(b"ALPH", b"\0" + bytes(33 * 47)),
                     webp_chunk(b"ALPH", b["alph"]),
                     webp_chunk(b"VP8 ", b["vp8_a"])],
        "alph_short": [webp_vp8x(0x10, 47, 33),
                       webp_chunk(b"ALPH", b"\0" + bytes(100)),
                       webp_chunk(b"VP8 ", b["vp8"])],
        "alph_one_byte": [webp_vp8x(0x10, 47, 33),
                          webp_chunk(b"ALPH", b"\0"),
                          webp_chunk(b"VP8 ", b["vp8"])],
        "alph_preprocessed": [webp_vp8x(0x10, 47, 33),
                              webp_chunk(b"ALPH", b"\x10" + plane),
                              webp_chunk(b"VP8 ", b["vp8"])],
        "alph_bad_preprocessing": [webp_vp8x(0x10, 47, 33),
                                   webp_chunk(b"ALPH", b"\x20" + plane),
                                   webp_chunk(b"VP8 ", b["vp8"])],
        "alph_bad_method": [webp_vp8x(0x10, 47, 33),
                            webp_chunk(b"ALPH", b"\x02" + plane),
                            webp_chunk(b"VP8 ", b["vp8"])],
        "unknown_chunks": [webp_vp8x(0x24, 47, 33),
                           webp_chunk(b"ICCP", b"abc"),
                           webp_chunk(b"ABCD", b"xyz12"),
                           webp_chunk(b"VP8L", b["vp8l"]),
                           webp_chunk(b"XMP ", b"<x/>")],
        "wrong_canvas": [webp_vp8x(0, 48, 33), webp_chunk(b"VP8L", b["vp8l"])],
    }
    for filt in range(4):
        cases[f"alph_raw_filter{filt}"] = [
            webp_vp8x(0x10, 47, 33),
            webp_chunk(b"ALPH", bytes([filt << 2]) + plane),
            webp_chunk(b"VP8 ", b["vp8"])]
    return {k: webp_riff(v) for k, v in cases.items()}


@pytest.mark.parametrize("case", sorted(_extended()))
def test_extended_files(case, tmp_path):
    _check(_extended()[case], str(tmp_path / "x.webp"))


def _animations():
    frame = _scene("frame1", 10, 12)
    frame_a = _scene("frame1a", 10, 12, 4)
    vp8l = webp_chunks(_cv2(frame))[0][1]
    vp8l_a = webp_chunks(_cv2(frame_a))[0][1]
    vp8 = webp_chunks(_cv2(frame, cv2.IMWRITE_WEBP_QUALITY, 70))[0][1]
    lossy = dict(webp_chunks(_pil(frame_a[..., [2, 1, 0, 3]], quality=70)))
    lossy_a = webp_chunk(b"ALPH", lossy[b"ALPH"]) + webp_chunk(
        b"VP8 ", lossy[b"VP8 "])
    cases = {}
    for flags in (0x02, 0x12):
        for x, y in ((0, 0), (4, 6), (18, 10), (20, 10)):
            at = f"{flags:02x}_{x}_{y}"
            for bits in range(4):
                cases[f"vp8l_{at}_bits{bits}"] = [
                    webp_vp8x(flags, 30, 20), webp_anim(),
                    webp_anmf(x, y, 12, 10, webp_chunk(b"VP8L", vp8l),
                              bits=bits)]
            cases[f"vp8l_alpha_{at}"] = [
                webp_vp8x(flags, 30, 20), webp_anim(),
                webp_anmf(x, y, 12, 10, webp_chunk(b"VP8L", vp8l_a))]
            cases[f"vp8_alph_{at}"] = [webp_vp8x(flags, 30, 20), webp_anim(),
                                       webp_anmf(x, y, 12, 10, lossy_a)]
            cases[f"vp8_{at}"] = [webp_vp8x(flags, 30, 20), webp_anim(),
                                  webp_anmf(x, y, 12, 10,
                                            webp_chunk(b"VP8 ", vp8))]
    one = webp_anmf(2, 2, 12, 10, webp_chunk(b"VP8L", vp8l))
    cases.update({
        "frame_size_not_the_bitstreams": [
            webp_vp8x(0x12, 30, 20), webp_anim(),
            webp_anmf(2, 2, 14, 12, webp_chunk(b"VP8L", vp8l))],
        "two_frames": [webp_vp8x(0x12, 30, 20), webp_anim(), one,
                       webp_anmf(0, 0, 12, 10, webp_chunk(b"VP8L", vp8l_a))],
        "no_frames": [webp_vp8x(0x12, 30, 20), webp_anim()],
        "no_anim_chunk": [webp_vp8x(0x12, 30, 20), one],
        "frames_without_the_flag": [webp_vp8x(0x10, 30, 20), webp_anim(),
                                    one],
        "unknown_chunk_in_frame": [
            webp_vp8x(0x12, 30, 20), webp_anim(),
            webp_anmf(2, 2, 12, 10, webp_chunk(b"VP8L", vp8l)
                      + webp_chunk(b"UNKN", b"ab"))],
        "exif": [webp_vp8x(0x1a, 30, 20), webp_anim(), one,
                 webp_chunk(b"EXIF", exif_tiff(6, b"II"))],
    })
    return {k: webp_riff(v) for k, v in cases.items()}


@pytest.mark.parametrize("case", sorted(_animations()))
def test_animations(case, tmp_path):
    """cv2 5.0 reads an animation's first frame on a transparent black
    canvas of the VP8X size (no blending for a first frame; the alpha flag
    decides 3 or 4 channels)."""
    _check(_animations()[case], str(tmp_path / "a.webp"))


# -- cut, corrupt and raw --------------------------------------------------

def _damaged():
    b = _bitstreams()
    files = {"vp8l": _cv2(_scene("dmg", 33, 47)),
             "vp8": _cv2(_scene("dmg", 33, 47), cv2.IMWRITE_WEBP_QUALITY, 80),
             "vp8x_alph": webp_riff([webp_vp8x(0x10, 47, 33),
                                     webp_chunk(b"ALPH", b["alph"]),
                                     webp_chunk(b"VP8 ", b["vp8_a"])]),
             "anim": webp_riff([webp_vp8x(0x12, 47, 33), webp_anim(),
                                webp_anmf(0, 0, 47, 33, webp_chunk(
                                    b"VP8 ", b["vp8"]))])}
    out = {}
    for name, data in files.items():
        n = len(data)
        for cut in (31, 32, 40, n // 2, n - 9, n - 2, n - 1):
            out[f"{name}_cut{cut}"] = data[:cut]
            fixed = bytearray(data[:cut])
            if cut >= 8:
                fixed[4:8] = (cut - 8).to_bytes(4, "little")
                out[f"{name}_cut{cut}_riff_fixed"] = bytes(fixed)
        out[f"{name}_trailing"] = data + b"garbage!"
        for delta in (100, -20):
            bad = bytearray(data)
            bad[4:8] = (n + delta).to_bytes(4, "little")
            out[f"{name}_riff_size{delta:+d}"] = bytes(bad)
        rng = _rng("damage" + name)
        for i in range(12):
            bad = bytearray(data)
            at = int(rng.integers(12, n))
            bad[at] ^= int(rng.integers(1, 256))
            out[f"{name}_byte{i}"] = bytes(bad)
        out[f"{name}_raw"] = data[20:]
    return out


@pytest.mark.parametrize("case", sorted(_damaged()))
def test_damaged_files(case, tmp_path):
    _check(_damaged()[case], str(tmp_path / "d.webp"))


def test_signature_is_webp_get_features():
    """OpenCV's test: libwebp accepts the first 32 bytes (RIFF, or a raw
    VP8L bitstream); 31 bytes are no WebP."""
    data = _cv2(_scene("sig", 20, 20))
    assert is_webp(data[:32]) and not is_webp(data[:31])
    assert is_webp(data[20:52])  # a raw VP8L bitstream
    assert not is_webp(b"RIFF" + bytes(4) + b"WEBP" + bytes(20))
    assert webp_features(data[:32]) == {"width": 20, "height": 20,
                                        "has_alpha": 0, "has_animation": 0}


def _heads():
    """32-byte heads: every other committed image fixture's, and ones that
    start as libwebp's parse would read further (chunks without RIFF, raw
    bitstreams, RIFF of other forms)."""
    root = os.path.join(ROOT, "tests", "data", "torch_images")
    heads = {}
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name), "rb") as f:
            heads[name] = f.read(32)
    data = _cv2(_scene("heads", 20, 20))
    lossy = _cv2(_scene("heads", 20, 20), cv2.IMWRITE_WEBP_QUALITY, 80)
    chunks = dict(webp_chunks(_pil(_scene("heads", 20, 20, 4), quality=70)))
    heads.update({
        "riff": data[:32], "vp8l_chunk": data[12:44],
        "vp8_chunk": lossy[12:44], "raw_vp8l": data[20:52],
        "raw_vp8": lossy[20:52], "alph_then_vp8": (
            webp_chunk(b"ALPH", chunks[b"ALPH"][:4]) + webp_chunk(
                b"VP8 ", chunks[b"VP8 "]))[:32],
        "vp8x_without_riff": webp_vp8x(0, 20, 20) + bytes(14),
        "riff_wave": b"RIFF" + bytes(4) + b"WAVE" + bytes(20),
        "slash": b"/" + bytes(31), "start_code": b"abc\x9d\x01\x2a" + bytes(26),
    })
    rng = _rng("heads")
    for i in range(20):
        heads[f"random{i}"] = rng.integers(0, 256, 32).astype(
            np.uint8).tobytes()
    return heads


@pytest.mark.parametrize("name", sorted(_heads()))
def test_signature_prefilter_is_libwebps(name):
    """``is_webp``'s byte test before the library: the same verdict as
    ``WebPGetFeatures`` on the 32 bytes."""
    head = _heads()[name]
    assert is_webp(head) == (webp_features(head) is not None)


# -- the committed fixtures and the flight ---------------------------------

def _digest(img):
    if img is None:
        return None
    return {"shape": list(img.shape), "dtype": str(img.dtype),
            "sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes())
            .hexdigest()}


with open(os.path.join(FIXTURES, "digests.json")) as _f:
    DIGESTS = json.load(_f)
with open(os.path.join(FIXTURES, "flight", "flight.json")) as _f:
    FLIGHT = json.load(_f)
KEYS = {"unchanged": cv2.IMREAD_UNCHANGED,
        "grayscale": cv2.IMREAD_GRAYSCALE}


def test_webp_fixture_set_is_whole():
    assert sorted(os.listdir(FIXTURES)) == sorted(
        [*DIGESTS, "digests.json", "flight"])
    total = sum(os.path.getsize(os.path.join(d, n))
                for d, _, names in os.walk(FIXTURES) for n in names)
    assert total < FIXTURE_LIMIT, total
    assert sorted(FLIGHT["png_sha256"]) == sorted(FLIGHT["webp_cv2"])
    assert len(FLIGHT["png_sha256"]) == FLIGHT["frames"] + 1


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_webp_fixture_digests_are_cv2s(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    assert hashlib.sha256(data).hexdigest() == DIGESTS[name]["file_sha256"]
    for key, flag in KEYS.items():
        assert _digest(cv2.imdecode(np.frombuffer(data, np.uint8), flag)) \
            == DIGESTS[name][key], key


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_webp_fixture_decodes_as_cv2(name):
    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as f:
        data = f.read()
    for key, flag in KEYS.items():
        assert _digest(decode_image(data, flag)) == DIGESTS[name][key], key
        assert _digest(read_image(path, flag)) == DIGESTS[name][key], key


@pytest.mark.parametrize("name", sorted(FLIGHT["webp_cv2"]))
def test_flight_files_decode_as_cv2(name):
    path = os.path.join(FIXTURES, "flight", name)
    want = FLIGHT["webp_cv2"][name]
    assert _digest(cv2.imread(path, cv2.IMREAD_GRAYSCALE)) == want
    assert _digest(read_image(path, cv2.IMREAD_GRAYSCALE)) == want


def test_flight_is_the_png_datasets(tmp_path):
    """The PNG dataset of the manifest's arguments holds the arrays whose
    sha256 the fixture tool recorded (what path 16 checks on the card
    machine), and the WebP flight reads as a dataset of the same poses."""
    root = str(tmp_path)
    write_replay_dataset(World.make(**FLIGHT["world"]), root,
                         frames=FLIGHT["frames"], hw=tuple(FLIGHT["hw"]),
                         coverage=FLIGHT["coverage"])
    for name, want in FLIGHT["png_sha256"].items():
        assert _digest(read_image(os.path.join(root, name),
                                  cv2.IMREAD_UNCHANGED)) == want, name
    png = treplay.load_dataset(root)
    webp = treplay.load_dataset(os.path.join(FIXTURES, "flight"))
    assert png["poses"][0]["stamp_us"] == webp["poses"][0]["stamp_us"]
    assert [p["lon"] for p in png["poses"]] == [p["lon"] for p in
                                               webp["poses"]]
    assert webp["ortho"].shape == png["ortho"].shape
    err = np.abs(webp["ortho"].astype(int) - png["ortho"])
    assert err.mean() < 3.0, err.mean()  # quality 90


# -- the replay and WMS routes through both packages -----------------------

@pytest.fixture(scope="module")
def world():
    return World.make(seed=7, size_px=3072, gsd_m=1.36)


def _as_webp(src: str, dst: str, *params) -> None:
    """Copy replay dataset ``src`` to ``dst`` with its map and frames
    re-encoded as WebP by cv2 under their layout names."""
    shutil.copytree(src, dst)
    names = ["map.png"] + [os.path.join("frames", n) for n in
                           os.listdir(os.path.join(src, "frames"))]
    for name in names:
        img = cv2.imread(os.path.join(src, name), cv2.IMREAD_UNCHANGED)
        with open(os.path.join(dst, name), "wb") as f:
            f.write(_cv2(img, *params))


@pytest.mark.parametrize("quality", [None, 90], ids=["lossless", "q90"])
def test_load_dataset_equals_jax(world, tmp_path, quality):
    png, webp = str(tmp_path / "png"), str(tmp_path / "webp")
    write_replay_dataset(world, png, frames=3)
    _as_webp(png, webp, *(() if quality is None
                          else (cv2.IMWRITE_WEBP_QUALITY, quality)))
    ours, ref = treplay.load_dataset(webp), jreplay.load_dataset(webp)
    assert set(ours) == set(ref)
    for key in ("ortho", "dem", "k"):
        _assert_same(ref[key], ours[key], key)
    assert ours["poses"] == ref["poses"]
    if quality is None:  # lossless: the PNG dataset's arrays
        _assert_same(treplay.load_dataset(png)["ortho"], ours["ortho"], "map")


def test_harris_replay_matches_jax_on_webp(world, tmp_path, monkeypatch):
    """The replay tests' 4-frame flight recorded as lossy WebP (cv2 at
    quality 90): both packages read the same pixels, so the gates are the
    PNG flight's."""
    from tests.test_torch_replay import _harris_replay_matches_jax

    png, webp = str(tmp_path / "png"), str(tmp_path / "webp")
    write_replay_dataset(world, png, frames=4)
    _as_webp(png, webp, cv2.IMWRITE_WEBP_QUALITY, 90)
    _harris_replay_matches_jax(webp, monkeypatch)


@pytest.mark.parametrize("kind", ["grey_lossy", "bgr_lossless", "bgra_lossy"])
def test_wms_webp_reply_equals_jax(world, kind):
    """A GetMap answered as ``image/webp`` (cv2's bytes of a world crop):
    both packages' clients and ``request_orthoimage`` give equal rasters."""
    crop = np.ascontiguousarray(world.raster[500:596, 700:820])
    img = {"grey_lossy": crop,
           "bgr_lossless": np.stack([crop, crop[::-1], crop[:, ::-1]],
                                    axis=2),
           "bgra_lossy": np.stack([crop, crop[::-1], crop, crop[:, ::-1]],
                                  axis=2)}[kind]
    params = () if "lossless" in kind else (cv2.IMWRITE_WEBP_QUALITY, 80)
    server = _serve("image/webp", _cv2(np.ascontiguousarray(img), *params))
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/wms"
        ours, ref = WMSClient(url), jax_wms.WMSClient(url)
        bb = (24.0, 60.0, 24.01, 60.01)
        for grey in (False, True):
            _assert_same(ref.get_map(["x"], bb, (96, 120), grayscale=grey),
                         ours.get_map(["x"], bb, (96, 120), grayscale=grey),
                         f"get_map grey {grey}")
        got = request_orthoimage(ours, bb, (96, 120), ["x"], ["dem"],
                                 format_="image/webp")
        want = jax_wms.request_orthoimage(ref, bb, (96, 120), ["x"], ["dem"],
                                          format_="image/webp")
        for a, b in zip(got, want):
            _assert_same(b, a, "request_orthoimage")
    finally:
        server.shutdown()
        server.server_close()
