"""The port's JPEG 2000 decoder (``gis/jpeg2000.py`` over
``native/jpeg2000.cpp``) against OpenCV's (OpenJPEG), on the CPU: the files
Pillow and cv2 write.

- ``decode_image`` and ``read_image`` equal ``cv2.imdecode`` and
  ``cv2.imread`` exactly under ``IMREAD_UNCHANGED`` and
  ``IMREAD_GRAYSCALE`` (values, dtype, shape; None where cv2 gives None),
  reversible and irreversible files alike (no difference of even one grey
  level is allowed anywhere), on Pillow's options in combination: modes L,
  RGB, RGBA, YCbCr, LA and I;16 at 1x1 to 130x97 px; reversible and
  irreversible; the five progressions with and without precincts and
  quality layers; tiles; 1-6 resolutions; code-block sizes; ``mct=0``;
  ``plt``; raw J2K codestreams; ``signed``; and cv2's ``.jp2`` at several
  ``IMWRITE_JPEG2000_COMPRESSION_X1000`` values; one 1088x1920 frame.
- The dispatch: OpenCV's two signatures pick the decoder, AVIF still
  raises, and reading a PNG, JPEG, TIFF or WebP never builds or loads the
  JPEG 2000 library.

``tests/test_torch_jpeg2000_variants.py`` holds OpenJPEG's encoder options
Pillow lacks, JP2 boxes and patched headers;
``tests/test_torch_jpeg2000_damage.py`` cut and damaged files;
``tests/test_torch_jpeg2000_paths.py`` the fixtures, the flight and the
replay and WMS paths.
"""
import io
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

from gisnav_tpu_torch.gis.imgcodecs import (decode_image, image_format,
                                            read_image)
from gisnav_tpu_torch.gis.jpeg2000 import is_jpeg2000

cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_SILENT)
FLAGS = (cv2.IMREAD_UNCHANGED, cv2.IMREAD_GRAYSCALE)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rng(name: str) -> np.random.Generator:
    return np.random.default_rng(sum(map(ord, name)))


def _scene(name: str, h: int, w: int, c: int) -> np.ndarray:
    """Smooth seeded content with some grain, (h, w, c) uint8."""
    rng = _rng(name)
    base = cv2.resize(rng.integers(0, 256, (max(h // 8, 2), max(w // 8, 2),
                                            c)).astype(np.uint8), (w, h),
                      interpolation=cv2.INTER_CUBIC).reshape(h, w, c)
    return np.clip(base.astype(int) + rng.integers(-12, 13, (h, w, c)), 0,
                   255).astype(np.uint8)


CHANNELS = {"L": 1, "RGB": 3, "RGBA": 4, "YCbCr": 3, "LA": 2, "I;16": 1}


def _pil(img: np.ndarray, mode: str, **kw) -> bytes:
    f = io.BytesIO()
    if mode == "I;16":
        im = Image.frombytes("I;16", img.shape[1::-1],
                             img.astype("<u2").tobytes())
    else:
        im = Image.frombytes(mode, img.shape[1::-1],
                             np.ascontiguousarray(img).tobytes())
    im.save(f, "JPEG2000", **kw)
    return f.getvalue()


def _image(mode: str, h: int, w: int) -> np.ndarray:
    img = _scene(f"{mode}{h}{w}", h, w, CHANNELS[mode])
    if mode == "I;16":
        grain = _rng(f"i16{h}{w}").integers(0, 256, (h, w))
        return (img[..., 0].astype(np.uint16) << 8) | grain.astype(np.uint16)
    return img[..., 0] if mode == "L" else img


def _assert_same(ref, got, what):
    assert (ref is None) == (got is None), (what, ref is None)
    if ref is not None:
        assert got.dtype == ref.dtype and got.shape == ref.shape, (
            what, got.dtype, got.shape, ref.dtype, ref.shape)
        assert np.array_equal(got, ref), (
            what, np.argwhere(got != ref)[:4].tolist(),
            int(np.abs(got.astype(np.int64) - ref).max()))


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
            _assert_same(cv2.imread(str(path), flag),
                         read_image(str(path), flag), f"imread flag {flag}")


# -- Pillow's options in combination ----------------------------------------

IRR = {"irreversible": True}
RATES = {"quality_mode": "rates"}
OPTIONS = {
    "reversible": {},
    "irreversible": IRR,
    "raw_j2k": {"no_jp2": True},
    "raw_j2k_irreversible": {"no_jp2": True, **IRR},
    "mct0": {"mct": 0},
    "mct0_irreversible": {"mct": 0, **IRR},
    "plt": {"plt": True},
    "layers_rates": {**RATES, "quality_layers": [40, 10, 3]},
    "layers_db": {"quality_mode": "dB", "quality_layers": [30, 40]},
    "irreversible_rate20": {**IRR, **RATES, "quality_layers": [20]},
    "irreversible_rate80": {**IRR, **RATES, "quality_layers": [80]},
    "res1": {"num_resolutions": 1},
    "res2": {"num_resolutions": 2},
    "res4_irreversible": {"num_resolutions": 4, **IRR},
    "cblk4x4": {"codeblock_size": (4, 4)},
    "cblk16x64": {"codeblock_size": (16, 64)},
    "cblk64x16_irreversible": {"codeblock_size": (64, 16), **IRR},
    "precinct128": {"precinct_size": (128, 128)},
    "tiles16": {"tile_size": (16, 16)},
    "tiles33x21": {"tile_size": (33, 21)},
    "tiles33x21_irreversible": {"tile_size": (33, 21), **IRR},
    **{f"{p}": {"progression": p} for p in
       ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")},
    **{f"{p}_precincts_layers": {"progression": p,
                                 "precinct_size": (64, 64),
                                 "num_resolutions": 3, **RATES,
                                 "quality_layers": [30, 8]}
       for p in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")},
    **{f"{p}_tiles_irreversible": {"progression": p, "tile_size": (25, 31),
                                   "num_resolutions": 3, **IRR}
       for p in ("RPCL", "PCRL", "CPRL")},
}
SIZES = [(1, 1), (2, 3), (7, 5), (17, 23), (64, 64), (33, 70), (130, 97)]


def _writable(h: int, w: int, opts: dict) -> bool:
    """Whether Pillow's OpenJPEG writes these options at this size: it
    refuses more resolutions than the smaller side allows, and its
    irreversible wavelet asserts on edge tiles under 8 px."""
    levels = int(np.floor(np.log2(min(h, w))))
    if opts.get("num_resolutions", 1) > 1 + levels:
        return False
    if "tile_size" in opts and opts.get("irreversible"):
        tw, th = opts["tile_size"]
        if 0 < w % tw < 8 or 0 < h % th < 8 or min(h, w) < 8:
            return False
    if opts.get("irreversible") and min(h, w) < 4:
        return False
    return True


CASES = [(mode, size, name) for mode in CHANNELS for size in SIZES
         for name, opts in OPTIONS.items() if _writable(*size, opts)]


@pytest.mark.parametrize("mode,size,option", CASES,
                         ids=[f"{m}-{h}x{w}-{o}" for m, (h, w), o in CASES])
def test_pillow_options(mode, size, option, tmp_path):
    data = _pil(_image(mode, *size), mode, **OPTIONS[option])
    _check(data, tmp_path / "x.jp2" if size == (17, 23) else None)


@pytest.mark.parametrize("mode", ["L", "RGB", "I;16"])
def test_pillow_signed(mode, tmp_path):
    """Signed components: cv2 refuses them (None under both flags)."""
    data = _pil(_image(mode, 17, 23), mode, signed=True)
    _check(data, tmp_path / "s.jp2")
    assert decode_image(data) is None


# -- cv2's writer --------------------------------------------------------------

@pytest.mark.parametrize("x1000", [None, 1000, 500, 250, 100, 20])
@pytest.mark.parametrize("kind", ["grey", "bgr", "grey16"])
def test_cv2_files(kind, x1000, tmp_path):
    img = _scene(f"cv2{kind}{x1000}", 41, 57, 1 if "grey" in kind else 3)
    img = img[..., 0] if img.shape[2] == 1 else img
    if kind == "grey16":
        img = img.astype(np.uint16) * 257
    params = [] if x1000 is None else [
        cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, x1000]
    ok, buf = cv2.imencode(".jp2", img, params)
    assert ok
    _check(buf.tobytes(), tmp_path / "c.jp2")


def test_full_width_frame(tmp_path):
    """One 1088x1920 grey frame as path 17's flight holds them
    (irreversible at 25:1) and reversible, bit for bit."""
    from gisnav_tpu_torch.utils.world_wms import World

    world = World.make(seed=7, size_px=2048, gsd_m=1.36)
    frame = np.ascontiguousarray(world.raster[400:1488, 64:1984])
    for opts in ({**IRR, **RATES, "quality_layers": [25]}, {}):
        _check(_pil(frame, "L", **opts), tmp_path / "f.jp2")


# -- the dispatch ----------------------------------------------------------

def test_signatures_pick_the_decoder():
    raw = _pil(_image("L", 9, 9), "L", no_jp2=True)
    jp2 = _pil(_image("L", 9, 9), "L")
    assert raw[:4] == b"\xff\x4f\xff\x51"
    assert jp2[:12] == b"\x00\x00\x00\x0cjP  \r\n\x87\n"
    for data in (raw, jp2):
        assert is_jpeg2000(data[:12])
        assert image_format(data) == "JPEG 2000"
    # a raw codestream whose SOC is not followed by SIZ is not JPEG 2000
    assert not is_jpeg2000(b"\xff\x4f\xff\x52" + raw[4:12])
    assert image_format(b"\xff\x4f\xff\x52" + raw[4:]) is None


def test_other_formats_never_load_the_library(tmp_path):
    """Reading PNG, JPEG, TIFF and WebP neither builds nor loads the JPEG
    2000 decoder (a fresh process; the build directory is watched)."""
    img = _scene("others", 24, 32, 3)
    for ext in (".png", ".jpg", ".tif", ".webp"):
        ok, buf = cv2.imencode(ext, img)
        assert ok
        (tmp_path / f"x{ext}").write_bytes(buf.tobytes())
    code = (
        "import os, sys\n"
        "from gisnav_tpu_torch import native\n"
        "from gisnav_tpu_torch.gis import jpeg2000\n"
        "from gisnav_tpu_torch.gis.imgcodecs import read_image\n"
        "built = []\n"
        "real = native.build_native_lib\n"
        "jpeg2000.build_native_lib = lambda n: built.append(n) or real(n)\n"
        "for name in sorted(os.listdir(sys.argv[1])):\n"
        "    assert read_image(os.path.join(sys.argv[1], name)) is not None\n"
        "assert jpeg2000._lib.cache_info().currsize == 0, built\n"
        "assert built == [], built\n")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=ROOT, capture_output=True, text=True,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-2000:]
