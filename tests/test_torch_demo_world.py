"""The demo world of the port (``utils/world.py`` ``synthetic_world``,
``synthetic_dem``, ``DEMO_GEOREF``; ``utils/drawing.py``) and its GeoTIFF
tool against the JAX package's and OpenCV, on the CPU.

- Drawing: ``rectangle`` and ``circle`` (filled, ``LINE_8``), ``line`` at
  thickness 1-11 and ``gaussian_blur`` (3x3) equal ``cv2.rectangle``,
  ``cv2.circle``, ``cv2.line`` and ``cv2.GaussianBlur(img, (3, 3), sigma)``
  pixel for pixel on seeded draws: shapes that cross the right and bottom
  edges, lines with ends off the image on every side (negative
  coordinates too), horizontal, vertical and 45-degree lines, and the
  ranges ``synthetic_world`` draws from (sizes 8-80, thickness 2-7, the
  second end within 2 sizes of the first). Any other argument raises
  ``ValueError``.
- ``synthetic_world`` bit for bit the JAX one at ``(256, 7, 4000)``,
  ``(512, 3, 800)`` (``tests/test_gis_stack.py``'s fixture) and the tool's
  default ``(4096, 7, 4000)``; ``synthetic_dem`` at its defaults, at
  ``(128, base_m=10, relief_m=20)`` and flat; ``DEMO_GEOREF.georef(n)``'s
  fields.
- ``tools/make_demo_geotiff_torch.py`` writes the bytes of
  ``tools/make_demo_geotiff.py`` at ``--size 256 --dem-size 64`` and at
  the defaults, and ``chip_smoke.py``'s ``DEMO_DIGESTS`` are the sha256 of
  the JAX tool's default arrays.
- Importing ``gisnav_tpu_torch.utils.world`` and running the port's tool
  leave no ``cv2``, ``jax`` or ``gisnav_tpu`` in ``sys.modules``.
"""
import hashlib
import os
import subprocess
import sys
import zlib

import cv2
import numpy as np
import pytest

from gisnav_tpu.utils import world as jworld
from gisnav_tpu_torch.utils import drawing
from gisnav_tpu_torch.utils import world as tworld

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANVAS = (97, 131)  # odd sides, neither a multiple of the other


def _canvas(rng):
    return rng.integers(0, 256, CANVAS).astype(np.uint8)


def _same(draw_ours, draw_cv2, img):
    a, b = img.copy(), img.copy()
    draw_ours(a)
    draw_cv2(b)
    assert np.array_equal(a, b), np.argwhere(a != b)[:8].tolist()


@pytest.mark.parametrize("seed", range(6))
def test_filled_rectangle_is_cv2(seed):
    rng = np.random.default_rng(seed)
    h, w = CANVAS
    img = _canvas(rng)
    for _ in range(60):
        # corners near and past the right and bottom edges, any order
        x, y = int(rng.integers(-20, w + 5)), int(rng.integers(-20, h + 5))
        s = int(rng.integers(8, 80))
        x2, y2 = x + s, y + int(s * rng.uniform(0.3, 1.5))
        if rng.random() < 0.3:
            x, x2 = x2, x
        v = int(rng.integers(0, 256))
        _same(lambda a: drawing.rectangle(a, (x, y), (x2, y2), v, -1),
              lambda a: cv2.rectangle(a, (x, y), (x2, y2), v, -1), img)


@pytest.mark.parametrize("seed", range(6))
def test_filled_circle_is_cv2(seed):
    rng = np.random.default_rng(100 + seed)
    h, w = CANVAS
    img = _canvas(rng)
    for _ in range(60):
        x, y = int(rng.integers(-30, w + 30)), int(rng.integers(-30, h + 30))
        r = int(rng.integers(0, 80)) // 2
        v = int(rng.integers(0, 256))
        _same(lambda a: drawing.circle(a, (x, y), r, v, -1),
              lambda a: cv2.circle(a, (x, y), r, v, -1), img)


def _line_ends(rng, kind):
    h, w = CANVAS
    x, y = int(rng.integers(-100, w + 100)), int(rng.integers(-100, h + 100))
    if kind == "world":  # synthetic_world's draw from a point in the image
        x, y = int(rng.integers(0, w)), int(rng.integers(0, h))
        s = int(rng.integers(8, 80))
        return x, y, x + int(s * rng.uniform(-2, 2)), \
            y + int(s * rng.uniform(-2, 2))
    d = int(rng.integers(-200, 200))
    return {"horizontal": (x, y, x + d, y), "vertical": (x, y, x, y + d),
            "diagonal": (x, y, x + d, y + d),
            "antidiagonal": (x, y, x + d, y - d),
            "any": (x, y, int(rng.integers(-100, w + 100)),
                    int(rng.integers(-100, h + 100)))}[kind]


@pytest.mark.parametrize("kind", ["world", "horizontal", "vertical",
                                  "diagonal", "antidiagonal", "any"])
@pytest.mark.parametrize("thick", [(1, 2), (2, 8), (8, 12)])
def test_line_is_cv2(kind, thick):
    rng = np.random.default_rng(zlib.crc32(f"{kind} {thick}".encode()))
    img = _canvas(rng)
    for _ in range(80):
        x0, y0, x1, y1 = _line_ends(rng, kind)
        t = int(rng.integers(*thick))
        v = int(rng.integers(0, 256))
        _same(lambda a: drawing.line(a, (x0, y0), (x1, y1), v, t),
              lambda a: cv2.line(a, (x0, y0), (x1, y1), v, t), img)


@pytest.mark.parametrize("sigma", [0.8, 0.0, 0.3, 0.5, 1.0, 1.5, 3.0])
@pytest.mark.parametrize("shape", [(97, 131), (2, 2), (3, 50), (256, 256)])
def test_gaussian_blur_is_cv2(sigma, shape):
    rng = np.random.default_rng(int(sigma * 10) + shape[0])
    img = rng.integers(0, 256, shape).astype(np.uint8)
    want = cv2.GaussianBlur(img, (3, 3), sigma)
    assert np.array_equal(drawing.gaussian_blur(img, (3, 3), sigma), want)


def test_drawing_rejects_what_the_world_does_not_draw():
    img = np.zeros((8, 8), np.uint8)
    for call in (
            lambda: drawing.rectangle(img, (0, 0), (3, 3), 1, 1),
            lambda: drawing.circle(img, (4, 4), 2, 1, 2),
            lambda: drawing.circle(img, (4, 4), -1, 1, -1),
            lambda: drawing.line(img, (0, 0), (3, 3), 1, 0),
            lambda: drawing.line(img, (0, 0), (3, 3), 256, 2),
            lambda: drawing.line(img, (0.5, 0), (3, 3), 1, 2),
            lambda: drawing.line(np.zeros((8, 8, 3), np.uint8), (0, 0),
                                 (3, 3), 1, 2),
            lambda: drawing.line(img.astype(np.float32), (0, 0), (3, 3), 1,
                                 2),
            lambda: drawing.line(img[:, ::2], (0, 0), (3, 3), 1, 2),
            lambda: drawing.gaussian_blur(img.astype(np.int16), (3, 3), 0.8),
            lambda: drawing.gaussian_blur(img, (3, 3), float("nan"))):
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("args", [(256, 7, 4000), (512, 3, 800),
                                  (4096, 7, 4000)])
def test_synthetic_world_is_jax_bit_for_bit(args):
    ours, ref = tworld.synthetic_world(*args), jworld.synthetic_world(*args)
    assert ours.dtype == ref.dtype == np.uint8
    assert ours.shape == ref.shape == (args[0], args[0])
    assert np.array_equal(ours, ref), int((ours != ref).sum())


@pytest.mark.parametrize("kw", [{}, dict(size_px=128, base_m=10.0,
                                         relief_m=20.0),
                                dict(size_px=256, relief_m=0.0)])
def test_synthetic_dem_is_jax_bit_for_bit(kw):
    ours, ref = tworld.synthetic_dem(**kw), jworld.synthetic_dem(**kw)
    assert ours.dtype == ref.dtype == np.float32
    assert ours.tobytes() == ref.tobytes()


@pytest.mark.parametrize("size", [64, 512, 1024, 4096])
def test_demo_georef_fields_are_jax(size):
    ours, ref = tworld.DEMO_GEOREF.georef(size), \
        jworld.DEMO_GEOREF.georef(size)
    assert type(ours).__module__ == "gisnav_tpu_torch.gis.geotiff"
    for f in ("left", "top", "gsd_lon", "gsd_lat"):
        assert getattr(ours, f) == getattr(ref, f), f
    assert ours.bbox((size, size)) == ref.bbox((size, size))


def _run_tool(name, out, *args):
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "tools", name),
                           "--out", str(out), *args], capture_output=True,
                          text=True, timeout=300,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


LAYOUT = (("imagery", "demo_imagery.tif"), ("dem", "demo_dem.tif"))


@pytest.mark.parametrize("args", [("--size", "256", "--dem-size", "64"),
                                  ()])
def test_tools_write_the_same_bytes(tmp_path, args):
    ours = _run_tool("make_demo_geotiff_torch.py", tmp_path / "ours", *args)
    ref = _run_tool("make_demo_geotiff.py", tmp_path / "ref", *args)
    assert ours.replace("ours", "ref") == ref
    for layer, name in LAYOUT:
        a = (tmp_path / "ours" / layer / name).read_bytes()
        b = (tmp_path / "ref" / layer / name).read_bytes()
        assert a == b, layer


def test_chip_smoke_digests_are_the_jax_tools_arrays():
    arrays = {"imagery": jworld.synthetic_world(4096, seed=7),
              "dem": jworld.synthetic_dem(1024, seed=11, relief_m=12.0)}
    assert set(chip_smoke.DEMO_DIGESTS) == set(arrays)
    for layer, (name, dtype, digest) in chip_smoke.DEMO_DIGESTS.items():
        a = arrays[layer]
        assert (layer, name) in LAYOUT and a.dtype == dtype
        assert hashlib.sha256(np.ascontiguousarray(
            a, np.dtype(dtype).newbyteorder("<")).tobytes()
        ).hexdigest() == digest, layer


FORBIDDEN = ("cv2", "jax", "jaxlib", "gisnav_tpu")


def test_world_and_tool_import_no_cv2_jax_or_jax_package(tmp_path):
    code = f"""
import runpy, sys
import gisnav_tpu_torch.utils.world as w
w.synthetic_world(64, n_shapes=40)
sys.argv = ["make_demo_geotiff_torch.py", "--out", {str(tmp_path)!r},
            "--size", "64", "--dem-size", "16"]
try:
    runpy.run_path({os.path.join(ROOT, "tools",
                                 "make_demo_geotiff_torch.py")!r},
                   run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
print(sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r}))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]", proc.stdout
