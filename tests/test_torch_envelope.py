"""The port's accuracy battery (``gisnav_tpu_torch/utils/envelope.py`` and
``tools/sweep_headline_torch.py``) against the JAX repository's code it
ports, on the CPU.

- The shape world (``tests/test_integration.WORLD``, 4096 px): bit-equal.
- The appearance transforms of ``tests/test_world_appearance.py`` on a
  480x640 frame of it: ``seasonal_tone``, ``temporal_change`` and
  ``jpeg_q40`` bit-equal; ``sun_shadows`` (a float32 13-tap blur and two
  bicubic shading octaves) and ``sensor_noise`` within one grey level on
  at most 1e-4 of the pixels (measured: none differs on the test's frame,
  one pixel of ``sun_shadows`` at yaw 30 of the battery's). The appearance
  map (INTER_AREA of the 1766-px crop to 800) and the frames of each
  scenario, with the test's ``default_rng(42)``, bit-equal.
- The fractal world (``tests/test_world_fractal.py``) and the field world
  (``tests/test_world_fieldlines.py``) at 4096 px, and ``_MatchedWorld``
  of ``tools/sweep_headline.py`` at 1440 px: within one grey level, on at
  most 1e-5 of the pixels (the worlds' bicubic octaves are IPP's values to
  a few ulp; measured 14, 25 and 5 pixels one level off).
- Each world's nadir render bit-equal to ``cv2.warpPerspective`` of the
  same world, and the maps' resizes (INTER_AREA, INTER_LINEAR) bit-equal
  to ``cv2.resize`` of the same crop.
- ``drawing.gaussian_blur`` and ``world.resize_cubic`` / ``resize_linear_u8``
  at the battery's arguments against cv2.
- The sweep tool on ``--device cpu`` at 480x640, 512 keypoints,
  LightGlue-9, 500 m and the bucket-edge yaws 7.5 and 142.5 over a world
  at the query's GSD ('auto'), in the warp and warp-bucketed modes,
  against ``tools/sweep_headline.py`` (JAX) with the same arguments, the
  port's RANSAC drawing the JAX runner's samples: per row, ``valid`` equal
  and the fix within 2.5 m of JAX's (the warp runners' gate of
  ``tests/test_torch_runners.py``; measured 1.43 and 1.16 m warp, 0.73
  and 0.52 m bucketed).
"""
import contextlib
import importlib.util
import io
import itertools
import json
import os
import sys

import cv2
import jax
import numpy as np
import pytest

import tests.test_integration as ti
import tests.test_world_appearance as ta
import tests.test_world_fieldlines as tfl
import tests.test_world_fractal as tf
from gisnav_tpu_torch.geometry.crs import haversine_m
from gisnav_tpu_torch.utils import drawing, envelope, world
from tests.test_torch_geometry import jax_ransac_sample

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name: str):
    path = os.path.join(ROOT, "tools", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def _near(ours: np.ndarray, ref: np.ndarray, share: float, what: str):
    """Within one grey level, on at most ``share`` of the pixels; prints
    the count."""
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    d = np.abs(ours.astype(np.int16) - ref.astype(np.int16))
    off = int((d > 0).sum())
    print(f"{what}: {off} of {d.size} pixels one grey level off "
          f"({off / d.size:.2e})")
    assert int(d.max()) <= 1, (what, int(d.max()))
    assert off <= share * d.size, (what, off)


def _cv2_nadir(img, cx, cy, alt_wpx, yaw, k, hw):
    a = np.radians(yaw)
    c, s = np.cos(a), np.sin(a)
    r = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1.0]])
    t = -r @ np.array([cx, cy, -alt_wpx])
    hm = k @ np.stack([r[:, 0], r[:, 1], t], axis=1)
    return cv2.warpPerspective(img, hm, (hw[1], hw[0]))


def test_shape_world_is_the_integration_world():
    ours = envelope.shape_world()
    assert ours.dtype == np.uint8 and ours.shape == (4096, 4096)
    assert np.array_equal(ours, ti.WORLD)
    for name in ("W_PX", "LEFT", "TOP", "GSD_LON", "GSD_LAT", "M_PER_WPX",
                 "ALT_M", "YAW_DEG"):
        assert getattr(envelope, name) == getattr(ti, name), name
    assert np.array_equal(envelope.K_CAM, ti.K_CAM)
    assert envelope.lonlat_to_wpx(24.03, 60.02) == ti._lonlat_to_wpx(
        24.03, 60.02)


@pytest.mark.parametrize("name", sorted(envelope.APPEARANCE))
def test_appearance_transform_as_jax(name):
    frame = ti.WORLD[2000:2480, 2000:2640].copy()
    ours = envelope.APPEARANCE[name](frame.copy(), np.random.default_rng(7))
    ref = ta.SCENARIOS[name](frame.copy(), np.random.default_rng(7))
    if name in ("sun_shadows", "sensor_noise"):
        _near(ours, ref, 1e-4, name)
    else:
        assert ours.dtype == ref.dtype and np.array_equal(ours, ref), name


def test_appearance_map_as_jax():
    ortho, dem, aff = envelope.appearance_map()
    side = int(round(3.0 * ta.ALT * max(ta.H, ta.W) / ta.F / ti.M_PER_WPX))
    cx, cy = ti._lonlat_to_wpx(ta.LON0, ta.LAT0)
    x0, y0 = int(cx - side / 2), int(cy - side / 2)
    ref = cv2.resize(ti.WORLD[y0:y0 + side, x0:x0 + side], (800, 800),
                     interpolation=cv2.INTER_AREA)
    assert np.array_equal(ortho, ref)
    assert dem.shape == (800, 800) and not dem.any()
    from gisnav_tpu.geometry.crs import pixel_to_wgs84_affine as j_aff

    left = ti.LEFT + x0 * ti.GSD_LON
    top = ti.TOP - y0 * ti.GSD_LAT
    np.testing.assert_array_equal(aff, np.asarray(j_aff(
        800, 800, left, top - side * ti.GSD_LAT, left + side * ti.GSD_LON,
        top)))


@pytest.mark.parametrize("name", sorted(envelope.APPEARANCE))
def test_appearance_frames_as_jax(name):
    """``_fly``'s renders under the ``rng`` fixture's generator (seed 42),
    both yaws drawing from it in order."""
    ours = envelope.appearance_frames(envelope.APPEARANCE[name],
                                      np.random.default_rng(42))
    rng = np.random.default_rng(42)
    for (yaw, lon, lat, frame), want_yaw in zip(ours, ta.YAWS):
        assert yaw == want_yaw
        assert lon == ta.LON0 + 0.0004 * np.cos(np.radians(yaw))
        assert lat == ta.LAT0 + 0.0002 * np.sin(np.radians(yaw))
        cxq, cyq = ti._lonlat_to_wpx(lon, lat)
        ref = ta.SCENARIOS[name](_cv2_nadir(
            ti.WORLD, cxq, cyq, ta.ALT / ti.M_PER_WPX, yaw, ta.K_CAM,
            (ta.H, ta.W)), rng)
        if name in ("sun_shadows", "sensor_noise"):
            _near(frame, ref, 1e-4, f"{name} yaw {yaw}")
        else:
            assert np.array_equal(frame, ref), (name, yaw)


@pytest.fixture(scope="module")
def fractal():
    return envelope.fractal_world()


def test_fractal_world_as_jax(fractal):
    _near(fractal, tf.WORLD_F, 1e-5, "fractal world")


def test_fractal_scene_renders_as_cv2(fractal):
    ortho, dem, aff, frames = envelope.fractal_scene(fractal)
    lat0, lon0 = 60.02, 24.03
    half_lon = 1400.0 / (111320 * np.cos(np.radians(60)))
    half_lat = 1400.0 / 110574
    x0, y0 = ti._lonlat_to_wpx(lon0 - half_lon, lat0 + half_lat)
    x1, y1 = ti._lonlat_to_wpx(lon0 + half_lon, lat0 - half_lat)
    crop = fractal[int(y0):int(y1), int(x0):int(x1)]
    assert np.array_equal(ortho, cv2.resize(crop, (1024, 1024),
                                            interpolation=cv2.INTER_AREA))
    for yaw, lon, lat, frame in frames:
        assert (lon, lat) == (lon0, lat0)
        assert np.array_equal(frame, tf._render_frame(
            fractal, lon, lat, ti.ALT_M, yaw, ti.K_CAM)), yaw


def test_field_world_and_scene_as_jax():
    ours = envelope.field_world()
    _near(ours, tfl._make_field_world(), 1e-5, "field world")
    ortho, dem, aff, k, frames = envelope.field_scene(ours)
    side = int(round(3.0 * 500.0 * 640 / 400.0 / tfl.M_PER_WPX))
    x0 = y0 = tfl.W_PX // 2 - side // 2
    assert np.array_equal(ortho, cv2.resize(
        ours[y0:y0 + side, x0:x0 + side], (800, 800),
        interpolation=cv2.INTER_AREA))
    m_per_deg_lon = 111320.0 * np.cos(np.radians(60.0))
    gsd_lon = tfl.M_PER_WPX / m_per_deg_lon
    gsd_lat = tfl.M_PER_WPX / 111320.0
    for yaw, lon, lat, frame in frames:
        cxq = tfl.W_PX // 2 + (lon - 24.0) / gsd_lon
        cyq = tfl.W_PX // 2 - (lat - 60.0) / gsd_lat
        assert np.array_equal(frame, _cv2_nadir(
            ours, cxq, cyq, 500.0 / tfl.M_PER_WPX, yaw, k, (480, 640))), yaw


def test_matched_world_as_jax():
    """``_MatchedWorld`` at a 1440-px side (0.417 m/px over 600 m)."""
    sweep = _load("sweep_headline")
    ref = sweep._MatchedWorld(600.0, 0.417, 24.04, 60.025)
    ours = envelope.MatchedWorld(600.0, 0.417, 24.04, 60.025)
    assert ours.w_px == ref.w_px == 1440
    for name in ("gsd_lon", "gsd_lat", "left", "top"):
        assert getattr(ours, name) == getattr(ref, name), name
    _near(ours.world, ref.world, 1e-5, "matched world")
    cx, cy = ours.lonlat_to_wpx(24.0401, 60.0251)
    assert (cx, cy) == ref.lonlat_to_wpx(24.0401, 60.0251)
    k = np.array([[600.0, 0, 480.0], [0, 600.0, 272.0], [0, 0, 1.0]],
                 np.float32)
    frame = envelope.nadir_frame(ours.world, cx, cy, 300.0 / 0.417, 52.5,
                                 k, (544, 960))
    assert np.array_equal(frame, _cv2_nadir(ours.world, cx, cy,
                                            300.0 / 0.417, 52.5, k,
                                            (544, 960)))


@pytest.mark.parametrize("dtype,ksize,sigma", [
    (np.uint8, (5, 5), 1.2), (np.uint8, (0, 0), 0.7),
    (np.uint8, (3, 3), 0.8), (np.uint8, (7, 5), 2.0),
    (np.uint8, (5, 5), 0.0), (np.float32, (0, 0), 1.5),
    (np.float32, (5, 5), 1.2)])
def test_gaussian_blur_as_cv2(dtype, ksize, sigma):
    rng = np.random.default_rng(int(sigma * 10) + ksize[0])
    img = (rng.integers(0, 256, (97, 131)).astype(np.uint8)
           if dtype == np.uint8 else rng.random((97, 131)).astype(dtype))
    ours = drawing.gaussian_blur(img, ksize, sigma)
    ref = cv2.GaussianBlur(img, ksize, sigma)
    assert ours.dtype == ref.dtype
    if dtype == np.uint8:
        assert np.array_equal(ours, ref)
    else:  # OpenCV's float sums in its own order: a few ulp
        np.testing.assert_allclose(ours, ref, rtol=0, atol=4e-7)


@pytest.mark.parametrize("n,hw", [(6, (480, 640)), (24, (480, 640)),
                                  (5, (7, 11))])
def test_resize_cubic_to_a_rectangle_as_cv2(n, hw):
    grid = np.random.default_rng(n).standard_normal((n, n)).astype(
        np.float32)
    ref = cv2.resize(grid, (hw[1], hw[0]), interpolation=cv2.INTER_CUBIC)
    np.testing.assert_allclose(world.resize_cubic(grid, hw), ref, rtol=0,
                               atol=2e-6)


@pytest.mark.parametrize("n_in,n_out", [(177, 221), (1767, 2208), (5, 7),
                                        (600, 751)])
def test_resize_linear_u8_as_cv2(n_in, n_out):
    img = envelope.shape_world()[1000:1000 + n_in, 1200:1200 + n_in]
    ref = cv2.resize(img, (n_out, n_out), interpolation=cv2.INTER_LINEAR)
    assert np.array_equal(world.resize_linear_u8(img, n_out, n_out), ref)


@pytest.mark.parametrize("shape,hw", [((2061, 2061), (1024, 1024)),
                                      ((5755, 5755), (2208, 2208)),
                                      ((600, 600), (300, 300)),
                                      ((601, 577), (200, 221))])
def test_resize_area_u8_as_cv2(shape, hw):
    img = tf.WORLD_F[:shape[0], :shape[1]]
    ref = cv2.resize(img, (hw[1], hw[0]), interpolation=cv2.INTER_AREA)
    assert np.array_equal(world.resize_area_u8(img, *hw), ref)


# the validated 480x640 camera (f 400) at 500 m over a world at its GSD
# (1.25 m/px, 2272 px); at 256x448 the fixes of both packages are 1-12 m
# from the truth and move metres with their match sets, which compares
# the draw more than the port
ARGS = ["--hw", "480", "640", "--kp", "512", "--depth", "9", "--alts",
        "500", "--yaws", "7.5", "142.5", "--world-gsd", "auto"]


def _recording(module, name, store):
    """``module.name`` wrapped to append each result to ``store``."""
    fn = getattr(module, name)

    def wrapped(*a, **k):
        out = fn(*a, **k)
        store.append(out)
        return out

    return wrapped


@pytest.mark.parametrize("mode", ["warp", "warp-bucketed"])
def test_sweep_tool_rows_as_jax(mode, monkeypatch):
    import gisnav_tpu.pipeline.geopose as jgp
    import gisnav_tpu.utils.jitcache as jcache
    import gisnav_tpu_torch.pipeline.geopose as tgp
    import gisnav_tpu_torch.pipeline.runners as truns

    program = {"warp": "build_frame_to_geopose",
               "warp-bucketed": "build_frame_to_geopose_warpcached"}[mode]
    make_program = getattr(truns, program)
    frames = itertools.count(1)

    def drawing_as_jax(config):
        fn = make_program(config)

        def run(*a, **kw):
            key = jax.random.PRNGKey(next(frames))
            kw["sample_idx"] = lambda mask, _: jax_ransac_sample(
                key, mask.cpu().numpy())
            return fn(*a, **kw)

        return run

    ours, ref = [], []
    monkeypatch.setattr(truns, program, drawing_as_jax)
    monkeypatch.setattr(tgp, "geopose_to_wgs84_f64",
                        _recording(tgp, "geopose_to_wgs84_f64", ours))
    monkeypatch.setattr(jgp, "geopose_to_wgs84_f64",
                        _recording(jgp, "geopose_to_wgs84_f64", ref))
    monkeypatch.setattr(jcache, "enable_persistent_cache", lambda: None)
    argv = ARGS + ["--mode", mode]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert _load("sweep_headline_torch").main(argv + ["--device",
                                                          "cpu"]) == 0
    port = json.loads(out.getvalue().strip().splitlines()[-1])
    monkeypatch.setattr(sys, "argv", ["sweep_headline.py"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _load("sweep_headline").main()
    jax_line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert set(port) == set(jax_line)
    assert port["config"] == jax_line["config"]
    assert port["world_gsd_m"] == jax_line["world_gsd_m"]
    assert port["poses"] == jax_line["poses"] == 2
    assert len(ours) == len(ref) == 2
    for p, r, fp, fr in zip(port["rows"], jax_line["rows"], ours, ref):
        assert set(p) == set(r)
        assert (p["alt"], p["yaw"]) == (r["alt"], r["yaw"])
        assert p["valid"] == r["valid"], (p, r)
        moved = haversine_m(fr["lat"], fr["lon"], fp["lat"], fp["lon"])
        print(f"{mode} yaw {p['yaw']}: port {p['horiz_m']} m, JAX "
              f"{r['horiz_m']} m from the truth; {moved:.3f} m apart")
        if r["valid"]:
            assert moved < 2.5, (p, r, moved)
    assert port["valid"] == jax_line["valid"]
