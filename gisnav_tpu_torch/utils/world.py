"""Seeded synthetic scene for the port's smoke run and tests (numpy).

A flat world of rectangles, discs and thick lines over multi-octave noise
(the content model of the JAX package's bench fixture and synthetic world),
an orthoimage cropped from it at the production map sizing (3x the camera
footprint), and nadir camera frames rendered at given positions and yaws.
Every frame carries its ground-truth lon/lat, so a run can check its fixes.
``render_flight`` renders consecutive frames of a straight, level flight
with each camera's pose, for visual odometry; ``render_streams`` one frame
a camera feed at distinct places of one world, each over a map of its own.
``resize_cubic`` and ``warp_perspective_u8`` are the two OpenCV calls of
the JAX package's bench fixture (``bench.py``), for ``gisnav_tpu_torch.bench``.
``cubic_taps`` is the one bicubic weight routine of the port (also
``train.data.cubic_resize_weights``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from gisnav_tpu_torch.geometry.crs import pixel_to_wgs84_affine
from gisnav_tpu_torch.gis.geotiff import GeoRef
from gisnav_tpu_torch.utils import drawing

__all__ = ["Scene", "render_scene", "render_streams", "Flight",
           "render_flight", "synthetic_world", "synthetic_dem",
           "DEMO_GEOREF", "cubic_taps", "resize_cubic",
           "warp_perspective_u8"]

_LEFT, _TOP = -122.27, 37.53  # demo georeference (KSQL, San Carlos, CA)


@dataclasses.dataclass
class Scene:
    frames: List[np.ndarray]  # (h, w) uint8 nadir frames
    yaws: List[float]  # camera yaw = map-alignment rotation, degrees
    truth_lonlat: List[Tuple[float, float]]
    ortho: np.ndarray  # (n, n) uint8
    dem: np.ndarray  # (n, n) f32 metres (flat world)
    k: np.ndarray  # (3, 3) intrinsics
    crs_affine: np.ndarray  # (4, 4) f64 ortho pixel -> lon/lat/metres
    alt_m: float


def _resize_bilinear(a: np.ndarray, size: int) -> np.ndarray:
    """Separable bilinear resize of a square array to (size, size)."""
    n = a.shape[0]
    pos = (np.arange(size, dtype=np.float32) + 0.5) * (n / size) - 0.5
    pos = np.clip(pos, 0, n - 1)
    i0 = np.floor(pos).astype(np.int64)
    i1 = np.minimum(i0 + 1, n - 1)
    f = (pos - i0).astype(np.float32)
    rows = a[i0] * (1 - f)[:, None] + a[i1] * f[:, None]
    return rows[:, i0] * (1 - f)[None, :] + rows[:, i1] * f[None, :]


def _draw_world(rng, size: int, gsd: float) -> np.ndarray:
    world = np.full((size, size), 110.0, np.float32)
    n_shapes = int(4000 * (size * gsd / 5565.0) ** 2)
    for _ in range(n_shapes):
        x, y = (int(v) for v in rng.integers(0, size, 2))
        kind = int(rng.integers(0, 3))
        v = float(rng.integers(0, 256))
        s = max(int(rng.integers(8, 80) * 1.36 / gsd), 1)
        if kind == 0:
            h = int(s * rng.uniform(0.3, 1.5))
            world[y:y + h + 1, x:x + s + 1] = v
        elif kind == 1:
            r = max(s // 2, 1)
            y0, y1 = max(y - r, 0), min(y + r + 1, size)
            x0, x1 = max(x - r, 0), min(x + r + 1, size)
            yy, xx = np.mgrid[y0:y1, x0:x1]
            disc = (yy - y) ** 2 + (xx - x) ** 2 <= r * r
            world[y0:y1, x0:x1][disc] = v
        else:
            x2 = x + int(s * rng.uniform(-2, 2))
            y2 = y + int(s * rng.uniform(-2, 2))
            half = max(2, int(3 * 1.36 / gsd)) / 2.0
            lo_x, hi_x = max(min(x, x2) - 4, 0), min(max(x, x2) + 5, size)
            lo_y, hi_y = max(min(y, y2) - 4, 0), min(max(y, y2) + 5, size)
            if lo_x >= hi_x or lo_y >= hi_y:
                continue
            yy, xx = np.mgrid[lo_y:hi_y, lo_x:hi_x].astype(np.float32)
            dx, dy = float(x2 - x), float(y2 - y)
            den = max(dx * dx + dy * dy, 1e-6)
            t = np.clip(((xx - x) * dx + (yy - y) * dy) / den, 0.0, 1.0)
            d2 = (xx - x - t * dx) ** 2 + (yy - y - t * dy) ** 2
            world[lo_y:hi_y, lo_x:hi_x][d2 <= half * half] = v
    acc = np.zeros((size, size), np.float32)
    amp = 1.0
    for o in range(int(np.ceil(np.log2(size / 4)))):
        n = max(2, min(size, 4 << o))
        acc += amp * _resize_bilinear(
            rng.standard_normal((n, n)).astype(np.float32), size)
        amp *= 0.85
    acc *= 20.0 / max(float(acc.std()), 1e-6)
    return np.clip(world + acc, 0, 255)


def _sample(src: np.ndarray, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """``src`` at pixel-centre coordinates (xs, ys), bilinear, zero beyond
    its edge pixels' centres."""
    x0 = np.floor(xs).astype(np.int64)
    y0 = np.floor(ys).astype(np.int64)
    fx, fy = xs - x0, ys - y0
    sh, sw = src.shape

    def tap(yi, xi):
        ok = (xi >= 0) & (xi < sw) & (yi >= 0) & (yi < sh)
        return np.where(ok, src[np.clip(yi, 0, sh - 1),
                                np.clip(xi, 0, sw - 1)], 0.0)

    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bot = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bot * fy


def _warp_perspective(src: np.ndarray, hm: np.ndarray,
                     out_hw: Tuple[int, int]) -> np.ndarray:
    """``out[v, u] = src(hm^-1 (u, v, 1))``, bilinear, zero outside, at
    float64 positions: the scenes' own warp, not cv2's bytes
    (``warp_perspective_u8``), kept because the committed flight fixtures
    and their digests were rendered through it."""
    h, w = out_hw
    inv = np.linalg.inv(hm)
    vv, uu = np.mgrid[0:h, 0:w].astype(np.float64)
    p = inv @ np.stack([uu.ravel(), vv.ravel(), np.ones(h * w)])
    out = _sample(src, (p[0] / p[2]).astype(np.float32),
                  (p[1] / p[2]).astype(np.float32))
    return np.clip(np.rint(out), 0, 255).astype(np.uint8).reshape(h, w)


def _fma32(a, b, c) -> np.ndarray:
    """``fma(a, b, c)`` of float32 operands rounded once to float32: the
    product of two float32 is exact in float64, so only a sum that float64
    rounds onto a float32 tie can differ from a fused multiply-add."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def cubic_taps(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """(n_out, 4) source indices (edges clamped) and float32 weights of a
    bicubic resize along one axis: Keys' kernel with a = -0.75 at
    ``(d + 0.5) * n_in / n_out - 0.5``, the weights evaluated in float64
    and rounded once, as ``cv2.resize(..., INTER_CUBIC)`` takes them."""
    a = -0.75
    fx = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    sx = np.floor(fx)
    x = fx - sx
    c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
    c3 = 1 - c0 - c1 - c2
    idx = np.clip(sx.astype(np.int64)[:, None] + np.arange(-1, 3), 0,
                  n_in - 1)
    return idx, np.stack([c0, c1, c2, c3], axis=1).astype(np.float32)


def resize_cubic(a: np.ndarray, size: int) -> np.ndarray:
    """``cv2.resize(a, (size, size), interpolation=INTER_CUBIC)`` of a
    square float32 array: along each row first, then along each column,
    each output the sum of its four float32 products taken in pairs (on
    torch's CPU threads: each product and sum rounded on its own, as numpy
    rounds them). OpenCV 5.0 hands this resize to Intel IPP, whose order of
    rounding is its own: this gives its values to within a few ulp (1.2e-6
    on unit noise), about half of them exactly."""
    import torch

    a = np.asarray(a, np.float32)
    if a.shape == (size, size):
        return a.copy()
    t = torch.from_numpy(np.ascontiguousarray(a))

    def taps(x, dim, n_in):
        idx, c = (torch.from_numpy(v) for v in cubic_taps(n_in, size))
        c = c if dim == 1 else c[:, None, :]
        terms = [x.index_select(dim, idx[:, j]) * (c[..., j]) for j in
                 range(4)]
        return (terms[0] + terms[1]) + (terms[2] + terms[3])

    rows = taps(t, 1, a.shape[1])
    return taps(rows, 0, a.shape[0]).numpy()


def _invert3(m: np.ndarray) -> np.ndarray:
    """``cv::invert`` of a 3x3 float64 matrix (its closed form: cofactors
    times the reciprocal of the determinant), flattened row-major."""
    s = np.asarray(m, np.float64)
    d = (s[0, 0] * (s[1, 1] * s[2, 2] - s[2, 1] * s[1, 2])
         - s[0, 1] * (s[1, 0] * s[2, 2] - s[2, 0] * s[1, 2])
         + s[0, 2] * (s[1, 0] * s[2, 1] - s[2, 0] * s[1, 1]))
    d = 1.0 / d
    return np.array([
        (s[1, 1] * s[2, 2] - s[1, 2] * s[2, 1]) * d,
        (s[0, 2] * s[2, 1] - s[0, 1] * s[2, 2]) * d,
        (s[0, 1] * s[1, 2] - s[0, 2] * s[1, 1]) * d,
        (s[1, 2] * s[2, 0] - s[1, 0] * s[2, 2]) * d,
        (s[0, 0] * s[2, 2] - s[0, 2] * s[2, 0]) * d,
        (s[0, 2] * s[1, 0] - s[0, 0] * s[1, 2]) * d,
        (s[1, 0] * s[2, 1] - s[1, 1] * s[2, 0]) * d,
        (s[0, 1] * s[2, 0] - s[0, 0] * s[2, 1]) * d,
        (s[0, 0] * s[1, 1] - s[0, 1] * s[1, 0]) * d])


def warp_perspective_u8(src: np.ndarray, hm: np.ndarray,
                        out_hw: Tuple[int, int]) -> np.ndarray:
    """``cv2.warpPerspective(src, hm, (w, h))`` of a uint8 image (bilinear,
    a zero border) as OpenCV 5.0's kernel computes it, byte for byte:

    - the inverse map in float64 (``cv::invert``), then rounded to float32;
    - in the SIMD part of a row (whole vectors of 16 floats) the row's
      ``m1 * y + m2`` in float32, unfused, then ``m0 * x + (...)`` as one
      fused multiply-add; in its scalar tail ``fma(m0, x, m1 * y) + m2``;
    - the source position ``X / W`` by a float32 division, its floor the
      top-left tap, the rest the weights;
    - two fused lerps along x, one along y, in float32, rounded half to
      even.
    """
    h, w = out_hw
    m = _invert3(hm).astype(np.float32)
    sh, sw = src.shape
    ys = np.arange(h, dtype=np.float32)[:, None]
    xs = np.arange(w, dtype=np.float32)[None, :]
    lanes = 16  # OpenCV's AVX-512 dispatch; only this width was held to cv2
    tail = np.arange(w)[None, :] >= w // lanes * lanes

    def coord(i):
        simd = _fma32(m[i], xs, m[i + 1] * ys + m[i + 2])
        scalar = _fma32(m[i], xs, m[i + 1] * ys) + m[i + 2]
        return np.where(tail, scalar, simd)

    wq = coord(6)
    sx, sy = coord(0) / wq, coord(3) / wq
    x0, y0 = np.floor(sx), np.floor(sy)
    fx, fy = sx - x0, sy - y0
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)

    def tap(yi, xi):
        ok = (xi >= 0) & (xi < sw) & (yi >= 0) & (yi < sh)
        return np.where(ok, src[np.clip(yi, 0, sh - 1),
                                np.clip(xi, 0, sw - 1)],
                        0).astype(np.float32)

    p00, p01 = tap(y0, x0), tap(y0, x0 + 1)
    p10, p11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    top = _fma32(fx, p01 - p00, p00)
    bot = _fma32(fx, p11 - p10, p10)
    out = _fma32(fy, bot - top, top)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def render_scene(seed: int, h: int, w: int, yaws: Sequence[float],
                 alt_m: float = 500.0, focal_px: float | None = None,
                 offset_m: float = 30.0, map_side: int | None = None,
                 coverage: float = 3.0) -> Scene:
    """Render a scene for an (h, w) camera at ``alt_m`` over a square map of
    ``map_side`` px (default: the warp mode's size, the camera diagonal
    rounded up to 8 px) covering ``coverage`` times the camera footprint.
    Frame i looks down from ``offset_m`` east/north of the map centre along
    yaw i."""
    rng = np.random.default_rng(seed)
    focal = float(focal_px or 400.0 * w / 640.0)
    ortho_hw = map_side or int(np.ceil(float(np.hypot(h, w)) / 8)) * 8
    side_m = coverage * alt_m * max(h, w) / focal
    gsd = side_m / ortho_hw
    size = ortho_hw * 2
    world = _draw_world(rng, size, gsd)
    x0 = (size - ortho_hw) // 2
    ortho = world[x0:x0 + ortho_hw, x0:x0 + ortho_hw]

    m_lat = 111_132.0
    m_lon = 111_320.0 * np.cos(np.radians(_TOP))
    right = _LEFT + (ortho_hw - 1) * gsd / m_lon
    bottom = _TOP - (ortho_hw - 1) * gsd / m_lat
    aff = pixel_to_wgs84_affine(ortho_hw, ortho_hw, _LEFT, bottom, right,
                                _TOP)
    k = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1.0]])
    frames, truths = [], []
    for yaw in yaws:
        a = np.radians(yaw)
        cx = size / 2 + offset_m / gsd * np.cos(a)
        cy = size / 2 + offset_m / gsd * np.sin(a)
        c, s = np.cos(a), np.sin(a)
        r = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1.0]])
        t = -r @ np.array([cx, cy, -alt_m / gsd])
        hm = k @ np.stack([r[:, 0], r[:, 1], t], axis=1)
        frames.append(_warp_perspective(world, hm, (h, w)))
        lla = aff @ np.array([cx - x0, cy - x0, 0.0, 1.0])
        truths.append((float(lla[0]), float(lla[1])))
    return Scene(frames=frames, yaws=[float(y) for y in yaws],
                 truth_lonlat=truths,
                 ortho=np.clip(np.rint(ortho), 0, 255).astype(np.uint8),
                 dem=np.zeros((ortho_hw, ortho_hw), np.float32), k=k,
                 crs_affine=aff, alt_m=alt_m)


def render_streams(seed: int, h: int, w: int, yaws: Sequence[float],
                   ring_m: float = 150.0, offset_m: float = 50.0,
                   alt_m: float = 500.0, map_side: int | None = None,
                   coverage: float = 3.0) -> List[Scene]:
    """One scene a camera feed over one world: camera i looks down with yaw
    i from the point of a ring of ``ring_m`` at ``i * 360 / n`` degrees, so
    neighbours are ``2 ring_m sin(180 / n)`` apart, over a map of its own
    (``map_side`` px covering ``coverage`` times the footprint, as in
    :func:`render_scene`) whose centre lies ``offset_m`` from the camera
    toward the ring's centre. Each map carries its own georeference, and
    the cameras sit at other places of their maps, so a fix read through
    another stream's map lands ``offset_m``-scale metres off."""
    rng = np.random.default_rng(seed)
    n = len(yaws)
    focal = 400.0 * w / 640.0
    ortho_hw = map_side or int(np.ceil(float(np.hypot(h, w)) / 8)) * 8
    gsd = coverage * alt_m * max(h, w) / focal / ortho_hw
    half = ortho_hw // 2 + int(np.ceil((ring_m + offset_m) / gsd)) + 8
    size = 2 * half
    world = _draw_world(rng, size, gsd)
    m_lat = 111_132.0
    m_lon = 111_320.0 * np.cos(np.radians(_TOP))
    k = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1.0]])
    scenes = []
    for i, yaw in enumerate(yaws):
        a = 2.0 * np.pi * i / n
        cx = half + ring_m / gsd * np.cos(a)
        cy = half + ring_m / gsd * np.sin(a)
        x0 = int(round(cx - offset_m / gsd * np.cos(a))) - ortho_hw // 2
        y0 = int(round(cy - offset_m / gsd * np.sin(a))) - ortho_hw // 2
        left = _LEFT + x0 * gsd / m_lon
        top = _TOP - y0 * gsd / m_lat
        aff = pixel_to_wgs84_affine(
            ortho_hw, ortho_hw, left, top - (ortho_hw - 1) * gsd / m_lat,
            left + (ortho_hw - 1) * gsd / m_lon, top)
        ya = np.radians(yaw)
        c, s = np.cos(ya), np.sin(ya)
        r = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1.0]])
        t = -r @ np.array([cx, cy, -alt_m / gsd])
        hm = k @ np.stack([r[:, 0], r[:, 1], t], axis=1)
        lla = aff @ np.array([cx - x0, cy - y0, 0.0, 1.0])
        ortho = world[y0:y0 + ortho_hw, x0:x0 + ortho_hw]
        scenes.append(Scene(
            frames=[_warp_perspective(world, hm, (h, w))],
            yaws=[float(yaw)], truth_lonlat=[(float(lla[0]), float(lla[1]))],
            ortho=np.clip(np.rint(ortho), 0, 255).astype(np.uint8),
            dem=np.zeros((ortho_hw, ortho_hw), np.float32), k=k,
            crs_affine=aff, alt_m=alt_m))
    return scenes


@dataclasses.dataclass
class Flight:
    frames: List[np.ndarray]  # (h, w) uint8 nadir frames, in flight order
    yaws: List[float]  # camera yaw, degrees
    # world <- camera 4x4 transforms in metres: the world frame is the
    # rendered raster's (x right, y down) with z toward the ground, the
    # camera frame x right, y down, z along the optical axis
    poses: List[np.ndarray]
    k: np.ndarray  # (3, 3) intrinsics
    alt_m: float


def render_flight(seed: int, h: int, w: int, steps: int,
                  step_m: float = 20.0, alt_m: float = 300.0,
                  yaw_drift_deg: float = 4.0) -> Flight:
    """``steps`` nadir frames of a straight, level flight along the world's
    x axis, ``step_m`` apart at ``alt_m`` above flat ground (f = 400 px at
    640 px wide, as ``render_scene``), the camera yaw going linearly from 0
    to ``yaw_drift_deg``. The world is drawn at the frames' ground sample
    distance."""
    rng = np.random.default_rng(seed)
    focal = 400.0 * w / 640.0
    gsd = alt_m / focal
    track_m = step_m * (steps - 1)
    margin_m = float(np.hypot(h, w)) * gsd
    size = int(np.ceil((track_m + 2 * margin_m) / gsd / 8)) * 8
    world = _draw_world(rng, size, gsd)
    k = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1.0]])
    frames, yaws, poses = [], [], []
    for i in range(steps):
        yaw = yaw_drift_deg * i / max(steps - 1, 1)
        a = np.radians(yaw)
        c, s = np.cos(a), np.sin(a)
        r = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1.0]])  # world -> camera
        centre = np.array([size / 2 + (i * step_m - track_m / 2) / gsd,
                           size / 2, -alt_m / gsd])
        hm = k @ np.stack([r[:, 0], r[:, 1], -r @ centre], axis=1)
        frames.append(_warp_perspective(world, hm, (h, w)))
        pose = np.eye(4)
        pose[:3, :3] = r.T
        pose[:3, 3] = centre * gsd
        poses.append(pose)
        yaws.append(float(yaw))
    return Flight(frames=frames, yaws=yaws, poses=poses, k=k, alt_m=alt_m)


def synthetic_world(size_px: int = 4096, seed: int = 7,
                    n_shapes: int = 4000) -> np.ndarray:
    """The demo world: an urban-like grey texture, (size, size) uint8, bit
    for bit the JAX package's ``utils/world.py`` ``synthetic_world`` (the
    same draws of ``np.random.default_rng(seed)`` in the same order, drawn
    and blurred by ``utils/drawing.py``, OpenCV's algorithms without
    OpenCV)."""
    rng = np.random.default_rng(seed)
    world = np.full((size_px, size_px), 110, np.uint8)
    for _ in range(n_shapes):
        x, y = (int(v) for v in rng.integers(0, size_px, 2))
        kind = int(rng.integers(0, 3))
        v = int(rng.integers(0, 256))
        s = int(rng.integers(8, 80))
        if kind == 0:
            drawing.rectangle(world, (x, y),
                              (x + s, y + int(s * rng.uniform(0.3, 1.5))),
                              v, -1)
        elif kind == 1:
            drawing.circle(world, (x, y), s // 2, v, -1)
        else:
            x2 = x + int(s * rng.uniform(-2, 2))
            y2 = y + int(s * rng.uniform(-2, 2))
            drawing.line(world, (x, y), (x2, y2), v, int(rng.integers(2, 8)))
    return drawing.gaussian_blur_3x3(world, 0.8)


def synthetic_dem(size_px: int = 1024, seed: int = 11,
                  base_m: float = 0.0, relief_m: float = 12.0) -> np.ndarray:
    """The demo DEM: gentle hills in metres, (size, size) float32, the sum
    of four random 2-D cosines scaled to ``relief_m`` above ``base_m``
    (the JAX package's ``synthetic_dem``, bit for bit)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size_px, 0:size_px].astype(np.float32) / size_px
    dem = np.zeros((size_px, size_px), np.float32)
    for _ in range(4):
        fx, fy = rng.uniform(0.5, 2.0, 2)
        px, py = rng.uniform(0, 2 * np.pi, 2)
        dem += np.cos(2 * np.pi * fx * x + px) * np.cos(
            2 * np.pi * fy * y + py)
    dem -= dem.min()
    if dem.max() > 0:
        dem *= relief_m / dem.max()
    return (dem + base_m).astype(np.float32)


class _DemoGeoref:
    """Georeference of the demo world: a square of 0.04 degrees (about 4.4
    km north-south, 3.5 km east-west) whose top-left corner is near KSQL
    airport (San Carlos, CA), at any raster size."""

    left = _LEFT
    top = _TOP
    size_deg = 0.04

    def georef(self, size_px: int) -> GeoRef:
        return GeoRef(left=self.left, top=self.top,
                      gsd_lon=self.size_deg / size_px,
                      gsd_lat=self.size_deg / size_px)


DEMO_GEOREF = _DemoGeoref()
