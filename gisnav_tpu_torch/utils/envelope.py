"""The JAX package's accuracy battery, its worlds and query transforms in
numpy (no cv2), for ``tools/sweep_headline_torch.py`` and the smoke run.

The JAX repository gates its accuracy on synthetic worlds rendered through
OpenCV in its tests and tools; these are the same worlds, drawn from the
same ``np.random.default_rng`` draws in the same order, through
``utils/drawing.py`` and ``utils/world.py`` (OpenCV 5.0's algorithms
without OpenCV):

- :func:`shape_world`: ``tests/test_integration.py``'s 4096-px world of
  rectangles, discs and thick lines (seed 7), bit for bit, with its
  georeference (``LEFT``, ``TOP``, ``GSD_LON``, ``GSD_LAT``,
  ``M_PER_WPX``) and :func:`lonlat_to_wpx`;
- :func:`nadir_frame`: the tests' nadir camera render (a camera at a world
  pixel, an altitude in world pixels and a yaw) through
  ``warp_perspective_u8``, ``cv2.warpPerspective``'s bytes;
- :class:`MatchedWorld`: ``tools/sweep_headline.py``'s world rastered at a
  chosen ground sample distance (the shapes scaled to it, a 1/f texture of
  ``octave_falloff`` per octave, the 3x3 blur);
- :func:`fractal_world` (``tests/test_world_fractal.py``, seed 19) and
  :func:`field_world` (``tests/test_world_fieldlines.py``, seed 11);
- :data:`APPEARANCE`: ``tests/test_world_appearance.py``'s five query
  transforms (seasonal tone, sun shadows, JPEG at quality 40 through
  ``gis/jpeg.py``, sensor noise, scene change), each drawing from the
  generator it is given;
- :func:`appearance_map`, :func:`appearance_frames`, :func:`fractal_scene`
  and :func:`field_scene`: each gate's map, georeference and frames as
  its JAX test builds them.

The bicubic resizes (``resize_cubic``) give OpenCV's IPP values to a few
ulp, so after the fractal and field worlds' percentile normalisation, and
the matched world's sum, clip and uint8 cast, a small share of pixels lies
one grey level from cv2's (``tests/test_torch_envelope.py`` counts them).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Tuple

import numpy as np

from gisnav_tpu_torch.geometry.crs import pixel_to_wgs84_affine
from gisnav_tpu_torch.utils import drawing
from gisnav_tpu_torch.utils.world import (resize_area_u8, resize_cubic,
                                          synthetic_world, warp_perspective_u8)

__all__ = ["W_PX", "LEFT", "RIGHT", "BOTTOM", "TOP", "GSD_LON", "GSD_LAT",
           "M_PER_WPX", "K_CAM", "ALT_M", "YAW_DEG", "shape_world",
           "lonlat_to_wpx", "nadir_frame", "MatchedWorld",
           "fractal_world", "field_world", "seasonal_tone", "sun_shadows",
           "jpeg_q40", "sensor_noise", "temporal_change", "APPEARANCE",
           "APPEARANCE_YAWS", "appearance_map", "appearance_frames",
           "fractal_scene", "field_scene"]

# tests/test_integration.py's world and camera
W_PX = 4096
LEFT, RIGHT = 24.00, 24.10  # ~5565 m at lat 60
BOTTOM, TOP = 60.00, 60.05  # ~5529 m
GSD_LON = (RIGHT - LEFT) / W_PX  # deg per world px
GSD_LAT = (TOP - BOTTOM) / W_PX
M_PER_WPX = 5565.0 / W_PX  # ~1.36 m
K_CAM = np.array([[400.0, 0, 320.0], [0, 400.0, 240.0], [0, 0, 1.0]])
ALT_M = 500.0
YAW_DEG = 15.0

# tests/test_world_appearance.py's flight
APPEARANCE_YAWS = (30.0, 135.0)
_H, _W, _F = 480, 640, 400.0
_K_APP = np.array([[_F, 0, _W / 2], [0, _F, _H / 2], [0, 0, 1.0]],
                  np.float32)
_LAT0, _LON0 = 60.025, 24.04

# a frame of a gate: (yaw deg, true lon, true lat, (h, w) uint8 frame)
Frame = Tuple[float, float, float, np.ndarray]


@functools.lru_cache(maxsize=1)
def shape_world() -> np.ndarray:
    """``tests/test_integration.WORLD``: the 4096-px shape world of seed 7
    (read-only, rendered once a process)."""
    world = synthetic_world(W_PX, seed=7)
    world.flags.writeable = False
    return world


def lonlat_to_wpx(lon, lat):
    """The shape world's pixel of a lon/lat (``_lonlat_to_wpx``)."""
    return (lon - LEFT) / GSD_LON, (TOP - lat) / GSD_LAT


def nadir_frame(world: np.ndarray, cx: float, cy: float, alt_wpx: float,
                yaw_deg: float, k: np.ndarray,
                hw: Tuple[int, int]) -> np.ndarray:
    """The nadir camera's (h, w) view of ``world`` from world pixel (cx,
    cy) at ``alt_wpx`` world pixels up, turned by ``yaw_deg``: the world
    pixel frame (x east, y south, z down) to the camera by Rz(yaw), then
    ``k``; ``cv2.warpPerspective``'s bytes."""
    a = np.radians(yaw_deg)
    c, s = np.cos(a), np.sin(a)
    r = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1.0]])  # worldpx -> camera
    t = -r @ np.array([cx, cy, -alt_wpx])
    hm = k @ np.stack([r[:, 0], r[:, 1], t], axis=1)
    return warp_perspective_u8(world, hm, hw)


class MatchedWorld:
    """``tools/sweep_headline.py``'s ``_MatchedWorld``: the shape world's
    metric statistics (4000 shapes over (5565 m)^2, sizes scaled from the
    legacy 1.3586 m/px to ``gsd_m``) under a 1/f micro-texture of
    ``octave_falloff`` amplitude per octave, blurred 3x3, centred on (lon0,
    lat0). The texture's float32 accumulator is summed in place (a 6816-px
    world holds one of 186 MB)."""

    def __init__(self, side_m: float, gsd_m: float, lon0: float,
                 lat0: float, seed: int = 7, octave_falloff: float = 0.85):
        w_px = int(np.ceil(side_m / gsd_m / 8)) * 8
        self.w_px = w_px
        self.gsd_m = gsd_m
        rng = np.random.default_rng(seed)
        world = np.full((w_px, w_px), 110, np.uint8)
        n = int(round(4000 * (side_m / 5565.0) ** 2))
        px_per_legacy = 1.358642578125 / gsd_m  # legacy world GSD -> ours
        for _ in range(n):
            x, y = (int(v) for v in rng.integers(0, w_px, 2))
            kind = int(rng.integers(0, 3))
            v = int(rng.integers(0, 256))
            s = int(rng.integers(8, 80) * px_per_legacy)
            if kind == 0:
                drawing.rectangle(
                    world, (x, y),
                    (x + s, y + int(s * rng.uniform(0.3, 1.5))), v, -1)
            elif kind == 1:
                drawing.circle(world, (x, y), s // 2, v, -1)
            else:
                x2 = x + int(s * rng.uniform(-2, 2))
                y2 = y + int(s * rng.uniform(-2, 2))
                drawing.line(world, (x, y), (x2, y2), v,
                             max(2, int(rng.integers(2, 8) * px_per_legacy)))
        octaves = max(2, int(np.ceil(np.log2(w_px / 4))))
        acc = np.zeros((w_px, w_px), np.float32)
        amp = 1.0
        for o in range(octaves):
            n = max(2, min(w_px, 4 << o))
            up = resize_cubic(rng.standard_normal((n, n)).astype(np.float32),
                              w_px)
            up *= amp  # amp * up in float32, as the tool's sum rounds it
            acc += up
            del up
            amp *= octave_falloff
        acc *= 20.0 / max(float(acc.std()), 1e-6)
        acc += world  # world + acc in float32
        np.clip(acc, 0, 255, out=acc)
        world = acc.astype(np.uint8)
        del acc
        self.world = drawing.gaussian_blur(world, (3, 3), 0.8)
        # georeference: centered on (lon0, lat0)
        m_per_deg_lat = 111320.0
        m_per_deg_lon = m_per_deg_lat * np.cos(np.radians(lat0))
        self.gsd_lon = gsd_m / m_per_deg_lon
        self.gsd_lat = gsd_m / m_per_deg_lat
        self.left = lon0 - w_px / 2 * self.gsd_lon
        self.top = lat0 + w_px / 2 * self.gsd_lat

    def lonlat_to_wpx(self, lon, lat):
        return ((lon - self.left) / self.gsd_lon,
                (self.top - lat) / self.gsd_lat)


def _percentile_unit(acc: np.ndarray) -> np.ndarray:
    """The 1st-99th percentile span of ``acc`` to [0, 1], clipped."""
    lo, hi = np.percentile(acc, [1, 99])
    return np.clip((acc - lo) / (hi - lo), 0, 1)


def fractal_world(seed: int = 19, octaves: int = 7) -> np.ndarray:
    """``tests/test_world_fractal.py``'s 1/f multi-octave value noise,
    4096-px uint8: no shapes, pure spectral texture."""
    rng = np.random.default_rng(seed)
    acc = np.zeros((W_PX, W_PX), np.float32)
    amp = 1.0
    for o in range(octaves):
        n = max(2, W_PX >> (octaves - 1 - o))
        grid = rng.standard_normal((n, n)).astype(np.float32)
        acc += amp * resize_cubic(grid, W_PX)
        amp *= 0.55  # ~1/f amplitude falloff across octaves
    return (_percentile_unit(acc) * 255).astype(np.uint8)


def field_world(seed: int = 11) -> np.ndarray:
    """``tests/test_world_fieldlines.py``'s agricultural world, 4096-px
    uint8: coarse smooth noise, 250 long low-contrast boundary lines (no
    corners), a 5x5 blur and sensor grain."""
    rng = np.random.default_rng(seed)
    acc = np.zeros((W_PX, W_PX), np.float32)
    amp = 1.0
    for n in (4, 8, 16, 32):
        acc += amp * resize_cubic(
            rng.standard_normal((n, n)).astype(np.float32), W_PX)
        amp *= 0.7
    world = (_percentile_unit(acc) * 200 + 25).astype(np.uint8)
    del acc
    for _ in range(250):
        x0, y0 = (int(v) for v in rng.integers(0, W_PX, 2))
        ang = rng.uniform(0, np.pi)
        length = int(rng.integers(400, 2000))
        x1 = int(x0 + length * np.cos(ang))
        y1 = int(y0 + length * np.sin(ang))
        v = int(np.clip(world[min(y0, W_PX - 1), min(x0, W_PX - 1)]
                        * rng.uniform(0.85, 1.15), 0, 255))
        drawing.line(world, (x0, y0), (x1, y1), v, int(rng.integers(3, 14)))
    world = drawing.gaussian_blur(world, (5, 5), 1.2)
    world = np.clip(world.astype(np.float32)
                    + rng.normal(0, 2.5, world.shape), 0, 255)
    return world.astype(np.uint8)


def seasonal_tone(img: np.ndarray, rng) -> np.ndarray:
    """Seasonal / radiometric shift: gamma 1.35, contrast 0.8, haze +0.12."""
    x = img.astype(np.float32) / 255.0
    x = np.power(x, 1.35)
    x = 0.8 * x + 0.12
    return np.clip(x * 255.0, 0, 255).astype(np.uint8)


def sun_shadows(img: np.ndarray, rng) -> np.ndarray:
    """Sun-angle appearance: 25 sun-offset cast-shadow quads (blurred,
    darkening by 0.4) and a smooth multiplicative shading field from two
    bicubic noise octaves."""
    h, w = img.shape
    cast = np.zeros((h, w), np.float32)
    for _ in range(25):
        x, y = int(rng.integers(0, w - 70)), int(rng.integers(0, h - 70))
        sx = int(rng.integers(14, 50))
        sy = int(rng.integers(14, 50))
        drawing.rectangle(cast, (x + 8, y - 8 if y >= 8 else 0),
                          (x + 8 + sx, y - 8 + sy), 1.0, -1)
    cast = drawing.gaussian_blur(cast, (0, 0), 1.5)
    shade = np.ones((h, w), np.float32)
    for n, amp in ((6, 0.08), (24, 0.06)):
        field = rng.standard_normal((n, n)).astype(np.float32)
        shade += amp * resize_cubic(field, (h, w))
    out = img.astype(np.float32) * np.clip(shade, 0.8, 1.15)
    out *= (1.0 - 0.4 * np.clip(cast, 0, 1))
    return np.clip(out, 0, 255).astype(np.uint8)


def jpeg_q40(img: np.ndarray, rng, quality: int = 40) -> np.ndarray:
    """JPEG at quality 40 and back (cv2's encoder and grey decode, through
    ``gis/jpeg.py``)."""
    from gisnav_tpu_torch.gis.jpeg import decode_jpeg, encode_jpeg

    return decode_jpeg(encode_jpeg(img, quality), grayscale=True)


def sensor_noise(img: np.ndarray, rng) -> np.ndarray:
    """Readout noise (sigma 6 grey levels) over a mild optical blur."""
    x = drawing.gaussian_blur(img, (0, 0), 0.7).astype(np.float32)
    x += rng.normal(0.0, 6.0, img.shape).astype(np.float32)
    return np.clip(x, 0, 255).astype(np.uint8)


def temporal_change(img: np.ndarray, rng) -> np.ndarray:
    """Scene change since the map: six squares repainted (~5 % of it)."""
    out = img.copy()
    h, w = out.shape
    for _ in range(6):
        x, y = int(rng.integers(0, w - 60)), int(rng.integers(0, h - 60))
        s = int(rng.integers(20, 60))
        v = int(rng.integers(0, 256))
        drawing.rectangle(out, (x, y), (x + s, y + s), v, -1)
    return out


APPEARANCE: Dict[str, Callable] = {
    "seasonal_tone": seasonal_tone,
    "sun_shadows": sun_shadows,
    "jpeg_q40": jpeg_q40,
    "sensor_noise": sensor_noise,
    "temporal_change": temporal_change,
}


def _affine(map_px: int, left: float, top: float, side_wpx: float,
            gsd_lon: float, gsd_lat: float) -> np.ndarray:
    return pixel_to_wgs84_affine(
        map_px, map_px, left, top - side_wpx * gsd_lat,
        left + side_wpx * gsd_lon, top)


def appearance_map(world: np.ndarray = None, map_px: int = 800):
    """``test_world_appearance.py``'s map: the shape world's 3x-footprint
    crop about (24.04, 60.025) at 800 px, INTER_AREA, its affine and a zero
    DEM."""
    world = shape_world() if world is None else world
    side_wpx = int(round(3.0 * ALT_M * max(_H, _W) / _F / M_PER_WPX))
    cx, cy = lonlat_to_wpx(_LON0, _LAT0)
    x0, y0 = int(cx - side_wpx / 2), int(cy - side_wpx / 2)
    crop = world[y0:y0 + side_wpx, x0:x0 + side_wpx]
    ortho = resize_area_u8(crop, map_px, map_px)
    aff = _affine(map_px, LEFT + x0 * GSD_LON, TOP - y0 * GSD_LAT, side_wpx,
                  GSD_LON, GSD_LAT)
    return ortho, np.zeros((map_px, map_px), np.float32), aff


def appearance_frames(transform: Callable, rng, world: np.ndarray = None,
                      yaws=APPEARANCE_YAWS) -> List[Frame]:
    """``test_world_appearance.py``'s ``_fly`` renders: a 480x640 frame a
    yaw, 40 m / 20 m off the map centre along the yaw, passed through
    ``transform(frame, rng)`` in yaw order (one generator for the
    scenario, as the test's ``rng`` fixture gives it)."""
    world = shape_world() if world is None else world
    out = []
    for yaw in yaws:
        lon = _LON0 + 0.0004 * np.cos(np.radians(yaw))
        lat = _LAT0 + 0.0002 * np.sin(np.radians(yaw))
        cxq, cyq = lonlat_to_wpx(lon, lat)
        frame = nadir_frame(world, cxq, cyq, ALT_M / M_PER_WPX, yaw, _K_APP,
                            (_H, _W))
        out.append((yaw, lon, lat, transform(frame, rng)))
    return out


def fractal_scene(world: np.ndarray):
    """``test_world_fractal.py``'s gate: a 1024-px map of a 2.8 km square
    about (24.03, 60.02), INTER_AREA, and two 480x640 frames from its
    centre at 500 m (yaws 15 and 135); (ortho, dem, affine, frames)."""
    lat0, lon0 = 60.02, 24.03
    half_lon = 1400.0 / (111320 * np.cos(np.radians(60)))
    half_lat = 1400.0 / 110574
    bb = (lon0 - half_lon, lat0 - half_lat, lon0 + half_lon,
          lat0 + half_lat)
    x0, y0 = lonlat_to_wpx(bb[0], bb[3])
    x1, y1 = lonlat_to_wpx(bb[2], bb[1])
    crop = world[int(y0):int(y1), int(x0):int(x1)]
    ortho = resize_area_u8(crop, 1024, 1024)
    aff = np.asarray(pixel_to_wgs84_affine(1024, 1024, *bb))
    frames = []
    for yaw in (YAW_DEG, 135.0):
        cx, cy = lonlat_to_wpx(lon0, lat0)
        frames.append((yaw, lon0, lat0, nadir_frame(
            world, cx, cy, ALT_M / M_PER_WPX, yaw, K_CAM, (480, 640))))
    return ortho, np.zeros((1024, 1024), np.float32), aff, frames


def field_scene(world: np.ndarray):
    """``test_world_fieldlines.py``'s gate: the world centred on (24.0,
    60.0), an 800-px map of its 3x-footprint crop (INTER_AREA), and two
    480x640 frames 40 m east and 20 m north of the centre at 500 m (yaws
    15 and 135); (ortho, dem, affine, k, frames)."""
    h, w, f = 480, 640, 400.0
    k_cam = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]],
                     np.float32)
    lat0, lon0 = 60.0, 24.0
    m_per_deg_lat = 111320.0
    m_per_deg_lon = m_per_deg_lat * np.cos(np.radians(lat0))
    alt, map_px = 500.0, 800
    side_wpx = int(round(3.0 * alt * max(h, w) / f / M_PER_WPX))
    cx = cy = W_PX // 2
    x0, y0 = cx - side_wpx // 2, cy - side_wpx // 2
    ortho = resize_area_u8(world[y0:y0 + side_wpx, x0:x0 + side_wpx],
                           map_px, map_px)
    gsd_lon = M_PER_WPX / m_per_deg_lon
    gsd_lat = M_PER_WPX / m_per_deg_lat
    left = lon0 - (cx - x0) * gsd_lon
    top = lat0 + (cy - y0) * gsd_lat
    aff = _affine(map_px, left, top, side_wpx, gsd_lon, gsd_lat)
    frames = []
    for yaw in (15.0, 135.0):
        lon = lon0 + 40.0 / m_per_deg_lon
        lat = lat0 + 20.0 / m_per_deg_lat
        cxq = cx + (lon - lon0) / gsd_lon
        cyq = cy - (lat - lat0) / gsd_lat
        frames.append((yaw, lon, lat, nadir_frame(
            world, cxq, cyq, alt / M_PER_WPX, yaw, k_cam, (h, w))))
    return ortho, np.zeros((map_px, map_px), np.float32), aff, k_cam, frames
