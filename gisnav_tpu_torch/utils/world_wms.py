"""A seeded georeferenced world, its camera frames, and a loopback stub WMS.

For the node-graph flights of ``chip_smoke.py`` and the CPU tests (numpy,
``http.server``, ``zlib`` and the port's JPEG codec; no OpenCV, no network:
the server binds 127.0.0.1 only).

- :class:`World`: a square raster drawn as ``utils.world`` draws its scenes
  (shapes over multi-octave noise), north up, ``gsd_m`` metres a pixel, its
  top-left corner at (``left``, ``top``) degrees. Degrees and metres are
  related on the 6371 km sphere, as the orthoimage affine's haversine
  z-scale relates them, so a DEM-lifted fix carries no scale bias.
- :meth:`World.render_frame`: the nadir camera view at a lon/lat, altitude
  and yaw, and :func:`camera_attitude_quat`: that camera's camera_optical
  -> ENU quaternion (the gimbal attitude message).
- :class:`GeoWorld`: imagery and a DEM as GeoTIFFs carry them (a
  ``GeoRef`` each, pixels square in degrees and so not in metres), such as
  the demo maps of ``tools/make_demo_geotiff_torch.py``;
  :meth:`GeoWorld.render_frame` renders the nadir view over the DEM's
  relief with the east and north metres of a pixel each.
- :func:`write_replay_dataset`: a recorded flight over the world in the
  layout ``replay`` reads (``tools/make_replay_dataset.py``'s flight and
  sizing), its images PNG, JPEG or a GIS export's TIFF under the layout's
  names.
- :class:`WorldWMS`: a WMS answering GetCapabilities and GetMap. An imagery
  GetMap pastes the in-world part of the bbox at its true place in the
  requested raster, area-resampled, and pads with grey outside the world:
  stretching the crop to the raster would skew the raster <-> CRS affine
  and fabricate hundreds of metres of error where maps are large. A layer
  named ``dem`` is flat at ``dem_value`` metres. Replies are 8-bit grey, in
  the format asked: JPEG (``gis/jpeg.py`` at quality 95, the bytes
  ``cv2.imencode`` writes) for ``image/jpeg``, an uncompressed GeoTIFF
  (``gis/tiff.py``, as MapServer's GTiff output writes it) for
  ``image/tiff``, else PNG.
"""
from __future__ import annotations

import csv
import dataclasses
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from gisnav_tpu_torch.geometry.quaternion import matrix_to_quat
from gisnav_tpu_torch.gis.geotiff import GeoRef, read_geotiff, write_geotiff
from gisnav_tpu_torch.gis.jpeg import encode_jpeg
from gisnav_tpu_torch.gis.png import encode_png
from gisnav_tpu_torch.gis.pxm import encode_pgm
from gisnav_tpu_torch.gis.server import overlap_weights
from gisnav_tpu_torch.gis.tiff import encode_tiff
from gisnav_tpu_torch.utils.world import (
    _draw_world,
    _sample,
    _warp_perspective,
)

__all__ = ["World", "WorldWMS", "GeoWorld", "camera_attitude_quat",
           "east_of", "write_replay_dataset"]

_M_PER_DEG = 6371000.0 * np.pi / 180.0  # haversine's sphere
_GREY = 110  # the world's background level
_GRID_PX = 8  # GeoWorld's ray-casting grid, frame pixels


def east_of(lon: float, lat: float, east_m: float) -> float:
    """The longitude ``east_m`` metres east of ``lon`` at ``lat``."""
    return lon + east_m / (_M_PER_DEG * np.cos(np.radians(lat)))


@dataclasses.dataclass
class World:
    raster: np.ndarray  # (n, n) uint8, north up
    gsd_m: float
    left: float  # degrees
    top: float

    @classmethod
    def make(cls, seed: int = 7, size_px: int = 2048,
             gsd_m: float = 1.36) -> "World":
        """A world with its top-left corner at 24.0 E, 60.05 N (the JAX
        package's synthetic world's)."""
        raster = _draw_world(np.random.default_rng(seed), size_px, gsd_m)
        return cls(np.rint(raster).astype(np.uint8), gsd_m, 24.0, 60.05)

    @property
    def _deg_per_px(self) -> Tuple[float, float]:
        lat_mid = self.top - self.raster.shape[0] * self.gsd_m / 2 \
            / _M_PER_DEG
        return (self.gsd_m / (_M_PER_DEG * np.cos(np.radians(lat_mid))),
                self.gsd_m / _M_PER_DEG)

    def to_px(self, lon: float, lat: float) -> Tuple[float, float]:
        """(x east, y south) world pixels of a lon/lat."""
        dlon, dlat = self._deg_per_px
        return (lon - self.left) / dlon, (self.top - lat) / dlat

    def to_lonlat(self, x: float, y: float) -> Tuple[float, float]:
        dlon, dlat = self._deg_per_px
        return self.left + x * dlon, self.top - y * dlat

    def crop(self, bbox, height: int, width: int) -> np.ndarray:
        """(height, width) uint8 raster of a (left, bottom, right, top)
        bbox: the in-world part pasted at its place, grey elsewhere."""
        left, bottom, right, top = bbox
        x0, y0 = self.to_px(left, top)
        x1, y1 = self.to_px(right, bottom)
        n = self.raster.shape[0]
        xi0, yi0 = max(int(x0), 0), max(int(y0), 0)
        xi1, yi1 = min(int(np.ceil(x1)), n), min(int(np.ceil(y1)), n)
        sx, sy = width / (x1 - x0), height / (y1 - y0)
        u0, v0 = int(round((xi0 - x0) * sx)), int(round((yi0 - y0) * sy))
        u1, v1 = int(round((xi1 - x0) * sx)), int(round((yi1 - y0) * sy))
        out = np.full((height, width), _GREY, np.uint8)
        u0, v0 = max(u0, 0), max(v0, 0)
        u1, v1 = min(u1, width), min(v1, height)
        if u1 > u0 and v1 > v0:
            part = self.raster[yi0:yi1, xi0:xi1].astype(np.float32)
            ay = overlap_weights(v1 - v0, yi1 - yi0)
            ax = overlap_weights(u1 - u0, xi1 - xi0)
            out[v0:v1, u0:u1] = np.clip(np.rint(ay @ part @ ax.T), 0, 255)
        return out

    def render_frame(self, lon: float, lat: float, alt_m: float,
                     yaw_deg: float, k: np.ndarray,
                     hw: Tuple[int, int] = (480, 640)) -> np.ndarray:
        """The nadir camera view at ``alt_m`` above the flat world."""
        cx, cy = self.to_px(lon, lat)
        a = np.radians(yaw_deg)
        c, s = np.cos(a), np.sin(a)
        r = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1.0]])  # px -> camera
        t = -r @ np.array([cx, cy, -alt_m / self.gsd_m])
        hm = np.asarray(k, np.float64) @ np.stack([r[:, 0], r[:, 1], t],
                                                   axis=1)
        return _warp_perspective(self.raster, hm, hw)


@dataclasses.dataclass
class GeoWorld:
    """North-up imagery and a DEM over one extent, each with the
    ``GeoRef`` of its GeoTIFF (a pixel's top-left corner at ``left + x
    gsd_lon``, ``top - y gsd_lat``). Degrees relate to metres on the 6371
    km sphere, as in :class:`World`, with the east scale at each frame's
    own latitude: the demo maps' pixels, square in degrees, are about 1.09
    m north-south and 0.86 m east-west."""

    raster: np.ndarray  # (n, m) uint8
    georef: GeoRef
    dem: np.ndarray  # (p, q) float32 metres, the altitudes' datum
    dem_georef: GeoRef

    @classmethod
    def read(cls, maps_dir: str) -> "GeoWorld":
        """The first GeoTIFF of ``imagery/`` and of ``dem/`` under
        ``maps_dir``, the files ``gis-serve --maps`` serves."""
        import glob

        def first(layer):
            paths = sorted(glob.glob(os.path.join(maps_dir, layer, "*.tif"))
                           + glob.glob(os.path.join(maps_dir, layer,
                                                    "*.tiff")))
            if not paths:
                raise FileNotFoundError(f"no GeoTIFF under {maps_dir}/"
                                        f"{layer}")
            return read_geotiff(paths[0])

        return cls(*first("imagery"), *first("dem"))

    def to_px(self, lon, lat, dem: bool = False):
        """Pixel-centre (x east, y south) coordinates of a lon/lat in the
        imagery (or the DEM)."""
        g = self.dem_georef if dem else self.georef
        return ((np.asarray(lon) - g.left) / g.gsd_lon - 0.5,
                (g.top - np.asarray(lat)) / g.gsd_lat - 0.5)

    def to_lonlat(self, x, y, dem: bool = False):
        g = self.dem_georef if dem else self.georef
        return (g.left + (np.asarray(x) + 0.5) * g.gsd_lon,
                g.top - (np.asarray(y) + 0.5) * g.gsd_lat)

    def metres_per_px(self, lat: float) -> Tuple[float, float]:
        """(east, south) metres of an imagery pixel at ``lat``."""
        return (self.georef.gsd_lon * _M_PER_DEG * np.cos(np.radians(lat)),
                self.georef.gsd_lat * _M_PER_DEG)

    def height_at(self, lon, lat):
        """The DEM at lon/lat, bilinear between its pixel centres (the
        edge pixels' beyond them)."""
        x, y = self.to_px(lon, lat, dem=True)
        h, w = self.dem.shape
        return _sample(self.dem, np.clip(x, 0, w - 1), np.clip(y, 0, h - 1))

    def ground_of(self, lon: float, lat: float, alt_m: float,
                  yaw_deg: float, k: np.ndarray, uv: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Where the rays of frame pixels ``uv`` ((2, n): u, v) of
        :meth:`World.render_frame`'s nadir camera at ``alt_m`` metres of
        the DEM's datum above lon/lat meet the DEM's surface, after five
        fixed-point steps from the height under the camera: ((2, n) metres
        east and south of the camera, (n,) heights)."""
        mx, my = self.metres_per_px(lat)
        cx, cy = self.to_px(lon, lat)
        a = np.radians(yaw_deg)
        c, s = np.cos(a), np.sin(a)
        r = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1.0]])  # ground -> cam
        rays = r.T @ np.linalg.inv(np.asarray(k, np.float64)) @ np.vstack(
            [uv, np.ones(uv.shape[1])])
        rays = rays[:2] / rays[2]  # metres east, south per metre down
        ground = np.full(uv.shape[1], float(self.height_at(lon, lat)))
        for _ in range(5):
            ground = self.height_at(*self.to_lonlat(
                cx + (alt_m - ground) * rays[0] / mx,
                cy + (alt_m - ground) * rays[1] / my)).astype(np.float64)
        return (alt_m - ground) * rays, ground

    def render_frame(self, lon: float, lat: float, alt_m: float,
                     yaw_deg: float, k: np.ndarray,
                     hw: Tuple[int, int] = (480, 640)) -> np.ndarray:
        """That camera's view over the DEM's relief: :meth:`ground_of` on a
        grid every ``_GRID_PX`` frame pixels (the relief is smooth at that
        scale), interpolated between, the imagery sampled bilinearly at
        pixel centres."""
        h, w = hw
        mx, my = self.metres_per_px(lat)
        cx, cy = self.to_px(lon, lat)
        us = np.unique(np.r_[np.arange(0, w, _GRID_PX), w - 1]).astype(
            np.float64)
        vs = np.unique(np.r_[np.arange(0, h, _GRID_PX), h - 1]).astype(
            np.float64)
        uu, vv = np.meshgrid(us, vs)
        metres, _ = self.ground_of(lon, lat, alt_m, yaw_deg, k,
                                   np.stack([uu.ravel(), vv.ravel()]))
        xs = (cx + metres[0] / mx).reshape(uu.shape)
        ys = (cy + metres[1] / my).reshape(uu.shape)

        def full(g):  # the grid's values at every frame pixel
            rows = np.stack([np.interp(np.arange(w), us, row) for row in g])
            return np.stack([np.interp(np.arange(h), vs, col)
                             for col in rows.T], axis=1)

        out = _sample(self.raster, full(xs), full(ys))
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def camera_attitude_quat(yaw_deg: float) -> np.ndarray:
    """camera_optical -> ENU quaternion of :meth:`World.render_frame`'s
    camera: world pixels (x east, y south, z down) relate to ENU by
    diag(1, -1, -1), and the camera is Rz(yaw) of them."""
    a = np.radians(yaw_deg)
    c, s = np.cos(a), np.sin(a)
    r_cam_from_px = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1.0]])
    return matrix_to_quat((r_cam_from_px @ np.diag([1.0, -1.0, -1.0])).T)


def write_replay_dataset(world: World, out: str, frames: int = 12,
                         alt_m: float = 500.0, yaw_deg: float = 25.0,
                         hw: Tuple[int, int] = (480, 640),
                         lonlat0: Tuple[float, float] = (24.04, 60.025),
                         map_px: int = 0,
                         image_format: str = "png",
                         coverage: float = 3.0) -> dict:
    """Write a replay dataset of a straight flight over ``world`` into
    ``out``, the map and frames as ``image_format`` ("png", "jpeg" at
    ``cv2.imencode``'s quality 95, or "tiff": a GIS export, the map a
    256-px tiled deflate GeoTIFF with predictor 2, the DEM a float32
    GeoTIFF (``gis/geotiff.py``) named in ``map.json``, the frames
    alternately deflate TIFF and PGM) under the layout's names
    (``map.png``, ``frames/<stamp_us>.png``), with the defaults of
    ``tools/make_replay_dataset.py``: frame i at ``lonlat0 + i * (1e-4,
    5e-5)`` deg, ``alt_m`` over a flat world (DEM 0), f = 400 px at 640 px
    width, the map a square at ``coverage`` (3) times the frame's larger
    footprint side around the first frame, ``map_px`` a side (0:
    ``ceil(diagonal / 8) * 8``).
    Returns the dataset's poses and map size."""
    if image_format not in ("png", "jpeg", "tiff"):
        raise ValueError(f"image_format {image_format!r}: png, jpeg or "
                         "tiff")
    encode = {"png": encode_png, "jpeg": encode_jpeg,
              "tiff": lambda img: encode_tiff(img, 8, 2)}[image_format]
    h, w = hw
    f = 400.0 * max(w, h) / 640.0
    k = np.array([[f, 0.0, w / 2], [0.0, f, h / 2], [0.0, 0.0, 1.0]])
    map_px = map_px or int(np.ceil(float(np.hypot(h, w)) / 8)) * 8
    side_px = int(round(coverage * alt_m * max(h, w) / f / world.gsd_m))
    cx, cy = world.to_px(*lonlat0)
    x0, y0 = int(cx - side_px / 2), int(cy - side_px / 2)
    left, top = world.to_lonlat(x0, y0)
    right, bottom = world.to_lonlat(x0 + side_px, y0 + side_px)
    os.makedirs(os.path.join(out, "frames"), exist_ok=True)
    ortho = world.crop((left, bottom, right, top), map_px, map_px)
    dem = 0.0
    geo = GeoRef(left, top, (right - left) / map_px, (top - bottom) / map_px)
    with open(os.path.join(out, "map.png"), "wb") as fh:
        if image_format == "tiff":
            fh.write(encode_tiff(ortho, 8, 2, tile=(256, 256), geo=(
                geo.left, geo.top, geo.gsd_lon, geo.gsd_lat)))
        else:
            fh.write(encode(ortho))
    if image_format == "tiff":
        dem = "dem.tif"
        write_geotiff(os.path.join(out, dem), np.zeros_like(ortho,
                                                             np.float32), geo)
    with open(os.path.join(out, "map.json"), "w") as fh:
        json.dump({"left": left, "top": top, "right": right,
                   "bottom": bottom, "dem": dem}, fh, indent=1)
    with open(os.path.join(out, "camera.json"), "w") as fh:
        json.dump({"k": k.tolist(), "width": w, "height": h}, fh, indent=1)
    rows = []
    for i in range(frames):
        stamp = 1_000_000 + i * 500_000
        lon, lat = lonlat0[0] + 1e-4 * i, lonlat0[1] + 5e-5 * i
        frame = world.render_frame(lon, lat, alt_m, yaw_deg, k, hw)
        with open(os.path.join(out, "frames", f"{stamp}.png"), "wb") as fh:
            fh.write(encode_pgm(frame) if image_format == "tiff" and i % 2
                     else encode(frame))
        rows.append({"stamp_us": stamp, "lon": lon, "lat": lat,
                     "alt_ellipsoid_m": alt_m, "yaw_deg": yaw_deg})
    with open(os.path.join(out, "poses.csv"), "w", newline="") as fh:
        wtr = csv.DictWriter(fh, fieldnames=list(rows[0]))
        wtr.writeheader()
        wtr.writerows(rows)
    return {"poses": rows, "map_px": map_px, "k": k}


class WorldWMS:
    """Loopback stub WMS over a :class:`World`::

        with WorldWMS(world) as wms:
            client = WMSClient(wms.url)

    ``get_maps`` counts the GetMap requests answered, ``formats`` the
    content types of their replies.
    """

    def __init__(self, world: World, dem_value: int = 0):
        self.world = world
        self.dem_value = int(dem_value)
        self.get_maps = 0
        self.formats: Dict[str, int] = {}
        self._count_lock = threading.Lock()
        self._server = ThreadingHTTPServer(("127.0.0.1", 0),
                                           self._handler())
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self._server.server_address[1]}/wms"

    def _handler(self):
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _reply(self, code: int, ctype: str, body: bytes) -> None:
                self.send_response(code)
                self.send_header("content-type", ctype)
                self.send_header("content-length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                q = {k.lower(): v[0] for k, v in
                     parse_qs(urlparse(self.path).query).items()}
                if q.get("request") == "GetCapabilities":
                    self._reply(200, "application/vnd.ogc.wms_xml",
                                b"<WMT_MS_Capabilities/>")
                    return
                if q.get("request") != "GetMap":
                    self._reply(404, "text/plain", b"unknown request")
                    return
                bbox = tuple(float(v) for v in q["bbox"].split(","))
                h, w = int(q["height"]), int(q["width"])
                if "dem" in q.get("layers", ""):
                    img = np.full((h, w), stub.dem_value, np.uint8)
                else:
                    img = stub.world.crop(bbox, h, w)
                fmt = q.get("format", "image/png")
                if "jpeg" in fmt or "jpg" in fmt:
                    ctype, body = "image/jpeg", encode_jpeg(img)
                elif "tiff" in fmt:  # MapServer's GTiff: plain strips
                    left, bottom, right, top = bbox
                    ctype, body = "image/tiff", encode_tiff(img, geo=(
                        left, top, (right - left) / w, (top - bottom) / h))
                else:
                    ctype, body = "image/png", encode_png(img)
                with stub._count_lock:
                    stub.get_maps += 1
                    stub.formats[ctype] = stub.formats.get(ctype, 0) + 1
                self._reply(200, ctype, body)

        return Handler

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "WorldWMS":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
