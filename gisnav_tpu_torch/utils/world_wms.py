"""A seeded georeferenced world, its camera frames, and a loopback stub WMS.

For the node-graph flights of ``chip_smoke.py`` and the CPU tests (numpy,
``http.server`` and ``zlib``; no OpenCV, no network: the server binds
127.0.0.1 only).

- :class:`World`: a square raster drawn as ``utils.world`` draws its scenes
  (shapes over multi-octave noise), north up, ``gsd_m`` metres a pixel, its
  top-left corner at (``left``, ``top``) degrees. Degrees and metres are
  related on the 6371 km sphere, as the orthoimage affine's haversine
  z-scale relates them, so a DEM-lifted fix carries no scale bias.
- :meth:`World.render_frame`: the nadir camera view at a lon/lat, altitude
  and yaw, and :func:`camera_attitude_quat`: that camera's camera_optical
  -> ENU quaternion (the gimbal attitude message).
- :class:`WorldWMS`: a WMS answering GetCapabilities and GetMap. An imagery
  GetMap pastes the in-world part of the bbox at its true place in the
  requested raster, area-resampled, and pads with grey outside the world:
  stretching the crop to the raster would skew the raster <-> CRS affine
  and fabricate hundreds of metres of error where maps are large. A layer
  named ``dem`` is flat at ``dem_value`` metres. Replies are 8-bit grey
  PNG whatever format is asked.
"""
from __future__ import annotations

import dataclasses
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from gisnav_tpu_torch.geometry.quaternion import matrix_to_quat
from gisnav_tpu_torch.gis.png import encode_png
from gisnav_tpu_torch.utils.world import _draw_world, _warp_perspective

__all__ = ["World", "WorldWMS", "camera_attitude_quat", "east_of"]

_M_PER_DEG = 6371000.0 * np.pi / 180.0  # haversine's sphere
_GREY = 110  # the world's background level


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
            ay = _area_weights(v1 - v0, yi1 - yi0)
            ax = _area_weights(u1 - u0, xi1 - xi0)
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


def _area_weights(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) box-filter weights: output i averages the source span
    [i, i + 1) * n_in / n_out by overlap (``INTER_AREA`` when shrinking)."""
    s = n_in / n_out
    lo = np.arange(n_out)[:, None] * s
    j = np.arange(n_in)[None, :]
    w = np.clip(np.minimum(j + 1, lo + s) - np.maximum(j, lo), 0.0, None)
    return (w / w.sum(axis=1, keepdims=True)).astype(np.float32)


def camera_attitude_quat(yaw_deg: float) -> np.ndarray:
    """camera_optical -> ENU quaternion of :meth:`World.render_frame`'s
    camera: world pixels (x east, y south, z down) relate to ENU by
    diag(1, -1, -1), and the camera is Rz(yaw) of them."""
    a = np.radians(yaw_deg)
    c, s = np.cos(a), np.sin(a)
    r_cam_from_px = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1.0]])
    return matrix_to_quat((r_cam_from_px @ np.diag([1.0, -1.0, -1.0])).T)


class WorldWMS:
    """Loopback stub WMS over a :class:`World`::

        with WorldWMS(world) as wms:
            client = WMSClient(wms.url)

    ``get_maps`` counts the GetMap requests answered.
    """

    def __init__(self, world: World, dem_value: int = 0):
        self.world = world
        self.dem_value = int(dem_value)
        self.get_maps = 0
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
                with stub._count_lock:
                    stub.get_maps += 1
                self._reply(200, "image/png", encode_png(img))

        return Handler

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "WorldWMS":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
