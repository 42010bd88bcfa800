"""Self-contained GIS service: WMS GetMap + WFS-T over HTTP, no GDAL stack.

The port's counterpart of ``gisnav_tpu/gis/server.py``. The reference's GIS
constellation is MapServer (WMS imagery/DEM) + TinyOWS (WFS-T transactions)
+ PostGIS (``docker/apache/`` in hmakelin/gisnav); this module is the
air-gapped/demo/test equivalent: one Python process that

- serves WMS 1.1.1 ``GetCapabilities``/``GetMap`` for ``imagery`` (uint8
  grayscale) and ``dem`` (meters, encoded as 8-bit grayscale — the same
  wire encoding ``gis/wms.py`` decodes; DEM values clip at 255 m) from
  GeoTIFFs read with :mod:`gisnav_tpu_torch.gis.geotiff`,
- serves WFS-T 1.1.0: ``Transaction`` (Insert/Delete of
  ``gisnav:position`` points — the exact XML
  :mod:`gisnav_tpu_torch.nodes.wfst_node` posts) and ``GetFeature`` as
  GeoJSON or GML, backed by SQLite (zero-dependency) or PostGIS
  (``psycopg2`` DSN, imported only when asked for).

Start it with ``python -m gisnav_tpu_torch gis-serve`` or in-process via
:class:`GisServer`. GetMap pastes the in-world crop at its true location
and pads outside-world area with neutral gray — never stretches — so the
raster<->CRS affine stays exact. The crop is resampled by
:func:`area_resize`, OpenCV's ``INTER_AREA`` on f32 in numpy (its
overlap weights and float32 sums when shrinking, its own two-tap weights
when enlarging), and
truncated to the layer's dtype, as the JAX server does with ``cv2.resize``.

GetMap answers ``image/jpeg`` (or a format naming ``jpg``) with
``gis/jpeg.py`` ``encode_jpeg`` at quality 95, the bytes ``cv2.imencode``
writes, and any other format with PNG (``gis/png.py`` ``encode_png``), as
the JAX server does; the capabilities list both.
"""
from __future__ import annotations

import json
import math
import re
import sqlite3
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from gisnav_tpu_torch.gis.jpeg import encode_jpeg
from gisnav_tpu_torch.gis.png import encode_png

__all__ = ["FeatureStore", "SQLiteStore", "PostGISStore", "GisServer",
           "area_resize", "handle_transaction", "load_layers_from_dir",
           "overlap_weights"]

_FALLBACK_GRAY = 110


class FeatureStore:
    """WFS-T feature storage interface (``position`` point layer)."""

    def insert(self, lon: float, lat: float) -> int:
        raise NotImplementedError

    def delete_all(self) -> int:
        raise NotImplementedError

    def features(self):
        """-> iterable of (id, lon, lat, timestamp-iso)."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class SQLiteStore(FeatureStore):
    """Zero-dependency store (file or ``:memory:``)."""

    def __init__(self, path: str = ":memory:"):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS position ("
                "id INTEGER PRIMARY KEY AUTOINCREMENT, "
                "lon REAL NOT NULL, lat REAL NOT NULL, "
                "ts TEXT DEFAULT (strftime('%Y-%m-%dT%H:%M:%fZ', 'now')))"
            )
            self._conn.commit()

    def insert(self, lon: float, lat: float) -> int:
        with self._lock:
            cur = self._conn.execute(
                "INSERT INTO position (lon, lat) VALUES (?, ?)", (lon, lat))
            self._conn.commit()
            return int(cur.lastrowid)

    def delete_all(self) -> int:
        with self._lock:
            cur = self._conn.execute("DELETE FROM position")
            self._conn.commit()
            return cur.rowcount

    def features(self):
        with self._lock:
            rows = self._conn.execute(
                "SELECT id, lon, lat, ts FROM position ORDER BY id").fetchall()
        return rows

    def close(self) -> None:
        with self._lock:
            self._conn.close()


class PostGISStore(FeatureStore):
    """PostGIS-backed store: the same ``feature.position`` table the
    reference's TinyOWS writes (``docker/postgres/init-gisnav-db.sh``)."""

    def __init__(self, dsn: str):
        import psycopg2  # optional dependency, production containers only

        self._conn = psycopg2.connect(dsn)
        self._lock = threading.Lock()
        with self._lock, self._conn.cursor() as cur:
            cur.execute("CREATE SCHEMA IF NOT EXISTS feature")
            cur.execute(
                "CREATE TABLE IF NOT EXISTS feature.position ("
                "id SERIAL PRIMARY KEY, "
                "geom GEOMETRY(Point, 4326), "
                "timestamp TIMESTAMPTZ DEFAULT NOW())"
            )
            self._conn.commit()

    def insert(self, lon: float, lat: float) -> int:
        with self._lock, self._conn.cursor() as cur:
            cur.execute(
                "INSERT INTO feature.position (geom) VALUES "
                "(ST_SetSRID(ST_MakePoint(%s, %s), 4326)) RETURNING id",
                (lon, lat))
            fid = cur.fetchone()[0]
            self._conn.commit()
            return int(fid)

    def delete_all(self) -> int:
        with self._lock, self._conn.cursor() as cur:
            cur.execute("DELETE FROM feature.position")
            n = cur.rowcount
            self._conn.commit()
            return n

    def features(self):
        with self._lock, self._conn.cursor() as cur:
            cur.execute(
                "SELECT id, ST_X(geom), ST_Y(geom), "
                "to_char(timestamp, 'YYYY-MM-DD\"T\"HH24:MI:SS\"Z\"') "
                "FROM feature.position ORDER BY id")
            return cur.fetchall()

    def close(self) -> None:
        with self._lock:
            self._conn.close()


# --- WFS-T XML handling (hand-rolled like the client side: the transaction
# schema is small and fixed — gisnav:position points, see wfst_node.py) ---

_COORD_RE = re.compile(
    r"<gml:(?:coordinates|pos)[^>]*>\s*([-\d.eE+]+)[,\s]+([-\d.eE+]+)\s*<")
_INSERT_RE = re.compile(r"<wfs:Insert[\s>]")
_DELETE_RE = re.compile(r"<wfs:Delete[^>]*typeName=\"([^\"]+)\"")


def handle_transaction(store: FeatureStore, xml: str) -> Tuple[int, str]:
    """Apply a WFS-T Transaction -> (http status, response XML)."""
    inserted = 0
    deleted = 0
    if _INSERT_RE.search(xml):
        coords = _COORD_RE.findall(xml)
        if not coords:
            return 400, _exception_xml("Insert with no gml coordinates")
        for lon_s, lat_s in coords:
            store.insert(float(lon_s), float(lat_s))
            inserted += 1
    m = _DELETE_RE.search(xml)
    if m:
        if "position" not in m.group(1):
            return 400, _exception_xml(f"unknown typeName {m.group(1)}")
        deleted = store.delete_all()
    if not inserted and not m:
        return 400, _exception_xml("no Insert or Delete in Transaction")
    return 200, (
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        '<wfs:TransactionResponse xmlns:wfs="http://www.opengis.net/wfs" '
        'version="1.1.0">'
        "<wfs:TransactionSummary>"
        f"<wfs:totalInserted>{inserted}</wfs:totalInserted>"
        f"<wfs:totalDeleted>{deleted}</wfs:totalDeleted>"
        "</wfs:TransactionSummary>"
        "</wfs:TransactionResponse>"
    )


def _exception_xml(message: str) -> str:
    return (
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        '<ows:ExceptionReport xmlns:ows="http://www.opengis.net/ows">'
        f"<ows:Exception><ows:ExceptionText>{message}"
        "</ows:ExceptionText></ows:Exception></ows:ExceptionReport>"
    )


def features_geojson(store: FeatureStore) -> str:
    feats = [
        {
            "type": "Feature",
            "id": f"position.{fid}",
            "geometry": {"type": "Point", "coordinates": [lon, lat]},
            "properties": {"timestamp": ts},
        }
        for fid, lon, lat, ts in store.features()
    ]
    return json.dumps({"type": "FeatureCollection", "features": feats})


def features_gml(store: FeatureStore) -> str:
    members = "".join(
        f'<gml:featureMember><gisnav:position gml:id="position.{fid}">'
        f"<gisnav:geom><gml:Point srsName=\"EPSG:4326\">"
        f"<gml:coordinates>{lon},{lat}</gml:coordinates></gml:Point>"
        f"</gisnav:geom><gisnav:timestamp>{ts}</gisnav:timestamp>"
        "</gisnav:position></gml:featureMember>"
        for fid, lon, lat, ts in store.features()
    )
    return (
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        '<wfs:FeatureCollection xmlns:wfs="http://www.opengis.net/wfs" '
        'xmlns:gml="http://www.opengis.net/gml" '
        'xmlns:gisnav="http://www.mapserver.org/tinyows/">'
        f"{members}</wfs:FeatureCollection>"
    )


# --- WMS raster serving ---


def overlap_weights(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) f32 weights of a shrinking axis: output i averages the
    source span [i, i + 1) * n_in / n_out by overlap."""
    s = n_in / n_out
    lo = np.arange(n_out)[:, None] * s
    j = np.arange(n_in)[None, :]
    w = np.clip(np.minimum(j + 1, lo + s) - np.maximum(j, lo), 0.0, None)
    return (w / w.sum(axis=1, keepdims=True)).astype(np.float32)


def _two_taps(n_out: int, n_in: int):
    """OpenCV's ``INTER_AREA`` taps where it enlarges: output i reads source
    ``floor(i * s)`` and the next one (clamped), the second weighted by the
    fractional part of ``(i + 1) - (floor(i * s) + 1) / s`` rounded to f32
    first, s = 1 / (n_out / n_in) in double as OpenCV forms it; the last
    source pixel alone at the edge."""
    d = np.arange(n_out)
    inv = n_out / n_in
    src = np.floor(d * (1.0 / inv)).astype(np.int64)  # OpenCV's rounding
    f = ((d + 1) - (src + 1) * inv).astype(np.float32)  # rounded first
    f = np.where((f <= 0) | (src >= n_in - 1), np.float32(0),
                 f - np.floor(f)).astype(np.float32)
    src = np.minimum(src, n_in - 1)
    return src, np.minimum(src + 1, n_in - 1), np.float32(1) - f, f


def _area_taps(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV's ``computeResizeAreaTab`` along a shrinking axis as (n_out,
    k) source indices and float32 weights, each output's taps in source
    order (padded with weight 0): output d covers the source span [d s,
    (d + 1) s), s = 1 / (n_out / n_in); a partial pixel at either end
    weighs its overlap (if over 1e-3) over the cell width, every whole one
    1 / cell width."""
    s = 1.0 / (n_out / n_in)
    rows = []
    for d in range(n_out):
        f1 = d * s
        f2 = f1 + s
        cell = min(s, n_in - f1)
        s2 = min(math.floor(f2), n_in - 1)
        s1 = min(math.ceil(f1), s2)
        taps = []
        if s1 - f1 > 1e-3:
            taps.append((s1 - 1, (s1 - f1) / cell))
        taps += [(i, 1.0 / cell) for i in range(s1, s2)]
        if f2 - s2 > 1e-3:
            taps.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        rows.append(taps)
    k = max(len(t) for t in rows)
    idx = np.zeros((n_out, k), np.int64)
    wts = np.zeros((n_out, k), np.float32)
    for d, taps in enumerate(rows):
        for j, (i, v) in enumerate(taps):
            idx[d, j], wts[d, j] = i, v
    return idx, wts


def area_resize(a: np.ndarray, height: int, width: int) -> np.ndarray:
    """``cv2.resize(a.astype(np.float32), (width, height),
    interpolation=cv2.INTER_AREA)`` in numpy. Where both axes shrink, as
    OpenCV's ``ResizeArea_Invoker`` sums: along each row the products of
    the pixels and their weights (:func:`_area_taps`) added in source order
    in float32, then down the columns the same with the row weights (its
    values exactly); else OpenCV's two-tap weights on both axes."""
    a = np.asarray(a, np.float32)
    h_in, w_in = a.shape
    if (h_in, w_in) == (height, width):
        return a.copy()
    if h_in >= height and w_in >= width:
        xi, xw = _area_taps(w_in, width)
        yi, yw = _area_taps(h_in, height)
        rows = np.zeros((h_in, width), np.float32)
        for j in range(xi.shape[1]):
            rows += a[:, xi[:, j]] * xw[:, j]
        out = rows[yi[:, 0]] * yw[:, :1]
        for j in range(1, yi.shape[1]):
            out += rows[yi[:, j]] * yw[:, j:j + 1]
        return out
    x0, x1, a0, a1 = _two_taps(width, w_in)
    y0, y1, b0, b1 = _two_taps(height, h_in)
    rows = a[:, x0] * a0 + a[:, x1] * a1
    return rows[y0] * b0[:, None] + rows[y1] * b1[:, None]


class _RasterLayer:
    def __init__(self, raster: np.ndarray, georef):
        self.raster = raster
        self.georef = georef

    def render(self, bbox, size_hw) -> np.ndarray:
        """Crop-resample the layer to (h, w) over a WGS84 bbox.

        True-location paste: the portion of the bbox inside the raster is
        resampled to its exact sub-rectangle of the output; the rest is
        neutral gray (imagery) / zero (float DEM).
        """
        left, bottom, right, top = bbox
        h, w = size_hw
        g = self.georef
        hh, ww = self.raster.shape[:2]
        # bbox corners in source pixel coords
        x0 = (left - g.left) / g.gsd_lon
        x1 = (right - g.left) / g.gsd_lon
        y0 = (g.top - top) / g.gsd_lat
        y1 = (g.top - bottom) / g.gsd_lat
        fill = 0.0 if self.raster.dtype != np.uint8 else _FALLBACK_GRAY
        out = np.full((h, w), fill, self.raster.dtype)
        xi0, yi0 = max(int(x0), 0), max(int(y0), 0)
        xi1 = min(int(np.ceil(x1)), ww)
        yi1 = min(int(np.ceil(y1)), hh)
        if xi1 <= xi0 or yi1 <= yi0 or x1 <= x0 or y1 <= y0:
            return out
        sx, sy = w / (x1 - x0), h / (y1 - y0)
        u0 = int(round((xi0 - x0) * sx))
        v0 = int(round((yi0 - y0) * sy))
        u1 = int(round((xi1 - x0) * sx))
        v1 = int(round((yi1 - y0) * sy))
        u0c, v0c = max(u0, 0), max(v0, 0)
        u1c, v1c = min(u1, w), min(v1, h)
        crop = self.raster[yi0:yi1, xi0:xi1]
        if u1c > u0c and v1c > v0c and crop.size:
            out[v0c:v1c, u0c:u1c] = area_resize(
                crop, v1c - v0c, u1c - u0c).astype(self.raster.dtype)
        return out


_WMS_CAPS = """<?xml version="1.0" encoding="UTF-8"?>
<WMT_MS_Capabilities version="1.1.1">
  <Service><Name>OGC:WMS</Name><Title>gisnav_tpu demo WMS</Title></Service>
  <Capability>
    <Request><GetMap><Format>image/png</Format>
      <Format>image/jpeg</Format></GetMap></Request>
    <Layer><Title>gisnav_tpu</Title><SRS>EPSG:4326</SRS>
      <Layer queryable="0"><Name>imagery</Name>
        <Title>Demo orthoimagery</Title></Layer>
      <Layer queryable="0"><Name>dem</Name>
        <Title>Demo elevation (m as gray)</Title></Layer>
    </Layer>
  </Capability>
</WMT_MS_Capabilities>
"""

_WFS_CAPS = """<?xml version="1.0" encoding="UTF-8"?>
<wfs:WFS_Capabilities version="1.1.0"
    xmlns:wfs="http://www.opengis.net/wfs"
    xmlns:gisnav="http://www.mapserver.org/tinyows/">
  <FeatureTypeList>
    <FeatureType><Name>gisnav:position</Name><Title>Position</Title>
      <DefaultSRS>EPSG:4326</DefaultSRS></FeatureType>
  </FeatureTypeList>
</wfs:WFS_Capabilities>
"""


class GisServer:
    """Threaded HTTP server exposing ``/wms`` and ``/wfst``.

    :param layers: mapping layer name -> (raster, GeoRef); typically from
        :func:`gisnav_tpu_torch.gis.geotiff.read_geotiff`
    :param store: WFS-T feature store (defaults to in-memory SQLite)
    :param port: 0 picks a free port (see :attr:`port` after start)
    """

    def __init__(self, layers: Optional[Dict[str, tuple]] = None,
                 store: Optional[FeatureStore] = None,
                 host: str = "0.0.0.0", port: int = 0):
        self.store = store or SQLiteStore()
        self._layers = {
            name: _RasterLayer(raster, georef)
            for name, (raster, georef) in (layers or {}).items()
        }
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def wms_url(self) -> str:
        return f"http://127.0.0.1:{self.port}/wms"

    @property
    def wfst_url(self) -> str:
        return f"http://127.0.0.1:{self.port}/wfst"

    def start(self) -> "GisServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="gis-server", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self.store.close()

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _send(self, status: int, content_type: str, body: bytes):
                self.send_response(status)
                self.send_header("content-type", content_type)
                self.send_header("content-length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                q = {k.lower(): v[0] for k, v in
                     parse_qs(url.query).items()}
                req = q.get("request", "").lower()
                if url.path.startswith("/wms"):
                    if req == "getcapabilities":
                        self._send(200, "application/vnd.ogc.wms_xml",
                                   _WMS_CAPS.encode())
                    elif req == "getmap":
                        self._get_map(q)
                    else:
                        self._send(400, "text/xml",
                                   _exception_xml("bad WMS request").encode())
                elif url.path.startswith("/wfst"):
                    if req == "getcapabilities":
                        self._send(200, "text/xml", _WFS_CAPS.encode())
                    elif req == "getfeature":
                        fmt = q.get("outputformat", "")
                        if "json" in fmt.lower():
                            self._send(200, "application/json",
                                       features_geojson(
                                           server.store).encode())
                        else:
                            self._send(200, "text/xml",
                                       features_gml(server.store).encode())
                    else:
                        self._send(400, "text/xml",
                                   _exception_xml("bad WFS request").encode())
                elif url.path == "/":
                    layers = ", ".join(sorted(server._layers)) or "(none)"
                    self._send(200, "text/plain",
                               f"gisnav_tpu GIS server\nWMS layers: "
                               f"{layers}\nWFS-T: gisnav:position\n".encode())
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                url = urlparse(self.path)
                if not url.path.startswith("/wfst"):
                    self._send(404, "text/plain", b"not found")
                    return
                length = int(self.headers.get("content-length", 0))
                xml = self.rfile.read(length).decode("utf-8", "replace")
                status, body = handle_transaction(server.store, xml)
                self._send(status, "text/xml", body.encode())

            def _get_map(self, q):
                try:
                    names = q.get("layers", "").split(",")
                    bbox = tuple(float(v) for v in q["bbox"].split(","))
                    h, w = int(q["height"]), int(q["width"])
                    if len(bbox) != 4 or h <= 0 or w <= 0:
                        raise ValueError("bbox or size out of range")
                except (KeyError, ValueError):
                    self._send(400, "text/xml",
                               _exception_xml("bad GetMap params").encode())
                    return
                name = names[0]
                layer = server._layers.get(name)
                if layer is None:
                    self._send(400, "text/xml", _exception_xml(
                        f"unknown layer {name!r}").encode())
                    return
                out = layer.render(bbox, (h, w))
                if out.dtype != np.uint8:
                    # DEM wire encoding: meters as 8-bit gray (clips at 255;
                    # gis/wms.py decodes grayscale -> float32 meters)
                    out = np.clip(out, 0, 255).astype(np.uint8)
                fmt = q.get("format", "image/png")
                if "jpeg" in fmt or "jpg" in fmt:
                    self._send(200, "image/jpeg", encode_jpeg(out))
                else:
                    self._send(200, "image/png", encode_png(out))

        return Handler


def load_layers_from_dir(maps_dir: str) -> Dict[str, tuple]:
    """Load ``imagery/*.tif`` and ``dem/*.tif`` from a maps directory
    (the same layout ``docker/mapserver``'s VRT entrypoint watches)."""
    import glob
    import os

    from gisnav_tpu_torch.gis.geotiff import read_geotiff

    layers: Dict[str, tuple] = {}
    for name in ("imagery", "dem"):
        paths = sorted(
            glob.glob(os.path.join(maps_dir, name, "*.tif"))
            + glob.glob(os.path.join(maps_dir, name, "*.tiff")))
        if paths:
            # single-raster demo scope; the MapServer VRT path handles
            # true mosaics
            layers[name] = read_geotiff(paths[0])
    return layers
