"""The port's GeoTIFF codec, GIS server and WFS-T sink against the JAX
package's.

- ``write_geotiff`` writes the JAX writer's bytes (uint8 and float32), and
  each package reads the other's files to the same raster and georeference.
- ``area_resize`` against ``cv2.resize(..., INTER_AREA)`` on f32: shrinking,
  enlarging and mixed, to 4e-6 of the range (f32 sums in another order).
- Both servers over the same layers: ``GetMap`` rasters (decoded PNG)
  within 1 grey level of the JAX server's and equal on at least 99 % of the
  pixels, padding equal, on bboxes that shrink, enlarge, cross the world's
  edge and lie outside it (the JAX server truncates ``cv2.resize``'s f32
  output, so an average that lands near an integer may flip a level); the
  DEM layer too. Service exceptions equal; capabilities equal but for the
  JPEG format the port does not serve; a JPEG GetMap is a WMS
  ``ServiceExceptionReport`` from the port; a malformed bbox or an empty
  raster is the GetMap exception (the JAX server drops the connection).
- WFS-T: the same transactions give the same store rows, equal GeoJSON and
  GML but for the timestamps, and equal transaction replies.
- ``WFSTNode`` posts the JAX node's XML byte for byte (delete-all, then an
  insert a fix), and the app's health report exempts it from staleness.
"""
import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import cv2
import numpy as np
import pytest
import torch

from gisnav_tpu.gis import geotiff as jgeo
from gisnav_tpu.gis import server as jserver
from gisnav_tpu.nodes.bus import LocalBus as JaxLocalBus
from gisnav_tpu.nodes.wfst_node import WFSTNode as JaxWFSTNode
from gisnav_tpu_torch.gis import geotiff as tgeo
from gisnav_tpu_torch.gis import server as tserver
from gisnav_tpu_torch.gis.png import decode_png
from gisnav_tpu_torch.nodes.bus import LocalBus
from gisnav_tpu_torch.nodes.mock_gps import TOPIC_SENSOR_GPS
from gisnav_tpu_torch.nodes.wfst_node import WFSTNode
from gisnav_tpu_torch.utils.world_wms import World

torch.set_num_threads(2)

GEOREF = dict(left=24.0, top=60.05, gsd_lon=2.4e-5, gsd_lat=1.2e-5)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_geotiff_bytes_equal_and_cross_read(tmp_path, dtype):
    rng = np.random.default_rng(3)
    arr = rng.uniform(0, 200, (37, 53)).astype(dtype)
    ours, ref = str(tmp_path / "ours.tif"), str(tmp_path / "ref.tif")
    tgeo.write_geotiff(ours, arr, tgeo.GeoRef(**GEOREF))
    jgeo.write_geotiff(ref, arr, jgeo.GeoRef(**GEOREF))
    with open(ours, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    for read, path in ((tgeo.read_geotiff, ref), (jgeo.read_geotiff, ours)):
        back, georef = read(path)
        assert back.dtype == arr.dtype and np.array_equal(back, arr)
        assert (georef.left, georef.top, georef.gsd_lon, georef.gsd_lat) == (
            GEOREF["left"], GEOREF["top"], GEOREF["gsd_lon"],
            GEOREF["gsd_lat"])
    assert tgeo.GeoRef(**GEOREF).bbox(arr.shape) == jgeo.GeoRef(
        **GEOREF).bbox(arr.shape)


def test_geotiff_rejects_out_of_subset(tmp_path):
    with pytest.raises(ValueError):
        tgeo.write_geotiff(str(tmp_path / "x.tif"), np.zeros((4, 4), np.int32),
                           tgeo.GeoRef(**GEOREF))
    bad = tmp_path / "bad.tif"
    bad.write_bytes(b"MZ not a tiff at all")
    with pytest.raises(ValueError):
        tgeo.read_geotiff(str(bad))


@pytest.mark.parametrize("src_hw,dst_hw", [
    ((100, 120), (37, 53)), ((64, 64), (32, 32)), ((37, 53), (100, 120)),
    ((50, 50), (50, 80)), ((33, 90), (70, 45)), ((300, 280), (641, 513)),
    ((10, 10), (30, 30)), ((120, 90), (120, 90))])
def test_area_resize_is_cv2_inter_area(src_hw, dst_hw):
    src = np.random.default_rng(1).uniform(0, 255, src_hw).astype(np.float32)
    ref = cv2.resize(src, dst_hw[::-1], interpolation=cv2.INTER_AREA)
    got = tserver.area_resize(src, *dst_hw)
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=255 * 1e-6 * 4)


@pytest.fixture(scope="module")
def servers():
    world = World.make(seed=5, size_px=640, gsd_m=1.36)
    dlon, dlat = world._deg_per_px
    dem = np.linspace(0, 300, 80 * 80, dtype=np.float32).reshape(80, 80)
    layers = {"imagery": (world.raster, (world.left, world.top, dlon, dlat)),
              "dem": (dem, (world.left, world.top, 8 * dlon, 8 * dlat))}
    ours = tserver.GisServer(layers={
        k: (r, tgeo.GeoRef(*g)) for k, (r, g) in layers.items()},
        host="127.0.0.1").start()
    ref = jserver.GisServer(layers={
        k: (r, jgeo.GeoRef(*g)) for k, (r, g) in layers.items()},
        host="127.0.0.1").start()
    yield world, ours, ref
    ours.stop()
    ref.stop()


def _get(url, **query):
    q = "&".join(f"{k}={v}" for k, v in query.items())
    try:
        with urllib.request.urlopen(f"{url}?{q}", timeout=30) as resp:
            return resp.status, resp.headers["content-type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["content-type"], e.read()


def _bboxes(world):
    """(left, bottom, right, top) bboxes as fractions of the world: inside,
    across the west and south edges, wholly outside."""
    n = world.raster.shape[0]

    def box(x0, y0, x1, y1):
        left, top = world.to_lonlat(x0 * n, y0 * n)
        right, bottom = world.to_lonlat(x1 * n, y1 * n)
        return ",".join(repr(float(v)) for v in (left, bottom, right, top))

    return [box(0.2, 0.2, 0.7, 0.6), box(-0.3, 0.1, 0.4, 0.8),
            box(0.5, 0.6, 1.2, 1.3), box(0.31, 0.33, 0.37, 0.41),
            box(1.5, 1.5, 2.0, 2.0)]


@pytest.mark.parametrize("layer", ["imagery", "dem"])
@pytest.mark.parametrize("size", [(160, 200), (256, 256), (900, 700)])
def test_getmap_within_one_level_of_jax(servers, layer, size):
    world, ours, ref = servers
    exact = total = 0
    for bbox in _bboxes(world):
        query = dict(service="WMS", version="1.1.1", request="GetMap",
                     layers=layer, styles="", srs="EPSG:4326", bbox=bbox,
                     width=size[1], height=size[0], format="image/png")
        (s1, c1, b1), (s2, c2, b2) = (_get(srv.wms_url, **query)
                                      for srv in (ours, ref))
        assert (s1, c1, s2, c2) == (200, "image/png", 200, "image/png")
        a, b = decode_png(b1).astype(int), cv2.imdecode(
            np.frombuffer(b2, np.uint8), cv2.IMREAD_UNCHANGED).astype(int)
        assert a.shape == b.shape == size
        assert np.abs(a - b).max() <= 1
        exact += int((a == b).sum())
        total += a.size
    assert exact >= 0.99 * total, exact / total


def test_padding_equal_outside_the_world(servers):
    world, ours, ref = servers
    bbox = _bboxes(world)[-1]  # wholly outside
    query = dict(request="GetMap", layers="imagery", bbox=bbox, width=64,
                 height=48, format="image/png")
    a = decode_png(_get(ours.wms_url, **query)[2])
    b = cv2.imdecode(np.frombuffer(_get(ref.wms_url, **query)[2], np.uint8),
                     cv2.IMREAD_UNCHANGED)
    assert np.array_equal(a, b) and (a == tserver._FALLBACK_GRAY).all()


def test_service_exceptions_and_capabilities(servers):
    world, ours, ref = servers
    bbox = _bboxes(world)[0]
    for query in (dict(request="GetMap", layers="nope", bbox=bbox,
                       width=64, height=64),
                  dict(request="GetMap", layers="imagery", bbox=bbox,
                       width="x", height=64),
                  dict(request="DescribeLayer"),
                  dict(request="GetMap", layers="imagery", bbox=bbox)):
        assert _get(ours.wms_url, **query) == _get(ref.wms_url, **query)
    for query in (dict(request="Nope"), dict(request="GetCapabilities")):
        assert _get(ours.wfst_url, **query) == _get(ref.wfst_url, **query)
    # a bbox of two numbers or an empty raster: the port answers with the
    # GetMap exception (the JAX server's handler raises and drops the
    # connection)
    for bad in (dict(bbox="1,2", width=64, height=64),
                dict(bbox=bbox, width=0, height=64)):
        status, _, body = _get(ours.wms_url, request="GetMap",
                               layers="imagery", **bad)
        assert status == 400 and b"bad GetMap params" in body
    caps, jcaps = (_get(srv.wms_url, request="GetCapabilities")
                   for srv in (ours, ref))
    assert caps[:2] == jcaps[:2] == (200, "application/vnd.ogc.wms_xml")
    assert caps[2] == jcaps[2].replace(
        b"</Format>\n      <Format>image/jpeg</Format>", b"</Format>")
    assert b"jpeg" not in caps[2]
    status, ctype, body = _get(ours.wms_url, request="GetMap",
                               layers="imagery", bbox=bbox, width=64,
                               height=64, format="image/jpeg")
    assert (status, ctype) == (400, "application/vnd.ogc.se_xml")
    assert b"<ServiceExceptionReport" in body and b"InvalidFormat" in body
    assert _get(ref.wms_url, request="GetMap", layers="imagery", bbox=bbox,
                width=64, height=64, format="image/jpeg")[:2] == (
                    200, "image/jpeg")


def _post(url, xml):
    req = urllib.request.Request(url, data=xml.encode(), method="POST",
                                 headers={"Content-Type": "text/xml"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _without_stamps(features_json):
    fc = json.loads(features_json)
    for f in fc["features"]:
        f["properties"].pop("timestamp")
    return fc


def test_wfst_transactions_equal(servers):
    from gisnav_tpu.nodes.wfst_node import (
        wfst_delete_all_xml,
        wfst_insert_xml,
    )

    _, ours, ref = servers
    xmls = [wfst_delete_all_xml(), wfst_insert_xml(24.01, 60.02),
            wfst_insert_xml(24.011, 60.0205), "<wfs:Insert></wfs:Insert>",
            "not xml at all", wfst_insert_xml(-1.5e-3, 1e2),
            '<wfs:Transaction><wfs:Delete typeName="gisnav:other"/>'
            '</wfs:Transaction>']
    for xml in xmls:
        assert _post(ours.wfst_url, xml) == _post(ref.wfst_url, xml)
    assert [r[:3] for r in ours.store.features()] == [
        r[:3] for r in ref.store.features()]
    assert len(ours.store.features()) == 3
    query = dict(service="WFS", version="1.1.0", request="GetFeature",
                 typename="gisnav:position",
                 outputFormat="application/json")
    (s1, c1, j1), (s2, c2, j2) = (_get(srv.wfst_url, **query)
                                  for srv in (ours, ref))
    assert (s1, c1) == (s2, c2) == (200, "application/json")
    assert _without_stamps(j1) == _without_stamps(j2)
    gml = [_get(srv.wfst_url, request="GetFeature",
                typename="gisnav:position")[2] for srv in (ours, ref)]
    stamps = [[r[3] for r in srv.store.features()] for srv in (ours, ref)]
    for body, ts in zip(gml, stamps):
        assert b"gml:coordinates" in body
    assert _scrub(gml[0], stamps[0]) == _scrub(gml[1], stamps[1])
    _post(ours.wfst_url, wfst_delete_all_xml())
    _post(ref.wfst_url, wfst_delete_all_xml())


def _scrub(body, stamps):
    for ts in stamps:
        body = body.replace(ts.encode(), b"TS")
    return body


class _Recorder:
    """An HTTP endpoint that records the bodies posted to it."""

    def __init__(self):
        self.bodies = []
        rec = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_POST(self):
                n = int(self.headers.get("content-length", 0))
                rec.bodies.append((self.headers["content-type"],
                                   self.rfile.read(n)))
                self.send_response(200)
                self.send_header("content-length", "0")
                self.end_headers()

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}/wfst"

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=5.0)


def test_wfst_node_posts_the_jax_bytes():
    pytest.importorskip("requests")
    fixes = [{"lon": int(24.0123456e7), "lat": int(60.0212345e7)},
             {"lon": -1225000001, "lat": 375199999}]
    sent = []
    for make, bus in ((WFSTNode, LocalBus()), (JaxWFSTNode, JaxLocalBus())):
        rec = _Recorder()
        try:
            make(bus, params={"wfst_url": rec.url})
            for fix in fixes:
                bus.publish(TOPIC_SENSOR_GPS, fix)
            sent.append(rec.bodies)
        finally:
            rec.close()
    assert sent[0] == sent[1] and len(sent[0]) == 3
    assert all(ctype == "text/xml" for ctype, _ in sent[0])


def test_wfst_node_into_the_ports_server_and_app_health(servers):
    from gisnav_tpu_torch.nodes.app import GisNavApp

    _, ours, _ = servers
    bus = LocalBus()
    node = WFSTNode(bus, params={"wfst_url": ours.wfst_url})
    bus.publish(TOPIC_SENSOR_GPS, {"lon": int(24.0261e7),
                                   "lat": int(60.0319e7)})
    rows = ours.store.features()
    assert len(rows) == 1 and rows[0][1:3] == pytest.approx(
        (24.0261, 60.0319))
    assert node.name == "wfst_node"
    # a refused endpoint is logged, not raised
    WFSTNode(LocalBus(), params={"wfst_url": "http://127.0.0.1:9/wfst",
                                 "timeout_s": 1.0})
    app = GisNavApp(wfst=True, device="cpu", params={
        "wfst_node": {"wfst_url": ours.wfst_url}})
    try:
        app.wfst.last_activity -= 60.0
        app.pose.last_activity -= 60.0
        report = app.health()
        assert report["wfst_node"]["healthy"]
        assert not report["pose_node"]["healthy"]
        assert app.wfst in app.nodes
    finally:
        app.shutdown()
