"""The port's node-graph pieces against the JAX package's, on the CPU.

- ``TransformGraph``: the cases of ``tests/test_nodes_transport.py`` and
  interpolated lookups equal to the JAX graph's (1e-12);
- ``LocalBus``: synchronous order, the threaded mode's drop-when-full and
  ``close``, and a stress run with more publishers than cores;
- ``fov_bounding_box_enu`` and ``OrthoImageCache`` equal to JAX (1e-12);
- the geoid equal to the JAX package's embedded grid (the JAX package
  prefers a host PROJ grid where one is installed; the port never does),
  and within 1.5 m of the EGM96 values of ``tests/test_fusion_rate.py``;
- ``MockGPSNode.odom_to_fix`` equal to JAX's, field for field;
- the PNG decoder equal to OpenCV's decode of ``cv2.imencode`` output for
  8-bit grey, RGB and RGBA and 16-bit grey under each row filter, colour
  to grey as ``cv2.cvtColor``; JPEG raises naming the format;
- ``WMSClient`` against the loopback stub WMS and against the JAX client.
"""
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

import cv2
import numpy as np
import pytest

from gisnav_tpu.geometry import bbox as jax_bbox
from gisnav_tpu.geometry import geoid as jax_geoid
from gisnav_tpu.gis import cache as jax_cache
from gisnav_tpu.gis import wms as jax_wms
from gisnav_tpu.nodes import mock_gps as jax_mock_gps
from gisnav_tpu.nodes import tf as jax_tf
from gisnav_tpu_torch.geometry import bbox, geoid
from gisnav_tpu_torch.geometry.crs import wgs84_to_ecef
from gisnav_tpu_torch.geometry.quaternion import (
    euler_to_quat,
    matrix_to_quat,
    quat_to_matrix,
)
from gisnav_tpu_torch.geometry.se3 import compose, invert, make_transform
from gisnav_tpu_torch.gis.cache import OrthoImageCache
from gisnav_tpu_torch.gis.png import decode_png, encode_png, to_gray
from gisnav_tpu_torch.gis.wms import WMSClient, request_orthoimage
from gisnav_tpu_torch.nodes import mock_gps
from gisnav_tpu_torch.nodes.bus import LocalBus
from gisnav_tpu_torch.nodes.tf import TransformGraph, TransformLookupError
from gisnav_tpu_torch.utils.world_wms import World, WorldWMS


def _h(yaw=0.0, t=(0, 0, 0)):
    return make_transform(quat_to_matrix(euler_to_quat(0, 0, yaw)),
                          np.array(t))


class TestTransformGraph:
    def test_single_edge_both_directions(self):
        g = TransformGraph()
        h = _h(yaw=0.5, t=(1, 2, 3))
        g.add("map", "base", h, static=True)
        assert np.allclose(g.lookup("map", "base"), h)
        assert np.allclose(g.lookup("base", "map"), invert(h))

    def test_chain_composition(self):
        g = TransformGraph()
        h1, h2 = _h(yaw=0.3, t=(1, 0, 0)), _h(yaw=-0.1, t=(0, 2, 0))
        g.add("map", "odom", h1, static=True)
        g.add("odom", "base", h2, static=True)
        assert np.allclose(g.lookup("map", "base"), compose(h1, h2))
        assert np.allclose(g.lookup("base", "map"), invert(compose(h1, h2)))

    def test_time_interpolation_and_clamp(self):
        g = TransformGraph()
        g.add("map", "base", _h(t=(0, 0, 0)), stamp_us=1_000_000)
        g.add("map", "base", _h(t=(10, 0, 0)), stamp_us=2_000_000)
        assert np.allclose(g.lookup("map", "base", 1_500_000)[:3, 3],
                           [5, 0, 0])
        assert np.allclose(g.lookup("map", "base", 1_250_000)[:3, 3],
                           [2.5, 0, 0])
        assert np.allclose(g.lookup("map", "base", 99_000_000)[:3, 3],
                           [10, 0, 0])
        assert np.allclose(g.lookup("map", "base", 0)[:3, 3], [0, 0, 0])

    def test_missing_path_raises(self):
        g = TransformGraph()
        g.add("map", "odom", np.eye(4), static=True)
        with pytest.raises(TransformLookupError):
            g.lookup("map", "unknown")
        assert not g.can_transform("map", "unknown")
        assert g.can_transform("odom", "map")

    def test_branching_tree(self):
        g = TransformGraph()
        g.add("map", "odom", _h(t=(5, 0, 0)), static=True)
        g.add("odom", "base", _h(t=(0, 5, 0)), static=True)
        g.add("base", "camera", _h(t=(0, 0, 1)), static=True)
        g.add("base", "gimbal", _h(t=(0, 0, -1)), static=True)
        assert np.allclose(g.lookup("map", "camera")[:3, 3], [5, 5, 1])
        assert np.allclose(g.lookup("gimbal", "camera")[:3, 3], [0, 0, 2])

    def test_lookups_equal_jax(self):
        rng = np.random.default_rng(0)
        ours, ref = TransformGraph(), jax_tf.TransformGraph()
        for g in (ours, ref):
            g.add("earth", "map", _h(0.2, (7, 1, 3)), static=True)
        for stamp in range(1_000_000, 3_000_001, 250_000):
            for parent, child in (("map", "odom"), ("odom", "base")):
                h = _h(rng.uniform(-3, 3), rng.normal(0, 50, 3))
                for g in (ours, ref):
                    g.add(parent, child, h, stamp)
        for stamp in rng.integers(500_000, 3_500_000, 20):
            for target, source in (("earth", "base"), ("base", "map")):
                np.testing.assert_allclose(
                    ours.lookup(target, source, int(stamp)),
                    ref.lookup(target, source, int(stamp)), atol=1e-12)


class TestLocalBus:
    def test_sync_dispatch_in_order(self):
        bus, got = LocalBus(), []
        bus.subscribe("/t", lambda m: got.append(("a", m)))
        bus.subscribe("/t", lambda m: got.append(("b", m)))
        bus.publish("/t", 1)
        assert got == [("a", 1), ("b", 1)]

    def test_async_drops_when_full_and_closes(self):
        bus, seen = LocalBus(async_dispatch=True), []

        def slow(msg):
            time.sleep(0.02)
            seen.append(msg)

        bus.subscribe("/t", slow)
        assert not bus._workers  # no thread before the first message
        for i in range(50):
            bus.publish("/t", i)
        deadline = time.monotonic() + 5.0
        while len(seen) + bus.dropped < 50 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert 0 < len(seen) < 50 and len(seen) + bus.dropped == 50
        assert seen == sorted(seen)  # one worker: in order
        threads = [t for _, t in bus._workers]
        bus.close()
        assert threads and not any(t.is_alive() for t in threads)
        bus.publish("/t", 99)  # after close: no subscriber
        time.sleep(0.05)
        assert 99 not in seen

    def test_async_stress_no_lost_message(self):
        """More publishers than cores into one worker that keeps up: each
        message is delivered or counted as dropped, never lost."""
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            bus, seen = LocalBus(async_dispatch=True), []
            bus.subscribe("/t", seen.append)
            n_pub, per = 16, 200

            def publish(k):
                for i in range(per):
                    bus.publish("/t", (k, i))

            pubs = [threading.Thread(target=publish, args=(k,))
                    for k in range(n_pub)]
            for t in pubs:
                t.start()
            for t in pubs:
                t.join(timeout=30.0)
            assert not any(t.is_alive() for t in pubs)
            deadline = time.monotonic() + 10.0
            while len(seen) + bus.dropped < n_pub * per \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
            bus.close()
        finally:
            sys.setswitchinterval(old)
        assert len(seen) + bus.dropped == n_pub * per
        assert len(set(seen)) == len(seen)


def test_fov_bounding_box_and_cache_equal_jax():
    rng = np.random.default_rng(1)
    k = np.array([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]])
    ours_c, ref_c = OrthoImageCache(), jax_cache.OrthoImageCache()
    for _ in range(12):
        roll, pitch = rng.uniform(-0.3, 0.3, 2)
        r = quat_to_matrix(euler_to_quat(np.pi + roll, pitch,
                                         rng.uniform(-np.pi, np.pi)))
        alt = float(rng.uniform(50, 1500))
        lon, lat = float(rng.uniform(-170, 170)), float(rng.uniform(-70, 70))
        got = bbox.fov_bounding_box_enu(k, 640, 480, r, alt, lon, lat)
        want = jax_bbox.fov_bounding_box_enu(k, 640, 480, r, alt, lon, lat)
        assert (got is None) == (want is None)
        if got is None:
            continue
        np.testing.assert_allclose(np.array(got), np.array(want), rtol=0,
                                   atol=1e-12)
        assert ours_c.needs_update(got) == ref_c.needs_update(want)
        img, dem = np.zeros((8, 8), np.uint8), np.zeros((8, 8), np.float32)
        a = ours_c.update(img, dem, got, 5)
        b = ref_c.update(img, dem, want, 5)
        np.testing.assert_allclose(a.crs_affine, b.crs_affine, rtol=1e-15)
        assert a.crs_proj == b.crs_proj
    # looking at the horizon: no ground intersection
    r = quat_to_matrix(euler_to_quat(np.pi / 2, 0, 0))
    assert bbox.fov_bounding_box_enu(k, 640, 480, r, 100, 24, 60) is None


def test_geoid_equals_jax_embedded_grid(monkeypatch):
    monkeypatch.setattr(jax_geoid, "_PROJ_GTX_PATHS", ())
    monkeypatch.setattr(jax_geoid, "_cache", None)
    rng = np.random.default_rng(2)
    for lon, lat in zip(rng.uniform(-200, 200, 50), rng.uniform(-91, 91, 50)):
        assert geoid.geoid_height(lon, lat) == jax_geoid.geoid_height(lon,
                                                                      lat)
    for lon, lat, n in ((-122.25, 37.51, -32.2), (24.94, 60.17, 18.0),
                        (0.0, 51.5, 46.0), (86.93, 27.99, -28.5)):
        assert abs(geoid.geoid_height(lon, lat) - n) < 1.5
    assert abs(geoid.geoid_height(179.99, 10) - geoid.geoid_height(
        -180.01, 10)) < 0.5
    assert np.isnan(geoid.geoid_height(float("nan"), 10.0))


def test_odom_to_fix_equals_jax(monkeypatch):
    monkeypatch.setattr(jax_geoid, "_PROJ_GTX_PATHS", ())
    monkeypatch.setattr(jax_geoid, "_cache", None)
    rng = np.random.default_rng(3)
    lon0, lat0 = 24.03, 60.02
    from gisnav_tpu_torch.geometry.crs import enu_to_ecef_matrix

    h_earth_map = make_transform(enu_to_ecef_matrix(lon0, lat0),
                                 np.array(wgs84_to_ecef(lon0, lat0, 0.0)))
    h_map_odom = _h(0.1, (3.0, -2.0, 0.5))
    nodes = []
    for node_cls, tf_cls in ((mock_gps.UORBNode, TransformGraph),
                             (jax_mock_gps.UORBNode, jax_tf.TransformGraph)):
        tf = tf_cls()
        tf.add("earth", "gisnav_map", h_earth_map, static=True)
        tf.add("gisnav_map", "gisnav_odom", h_map_odom, 1_000_000)
        nodes.append(node_cls(LocalBus(), None, tf))
    for i in range(14):
        cov = np.diag(rng.uniform(0.1, 5.0, 15))
        odom = {
            "stamp_us": 1_000_000 + 100_000 * i, "frame_id": "gisnav_odom",
            "child_frame_id": "gisnav_base_link",
            "position": rng.normal(0, 100, 3) + [0, 0, 500],
            "quat_xyzw": matrix_to_quat(quat_to_matrix(euler_to_quat(
                *rng.uniform(-np.pi, np.pi, 3)))),
            "pose_covariance": cov[:6, :6],
            "twist_covariance": cov[6:12, 6:12],
            "velocity_body": rng.normal(0, 5, 3),
            "angular_velocity_body": rng.normal(0, 0.1, 3),
            "latest_global_match_stamp_us": 1_000_000,
        }
        got, want = (n.odom_to_fix(dict(odom)) for n in nodes)
        assert (got is None) == (want is None) == (i < 9)  # 10-msg warmup
        if got is not None:
            assert got == want
            assert got["satellites_visible"] == 255
    assert nodes[0].odom_to_fix({**odom, "frame_id": "gisnav_map"}) is None


# -- PNG -----------------------------------------------------------------

def _images():
    rng = np.random.default_rng(5)
    g = (np.add.outer(np.arange(37), 3 * np.arange(53)) % 256
         + rng.integers(0, 30, (37, 53))).astype(np.uint8)
    rgb = np.stack([g, np.roll(g, 7, 1), 255 - g], -1)
    return {"grey": g, "rgb": rgb,
            "rgba": np.concatenate([rgb, g[..., None] // 2], -1),
            "grey16": (g.astype(np.uint16) * 257
                       + rng.integers(0, 200, g.shape)).astype(np.uint16)}


def _bgr(img):
    return img if img.ndim == 2 else img[..., [2, 1, 0, 3][:img.shape[2]]]


FILTERS = ["NONE", "SUB", "UP", "AVG", "PAETH", "ALL"]


@pytest.mark.parametrize("flt", FILTERS)
@pytest.mark.parametrize("kind", ["grey", "rgb", "rgba", "grey16"])
def test_png_decode_equals_opencv(kind, flt):
    img = _images()[kind]
    code = (cv2.IMWRITE_PNG_ALL_FILTERS if flt == "ALL"
            else getattr(cv2, f"IMWRITE_PNG_FILTER_{flt}"))
    ok, buf = cv2.imencode(".png", _bgr(img), [cv2.IMWRITE_PNG_FILTER, code])
    assert ok
    got = decode_png(buf.tobytes())
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)
    ref = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)
    if img.ndim == 3:
        flag = (cv2.COLOR_BGRA2GRAY if img.shape[2] == 4
                else cv2.COLOR_BGR2GRAY)
        np.testing.assert_array_equal(to_gray(got), cv2.cvtColor(ref, flag))
    elif img.dtype == np.uint16:
        np.testing.assert_array_equal(
            (got >> 8).astype(np.uint8),
            cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE))


def test_png_encode_roundtrip_and_refusals():
    for img in list(_images().values())[:3]:
        data = encode_png(img)
        np.testing.assert_array_equal(decode_png(data), img)
        np.testing.assert_array_equal(
            _bgr(cv2.imdecode(np.frombuffer(data, np.uint8),
                              cv2.IMREAD_UNCHANGED)), img)
    ok, jpg = cv2.imencode(".jpg", _images()["grey"])
    with pytest.raises(ValueError, match="JPEG"):
        decode_png(jpg.tobytes())
    data = bytearray(encode_png(_images()["grey"]))
    data[44] ^= 0xFF  # inside IDAT's data: the chunk CRC no longer holds
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(data))


# -- WMS -----------------------------------------------------------------

@pytest.fixture(scope="module")
def world_wms():
    world = World.make(seed=3, size_px=512, gsd_m=4.0)
    with WorldWMS(world, dem_value=7) as wms:
        yield world, wms


class _Fixed(BaseHTTPRequestHandler):
    """Replies every GET with ``self.server.reply`` (content type, body)."""

    def log_message(self, *args):
        pass

    def do_GET(self):
        ctype, body = self.server.reply
        self.send_response(200)
        self.send_header("content-type", ctype)
        self.send_header("content-length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def _serve(ctype, body):
    server = HTTPServer(("127.0.0.1", 0), _Fixed)
    server.reply = (ctype, body)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def test_wms_client_against_stub_and_jax(world_wms):
    world, wms = world_wms
    client = WMSClient(wms.url)
    assert client.is_available()
    left, top = world.to_lonlat(-40, 30)  # reaches outside the world
    right, bottom = world.to_lonlat(300, 400)
    bb = (left, bottom, right, top)
    img = client.get_map(["imagery"], bb, (96, 88), format_="image/png")
    np.testing.assert_array_equal(img, world.crop(bb, 96, 88))
    assert (img[:, :5] == 110).all()  # grey padding west of the world
    # the JAX client's default format: the stub's JPEG, as cv2 decodes it
    ok, jpg = cv2.imencode(".jpg", world.crop(bb, 96, 88))
    np.testing.assert_array_equal(client.get_map(["imagery"], bb, (96, 88)),
                                  cv2.imdecode(jpg, cv2.IMREAD_UNCHANGED))
    for fmt in ("image/jpeg", "image/png"):
        got = request_orthoimage(client, bb, (96, 88), ["imagery"], ["dem"],
                                 format_=fmt)
        want = jax_wms.request_orthoimage(jax_wms.WMSClient(wms.url), bb,
                                          (96, 88), ["imagery"], ["dem"],
                                          format_=fmt)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert (got[1] == 7.0).all()


def test_wms_client_failures():
    closed = WMSClient("http://127.0.0.1:9/wms", timeout_s=2.0)
    assert closed.get_map(["imagery"], (0, 0, 1, 1), (8, 8)) is None
    assert not closed.is_available()
    xml = _serve("application/vnd.ogc.se_xml", b"<ServiceException/>")
    ok, jpg = cv2.imencode(".jpg", _images()["rgb"][..., ::-1])
    jpeg = _serve("image/jpeg", jpg.tobytes())
    garbage = _serve("image/jpeg", b"\xff\xd8\xff\xe0 not a JPEG")
    try:
        url = f"http://127.0.0.1:{xml.server_address[1]}/wms"
        assert WMSClient(url).get_map(["x"], (0, 0, 1, 1), (8, 8)) is None
        # a JPEG reply is read (BGR, as cv2.imdecode gives it), whatever
        # format was asked for
        url = f"http://127.0.0.1:{jpeg.server_address[1]}/wms"
        for fmt in ("image/jpeg", "image/png"):
            np.testing.assert_array_equal(
                WMSClient(url).get_map(["x"], (0, 0, 1, 1), (8, 8),
                                       format_=fmt),
                cv2.imdecode(jpg, cv2.IMREAD_UNCHANGED))
        np.testing.assert_array_equal(
            WMSClient(url).get_map(["x"], (0, 0, 1, 1), (8, 8),
                                   grayscale=True),
            cv2.imdecode(jpg, cv2.IMREAD_GRAYSCALE))
        # bytes cv2 cannot decode give None, as in the JAX client
        url = f"http://127.0.0.1:{garbage.server_address[1]}/wms"
        assert WMSClient(url).get_map(["x"], (0, 0, 1, 1), (8, 8)) is None
    finally:
        for server in (xml, jpeg, garbage):
            server.shutdown()
            server.server_close()
