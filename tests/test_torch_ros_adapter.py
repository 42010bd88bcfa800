"""The port's ROS adapter against the JAX package's, both driven by the
fake ``rclpy`` stack of ``tests/test_ros_adapter.py``.

- The same topic surface: inbound subscriptions, outbound publishers for
  every protocol subset, the MAVROS parameter push (and its fail-soft skip
  of a missing service).
- Inbound conversions give equal bus messages: mono8 images, ``bgr8``
  colour images to grey exactly (the port uses ``gis/png.py`` ``to_gray``,
  the JAX adapter ``cv2.cvtColor``), camera info, NavSatFix and the gimbal
  quaternion reordered to xyzw.
- Outbound conversions fill equal ROS message fields (SensorGps, NMEA
  sentence, NavPVT).
- ``close`` wakes ``spin`` and destroys the node; without ``rclpy``,
  ``maybe_attach`` returns ``None``.
"""
import sys
import threading
import time

import cv2
import numpy as np
import pytest

from gisnav_tpu.nodes import ros_adapter as jros
from gisnav_tpu.nodes.bus import LocalBus as JaxLocalBus
from gisnav_tpu_torch.constants import (
    ROS_TOPIC_CAMERA_INFO,
    ROS_TOPIC_IMAGE,
    ROS_TOPIC_MAVROS_GIMBAL_DEVICE_ATTITUDE_STATUS,
    ROS_TOPIC_MAVROS_GLOBAL_POSITION,
    ROS_TOPIC_SENSOR_GPS,
)
from gisnav_tpu_torch.nodes import ros_adapter as tros
from gisnav_tpu_torch.nodes.bus import LocalBus
from gisnav_tpu_torch.nodes.mock_gps import TOPIC_NAV_PVT, TOPIC_NMEA_SENTENCE
from tests.test_ros_adapter import (  # noqa: F401 - fake_ros is a fixture
    FakeCameraInfo,
    FakeGimbalStatus,
    FakeImage,
    FakeNavSatFix,
    FakeRclpyNode,
    _Quat,
    fake_ros,
)

PROTOCOLS = ("uorb", "nmea", "ubx")


def _pair(protocols=PROTOCOLS):
    """(port adapter, its bus), (JAX adapter, its bus)."""
    ours, ref = LocalBus(), JaxLocalBus()
    return ((tros.RosAdapter(ours, protocols=protocols), ours),
            (jros.RosAdapter(ref, protocols=protocols), ref))


def _inbound(adapter, bus, topic, msg):
    got = []
    bus.subscribe(topic, got.append)
    adapter.node.subs[topic][1](msg)
    return got


def _fields(msg):
    """A fake ROS message's fields, its header by value."""
    out = dict(vars(msg))
    if "header" in out:
        h = out["header"]
        out["header"] = (h.frame_id, h.stamp.sec, h.stamp.nanosec)
    return out


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray) or isinstance(b[k], np.ndarray):
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
        else:
            assert a[k] == b[k] and type(a[k]) is type(b[k])


@pytest.mark.parametrize("protocols", [PROTOCOLS, ("uorb",), ("nmea",),
                                       ("ubx",), ("nmea", "ubx")])
def test_topic_surface_equal(fake_ros, protocols):
    (ours, _), (ref, _) = _pair(protocols)
    assert {t: m for t, (m, _) in ours.node.subs.items()} == {
        t: m for t, (m, _) in ref.node.subs.items()}
    assert set(ours.node.subs) == {
        ROS_TOPIC_IMAGE, ROS_TOPIC_CAMERA_INFO,
        ROS_TOPIC_MAVROS_GLOBAL_POSITION,
        ROS_TOPIC_MAVROS_GIMBAL_DEVICE_ATTITUDE_STATUS}
    assert {t: p.msg_type for t, p in ours.node.pubs.items()} == {
        t: p.msg_type for t, p in ref.node.pubs.items()}


def test_mavros_parameter_push_equal(fake_ros, monkeypatch):
    def pushed(adapter):
        return {name: [[(p.name, p.value.type, p.value.bool_value,
                         p.value.string_value) for p in r.parameters]
                       for r in cli.requests]
                for name, cli in adapter.node.clients.items()}

    (ours, _), (ref, _) = _pair()
    assert pushed(ours) == pushed(ref) and len(pushed(ours)) == 2
    monkeypatch.setattr(FakeRclpyNode, "unavailable_services",
                        ("/mavros/gimbal_control/set_parameters",))
    (ours, _), (ref, _) = _pair()
    assert pushed(ours) == pushed(ref)
    assert ours.node.get_logger().warnings == ref.node.get_logger().warnings


def test_inbound_messages_equal(fake_ros):
    rng = np.random.default_rng(5)
    gray = rng.integers(0, 256, (48, 64)).astype(np.uint8)
    bgr = rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
    bgra = rng.integers(0, 256, (48, 64, 4)).astype(np.uint8)
    k = [400.0, 0.0, 320.0, 0.0, 400.0, 240.0, 0.0, 0.0, 1.0]
    cases = [
        (ROS_TOPIC_IMAGE, FakeImage(48, 64, "mono8", gray.tobytes(), sec=2,
                                    nanosec=500_000)),
        (ROS_TOPIC_IMAGE, FakeImage(48, 64, "8UC1", gray.tobytes())),
        (ROS_TOPIC_IMAGE, FakeImage(48, 64, "bgr8", bgr.tobytes(), sec=3)),
        (ROS_TOPIC_IMAGE, FakeImage(48, 64, "rgb8", bgr.tobytes(), sec=4)),
        (ROS_TOPIC_IMAGE, FakeImage(48, 64, "bgra8", bgra.tobytes())),
        (ROS_TOPIC_CAMERA_INFO, FakeCameraInfo(k, 640, 480)),
        (ROS_TOPIC_MAVROS_GLOBAL_POSITION,
         FakeNavSatFix(60.02, 24.03, 512.5, sec=7, nanosec=250)),
        (ROS_TOPIC_MAVROS_GIMBAL_DEVICE_ATTITUDE_STATUS,
         FakeGimbalStatus(_Quat(w=0.1, x=0.2, y=0.3, z=0.4), sec=9)),
    ]
    for topic, msg in cases:
        (ours, obus), (ref, rbus) = _pair()
        a = _inbound(ours, obus, topic, msg)
        b = _inbound(ref, rbus, topic, msg)
        assert len(a) == len(b) == 1
        _equal(a[0], b[0])
    # the colour image's grey is OpenCV's, exactly
    (ours, obus), _ = _pair()
    got = _inbound(ours, obus, ROS_TOPIC_IMAGE,
                   FakeImage(48, 64, "bgr8", bgr.tobytes()))
    np.testing.assert_array_equal(got[0]["image"],
                                  cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY))


def test_outbound_fields_equal(fake_ros):
    (ours, obus), (ref, rbus) = _pair()
    outputs = [
        (ROS_TOPIC_SENSOR_GPS, {"lat": 600200000, "lon": 240300000,
                                "alt_ellipsoid": 512500,
                                "satellites_used": 255, "eph": 2.5,
                                "timestamp_sample": 17, "vel_m_s": 3.5,
                                "not_a_px4_field": "ignored"}),
        (TOPIC_NMEA_SENTENCE, {"stamp_us": 1, "sentence": "$GPGGA,x*00"}),
        (TOPIC_NAV_PVT, {"lat": 600200000, "lon": 240300000,
                         "i_tow": 12345, "extra": 1}),
    ]
    for topic, payload in outputs:
        obus.publish(topic, dict(payload))
        rbus.publish(topic, dict(payload))
        a, b = ours.node.pubs[topic].published, ref.node.pubs[topic].published
        assert len(a) == len(b) == 1
        assert type(a[0]) is type(b[0])
        assert _fields(a[0]) == _fields(b[0])


def test_close_wakes_spin_and_destroys_node(fake_ros):
    (ours, _), _ = _pair()
    t = threading.Thread(target=ours.spin, daemon=True)
    t.start()
    deadline = time.monotonic() + 5.0
    while getattr(ours, "_executor", None) is None:
        assert time.monotonic() < deadline, "spin never started"
        time.sleep(0.01)
    ours.close()
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert getattr(ours.node, "destroyed", False)
    ours.close()  # idempotent


def test_without_rclpy_maybe_attach_returns_none(monkeypatch):
    monkeypatch.setitem(sys.modules, "rclpy", None)  # import raises
    assert not tros.ros_available()
    assert tros.maybe_attach(LocalBus()) is None
    with pytest.raises(ImportError):
        tros.RosAdapter(LocalBus())
