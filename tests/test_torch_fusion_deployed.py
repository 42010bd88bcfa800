"""The port's fusion node and mock-GPS node against the JAX package's, fed
as the deployed graph feeds them (``chip_smoke.py`` path 10), on the CPU.

One stamped feed drives both packages' ``FusionNode`` (UKF global filter,
VO local filter) and ``UORBNode`` on synchronous buses, each with its own
transform graph: a 20-step lead-in and 24 steps on path 10's line (30 m a
second, 500 m up, the yaw alternating 22.5 +- 1.5 degrees), a frame a
second. At a frame the VO pose (odom frame: the truth plus a random-walk
drift) comes first, then the pose fix (map frame), whose error falls from
190 m over the lead-in's first five fixes (the deployed graph's fixes
against a map still loading) to about 3 m; one gated fix is an outlier
the innovation gate rejects. Between frames the 5 Hz output timer ticks
at 200, 400, 600 and 800 ms. Every odometry message and every published
``SensorGps`` fix, lead-in included, is compared: the same stamps,
odometry positions within 1 mm (measured 0.12 mm), fixes within one step
of their integer latitude and longitude (1e-7 degree, 1.1 cm; measured
1.24 cm horizontally, the rounding of positions that agree to 0.12 mm) and
10 mm of ellipsoid altitude (measured 4 mm).
"""
import numpy as np
import pytest
import torch

from gisnav_tpu.geometry import geoid as jax_geoid
from gisnav_tpu.geometry.crs import enu_to_ecef_matrix, wgs84_to_ecef
from gisnav_tpu.geometry.quaternion import euler_to_quat
from gisnav_tpu.geometry.se3 import make_transform
from gisnav_tpu.nodes import bus as jax_bus
from gisnav_tpu.nodes import fusion_node as jax_fusion
from gisnav_tpu.nodes import mock_gps as jax_mock_gps
from gisnav_tpu.nodes import tf as jax_tf
from gisnav_tpu_torch.nodes import bus, fusion_node, mock_gps, tf
from gisnav_tpu_torch.nodes.fusion_node import TOPIC_ODOMETRY
from gisnav_tpu_torch.nodes.mock_gps import TOPIC_SENSOR_GPS

torch.set_num_threads(2)

LEAD, GATED = 20, 24  # path 10: DEPLOY_LEAD_STEPS, GRAPH_STEPS
STEP_US, SPEED_MS, ALT_M = 1_000_000, 30.0, 500.0
LON0, LAT0 = 24.03, 60.02
LEAD_ERRORS_M = (190.0, 120.0, 60.0, 25.0, 10.0)
OUTLIER_STEP = LEAD + 9


def _feed():
    """[(kind, stamp_us, payload)]: "vo" / "pose" messages and "tick"s."""
    rng = np.random.default_rng(10)
    drift = np.zeros(3)
    events = []
    for i in range(LEAD + GATED):
        stamp = 1_000_000 + i * STEP_US
        truth = np.array([SPEED_MS * i, 0.0, ALT_M])
        yaw = np.radians(22.5 + 1.5 * (-1) ** i)
        quat = np.asarray(euler_to_quat(*rng.normal(0, 0.01, 2), yaw),
                          np.float64)
        drift = drift + rng.normal(0, 0.3, 3)
        vo_cov = np.diag([0.5, 0.5, 0.5, 0.01, 0.01, 0.01]) ** 2
        events.append(("vo", stamp, {
            "stamp_us": stamp, "position": truth + drift
            + rng.normal(0, 0.2, 3), "quat_xyzw": quat,
            "covariance": vo_cov}))
        err = rng.normal(0, 3.0, 3)
        if i < len(LEAD_ERRORS_M):
            direction = rng.normal(size=2)
            err[:2] = LEAD_ERRORS_M[i] * direction / np.linalg.norm(direction)
        if i == OUTLIER_STEP:
            err[:2] += 150.0
        pose_cov = np.diag([3.0, 3.0, 3.0, 0.02, 0.02, 0.02]) ** 2
        events.append(("pose", stamp, {
            "stamp_us": stamp, "position": truth + err,
            "quat_xyzw": quat, "covariance": pose_cov}))
        events += [("tick", stamp + k * 200_000, None) for k in range(1, 5)]
    return events


def _graph(fusion_mod, gps_mod, tf_mod, bus_mod, global_filter, **kw):
    graph = tf_mod.TransformGraph()
    graph.add("earth", "gisnav_map", make_transform(
        enu_to_ecef_matrix(LON0, LAT0),
        np.array(wgs84_to_ecef(LON0, LAT0, 0.0))), static=True)
    b = bus_mod.LocalBus()
    node = fusion_mod.FusionNode(b, {"global_filter": global_filter}, graph,
                                 **kw)
    gps_mod.UORBNode(b, {"geoid_offset_m": 0.0}, graph)
    odometry, fixes = [], []
    b.subscribe(TOPIC_ODOMETRY, odometry.append)
    b.subscribe(TOPIC_SENSOR_GPS, fixes.append)
    return node, odometry, fixes


def _fly(node, feed):
    for kind, stamp, msg in feed:
        if kind == "vo":
            node._twist_pose_cb(dict(msg))
        elif kind == "pose":
            node._pose_cb(dict(msg))
        else:
            node.tick(stamp)


@pytest.mark.parametrize("global_filter", ["ukf", "ekf"])
def test_deployed_feed_fixes_equal_jax(monkeypatch, global_filter):
    monkeypatch.setattr(jax_geoid, "_PROJ_GTX_PATHS", ())
    monkeypatch.setattr(jax_geoid, "_cache", None)
    feed = _feed()
    ours = _graph(fusion_node, mock_gps, tf, bus, global_filter,
                  device="cpu")
    ref = _graph(jax_fusion, jax_mock_gps, jax_tf, jax_bus, global_filter)
    _fly(ours[0], feed)
    _fly(ref[0], feed)
    (_, odo, fixes), (_, odo_ref, fixes_ref) = ours, ref
    assert [m["stamp_us"] for m in odo] == [m["stamp_us"] for m in odo_ref]
    assert len(odo) == (LEAD + GATED) * 5
    for a, b in zip(odo, odo_ref):
        np.testing.assert_allclose(a["position"], b["position"], atol=1e-3)
    stamps = [f["timestamp_sample"] for f in fixes]
    assert stamps == [f["timestamp_sample"] for f in fixes_ref]
    assert len(fixes) == len(odo) - 9  # the mock GPS's 10-message warm-up
    assert stamps[0] < 1_000_000 + LEAD * STEP_US  # lead-in fixes compared
    for a, b in zip(fixes, fixes_ref):  # lat/lon in 1e-7 degrees, alt mm
        assert abs(a["lat"] - b["lat"]) <= 1 and abs(a["lon"] - b["lon"]) <= 1
        assert abs(a["alt_ellipsoid"] - b["alt_ellipsoid"]) <= 10, (a, b)
