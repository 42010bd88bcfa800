"""Mock-GPS output nodes: odometry -> uORB SensorGps / NMEA / u-blox NavPVT.

The port's own copy of ``gisnav_tpu/nodes/mock_gps.py`` (host numpy). The
geoid is the port's shipped EGM96 grid (``geometry.geoid``). Capability
parity with the reference's MockGPSNode hierarchy
(``extensions/_mock_gps_node.py`` + ``uorb_node.py`` / ``nmea_node.py`` /
``ubx_node.py`` in hmakelin/gisnav): only ``gisnav_odom``-frame odometry is
converted, publishing starts after a 10-message warmup, positions go through
``gisnav_odom -> earth`` (tf) to WGS84, heading/COG follow the NED
conventions, and ``satellites_visible`` stays 255 as the GISNav fingerprint.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from gisnav_tpu_torch.constants import (
    NMEA_NODE_NAME,
    ROS_NAMESPACE,
    ROS_TOPIC_RELATIVE_NAV_PVT,
    ROS_TOPIC_RELATIVE_NMEA_SENTENCE,
    ROS_TOPIC_SENSOR_GPS,
    UBX_NODE_NAME,
    UORB_NODE_NAME,
)
from gisnav_tpu_torch.geometry.crs import ecef_to_wgs84
from gisnav_tpu_torch.geometry.geoid import geoid_height
from gisnav_tpu_torch.geometry.quaternion import quat_to_euler, quat_to_matrix
from gisnav_tpu_torch.io.nmea import sentences_for_fix
from gisnav_tpu_torch.io.ubx import make_nav_pvt
from gisnav_tpu_torch.io.uorb import make_sensor_gps
from gisnav_tpu_torch.nodes.base import Node
from gisnav_tpu_torch.nodes.fusion_node import TOPIC_ODOMETRY

__all__ = ["MockGPSNode", "UORBNode", "NMEANode", "UBXNode",
           "TOPIC_SENSOR_GPS", "TOPIC_NMEA_SENTENCE", "TOPIC_NAV_PVT"]

TOPIC_SENSOR_GPS = ROS_TOPIC_SENSOR_GPS
TOPIC_NMEA_SENTENCE = (
    f"/{ROS_NAMESPACE}/{NMEA_NODE_NAME}/"
    + ROS_TOPIC_RELATIVE_NMEA_SENTENCE.replace("~/", "")
)
TOPIC_NAV_PVT = (
    f"/{ROS_NAMESPACE}/{UBX_NODE_NAME}/"
    + ROS_TOPIC_RELATIVE_NAV_PVT.replace("~/", "")
)

_WARMUP_MESSAGES = 10  # reference _mock_gps_node.py:33-39


class MockGPSNode(Node):
    """Base: converts filtered odometry into the mock-GPS fix dict."""

    def __init__(self, name, bus, params=None, tf=None):
        super().__init__(name, bus, params, tf)
        self._counter = 0
        # AMSL conversion: the embedded EGM96 geoid grid by default
        # (matching the reference's pyproj EPSG:5773 transform,
        # ``_mock_gps_node.py:57-65``); a constant ``geoid_offset_m`` param
        # overrides it (e.g. to match a simulator's flat vertical datum)
        self._geoid_offset_m = self.param("geoid_offset_m", None)
        if self._geoid_offset_m is not None:
            self._geoid_offset_m = float(self._geoid_offset_m)
        self.subscribe(TOPIC_ODOMETRY, self._odometry_cb)

    def _undulation(self, lon: float, lat: float) -> float:
        if self._geoid_offset_m is not None:
            return self._geoid_offset_m
        return geoid_height(lon, lat)

    def _odometry_cb(self, msg) -> None:
        fix = self.odom_to_fix(msg)
        if fix is not None:
            self._publish_fix(fix)

    def odom_to_fix(self, odom) -> Optional[dict]:
        if odom["frame_id"] != "gisnav_odom":
            # only VO-frame odometry may drive GPS output
            # (reference _mock_gps_node.py:350-356)
            return None
        self._counter += 1
        if self._counter < _WARMUP_MESSAGES:
            return None
        if self.tf is None or not self.tf.can_transform("earth", "gisnav_odom"):
            self.log.warning("no earth->gisnav_odom transform yet")
            return None
        # transform at the latest global match stamp (avoids interpolating in
        # the sparse map frame, reference _mock_gps_node.py:108-117)
        stamp = odom.get("latest_global_match_stamp_us") or odom["stamp_us"]
        h_earth_odom = self.tf.lookup("earth", "gisnav_odom", stamp)

        pos_ecef = (h_earth_odom @ np.append(odom["position"], 1.0))[:3]
        lon, lat, alt_ellipsoid = ecef_to_wgs84(*pos_ecef)
        if not (np.isfinite(lon) and np.isfinite(lat)
                and np.isfinite(alt_ellipsoid)):
            # fail-soft like every other node: a transient non-finite
            # transform (filter re-initialization) must drop the fix, not
            # crash the output node (int(nan) in the scaled-integer fields)
            self.log.warning("non-finite geopose at %d; fix dropped",
                             odom["stamp_us"])
            return None
        alt_amsl = alt_ellipsoid - self._undulation(lon, lat)

        cov = np.asarray(odom["pose_covariance"])
        eph = float(np.sqrt(cov[0, 0] + cov[1, 1]))
        epv = float(np.sqrt(cov[2, 2]))
        # cov[5,5] IS already the yaw variance (rad^2). The reference squares
        # it again (``_mock_gps_node.py`` heading-variance path), a unit
        # error that deflates the autopilot's heading variance whenever
        # cov[5,5] < 1; ``strict_reference_variance`` restores bug-for-bug
        # parity (the JAX package's docs/parity.md)
        h_variance_rad = float(cov[5, 5])
        if self.param("strict_reference_variance", False):
            h_variance_rad = float(cov[5, 5] ** 2)

        # velocity: body frame -> odom(ENU-aligned) -> NED
        r_ob = quat_to_matrix(np.asarray(odom["quat_xyzw"]))
        v_enu = r_ob @ np.asarray(odom["velocity_body"])
        vel_n, vel_e, vel_d = v_enu[1], v_enu[0], -v_enu[2]

        # heading: ENU yaw -> NED compass degrees in (0, 360]
        _, _, yaw_enu = quat_to_euler(np.asarray(odom["quat_xyzw"]))
        yaw_ned = -yaw_enu
        if yaw_ned < 0:
            yaw_ned += 2 * np.pi
        yaw_ned += np.pi / 2
        yaw_degrees = int(np.degrees(yaw_ned) % 360)
        yaw_degrees = 360 if yaw_degrees == 0 else yaw_degrees  # 0 := invalid

        cog = float(np.arctan2(vel_e, vel_n) % (2 * np.pi))
        tcov = np.asarray(odom["twist_covariance"])
        vel_n_var, vel_e_var, vel_d_var = tcov[1, 1], tcov[0, 0], tcov[2, 2]
        s_variance = float(vel_n_var + vel_e_var + vel_d_var)
        speed_sq = vel_n**2 + vel_e**2
        cog_variance = float(
            (vel_e_var * vel_n**2 + vel_n_var * vel_e**2)
            / max(speed_sq**2, 1e-6)
        )

        return {
            "lat": int(lat * 1e7),
            "lon": int(lon * 1e7),
            "altitude_ellipsoid": float(alt_ellipsoid),
            "altitude_amsl": float(alt_amsl),
            "yaw_degrees": yaw_degrees,
            "h_variance_rad": h_variance_rad,
            "vel_n_m_s": float(vel_n),
            "vel_e_m_s": float(vel_e),
            "vel_d_m_s": float(vel_d),
            "cog": cog,
            "cog_variance_rad": cog_variance,
            "s_variance_m_s": s_variance,
            "timestamp": int(odom["stamp_us"]),
            "eph": eph,
            "epv": epv,
            "satellites_visible": 255,
        }

    def _publish_fix(self, fix: dict) -> None:
        raise NotImplementedError


class UORBNode(MockGPSNode):
    """PX4 uORB SensorGps output (``/fmu/in/sensor_gps``)."""

    def __init__(self, bus, params=None, tf=None):
        super().__init__(UORB_NODE_NAME, bus, params, tf)

    def _publish_fix(self, fix: dict) -> None:
        self.publish(TOPIC_SENSOR_GPS, make_sensor_gps(**fix))


class NMEANode(MockGPSNode):
    """NMEA sentence output (serial bridge feeds PX4's nmea driver)."""

    def __init__(self, bus, params=None, tf=None):
        super().__init__(NMEA_NODE_NAME, bus, params, tf)
        self._include_velocity = bool(self.param("include_velocity", False))

    def _publish_fix(self, fix: dict) -> None:
        for sentence in sentences_for_fix(
            include_velocity=self._include_velocity, **fix
        ):
            self.publish(TOPIC_NMEA_SENTENCE,
                         {"stamp_us": fix["timestamp"], "sentence": sentence})


class UBXNode(MockGPSNode):
    """u-blox NavPVT output."""

    def __init__(self, bus, params=None, tf=None):
        super().__init__(UBX_NODE_NAME, bus, params, tf)

    def _publish_fix(self, fix: dict) -> None:
        self.publish(TOPIC_NAV_PVT, make_nav_pvt(**fix))
