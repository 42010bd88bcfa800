"""PX4 uORB SensorGps message construction (as a plain dict).

The port's own copy of ``gisnav_tpu/io/uorb.py``. Field-for-field parity
with the reference's UORBNode (``extensions/uorb_node.py:33-113`` in
hmakelin/gisnav), which targets
px4_msgs release/1.14. The node layer maps this dict onto whatever transport
is available (px4_msgs publisher, uXRCE-DDS bridge, JSON debug sink).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["make_sensor_gps", "SENSOR_GPS_DEVICE_ID"]

SENSOR_GPS_DEVICE_ID = 11469064
"""DRV_GPS_DEVTYPE_SIM (0xAF) + dev 1 + bus 1 + DeviceBusType_UNKNOWN
(reference ``uorb_node.py:102-113``)."""


def make_sensor_gps(
    lat: int,
    lon: int,
    altitude_ellipsoid: float,
    altitude_amsl: float,
    yaw_degrees: float,
    h_variance_rad: float,
    vel_n_m_s: float,
    vel_e_m_s: float,
    vel_d_m_s: float,
    cog: float,
    cog_variance_rad: float,
    s_variance_m_s: float,
    timestamp: int,
    eph: float,
    epv: float,
    satellites_visible: int,
    **_ignored,
) -> Dict:
    """Build a SensorGps message dict from a mock-GPS fix.

    :param lat, lon: degrees * 1e7 (int)
    :param timestamp: microseconds
    :param cog: course over ground, radians
    """
    return {
        "timestamp": 0,
        "timestamp_sample": int(timestamp),
        "device_id": 0,
        "fix_type": 3,
        "s_variance_m_s": float(s_variance_m_s),
        "c_variance_rad": float(cog_variance_rad),
        "lat": int(lat),
        "lon": int(lon),
        "alt_ellipsoid": int(altitude_ellipsoid * 1e3),
        "alt": int(altitude_amsl * 1e3),
        "eph": float(eph),
        "epv": float(epv),
        "hdop": 0.0,
        "vdop": 0.0,
        "noise_per_ms": 0,
        "automatic_gain_control": 0,
        "jamming_state": 0,
        "jamming_indicator": 0,
        "spoofing_state": 0,
        "vel_m_s": float(np.sqrt(vel_n_m_s**2 + vel_e_m_s**2 + vel_d_m_s**2)),
        "vel_n_m_s": float(vel_n_m_s),
        "vel_e_m_s": float(vel_e_m_s),
        "vel_d_m_s": float(vel_d_m_s),
        "cog_rad": float(cog),
        "vel_ned_valid": True,
        "timestamp_time_relative": 0,
        "satellites_used": int(satellites_visible),
        "time_utc_usec": int(timestamp),
        "heading": float(np.radians(yaw_degrees)),
        "heading_offset": 0.0,
        "heading_accuracy": float(h_variance_rad),
    }
