"""u-blox NavPVT message construction (as a plain dict) and framing.

The port's own copy of ``gisnav_tpu/io/ubx.py`` (the same bytes out).
Field-for-field parity with the reference's UBXNode
(``extensions/ubx_node.py:53-161`` in hmakelin/gisnav), including the GPS
time-of-week conversion.
"""
from __future__ import annotations

import time as _time
from typing import Dict, Tuple

import numpy as np

__all__ = ["unix_to_gps_time", "make_nav_pvt", "frame_nav_pvt"]

_GPS_EPOCH_UNIX = 315964800  # 1980-01-06 00:00:00 UTC
_SECONDS_PER_WEEK = 604800


def unix_to_gps_time(unix_time_s: float) -> Tuple[int, float]:
    """POSIX seconds -> (GPS week number, time of week seconds).

    Reference semantics (``ubx_node.py:145-150``): no leap-second offset
    applied (mock GPS only).
    """
    gps_time = unix_time_s - _GPS_EPOCH_UNIX
    return int(gps_time / _SECONDS_PER_WEEK), gps_time % _SECONDS_PER_WEEK


def make_nav_pvt(
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
    s_variance_m_s: float,
    timestamp: int,
    eph: float,
    epv: float,
    satellites_visible: int,
    **_ignored,
) -> Dict:
    """Build a NavPVT message dict from a mock-GPS fix.

    :param lat, lon: degrees * 1e7 (int)
    :param timestamp: microseconds
    :param cog: course over ground, radians
    """
    _, time_of_week = unix_to_gps_time(timestamp / 1e6)
    utc = _time.gmtime(timestamp / 1e6)
    return {
        "i_tow": int(time_of_week * 1000),
        "year": utc.tm_year,
        "month": utc.tm_mon,
        "day": utc.tm_mday,
        "hour": utc.tm_hour,
        "min": utc.tm_min,
        "sec": utc.tm_sec,
        "valid": 0x01 | 0x02 | 0x04,  # date + time + fully resolved
        "t_acc": 50000000,  # ns
        "nano": 0,
        "fix_type": 3,
        "flags": 0x01,  # gnssFixOK
        "flags2": 0,
        "num_sv": int(satellites_visible),
        "lon": int(lon),
        "lat": int(lat),
        "height": int(altitude_ellipsoid * 1e3),  # mm above ellipsoid
        "h_msl": int(altitude_amsl * 1e3),  # mm above MSL
        "h_acc": int(eph * 1e3),  # mm
        "v_acc": int(epv * 1e3),  # mm
        "vel_n": int(vel_n_m_s * 1e3),  # mm/s
        "vel_e": int(vel_e_m_s * 1e3),
        "vel_d": int(vel_d_m_s * 1e3),
        "g_speed": int(float(np.hypot(vel_n_m_s, vel_e_m_s)) * 1e3),
        "heading": int(float(np.degrees(cog)) * 1e5),  # deg * 1e-5
        "s_acc": int(s_variance_m_s * 1e3),  # mm/s
        "head_acc": int(float(np.degrees(h_variance_rad)) * 1e5),
        "p_dop": 0,
        "head_veh": int(yaw_degrees * 1e5),
    }


def frame_nav_pvt(pvt: Dict) -> bytes:
    """Serialize a :func:`make_nav_pvt` dict to a framed UBX binary message.

    UBX-NAV-PVT (class 0x01, id 0x07, 92-byte little-endian payload) with
    the 8-bit Fletcher checksum over class/id/length/payload — the wire
    format a u-blox serial driver (ArduPilot/PX4 GPS_TYPE u-blox) parses.
    The reference publishes ublox_msgs over ROS and relies on an external
    serial bridge; this framing is what a serial bridge writes to the
    autopilot's serial GPS port.
    """
    import struct

    payload = struct.pack(
        "<LHBBBBBBLlBBBBllllLLlllllLLHB5slhH",
        pvt["i_tow"] & 0xFFFFFFFF,
        pvt["year"], pvt["month"], pvt["day"],
        pvt["hour"], pvt["min"], pvt["sec"],
        pvt["valid"],
        pvt["t_acc"],
        pvt["nano"],
        pvt["fix_type"],
        pvt["flags"],
        pvt["flags2"],
        pvt["num_sv"],
        pvt["lon"], pvt["lat"],
        pvt["height"], pvt["h_msl"],
        pvt["h_acc"], pvt["v_acc"],
        pvt["vel_n"], pvt["vel_e"], pvt["vel_d"],
        pvt["g_speed"],
        pvt["heading"],
        pvt["s_acc"], pvt["head_acc"],
        pvt["p_dop"],
        0,  # flags3
        b"\x00" * 5,  # reserved1
        pvt.get("head_veh", 0),
        0,  # magDec (deg * 1e-2)
        0,  # magAcc
    )
    assert len(payload) == 92, len(payload)
    body = b"\x01\x07" + len(payload).to_bytes(2, "little") + payload
    ck_a = ck_b = 0
    for byte in body:
        ck_a = (ck_a + byte) & 0xFF
        ck_b = (ck_b + ck_a) & 0xFF
    return b"\xb5\x62" + body + bytes((ck_a, ck_b))
