"""NMEA 0183 sentence rendering (no pynmea2 dependency).

The port's own copy of ``gisnav_tpu/io/nmea.py`` (the same bytes out).
Capability parity with the reference's NMEANode sentence set
(``extensions/nmea_node.py:107-504`` in hmakelin/gisnav): GGA, VTG, GSA, HDT,
GST, RMC, ZDA and the 12-dummy-satellite GSV block. Sentences carry proper
``*XX`` checksums. Like the reference, VTG/RMC velocities are rendered but
PX4's nmea.cpp zeroes ``s_variance`` when velocity is consumed — callers
decide whether to emit them (``nmea_node.py:152-156``).
"""
from __future__ import annotations

from datetime import datetime, timezone
from functools import reduce
from typing import List

import numpy as np

__all__ = [
    "nmea_checksum",
    "render_sentence",
    "decimal_to_nmea",
    "format_time",
    "format_date",
    "make_gga",
    "make_vtg",
    "make_gsa",
    "make_hdt",
    "make_gst",
    "make_rmc",
    "make_zda",
    "make_gsv",
    "sentences_for_fix",
]


def nmea_checksum(payload: str) -> str:
    """XOR checksum over the characters between ``$`` and ``*``, as two
    uppercase hex digits."""
    return f"{reduce(lambda a, b: a ^ b, (ord(c) for c in payload), 0):02X}"


def render_sentence(talker: str, formatter: str, fields: List[str]) -> str:
    """Assemble ``$TTFFF,f1,f2,...*CS``."""
    payload = ",".join([f"{talker}{formatter}", *fields])
    return f"${payload}*{nmea_checksum(payload)}"


def decimal_to_nmea(degrees: float) -> str:
    """Decimal degrees -> ``(d)ddmm.mmmm`` (sign dropped; reference
    ``_decimal_to_nmea``, ``nmea_node.py:419-430``)."""
    d = int(degrees)
    m = abs(degrees - d) * 60.0
    return f"{abs(d):02d}{m:07.4f}"


def format_time(timestamp_us: int) -> str:
    """Microsecond POSIX timestamp -> ``HHMMSS.mmm`` UTC."""
    dt = datetime.fromtimestamp(timestamp_us / 1e6, tz=timezone.utc)
    return dt.strftime("%H%M%S.%f")[:10]


def format_date(timestamp_us: int) -> str:
    """Microsecond POSIX timestamp -> ``YYMMDD`` UTC."""
    return datetime.fromtimestamp(
        timestamp_us / 1e6, tz=timezone.utc
    ).strftime("%y%m%d")


def make_gga(timestamp_us: int, lat_deg: float, lon_deg: float,
             altitude_amsl: float, hdop: float = 0.0) -> str:
    return render_sentence("GP", "GGA", [
        format_time(timestamp_us),
        decimal_to_nmea(lat_deg), "N" if lat_deg >= 0 else "S",
        decimal_to_nmea(lon_deg), "E" if lon_deg >= 0 else "W",
        "1", "12", f"{hdop:.2f}", f"{altitude_amsl:.1f}", "M",
        "0.0", "M", "", "",
    ])


def make_vtg(cog_deg: float, ground_speed_knots: float) -> str:
    return render_sentence("GP", "VTG", [
        f"{cog_deg:.1f}", "T", "", "M",
        f"{ground_speed_knots:.1f}", "N", "", "K",
    ])


def make_gsa(pdop: float = 0.0, hdop: float = 0.0, vdop: float = 0.0) -> str:
    sats = [str(i).zfill(2) for i in range(12)]
    return render_sentence("GP", "GSA", [
        "A", "3", *sats, f"{pdop:.2f}", f"{hdop:.2f}", f"{vdop:.2f}",
    ])


def make_hdt(yaw_deg: float) -> str:
    return render_sentence("GP", "HDT", [f"{yaw_deg:.1f}", "T"])


def make_gst(timestamp_us: int, rms: float, sd_major: float, sd_minor: float,
             orient: float, sd_lat: float, sd_lon: float, sd_alt: float) -> str:
    return render_sentence("GP", "GST", [
        format_time(timestamp_us), f"{rms:.2f}", f"{sd_major:.2f}",
        f"{sd_minor:.2f}", f"{orient:.1f}", f"{sd_lat:.2f}",
        f"{sd_lon:.2f}", f"{sd_alt:.2f}",
    ])


def make_rmc(timestamp_us: int, lat_deg: float, lon_deg: float,
             ground_speed_knots: float, cog_deg: float) -> str:
    status = "A" if lat_deg and lon_deg else "V"
    return render_sentence("GP", "RMC", [
        format_time(timestamp_us), status,
        decimal_to_nmea(lat_deg), "N" if lat_deg >= 0 else "S",
        decimal_to_nmea(lon_deg), "E" if lon_deg >= 0 else "W",
        f"{ground_speed_knots:.1f}", f"{cog_deg:.1f}",
        format_date(timestamp_us), "0.0", "E",
    ])


def make_zda(timestamp_us: int, tz_hour: int = 0, tz_minute: int = 0) -> str:
    dt = datetime.fromtimestamp(timestamp_us / 1e6, tz=timezone.utc)
    return render_sentence("GP", "ZDA", [
        dt.strftime("%H%M%S"), dt.strftime("%d"), dt.strftime("%m"),
        dt.strftime("%Y"), str(tz_hour), str(tz_minute),
    ])


def make_gsv() -> List[str]:
    """12 statically defined dummy satellites, one per GSV message
    (reference ``nmea_node.py:432-504``)."""
    sats = [
        (f"{i + 1:02d}", "85", f"{i * 30:03d}", "99") for i in range(12)
    ]
    return [
        render_sentence("GP", "GSV", [str(len(sats)), str(i + 1), "12", *sat])
        for i, sat in enumerate(sats)
    ]


def sentences_for_fix(
    lat: int,
    lon: int,
    altitude_amsl: float,
    timestamp: int,
    vel_n_m_s: float,
    vel_e_m_s: float,
    yaw_degrees: float,
    cog: float,
    eph: float,
    epv: float,
    include_velocity: bool = True,
    **_ignored,
) -> List[str]:
    """Render the full sentence block for one mock-GPS fix.

    Args mirror the reference's MockGPSDict (lat/lon in 1e7 degrees, cog in
    radians; ``nmea_node.py:107-170``).
    """
    lat_deg, lon_deg = lat / 1e7, lon / 1e7
    gs_knots = float(np.hypot(vel_n_m_s, vel_e_m_s) * 1.94384)
    rms = float(np.sqrt(eph**2 + epv**2))
    sd_h = float(np.sqrt(eph**2 / 2))
    out = [
        make_gga(timestamp, lat_deg, lon_deg, altitude_amsl),
    ]
    if include_velocity:
        out.append(make_vtg(float(np.degrees(cog)), gs_knots))
    out += [
        make_gsa(),
        make_hdt(float(yaw_degrees)),
        make_gst(timestamp, rms, eph, eph, 0.0, sd_h, sd_h, float(epv**2)),
    ]
    if include_velocity:
        out.append(make_rmc(timestamp, lat_deg, lon_deg, gs_knots,
                            float(np.degrees(cog))))
    out += make_gsv()
    # reference publishes ZDA with every fix (nmea_node.py:166-170)
    out.append(make_zda(timestamp))
    return out
