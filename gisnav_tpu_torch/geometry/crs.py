"""WGS84 math on the host (numpy, float64).

The port's own copy of what it needs from ``gisnav_tpu/geometry/crs.py``:
ellipsoid constants, geodetic <-> ECEF (Vermeille's closed form back), the
ENU -> ECEF rotation, haversine distance, the pixel -> WGS84 raster affine
and its ``+proj=affine`` wire codec (the orthoimage message's ``crs``).
"""
from __future__ import annotations

import numpy as np

__all__ = ["WGS84_A", "WGS84_F", "WGS84_B", "WGS84_E2", "wgs84_to_ecef",
           "ecef_to_wgs84", "enu_to_ecef_matrix", "haversine_m",
           "bbox_perimeter_meters", "affine_to_proj", "proj_to_affine",
           "pixel_to_wgs84_affine"]

WGS84_A = 6378137.0  # semi-major axis [m]
WGS84_F = 1.0 / 298.257223563  # flattening
WGS84_B = WGS84_A * (1.0 - WGS84_F)  # semi-minor axis [m]
WGS84_E2 = WGS84_F * (2.0 - WGS84_F)  # first eccentricity squared
EARTH_MEAN_RADIUS_M = 6371000.0


def wgs84_to_ecef(lon, lat, alt):
    """Geodetic (lon, lat degrees, ellipsoidal alt m) -> ECEF metres."""
    lon = np.radians(np.asarray(lon, dtype=np.float64))
    lat = np.radians(np.asarray(lat, dtype=np.float64))
    alt = np.asarray(alt, dtype=np.float64)
    slat, clat = np.sin(lat), np.cos(lat)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * slat * slat)
    return ((n + alt) * clat * np.cos(lon), (n + alt) * clat * np.sin(lon),
            (n * (1.0 - WGS84_E2) + alt) * slat)


def ecef_to_wgs84(x, y, z):
    """ECEF metres -> (lon deg, lat deg, ellipsoidal alt m), Vermeille's
    (2002) closed form (sub-millimetre from the surface to LEO)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    z = np.asarray(z, dtype=np.float64)
    e4 = WGS84_E2 * WGS84_E2
    p = (x * x + y * y) / (WGS84_A * WGS84_A)
    q = (1.0 - WGS84_E2) * z * z / (WGS84_A * WGS84_A)
    r = (p + q - e4) / 6.0
    s = e4 * p * q / (4.0 * r ** 3)
    t = np.cbrt(1.0 + s + np.sqrt(s * (2.0 + s)))
    u = r * (1.0 + t + 1.0 / t)
    v = np.sqrt(u * u + e4 * q)
    w = WGS84_E2 * (u + v - q) / (2.0 * v)
    k = np.sqrt(u + v + w * w) - w
    d = k * np.hypot(x, y) / (k + WGS84_E2)
    hyp = np.hypot(d, z)
    lat = 2.0 * np.arctan2(z, d + hyp)
    alt = (k + WGS84_E2 - 1.0) / k * hyp
    return np.degrees(np.arctan2(y, x)), np.degrees(lat), alt


def enu_to_ecef_matrix(lon, lat) -> np.ndarray:
    """Rotation taking local ENU vectors at (lon, lat) to ECEF."""
    lon = np.radians(float(lon))
    lat = np.radians(float(lat))
    slat, clat = np.sin(lat), np.cos(lat)
    slon, clon = np.sin(lon), np.cos(lon)
    return np.array([[-slon, -slat * clon, clat * clon],
                     [clon, -slat * slon, clat * slon],
                     [0.0, clat, slat]])


def haversine_m(lat1, lon1, lat2, lon2) -> float:
    """Great-circle distance in metres on the mean-radius sphere."""
    lat1, lon1, lat2, lon2 = (np.radians(float(v))
                              for v in (lat1, lon1, lat2, lon2))
    a = (np.sin((lat2 - lat1) / 2) ** 2
         + np.cos(lat1) * np.cos(lat2) * np.sin((lon2 - lon1) / 2) ** 2)
    return float(EARTH_MEAN_RADIUS_M * 2.0
                 * np.arctan2(np.sqrt(a), np.sqrt(1.0 - a)))


def bbox_perimeter_meters(left, bottom, right, top) -> float:
    """Perimeter of a WGS84 bounding box in metres (haversine edges)."""
    return 2.0 * haversine_m(bottom, left, bottom, right) \
        + 2.0 * haversine_m(bottom, left, top, left)


def affine_to_proj(m: np.ndarray) -> str:
    """A (3, 4) or (4, 4) pixel -> WGS84 affine as a ``+proj=affine`` PROJ
    string (translation in ``+xoff/+yoff/+zoff``, the linear part in
    ``+sIJ``), the reference's wire format."""
    m = np.asarray(m, dtype=np.float64)
    if m.shape not in ((3, 4), (4, 4)):
        raise ValueError(f"affine of shape {m.shape}")
    return (f"+proj=affine "
            f"+xoff={m[0, 3]} +yoff={m[1, 3]} +zoff={m[2, 3]} "
            f"+s11={m[0, 0]} +s12={m[0, 1]} +s13={m[0, 2]} "
            f"+s21={m[1, 0]} +s22={m[1, 1]} +s23={m[1, 2]} "
            f"+s31={m[2, 0]} +s32={m[2, 1]} +s33={m[2, 2]} "
            f"+no_defs +type=crs +datum=WGS84")


def proj_to_affine(proj_str: str) -> np.ndarray:
    """Inverse of :func:`affine_to_proj`: the (3, 4) matrix."""
    vals = dict(token.partition("=")[::2] for token in proj_str.split()
                if token.startswith("+") and "=" in token)

    def f(key):
        return float(vals[key])

    return np.array([[f("+s11"), f("+s12"), f("+s13"), f("+xoff")],
                     [f("+s21"), f("+s22"), f("+s23"), f("+yoff")],
                     [f("+s31"), f("+s32"), f("+s33"), f("+zoff")]])


def pixel_to_wgs84_affine(height: int, width: int, left: float,
                          bottom: float, right: float,
                          top: float) -> np.ndarray:
    """(4, 4) affine: orthoimage pixel (x east, y south, z) -> (lon, lat,
    metres); the z scale is the bbox perimeter ratio with a sign flip (the
    raster frame is East-South-Down)."""
    aff = np.eye(4)
    aff[0, 0] = (right - left) / float(width - 1)
    aff[1, 1] = (bottom - top) / float(height - 1)
    aff[0, 3] = left
    aff[1, 3] = top
    aff[2, 2] = -bbox_perimeter_meters(left, bottom, right, top) / (
        2.0 * height + 2.0 * width)
    return aff
