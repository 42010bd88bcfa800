"""WGS84 math on the host (numpy, float64).

The port's own copy of what it needs from ``gisnav_tpu/geometry/crs.py``:
ellipsoid constants, geodetic -> ECEF, the ENU -> ECEF rotation, haversine
distance and the pixel -> WGS84 raster affine.
"""
from __future__ import annotations

import numpy as np

__all__ = ["WGS84_A", "WGS84_E2", "wgs84_to_ecef", "enu_to_ecef_matrix",
           "haversine_m", "pixel_to_wgs84_affine"]

WGS84_A = 6378137.0  # semi-major axis [m]
WGS84_F = 1.0 / 298.257223563  # flattening
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
    width_m = haversine_m(bottom, left, bottom, right)
    height_m = haversine_m(bottom, left, top, left)
    perimeter_m = 2.0 * width_m + 2.0 * height_m
    aff[2, 2] = -perimeter_m / (2.0 * height + 2.0 * width)
    return aff
