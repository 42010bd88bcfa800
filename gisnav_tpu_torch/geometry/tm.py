"""Transverse Mercator / UTM projection (numpy, host-side; no PROJ).

The port's own copy of ``gisnav_tpu/geometry/tm.py``: the UTM round-trip
that converts local ENU metre offsets to WGS84 (the reference's
``core/bbox_node.py:224-260`` in hmakelin/gisnav).
Implements Karney-style Krüger series to 6th order in the third flattening;
round-trip accuracy is sub-millimeter within UTM zone extents.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from gisnav_tpu_torch.geometry.crs import WGS84_A, WGS84_F

__all__ = ["utm_zone", "wgs84_to_utm", "utm_to_wgs84", "enu_offset_to_wgs84"]

_K0 = 0.9996  # UTM scale factor on the central meridian
_FALSE_EASTING = 500000.0
_FALSE_NORTHING_SOUTH = 10000000.0

# Third flattening and rectifying radius
_N = WGS84_F / (2.0 - WGS84_F)
_N2, _N3, _N4, _N5, _N6 = _N**2, _N**3, _N**4, _N**5, _N**6
_A_RECT = WGS84_A / (1.0 + _N) * (1.0 + _N2 / 4.0 + _N4 / 64.0 + _N6 / 256.0)

# Krüger series coefficients (Karney 2011, eqs. 35-36), 6th order in n.
_ALPHA = np.array(
    [
        _N / 2 - 2 * _N2 / 3 + 5 * _N3 / 16 + 41 * _N4 / 180 - 127 * _N5 / 288
        + 7891 * _N6 / 37800,
        13 * _N2 / 48 - 3 * _N3 / 5 + 557 * _N4 / 1440 + 281 * _N5 / 630
        - 1983433 * _N6 / 1935360,
        61 * _N3 / 240 - 103 * _N4 / 140 + 15061 * _N5 / 26880
        + 167603 * _N6 / 181440,
        49561 * _N4 / 161280 - 179 * _N5 / 168 + 6601661 * _N6 / 7257600,
        34729 * _N5 / 80640 - 3418889 * _N6 / 1995840,
        212378941 * _N6 / 319334400,
    ]
)
_BETA = np.array(
    [
        _N / 2 - 2 * _N2 / 3 + 37 * _N3 / 96 - _N4 / 360 - 81 * _N5 / 512
        + 96199 * _N6 / 604800,
        _N2 / 48 + _N3 / 15 - 437 * _N4 / 1440 + 46 * _N5 / 105
        - 1118711 * _N6 / 3870720,
        17 * _N3 / 480 - 37 * _N4 / 840 - 209 * _N5 / 4480 + 5569 * _N6 / 90720,
        4397 * _N4 / 161280 - 11 * _N5 / 504 - 830251 * _N6 / 7257600,
        4583 * _N5 / 161280 - 108847 * _N6 / 3991680,
        20648693 * _N6 / 638668800,
    ]
)


def utm_zone(lon_deg: float) -> int:
    """UTM zone number for a longitude (same formula as the reference,
    ``bbox_node.py:235-237``)."""
    return int((float(lon_deg) + 180.0) / 6.0) + 1


def _central_meridian_deg(zone: int) -> float:
    return (zone - 1) * 6.0 - 180.0 + 3.0


def wgs84_to_utm(lon, lat, zone: int | None = None) -> Tuple[np.ndarray, np.ndarray, int]:
    """WGS84 (lon, lat degrees) -> UTM (easting, northing meters, zone).

    Northern-hemisphere false northing is 0; southern adds 10,000 km, matching
    standard UTM (and pyproj ``proj=utm``) conventions.
    """
    lon = np.asarray(lon, dtype=np.float64)
    lat = np.asarray(lat, dtype=np.float64)
    if zone is None:
        zone = utm_zone(float(np.atleast_1d(lon)[0]))
    lam0 = np.radians(_central_meridian_deg(zone))
    phi = np.radians(lat)
    lam = np.radians(lon) - lam0

    # Conformal latitude
    e = np.sqrt(WGS84_F * (2.0 - WGS84_F))
    t = np.sinh(
        np.arctanh(np.sin(phi)) - e * np.arctanh(e * np.sin(phi))
    )
    xi_p = np.arctan2(t, np.cos(lam))
    eta_p = np.arcsinh(np.sin(lam) / np.hypot(t, np.cos(lam)))

    j = np.arange(1, 7)
    xi = xi_p + np.sum(
        _ALPHA * np.sin(2.0 * np.outer(np.atleast_1d(xi_p), j))
        * np.cosh(2.0 * np.outer(np.atleast_1d(eta_p), j)),
        axis=-1,
    ).reshape(np.shape(xi_p))
    eta = eta_p + np.sum(
        _ALPHA * np.cos(2.0 * np.outer(np.atleast_1d(xi_p), j))
        * np.sinh(2.0 * np.outer(np.atleast_1d(eta_p), j)),
        axis=-1,
    ).reshape(np.shape(eta_p))

    easting = _FALSE_EASTING + _K0 * _A_RECT * eta
    northing = _K0 * _A_RECT * xi
    northing = np.where(lat < 0, northing + _FALSE_NORTHING_SOUTH, northing)
    return easting, northing, zone


def utm_to_wgs84(easting, northing, zone: int, south: bool = False
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """UTM (easting, northing meters, zone) -> WGS84 (lon, lat degrees)."""
    easting = np.asarray(easting, dtype=np.float64)
    northing = np.asarray(northing, dtype=np.float64)
    if south:
        northing = northing - _FALSE_NORTHING_SOUTH
    xi = northing / (_K0 * _A_RECT)
    eta = (easting - _FALSE_EASTING) / (_K0 * _A_RECT)

    j = np.arange(1, 7)
    xi_p = xi - np.sum(
        _BETA * np.sin(2.0 * np.outer(np.atleast_1d(xi), j))
        * np.cosh(2.0 * np.outer(np.atleast_1d(eta), j)),
        axis=-1,
    ).reshape(np.shape(xi))
    eta_p = eta - np.sum(
        _BETA * np.cos(2.0 * np.outer(np.atleast_1d(xi), j))
        * np.sinh(2.0 * np.outer(np.atleast_1d(eta), j)),
        axis=-1,
    ).reshape(np.shape(eta))

    chi = np.arcsin(np.sin(xi_p) / np.cosh(eta_p))  # conformal latitude
    lam = np.arctan2(np.sinh(eta_p), np.cos(xi_p))

    # Invert conformal latitude -> geodetic latitude by fixed-point iteration
    e = np.sqrt(WGS84_F * (2.0 - WGS84_F))
    phi = chi
    for _ in range(8):
        phi = np.arcsin(
            np.tanh(np.arctanh(np.sin(chi)) + e * np.arctanh(e * np.sin(phi)))
        )

    lon = np.degrees(lam) + _central_meridian_deg(zone)
    lat = np.degrees(phi)
    return lon, lat


def enu_offset_to_wgs84(origin_lon: float, origin_lat: float,
                        east_m, north_m) -> Tuple[np.ndarray, np.ndarray]:
    """Offset a WGS84 origin by local ENU meters, returning (lon, lat) arrays.

    Same UTM round-trip strategy as the reference's ``_enu_to_latlon``
    (``core/bbox_node.py:224-260``): project origin to UTM, add offsets in
    meters, unproject.
    """
    zone = utm_zone(origin_lon)
    e0, n0, _ = wgs84_to_utm(origin_lon, origin_lat, zone)
    south = origin_lat < 0
    return utm_to_wgs84(
        e0 + np.asarray(east_m, dtype=np.float64),
        n0 + np.asarray(north_m, dtype=np.float64),
        zone,
        south=south,
    )
