"""Bounding-box logic: FOV ground projection, squaring/padding, overlap gating.

Host-side numpy; the port's own copy of ``gisnav_tpu/geometry/bbox.py``.
Covers the reference's BBoxNode geometry (``core/bbox_node.py:154-365`` in
hmakelin/gisnav) and the shapely-based overlap gate of GISNode
(``core/gis_node.py:451-487``) without shapely.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from gisnav_tpu_torch.geometry.tm import enu_offset_to_wgs84

__all__ = [
    "BBox",
    "bbox_overlap_fraction",
    "project_fov_to_ground",
    "square_and_pad",
    "fov_bounding_box_enu",
]


class BBox(NamedTuple):
    """WGS84 bounding box, same field layout as the reference's namedtuple
    (``_transformations.py:24``)."""

    left: float  # min longitude
    bottom: float  # min latitude
    right: float  # max longitude
    top: float  # max latitude


def bbox_overlap_fraction(new: BBox, old: BBox) -> float:
    """Intersection area as a fraction of ``new``'s area.

    Used to gate WMS map refreshes: the reference requests a new map only when
    this drops below 0.85 (``core/gis_node.py:124-128,451-487``). Plain
    interval math replaces shapely's ``box(...).intersection``.
    """
    ix = max(0.0, min(new.right, old.right) - max(new.left, old.left))
    iy = max(0.0, min(new.top, old.top) - max(new.bottom, old.bottom))
    area_new = (new.right - new.left) * (new.top - new.bottom)
    if area_new <= 0:
        return 0.0
    return (ix * iy) / area_new


def project_fov_to_ground(
    k: np.ndarray, width: int, height: int, r_enu: np.ndarray, altitude_agl: float
) -> Optional[np.ndarray]:
    """Project the camera FOV corners and principal point onto the ground.

    Assumes a flat ground plane at z=0 in a local ENU frame whose origin sits
    directly below the camera (camera at (0, 0, altitude_agl)). Rays through
    the four image corners and the principal point are intersected with the
    plane. Reference semantics:
    ``_fov_and_principal_point_on_ground_plane`` (``core/bbox_node.py:161-222``).

    :param k: 3x3 camera intrinsics
    :param r_enu: 3x3 rotation taking camera-optical-frame vectors to ENU
    :param altitude_agl: camera height above ground in meters
    :return: (5, 2) ENU meters: top-left, top-right, bottom-right,
        bottom-left corners then principal point; or None if any ray does not
        hit the ground ahead of the camera.
    """
    k = np.asarray(k, dtype=np.float64).reshape(3, 3)
    img_points = np.array(
        [
            [0.0, 0.0, 1.0],
            [width - 1.0, 0.0, 1.0],
            [width - 1.0, height - 1.0, 1.0],
            [0.0, height - 1.0, 1.0],
            [width / 2.0, height / 2.0, 1.0],
        ]
    )
    try:
        k_inv = np.linalg.inv(k)
    except np.linalg.LinAlgError:
        return None
    d_cam = img_points @ k_inv.T  # rays in camera frame
    d_enu = d_cam @ np.asarray(r_enu, dtype=np.float64).T
    dz = d_enu[:, 2]
    if np.any(dz >= -1e-12):  # ray parallel to or away from ground
        return None
    t = -altitude_agl / dz
    cam = np.array([0.0, 0.0, altitude_agl])
    ground = cam[None, :] + t[:, None] * d_enu
    return ground[:, :2]


def square_and_pad(enu_coords: np.ndarray) -> np.ndarray:
    """Make the FOV's axis-aligned bounds square and pad by one side length.

    Reference semantics: ``_square_bounding_box`` (``core/bbox_node.py:
    262-307``) — equalize the east/north extents around the center, then pad
    by the (post-squaring) side length on every side so arbitrary camera yaw
    never clips the FOV and map refreshes stay rare.

    :param enu_coords: (N, 2) ENU meter coordinates to enclose
    :return: (4, 2) corners bottom-left, bottom-right, top-right, top-left
    """
    enu_coords = np.asarray(enu_coords, dtype=np.float64)
    min_e, min_n = enu_coords.min(axis=0)
    max_e, max_n = enu_coords.max(axis=0)
    delta_e, delta_n = max_e - min_e, max_n - min_n
    if delta_e > delta_n:
        half = (delta_e - delta_n) / 2.0
        min_n, max_n = min_n - half, max_n + half
    elif delta_n > delta_e:
        half = (delta_n - delta_e) / 2.0
        min_e, max_e = min_e - half, max_e + half
    pad = max_n - min_n
    return np.array(
        [
            [min_e - pad, min_n - pad],
            [max_e + pad, min_n - pad],
            [max_e + pad, max_n + pad],
            [min_e - pad, max_n + pad],
        ]
    )


def fov_bounding_box_enu(
    k: np.ndarray,
    width: int,
    height: int,
    r_enu: np.ndarray,
    altitude_agl: float,
    origin_lon: float,
    origin_lat: float,
) -> Optional[BBox]:
    """Full BBoxNode pipeline: FOV ground projection -> square+pad -> WGS84.

    Combines :func:`project_fov_to_ground`, :func:`square_and_pad` and the UTM
    meter-offset conversion (``core/bbox_node.py:154-365``).
    """
    ground = project_fov_to_ground(k, width, height, r_enu, altitude_agl)
    if ground is None:
        return None
    corners_enu = square_and_pad(ground[:4])
    lon, lat = enu_offset_to_wgs84(
        origin_lon, origin_lat, corners_enu[:, 0], corners_enu[:, 1]
    )
    return BBox(
        left=float(np.min(lon)),
        bottom=float(np.min(lat)),
        right=float(np.max(lon)),
        top=float(np.max(lat)),
    )
