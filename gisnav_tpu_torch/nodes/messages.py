"""Wire message shapes for the node graph (plain dicts of numpy arrays).

The port's own copy of ``gisnav_tpu/nodes/messages.py``. The reference uses
ROS message types (sensor_msgs, geometry_msgs, custom ``gisnav_msgs``);
this graph uses documented dict payloads with the same information content,
so messages map 1:1 onto ROS types.
"""
from __future__ import annotations

import time
from typing import TypedDict

import numpy as np

from gisnav_tpu_torch.geometry.bbox import BBox

__all__ = [
    "Image",
    "CameraInfo",
    "NavSatFix",
    "GimbalAttitude",
    "BoundingBoxMsg",
    "OrthoImageMsg",
    "PoseMsg",
    "OdometryMsg",
    "stamp_us_now",
]


class Image(TypedDict):
    """``sensor_msgs/Image`` equivalent (grayscale)."""

    stamp_us: int
    frame_id: str
    image: np.ndarray  # (H, W) uint8


class CameraInfo(TypedDict):
    """``sensor_msgs/CameraInfo`` equivalent."""

    k: np.ndarray  # (3, 3)
    width: int
    height: int


class NavSatFix(TypedDict):
    """``sensor_msgs/NavSatFix`` equivalent."""

    stamp_us: int
    lat: float  # degrees
    lon: float  # degrees
    alt_ellipsoid: float  # meters


class GimbalAttitude(TypedDict):
    """Camera-optical orientation in the local ENU frame."""

    stamp_us: int
    quat_xyzw: np.ndarray  # (4,) camera_optical -> ENU


class BoundingBoxMsg(TypedDict):
    """``geographic_msgs/BoundingBox`` equivalent."""

    stamp_us: int
    bbox: BBox


class OrthoImageMsg(TypedDict):
    """``gisnav_msgs/OrthoImage`` equivalent: imagery + DEM + CRS atomically."""

    stamp_us: int
    image: np.ndarray  # (H, W) uint8
    dem: np.ndarray  # (H, W) float32 meters
    bbox: BBox
    crs: str  # +proj=affine PROJ string (pixel -> WGS84)


class PoseMsg(TypedDict):
    """``geometry_msgs/PoseWithCovarianceStamped`` equivalent."""

    stamp_us: int
    frame_id: str
    position: np.ndarray  # (3,)
    quat_xyzw: np.ndarray  # (4,)
    covariance: np.ndarray  # (6, 6)


class OdometryMsg(TypedDict):
    """``nav_msgs/Odometry`` equivalent."""

    stamp_us: int
    frame_id: str
    child_frame_id: str
    position: np.ndarray  # (3,)
    quat_xyzw: np.ndarray  # (4,)
    pose_covariance: np.ndarray  # (6, 6)
    velocity_body: np.ndarray  # (3,)
    angular_velocity_body: np.ndarray  # (3,)
    twist_covariance: np.ndarray  # (6, 6)


def stamp_us_now() -> int:
    """The current wall-clock time in integer microseconds, the stamp unit
    of every message."""
    return int(time.time() * 1e6)
