"""PoseNode: global pose from the camera frame against the orthoimage.

Counterpart of ``gisnav_tpu/nodes/pose_node.py`` (the reference PoseNode,
``core/pose_node.py:186-497`` in hmakelin/gisnav): match the frame against
the current map raster, solve PnP, bootstrap the ``earth -> gisnav_map``
frame on the first valid fix, and publish the pose in the ``gisnav_map``
frame with the reference covariance template. Backends, through the port's
runners (on the card unless ``device="cpu"``):

- ``classical`` (the default): the port's SIFT + MNN + RANSAC-PnP;
- ``deep``: a bundled weight set (``weights``, default ``learned_lg9``) in
  ``deep_mode`` ``warp-bucketed`` (the default), ``warp`` or ``cached``;
  the bundle's config replaces the node's (480x640, 512 keypoints);
- ``semidense``: the LoFTR runner.

Written departures: a missing bundle raises (the JAX node logs it and falls
back to the classical backend), and ``dev_topics=True`` raises
``NotImplementedError`` (the match images of ``viz.py`` are not ported).
"""
from __future__ import annotations

import inspect
from typing import Optional

import numpy as np

from gisnav_tpu_torch.constants import (
    POSE_NODE_NAME,
    ROS_NAMESPACE,
    ROS_TOPIC_CAMERA_INFO,
    ROS_TOPIC_IMAGE,
    ROS_TOPIC_MAVROS_GIMBAL_DEVICE_ATTITUDE_STATUS,
    ROS_TOPIC_MAVROS_GLOBAL_POSITION,
    ROS_TOPIC_RELATIVE_POSE,
)
from gisnav_tpu_torch.device import resolve_device
from gisnav_tpu_torch.geometry.crs import (
    enu_to_ecef_matrix,
    proj_to_affine,
    wgs84_to_ecef,
)
from gisnav_tpu_torch.geometry.quaternion import matrix_to_quat, quat_to_matrix
from gisnav_tpu_torch.geometry.se3 import invert, make_transform
from gisnav_tpu_torch.nodes.base import Node
from gisnav_tpu_torch.nodes.gis_node import TOPIC_ORTHOIMAGE
from gisnav_tpu_torch.pipeline.classical import classical_frame_to_geopose
from gisnav_tpu_torch.pipeline.geopose import (
    PipelineConfig,
    geopose_to_wgs84_f64,
)
from gisnav_tpu_torch.utils.devlock import device_lock

__all__ = ["PoseNode", "TOPIC_POSE"]

TOPIC_POSE = (
    f"/{ROS_NAMESPACE}/{POSE_NODE_NAME}/"
    + ROS_TOPIC_RELATIVE_POSE.replace("~/", "")
)

# reference covariance template: 3 m position SD, ~3 deg angle SD
# (core/_shared.py:8-23)
_POSE_COV = np.diag([9.0, 9.0, 9.0] + [np.radians(3.0) ** 2] * 3)


def _bundled_runner(name: str, mode: str, derotate: bool, device):
    """(runner, config) of a bundled weight set in a deep mode; raises
    ``FileNotFoundError`` when the bundle is missing."""
    from gisnav_tpu_torch.pipeline.runners import (
        make_bucketed_warp_runner,
        make_cached_deep_runner,
        make_deep_runner,
    )
    from gisnav_tpu_torch.weights import load_bundled

    params, config = load_bundled(name)
    if mode == "warp-bucketed":
        runner = make_bucketed_warp_runner(params, config, device=device)
    elif mode == "warp":
        runner = make_deep_runner(params, config, device=device)
    elif mode == "cached":
        runner = make_cached_deep_runner(params, config, derotate=derotate,
                                         device=device)
    else:
        raise ValueError(f"unknown deep_mode {mode!r}")
    return runner, config


class PoseNode(Node):
    """Publishes the global pose in the ``gisnav_map`` frame."""

    def __init__(self, bus, params=None, tf=None, deep_runner=None, *,
                 device=None):
        super().__init__(POSE_NODE_NAME, bus, params, tf)
        if self.param("dev_topics", False):
            raise NotImplementedError(
                "dev_topics: the match and position images are not ported")
        self._device = resolve_device(device)
        self._camera_info = None
        self._ortho = None
        self._attitude = None
        self._map_origin = None  # (H_earth_map 4x4, lon, lat)
        self._config = PipelineConfig(
            image_shape=tuple(self.param("image_shape", (480, 640))),
            max_keypoints=int(self.param("max_keypoints", 1024)),
            min_matches=int(self.param("min_matches", 15)),
        )
        backend = self.param("backend")
        self._deep_runner = deep_runner
        if deep_runner is None and backend == "semidense":
            from gisnav_tpu_torch.pipeline.runners import make_semidense_runner

            self._deep_runner = make_semidense_runner(
                params=self.param("semidense_params", None),
                device=self._device)
        elif deep_runner is None and backend == "deep":
            self._deep_runner, self._config = _bundled_runner(
                self.param("weights", "learned_lg9"),
                self.param("deep_mode", "warp-bucketed"),
                bool(self.param("derotate_query", False)), self._device)
        elif backend not in (None, "classical", "deep", "semidense"):
            raise ValueError(f"unknown pose backend {backend!r}")
        takes = set()
        if self._deep_runner is not None:
            try:
                takes = set(inspect.signature(self._deep_runner).parameters)
            except (TypeError, ValueError):
                pass
        self._runner_takes_map_stamp = "map_stamp" in takes
        self._runner_takes_altitude = "altitude_agl" in takes
        self._runner_takes_prior = "prior_lonlat" in takes
        self._altitude_agl = None
        self._prior_lonlat = None
        self.subscribe(ROS_TOPIC_CAMERA_INFO, self._camera_info_cb)
        self.subscribe(TOPIC_ORTHOIMAGE, self._orthoimage_cb)
        self.subscribe(
            ROS_TOPIC_MAVROS_GIMBAL_DEVICE_ATTITUDE_STATUS, self._attitude_cb
        )
        self.subscribe(ROS_TOPIC_MAVROS_GLOBAL_POSITION, self._nav_fix_cb)
        self.subscribe(ROS_TOPIC_IMAGE, self._image_cb)

    # -- inputs ------------------------------------------------------------

    def _camera_info_cb(self, msg):
        self._camera_info = msg

    def _nav_fix_cb(self, msg):
        # the rough altitude sets the runners' GSD match; the rough lon/lat
        # the cached runner's position prior
        self._altitude_agl = float(msg.get("alt_ellipsoid", 0.0)) - float(
            self.param("ground_altitude_m", 0.0))
        if "lon" in msg and "lat" in msg:
            self._prior_lonlat = (float(msg["lon"]), float(msg["lat"]))

    def _orthoimage_cb(self, msg):
        self._ortho = msg

    def _attitude_cb(self, msg):
        self._attitude = msg

    # -- core --------------------------------------------------------------

    def _image_cb(self, msg) -> None:
        pose = self.estimate(msg)
        if pose is not None:
            self.publish(TOPIC_POSE, pose)

    def _rotation_deg(self) -> float:
        """Map-alignment rotation: rotate the north-up reference raster by
        this angle (CCW, y down) so its content matches the camera image.
        Image-up in ENU is the camera_optical frame's -y axis; the angle is
        its compass bearing ``atan2(up_east, up_north)``."""
        if self._attitude is None:
            return 0.0
        r = quat_to_matrix(np.asarray(self._attitude["quat_xyzw"]))
        up = -r[:, 1]
        return float(np.degrees(np.arctan2(up[0], up[1])))

    def estimate(self, image_msg) -> Optional[dict]:
        if self._ortho is None or self._camera_info is None:
            return None
        query = image_msg["image"]
        h, w = self._config.image_shape
        if query.shape != (h, w):
            self.log.warning("frame shape %s != configured %s", query.shape,
                             (h, w))
            return None
        aff4 = np.eye(4)
        aff4[:3, :] = proj_to_affine(self._ortho["crs"])
        with device_lock:
            if self._deep_runner is not None:
                kw = {}
                if self._runner_takes_map_stamp:
                    kw["map_stamp"] = self._ortho.get("stamp_us")
                if self._runner_takes_altitude:
                    kw["altitude_agl"] = self._altitude_agl
                if self._runner_takes_prior:
                    kw["prior_lonlat"] = self._prior_lonlat
                geopose = self._deep_runner(
                    query, self._ortho["image"], self._ortho["dem"],
                    self._rotation_deg(), self._camera_info["k"], aff4, **kw)
            else:
                geopose = classical_frame_to_geopose(
                    query, self._ortho["image"], self._ortho["dem"],
                    self._rotation_deg(), self._camera_info["k"], aff4,
                    self._config, device=self._device)
            if not bool(geopose.valid):
                self.log.debug("no valid pose (%d matches)",
                               int(geopose.num_matches))
                return None
            out = geopose_to_wgs84_f64(geopose, aff4)
        return self._to_map_frame(image_msg["stamp_us"], out)

    # -- frame bootstrap ---------------------------------------------------

    def _to_map_frame(self, stamp_us: int, wgs84: dict) -> dict:
        """Bootstrap ``earth -> gisnav_map`` (local ENU at the first fix,
        on the ellipsoid) and express the camera pose in it (reference
        ``pose_node.py:389-473``)."""
        ecef = np.asarray(wgs84["ecef"])
        if self._map_origin is None:
            r = enu_to_ecef_matrix(wgs84["lon"], wgs84["lat"])
            origin = np.array(wgs84_to_ecef(wgs84["lon"], wgs84["lat"], 0.0))
            h_earth_map = make_transform(r, origin)
            self._map_origin = (h_earth_map, wgs84["lon"], wgs84["lat"])
            if self.tf is not None:
                self.tf.add("earth", "gisnav_map", h_earth_map, stamp_us,
                            static=True)
        h_earth_map = self._map_origin[0]
        pos_map = (invert(h_earth_map) @ np.append(ecef, 1.0))[:3]
        return {
            "stamp_us": int(stamp_us),
            "frame_id": "gisnav_map",
            "position": pos_map,
            "quat_xyzw": matrix_to_quat(np.asarray(wgs84["r_enu_cam"])),
            "covariance": _POSE_COV.copy(),
            "lon": wgs84["lon"],
            "lat": wgs84["lat"],
            "alt_ellipsoid": wgs84["alt_ellipsoid"],
        }
