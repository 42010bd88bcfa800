"""TwistNode: shallow-matching visual odometry on consecutive frames.

Counterpart of ``gisnav_tpu/nodes/twist_node.py`` (the reference TwistNode,
``core/twist_node.py`` in hmakelin/gisnav): SIFT on consecutive frames,
ratio-test matching, PnP against the previous frame's flat pixel plane,
metric scaling from distance-to-ground and the camera focal length,
cumulative pose integration in the ``gisnav_odom`` frame. SIFT, the matcher
and PnP run on the device, and each frame's features stay there until the
next frame is matched against them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gisnav_tpu_torch.constants import (
    ROS_NAMESPACE,
    ROS_TOPIC_CAMERA_INFO,
    ROS_TOPIC_IMAGE,
    ROS_TOPIC_MAVROS_GIMBAL_DEVICE_ATTITUDE_STATUS,
    ROS_TOPIC_MAVROS_GLOBAL_POSITION,
    ROS_TOPIC_RELATIVE_POSE,
    TWIST_NODE_NAME,
)
from gisnav_tpu_torch.device import resolve_device, strict_fp32
from gisnav_tpu_torch.features.sift import (
    SiftFeatures,
    extract_sift,
    pad_features,
)
from gisnav_tpu_torch.geometry.quaternion import matrix_to_quat, quat_rotate
from gisnav_tpu_torch.geometry.se3 import compose, make_transform
from gisnav_tpu_torch.matching.mnn import mnn_ratio_match
from gisnav_tpu_torch.nodes.base import Node
from gisnav_tpu_torch.pnp.ransac import ransac_pnp
from gisnav_tpu_torch.utils.devlock import device_lock

__all__ = ["TwistNode", "TOPIC_TWIST_POSE"]

# the VO pose topic is "~/pose" under the twist node, as in the reference
# graph ("/gisnav/twist_node/pose")
TOPIC_TWIST_POSE = (
    f"/{ROS_NAMESPACE}/{TWIST_NODE_NAME}/"
    + ROS_TOPIC_RELATIVE_POSE.replace("~/", "")
)

# VO covariance template (reference core/_shared.py:8-15)
_VO_COV = np.diag([9.0, 9.0, 9.0] + [np.radians(3.0) ** 2] * 3)


class TwistNode(Node):
    """Publishes the integrated VO pose in the ``gisnav_odom`` frame.

    Runs on the card unless ``device="cpu"`` is passed (TF32 off, as every
    classical entry point)."""

    MIN_MATCHES = 30  # reference twist_node.py:66
    RATIO = 0.7  # reference twist_node.py:54

    def __init__(self, bus, params=None, tf=None, *, device=None):
        super().__init__(TWIST_NODE_NAME, bus, params, tf)
        self._device = resolve_device(device)
        strict_fp32()
        self._camera_info = None
        self._prev: Optional[SiftFeatures] = None  # tensors on the device
        self._pose_odom = np.eye(4)  # odom <- camera
        self._distance_to_ground = float(
            self.param("default_distance_to_ground", 100.0)
        )
        self._ground_alt = float(self.param("ground_altitude_m", 0.0))
        self._max_kp = int(self.param("max_keypoints", 1024))
        self._initialized = False
        self._attitude = None
        self.subscribe(ROS_TOPIC_CAMERA_INFO, self._camera_info_cb)
        self.subscribe(ROS_TOPIC_MAVROS_GLOBAL_POSITION, self._nav_fix_cb)
        self.subscribe(ROS_TOPIC_MAVROS_GIMBAL_DEVICE_ATTITUDE_STATUS,
                       self._attitude_cb)
        self.subscribe(ROS_TOPIC_IMAGE, self._image_cb)

    def _camera_info_cb(self, msg):
        self._camera_info = msg

    def _nav_fix_cb(self, msg):
        self._distance_to_ground = max(
            msg["alt_ellipsoid"] - self._ground_alt, 1.0
        )

    def _attitude_cb(self, msg):
        self._attitude = msg

    def _camera_pointed_at_ground(self) -> bool:
        """Gate VO on the camera looking closer to nadir than half the
        horizontal FOV (the ground-plane scaling assumption breaks
        off-nadir)."""
        if self._attitude is None or self._camera_info is None:
            return True  # no attitude source: assume nadir rig
        fwd_enu = quat_rotate(
            np.asarray(self._attitude["quat_xyzw"]), np.array([0.0, 0.0, 1.0])
        )  # camera optical +z in ENU
        cos_nadir = -fwd_enu[2] / max(np.linalg.norm(fwd_enu), 1e-9)
        angle_off_nadir = np.arccos(np.clip(cos_nadir, -1.0, 1.0))
        k = np.asarray(self._camera_info["k"]).reshape(3, 3)
        hfov = 2.0 * np.arctan(self._camera_info["width"] / (2.0 * k[0, 0]))
        return bool(angle_off_nadir < np.pi / 2 - hfov / 2)

    def initialize_pose(self, h_odom_cam: np.ndarray) -> None:
        """Seed the cumulative pose (e.g. from the first global fix); until
        then the odom frame is the first camera frame."""
        self._pose_odom = np.asarray(h_odom_cam, np.float64).copy()
        self._initialized = True

    def _image_cb(self, msg) -> None:
        out = self.step(msg)
        # pre-bootstrap VO lives in an arbitrary first-camera frame (z=0):
        # publishing it would seed the fusion filters far from the map
        # frame, so nothing is published before initialize_pose
        if out is not None and self._initialized:
            self.publish(TOPIC_TWIST_POSE, out)

    def step(self, image_msg) -> Optional[dict]:
        if self._camera_info is None:
            return None
        if not self._camera_pointed_at_ground():
            self._prev = None  # do not match across a gimbal slew
            return None
        with device_lock:
            feats = pad_features(
                *extract_sift(image_msg["image"], self._max_kp,
                              device=self._device), self._max_kp)
        prev, self._prev = self._prev, feats
        if prev is None or int(prev.mask.sum()) < self.MIN_MATCHES:
            return None

        delta = self._relative_transform(prev, feats)
        if delta is None:
            return None
        # integrate: odom <- cur = (odom <- prev) o (prev <- cur)
        self._pose_odom = compose(self._pose_odom, delta)
        r = self._pose_odom[:3, :3]
        return {
            "stamp_us": int(image_msg["stamp_us"]),
            "frame_id": "gisnav_odom",
            "position": self._pose_odom[:3, 3].copy(),
            "quat_xyzw": matrix_to_quat(r),
            "covariance": _VO_COV.copy(),
        }

    def _relative_transform(self, prev: SiftFeatures, cur: SiftFeatures
                            ) -> Optional[np.ndarray]:
        """(prev camera <- current camera) rigid transform, in meters.

        The previous frame's keypoints form a flat object plane at the
        camera's distance-to-ground; PnP solves the current camera against
        it. In pixel units the previous camera sits at height ``fx`` above
        its own image plane (so one pixel equals ``d / fx`` meters on the
        ground — the reference's hfov scaling).
        """
        dev = self._device
        with device_lock:
            matches, _ = mnn_ratio_match(
                cur.descriptors, prev.descriptors, cur.mask, prev.mask,
                ratio=self.RATIO, mutual=False,
            )
            valid = matches >= 0
            if int(valid.sum()) < self.MIN_MATCHES:
                return None

            k = np.asarray(self._camera_info["k"], np.float64).reshape(3, 3)
            obj = torch.zeros((len(matches), 3), device=dev)
            obj[:, :2] = prev.keypoints[torch.clamp(matches, min=0).long()]
            # the JAX node's default key is fixed: one seed every frame
            res = ransac_pnp(
                obj, cur.keypoints,
                torch.as_tensor(k, dtype=torch.float32, device=dev), valid,
                generator=torch.Generator(device=dev).manual_seed(0),
                min_inliers=self.MIN_MATCHES,
            )
            if not bool(res.valid):
                return None
            r = res.r.cpu().numpy().astype(np.float64)
            t = res.t.cpu().numpy().astype(np.float64)

        fx = k[0, 0]
        cx, cy = k[0, 2], k[1, 2]
        gsd = self._distance_to_ground / fx  # meters per pixel
        c1 = -r.T @ t  # current camera center in prev pixel frame
        c0 = np.array([cx, cy, -fx])  # previous camera center, pixel units
        t_rel = (c1 - c0) * gsd
        return make_transform(r.T, t_rel)
