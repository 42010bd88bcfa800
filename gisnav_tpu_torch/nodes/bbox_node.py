"""BBoxNode: project the camera FOV to the ground, publish a padded bbox.

The port's own copy of ``gisnav_tpu/nodes/bbox_node.py`` (host numpy, no
device work). Capability parity with the reference BBoxNode
(``core/bbox_node.py:154-365`` in hmakelin/gisnav): intrinsics-inverse ray
casting onto the ground plane, ENU squaring + padding, UTM metre-offset
conversion to WGS84.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from gisnav_tpu_torch.constants import (
    BBOX_NODE_NAME,
    ROS_NAMESPACE,
    ROS_TOPIC_CAMERA_INFO,
    ROS_TOPIC_MAVROS_GIMBAL_DEVICE_ATTITUDE_STATUS,
    ROS_TOPIC_MAVROS_GLOBAL_POSITION,
    ROS_TOPIC_RELATIVE_FOV_BOUNDING_BOX,
)
from gisnav_tpu_torch.geometry.bbox import fov_bounding_box_enu
from gisnav_tpu_torch.geometry.quaternion import (
    euler_to_quat,
    matrix_to_quat,
    quat_to_euler,
    quat_to_matrix,
)
from gisnav_tpu_torch.geometry.se3 import make_transform
from gisnav_tpu_torch.nodes.base import Node

__all__ = ["BBoxNode", "TOPIC_FOV_BOUNDING_BOX"]

TOPIC_FOV_BOUNDING_BOX = (
    f"/{ROS_NAMESPACE}/{BBOX_NODE_NAME}/"
    + ROS_TOPIC_RELATIVE_FOV_BOUNDING_BOX.replace("~/", "")
)


class BBoxNode(Node):
    """Publishes the WGS84 bounding box of the ground-projected camera FOV."""

    def __init__(self, bus, params=None, tf=None):
        super().__init__(BBOX_NODE_NAME, bus, params, tf)
        self._camera_info = None
        self._nav_fix = None
        self._ground_alt = float(self.param("ground_altitude_m", 0.0))
        self.subscribe(ROS_TOPIC_CAMERA_INFO, self._camera_info_cb)
        self.subscribe(ROS_TOPIC_MAVROS_GLOBAL_POSITION, self._nav_fix_cb)
        self.subscribe(
            ROS_TOPIC_MAVROS_GIMBAL_DEVICE_ATTITUDE_STATUS, self._attitude_cb
        )

    def _camera_info_cb(self, msg) -> None:
        self._camera_info = msg

    def _nav_fix_cb(self, msg) -> None:
        self._nav_fix = msg

    def _attitude_cb(self, msg) -> None:
        """Gimbal attitude drives the publish (the FOV moves with it)."""
        bbox = self.compute_bbox(msg)
        if bbox is not None:
            self.publish(
                TOPIC_FOV_BOUNDING_BOX,
                {"stamp_us": msg["stamp_us"], "bbox": bbox},
            )
        self._publish_stabilized_frame(int(msg["stamp_us"]))

    def _publish_stabilized_frame(self, stamp_us: int) -> None:
        """Maintain ``gisnav_base_link_stabilized``: the vehicle pose with
        roll/pitch removed (yaw-only), the parent frame for horizon-locked
        gimbal frames (``GimbalDeviceAttitudeStatus`` flags bitmask 1100 —
        pitch/roll stabilized, yaw floating). Parity with the reference's
        ``base_link_stabilized`` broadcast (``core/bbox_node.py:387-436`` in
        hmakelin/gisnav)."""
        if self.tf is None:
            return
        try:
            h = self.tf.lookup("gisnav_map", "gisnav_base_link", stamp_us)
        except Exception:  # noqa: BLE001 - frame not yet available
            return
        from gisnav_tpu_torch.geometry.quaternion import (
            euler_to_quat,
            matrix_to_quat,
            quat_to_euler,
        )
        from gisnav_tpu_torch.geometry.se3 import make_transform

        _, _, yaw = quat_to_euler(matrix_to_quat(h[:3, :3]))
        r_yaw = quat_to_matrix(euler_to_quat(0.0, 0.0, yaw))
        self.tf.add(
            "gisnav_map", "gisnav_base_link_stabilized",
            make_transform(r_yaw, h[:3, 3]), stamp_us,
        )

    def compute_bbox(self, attitude) -> Optional[object]:
        if self._camera_info is None or self._nav_fix is None:
            return None
        altitude_agl = self._nav_fix["alt_ellipsoid"] - self._ground_alt
        if altitude_agl <= 1.0:
            return None
        r_enu = quat_to_matrix(np.asarray(attitude["quat_xyzw"]))
        return fov_bounding_box_enu(
            self._camera_info["k"],
            self._camera_info["width"],
            self._camera_info["height"],
            r_enu,
            altitude_agl,
            self._nav_fix["lon"],
            self._nav_fix["lat"],
        )
