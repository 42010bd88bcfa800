"""Node and topic names the port's nodes use.

The port's own copy of the names it needs from ``gisnav_tpu/constants.py``
(the reference topic API, ``ros/gisnav/gisnav/constants.py`` in
hmakelin/gisnav), so the two node graphs never disagree on a topic string.
"""
from typing import Final

ROS_NAMESPACE: Final = "gisnav"
"""Namespace for all framework nodes."""

TWIST_NODE_NAME: Final = "twist_node"

ROS_TOPIC_RELATIVE_POSE: Final = "~/pose"
"""Pose output of a node, relative to its name."""

ROS_TOPIC_CAMERA_INFO: Final = "/camera/camera_info"
ROS_TOPIC_IMAGE: Final = "/camera/image_raw"

ROS_TOPIC_MAVROS_GLOBAL_POSITION: Final = "/mavros/global_position/global"
ROS_TOPIC_MAVROS_GIMBAL_DEVICE_ATTITUDE_STATUS: Final = (
    "/mavros/gimbal_control/device/attitude_status"
)
