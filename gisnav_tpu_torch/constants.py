"""Node names, topic names and frame ids of the node graph.

The port's own copy of ``gisnav_tpu/constants.py`` (the reference topic API,
``ros/gisnav/gisnav/constants.py`` in hmakelin/gisnav), so the two node
graphs never disagree on a topic string, plus the port's health topic.
"""
from typing import Final, Literal

ROS_NAMESPACE: Final = "gisnav"
"""Namespace for all framework nodes."""

GIS_NODE_NAME: Final = "gis_node"
BBOX_NODE_NAME: Final = "bbox_node"
STEREO_NODE_NAME: Final = "stereo_node"
POSE_NODE_NAME: Final = "pose_node"
TWIST_NODE_NAME: Final = "twist_node"
UORB_NODE_NAME: Final = "uorb_node"
NMEA_NODE_NAME: Final = "nmea_node"
UBX_NODE_NAME: Final = "ubx_node"
WFST_NODE_NAME: Final = "wfst_node"

ROS_TOPIC_RELATIVE_ORTHOIMAGE: Final = "~/orthoimage"
"""Orthoimage + DEM + CRS published by the GIS node."""

ROS_TOPIC_SENSOR_GPS: Final = "/fmu/in/sensor_gps"
"""uORB SensorGps output (PX4 uXRCE-DDS bridge input)."""

ROS_TOPIC_RELATIVE_NAV_PVT: Final = "~/navpvt"
"""u-blox NavPVT output of the UBX node."""

ROS_TOPIC_RELATIVE_NMEA_SENTENCE: Final = "~/sentence"
"""NMEA sentence output of the NMEA node."""

ROS_TOPIC_RELATIVE_FOV_BOUNDING_BOX: Final = "~/fov/bounding_box"
"""Padded square WGS84 bounding box of the projected camera FOV."""

ROS_TOPIC_RELATIVE_POSE_IMAGE: Final = "~/pose_image"
"""Pseudo-stereo couple (query frame + rotated/cropped reference raster)."""

ROS_TOPIC_RELATIVE_POSE: Final = "~/pose"
"""Pose output of a node, relative to its name."""

ROS_TOPIC_RELATIVE_TWIST: Final = "~/twist"
"""VO relative pose/twist estimate of the twist node."""

ROS_TOPIC_RELATIVE_MATCHES_IMAGE: Final = "~/dev/matches_image"
ROS_TOPIC_RELATIVE_POSITION_IMAGE: Final = "~/dev/position_image"
"""The pose node's developer images (``dev_topics``)."""

ROS_TOPIC_CAMERA_INFO: Final = "/camera/camera_info"
ROS_TOPIC_IMAGE: Final = "/camera/image_raw"

ROS_TOPIC_MAVROS_GLOBAL_POSITION: Final = "/mavros/global_position/global"
ROS_TOPIC_MAVROS_LOCAL_POSITION: Final = "/mavros/local_position/pose"
ROS_TOPIC_MAVROS_GIMBAL_DEVICE_ATTITUDE_STATUS: Final = (
    "/mavros/gimbal_control/device/attitude_status"
)

ROS_TOPIC_ROBOT_LOCALIZATION_ODOMETRY: Final = (
    "/robot_localization/odometry/filtered")
"""Filtered odometry from the fusion (EKF/UKF) layer."""

ROS_TOPIC_RELATIVE_QUERY_KEYPOINTS: Final = "~/keypoints"
"""Query-frame keypoints shared from the VO (twist) node to the stereo node."""

TOPIC_HEALTH: Final = "/gisnav/health"
"""Per-node liveness report of the graph's spin loop."""

DELAY_DEFAULT_MS: Final = 2000
"""Max acceptable staleness for inputs like global position (milliseconds)."""

FrameID = Literal[
    "base_link",
    "camera",
    "camera_optical",
    "base_link_stabilized",
    "camera_frd",
    "map",
    "odom",
    "earth",
    "gisnav_map",
    "gisnav_odom",
    "gisnav_camera_link_optical",
    "gisnav_base_link",
    "query_image",
]
"""Allowed transform-graph frame ids (REP 103 / REP 105 conventions).

``query_image`` coordinates are pixels, not meters.
"""
