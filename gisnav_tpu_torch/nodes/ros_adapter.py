"""Optional ROS 2 adapter: bridge the internal bus to rclpy topics.

The port's counterpart of ``gisnav_tpu/nodes/ros_adapter.py``: the same
topic surface, message conversions and MAVROS parameter push. A ``bgr8``
(or any colour) camera image becomes grey through ``gis/png.py``
``to_gray``, OpenCV's fixed-point ``COLOR_BGR2GRAY`` weights (the JAX
adapter calls ``cv2.cvtColor``; the port has no OpenCV).

The framework's node graph runs on its own transport (``nodes.bus``); this
adapter mirrors the reference's external topic surface when a ROS 2
environment is present, so MAVROS / gscam / micro-ros-agent integrate exactly
as with the reference (SURVEY.md L1): inbound ROS messages are converted to
the graph's dict payloads, outbound mock-GPS messages to their ROS types.

rclpy (plus px4_msgs / nmea_msgs / ublox_msgs for the outputs) must be
importable; everything here is import-gated so the core framework carries no
ROS dependency.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from gisnav_tpu_torch.constants import (
    ROS_TOPIC_CAMERA_INFO,
    ROS_TOPIC_IMAGE,
    ROS_TOPIC_MAVROS_GIMBAL_DEVICE_ATTITUDE_STATUS,
    ROS_TOPIC_MAVROS_GLOBAL_POSITION,
    ROS_TOPIC_SENSOR_GPS,
)
from gisnav_tpu_torch.gis.png import to_gray
from gisnav_tpu_torch.nodes.mock_gps import TOPIC_NAV_PVT, TOPIC_NMEA_SENTENCE

__all__ = ["RosAdapter", "maybe_attach", "ros_available"]


def ros_available() -> bool:
    try:
        import rclpy  # noqa: F401

        return True
    except ImportError:
        return False


def _stamp_us(header) -> int:
    return int(header.stamp.sec * 1e6 + header.stamp.nanosec / 1e3)


class RosAdapter:
    """Bidirectional bus <-> ROS 2 bridge (one rclpy node).

    :param bus: the internal bus the GisNavApp graph runs on
    :param protocols: which outputs to republish ("uorb", "nmea", "ubx")
    """

    def __init__(self, bus, node_name: str = "gisnav_bridge",
                 protocols=("uorb",)):
        if not ros_available():
            raise ImportError(
                "rclpy is not importable; the ROS adapter needs a sourced "
                "ROS 2 environment (the core framework runs without it)"
            )
        import rclpy
        from rclpy.node import Node as RclpyNode

        if not rclpy.ok():
            rclpy.init()
        self.bus = bus
        self.node: "RclpyNode" = RclpyNode(node_name)
        self._wire_inputs()
        self._wire_outputs(protocols)
        self.configure_mavros()

    def configure_mavros(self) -> None:
        """Push the MAVROS plugin configuration the graph depends on.

        Parity with the reference BBoxNode's startup service calls
        (``core/bbox_node.py:68-96`` in hmakelin/gisnav): the
        ``local_position`` and ``gimbal_control`` plugins must broadcast
        their tf frames (``tf.send=true``), local position against the
        ``odom`` frame, and gimbal frames parented on the roll/pitch
        -stabilized base link so horizon lock is respected. Fail-soft: a
        missing service (plugin not loaded) is logged and skipped.
        """
        try:
            from rcl_interfaces.msg import Parameter, ParameterValue
            from rcl_interfaces.msg import ParameterType as PT
            from rcl_interfaces.srv import SetParameters
        except ImportError:
            return

        def pbool(name, v):
            return Parameter(name=name, value=ParameterValue(
                type=PT.PARAMETER_BOOL, bool_value=v))

        def pstr(name, v):
            return Parameter(name=name, value=ParameterValue(
                type=PT.PARAMETER_STRING, string_value=v))

        plan = {
            "/mavros/local_position/set_parameters": [
                pbool("tf.send", True), pstr("tf.frame_id", "odom")],
            "/mavros/gimbal_control/set_parameters": [
                pbool("tf.send", True),
                pstr("tf.frame_id", "base_link_stabilized_frd")],
        }
        for srv, params in plan.items():
            cli = self.node.create_client(SetParameters, srv)
            if not cli.wait_for_service(timeout_sec=2.0):
                self.node.get_logger().warning(
                    f"{srv} unavailable; MAVROS plugin not auto-configured")
                continue
            cli.call_async(SetParameters.Request(parameters=params))

    # -- ROS -> bus --------------------------------------------------------

    def _wire_inputs(self) -> None:
        from sensor_msgs.msg import CameraInfo, Image, NavSatFix

        def on_image(msg: Image) -> None:
            data = np.frombuffer(bytes(msg.data), np.uint8)
            if msg.encoding in ("mono8", "8UC1"):
                img = data.reshape(msg.height, msg.width)
            else:  # bgr8 (any colour order is read as BGR, as in JAX)
                bgr = data.reshape(msg.height, msg.width, -1)[..., :3]
                img = to_gray(bgr[..., ::-1])
            self.bus.publish(ROS_TOPIC_IMAGE, {
                "stamp_us": _stamp_us(msg.header),
                "frame_id": msg.header.frame_id,
                "image": img,
            })

        def on_camera_info(msg: CameraInfo) -> None:
            self.bus.publish(ROS_TOPIC_CAMERA_INFO, {
                "k": np.asarray(msg.k, np.float64).reshape(3, 3),
                "width": int(msg.width),
                "height": int(msg.height),
            })

        def on_navsatfix(msg: NavSatFix) -> None:
            self.bus.publish(ROS_TOPIC_MAVROS_GLOBAL_POSITION, {
                "stamp_us": _stamp_us(msg.header),
                "lat": float(msg.latitude),
                "lon": float(msg.longitude),
                "alt_ellipsoid": float(msg.altitude),
            })

        self.node.create_subscription(Image, ROS_TOPIC_IMAGE, on_image, 10)
        self.node.create_subscription(
            CameraInfo, ROS_TOPIC_CAMERA_INFO, on_camera_info, 10
        )
        self.node.create_subscription(
            NavSatFix, ROS_TOPIC_MAVROS_GLOBAL_POSITION, on_navsatfix, 10
        )
        try:
            from mavros_msgs.msg import GimbalDeviceAttitudeStatus

            def on_gimbal(msg) -> None:
                q = msg.q  # w, x, y, z in MAVLink order
                self.bus.publish(
                    ROS_TOPIC_MAVROS_GIMBAL_DEVICE_ATTITUDE_STATUS,
                    {"stamp_us": _stamp_us(msg.header),
                     "quat_xyzw": np.array([q.x, q.y, q.z, q.w])},
                )

            self.node.create_subscription(
                GimbalDeviceAttitudeStatus,
                ROS_TOPIC_MAVROS_GIMBAL_DEVICE_ATTITUDE_STATUS,
                on_gimbal, 10,
            )
        except ImportError:
            self.node.get_logger().warning(
                "mavros_msgs unavailable: gimbal attitude not bridged"
            )

    # -- bus -> ROS --------------------------------------------------------

    def _wire_outputs(self, protocols) -> None:
        if "uorb" in protocols:
            try:
                from px4_msgs.msg import SensorGps

                pub = self.node.create_publisher(
                    SensorGps, ROS_TOPIC_SENSOR_GPS, 10
                )

                # bind pub at definition time: the name is reused by the
                # other protocol blocks below (late binding would route
                # every output through the last-created publisher)
                def on_fix(fix: dict, pub=pub) -> None:
                    msg = SensorGps()
                    for key, value in fix.items():
                        if hasattr(msg, key):
                            setattr(msg, key, value)
                    pub.publish(msg)

                self.bus.subscribe(ROS_TOPIC_SENSOR_GPS, on_fix)
            except ImportError:
                self.node.get_logger().warning(
                    "px4_msgs unavailable: SensorGps not bridged"
                )
        if "nmea" in protocols:
            try:
                from nmea_msgs.msg import Sentence

                pub = self.node.create_publisher(
                    Sentence, TOPIC_NMEA_SENTENCE, 10
                )

                def on_sentence(payload: dict, pub=pub) -> None:
                    msg = Sentence()
                    msg.sentence = payload["sentence"]
                    pub.publish(msg)

                self.bus.subscribe(TOPIC_NMEA_SENTENCE, on_sentence)
            except ImportError:
                self.node.get_logger().warning(
                    "nmea_msgs unavailable: sentences not bridged"
                )
        if "ubx" in protocols:
            try:
                from ublox_msgs.msg import NavPVT

                pub = self.node.create_publisher(NavPVT, TOPIC_NAV_PVT, 10)

                def on_navpvt(fix: dict, pub=pub) -> None:
                    msg = NavPVT()
                    for key, value in fix.items():
                        if hasattr(msg, key):
                            setattr(msg, key, value)
                    pub.publish(msg)

                self.bus.subscribe(TOPIC_NAV_PVT, on_navpvt)
            except ImportError:
                self.node.get_logger().warning(
                    "ublox_msgs unavailable: NavPVT not bridged"
                )

    def spin(self) -> None:
        """Blocking spin; ``close()`` (from any thread) wakes and stops it.

        Uses an owned ``SingleThreadedExecutor`` rather than module-level
        ``rclpy.spin`` so shutdown is cooperative: ``executor.shutdown()``
        interrupts a concurrent ``spin()``, letting the CLI join the spin
        thread and destroy the node instead of leaking a live executor on
        Ctrl-C.
        """
        import rclpy

        try:
            from rclpy.executors import SingleThreadedExecutor
        except ImportError:  # pragma: no cover - stub ROS stacks
            rclpy.spin(self.node)
            return
        executor = SingleThreadedExecutor()
        executor.add_node(self.node)
        self._executor = executor
        try:
            executor.spin()
        finally:
            executor.remove_node(self.node)

    def close(self) -> None:
        """Stop a concurrent :meth:`spin` and destroy the rclpy node.

        Idempotent and thread-safe; callers should join the spin thread
        afterwards (see ``cli._cmd_run``).
        """
        if getattr(self, "_closed", False):
            return
        self._closed = True
        stopped = True
        executor = getattr(self, "_executor", None)
        if executor is not None:
            self._executor = None
            # shutdown() returns False when a callback is still executing
            # at the timeout; destroying the node under a live executor
            # thread can crash rclpy at teardown, so defer to GC in that
            # case (the caller joins the spin thread after close())
            stopped = executor.shutdown(timeout_sec=2.0)
            if stopped is None:  # older rclpy returns None
                stopped = True
        if stopped:
            destroy = getattr(self.node, "destroy_node", None)
            if destroy is not None:
                destroy()


def maybe_attach(bus, protocols=("uorb",)) -> Optional["RosAdapter"]:
    """Attach the bridge when ROS is present; None (with no error)
    otherwise."""
    if not ros_available():
        return None
    return RosAdapter(bus, protocols=protocols)
