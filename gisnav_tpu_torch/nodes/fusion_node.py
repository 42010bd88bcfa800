"""FusionNode: EKF state fusion of the deep pose and VO pose streams.

Counterpart of ``gisnav_tpu/nodes/fusion_node.py``. Replaces the two
``robot_localization`` processes of the reference
(``launch/params/ekf_global_node.yaml`` / ``ekf_local_node.yaml`` in
hmakelin/gisnav) with the port's filters on the card: the global UKF fuses
the absolute map-frame pose plus differential VO, the local EKF fuses VO
only and yields the smooth ``gisnav_odom``-frame odometry that drives the
mock-GPS outputs (only odom-frame odometry may drive GPS output: global
jumps would corrupt velocity, ``_mock_gps_node.py:345-375``).

Written departure: a pose older than the newest VO pose (on the threaded
bus the pose and VO streams reach this node on two workers, so a frame's
pose can come after the next frame's VO) is carried along the VO odometry
from its frame's VO pose to the newest one and fused at that stamp, or
dropped without its frame's VO pose. The JAX node drops it in the global
filter yet anchors ``map -> odom`` at its stamp with the newer states,
which put fixes of a moving camera a step (30 m) off, and all of them
hundreds of metres off when every pose lags. In order, as on the
synchronous bus, nothing changes.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Optional

import numpy as np

from gisnav_tpu_torch.constants import ROS_TOPIC_ROBOT_LOCALIZATION_ODOMETRY
from gisnav_tpu_torch.fusion.filter import PoseFusionFilter, SensorConfig
from gisnav_tpu_torch.geometry.quaternion import matrix_to_quat, quat_to_matrix
from gisnav_tpu_torch.geometry.se3 import invert, make_transform
from gisnav_tpu_torch.nodes.base import Node
from gisnav_tpu_torch.nodes.pose_node import TOPIC_POSE
from gisnav_tpu_torch.nodes.twist_node import TOPIC_TWIST_POSE

__all__ = ["FusionNode", "TOPIC_ODOMETRY"]

TOPIC_ODOMETRY = ROS_TOPIC_ROBOT_LOCALIZATION_ODOMETRY
_VO_HISTORY = 16  # VO poses kept to carry a late pose forward


class FusionNode(Node):
    """Publishes filtered odometry in the ``gisnav_odom`` frame."""

    def __init__(self, bus, params=None, tf=None, *, device=None):
        super().__init__("fusion_node", bus, params, tf)
        # (input stamp_us, wall time) of the newest measurement — drives the
        # fixed-rate output timer's stamp extrapolation
        self._last_input = None
        # global filter: absolute deep pose + differential VO
        self.global_filter = PoseFusionFilter(
            {
                # innovation gate: an aliased PnP fix on self-similar
                # terrain must not yank the filter (robot_localization's
                # pose0_rejection_threshold; reference suggests 2.0, we
                # default 3.0 for faster reconvergence after dropouts)
                "pose": SensorConfig(rejection_threshold=self.param(
                    "pose_rejection_threshold", 3.0)),
                "vo": SensorConfig(differential=True),
            },
            backend=self.param("global_filter", "ukf"),  # reference: UKF
            device=device,
        )
        # local filter: VO only (absolute in the odom frame)
        self.local_filter = PoseFusionFilter({"vo": SensorConfig()},
                                             device=device)
        self._latest_global_match_stamp: Optional[int] = None
        # the two input handlers run one at a time, so a late pose is
        # carried to the VO stamp that is newest when it is fused
        self._inputs = threading.Lock()
        self._vo_poses: "OrderedDict[int, tuple]" = OrderedDict()
        self.subscribe(TOPIC_POSE, self._pose_cb)
        self.subscribe(TOPIC_TWIST_POSE, self._twist_pose_cb)

    def _pose_cb(self, msg) -> None:
        with self._inputs:
            self._fuse_pose(msg)

    def _fuse_pose(self, msg) -> None:
        stamp = int(msg["stamp_us"])
        position, quat_xyzw = msg["position"], msg["quat_xyzw"]
        newest = next(reversed(self._vo_poses), stamp)
        if newest > stamp:  # a later frame's VO came first
            if stamp not in self._vo_poses:
                return  # nothing to carry it along
            h_odom = [make_transform(quat_to_matrix(q), p) for p, q in (
                self._vo_poses[stamp], self._vo_poses[newest])]
            h = (make_transform(quat_to_matrix(np.asarray(quat_xyzw)),
                                np.asarray(position))
                 @ invert(h_odom[0]) @ h_odom[1])
            stamp, position, quat_xyzw = newest, h[:3, 3], matrix_to_quat(
                h[:3, :3])
        self._last_input = (stamp, time.monotonic())
        self._latest_global_match_stamp = stamp
        self.global_filter.submit(
            "pose", stamp, position, quat_xyzw, msg["covariance"],
        )
        if self.tf is not None:
            # keep gisnav_map -> gisnav_base_link tf fresh from the global EKF
            est = self.global_filter.state_at(stamp)
            if est is not None:
                self.tf.add(
                    "gisnav_map", "gisnav_base_link",
                    make_transform(quat_to_matrix(est["quat_xyzw"]),
                                   est["position"]),
                    stamp,
                )
            # map -> odom is anchored at MEASUREMENT instants (the
            # robot_localization world->odom convention): both filters are
            # freshest here. Computing it on the output timer instead means
            # extrapolating the global filter across pose dropouts — an
            # early bad velocity estimate integrated for many seconds put
            # fixes hundreds of meters off in altitude.
            self._update_map_to_odom(stamp)

    def _twist_pose_cb(self, msg) -> None:
        with self._inputs:
            stamp = int(msg["stamp_us"])
            self._vo_poses[stamp] = (np.asarray(msg["position"]),
                                     np.asarray(msg["quat_xyzw"]))
            while len(self._vo_poses) > _VO_HISTORY:
                self._vo_poses.popitem(last=False)
            self._last_input = (stamp, time.monotonic())
            self.global_filter.submit(
                "vo", msg["stamp_us"], msg["position"], msg["quat_xyzw"],
                msg["covariance"],
            )
            self.local_filter.submit(
                "vo", msg["stamp_us"], msg["position"], msg["quat_xyzw"],
                msg["covariance"],
            )
            self.tick(msg["stamp_us"])

    def tick_now(self) -> Optional[dict]:
        """Fixed-rate output: publish odometry at a stamp extrapolated from
        the newest measurement by the wall time elapsed since it arrived.

        Called from the app's 5 Hz fusion timer (the reference publishes its
        filters at a fixed 5 Hz, ``launch/params/ekf_global_node.yaml:13``),
        so mock-GPS output survives VO dropouts — e.g. the off-nadir gimbal
        gate in TwistNode (``twist_node.py:116-118``) no longer silences GPS.
        """
        if self._last_input is None:
            return None
        stamp0, wall0 = self._last_input
        elapsed = time.monotonic() - wall0
        if elapsed > float(self.param("output_timeout_s", 10.0)):
            # all sensors stale (e.g. frames dropped while device programs
            # compile): stop publishing rather than dead-reckon into
            # nonsense (robot_localization goes silent on sensor timeout)
            return None
        stamp = stamp0 + int(elapsed * 1e6)
        return self.tick(stamp)

    def tick(self, stamp_us: int) -> Optional[dict]:
        """Publish the current filtered odometry at ``stamp_us`` (the filter
        predicts forward to the query time). Called per VO update and from
        the fixed-rate timer via :meth:`tick_now`."""
        est = self.local_filter.state_at(stamp_us)
        if est is None:
            return None
        if not (np.all(np.isfinite(est["position"]))
                and np.all(np.isfinite(est["quat_xyzw"]))):
            # never publish a non-finite state (downstream encoders int()
            # the fields); the filter re-seeds on the next measurement
            self.log.warning("non-finite fused state at %d; skipping output",
                             stamp_us)
            return None
        cov = est["covariance"]
        msg = {
            "stamp_us": int(stamp_us),
            "frame_id": "gisnav_odom",
            "child_frame_id": "gisnav_base_link",
            "position": est["position"],
            "quat_xyzw": est["quat_xyzw"],
            "pose_covariance": cov[:6, :6],
            "velocity_body": est["velocity_body"],
            "angular_velocity_body": est["angular_velocity_body"],
            "twist_covariance": cov[6:12, 6:12],
            "latest_global_match_stamp_us": self._latest_global_match_stamp,
        }
        self.publish(TOPIC_ODOMETRY, msg)
        if self.tf is not None:
            h_odom_base = make_transform(
                quat_to_matrix(est["quat_xyzw"]), est["position"]
            )
            self.tf.add("gisnav_odom", "gisnav_base_link", h_odom_base,
                        stamp_us)
        return msg

    def _update_map_to_odom(self, stamp_us: int) -> None:
        """Close the frame chain (robot_localization's world->odom tf):
        map<-base composed with base<-odom, both evaluated at a global
        MEASUREMENT stamp."""
        if self.tf is None:
            return
        # both chains must be measurement-anchored near the stamp: an
        # extrapolated state (stale VO during compile stalls / gimbal-gate
        # dropouts) bakes integrated velocity error into the transform —
        # observed as fixes hundreds of meters off in altitude
        lstamp = self.local_filter.latest_stamp_us
        if lstamp is None or abs(int(lstamp) - stamp_us) > 1_000_000:
            return
        g = self.global_filter.state_at(stamp_us)
        le = self.local_filter.state_at(stamp_us)
        if g is None or le is None:
            return
        if not (np.all(np.isfinite(g["position"]))
                and np.all(np.isfinite(g["quat_xyzw"]))
                and np.all(np.isfinite(le["position"]))
                and np.all(np.isfinite(le["quat_xyzw"]))):
            self.log.warning(
                "non-finite filter state at %d; map->odom not updated",
                stamp_us)
            return
        h_map_base = make_transform(
            quat_to_matrix(g["quat_xyzw"]), g["position"])
        h_odom_base = make_transform(
            quat_to_matrix(le["quat_xyzw"]), le["position"])
        self.tf.add("gisnav_map", "gisnav_odom",
                    h_map_base @ invert(h_odom_base), stamp_us)
