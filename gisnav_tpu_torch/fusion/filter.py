"""Host-side fusion filter: sensor routing, timestamps, differential mode.

Counterpart of ``gisnav_tpu/fusion/filter.py``: the robot_localization node
behaviour the reference configures (``launch/params/ekf_global_node.yaml``
/ ``ekf_local_node.yaml`` in hmakelin/gisnav): absolute 6-DoF pose
sensors, differential pose sensors (consecutive poses -> body-frame
velocity), an innovation gate, a re-seed after a long gap, an extrapolation
clamp and a reset when the state turns non-finite. The filter state stays
on the device; ``device=None`` means the card.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gisnav_tpu_torch.device import resolve_device, strict_fp32
from gisnav_tpu_torch.fusion.ekf import (
    EKFState,
    ekf_init,
    ekf_predict,
    ekf_update_pose,
    ekf_update_velocity,
)
from gisnav_tpu_torch.fusion.ukf import (
    ukf_predict,
    ukf_update_pose,
    ukf_update_velocity,
)
from gisnav_tpu_torch.geometry.quaternion import (
    euler_to_quat,
    quat_inverse,
    quat_mul,
    quat_to_euler,
    quat_to_matrix,
)
from gisnav_tpu_torch.utils.devlock import device_lock

__all__ = ["SensorConfig", "PoseFusionFilter"]

_log = logging.getLogger("gisnav_tpu_torch.fusion")

_DEFAULT_Q = np.array(
    [0.05, 0.05, 0.06, 0.03, 0.03, 0.06,  # pose
     0.025, 0.025, 0.04, 0.01, 0.01, 0.02,  # velocity
     0.01, 0.01, 0.015],  # acceleration
    dtype=np.float32,
)
"""robot_localization's default process-noise diagonal."""

_BACKENDS = {
    "ekf": (ekf_predict, ekf_update_pose, ekf_update_velocity),
    "ukf": (ukf_predict, ukf_update_pose, ukf_update_velocity),
}


@dataclasses.dataclass
class SensorConfig:
    """One pose input (a ``poseN`` block of the reference YAML)."""

    differential: bool = False
    fuse_mask: Tuple[bool, ...] = (True,) * 6  # x y z roll pitch yaw
    timeout_s: float = 30.0
    # Mahalanobis innovation gate in SDs (``poseN_rejection_threshold``);
    # <= 0 disables it
    rejection_threshold: float = 0.0


class PoseFusionFilter:
    """Multi-sensor 6-DoF pose fusion with a 15-state EKF or UKF::

        f = PoseFusionFilter({"deep": SensorConfig(),
                              "vo": SensorConfig(differential=True)})
        f.submit("deep", t, position, quat_xyzw, covariance6)
        state = f.state_at(t)

    ``backend`` is "ekf" or "ukf" (the reference's global filter is a UKF,
    its local one an EKF). ``reset_after_s`` is the measurement-gap
    ceiling: past it an absolute measurement re-seeds the state, and state
    queries clamp their extrapolation to it (predicting across a long
    dropout grows P past f32 range). ``device=None`` is the card; the CPU
    only when asked.
    """

    def __init__(self, sensors: Dict[str, SensorConfig],
                 process_noise: Optional[np.ndarray] = None,
                 backend: str = "ekf", reset_after_s: float = 30.0, *,
                 device=None):
        if backend not in _BACKENDS:
            raise ValueError(f"unknown filter backend {backend!r}")
        self._predict, self._update_pose, self._update_velocity = \
            _BACKENDS[backend]
        self._device = resolve_device(device)
        strict_fp32()
        self._sensors = dict(sensors)
        self._q = torch.as_tensor(np.asarray(
            _DEFAULT_Q if process_noise is None else process_noise,
            np.float32), device=self._device)
        self._state: Optional[EKFState] = None
        self._stamp_us: Optional[int] = None
        self._prev_pose: Dict[str, Tuple[int, np.ndarray, np.ndarray]] = {}
        # submit and state_at run on different bus worker threads and the
        # output timer; the (x, P) read-modify-write must be atomic. The
        # mutex is the process-wide device lock, so filter launches never
        # interleave with another node's, and no lock order can deadlock
        self._mutex = device_lock
        self._reset_after_s = float(reset_after_s)

    @property
    def initialized(self) -> bool:
        return self._state is not None

    @property
    def latest_stamp_us(self):
        """Stamp of the newest fused measurement (None before init)."""
        with self._mutex:
            return self._stamp_us

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32),
                               device=self._device)

    def set_pose(self, stamp_us: int, position, quat_xyzw) -> None:
        """Hard-set the pose (the reference seeds its EKF once through
        /robot_localization/set_pose). Pose starts tight; velocity and
        acceleration wide, since the vehicle may already be moving."""
        with self._mutex:
            self._set_pose_locked(stamp_us, position, quat_xyzw)

    def _set_pose_locked(self, stamp_us: int, position, quat_xyzw) -> None:
        x0 = np.zeros(15, np.float32)
        x0[0:3] = np.asarray(position)
        x0[3:6] = quat_to_euler(np.asarray(quat_xyzw))
        p0 = np.concatenate([
            np.full(6, 1e-4, np.float32),  # pose: trusted
            np.full(3, 25.0, np.float32),  # velocity: +-5 m/s SD
            # angular rate +-1 rad/s SD: wider spreads push sigma points
            # past the euler singularity
            np.full(3, 1.0, np.float32),
            np.full(3, 10.0, np.float32),  # acceleration
        ])
        self._state = ekf_init(x0, p0, self._device)
        self._stamp_us = int(stamp_us)

    def _predict_to(self, stamp_us: int) -> None:
        dt = (stamp_us - self._stamp_us) / 1e6
        if dt > 0:
            self._state = self._predict(self._state, float(np.float32(dt)),
                                        self._q)
            self._stamp_us = int(stamp_us)

    def submit(self, sensor: str, stamp_us: int, position, quat_xyzw,
               covariance6: Optional[np.ndarray] = None) -> None:
        """Fuse one stamped pose measurement from a configured sensor."""
        cfg = self._sensors[sensor]
        position = np.asarray(position, np.float64)
        quat_xyzw = np.asarray(quat_xyzw, np.float64)
        if covariance6 is None:
            covariance6 = np.diag([9.0, 9.0, 9.0, 0.0027, 0.0027, 0.0027])
        r_diag = np.maximum(np.diag(np.asarray(covariance6)), 1e-9).astype(
            np.float32)
        mask = np.asarray(cfg.fuse_mask, np.float32)
        with self._mutex:
            self._submit_locked(cfg, sensor, int(stamp_us), position,
                                quat_xyzw, r_diag, mask)

    def _finite(self) -> bool:
        return bool(torch.isfinite(self._state.x).all()
                    & torch.isfinite(self._state.p).all())

    def _submit_locked(self, cfg, sensor, stamp_us, position, quat_xyzw,
                       r_diag, mask) -> None:
        if self._state is not None and not self._finite():
            # divergence reset (robot_localization is likewise reset): a
            # NaN state otherwise persists forever and freezes the
            # map->odom anchor; the next absolute measurement re-seeds
            _log.warning("non-finite filter state at %d; resetting for "
                         "re-seed", stamp_us)
            self._state = None
            self._stamp_us = None
            self._prev_pose.clear()
        if self._state is None:
            if cfg.differential:
                # a differential sensor cannot initialise an absolute state
                self._prev_pose[sensor] = (stamp_us, position, quat_xyzw)
            else:
                self._set_pose_locked(stamp_us, position, quat_xyzw)
            return
        if stamp_us < self._stamp_us:
            return  # stale measurement (robot_localization drops these)
        if (stamp_us - self._stamp_us) / 1e6 > self._reset_after_s:
            # a gap past the trustable prediction horizon: re-seed from an
            # absolute measurement, re-arm a differential one
            if cfg.differential:
                self._prev_pose[sensor] = (stamp_us, position, quat_xyzw)
            else:
                self._set_pose_locked(stamp_us, position, quat_xyzw)
            return

        self._predict_to(stamp_us)
        thr = float(np.float32(cfg.rejection_threshold))
        if not cfg.differential:
            z = np.concatenate([position, quat_to_euler(quat_xyzw)])
            self._state = self._update_pose(
                self._state, self._t(z), self._t(r_diag), self._t(mask), thr)
            return
        prev = self._prev_pose.get(sensor)
        self._prev_pose[sensor] = (stamp_us, position, quat_xyzw)
        if prev is None:
            return
        t0, p0, q0 = prev
        dt = (stamp_us - t0) / 1e6
        if dt <= 0 or dt > cfg.timeout_s:
            return
        # world-frame delta -> body-frame velocity at the previous attitude
        v_body = quat_to_matrix(q0).T @ (position - p0) / dt
        w_body = np.asarray(quat_to_euler(
            quat_mul(quat_inverse(q0), quat_xyzw))) / dt
        self._state = self._update_velocity(
            self._state, self._t(np.concatenate([v_body, w_body])),
            self._t(r_diag / max(dt, 1e-3)), self._t(mask), thr)

    def state_at(self, stamp_us: int):
        """Predict (without mutating) to a query time and return the
        odometry: position (3,), quat_xyzw (4,), velocity_body (3,),
        angular_velocity_body (3,) and covariance (15, 15) as float64
        numpy, or None before the first absolute measurement."""
        with self._mutex:
            if self._state is None:
                return None
            state = self._state
            # the extrapolation horizon is clamped: a query far past the
            # newest measurement must not blow P through f32 range
            dt = min((stamp_us - self._stamp_us) / 1e6, self._reset_after_s)
            if dt > 0:
                state = self._predict(state, float(np.float32(dt)), self._q)
            x = state.x.cpu().numpy().astype(np.float64)
            p = state.p.cpu().numpy().astype(np.float64)
        return {
            "stamp_us": int(stamp_us),
            "position": x[0:3],
            "quat_xyzw": euler_to_quat(*x[3:6]),
            "velocity_body": x[6:9],
            "angular_velocity_body": x[9:12],
            "covariance": p,
        }
