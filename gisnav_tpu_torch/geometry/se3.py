"""SE(3) rigid transforms as 4x4 homogeneous matrices (numpy, host-side).

The port's own copy of ``gisnav_tpu/geometry/se3.py`` ``make_transform``,
``split_transform``, ``invert``, ``compose``, ``interpolate_transform`` and
``poses_to_twist``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from gisnav_tpu_torch.geometry.quaternion import (
    matrix_to_quat,
    quat_inverse,
    quat_mul,
    quat_slerp,
    quat_to_matrix,
)

__all__ = ["make_transform", "split_transform", "invert", "compose",
           "interpolate_transform", "poses_to_twist"]


def make_transform(r: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Build a 4x4 homogeneous transform from 3x3 rotation and 3-vector."""
    h = np.eye(4)
    h[:3, :3] = np.asarray(r, dtype=np.float64)
    h[:3, 3] = np.asarray(t, dtype=np.float64).reshape(3)
    return h


def split_transform(h: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """4x4 homogeneous transform -> (3x3 rotation, 3-vector translation)."""
    h = np.asarray(h, dtype=np.float64)
    return h[:3, :3].copy(), h[:3, 3].copy()


def invert(h: np.ndarray) -> np.ndarray:
    """Invert a rigid transform without a general matrix inverse."""
    r, t = split_transform(h)
    return make_transform(r.T, -r.T @ t)


def compose(*hs: np.ndarray) -> np.ndarray:
    """Compose transforms left-to-right: ``compose(a, b)(x) = a @ b @ x``."""
    out = np.eye(4)
    for h in hs:
        out = out @ np.asarray(h, dtype=np.float64)
    return out


def interpolate_transform(h0: np.ndarray, h1: np.ndarray,
                          alpha: float) -> np.ndarray:
    """Slerp the rotation and lerp the translation of two transforms (the
    transform graph's time interpolation)."""
    r0, t0 = split_transform(h0)
    r1, t1 = split_transform(h1)
    q = quat_slerp(matrix_to_quat(r0), matrix_to_quat(r1), alpha)
    return make_transform(quat_to_matrix(q), (1.0 - alpha) * t0 + alpha * t1)


def poses_to_twist(pos2: np.ndarray, quat2: np.ndarray, stamp2_us: int,
                   pos1: np.ndarray, quat1: np.ndarray, stamp1_us: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Two stamped poses (xyz metres, xyzw, microseconds; pose 2 the newer)
    -> (linear, angular) velocity in the poses' frame: the position
    difference over dt, and the axis-angle of ``q2 * q1^-1`` over dt.
    Raises ``ValueError`` unless dt > 0."""
    dt = (int(stamp2_us) - int(stamp1_us)) / 1e6
    if dt <= 0:
        raise ValueError(f"non-positive time step {dt}")
    lin = (np.asarray(pos2, dtype=np.float64)
           - np.asarray(pos1, dtype=np.float64)) / dt
    q_diff = quat_mul(quat2, quat_inverse(quat1))
    q_diff = q_diff / np.linalg.norm(q_diff)
    w = np.clip(q_diff[3], -1.0, 1.0)
    sin_half = np.sqrt(max(1.0 - w * w, 0.0))
    if sin_half < 1e-12:  # no rotation
        return lin, np.zeros(3)
    return lin, (2.0 * np.arccos(w) / sin_half) * q_diff[:3] / dt
