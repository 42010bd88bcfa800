"""SE(3) rigid transforms as 4x4 homogeneous matrices (numpy, host-side).

The port's own copy of ``gisnav_tpu/geometry/se3.py`` ``make_transform``,
``split_transform``, ``invert``, ``compose`` and ``interpolate_transform``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from gisnav_tpu_torch.geometry.quaternion import (
    matrix_to_quat,
    quat_slerp,
    quat_to_matrix,
)

__all__ = ["make_transform", "split_transform", "invert", "compose",
           "interpolate_transform"]


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
