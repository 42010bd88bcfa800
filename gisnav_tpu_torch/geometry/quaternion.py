"""Quaternion math on the host (numpy), (x, y, z, w) layout.

The port's own copy of ``gisnav_tpu/geometry/quaternion.py``
``matrix_to_quat`` (Shepperd's method) and ``quat_rotate``.
"""
from __future__ import annotations

import numpy as np

__all__ = ["matrix_to_quat", "quat_rotate"]


def matrix_to_quat(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    t = np.trace(m)
    if t > 0:
        s = 2.0 * np.sqrt(1.0 + t)
        q = np.array([(m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
                      (m[1, 0] - m[0, 1]) / s, 0.25 * s])
    else:
        i = int(np.argmax(np.diagonal(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(1.0 + m[i, i] - m[j, j] - m[k, k])
        q = np.empty(4)
        q[i] = 0.25 * s
        q[j] = (m[j, i] + m[i, j]) / s
        q[k] = (m[k, i] + m[i, k]) / s
        q[3] = (m[k, j] - m[j, k]) / s
    return q / np.linalg.norm(q)


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate vector(s) ``v`` (shape (..., 3)) by quaternion ``q``."""
    q = np.asarray(q, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    u = q[..., :3]
    w = q[..., 3:4]
    # v' = v + 2 * u x (u x v + w v)
    uv = np.cross(u, v)
    return v + 2.0 * np.cross(u, uv + w * v)
