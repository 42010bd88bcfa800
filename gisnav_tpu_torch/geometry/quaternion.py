"""Quaternion math on the host (numpy), (x, y, z, w) layout.

The port's own copy of what the node graph needs from
``gisnav_tpu/geometry/quaternion.py``: the Hamilton product, conjugate and
inverse, rotation of vectors, quaternion <-> matrix (Shepperd's method),
x-y-z Euler angles, slerp, and the compass heading, roll and off-nadir
angle of an attitude.
"""
from __future__ import annotations

import numpy as np

__all__ = ["quat_mul", "quat_conjugate", "quat_inverse", "quat_rotate",
           "quat_to_matrix", "matrix_to_quat", "euler_to_quat",
           "quat_to_euler", "quat_slerp", "heading_deg_from_quat",
           "roll_deg_from_quat", "angle_off_nadir"]


def quat_mul(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    """Hamilton product ``q1 * q2``: rotating by it applies ``q2`` first."""
    x1, y1, z1, w1 = np.moveaxis(np.asarray(q1, dtype=np.float64), -1, 0)
    x2, y2, z2, w2 = np.moveaxis(np.asarray(q2, dtype=np.float64), -1, 0)
    return np.stack([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                     w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], axis=-1)


def quat_conjugate(q: np.ndarray) -> np.ndarray:
    return np.asarray(q, dtype=np.float64) * np.array([-1.0, -1.0, -1.0, 1.0])


def quat_inverse(q: np.ndarray) -> np.ndarray:
    q = np.asarray(q, dtype=np.float64)
    return quat_conjugate(q) / np.sum(q * q, axis=-1, keepdims=True)


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """(x, y, z, w) -> 3x3 rotation (the input is normalised)."""
    q = np.asarray(q, dtype=np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = np.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = np.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
                  2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
                  2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], axis=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


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


def euler_to_quat(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """x-y-z (roll, pitch, yaw) radians -> quaternion, as
    ``tf_transformations.quaternion_from_euler``."""
    cr, sr = np.cos(roll / 2), np.sin(roll / 2)
    cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
    cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
    return np.array([sr * cp * cy - cr * sp * sy,
                     cr * sp * cy + sr * cp * sy,
                     cr * cp * sy - sr * sp * cy,
                     cr * cp * cy + sr * sp * sy])


def quat_to_euler(q: np.ndarray) -> tuple:
    """Quaternion -> (roll, pitch, yaw) radians, x-y-z convention."""
    x, y, z, w = np.asarray(q, dtype=np.float64)
    roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = np.arcsin(np.clip(2 * (w * y - z * x), -1.0, 1.0))
    yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return roll, pitch, yaw


def quat_slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    """Spherical linear interpolation along the short arc (a lerp when the
    two are nearly parallel)."""
    q0 = np.asarray(q0, dtype=np.float64)
    q1 = np.asarray(q1, dtype=np.float64)
    q0 = q0 / np.linalg.norm(q0)
    q1 = q1 / np.linalg.norm(q1)
    d = float(np.dot(q0, q1))
    if d < 0.0:
        q1, d = -q1, -d
    if d > 0.9995:
        q = q0 + t * (q1 - q0)
        return q / np.linalg.norm(q)
    theta = np.arccos(np.clip(d, -1.0, 1.0))
    return (np.sin((1 - t) * theta) * q0
            + np.sin(t * theta) * q1) / np.sin(theta)


def heading_deg_from_quat(q: np.ndarray) -> float:
    """ENU-frame quaternion -> compass heading in degrees, North = 0, in
    [0, 360): 90 deg less the ENU yaw (the reference's ``extract_yaw``)."""
    x, y, z, w = np.asarray(q, dtype=np.float64)
    enu_yaw_deg = np.degrees(np.arctan2(2 * (w * z + x * y),
                                        1 - 2 * (y * y + z * z)))
    return float((90.0 - enu_yaw_deg + 360.0) % 360.0)


def roll_deg_from_quat(q: np.ndarray) -> float:
    """Roll angle in degrees in [0, 360) (the reference's
    ``extract_roll``)."""
    x, y, z, w = np.asarray(q, dtype=np.float64)
    roll_deg = np.degrees(np.arctan2(2 * (w * x + y * z),
                                     1 - 2 * (x * x + y * y)))
    return float((roll_deg + 360.0) % 360.0)


def angle_off_nadir(q: np.ndarray) -> float:
    """Angle in radians between the body's forward axis (+x, rotated by
    ``q``) and straight down (-z of the parent frame)."""
    fwd = quat_rotate(np.asarray(q, dtype=np.float64),
                      np.array([1.0, 0.0, 0.0]))
    cos_theta = -fwd[2] / np.linalg.norm(fwd)
    return float(np.arccos(np.clip(cos_theta, -1.0, 1.0)))
