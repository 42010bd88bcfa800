"""SE(3) rigid transforms as 4x4 homogeneous matrices (numpy, host-side).

The port's own copy of ``gisnav_tpu/geometry/se3.py`` ``make_transform``,
``split_transform``, ``invert`` and ``compose``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["make_transform", "split_transform", "invert", "compose"]


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
