"""Developer visualization: match image + projected camera position.

The port's counterpart of ``gisnav_tpu/nodes/viz.py`` (the reference's dev
topics ``~/dev/matches_image`` and ``~/dev/position_image``,
``core/pose_node.py:145-151,310-346`` and ``core/_shared.py:38-86`` in
hmakelin/gisnav): matched keypoint pairs side by side, and the solved
camera ground position on the reference raster.

Drawn in numpy (the JAX module draws with OpenCV, which the port does not
have) by ``utils/drawing.py``, OpenCV 5.0's own drawing: the same canvases,
colours (BGR) and marks, pixel for pixel: a match line is
``cv2.line(..., 1, LINE_AA)``, a disc ``cv2.circle(..., -1)`` and the
position cross ``cv2.drawMarker``'s ``MARKER_CROSS`` of size 18 and
thickness 2 (two ``LINE_8`` lines of thickness 2 through the centre, +-9
px).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from gisnav_tpu_torch.utils import drawing

__all__ = ["draw_matches", "draw_position"]

_LINE = (0, 200, 0)
_KEYPOINT = (0, 120, 255)
_INLIER = (180, 180, 0)
_POSITION = (0, 255, 0)
_CROSS = (0, 0, 255)
_CROSS_SIZE, _CROSS_THICKNESS = 18, 2


def _gray_to_bgr(img: np.ndarray) -> np.ndarray:
    return np.repeat(np.asarray(img, np.uint8)[..., None], 3, axis=2)


def draw_matches(
    query: np.ndarray,
    reference: np.ndarray,
    mkp_qry: np.ndarray,
    mkp_ref: np.ndarray,
    mask: np.ndarray,
    max_draw: int = 200,
) -> np.ndarray:
    """Side-by-side match visualization (grayscale in, BGR out)."""
    h = max(query.shape[0], reference.shape[0])
    w = query.shape[1] + reference.shape[1]
    canvas = np.zeros((h, w, 3), np.uint8)
    canvas[: query.shape[0], : query.shape[1]] = _gray_to_bgr(query)
    canvas[: reference.shape[0], query.shape[1]:] = _gray_to_bgr(reference)
    off = query.shape[1]
    for i in np.flatnonzero(np.asarray(mask))[:max_draw]:
        p0 = tuple(np.round(mkp_qry[i]).astype(int))
        p1 = tuple(np.round(mkp_ref[i]).astype(int) + np.array([off, 0]))
        drawing.line(canvas, p0, p1, _LINE, 1, drawing.LINE_AA)
        drawing.circle(canvas, p0, 2, _KEYPOINT, -1)
        drawing.circle(canvas, p1, 2, _KEYPOINT, -1)
    return canvas


def draw_position(
    reference: np.ndarray,
    cam_pos_raster: np.ndarray,
    matched_ref: Optional[np.ndarray] = None,
    mask: Optional[np.ndarray] = None,
) -> Optional[np.ndarray]:
    """Mark the solved camera ground position (and inlier spread) on the
    reference raster; None when the position is outside the raster
    (the reference warns and skips, ``pose_node.py:336-343``)."""
    x, y = int(cam_pos_raster[0]), int(cam_pos_raster[1])
    h, w = reference.shape[:2]
    if not (0 <= x < w and 0 <= y < h):
        return None
    canvas = _gray_to_bgr(reference)
    if matched_ref is not None and mask is not None:
        for i in np.flatnonzero(np.asarray(mask))[:500]:
            drawing.circle(canvas, tuple(np.round(matched_ref[i]).astype(int)),
                           1, _INLIER, -1)
    drawing.circle(canvas, (x, y), 6, _POSITION, -1)
    half = _CROSS_SIZE // 2  # cv2.drawMarker's MARKER_CROSS
    drawing.line(canvas, (x - half, y), (x + half, y), _CROSS,
                 _CROSS_THICKNESS)
    drawing.line(canvas, (x, y - half), (x, y + half), _CROSS,
                 _CROSS_THICKNESS)
    return canvas
