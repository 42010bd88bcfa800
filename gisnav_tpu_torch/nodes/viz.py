"""Developer visualization: match image + projected camera position.

The port's counterpart of ``gisnav_tpu/nodes/viz.py`` (the reference's dev
topics ``~/dev/matches_image`` and ``~/dev/position_image``,
``core/pose_node.py:145-151,310-346`` and ``core/_shared.py:38-86`` in
hmakelin/gisnav): matched keypoint pairs side by side, and the solved
camera ground position on the reference raster.

Drawn in numpy (the JAX module draws with OpenCV, which the port does not
have): the same canvases, colours (BGR) and marks. Filled discs and the
2-px cross cover the pixels OpenCV's ``LINE_8`` shapes cover (within the
radius; within 1 px of the cross's arms); a match line is anti-aliased by
its pixels' distance to the segment, a profile close to ``LINE_AA``'s, so
its pixels lie within 1 px of OpenCV's.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["draw_matches", "draw_position"]

_LINE = (0, 200, 0)
_KEYPOINT = (0, 120, 255)
_INLIER = (180, 180, 0)
_POSITION = (0, 255, 0)
_CROSS = (0, 0, 255)


def _gray_to_bgr(img: np.ndarray) -> np.ndarray:
    return np.repeat(np.asarray(img, np.uint8)[..., None], 3, axis=2)


def _disc(canvas: np.ndarray, x: int, y: int, r: int, colour) -> None:
    """Fill the pixels within ``r`` of (x, y), clipped to the canvas."""
    h, w = canvas.shape[:2]
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    keep = dx * dx + dy * dy <= r * r
    xs, ys = x + dx[keep], y + dy[keep]
    inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    canvas[ys[inside], xs[inside]] = colour


def _segment_pixels(p0, p1, reach: float):
    """Pixels (xs, ys) within ``reach`` of the segment p0-p1 and their
    distance to it, found along the major axis (``reach`` <= 2)."""
    p0, p1 = np.asarray(p0, np.float64), np.asarray(p1, np.float64)
    d = p1 - p0
    major = 0 if abs(d[0]) >= abs(d[1]) else 1
    lo, hi = sorted((p0[major], p1[major]))
    m = np.arange(np.floor(lo) - 2, np.ceil(hi) + 3)
    slope = d[1 - major] / d[major] if d[major] else 0.0
    centre = p0[1 - major] + (np.clip(m, lo, hi) - p0[major]) * slope
    n = np.rint(centre)[:, None] + np.arange(-3, 4)[None, :]
    mm = np.broadcast_to(m[:, None], n.shape)
    pts = np.stack([mm, n] if major == 0 else [n, mm], axis=-1).reshape(-1, 2)
    length2 = float(d @ d)
    t = (np.clip((pts - p0) @ d / length2, 0.0, 1.0) if length2
         else np.zeros(len(pts)))
    dist = np.linalg.norm(pts - (p0 + t[:, None] * d), axis=1)
    near = dist <= reach
    return (pts[near, 0].astype(np.int64), pts[near, 1].astype(np.int64),
            dist[near])


def _line_aa(canvas: np.ndarray, p0, p1, colour) -> None:
    """A 1-px anti-aliased line: each pixel within 1.35 of the segment
    blended toward ``colour`` by ``exp(-(distance / 0.72)^2)`` (OpenCV's
    ``LINE_AA`` profile within a few hundredths)."""
    xs, ys, dist = _segment_pixels(p0, p1, 1.35)
    h, w = canvas.shape[:2]
    inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    xs, ys, dist = xs[inside], ys[inside], dist[inside]
    alpha = np.exp(-(dist / 0.72) ** 2)[:, None]
    old = canvas[ys, xs].astype(np.float64)
    canvas[ys, xs] = np.rint(old + (np.asarray(colour) - old) * alpha
                             ).astype(np.uint8)


def _thick_line(canvas: np.ndarray, p0, p1, colour) -> None:
    """A 2-px line: the pixels within 1 of the segment."""
    xs, ys, _ = _segment_pixels(p0, p1, 1.0)
    h, w = canvas.shape[:2]
    inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    canvas[ys[inside], xs[inside]] = colour


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
        p0 = np.round(mkp_qry[i]).astype(int)
        p1 = np.round(mkp_ref[i]).astype(int) + np.array([off, 0])
        _line_aa(canvas, p0, p1, _LINE)
        _disc(canvas, p0[0], p0[1], 2, _KEYPOINT)
        _disc(canvas, p1[0], p1[1], 2, _KEYPOINT)
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
            px, py = np.round(matched_ref[i]).astype(int)
            _disc(canvas, px, py, 1, _INLIER)
    _disc(canvas, x, y, 6, _POSITION)
    for d in ((9, 0), (0, 9)):  # OpenCV's MARKER_CROSS of size 18
        _thick_line(canvas, (x - d[0], y - d[1]), (x + d[0], y + d[1]),
                    _CROSS)
    return canvas
