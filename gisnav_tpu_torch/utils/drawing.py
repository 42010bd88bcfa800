"""OpenCV's drawing calls that the demo world makes, in numpy (no cv2).

``utils/world.py`` ``synthetic_world`` draws rectangles, discs and thick
lines on a uint8 image and blurs it as the JAX package's generator does
through ``cv2.rectangle``, ``cv2.circle``, ``cv2.line`` and
``cv2.GaussianBlur``. The card machine has no OpenCV, so these are
OpenCV's own algorithms (``imgproc/src/drawing.cpp`` and the bit-exact
Gaussian of ``smooth.dispatch.cpp``), integer for integer, each held pixel
for pixel against ``cv2`` by ``tests/test_torch_demo_world.py``:

- :func:`rectangle`: a filled rectangle (``thickness=-1``), the inclusive
  box between its corners, clipped;
- :func:`circle`: a filled ``LINE_8`` circle, the midpoint algorithm's
  horizontal spans;
- :func:`line`: a ``LINE_8`` line of any thickness from 1 (thickness 1 is
  Bresenham's line from the left end; a thicker one is first cut to the
  image grown by the thickness on each side, in integers, then drawn as
  the quadrilateral of 16-bit fixed-point corners that ``FillConvexPoly``
  fills, with its edges drawn, and a filled circle at each end);
- :func:`gaussian_blur_3x3`: ``GaussianBlur(img, (3, 3), sigma)`` on uint8,
  the kernel in 8 fractional bits, the two passes in integers, a reflect-101
  border and one rounding at the end.

They draw into a 2-D C-contiguous uint8 array in place (the blur returns a
new one) and take only what the demo world needs: any other argument
raises ``ValueError``. Coordinates may lie off the image on either side.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

__all__ = ["rectangle", "circle", "line", "gaussian_blur_3x3"]

_SHIFT = 16  # drawing.cpp's XY_SHIFT: 16 fractional bits
_ONE = 1 << _SHIFT
_HALF = _ONE >> 1
_MAX_THICKNESS = 32767  # drawing.cpp's MAX_THICKNESS
_DBL_EPSILON = float(np.finfo(np.float64).eps)


def _canvas(img) -> np.ndarray:
    if not (isinstance(img, np.ndarray) and img.dtype == np.uint8
            and img.ndim == 2 and img.flags.c_contiguous
            and img.flags.writeable):
        raise ValueError("draw on a writable 2-D C-contiguous uint8 array")
    return img


def _point(p) -> Tuple[int, int]:
    try:
        x, y = p
    except (TypeError, ValueError):
        raise ValueError(f"a point is (x, y), not {p!r}") from None
    if not all(isinstance(v, (int, np.integer)) for v in (x, y)):
        raise ValueError(f"a point's coordinates are integers, not {p!r}")
    return int(x), int(y)


def _colour(color) -> int:
    if isinstance(color, (int, np.integer)) and 0 <= color <= 255:
        return int(color)
    raise ValueError(f"color is one grey level 0-255, not {color!r}")


def _cdiv(a: int, b: int) -> int:
    """C's integer division: the quotient truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _hline(img: np.ndarray, y: int, x0: int, x1: int, color: int) -> None:
    """The span ``x0..x1`` of row ``y``, clipped to the image."""
    h, w = img.shape
    if 0 <= y < h and x1 >= 0 and x0 < w:
        img[y, max(x0, 0):min(x1, w - 1) + 1] = color


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int
               ) -> Optional[Tuple[int, int, int, int]]:
    """drawing.cpp's ``clipLine``: the segment cut to ``[0, w) x [0, h)``
    as OpenCV cuts it (each end moved along the line in doubles, the
    second with the first's new coordinates), or None if it misses."""
    right, bottom = w - 1, h - 1
    if w <= 0 or h <= 0:
        return None

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return x1, y1, x2, y2


def _put(img: np.ndarray, xs: np.ndarray, ys: np.ndarray, color: int
         ) -> None:
    h, w = img.shape
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


def _line_fixed(img: np.ndarray, x1: int, y1: int, x2: int, y2: int,
                color: int) -> None:
    """drawing.cpp's ``Line2``: a 1-px line between two points in 16-bit
    fixed point (a thick line's polygon edges)."""
    h, w = img.shape
    cut = _clip_line(w << _SHIFT, h << _SHIFT, x1, y1, x2, y2)
    if cut is None:
        return
    x1, y1, x2, y2 = cut
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            x1, y1, x2, y2 = x2, y2, x1, y1
            dy = -dy
        step = _cdiv(dy << _SHIFT, ax | 1)
        count = (x2 - x1) >> _SHIFT
    else:
        if dy < 0:
            x1, y1, x2, y2 = x2, y2, x1, y1
            dx = -dx
        step = _cdiv(dx << _SHIFT, ay | 1)
        count = (y2 - y1) >> _SHIFT
    x1 += _HALF
    y1 += _HALF
    _put(img, np.array([(x2 + _HALF) >> _SHIFT]),
         np.array([(y2 + _HALF) >> _SHIFT]), color)
    k = np.arange(count + 1, dtype=np.int64)
    if ax > ay:
        _put(img, (x1 >> _SHIFT) + k, (y1 + k * step) >> _SHIFT, color)
    else:
        _put(img, (x1 + k * step) >> _SHIFT, (y1 >> _SHIFT) + k, color)


def _line_8(img: np.ndarray, x1: int, y1: int, x2: int, y2: int,
            color: int) -> None:
    """drawing.cpp's ``Line`` with 8-connectivity: the ``LineIterator``'s
    Bresenham line, clipped, drawn from its left end."""
    h, w = img.shape
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        cut = _clip_line(w, h, x1, y1, x2, y2)
        if cut is None:
            return
        x1, y1, x2, y2 = cut
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy = -dx, -dy
        x1, y1, x2, y2 = x2, y2, x1, y1
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    major = np.empty(dx + 1, np.int64)
    minor = np.empty(dx + 1, np.int64)
    a = b = 0
    for i in range(dx + 1):
        major[i], minor[i] = a, b
        if err < 0:
            b += 1
            err += 2 * dx
        err -= 2 * dy
        a += 1
    if vert:
        _put(img, x1 + minor, y1 + sy * major, color)
    else:
        _put(img, x1 + major, y1 + sy * minor, color)


def _fill_convex_fixed(img: np.ndarray, v: np.ndarray, color: int) -> None:
    """drawing.cpp's ``FillConvexPoly`` for ``LINE_8`` at ``shift`` 16:
    the edges drawn with ``Line2``, then the rows between the two edge
    walkers filled, each walker's x stepping by its rounded slope from the
    vertex it started at."""
    h, w = img.shape
    n = len(v)
    for i in range(n):
        x0, y0 = v[i - 1]
        x1, y1 = v[i]
        _line_fixed(img, int(x0), int(y0), int(x1), int(y1), color)
    ys = [int(p[1]) for p in v]
    xs = [int(p[0]) for p in v]
    imin = ys.index(min(ys))
    xmin = (min(xs) + _HALF) >> _SHIFT
    xmax = (max(xs) + _HALF) >> _SHIFT
    ymin = (ys[imin] + _HALF) >> _SHIFT
    ymax = (max(ys) + _HALF) >> _SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    idx = [imin, imin]
    di = [1, n - 1]
    ye = [ymin, ymin]
    ex = [-_ONE, -_ONE]
    edx = [0, 0]
    edges = n
    y = ymin
    while True:
        for i in range(2):
            if y >= ye[i]:
                idx0 = idx[i]
                j = (idx0 + di[i]) % n
                while edges > 0:
                    edges -= 1
                    ty = (ys[j] + _HALF) >> _SHIFT
                    if ty > y:
                        ye[i] = ty
                        edx[i] = _cdiv((xs[j] - xs[idx0]) * 2 + (ty - y),
                                       2 * (ty - y))
                        ex[i] = xs[idx0]
                        idx[i] = j
                        break
                    idx0 = j
                    j = (j + di[i]) % n
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            lo, hi = min(ex), max(ex)
            _hline(img, y, (lo + _HALF) >> _SHIFT, (hi + _HALF) >> _SHIFT,
                   color)
        ex[0] += edx[0]
        ex[1] += edx[1]
        y += 1
        if y > ymax:
            break


def _circle_filled(img: np.ndarray, cx: int, cy: int, radius: int,
                   color: int) -> None:
    """drawing.cpp's ``Circle`` with ``fill``: the midpoint algorithm's
    four horizontal spans an octant step, clipped."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        _hline(img, cy - dy, cx - dx, cx + dx, color)
        _hline(img, cy + dy, cx - dx, cx + dx, color)
        _hline(img, cy - dx, cx - dy, cx + dy, color)
        _hline(img, cy + dx, cx - dy, cx + dy, color)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def rectangle(img: np.ndarray, pt1, pt2, color, thickness: int) -> None:
    """``cv2.rectangle(img, pt1, pt2, color, thickness)`` with
    ``thickness=-1`` (filled): every pixel of the box between the corners,
    both included."""
    img = _canvas(img)
    (x1, y1), (x2, y2) = _point(pt1), _point(pt2)
    color = _colour(color)
    if thickness != -1:
        raise ValueError("only a filled rectangle (thickness -1)")
    h, w = img.shape
    xa, xb = max(min(x1, x2), 0), min(max(x1, x2), w - 1)
    ya, yb = max(min(y1, y2), 0), min(max(y1, y2), h - 1)
    if xa <= xb and ya <= yb:
        img[ya:yb + 1, xa:xb + 1] = color


def circle(img: np.ndarray, center, radius: int, color,
           thickness: int) -> None:
    """``cv2.circle(img, center, radius, color, thickness)`` with
    ``thickness=-1`` (filled, ``LINE_8``)."""
    img = _canvas(img)
    cx, cy = _point(center)
    color = _colour(color)
    if thickness != -1:
        raise ValueError("only a filled circle (thickness -1)")
    if not isinstance(radius, (int, np.integer)) or radius < 0:
        raise ValueError(f"radius is an integer >= 0, not {radius!r}")
    _circle_filled(img, cx, cy, int(radius), color)


def line(img: np.ndarray, pt1, pt2, color, thickness: int = 1) -> None:
    """``cv2.line(img, pt1, pt2, color, thickness)`` (``LINE_8``, no
    shift)."""
    img = _canvas(img)
    (x0, y0), (x1, y1) = _point(pt1), _point(pt2)
    color = _colour(color)
    if not isinstance(thickness, (int, np.integer)) \
            or not 0 < thickness <= _MAX_THICKNESS:
        raise ValueError(f"thickness is an integer 1-{_MAX_THICKNESS}, "
                         f"not {thickness!r}")
    thickness = int(thickness)
    if thickness == 1:
        _line_8(img, x0, y0, x1, y1, color)
        return
    h, w = img.shape  # cut to the image grown by the thickness first
    cut = _clip_line(w + 2 * thickness, h + 2 * thickness, x0 + thickness,
                     y0 + thickness, x1 + thickness, y1 + thickness)
    if cut is None:
        return
    x0, y0, x1, y1 = (v - thickness for v in cut)
    p0 = (x0 << _SHIFT, y0 << _SHIFT)
    p1 = (x1 << _SHIFT, y1 << _SHIFT)
    dx = (p0[0] - p1[0]) / _ONE
    dy = (p1[1] - p0[1]) / _ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    half_t = thickness << (_SHIFT - 1)
    if math.fabs(r) > _DBL_EPSILON:
        r = (half_t + odd * _ONE * 0.5) / math.sqrt(r)
        px, py = round(dy * r), round(dx * r)
        _fill_convex_fixed(img, np.array(
            [(p0[0] + px, p0[1] + py), (p0[0] - px, p0[1] - py),
             (p1[0] - px, p1[1] - py), (p1[0] + px, p1[1] + py)],
            np.int64), color)
    radius = (half_t + _HALF) >> _SHIFT
    for px, py in (p0, p1):
        _circle_filled(img, (px + _HALF) >> _SHIFT, (py + _HALF) >> _SHIFT,
                       radius, color)


def _gaussian_taps(sigma: float) -> Tuple[int, int]:
    """(side, centre) taps of OpenCV's 3-tap Gaussian in 8 fractional
    bits: the side rounded from ``exp(-1 / (2 sigma^2))`` over the sum, the
    centre what is left of 256 (sigma <= 0: ``[1, 2, 1] / 4``)."""
    if sigma <= 0:
        return 64, 128
    t = math.exp(-0.125 / (sigma * sigma) * 4.0)
    side = round(t * (1.0 / (2.0 * t + 1.0)) * 256.0)
    return side, 256 - 2 * side


def gaussian_blur_3x3(img: np.ndarray, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (3, 3), sigma)`` of a 2-D uint8 image."""
    if not (isinstance(img, np.ndarray) and img.dtype == np.uint8
            and img.ndim == 2 and min(img.shape) >= 2):
        raise ValueError("blur a 2-D uint8 array of at least 2x2")
    if not isinstance(sigma, (int, float)) or not math.isfinite(sigma):
        raise ValueError(f"sigma is a finite number, not {sigma!r}")
    side, centre = _gaussian_taps(float(sigma))
    a = np.pad(img, 1, mode="reflect").astype(np.int32)  # reflect-101
    rows = side * (a[:, :-2] + a[:, 2:]) + centre * a[:, 1:-1]
    acc = side * (rows[:-2] + rows[2:]) + centre * rows[1:-1]
    return ((acc + (1 << 15)) >> 16).astype(np.uint8)
