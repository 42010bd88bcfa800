"""OpenCV's drawing calls that the demo world and the developer images make,
in numpy (no cv2).

``utils/world.py`` ``synthetic_world`` draws rectangles, discs and thick
lines on a uint8 image and blurs it as the JAX package's generator does
through ``cv2.rectangle``, ``cv2.circle``, ``cv2.line`` and
``cv2.GaussianBlur``; ``nodes/viz.py`` draws anti-aliased lines, discs and a
cross on BGR images as the JAX module does through ``cv2.line`` (``LINE_AA``),
``cv2.circle`` and ``cv2.drawMarker``. The card machine has no OpenCV, so
these are OpenCV 5.0's own algorithms (``imgproc/src/drawing.cpp`` and the
bit-exact Gaussian of ``smooth.dispatch.cpp``), integer for integer, each
held pixel for pixel against ``cv2`` by ``tests/test_torch_demo_world.py``
and ``tests/test_torch_viz.py``:

- :func:`rectangle`: a filled rectangle (``thickness=-1``), the inclusive
  box between its corners, clipped;
- :func:`circle`: a filled ``LINE_8`` circle, the midpoint algorithm's
  horizontal spans;
- :func:`line`: a ``LINE_8`` line of any thickness from 1 (thickness 1 is
  Bresenham's line from the left end; a thicker one is first cut to the
  image grown by the thickness on each side, in integers, then drawn as
  the quadrilateral of 16-bit fixed-point corners that ``FillConvexPoly``
  fills, with its edges drawn, and a filled circle at each end); or a
  ``LINE_AA`` line of thickness 1: ``LineAA``'s walk along the major axis
  in 16-bit fixed point, three pixels a step weighted by its filter and
  slope-correction tables and its end-point corrections, each pixel
  blended toward the colour twice with the same weight (as OpenCV 5.0
  does);
- :func:`gaussian_blur_3x3`: ``GaussianBlur(img, (3, 3), sigma)`` on uint8,
  the kernel in 8 fractional bits, the two passes in integers, a reflect-101
  border and one rounding at the end.

They draw in place into a C-contiguous uint8 array, grey (H, W) with a
grey level for colour or BGR (H, W, 3) with a (B, G, R) colour (the blur
returns a new grey one), and take only what these callers need: any other
argument raises ``ValueError``. Coordinates may lie off the image on either
side.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

__all__ = ["rectangle", "circle", "line", "gaussian_blur_3x3", "LINE_8",
           "LINE_AA"]

_SHIFT = 16  # drawing.cpp's XY_SHIFT: 16 fractional bits
_ONE = 1 << _SHIFT
_HALF = _ONE >> 1
_MAX_THICKNESS = 32767  # drawing.cpp's MAX_THICKNESS
_DBL_EPSILON = float(np.finfo(np.float64).eps)
LINE_8, LINE_AA = 8, 16  # cv2's line types
# LineAA's tables: the anti-aliasing filter by distance (1/32 px), and the
# slope correction by slope (1/32)
_FILTER = np.array([
    168, 177, 185, 194, 202, 210, 218, 224, 231, 236, 241, 246, 249, 252,
    254, 254, 254, 254, 252, 249, 246, 241, 236, 231, 224, 218, 210, 202,
    194, 185, 177, 168, 158, 149, 140, 131, 122, 114, 105, 97, 89, 82, 75,
    68, 62, 56, 50, 45, 40, 36, 32, 28, 25, 22, 19, 16, 14, 12, 11, 9, 8,
    7, 5, 5], np.int64)
_SLOPE_CORR = (181, 181, 181, 182, 182, 183, 184, 185, 187, 188, 190, 192,
               194, 196, 198, 201, 203, 206, 209, 211, 214, 218, 221, 224,
               227, 231, 235, 238, 242, 246, 250, 254)


def _canvas(img) -> np.ndarray:
    if not (isinstance(img, np.ndarray) and img.dtype == np.uint8
            and (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3))
            and img.flags.c_contiguous and img.flags.writeable):
        raise ValueError("draw on a writable C-contiguous uint8 array, "
                         "(H, W) grey or (H, W, 3) BGR")
    return img


def _point(p) -> Tuple[int, int]:
    try:
        x, y = p
    except (TypeError, ValueError):
        raise ValueError(f"a point is (x, y), not {p!r}") from None
    if not all(isinstance(v, (int, np.integer)) for v in (x, y)):
        raise ValueError(f"a point's coordinates are integers, not {p!r}")
    return int(x), int(y)


def _colour(color, img: np.ndarray):
    """A grey level for a grey canvas, a (B, G, R) tuple for a BGR one."""
    if img.ndim == 2:
        if isinstance(color, (int, np.integer)) and 0 <= color <= 255:
            return int(color)
        raise ValueError(f"color on a grey image is one level 0-255, not "
                         f"{color!r}")
    if (isinstance(color, (tuple, list)) and len(color) == 3
            and all(isinstance(c, (int, np.integer)) and 0 <= c <= 255
                    for c in color)):
        return tuple(int(c) for c in color)
    raise ValueError(f"color on a BGR image is (B, G, R), each 0-255, not "
                     f"{color!r}")


def _cdiv(a: int, b: int) -> int:
    """C's integer division: the quotient truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _hline(img: np.ndarray, y: int, x0: int, x1: int, color) -> None:
    """The span ``x0..x1`` of row ``y``, clipped to the image."""
    h, w = img.shape[:2]
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


def _put(img: np.ndarray, xs: np.ndarray, ys: np.ndarray, color) -> None:
    h, w = img.shape[:2]
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


def _line_fixed(img: np.ndarray, x1: int, y1: int, x2: int, y2: int,
                color) -> None:
    """drawing.cpp's ``Line2``: a 1-px line between two points in 16-bit
    fixed point (a thick line's polygon edges)."""
    h, w = img.shape[:2]
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
            color) -> None:
    """drawing.cpp's ``Line`` with 8-connectivity: the ``LineIterator``'s
    Bresenham line, clipped, drawn from its left end."""
    h, w = img.shape[:2]
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


def _fill_convex_fixed(img: np.ndarray, v: np.ndarray, color) -> None:
    """drawing.cpp's ``FillConvexPoly`` for ``LINE_8`` at ``shift`` 16:
    the edges drawn with ``Line2``, then the rows between the two edge
    walkers filled, each walker's x stepping by its rounded slope from the
    vertex it started at."""
    h, w = img.shape[:2]
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
                   color) -> None:
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
    color = _colour(color, img)
    if thickness != -1:
        raise ValueError("only a filled rectangle (thickness -1)")
    h, w = img.shape[:2]
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
    color = _colour(color, img)
    if thickness != -1:
        raise ValueError("only a filled circle (thickness -1)")
    if not isinstance(radius, (int, np.integer)) or radius < 0:
        raise ValueError(f"radius is an integer >= 0, not {radius!r}")
    _circle_filled(img, cx, cy, int(radius), color)


def _line_aa(img: np.ndarray, x1: int, y1: int, x2: int, y2: int,
             color) -> None:
    """drawing.cpp's ``LineAA`` between two points in 16-bit fixed point:
    the segment clipped to the image, then a walk along the major axis, a
    step a pixel from the first end's pixel to one past the second's, the
    minor coordinate advancing by the truncated slope; each step weights
    the three pixels around the line by the filter at its 1/32-px distance
    times the slope correction (the first two and last two steps by the
    end-point table of the ends' 1/16-px fractions), and each pixel moves
    toward the colour by ``((colour - value) * weight + 127) >> 8`` twice."""
    h, w = img.shape[:2]
    cut = _clip_line(w << _SHIFT, h << _SHIFT, x1, y1, x2, y2)
    if cut is None:
        return
    x1, y1, x2, y2 = cut
    dx, dy = x2 - x1, y2 - y1
    horizontal = abs(dx) > abs(dy)
    if not horizontal:  # walk along y: swap the axes
        x1, y1, x2, y2, dx, dy = y1, x1, y2, x2, dy, dx
    if dx < 0:
        x1, y1, x2, y2, dx, dy = x2, y2, x1, y1, -dx, -dy
    step = _cdiv(dy << _SHIFT, dx | 1)
    x2 += _ONE
    ecount = (x2 >> _SHIFT) - (x1 >> _SHIFT)
    y1 += ((step * -(x1 & (_ONE - 1))) >> _SHIFT) + _HALF
    slope = (step >> (_SHIFT - 5)) & 0x3f
    if step < 0:
        slope ^= 0x3f
    i = (x1 >> (_SHIFT - 7)) & 0x78  # the ends' fractions, in 1/16 px
    j = ((x2 - _ONE) >> (_SHIFT - 7)) & 0x78
    slope = 0x100 if slope & 0x20 else _SLOPE_CORR[slope]
    t0, t1, t2 = slope << 7, ((0x78 - i) | 4) * slope, (j | 4) * slope
    both = ((((j - i) & 0x78) | 4) * slope >> 8) & 0x1ff  # a 1-2 step line
    ep = np.array([0, both, (t1 >> 8) & 0x1ff, both,
                   ((((j - i) + 0x80) | 4) * slope >> 8) & 0x1ff,
                   ((t1 + t0) >> 8) & 0x1ff, (t2 >> 8) & 0x1ff,
                   ((t2 + t0) >> 8) & 0x1ff, slope], np.int64)
    n = np.arange(ecount + 1, dtype=np.int64)
    sc, ec = n, ecount - n
    corr = ep[(((sc >= 2) + 1) & (sc | 2)) * 3 + (((ec >= 2) + 1) & (ec | 2))]
    major = (x1 >> _SHIFT) + n
    minor_pos = y1 + n * step
    dist = (minor_pos >> (_SHIFT - 5)) & 31
    size_major, size_minor = (w, h) if horizontal else (h, w)
    keep = (major >= 0) & (major < size_major)
    c = np.asarray(color, np.int64)
    for off, k in ((0, dist + 32), (1, dist), (2, 63 - dist)):
        minor = (minor_pos >> _SHIFT) - 1 + off
        ok = keep & (minor >= 0) & (minor < size_minor)
        a = ((corr[ok] * _FILTER[k[ok]]) >> 8) & 0xff
        xs, ys = (major[ok], minor[ok]) if horizontal else (minor[ok],
                                                            major[ok])
        v = img[ys, xs].astype(np.int64)
        if img.ndim == 3:
            a = a[:, None]
        for _ in range(2):
            v = v + (((c - v) * a + 127) >> 8)
        img[ys, xs] = v.astype(np.uint8)


def line(img: np.ndarray, pt1, pt2, color, thickness: int = 1,
         line_type: int = LINE_8) -> None:
    """``cv2.line(img, pt1, pt2, color, thickness, line_type)`` (no
    shift): ``LINE_8`` of any thickness, ``LINE_AA`` of thickness 1."""
    img = _canvas(img)
    (x0, y0), (x1, y1) = _point(pt1), _point(pt2)
    color = _colour(color, img)
    if not isinstance(thickness, (int, np.integer)) \
            or not 0 < thickness <= _MAX_THICKNESS:
        raise ValueError(f"thickness is an integer 1-{_MAX_THICKNESS}, "
                         f"not {thickness!r}")
    if line_type not in (LINE_8, LINE_AA):
        raise ValueError(f"line_type is LINE_8 (8) or LINE_AA (16), not "
                         f"{line_type!r}")
    thickness = int(thickness)
    if line_type == LINE_AA:
        if thickness != 1:
            raise ValueError("only a LINE_AA line of thickness 1")
        _line_aa(img, x0 << _SHIFT, y0 << _SHIFT, x1 << _SHIFT, y1 << _SHIFT,
                 color)
        return
    if thickness == 1:
        _line_8(img, x0, y0, x1, y1, color)
        return
    h, w = img.shape[:2]  # cut to the image grown by the thickness first
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
