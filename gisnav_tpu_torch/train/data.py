"""Synthetic homography-pair supervision on the host, without OpenCV.

Counterpart of ``gisnav_tpu/train/data.py`` (``MatchBatch``,
``make_homography_batch``): fractal textures from four octaves of uniform
noise, each resized bicubically to the image, and a partner view under a
random homography with its exact 3x3 ground truth. The numpy ``Generator``
is drawn from in the JAX module's order, so one seed gives both modules the
same textures and transforms. The machine with the card has no OpenCV, so
its two calls are rebuilt here in numpy:

- ``cv2.resize(..., INTER_CUBIC)``: Keys' cubic with a = -0.75 at the
  sample points ``(d + 0.5) * in / out - 0.5``, edge indices clamped, as one
  weight matrix an axis;
- ``cv2.warpPerspective``: the inverse map in float64, bilinear taps with a
  zero border (OpenCV 5 samples at the float position; older versions round
  it to 1/32 px first).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from gisnav_tpu_torch.utils.world import cubic_taps

__all__ = ["MatchBatch", "make_homography_batch", "cubic_resize_weights",
           "warp_perspective"]


class MatchBatch(NamedTuple):
    """One batched training example for the matcher (all fixed-size)."""

    image0: np.ndarray  # (B, H, W) float32 in [0, 1]
    image1: np.ndarray  # (B, H, W)
    homography: np.ndarray  # (B, 3, 3) image0 px -> image1 px


def _random_homography(rng, h, w, max_angle=35.0, max_scale=0.25,
                       max_shift=0.15, perspective=2e-4):
    a = np.radians(rng.uniform(-max_angle, max_angle))
    s = 1.0 + rng.uniform(-max_scale, max_scale)
    tx = rng.uniform(-max_shift, max_shift) * w
    ty = rng.uniform(-max_shift, max_shift) * h
    c, si = np.cos(a), np.sin(a)
    cx, cy = w / 2.0, h / 2.0
    center = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1.0]])
    rot = np.array([[s * c, -s * si, 0], [s * si, s * c, 0], [0, 0, 1.0]])
    back = np.array([[1, 0, cx + tx], [0, 1, cy + ty], [0, 0, 1.0]])
    persp = np.eye(3)
    persp[2, 0] = rng.uniform(-perspective, perspective)
    persp[2, 1] = rng.uniform(-perspective, perspective)
    return back @ persp @ rot @ center


def cubic_resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) f32 matrix of OpenCV's bicubic resize along one axis
    (``utils.world.cubic_taps``' weights, summed where clamped taps meet)."""
    idx, c = cubic_taps(n_in, n_out)
    m = np.zeros((n_out, n_in), np.float32)
    np.add.at(m, (np.arange(n_out)[:, None], idx), c)
    return m


def warp_perspective(src: np.ndarray, hom: np.ndarray) -> np.ndarray:
    """``dst(x, y) = src(hom^-1 (x, y))`` of an (H, W) f32 image onto its
    own size: bilinear, zero outside."""
    h, w = src.shape
    minv = np.linalg.inv(np.asarray(hom, np.float64))
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float64),
                         np.arange(w, dtype=np.float64), indexing="ij")
    den = minv[2, 0] * xs + minv[2, 1] * ys + minv[2, 2]
    inv = np.where(den != 0, 1.0 / np.where(den != 0, den, 1.0), 0.0)
    x = (minv[0, 0] * xs + minv[0, 1] * ys + minv[0, 2]) * inv
    y = (minv[1, 0] * xs + minv[1, 1] * ys + minv[1, 2]) * inv
    x0, y0 = np.floor(x), np.floor(y)
    fx, fy = (x - x0).astype(np.float32), (y - y0).astype(np.float32)
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)

    def tap(yy, xx):
        ok = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        v = src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        return np.where(ok, v, np.float32(0))

    one = np.float32(1)
    out = (tap(y0, x0) * ((one - fx) * (one - fy))
           + tap(y0, x0 + 1) * (fx * (one - fy))
           + tap(y0 + 1, x0) * ((one - fx) * fy)
           + tap(y0 + 1, x0 + 1) * (fx * fy))
    return out.astype(np.float32)


def make_homography_batch(rng: np.random.Generator, batch: int,
                          shape=(128, 160)) -> MatchBatch:
    """Generate fractal-textured images and homography-warped partners."""
    h, w = shape
    imgs0 = np.empty((batch, h, w), np.float32)
    imgs1 = np.empty((batch, h, w), np.float32)
    hs = np.empty((batch, 3, 3), np.float64)
    for b in range(batch):
        acc = np.zeros((h, w), np.float32)
        for octave in (4, 16, 64, max(h, w)):
            layer = rng.uniform(0, 1, (octave, octave)).astype(np.float32)
            acc += (cubic_resize_weights(octave, h) @ layer
                    @ cubic_resize_weights(octave, w).T)
        acc = (acc - acc.min()) / max(np.ptp(acc), 1e-6)
        hom = _random_homography(rng, h, w)
        imgs0[b] = acc
        imgs1[b] = warp_perspective(acc, hom)
        hs[b] = hom
    return MatchBatch(image0=imgs0, image1=imgs1,
                      homography=hs.astype(np.float32))
