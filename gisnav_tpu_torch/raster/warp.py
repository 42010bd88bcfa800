"""Fused rotate + optional GSD-zoom + centre crop of a raster stack
(bilinear gather).

Counterpart of ``gisnav_tpu/raster/warp.py`` (``rotation_about_center``,
``warp_affine``, ``rotate_and_crop_center``, ``compose_crs_after_warp``,
``_bilinear_gather``). ``raster.rotate_and_crop_auto`` picks between this
gather warp and the 3-shear rotation (``raster.shear``). All f32; the caller
keeps TF32 off (``device.strict_fp32``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gisnav_tpu_torch.device import scalar_f32

__all__ = ["rotation_about_center", "warp_affine", "rotate_and_crop_center",
           "bilinear_gather", "crop_to_original", "compose_crs_after_warp"]


def rotation_about_center(h: int, w: int, angle_deg: float) -> np.ndarray:
    """2x3 f64 affine mapping ORIGINAL pixel coords to ROTATED ones for an
    (h, w) image rotated by ``angle_deg`` CCW about its integer centre
    ``(w // 2, h // 2)`` (``cv2.getRotationMatrix2D`` at scale 1)."""
    cx, cy = w // 2, h // 2
    a = np.radians(angle_deg)
    c, s = np.cos(a), np.sin(a)
    # CCW content rotation in the y-down pixel frame: [[c, s], [-s, c]]
    return np.array([[c, s, (1.0 - c) * cx - s * cy],
                     [-s, c, s * cx + (1.0 - c) * cy]])


def bilinear_gather(src: torch.Tensor, xs: torch.Tensor,
                    ys: torch.Tensor) -> torch.Tensor:
    """Sample ``src`` (H, W, C) at float coords, zero outside (cv2 bilinear,
    BORDER_CONSTANT 0)."""
    h, w = src.shape[0], src.shape[1]
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    fx = (xs - x0)[..., None]
    fy = (ys - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()

    def tap(yi, xi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        v = src[torch.clamp(yi, 0, h - 1), torch.clamp(xi, 0, w - 1)]
        return torch.where(valid[..., None], v, torch.zeros_like(v))

    v00 = tap(y0i, x0i)
    v01 = tap(y0i, x0i + 1)
    v10 = tap(y0i + 1, x0i)
    v11 = tap(y0i + 1, x0i + 1)
    top = v00 * (1.0 - fx) + v01 * fx
    bot = v10 * (1.0 - fx) + v11 * fx
    return top * (1.0 - fy) + bot * fy


def warp_affine(src: torch.Tensor, dst_to_src: torch.Tensor,
                out_shape: Tuple[int, int]) -> torch.Tensor:
    """``out[y, x] = src(dst_to_src @ (x, y, 1))`` for (H, W, C) ``src``."""
    oh, ow = out_shape
    m = dst_to_src.float()
    ys, xs = torch.meshgrid(
        torch.arange(oh, dtype=torch.float32, device=src.device),
        torch.arange(ow, dtype=torch.float32, device=src.device),
        indexing="ij")
    sx = m[0, 0] * xs + m[0, 1] * ys + m[0, 2]
    sy = m[1, 0] * xs + m[1, 1] * ys + m[1, 2]
    return bilinear_gather(src.float(), sx, sy)


def crop_to_original(angle_deg, cx: int, cy: int, tx, ty, scale=1.0,
                     device=None) -> torch.Tensor:
    """3x3 f32 matrix ``inv_rot @ [[scale, 0, tx], [0, scale, ty], [0, 0,
    1]]``: crop pixel -> original raster pixel for a rotation by
    ``angle_deg`` (CCW, cv2 convention) about ``(cx, cy)``. Built on
    ``device`` (default: the angle's, else the host) in f32 from the ()
    angle, scale and shift (tensors there or host numbers), in the order
    the JAX program computes it."""
    if device is None:
        device = (angle_deg.device if isinstance(angle_deg, torch.Tensor)
                  else torch.device("cpu"))
    a = torch.deg2rad(scalar_f32(angle_deg, device))
    c, s = torch.cos(a), torch.sin(a)
    z, tx, ty = (scalar_f32(v, device) for v in (scale, tx, ty))
    one = torch.ones((), device=device)
    zero = torch.zeros((), device=device)
    shift_scale = torch.stack([
        torch.stack([z, zero, tx]),
        torch.stack([zero, z, ty]),
        torch.stack([zero, zero, one])])
    inv_rot = torch.stack([
        torch.stack([c, -s, cx - c * cx + s * cy]),
        torch.stack([s, c, cy - s * cx - c * cy]),
        torch.stack([zero, zero, one])])
    return inv_rot @ shift_scale


def rotate_and_crop_center(stack: torch.Tensor, angle_deg,
                           crop_shape: Tuple[int, int],
                           zoom=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate an (H, W, C) stack about its centre (CCW, cv2 convention) and
    centre-crop, in one gather. With ``zoom`` (query GSD / map GSD) the
    (h, w) crop samples an (h * zoom, w * zoom) window instead, so the map
    is resampled to the query's ground sample distance. ``angle_deg`` and
    ``zoom`` are host numbers or () tensors on the stack's device (a
    graphed program's inputs); the matrix is built there.

    :return: (crop (h, w, C) f32, 3x3 f32 cropped -> original pixel affine)
    """
    h, w = int(stack.shape[0]), int(stack.shape[1])
    ch, cw = crop_shape
    cx, cy = w // 2, h // 2
    dev = stack.device
    if zoom is not None:
        z = scalar_f32(zoom, dev)
        m = crop_to_original(angle_deg, cx, cy, cx - z * (cw / 2.0),
                             cy - z * (ch / 2.0), z, device=dev)
    else:
        m = crop_to_original(angle_deg, cx, cy, float(cx - cw // 2),
                             float(cy - ch // 2), device=dev)
    return warp_affine(stack, m, (ch, cw)), m


def compose_crs_after_warp(crs_affine_4x4, cropped_to_original_3x3
                           ) -> np.ndarray:
    """Rewrite the pixel -> WGS84 affine so that it applies to the warped
    crop: ``crs @ embed(cropped -> original)``, float64 on the host."""
    if isinstance(cropped_to_original_3x3, torch.Tensor):
        cropped_to_original_3x3 = cropped_to_original_3x3.detach().cpu()
    m = np.asarray(cropped_to_original_3x3, dtype=np.float64)
    embed = np.eye(4)
    embed[:2, :2] = m[:2, :2]
    embed[:2, 3] = m[:2, 2]
    return np.asarray(crs_affine_4x4, dtype=np.float64) @ embed
