"""Fused rotate + GSD-zoom + centre crop of a raster stack (bilinear gather).

Counterpart of ``gisnav_tpu/raster/warp.py`` (``warp_affine``,
``rotate_and_crop_center`` with ``zoom``, ``_bilinear_gather``). The main
path always passes ``zoom``, so this is the gather warp, not the 3-shear
kernel. All f32; the caller keeps TF32 off (``device.strict_fp32``).
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["warp_affine", "rotate_and_crop_center", "bilinear_gather"]


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


def rotate_and_crop_center(stack: torch.Tensor, angle_deg: float,
                           crop_shape: Tuple[int, int], zoom: float
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate an (H, W, C) stack about its centre (CCW, cv2 convention),
    resample to ``zoom`` (query GSD / map GSD) and centre-crop, in one gather.

    :return: (crop (h, w, C) f32, 3x3 f32 cropped -> original pixel affine)
    """
    h, w = int(stack.shape[0]), int(stack.shape[1])
    ch, cw = crop_shape
    cx, cy = w // 2, h // 2
    dev = stack.device
    # f32 scalars, as the JAX program computes them
    a = torch.deg2rad(torch.tensor(angle_deg, dtype=torch.float32))
    c, s = torch.cos(a), torch.sin(a)
    z = torch.tensor(zoom, dtype=torch.float32)
    one, zero = torch.ones(()), torch.zeros(())
    shift_scale = torch.stack([
        torch.stack([z, zero, cx - z * (cw / 2.0)]),
        torch.stack([zero, z, cy - z * (ch / 2.0)]),
        torch.stack([zero, zero, one])])
    inv_rot = torch.stack([
        torch.stack([c, -s, cx - c * cx + s * cy]),
        torch.stack([s, c, cy - s * cx - c * cy]),
        torch.stack([zero, zero, one])])
    cropped_to_original = (inv_rot @ shift_scale).to(dev)
    return warp_affine(stack, cropped_to_original, (ch, cw)), \
        cropped_to_original
