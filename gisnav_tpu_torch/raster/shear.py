"""Three-shear rotation: rotate + centre crop of a square stack from 1-D
shears.

Counterpart of ``gisnav_tpu/raster/shear.py``
(``rotate_and_crop_center_shear``). A rotation decomposes into

    R(theta) = ShearX(a) . ShearY(b) . ShearX(a),  a = -tan(theta / 2),
                                                   b = sin(theta)

after exact right-angle steps that bring the residual into [-45, 45]
degrees, so \\|a\\| <= tan(22.5 deg) and \\|b\\| <= sin(45 deg). The
x-shears are ``shear_last_axis`` passes and the y-shear one
``shear_first_axis`` pass, which equals the JAX package's x-shear between two
transposes bit for bit without those two copies of the stack. Three
chained linear resamples smooth slightly more than one bilinear pass; the
output geometry and the crop -> original matrix are those of
``warp.rotate_and_crop_center``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from gisnav_tpu_torch.raster.shear_kernel import (
    shear_first_axis,
    shear_first_axis_plain,
    shear_last_axis,
    shear_last_axis_plain,
)
from gisnav_tpu_torch.raster.warp import crop_to_original

__all__ = ["rotate_and_crop_center_shear"]


def _rot90_exact(img: torch.Tensor, k4: int) -> torch.Tensor:
    """Exact rotation by k4 * 90 degrees about the integer centre
    (N // 2, N // 2) of an even square (C, N, N) stack: transposes, flips
    and a one-pixel roll whose wrapped row/column is zeroed (the centre is
    N // 2, not (N - 1) / 2)."""
    if k4 == 0:
        return img
    if k4 == 1:  # out[y, x] = src[x, n - y]
        t = torch.roll(torch.flip(img.transpose(-1, -2), dims=(-2,)), 1, -2)
        t[:, 0, :] = 0.0
        return t
    if k4 == 2:  # out[y, x] = src[n - y, n - x]
        t = torch.roll(torch.flip(img, dims=(-1, -2)), (1, 1), (-2, -1))
        t[:, 0, :] = 0.0
        t[:, :, 0] = 0.0
        return t
    t = torch.roll(torch.flip(img.transpose(-1, -2), dims=(-1,)), 1, -1)
    t[:, :, 0] = 0.0  # out[y, x] = src[n - x, y]
    return t


def rotate_and_crop_center_shear(stack: torch.Tensor, angle_deg: float,
                                 crop_shape: Tuple[int, int]
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate a SQUARE (N, N, C) stack about its centre (CCW, cv2
    convention) and centre-crop. A stack on the card goes through the CUDA
    shear kernels, which raise unless N % 128 == 0 and N >= 384; a CPU stack
    of any side runs the plain shears.

    :return: (crop (h, w, C) f32, 3x3 f32 cropped -> original pixel affine)
    """
    hh, ww = int(stack.shape[0]), int(stack.shape[1])
    if hh != ww:
        raise ValueError("the shear rotation needs a square raster")
    shear_x, shear_y = ((shear_last_axis, shear_first_axis) if stack.is_cuda
                        else (shear_last_axis_plain, shear_first_axis_plain))
    ch, cw = crop_shape
    cx, cy = ww // 2, hh // 2
    img = stack.float().permute(2, 0, 1)  # (C, H, W)

    # f32 scalars, as the JAX program computes them
    angle = np.float32(angle_deg)
    k = int(np.round(angle / np.float32(90.0)))
    residual = np.radians(angle - np.float32(90.0) * np.float32(k),
                          dtype=np.float32)
    img = _rot90_exact(img, k % 4)
    a = float(-np.tan(residual / np.float32(2.0), dtype=np.float32))
    b = float(np.sin(residual, dtype=np.float32))

    img = shear_x(img, a, float(cy))
    img = shear_y(img, b, float(cx))
    img = shear_x(img, a, float(cy))

    dx, dy = cx - cw // 2, cy - ch // 2
    crop = img[:, dy:dy + ch, dx:dx + cw].permute(1, 2, 0).contiguous()
    return crop, crop_to_original(angle_deg, cx, cy, float(dx),
                                  float(dy)).to(stack.device)
