"""1-D shear resample along the last axis: CUDA kernel and plain version.

Counterpart of ``gisnav_tpu/raster/pallas_shear.py``
(``shear_last_axis_pallas``), one pass of the 3-shear rotation::

    out[c, r, x] = lerp(img[c, r, .], x + shift * (r - center_row))

with zeros outside ``[0, W)`` (cv2 BORDER_CONSTANT). The supported set is the
TPU kernel's: a (C, H, W) f32 stack with H and W multiples of 128, W >= 384
and \\|shift\\| < 1 px per row.

A CPU tensor runs the plain version; a CUDA tensor launches
``kernels/shear.cu`` or raises.
"""
from __future__ import annotations

import ctypes

import torch

from gisnav_tpu_torch.kernels import LAUNCHES
from gisnav_tpu_torch.kernels.build import (
    check,
    library,
    ptr,
    stream_of,
    typed,
)

__all__ = ["shear_last_axis", "shear_last_axis_plain", "shear_supported"]


def shear_supported(h: int, w: int) -> bool:
    return h % 128 == 0 and w % 128 == 0 and w >= 384


def shear_last_axis_plain(img: torch.Tensor, shift: float,
                          center_row: float) -> torch.Tensor:
    _, h, w = img.shape
    img = img.float()
    dev = img.device
    rows = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    cols = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    s = torch.tensor(shift, dtype=torch.float32, device=dev)
    xf = cols + s * (rows - center_row)
    i0f = torch.floor(xf)
    frac = xf - i0f
    i0 = i0f.long()

    def tap(i):
        valid = (i >= 0) & (i < w)
        idx = torch.clamp(i, 0, w - 1).expand(img.shape)
        return torch.where(valid, torch.gather(img, 2, idx),
                           torch.zeros((), device=dev))

    return tap(i0) * (1.0 - frac) + tap(i0 + 1) * frac


def _lib():
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return typed(library("shear"), {
        "gisnav_shear_last_axis": [vp, vp, ci, ci, ci, cf, cf, vp]})


def shear_last_axis(img: torch.Tensor, shift: float,
                    center_row: float) -> torch.Tensor:
    """Shear a (C, H, W) f32 stack along its last axis."""
    if img.dim() != 3 or not shear_supported(img.shape[1], img.shape[2]):
        raise ValueError(f"shear_last_axis needs (C, H, W) with H, W "
                         f"multiples of 128 and W >= 384, got "
                         f"{tuple(img.shape)}")
    shift = float(shift)
    if not abs(shift) < 1.0:
        raise ValueError(f"shear_last_axis needs |shift| < 1, got {shift}")
    if not img.is_cuda:
        return shear_last_axis_plain(img, shift, center_row)
    if img.dtype != torch.float32:
        raise TypeError("shear_last_axis takes an f32 stack")
    src = img.contiguous()
    out = torch.empty_like(src)
    c, h, w = src.shape
    check(_lib().gisnav_shear_last_axis(ptr(src), ptr(out), c, h, w, shift,
                                        float(center_row), stream_of(src)),
          "shear_last_axis")
    LAUNCHES["shear_last_axis"] += 1
    return out
