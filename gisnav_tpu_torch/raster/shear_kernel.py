"""1-D shear resamples of a stack: CUDA kernels and plain versions.

Counterpart of ``gisnav_tpu/raster/pallas_shear.py``
(``shear_last_axis_pallas``), one pass of the 3-shear rotation::

    last axis:  out[c, r, x] = lerp(img[c, r, .], x + shift * (r - center_row))
    first axis: out[c, y, x] = lerp(img[c, ., x], y + shift * (x - center_col))

with zeros outside the image (cv2 BORDER_CONSTANT). The first axis is the
last-axis shear of the transposed stack, transposed back, bit for bit: the
JAX package's y-shear, which runs the TPU kernel between two transposes. The
supported set is the TPU kernel's: a (C, H, W) f32 stack with H and W
multiples of 128, W >= 384 (H >= 384 along the first axis) and \\|shift\\| < 1
px per line. Each entry counts its launches under its own name.

The shift is a host number or a () f32 tensor on the stack's device. A
tensor is read by the kernel from device memory (a graphed rotation's
residual shears, computed on the card), so its bound is checked there:
a shift outside (-1, 1) gives a NaN output rather than a host read.

A CPU tensor runs the plain version; a CUDA tensor launches
``kernels/shear.cu`` or raises.
"""
from __future__ import annotations

import ctypes

import torch

from gisnav_tpu_torch.device import scalar_f32
from gisnav_tpu_torch.kernels import LAUNCHES
from gisnav_tpu_torch.kernels.build import (
    aligned16,
    check,
    library,
    on_device,
    ptr,
    stream_of,
    typed,
)

__all__ = ["shear_first_axis", "shear_first_axis_plain", "shear_last_axis",
           "shear_last_axis_plain", "shear_supported"]


def shear_supported(h: int, w: int) -> bool:
    return h % 128 == 0 and w % 128 == 0 and w >= 384


def _resample(img: torch.Tensor, pos: torch.Tensor, dim: int
              ) -> torch.Tensor:
    """Linear resample of a (C, H, W) f32 stack along ``dim`` at the source
    coordinates ``pos`` (H, W), zeros outside."""
    n = img.shape[dim]
    i0f = torch.floor(pos)
    frac = pos - i0f
    i0 = i0f.long()

    def tap(i):
        valid = (i >= 0) & (i < n)
        idx = torch.clamp(i, 0, n - 1).expand(img.shape)
        return torch.where(valid, torch.gather(img, dim, idx),
                           torch.zeros((), device=img.device))

    return tap(i0) * (1.0 - frac) + tap(i0 + 1) * frac


def _grid(img: torch.Tensor, shift):
    _, h, w = img.shape
    dev = img.device
    return (torch.arange(h, dtype=torch.float32, device=dev)[:, None],
            torch.arange(w, dtype=torch.float32, device=dev)[None, :],
            scalar_f32(shift, dev))


def shear_last_axis_plain(img: torch.Tensor, shift,
                          center_row: float) -> torch.Tensor:
    rows, cols, s = _grid(img, shift)
    return _resample(img.float(), cols + s * (rows - center_row), 2)


def shear_first_axis_plain(img: torch.Tensor, shift,
                           center_col: float) -> torch.Tensor:
    """The same f32 expression as ``shear_last_axis_plain`` on the
    transposed stack, so the two routes agree bit for bit."""
    rows, cols, s = _grid(img, shift)
    return _resample(img.float(), rows + s * (cols - center_col), 1)


def _lib():
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sig = [vp, vp, ci, ci, ci, cf, vp, cf, vp]
    return typed(library("shear"), {"gisnav_shear_last_axis": sig,
                                    "gisnav_shear_first_axis": sig})


def _launch(entry: str, img: torch.Tensor, shift,
            center: float) -> torch.Tensor:
    if img.dtype != torch.float32:
        raise TypeError(f"{entry} takes an f32 stack")
    src = aligned16(img)
    out = torch.empty_like(src)
    c, h, w = src.shape
    if isinstance(shift, torch.Tensor):
        if shift.device != src.device or shift.dtype != torch.float32 \
                or shift.dim() != 0:
            raise ValueError(f"{entry} takes its shift as a () f32 tensor "
                             f"on the stack's device")
        value, at = 0.0, ptr(shift.contiguous())
    else:
        value, at = shift, None
    with on_device(src):
        check(getattr(_lib(), "gisnav_" + entry)(
            ptr(src), ptr(out), c, h, w, value, at, float(center),
            stream_of(src)), entry)
    LAUNCHES[entry] += 1
    return out


def _checked_shift(entry: str, img: torch.Tensor, sides, shift):
    """Raise unless ``img`` is a stack whose ``sides`` (across and along the
    sheared lines) are in the supported set, and a host shift has
    \\|shift\\| < 1 (a tensor's is the kernel's to check)."""
    if img.dim() != 3 or not shear_supported(*sides):
        raise ValueError(f"{entry} needs (C, H, W) with H, W multiples of "
                         f"128 and the sheared axis >= 384, got "
                         f"{tuple(img.shape)}")
    if isinstance(shift, torch.Tensor):
        return shift
    shift = float(shift)
    if not abs(shift) < 1.0:
        raise ValueError(f"{entry} needs |shift| < 1, got {shift}")
    return shift


def shear_last_axis(img: torch.Tensor, shift,
                    center_row: float) -> torch.Tensor:
    """Shear a (C, H, W) f32 stack along its last axis."""
    shift = _checked_shift("shear_last_axis", img, img.shape[-2:], shift)
    if not img.is_cuda:
        return shear_last_axis_plain(img, shift, center_row)
    return _launch("shear_last_axis", img, shift, center_row)


def shear_first_axis(img: torch.Tensor, shift,
                     center_col: float) -> torch.Tensor:
    """Shear a (C, H, W) f32 stack along its first image axis:
    ``shear_last_axis(img.transpose(-1, -2), shift, center_col)``
    transposed back, in one pass with no transpose."""
    shift = _checked_shift("shear_first_axis", img, img.shape[-2:][::-1],
                           shift)
    if not img.is_cuda:
        return shear_first_axis_plain(img, shift, center_col)
    return _launch("shear_first_axis", img, shift, center_col)
