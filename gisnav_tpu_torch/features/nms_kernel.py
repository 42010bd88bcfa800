"""Fused NMS + per-cell keypoint select: CUDA kernel and its plain version.

Counterpart of ``gisnav_tpu/features/pallas_nms.py`` ``nms_select_pallas``:
(H, W) f32 heatmap -> ``(cell_max, cell_x, cell_y)``, each (H/4, W/4) f32.
9x9 NMS (``core >= pooled``) with border suppression, 4x4 cell max, and per
cell the sub-pixel position of its survivors (3x3 soft-argmax on the raw
heatmap, temperature 0.1, clipped to +-0.5 px), averaged over tied survivors;
0 for empty cells. Pixels outside the image read as zero.

``nms_cellmax`` is the counterpart of ``nms_cellmax_pallas``: the NMS and
cell-max half alone, (H, W) -> (H/4, W/4), the kernel's second entry point.
Its cell maxima are bit-identical to ``nms_select``'s.

A CPU tensor runs the plain version; a CUDA tensor launches
``kernels/nms_select.cu`` or raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

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

__all__ = ["nms_select", "nms_select_plain", "nms_cellmax",
           "nms_cellmax_plain", "nms_cellmax_supported"]

_RADIUS = 4
_BLOCK = 4


def _nms_keep(core: torch.Tensor, border: int):
    """9x9 NMS survivors inside the border, and the pixel index grids."""
    h, w = core.shape
    r = _RADIUS
    pooled = F.max_pool2d(F.pad(core, (r, r, r, r))[None, None], 2 * r + 1,
                          stride=1)[0, 0]
    ys = torch.arange(h, device=core.device)[:, None]
    xs = torch.arange(w, device=core.device)[None, :]
    keep = ((core >= pooled) & (xs >= border) & (xs < w - border)
            & (ys >= border) & (ys < h - border))
    return keep, xs, ys


def nms_cellmax_plain(heatmap: torch.Tensor, border: int) -> torch.Tensor:
    h, w = heatmap.shape
    core = heatmap.float()
    keep, _, _ = _nms_keep(core, border)
    nms = torch.where(keep, core, torch.zeros_like(core))
    return nms.reshape(h // _BLOCK, _BLOCK, w // _BLOCK, _BLOCK).amax(
        dim=(1, 3))


def nms_select_plain(heatmap: torch.Tensor, border: int,
                     temperature: float = 0.1
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    h, w = heatmap.shape
    core = heatmap.float()
    keep, xs, ys = _nms_keep(core, border)
    nms = torch.where(keep, core, torch.zeros_like(core))

    pad = F.pad(core, (1, 1, 1, 1))

    def win(dy, dx):
        return pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    m3 = core
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                m3 = torch.maximum(m3, win(dy, dx))
    inv_t = 1.0 / float(temperature)
    s = torch.zeros_like(core)
    sx = torch.zeros_like(core)
    sy = torch.zeros_like(core)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            e = torch.exp((win(dy, dx) - m3) * inv_t)
            s = s + e
            sx = sx + e * dx
            sy = sy + e * dy
    dxm = torch.clamp(sx / s, -0.5, 0.5)
    dym = torch.clamp(sy / s, -0.5, 0.5)
    mask = (keep & (core > 0.0)).float()
    px = mask * (xs.float() + dxm)
    py = mask * (ys.float() + dym)

    def cells(m, reduce):
        c = m.reshape(h // _BLOCK, _BLOCK, w // _BLOCK, _BLOCK)
        return c.amax(dim=(1, 3)) if reduce == "max" else c.sum(dim=(1, 3))

    denom = torch.clamp(cells(mask, "sum"), min=1.0)
    return (cells(nms, "max"), cells(px, "sum") / denom,
            cells(py, "sum") / denom)


def _lib():
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return typed(library("nms_select"), {
        "gisnav_nms_select": [vp, vp, vp, vp, ci, ci, ci, ctypes.c_float,
                              vp],
        "gisnav_nms_cellmax": [vp, vp, ci, ci, ci, vp]})


def nms_select(heatmap: torch.Tensor, border: int, temperature: float = 0.1
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(H, W) heatmap, H and W multiples of 4 -> 3 x (H/4, W/4) f32, the
    three views of one (3, H/4, W/4) allocation."""
    h, w = heatmap.shape
    if h % _BLOCK or w % _BLOCK:
        raise ValueError(f"nms_select needs H, W multiples of 4, got {(h, w)}")
    out = torch.empty((3, h // _BLOCK, w // _BLOCK), dtype=torch.float32,
                      device=heatmap.device)
    if not heatmap.is_cuda:
        torch.stack(nms_select_plain(heatmap, border, temperature), out=out)
        return out.unbind(0)
    if heatmap.dtype != torch.float32:
        raise TypeError("nms_select takes an f32 heatmap")
    heat = aligned16(heatmap)
    with on_device(heat):
        check(_lib().gisnav_nms_select(ptr(heat), *(ptr(o) for o in out), h,
                                       w, int(border),
                                       1.0 / float(temperature),
                                       stream_of(heat)), "nms_select")
    LAUNCHES["nms_select"] += 1
    return out.unbind(0)


def nms_cellmax_supported(h: int, w: int, border: int) -> bool:
    """The shapes ``nms_cellmax_pallas`` takes (radius 4, block 4)."""
    return border >= 1 and h % 32 == 0 and w % 128 == 0 and w >= 256


def nms_cellmax(heatmap: torch.Tensor, border: int) -> torch.Tensor:
    """(H, W) heatmap -> (H/4, W/4) NMS'd cell maxima."""
    h, w = heatmap.shape
    if not nms_cellmax_supported(h, w, border):
        raise ValueError(f"nms_cellmax needs H % 32 == 0, W % 128 == 0, "
                         f"W >= 256 and border >= 1, got {(h, w, border)}")
    if not heatmap.is_cuda:
        return nms_cellmax_plain(heatmap, border)
    if heatmap.dtype != torch.float32:
        raise TypeError("nms_cellmax takes an f32 heatmap")
    heat = aligned16(heatmap)
    out = torch.empty((h // _BLOCK, w // _BLOCK), dtype=torch.float32,
                      device=heat.device)
    with on_device(heat):
        check(_lib().gisnav_nms_cellmax(ptr(heat), ptr(out), h, w,
                                        int(border), stream_of(heat)),
              "nms_cellmax")
    LAUNCHES["nms_cellmax"] += 1
    return out
