"""Keypoint NMS + fixed-size top-K selection.

Counterpart of ``gisnav_tpu/features/nms.py``, whose two routes are two
functions here:

- ``select_keypoints``, the fused-kernel route: one pass of ``nms_select``
  gives each 4x4 cell's NMS'd maximum and refined position, then a top-K
  over the cell maxima and a table lookup give K keypoints with static
  shapes (padded slots score 0 and are masked invalid downstream);
- ``select_keypoints_tiled``, the route the JAX package runs outside any
  kernel, over the tiles of a large raster as one batch: ``simple_nms``, the
  border mask, the cell maximum, the per-cell argmax on the NMS'd map with
  soft-argmax offsets from the raw one (or, where the cells do not fit, a
  top-K over all pixels and ``refine_subpixel``). ``select_keypoints`` with
  ``prefer_kernel=False`` takes that route too, over a batch of whole maps:
  it is the JAX package's training route, and gradients flow through the
  soft-argmax offsets into the heatmap.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from gisnav_tpu_torch.features.nms_kernel import nms_select

__all__ = ["simple_nms", "select_keypoints", "select_keypoints_tiled",
           "refine_subpixel"]

_BLOCK = 4
_RADIUS = 4


def simple_nms(scores: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Zero every pixel of (..., H, W) that is not the maximum of its
    (2 * radius + 1)^2 window (windows are cut at the edges)."""
    lead = scores.shape[:-2]
    flat = scores.reshape(-1, 1, *scores.shape[-2:])
    pooled = F.max_pool2d(flat, 2 * radius + 1, stride=1, padding=radius)
    pooled = pooled.reshape(*lead, *scores.shape[-2:])
    return torch.where(scores == pooled, scores, torch.zeros_like(scores))


def _softargmax_offset_maps(heat: torch.Tensor, temperature: float = 0.1):
    """Per-pixel 3x3 soft-argmax offsets of (B, H, W) maps, edge-replicated,
    clipped to +-0.5 px."""
    _, h, w = heat.shape
    pad = F.pad(heat[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]

    def shifted(dy, dx):
        return pad[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    m = heat
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                m = torch.maximum(m, shifted(dy, dx))
    s = torch.zeros_like(heat)
    sx = torch.zeros_like(heat)
    sy = torch.zeros_like(heat)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            e = torch.exp((shifted(dy, dx) - m) / temperature)
            s = s + e
            sx = sx + e * dx
            sy = sy + e * dy
    return torch.clamp(sx / s, -0.5, 0.5), torch.clamp(sy / s, -0.5, 0.5)


def _to_cells(m: torch.Tensor, block: int) -> torch.Tensor:
    b, h, w = m.shape
    c = m.reshape(b, h // block, block, w // block, block)
    return c.permute(0, 1, 3, 2, 4).reshape(b, -1, block * block)


def _cell_keypoint_table(argmax_src: torch.Tensor, refine_src: torch.Tensor,
                         block: int) -> torch.Tensor:
    """(B, hb * wb, 2) refined xy keypoint of every block cell: the cell's
    first argmax of ``argmax_src`` plus the soft-argmax offset of
    ``refine_src`` there."""
    _, _, w = argmax_src.shape
    wb = w // block
    inner = torch.argmax(_to_cells(argmax_src, block), dim=2)
    dx_map, dy_map = _softargmax_offset_maps(refine_src)
    ids = torch.arange(inner.shape[1], device=inner.device)[None]
    by = (ids // wb) * block + inner // block
    bx = (ids % wb) * block + inner % block
    pick = inner[..., None]
    return torch.stack(
        [bx.float() + torch.gather(_to_cells(dx_map, block), 2, pick)[..., 0],
         by.float() + torch.gather(_to_cells(dy_map, block), 2, pick)[..., 0]],
        dim=2)


def refine_subpixel(heatmap: torch.Tensor, keypoints: torch.Tensor,
                    temperature: float = 0.1) -> torch.Tensor:
    """Soft-argmax over the 3x3 neighbourhood (clamped at the edges) of each
    integer-valued xy peak of an (H, W) heatmap; offsets clipped to +-0.5."""
    h, w = heatmap.shape
    x, y = keypoints[:, 0].long(), keypoints[:, 1].long()
    offs = torch.tensor([-1, 0, 1], device=heatmap.device)
    yy = torch.clamp(y[:, None, None] + offs[None, :, None], 0, h - 1)
    xx = torch.clamp(x[:, None, None] + offs[None, None, :], 0, w - 1)
    vals = heatmap[yy, xx]
    weights = torch.softmax(vals.reshape(-1, 9) / temperature,
                            dim=-1).reshape(-1, 3, 3)
    dx = (weights * offs[None, None, :].float()).sum(dim=(1, 2))
    dy = (weights * offs[None, :, None].float()).sum(dim=(1, 2))
    return keypoints + torch.clamp(torch.stack([dx, dy], dim=1), -0.5, 0.5)


def _select_plain(heat: torch.Tensor, max_keypoints: int,
                  score_threshold: float, border: int):
    """The kernel-less route over a (B, H, W) batch of tiles
    -> (B, K, 2), (B, K), (B, K)."""
    _, h, w = heat.shape
    block = _BLOCK
    nms = simple_nms(heat, _RADIUS)
    ys = torch.arange(h, device=heat.device)[:, None]
    xs = torch.arange(w, device=heat.device)[None, :]
    in_border = ((xs >= border) & (xs < w - border) & (ys >= border)
                 & (ys < h - border))
    nms = torch.where(in_border, nms, torch.zeros_like(nms))
    if h % block == 0 and w % block == 0 and \
            (h // block) * (w // block) >= max_keypoints:
        cell_max = _to_cells(nms, block).amax(dim=2)
        scores, cell_idx = torch.topk(cell_max, max_keypoints, dim=1)
        table = _cell_keypoint_table(nms, heat, block)
        keypoints = torch.gather(table, 1,
                                 cell_idx[..., None].expand(-1, -1, 2))
        return keypoints, scores, scores > score_threshold
    scores, idx = torch.topk(nms.reshape(nms.shape[0], -1), max_keypoints,
                             dim=1)
    keypoints = torch.stack([(idx % w).float(), (idx // w).float()], dim=2)
    keypoints = torch.stack([refine_subpixel(hm, kp)
                             for hm, kp in zip(heat, keypoints)])
    return keypoints, scores, scores > score_threshold


def select_keypoints(
    heatmap: torch.Tensor,
    max_keypoints: int,
    score_threshold: float = 0.0005,
    border: int = 4,
    prefer_kernel: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(H, W) heatmap -> (keypoints (K, 2) xy f32, scores (K,), valid (K,)).

    Heights that are not a multiple of 32 (1088 is one, 1080 is not) get the
    treatment of the JAX package's padded kernel call: rows at or below
    ``h - border`` are zeroed first, so they neither survive nor suppress.

    ``prefer_kernel=False`` is the JAX package's ``prefer_pallas=False``
    route, the one its training takes: no kernel, a (B, H, W) batch as well
    as one map, and differentiable, since the positions carry the raw
    heatmap's soft-argmax offsets.
    """
    h, w = heatmap.shape[-2:]
    if not prefer_kernel:
        single = heatmap.dim() == 2
        heat = heatmap.float()[None] if single else heatmap.float()
        out = _select_plain(heat, max_keypoints, score_threshold, border)
        return tuple(t[0] for t in out) if single else out
    if (h // _BLOCK) * (w // _BLOCK) < max_keypoints:
        raise ValueError(
            f"{h}x{w} has fewer 4x4 cells than max_keypoints={max_keypoints}")
    heat = heatmap.float()
    if h % 32:
        rows = torch.arange(h, device=heat.device)[:, None]
        heat = torch.where(rows < h - border, heat, torch.zeros_like(heat))
    cell_max, cell_x, cell_y = nms_select(heat, border)
    scores, cell_idx = torch.topk(cell_max.reshape(-1), max_keypoints)
    table = torch.stack([cell_x.reshape(-1), cell_y.reshape(-1)], dim=1)
    keypoints = table[cell_idx]
    return keypoints, scores, scores > score_threshold


def select_keypoints_tiled(
    heatmap: torch.Tensor,
    max_keypoints: int,
    tiles: Tuple[int, int],
    score_threshold: float = 0.0005,
    border: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Spatially uniform top-K: the budget is split evenly over a ``tiles``
    grid and each tile selects on its own (tile-local NMS window and border,
    outside any kernel), so every region of a large reference raster holds its
    share. Fewer than ``max_keypoints`` slots are padded invalid. Takes one
    (H, W) map or a (B, H, W) batch, and is differentiable as the
    kernel-less route of :func:`select_keypoints` is."""
    ty, tx = tiles
    single = heatmap.dim() == 2
    heat = heatmap.float()[None] if single else heatmap.float()
    b, h, w = heat.shape
    th, tw = h // ty, w // tx
    k_tile = max(1, max_keypoints // (ty * tx))
    tiled = heat.reshape(b, ty, th, tx, tw).permute(0, 1, 3, 2, 4)
    kp, sc, valid = _select_plain(tiled.reshape(b * ty * tx, th, tw), k_tile,
                                  score_threshold, border)
    tids = torch.arange(ty * tx, device=heat.device)
    off = torch.stack([((tids % tx) * tw).float(),
                       ((tids // tx) * th).float()], dim=1)
    kp = kp.reshape(b, ty * tx, k_tile, 2) + off[None, :, None, :]
    n = ty * tx * k_tile
    kp, sc, valid = kp.reshape(b, n, 2), sc.reshape(b, n), valid.reshape(b, n)
    if n < max_keypoints:
        pad = max_keypoints - n
        kp = torch.cat([kp, kp.new_zeros((b, pad, 2))], dim=1)
        sc = torch.cat([sc, sc.new_zeros((b, pad))], dim=1)
        valid = torch.cat([valid, valid.new_zeros((b, pad))], dim=1)
    return (kp[0], sc[0], valid[0]) if single else (kp, sc, valid)
