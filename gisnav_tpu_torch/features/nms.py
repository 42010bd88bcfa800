"""Keypoint NMS + fixed-size top-K selection.

Counterpart of ``gisnav_tpu/features/nms.py`` ``select_keypoints`` on its
fused-kernel route: one pass of ``nms_select`` gives each 4x4 cell's
NMS'd maximum and refined position, then a top-K over the cell maxima and a
table lookup give K keypoints with static shapes (padded slots score 0 and
are masked invalid downstream).
"""
from __future__ import annotations

from typing import Tuple

import torch

from gisnav_tpu_torch.features.nms_kernel import nms_select

__all__ = ["select_keypoints"]

_BLOCK = 4


def select_keypoints(
    heatmap: torch.Tensor,
    max_keypoints: int,
    score_threshold: float = 0.0005,
    border: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(H, W) heatmap -> (keypoints (K, 2) xy f32, scores (K,), valid (K,)).

    Heights that are not a multiple of 32 (1088 is one, 1080 is not) get the
    treatment of the JAX package's padded kernel call: rows at or below
    ``h - border`` are zeroed first, so they neither survive nor suppress.
    """
    h, w = heatmap.shape
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
