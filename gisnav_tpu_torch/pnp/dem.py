"""DEM elevation lookup for matched reference keypoints.

Counterpart of ``gisnav_tpu/pnp/dem.py`` ``gather_elevation``.
"""
from __future__ import annotations

import torch

__all__ = ["gather_elevation"]


def gather_elevation(dem: torch.Tensor, pts_xy: torch.Tensor) -> torch.Tensor:
    """DEM at floored pixel coords of (N, 2) xy; 0 outside the raster."""
    h, w = dem.shape
    x = torch.floor(pts_xy[:, 0]).long()
    y = torch.floor(pts_xy[:, 1]).long()
    valid = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    z = dem[torch.clamp(y, 0, h - 1), torch.clamp(x, 0, w - 1)]
    return torch.where(valid, z, torch.zeros_like(z))
