"""DEM elevation lookup for matched reference keypoints.

Counterpart of ``gisnav_tpu/pnp/dem.py``: ``gather_elevation`` samples the
DEM at the floored pixel of each keypoint (the reference's
``core/_shared.py:95-102`` in hmakelin/gisnav), ``keypoints_to_3d`` lifts
2-D reference keypoints to 3-D object points with it. Both run on the
tensors' device.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["gather_elevation", "keypoints_to_3d"]


def gather_elevation(dem: torch.Tensor, pts_xy: torch.Tensor) -> torch.Tensor:
    """DEM at floored pixel coords of (N, 2) xy; 0 outside the raster."""
    h, w = dem.shape
    x = torch.floor(pts_xy[:, 0]).long()
    y = torch.floor(pts_xy[:, 1]).long()
    valid = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    z = dem[torch.clamp(y, 0, h - 1), torch.clamp(x, 0, w - 1)]
    return torch.where(valid, z, torch.zeros_like(z))


def keypoints_to_3d(pts_xy: torch.Tensor,
                    dem: Optional[torch.Tensor]) -> torch.Tensor:
    """(N, 2) reference keypoints -> (N, 3) object points (x, y, z_dem) in
    ``pts_xy``'s dtype. With ``dem=None`` the ground is flat (z = 0), as on
    the VO path (``core/twist_node.py:289`` passes a zero elevation)."""
    if dem is None:
        z = torch.zeros(pts_xy.shape[0], dtype=pts_xy.dtype,
                        device=pts_xy.device)
    else:
        z = gather_elevation(dem, pts_xy).to(pts_xy.dtype)
    return torch.cat([pts_xy, z[:, None]], dim=1)
