"""Overlap-gated orthoimage cache (host).

The port's own copy of ``gisnav_tpu/gis/cache.py``. The reference requests
a new WMS map only when the projected-FOV bbox's overlap with the current
map drops below 0.85 (``core/gis_node.py:124-128,451-487`` in
hmakelin/gisnav). The device copies of a map belong to the deep runners,
which upload it once per map stamp; ``on_update`` runs a caller's hook on
each new map.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from gisnav_tpu_torch.geometry.bbox import BBox, bbox_overlap_fraction
from gisnav_tpu_torch.geometry.crs import affine_to_proj, pixel_to_wgs84_affine

__all__ = ["OrthoImage", "OrthoImageCache"]


@dataclasses.dataclass
class OrthoImage:
    """One atomic orthoimage: imagery + DEM + CRS (the reference's
    ``OrthoImage.msg`` equivalent)."""

    image: np.ndarray  # (H, W) uint8 grayscale
    dem: np.ndarray  # (H, W) float32 meters
    bbox: BBox
    crs_affine: np.ndarray  # (4, 4) pixel->WGS84 (float64)
    stamp_us: int = 0

    @property
    def crs_proj(self) -> str:
        return affine_to_proj(self.crs_affine)


class OrthoImageCache:
    """Holds the current map and decides when a refresh is needed.

    :param min_overlap: refresh below this overlap fraction (reference
        default 0.85, ``gis_node.py:124-128``)
    :param on_update: optional callback run with the new OrthoImage after an
        update
    """

    def __init__(self, min_overlap: float = 0.85,
                 on_update: Optional[Callable[[OrthoImage], None]] = None):
        self.min_overlap = min_overlap
        self.on_update = on_update
        self._current: Optional[OrthoImage] = None

    @property
    def current(self) -> Optional[OrthoImage]:
        return self._current

    def needs_update(self, bbox: BBox) -> bool:
        """True when no map is held or the new bbox's overlap with the held
        map drops below the threshold."""
        if self._current is None:
            return True
        return (
            bbox_overlap_fraction(bbox, self._current.bbox) < self.min_overlap
        )

    def update(self, image: np.ndarray, dem: np.ndarray, bbox: BBox,
               stamp_us: int = 0) -> OrthoImage:
        """Install a new map (computes the pixel->WGS84 affine)."""
        h, w = image.shape[:2]
        aff = pixel_to_wgs84_affine(h, w, bbox.left, bbox.bottom, bbox.right,
                                    bbox.top)
        ortho = OrthoImage(
            image=image, dem=dem, bbox=bbox, crs_affine=aff, stamp_us=stamp_us
        )
        self._current = ortho
        if self.on_update is not None:
            self.on_update(ortho)
        return ortho
