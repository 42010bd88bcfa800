"""EGM96 geoid undulation lookup (ellipsoid height <-> AMSL).

The port's own copy of ``gisnav_tpu/geometry/geoid.py`` and of its grid
(``gisnav_tpu_torch/data/egm96_grid.npz``, the same bytes): a 0.5-degree
EGM96 undulation grid (subsampled from the public ``egm96_15.gtx``, at most
1.2 m off the 15-minute grid), interpolated bilinearly. The reference
converts its vertical datum with pyproj's EGM96 transform
(``extensions/_mock_gps_node.py:57-65,392-408`` in hmakelin/gisnav).

Where the JAX package prefers a host PROJ installation's 15-minute grid
when one exists, the port reads only the grid it ships, so its altitudes do
not depend on what the host has installed.
"""
from __future__ import annotations

import functools
import os
from typing import Tuple

import numpy as np

__all__ = ["geoid_height", "load_grid", "EMBEDDED_GRID_PATH"]

EMBEDDED_GRID_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
    "egm96_grid.npz")


@functools.lru_cache(maxsize=1)
def load_grid() -> Tuple[np.ndarray, float, float, float, float]:
    """(grid f32, lat0, lon0, dlat, dlon) of the shipped grid, read once."""
    with np.load(EMBEDDED_GRID_PATH) as d:
        return (d["grid"].astype(np.float32), float(d["lat0"]),
                float(d["lon0"]), float(d["dlat"]), float(d["dlon"]))


def geoid_height(lon: float, lat: float) -> float:
    """EGM96 geoid undulation N (metres) at (lon, lat) degrees.

    ``alt_amsl = alt_ellipsoid - N``. Bilinear, longitude wraps around,
    latitude is clamped to the grid; a non-finite input gives NaN.
    """
    grid, lat0, lon0, dlat, dlon = load_grid()
    nr, nc = grid.shape
    if not (np.isfinite(lat) and np.isfinite(lon)):
        return float("nan")
    i = (float(lat) - lat0) / dlat
    j = ((float(lon) - lon0) % 360.0) / dlon
    i0 = int(np.clip(np.floor(i), 0, nr - 2))
    fi = np.clip(i - i0, 0.0, 1.0)
    j0 = int(np.floor(j)) % nc
    fj = j - np.floor(j)
    j1 = (j0 + 1) % nc
    return float(grid[i0, j0] * (1 - fi) * (1 - fj)
                 + grid[i0, j1] * (1 - fi) * fj
                 + grid[i0 + 1, j0] * fi * (1 - fj)
                 + grid[i0 + 1, j1] * fi * fj)
