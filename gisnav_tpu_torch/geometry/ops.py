"""Device-side geometry in f32 tensors.

Counterpart of ``gisnav_tpu/geometry/jaxops.py``: WGS84 -> ECEF, metres per
degree, the ENU -> ECEF rotation, and a branchless matrix -> quaternion.
"""
from __future__ import annotations

import math

import torch

from gisnav_tpu_torch.geometry.crs import WGS84_A, WGS84_E2

__all__ = ["wgs84_to_ecef", "meters_per_degree", "enu_to_ecef_matrix",
           "matrix_to_quat"]


def wgs84_to_ecef(lon_deg, lat_deg, alt_m) -> torch.Tensor:
    lon = torch.deg2rad(lon_deg)
    lat = torch.deg2rad(lat_deg)
    slat, clat = torch.sin(lat), torch.cos(lat)
    n = WGS84_A / torch.sqrt(1.0 - WGS84_E2 * slat * slat)
    return torch.stack([(n + alt_m) * clat * torch.cos(lon),
                        (n + alt_m) * clat * torch.sin(lon),
                        (n * (1.0 - WGS84_E2) + alt_m) * slat], dim=-1)


def meters_per_degree(lat_deg):
    """(metres per degree of longitude, of latitude) at a latitude."""
    lat = torch.deg2rad(lat_deg)
    slat = torch.sin(lat)
    w2 = 1.0 - WGS84_E2 * slat * slat
    n = WGS84_A / torch.sqrt(w2)
    m = WGS84_A * (1.0 - WGS84_E2) / w2 ** 1.5
    deg = math.pi / 180.0
    return n * torch.cos(lat) * deg, m * deg


def enu_to_ecef_matrix(lon_deg, lat_deg) -> torch.Tensor:
    lon = torch.deg2rad(lon_deg)
    lat = torch.deg2rad(lat_deg)
    slat, clat = torch.sin(lat), torch.cos(lat)
    slon, clon = torch.sin(lon), torch.cos(lon)
    zero = torch.zeros_like(lat)
    return torch.stack([
        torch.stack([-slon, -slat * clon, clat * clon]),
        torch.stack([clon, -slat * slon, clat * slon]),
        torch.stack([zero, clat, slat])])


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """3x3 rotation -> (x, y, z, w), best-conditioned Shepperd branch,
    sign canonicalised to w >= 0."""
    t = m[0, 0] + m[1, 1] + m[2, 2]
    m00, m11, m22 = m[0, 0], m[1, 1], m[2, 2]
    one = torch.ones_like(t)
    qw = torch.stack([m[2, 1] - m[1, 2], m[0, 2] - m[2, 0],
                      m[1, 0] - m[0, 1], one + t])
    qx = torch.stack([one + m00 - m11 - m22, m[0, 1] + m[1, 0],
                      m[0, 2] + m[2, 0], m[2, 1] - m[1, 2]])
    qy = torch.stack([m[0, 1] + m[1, 0], one - m00 + m11 - m22,
                      m[1, 2] + m[2, 1], m[0, 2] - m[2, 0]])
    qz = torch.stack([m[0, 2] + m[2, 0], m[1, 2] + m[2, 1],
                      one - m00 - m11 + m22, m[1, 0] - m[0, 1]])
    scores = torch.stack([one + t, one + m00 - m11 - m22,
                          one - m00 + m11 - m22, one - m00 - m11 + m22])
    # a 1-element index tensor, not a 0-d one (which indexing would read
    # back to the host): the frame programs capture this in a CUDA graph
    q = torch.stack([qw, qx, qy, qz]).index_select(
        0, torch.argmax(scores).reshape(1))[0]
    q = q / torch.linalg.norm(q)
    return q * torch.sign(torch.where(q[3] == 0, one, q[3]))
