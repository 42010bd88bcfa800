"""Classical (SIFT + MNN) frame -> geopose program.

Counterpart of ``gisnav_tpu/pipeline/classical.py``: the deep pipeline's
rotate + crop, the port's SIFT on the query and the crop (one batched
pyramid, on the device, no OpenCV), the distance-matrix matcher with ratio
test and mutual check, DEM z-lift, RANSAC-PnP and geopose assembly.

The rotate + crop is ``rotate_and_crop_auto`` without zoom: on the card, a
square map whose side the shear kernel serves takes the 3-shear rotation
(K6: two last-axis launches and one first-axis launch), any other stack the
gather. Every entry point turns TF32 off (``device.strict_fp32``): the SIFT
blurs are ``F.conv2d`` products, and the matcher's distances and RANSAC's
solves need true f32.

On the card the two device programs the JAX package jits are each one
CUDA graph replay (``pipeline.graph.FrameGraph``): the rotate + crop a
(map signature, crop shape, 3-shear quadrant), the angle a () input and
the map and DEM sticky, and the tail (match + z-lift + PnP + geopose) a
config, RANSAC's noise drawn ahead from the seeded generator. SIFT stays
eager between them, as the JAX package runs OpenCV's on the host outside
any ``jit``; ``pad_features`` gives the tail fixed shapes. ``GRAPHS``
holds the captured programs.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from gisnav_tpu_torch.device import resolve_device, strict_fp32
from gisnav_tpu_torch.features.sift import extract_sift_batch, pad_features
from gisnav_tpu_torch.matching.mnn import mnn_ratio_match
from gisnav_tpu_torch.pipeline.geopose import (
    GeoPose,
    PipelineConfig,
    _pose_from_matches,
)
from gisnav_tpu_torch.pipeline.graph import FrameGraph
from gisnav_tpu_torch.pnp.ransac import draw_noise
from gisnav_tpu_torch.raster import (
    rotate_and_crop_auto,
    rotation_quadrant,
    takes_shear,
)

__all__ = ["classical_frame_to_geopose", "warp_program", "GRAPHS"]

GRAPHS: Dict[tuple, FrameGraph] = {}
"""The captured programs, keyed by the program's name, its device and
what it is compiled for."""
_graphs_lock = threading.Lock()


def _device_tail(config: PipelineConfig) -> Callable:
    """Device portion: match + z-lift + PnP + geopose assembly::

        tail(kp_q, desc_q, mask_q, kp_r, desc_r, mask_r, dem_crop, m_crop,
             k, crs_affine, sample_idx=None, generator=None, noise=None)
            -> GeoPose

    The z-lift divides by the crop's scale as the deep programs do; without
    zoom that scale is 1 to f32 rounding, the JAX classical tail's unit.
    ``noise`` is RANSAC's noise drawn ahead (``pnp.ransac.draw_noise``)."""

    def tail(kp_q, desc_q, mask_q, kp_r, desc_r, mask_r, dem_crop, m_crop,
             k, crs_affine, sample_idx: Optional[Any] = None,
             generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None) -> GeoPose:
        midx, _ = mnn_ratio_match(desc_q, desc_r, mask_q, mask_r,
                                  ratio=0.7, mutual=True)
        mvalid = midx >= 0
        return _pose_from_matches(
            config, kp_q, kp_r[torch.clamp(midx, min=0).long()], mvalid,
            dem_crop, m_crop, k, crs_affine, sample_idx, generator, noise)

    return tail


def warp_program(crop_shape, quadrant: Optional[int] = None) -> Callable:
    """The rotate + crop of the classical frame::

        warp(ortho, dem, rotation_deg) -> (ref_img u8, dem_crop, m_crop)

    the map and DEM as given (uint8 / f32, converted to f32 here), the
    angle a host number or a () tensor on their device, ``quadrant`` the
    3-shear route's static right-angle steps."""

    def warp(ortho, dem, rotation_deg):
        stack = torch.stack([ortho.float(), dem.float()], dim=-1)
        warped, m_crop = rotate_and_crop_auto(stack, rotation_deg,
                                              crop_shape, quadrant=quadrant)
        return (torch.clamp(warped[:, :, 0], 0, 255).to(torch.uint8),
                warped[:, :, 1].contiguous(), m_crop)

    return warp


def _graph(key, make: Callable, dev, sticky=()) -> FrameGraph:
    with _graphs_lock:
        if key not in GRAPHS:
            GRAPHS[key] = FrameGraph(make(), dev, sticky=sticky)
        return GRAPHS[key]


def classical_frame_to_geopose(query, ortho, dem, rotation_deg: float, k,
                               crs_affine,
                               config: Optional[PipelineConfig] = None,
                               seed: int = 0, *,
                               sample_idx: Optional[Any] = None,
                               generator: Optional[torch.Generator] = None,
                               device=None) -> GeoPose:
    """Run the classical pipeline on one frame.

    :param query: (h, w) uint8 grayscale camera frame (numpy or tensor)
    :param ortho: (H, W) uint8 grayscale orthoimage
    :param dem: (H, W) float32 DEM metres
    :param rotation_deg: camera-yaw rotation for the reference crop
    :param k: (3, 3) intrinsics
    :param crs_affine: (4, 4) pixel -> WGS84 affine of the full orthoimage
    :param seed: seeds the RANSAC generator when neither ``sample_idx`` nor
        ``generator`` is given
    :param sample_idx: (num_hypotheses, 4) RANSAC samples, or a callable of
        the match mask and the query points returning them (tests inject
        another implementation's draw); on the CPU only

    On the card the rotate + crop and the tail replay their graphs, and a
    ``sample_idx`` raises ``ValueError``: the tail draws from ``generator``.
    """
    dev = resolve_device(device)
    graphed = dev.type == "cuda"
    if graphed and sample_idx is not None:
        raise ValueError("sample_idx is for the CPU; on the card the tail "
                         "graph draws RANSAC's samples from the generator")
    strict_fp32()
    config = config or PipelineConfig()
    h, w = config.image_shape

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32) if not
                               torch.is_tensor(a) else a,
                               dtype=torch.float32, device=dev)

    def raster(a):  # as given, on the host or the card
        return a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))

    angle = np.float32(rotation_deg)
    if graphed:
        o, d = raster(ortho), raster(dem)
        quadrant = (rotation_quadrant(angle)
                    if takes_shear(o.shape, dev) else None)
        key = ("warp", dev, tuple(o.shape), o.dtype, tuple(d.shape),
               d.dtype, (h, w), quadrant)
        ref_img, dem_crop, m_crop = _graph(
            key, lambda: warp_program((h, w), quadrant), dev,
            sticky=(0, 1))(o, d, torch.tensor(angle))
    else:
        ref_img, dem_crop, m_crop = warp_program((h, w))(
            f32(ortho), f32(dem), float(angle))
    qry = torch.as_tensor(query if torch.is_tensor(query)
                          else np.asarray(query), device=dev)

    kq = config.max_keypoints
    if qry.shape == ref_img.shape:
        raw_q, raw_r = extract_sift_batch(torch.stack([qry, ref_img]), kq,
                                          device=dev)
    else:
        (raw_q,), (raw_r,) = (extract_sift_batch(img[None], kq, device=dev)
                              for img in (qry, ref_img))
    fq, fr = pad_features(*raw_q, kq), pad_features(*raw_r, kq)
    if sample_idx is None and generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    feats = (fq.keypoints, fq.descriptors, fq.mask, fr.keypoints,
             fr.descriptors, fr.mask, dem_crop, m_crop)
    if not graphed:
        return _device_tail(config)(
            *feats, f32(k), f32(crs_affine), sample_idx=sample_idx,
            generator=generator)
    tail = _device_tail(config)
    return _graph(("tail", dev, config), lambda: (
        lambda *a: tail(*a[:-1], noise=a[-1])), dev)(
        *feats, f32(k), f32(crs_affine),
        draw_noise(generator, config.num_hypotheses, kq))
