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
"""
from __future__ import annotations

from typing import Any, Callable, Optional

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
from gisnav_tpu_torch.raster import rotate_and_crop_auto

__all__ = ["classical_frame_to_geopose"]


def _device_tail(config: PipelineConfig) -> Callable:
    """Device portion: match + z-lift + PnP + geopose assembly::

        tail(kp_q, desc_q, mask_q, kp_r, desc_r, mask_r, dem_crop, m_crop,
             k, crs_affine, sample_idx=None, generator=None) -> GeoPose

    The z-lift divides by the crop's scale as the deep programs do; without
    zoom that scale is 1 to f32 rounding, the JAX classical tail's unit."""

    def tail(kp_q, desc_q, mask_q, kp_r, desc_r, mask_r, dem_crop, m_crop,
             k, crs_affine, sample_idx: Optional[Any] = None,
             generator: Optional[torch.Generator] = None) -> GeoPose:
        midx, _ = mnn_ratio_match(desc_q, desc_r, mask_q, mask_r,
                                  ratio=0.7, mutual=True)
        mvalid = midx >= 0
        return _pose_from_matches(
            config, kp_q, kp_r[torch.clamp(midx, min=0).long()], mvalid,
            dem_crop, m_crop, k, crs_affine, sample_idx, generator)

    return tail


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
        another implementation's draw)
    """
    dev = resolve_device(device)
    strict_fp32()
    config = config or PipelineConfig()
    h, w = config.image_shape

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32) if not
                               torch.is_tensor(a) else a,
                               dtype=torch.float32, device=dev)

    stack = torch.stack([f32(ortho), f32(dem)], dim=-1)
    warped, m_crop = rotate_and_crop_auto(stack, rotation_deg, (h, w))
    ref_img = torch.clamp(warped[:, :, 0], 0, 255).to(torch.uint8)
    dem_crop = warped[:, :, 1].contiguous()
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
    return _device_tail(config)(
        fq.keypoints, fq.descriptors, fq.mask, fr.keypoints, fr.descriptors,
        fr.mask, dem_crop, m_crop.to(dev), f32(k), f32(crs_affine),
        sample_idx=sample_idx, generator=generator)
