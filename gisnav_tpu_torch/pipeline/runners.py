"""Host-facing runners of the three deep modes.

Counterpart of ``gisnav_tpu/pipeline/runners.py``; every runner keeps the JAX
call signature, so a pose node can take any of them as its deep runner.

- ``make_bucketed_warp_runner``: the map crop is rotated/GSD-resampled at a
  rotation quantised to ``bucket_deg`` and a zoom quantised to
  ``1 + zoom_band`` steps; the bucket's SuperPoint features stay on the
  device in a 4-entry LRU keyed on (rotation bucket, zoom band), and per
  frame only the query runs the extractor before matching.
- ``make_cached_deep_runner``: SuperPoint runs over the whole orthoimage
  once per map refresh; per frame only the query runs the extractor before
  LightGlue against the cached map features.
- ``make_deep_runner``: the exact warp mode, which rotates and crops the map
  to the camera yaw and extracts both images every frame.

The ortho/DEM rasters are uploaded once per map key. RANSAC draws from a
``torch.Generator`` seeded with the frame counter. Each runner takes
``device=None`` -> ``cuda`` and raises without a card unless the caller
passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gisnav_tpu_torch.device import resolve_device, strict_fp32
from gisnav_tpu_torch.pipeline.geopose import (
    GeoPose,
    PipelineConfig,
    build_frame_to_geopose,
    build_frame_to_geopose_cached,
    build_frame_to_geopose_warpcached,
    build_models,
    build_reference_extractor,
    build_warp_reference_extractor,
)

__all__ = ["make_deep_runner", "make_bucketed_warp_runner",
           "make_cached_deep_runner"]


def _map_identity(ortho, map_stamp) -> object:
    """``map_stamp`` when given, else buffer address plus a strided sample
    digest (``id()`` alone can alias a new map after garbage collection)."""
    if map_stamp is not None:
        return int(map_stamp)
    try:
        addr = ortho.__array_interface__["data"][0]
    except AttributeError:
        addr = id(ortho)
    flat = np.ravel(ortho)
    step = max(1, flat.size // 64)
    return (addr, np.ascontiguousarray(flat[::step][:64]).tobytes())


def _setup(params, config, device):
    """Device, weights on it, config and models of a runner."""
    from gisnav_tpu_torch.weights import (
        infer_config_from_params,
        load_bundled,
        params_from_jax,
    )

    dev = resolve_device(device)
    strict_fp32()
    if params is None:
        params, inferred = load_bundled("learned_lg9")
        config = config or inferred
    if config is None:
        config = infer_config_from_params(params)
    return dev, config, build_models(params_from_jax(params, dev), config)


def _f32(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=dev)


def _gsd_zoom(k, crs_affine, altitude_agl) -> float:
    """Query GSD / map GSD for a nadir camera; 1.0 when the altitude is
    unknown."""
    map_gsd = float(abs(np.asarray(crs_affine)[2, 2]))
    if altitude_agl is not None and altitude_agl > 0 and map_gsd > 0:
        return (float(altitude_agl) / float(np.asarray(k)[0, 0])) / map_gsd
    return 1.0


def make_deep_runner(params=None, config: Optional[PipelineConfig] = None, *,
                     device=None):
    """Build the exact-warp runner ``runner(query_u8, ortho_u8, dem_f32,
    rotation_deg, k, crs_affine, map_stamp=None, altitude_agl=None)
    -> GeoPose``.

    Per frame the ortho/DEM stack (device-resident, keyed on the map) is
    rotated to ``rotation_deg`` and resampled to the camera's ground sample
    distance, and SuperPoint runs on both the query and the crop: heavier
    than the cached and bucketed modes, exact in rotation.
    """
    dev, config, models = _setup(params, config, device)
    fn = build_frame_to_geopose(config)
    generator = torch.Generator(device=dev)
    state = {"map_key": None, "ortho": None, "dem": None, "n": 0}

    def runner(query: np.ndarray, ortho: np.ndarray, dem: np.ndarray,
               rotation_deg: float, k: np.ndarray, crs_affine: np.ndarray,
               map_stamp=None, altitude_agl=None) -> GeoPose:
        map_key = (ortho.shape[:2], _map_identity(ortho, map_stamp))
        if state["map_key"] != map_key:
            state["ortho"] = _f32(ortho, dev) / 255.0
            state["dem"] = _f32(dem, dev)
            state["map_key"] = map_key
        state["n"] += 1
        generator.manual_seed(state["n"])
        return fn(models, _f32(query, dev) / 255.0, state["ortho"],
                  state["dem"], float(np.float32(rotation_deg)),
                  _f32(k, dev), _f32(crs_affine, dev), generator=generator,
                  gsd_zoom=float(np.float32(
                      _gsd_zoom(k, crs_affine, altitude_agl))))

    return runner


def make_cached_deep_runner(params=None,
                            config: Optional[PipelineConfig] = None,
                            derotate: bool = False, *, device=None):
    """Build the cached-reference runner, same call signature as
    :func:`make_deep_runner` plus ``prior_lonlat=None``.

    On the first frame after a map refresh (``map_stamp``, else the ortho
    array's identity) the orthoimage is uploaded, SuperPoint runs over all
    of it, and the features and the DEM stay on the device; every later
    frame uploads the query and runs SuperPoint(query) -> LightGlue against
    the cached features -> DEM z-lift -> RANSAC-PnP -> geopose. The query is
    mean-pooled toward the map's ground sample distance by an integer factor
    (4 or 2) when the altitude says so. ``derotate`` feeds ``rotation_deg``
    into query-side derotation. ``prior_lonlat`` with an altitude masks map
    keypoints farther than 1.5 x 0.75 FOV diagonals from it.
    ``runner.stats`` counts frames and map extractions.
    """
    dev, config, models = _setup(params, config, device)
    generator = torch.Generator(device=dev)
    extract = build_reference_extractor(config)
    frame_fns: Dict[Tuple[tuple, int], object] = {}
    state = {"map_key": None, "ref_feats": None, "dem": None, "n": 0}
    stats = {"frames": 0, "map_extractions": 0}

    def runner(query: np.ndarray, ortho: np.ndarray, dem: np.ndarray,
               rotation_deg: float, k: np.ndarray, crs_affine: np.ndarray,
               map_stamp=None, altitude_agl=None,
               prior_lonlat=None) -> GeoPose:
        shape = tuple(ortho.shape[:2])
        map_key = (shape, _map_identity(ortho, map_stamp))
        if state["map_key"] != map_key:
            state["ref_feats"] = extract(models, _f32(ortho, dev) / 255.0)
            state["dem"] = _f32(dem, dev)
            state["map_key"] = map_key
            stats["map_extractions"] += 1
        state["n"] += 1
        stats["frames"] += 1
        aff = np.asarray(crs_affine, np.float64)
        map_gsd = float(abs(aff[2, 2]))
        gsd_scale = _gsd_zoom(k, aff, altitude_agl)
        # an integer mean-pool factor per altitude band; the residual scale
        # gap stays within the descriptors' working range
        hq, wq = query.shape[:2]
        ds = 1
        for cand in (4, 2):
            if gsd_scale < 0.7 / cand * 2 and hq % cand == 0 \
                    and wq % cand == 0:
                ds = cand
                break
        if (shape, ds) not in frame_fns:
            frame_fns[(shape, ds)] = build_frame_to_geopose_cached(
                dataclasses.replace(config, ortho_shape=shape,
                                    detector_downsample=ds))
        # position prior: lon/lat -> map px centre; radius = 0.75 FOV
        # diagonals at this altitude with a 1.5x margin, in map px
        prior_xy = np.zeros(2, np.float32)
        prior_radius = -1.0
        if prior_lonlat is not None and altitude_agl is not None \
                and altitude_agl > 0 and map_gsd > 0:
            try:
                prior_xy = np.linalg.solve(
                    aff[:2, :2], np.asarray(prior_lonlat, np.float64)
                    - aff[:2, 3]).astype(np.float32)
                fov_diag_m = altitude_agl * float(np.hypot(hq, wq)) / float(
                    np.asarray(k)[0, 0])
                prior_radius = 0.75 * fov_diag_m / map_gsd * 1.5
            except np.linalg.LinAlgError:
                pass
        generator.manual_seed(state["n"])
        return frame_fns[(shape, ds)](
            models, _f32(query, dev) / 255.0, state["ref_feats"],
            state["dem"], _f32(k, dev), _f32(crs_affine, dev),
            prior_xy=prior_xy, prior_radius=prior_radius,
            rotation_deg=rotation_deg if derotate else None,
            generator=generator)

    runner.stats = stats
    return runner


def make_bucketed_warp_runner(params=None,
                              config: Optional[PipelineConfig] = None,
                              bucket_deg: float = 15.0,
                              zoom_band: float = 0.10, *,
                              device=None):
    """Build ``runner(query_u8, ortho_u8, dem_f32, rotation_deg, k,
    crs_affine, map_stamp=None, altitude_agl=None) -> GeoPose``.

    :param params: JAX-layout weights tree (``weights.load_bundled``);
        default the bundled ``learned_lg9``
    :param device: ``cuda`` unless the caller asks for ``cpu``; raises when
        CUDA is absent and no device is given

    RANSAC draws from a ``torch.Generator`` seeded with the frame index.
    """
    dev, config, models = _setup(params, config, device)
    extract = build_warp_reference_extractor(config)
    hot = build_frame_to_geopose_warpcached(config)
    generator = torch.Generator(device=dev)
    counter = {"n": 0}
    state = {"map_key": None, "ortho": None, "dem": None}
    buckets: "OrderedDict[tuple, tuple]" = OrderedDict()
    max_buckets = 4

    def runner(query: np.ndarray, ortho: np.ndarray, dem: np.ndarray,
               rotation_deg: float, k: np.ndarray, crs_affine: np.ndarray,
               map_stamp=None, altitude_agl=None) -> GeoPose:
        shape = ortho.shape[:2]
        map_key = (shape, _map_identity(ortho, map_stamp))
        if state["map_key"] != map_key:
            state["ortho"] = _f32(ortho, dev) / 255.0
            state["dem"] = _f32(dem, dev)
            state["map_key"] = map_key
            buckets.clear()
        zoom = _gsd_zoom(k, crs_affine, altitude_agl)
        bucket = round(float(rotation_deg) / bucket_deg)
        zstep = np.log1p(zoom_band)
        zband = round(float(np.log(max(zoom, 1e-6))) / zstep)
        ref_key = (bucket, zband)
        if ref_key in buckets:
            buckets.move_to_end(ref_key)
        else:
            buckets[ref_key] = extract(
                models, state["ortho"], state["dem"],
                float(np.float32(bucket * bucket_deg)),
                float(np.float32(np.exp(zband * zstep))))
            while len(buckets) > max_buckets:
                buckets.popitem(last=False)
        feats, dem_crop, m_crop = buckets[ref_key]
        counter["n"] += 1
        generator.manual_seed(counter["n"])
        return hot(models, _f32(query, dev) / 255.0, feats, dem_crop, m_crop,
                   _f32(k, dev), _f32(crs_affine, dev), generator=generator)

    return runner
