"""Host-facing runner of the bucketed warp mode, the production main path.

Counterpart of ``gisnav_tpu/pipeline/runners.py`` ``make_bucketed_warp_runner``
with the same call signature, so a pose node can take it as its deep runner.
The map crop is rotated/GSD-resampled at a rotation quantised to
``bucket_deg`` and a zoom quantised to ``1 + zoom_band`` steps; the bucket's
SuperPoint features stay on the device in a 4-entry LRU keyed on
(rotation bucket, zoom band), and per frame only the query runs the
extractor before matching. The ortho/DEM stack is uploaded once per map key.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from gisnav_tpu_torch.device import resolve_device, strict_fp32
from gisnav_tpu_torch.pipeline.geopose import (
    GeoPose,
    PipelineConfig,
    build_frame_to_geopose_warpcached,
    build_models,
    build_warp_reference_extractor,
)

__all__ = ["make_bucketed_warp_runner"]


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
    from gisnav_tpu_torch.weights import load_bundled, params_from_jax

    dev = resolve_device(device)
    strict_fp32()
    if params is None:
        params, inferred = load_bundled("learned_lg9")
        config = config or inferred
    if config is None:
        from gisnav_tpu_torch.weights import infer_config_from_params

        config = infer_config_from_params(params)
    models = build_models(params_from_jax(params, dev), config)
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
            state["ortho"] = torch.as_tensor(
                np.asarray(ortho, np.float32), device=dev) / 255.0
            state["dem"] = torch.as_tensor(np.asarray(dem, np.float32),
                                           device=dev)
            state["map_key"] = map_key
            buckets.clear()
        zoom = 1.0
        map_gsd = float(abs(np.asarray(crs_affine)[2, 2]))
        if altitude_agl is not None and altitude_agl > 0 and map_gsd > 0:
            zoom = (float(altitude_agl) / float(np.asarray(k)[0, 0])) / map_gsd
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
        return hot(
            models,
            torch.as_tensor(np.asarray(query, np.float32), device=dev) / 255.0,
            feats, dem_crop, m_crop,
            torch.as_tensor(np.asarray(k, np.float32), device=dev),
            torch.as_tensor(np.asarray(crs_affine, np.float32), device=dev),
            generator=generator)

    return runner
