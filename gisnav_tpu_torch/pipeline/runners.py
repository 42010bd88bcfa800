"""Host-facing runners of the three deep modes and the semi-dense mode.

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
  to the camera yaw and extracts both images every frame;
- ``make_semidense_runner``: the exact warp with LoFTR in place of
  SuperPoint + LightGlue.

With ``params=None`` the deep runners load the bundled ``harris_lg5`` with
``PRETRAINED_CONFIG``, as the JAX runners do. Given params but no config,
they infer the config from the tree (``weights.infer_config_from_params``),
where the JAX runners pin ``PRETRAINED_CONFIG``: a written departure, since
the pinned config cannot run a ``learned_lg9`` tree (``gisnav_tpu/cli.py``
says the same).

The ortho/DEM rasters are uploaded once per map key. RANSAC draws from a
``torch.Generator`` seeded with the frame counter. Each runner takes
``device=None`` -> ``cuda`` and raises without a card unless the caller
passes ``device="cpu"``.

On the card the cached and the bucketed runners replay their per-frame
program as one CUDA graph (``pipeline.graph.FrameGraph``, the counterpart
of the JAX runners' ``jax.jit``): one graph a query signature in the
bucketed runner, one a ``(map shape, downsample, query signature)`` in the
cached runner, as its programs are keyed. The query is uploaded as it comes
(uint8) into the graph's buffer, a bucket's features and crop or the map's
features and DEM only when they change, and RANSAC's noise is drawn from
the seeded generator ahead of the replay (``pnp.ransac.draw_noise``), so a
replayed frame and an eager one with the same seed draw the same samples.
The bucket refresh, the exact-warp, derotating, semi-dense and classical
programs stay eager. ``runner.graphs`` holds the captured programs.
"""
from __future__ import annotations

import dataclasses
import os
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gisnav_tpu_torch.device import resolve_device, strict_fp32
from gisnav_tpu_torch.pipeline.graph import FrameGraph
from gisnav_tpu_torch.pipeline.geopose import (
    GeoPose,
    PipelineConfig,
    build_frame_to_geopose,
    build_frame_to_geopose_cached,
    build_frame_to_geopose_semidense,
    build_frame_to_geopose_warpcached,
    build_models,
    build_reference_extractor,
    build_warp_reference_extractor,
    init_semidense_params,
)

__all__ = ["make_deep_runner", "make_bucketed_warp_runner",
           "make_cached_deep_runner", "make_semidense_runner",
           "PRETRAINED_CONFIG", "LEARNED_LG9_CONFIG", "SEMIDENSE_CONFIG"]

PRETRAINED_CONFIG = PipelineConfig(
    image_shape=(480, 640), max_keypoints=512, lightglue_depth=5,
    detector_mode="harris", min_matches=15)
"""Config of ``weights/gisnav_tpu_harris_lg5.npz``: Harris detector +
5-layer LightGlue, the default bundle."""

LEARNED_LG9_CONFIG = dataclasses.replace(
    PRETRAINED_CONFIG, detector_mode="learned", lightglue_depth=9)
"""Config of ``weights/gisnav_tpu_learned_lg9.npz``: learned SuperPoint
detector + 9-layer LightGlue."""

SEMIDENSE_CONFIG = dataclasses.replace(PRETRAINED_CONFIG, max_keypoints=1024)
"""Config of ``weights/gisnav_tpu_loftr.npz`` (``max_keypoints`` bounds the
coarse match set)."""


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
        params, default = load_bundled("harris_lg5")
        config = config or default
    if config is None:
        config = infer_config_from_params(params)
    return dev, config, build_models(params_from_jax(params, dev), config)


def _f32(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=dev)


def _host(a) -> torch.Tensor:
    """A host tensor for a graph's input buffer: uint8 frames as they come
    (a quarter of the f32 upload), anything else as f32."""
    a = np.asarray(a)
    if a.dtype != np.uint8:
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a))


def _noise(generator, config) -> torch.Tensor:
    from gisnav_tpu_torch.pnp.ransac import draw_noise

    return draw_noise(generator, config.num_hypotheses,
                      config.max_keypoints)


def _gsd_zoom(k, crs_affine, altitude_agl) -> float:
    """Query GSD / map GSD for a nadir camera; 1.0 when the altitude is
    unknown."""
    map_gsd = float(abs(np.asarray(crs_affine)[2, 2]))
    if altitude_agl is not None and altitude_agl > 0 and map_gsd > 0:
        return (float(altitude_agl) / float(np.asarray(k)[0, 0])) / map_gsd
    return 1.0


def _warp_runner(fn, models, dev):
    """The runner around an exact-warp frame program ``fn`` (the signature
    of ``build_frame_to_geopose``): the ortho/DEM stack is uploaded once per
    map key, the zoom comes from the altitude, RANSAC is seeded with the
    frame counter."""
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
    return _warp_runner(build_frame_to_geopose(config), models, dev)


def make_semidense_runner(params=None,
                          config: Optional[PipelineConfig] = None,
                          seed: int = 0, *, device=None):
    """Build the semi-dense (LoFTR) exact-warp runner, same call signature
    as :func:`make_deep_runner`.

    ``params`` is a JAX-layout ``{"loftr": ...}`` tree; by default the
    bundled ``loftr`` weights, or, where that file is missing, the
    initialiser's weights drawn from ``seed`` (structure tests, untrained
    experiments). The crop is always resampled to the query's ground sample
    distance (LoFTR matches coarse cells 1:1 in scale), so the warp is the
    gather route.
    """
    from gisnav_tpu_torch.weights import LOFTR_PATH, load_npz, params_from_jax

    dev = resolve_device(device)
    strict_fp32()
    config = config or SEMIDENSE_CONFIG
    if params is None:
        if os.path.exists(LOFTR_PATH):
            params = load_npz(LOFTR_PATH)
        else:
            params = init_semidense_params(
                torch.Generator().manual_seed(seed), config)
    models = build_models(params_from_jax(params, dev), config)
    return _warp_runner(build_frame_to_geopose_semidense(config), models,
                        dev)


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
    ``runner.stats`` counts frames and map extractions. On the card each
    frame without ``derotate`` replays its program's CUDA graph.
    """
    dev, config, models = _setup(params, config, device)
    generator = torch.Generator(device=dev)
    extract = build_reference_extractor(config)
    frame_fns: Dict[Tuple[tuple, int], object] = {}
    graphs: Dict[tuple, FrameGraph] = {}
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
        fn = frame_fns[(shape, ds)]
        if dev.type != "cuda" or derotate:
            return fn(models, _f32(query, dev) / 255.0, state["ref_feats"],
                      state["dem"], _f32(k, dev), _f32(crs_affine, dev),
                      prior_xy=prior_xy, prior_radius=prior_radius,
                      rotation_deg=rotation_deg if derotate else None,
                      generator=generator)
        q = _host(query)
        key = (shape, ds, tuple(q.shape), q.dtype)
        if key not in graphs:
            graphs[key] = FrameGraph(
                lambda q, feats, dem, k, aff, pxy, pr, noise, fn=fn: fn(
                    models, q.float() / 255.0, feats, dem, k, aff,
                    prior_xy=pxy, prior_radius=pr, noise=noise),
                dev, sticky=(1, 2))
        return graphs[key](
            q, state["ref_feats"], state["dem"], _host(k),
            _host(crs_affine), torch.from_numpy(prior_xy),
            torch.tensor(prior_radius, dtype=torch.float32),
            _noise(generator, config))

    runner.stats = stats
    runner.graphs = graphs
    return runner


def make_bucketed_warp_runner(params=None,
                              config: Optional[PipelineConfig] = None,
                              bucket_deg: float = 15.0,
                              zoom_band: float = 0.10, *,
                              device=None):
    """Build ``runner(query_u8, ortho_u8, dem_f32, rotation_deg, k,
    crs_affine, map_stamp=None, altitude_agl=None) -> GeoPose``.

    :param params: JAX-layout weights tree (``weights.load_bundled``);
        default the bundled ``harris_lg5``
    :param device: ``cuda`` unless the caller asks for ``cpu``; raises when
        CUDA is absent and no device is given

    RANSAC draws from a ``torch.Generator`` seeded with the frame index. On
    the card each frame replays the per-frame program's CUDA graph (one a
    query signature); a bucket refresh runs eagerly. ``runner.buckets`` is
    the LRU of bucket features, ``runner.models`` the models and
    ``runner.stats["frames"]`` the frames so far (the last frame's seed).
    """
    dev, config, models = _setup(params, config, device)
    extract = build_warp_reference_extractor(config)
    hot = build_frame_to_geopose_warpcached(config)
    generator = torch.Generator(device=dev)
    graphs: Dict[tuple, FrameGraph] = {}
    stats = {"frames": 0}
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
        stats["frames"] += 1
        generator.manual_seed(stats["frames"])
        if dev.type != "cuda":
            return hot(models, _f32(query, dev) / 255.0, feats, dem_crop,
                       m_crop, _f32(k, dev), _f32(crs_affine, dev),
                       generator=generator)
        q = _host(query)
        key = (tuple(q.shape), q.dtype)
        if key not in graphs:
            graphs[key] = FrameGraph(
                lambda q, feats, dem, m, k, aff, noise: hot(
                    models, q.float() / 255.0, feats, dem, m, k, aff,
                    noise=noise),
                dev, sticky=(1, 2, 3))
        return graphs[key](q, feats, dem_crop, m_crop, _host(k),
                           _host(crs_affine), _noise(generator, config))

    runner.stats = stats
    runner.graphs = graphs
    runner.buckets = buckets
    runner.models = models
    return runner
