"""Frame -> geopose programs of the three deep modes and the semi-dense
mode, and geopose assembly.

Counterpart of ``gisnav_tpu/pipeline/geopose.py`` (``PipelineConfig``,
``GeoPose``, ``assemble_geopose``, ``geopose_to_wgs84_f64``; exact warp:
``build_frame_to_geopose``; cached reference: ``build_reference_extractor``,
``build_frame_to_geopose_cached``; bucketed warp:
``build_warp_reference_extractor``, ``build_frame_to_geopose_warpcached``;
semi-dense: ``init_semidense_params``, ``build_frame_to_geopose_semidense``;
the random init of training: ``init_pipeline_params``).
PyTorch runs eagerly, so the builders return plain functions over the
models (``build_models``) and device tensors. Every program can take every
input as a tensor (an angle or a zoom as a () tensor, RANSAC's noise drawn
ahead), so ``pipeline.graph`` can capture each as one CUDA graph; the
3-shear rotation's right-angle steps (``quadrant``) are the one static
value a rotating program is keyed on.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = ["PipelineConfig", "GeoPose", "build_models", "assemble_geopose",
           "geopose_to_wgs84_f64", "build_frame_to_geopose",
           "build_reference_extractor", "build_frame_to_geopose_cached",
           "build_warp_reference_extractor",
           "build_frame_to_geopose_warpcached", "init_semidense_params",
           "build_frame_to_geopose_semidense", "init_pipeline_params",
           "superpoint_param_shapes", "lightglue_param_shapes"]


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    image_shape: Tuple[int, int] = (480, 640)  # query frame (h, w)
    ortho_shape: Tuple[int, int] = (1024, 1024)  # orthoimage raster (h, w)
    max_keypoints: int = 1024
    lightglue_depth: int = 9
    filter_threshold: float = 0.1
    min_matches: int = 15
    num_hypotheses: int = 64
    threshold_px: float = 8.0
    refine_iters: int = 10
    score_threshold: float = 0.0005
    detector_downsample: int = 1  # 2 = SuperPoint on the half-size query
    detector_mode: str = "learned"
    ref_keypoint_factor: int = 2  # reference budget = max_keypoints * this
    ref_tile_grid: Tuple[int, int] = (8, 8)  # uniform reference selection


class GeoPose(NamedTuple):
    ecef_position: torch.Tensor  # (3,) metres
    ecef_quat: torch.Tensor  # (4,) xyzw camera_optical -> ECEF
    lon_lat_alt: torch.Tensor  # (3,)
    r_raster: torch.Tensor  # (3, 3) object (raster px) -> camera
    cam_pos_raster: torch.Tensor  # (3,) camera centre in crop px
    m_crop: torch.Tensor  # (3, 3) crop -> original raster px
    num_matches: torch.Tensor
    num_inliers: torch.Tensor
    valid: torch.Tensor
    matched_qry: torch.Tensor  # (K, 2)
    matched_ref: torch.Tensor  # (K, 2)
    match_mask: torch.Tensor  # (K,)


def build_models(params: Dict[str, Any], config: PipelineConfig
                 ) -> Dict[str, torch.nn.Module]:
    """The modules of the port's param tree (``weights.params_from_jax``),
    for the parts it holds:

    - ``superpoint`` for a query frame or a frame-sized crop and
      ``superpoint_ref`` for a whole orthoimage (the reference keypoint
      budget, split evenly over ``ref_tile_grid``; same weight tensors),
      both with ``config.detector_mode``'s detector;
    - ``lightglue``, which picks the fused or the module route per call;
    - ``loftr``, the semi-dense matcher (``max_keypoints`` matches).

    ``params`` may be one mesh row's tree (``parallel.mesh.shard_params_tp``):
    LightGlue then forms its Dense products over the row's model shards,
    and SuperPoint and LoFTR, whose kernels take their operands whole, get
    their sharded leaves (the conv biases) gathered onto the row's first
    device."""
    from gisnav_tpu_torch.features.superpoint import SuperPoint
    from gisnav_tpu_torch.matching.lightglue import LightGlueMatcher
    from gisnav_tpu_torch.matching.loftr import LoFTR
    from gisnav_tpu_torch.parallel.tp import gather_tree

    models: Dict[str, torch.nn.Module] = {}
    if "superpoint" in params:
        mode = config.detector_mode  # SuperPoint raises for an unknown one
        sp = gather_tree(params["superpoint"])
        models["superpoint"] = SuperPoint(
            sp, config.max_keypoints,
            config.score_threshold, detector_mode=mode)
        models["superpoint_ref"] = SuperPoint(
            sp,
            config.max_keypoints * config.ref_keypoint_factor,
            config.score_threshold, select_tiles=config.ref_tile_grid,
            detector_mode=mode)
    if "lightglue" in params:
        models["lightglue"] = LightGlueMatcher(
            params["lightglue"], depth=config.lightglue_depth,
            filter_threshold=config.filter_threshold)
    if "loftr" in params:
        models["loftr"] = LoFTR(gather_tree(params["loftr"]),
                                max_matches=config.max_keypoints)
    return models


def assemble_geopose(r, t, m_crop, crs_affine):
    """PnP pose in the cropped-raster frame -> (ecef, quat xyzw, lon/lat/alt,
    camera position in crop px), all f32 on the device (TF32 off)."""
    from gisnav_tpu_torch.geometry.ops import (
        enu_to_ecef_matrix,
        matrix_to_quat,
        meters_per_degree,
        wgs84_to_ecef,
    )

    cam_pos = -r.T @ t
    crop_scale = torch.sqrt(torch.abs(torch.linalg.det(m_crop[:2, :2])))
    embed = torch.eye(4, dtype=torch.float32, device=r.device)
    embed[:2, :2] = m_crop[:2, :2]
    embed[:2, 3] = m_crop[:2, 2]
    embed[2, 2] = crop_scale
    aff = crs_affine @ embed
    lla = aff @ torch.cat([cam_pos, torch.ones_like(cam_pos[:1])])
    lon, lat, alt = lla[0], lla[1], lla[2]
    ecef = wgs84_to_ecef(lon, lat, alt)

    m_lon, m_lat = meters_per_degree(lat)
    metric = torch.diag(torch.stack([m_lon, m_lat, torch.ones_like(m_lon)]))
    r_cols = metric @ aff[:3, :3]
    r_enu = r_cols / torch.clamp(torch.linalg.norm(r_cols, dim=0,
                                                   keepdim=True), min=1e-12)
    r_ecef = enu_to_ecef_matrix(lon, lat) @ (r_enu @ r.T)
    return ecef, matrix_to_quat(r_ecef), torch.stack([lon, lat, alt]), cam_pos


def geopose_to_wgs84_f64(geopose: GeoPose, crs_affine_f64) -> dict:
    """Host float64 re-assembly from the f32-exact raster-frame outputs."""
    from gisnav_tpu_torch.geometry.crs import (
        WGS84_A,
        WGS84_E2,
        enu_to_ecef_matrix,
        wgs84_to_ecef,
    )
    from gisnav_tpu_torch.geometry.quaternion import matrix_to_quat

    def host(t):
        return np.asarray(t.detach().cpu().numpy(), dtype=np.float64)

    cam_pos, r, m_crop = (host(geopose.cam_pos_raster),
                          host(geopose.r_raster), host(geopose.m_crop))
    aff = np.asarray(crs_affine_f64, dtype=np.float64)
    embed = np.eye(4)
    embed[:2, :2] = m_crop[:2, :2]
    embed[:2, 3] = m_crop[:2, 2]
    embed[2, 2] = np.sqrt(abs(np.linalg.det(m_crop[:2, :2])))
    aff = aff @ embed
    lla = aff @ np.append(cam_pos, 1.0)
    lon, lat, alt = float(lla[0]), float(lla[1]), float(lla[2])
    x, y, z = wgs84_to_ecef(lon, lat, alt)

    lat_r = np.radians(lat)
    w2 = 1.0 - WGS84_E2 * np.sin(lat_r) ** 2
    m_lon = WGS84_A / np.sqrt(w2) * np.cos(lat_r) * np.pi / 180.0
    m_lat = WGS84_A * (1.0 - WGS84_E2) / w2 ** 1.5 * np.pi / 180.0
    r_cols = np.diag([m_lon, m_lat, 1.0]) @ aff[:3, :3]
    r_enu = r_cols / np.linalg.norm(r_cols, axis=0, keepdims=True)
    r_ecef = enu_to_ecef_matrix(lon, lat) @ (r_enu @ r.T)
    if np.all(np.isfinite(r_ecef)):
        u, _, vt = np.linalg.svd(r_ecef)
        r_ecef = u @ np.diag([1.0, 1.0, np.linalg.det(u @ vt)]) @ vt
    else:
        r_ecef = np.eye(3)
    return {"lon": lon, "lat": lat, "alt_ellipsoid": alt,
            "ecef": np.array([x, y, z]), "quat_ecef": matrix_to_quat(r_ecef),
            "r_enu_cam": r_enu @ r.T}


def build_warp_reference_extractor(config: PipelineConfig) -> Callable:
    """Per-bucket reference side::

        fn(models, ortho, dem, rotation_deg, gsd_zoom)
            -> (ref_feats, dem_crop, m_crop)

    Rotate + GSD-zoom + crop the ortho/DEM stack, then SuperPoint on the
    crop. The angle and zoom are host numbers or () device tensors (the
    crop matrix is built on the device)."""
    from gisnav_tpu_torch.raster.warp import rotate_and_crop_center

    h, w = config.image_shape

    def fn(models, ortho, dem, rotation_deg, gsd_zoom):
        stack = torch.stack([ortho, dem], dim=-1)
        warped, m_crop = rotate_and_crop_center(stack, rotation_deg, (h, w),
                                                gsd_zoom)
        feats = models["superpoint"](warped[:, :, 0].contiguous())
        return feats, warped[:, :, 1].contiguous(), m_crop

    return fn


def _pose_from_matches(config, kp_pnp, mkp_ref, mvalid, dem, m_crop, k,
                       crs_affine, sample_idx, generator,
                       noise=None) -> GeoPose:
    """The tail every frame program shares: DEM z-lift in crop-pixel units,
    RANSAC-PnP, geopose assembly. ``kp_pnp`` are the query points in true
    camera pixels, ``mkp_ref`` their matches in the crop, ``mvalid`` the
    match mask. ``sample_idx`` may be a callable taking the match mask and
    ``kp_pnp`` and returning the (num_hypotheses, 4) RANSAC samples;
    ``noise`` is drawn ahead (``pnp.ransac.draw_noise``) in place of
    ``generator``."""
    from gisnav_tpu_torch.pnp.dem import gather_elevation
    from gisnav_tpu_torch.pnp.ransac import ransac_pnp

    num_matches = mvalid.sum()
    # 1 crop px = |det m_crop|^0.5 original px: x/y/z in the same unit
    crop_scale = torch.sqrt(torch.abs(torch.linalg.det(m_crop[:2, :2])))
    z_scale = crs_affine[2, 2] * crop_scale
    dem_m = gather_elevation(dem, mkp_ref)
    obj = torch.cat([mkp_ref, (dem_m / z_scale)[:, None]], dim=1)

    if callable(sample_idx):
        sample_idx = sample_idx(mvalid, kp_pnp)
    pnp = ransac_pnp(obj, kp_pnp, k, mvalid, sample_idx=sample_idx,
                     generator=generator, noise=noise,
                     num_hypotheses=config.num_hypotheses,
                     threshold_px=config.threshold_px,
                     min_inliers=config.min_matches,
                     refine_iters=config.refine_iters)
    ecef, quat, lla, cam_pos = assemble_geopose(pnp.r, pnp.t, m_crop,
                                                crs_affine)
    return GeoPose(
        ecef_position=ecef, ecef_quat=quat, lon_lat_alt=lla,
        r_raster=pnp.r, cam_pos_raster=cam_pos, m_crop=m_crop,
        num_matches=num_matches, num_inliers=pnp.num_inliers,
        valid=pnp.valid & (num_matches >= config.min_matches),
        matched_qry=kp_pnp, matched_ref=mkp_ref,
        match_mask=mvalid & pnp.inliers)


def _pose_from_features(config, models, kp_match, kp_pnp, f_qry, size_qry,
                        ref_kp, ref_desc, ref_mask, size_ref, dem, m_crop,
                        k, crs_affine, sample_idx, generator,
                        noise=None) -> GeoPose:
    """LightGlue, then the shared tail. ``kp_match`` are the query
    keypoints the matcher sees, ``kp_pnp`` the same keypoints in true
    camera pixels."""
    match = models["lightglue"](kp_match, f_qry.descriptors, f_qry.mask,
                                size_qry, ref_kp, ref_desc, ref_mask,
                                size_ref)
    midx = match.matches0
    return _pose_from_matches(config, kp_pnp,
                              ref_kp[torch.clamp(midx, min=0)], midx >= 0,
                              dem, m_crop, k, crs_affine, sample_idx,
                              generator, noise)


def build_frame_to_geopose_warpcached(config: PipelineConfig) -> Callable:
    """Per-frame hot path of the bucketed warp mode::

        fn(models, query, ref_feats, dem_crop, m_crop, k, crs_affine,
           sample_idx=None, generator=None, noise=None) -> GeoPose

    SuperPoint on the query, then the shared tail against the cached bucket
    features. ``noise`` is RANSAC's (num_hypotheses, max_keypoints)
    ``draw_noise``, drawn ahead in place of ``generator``."""
    h, w = config.image_shape

    def fn(models, query, ref_feats, dem_crop, m_crop, k, crs_affine,
           sample_idx: Optional[Any] = None,
           generator: Optional[torch.Generator] = None,
           noise: Optional[torch.Tensor] = None) -> GeoPose:
        f_qry = models["superpoint"](query)
        return _pose_from_features(
            config, models, f_qry.keypoints, f_qry.keypoints, f_qry, (h, w),
            ref_feats.keypoints, ref_feats.descriptors, ref_feats.mask,
            (h, w), dem_crop, m_crop, k, crs_affine, sample_idx, generator,
            noise)

    return fn


def build_frame_to_geopose(config: PipelineConfig) -> Callable:
    """Exact-warp frame program::

        fn(models, query, ortho, dem, rotation_deg, k, crs_affine,
           sample_idx=None, generator=None, gsd_zoom=None, noise=None,
           quadrant=None) -> GeoPose

    Rotate + centre-crop the ortho/DEM stack to the camera yaw
    (``rotate_and_crop_auto``: the gather warp with ``gsd_zoom``, without it
    the 3-shear rotation where the stack allows, ``quadrant`` its static
    right-angle steps), SuperPoint on the (query, crop) pair, then the
    shared tail. ``rotation_deg`` and ``gsd_zoom`` may be () device
    tensors and ``noise`` RANSAC's noise drawn ahead, as in the bucketed
    program."""
    from gisnav_tpu_torch.raster import rotate_and_crop_auto

    h, w = config.image_shape

    def fn(models, query, ortho, dem, rotation_deg, k, crs_affine,
           sample_idx: Optional[Any] = None,
           generator: Optional[torch.Generator] = None,
           gsd_zoom=None, noise: Optional[torch.Tensor] = None,
           quadrant: Optional[int] = None) -> GeoPose:
        stack = torch.stack([ortho, dem], dim=-1)
        warped, m_crop = rotate_and_crop_auto(stack, rotation_deg, (h, w),
                                              zoom=gsd_zoom,
                                              quadrant=quadrant)
        feats = models["superpoint"](
            torch.stack([query, warped[:, :, 0]]))
        f_qry, f_ref = (type(feats)(*(a[i] for a in feats)) for i in (0, 1))
        return _pose_from_features(
            config, models, f_qry.keypoints, f_qry.keypoints, f_qry, (h, w),
            f_ref.keypoints, f_ref.descriptors, f_ref.mask, (h, w),
            warped[:, :, 1].contiguous(), m_crop, k, crs_affine, sample_idx,
            generator, noise)

    return fn


def build_reference_extractor(config: PipelineConfig) -> Callable:
    """Per-map-refresh reference side of the cached mode:
    ``extract(models, ortho) -> SuperPointFeatures`` over the WHOLE
    orthoimage, with ``max_keypoints * ref_keypoint_factor`` keypoints
    spread evenly over ``ref_tile_grid``."""

    def extract(models, ortho):
        return models["superpoint_ref"](ortho)

    return extract


def build_frame_to_geopose_cached(config: PipelineConfig) -> Callable:
    """Per-frame hot path of the cached-reference mode::

        fn(models, query, ref_feats, dem, k, crs_affine, prior_xy=None,
           prior_radius=-1.0, rotation_deg=None, sample_idx=None,
           generator=None, noise=None, quadrant=None) -> GeoPose

    ``ref_feats`` are the whole orthoimage's features, ``dem`` the whole DEM;
    the pose is in the full raster frame (``m_crop`` = identity). The query
    is mean-pooled by ``detector_downsample`` before SuperPoint (GSD
    matching by an integer factor) and its keypoints scaled back. With
    ``rotation_deg`` (the map-alignment rotation the warp modes apply to the
    reference) the QUERY is derotated by the inverse: features come from the
    north-up query (``kp_match``) while PnP sees the keypoints mapped back
    to camera pixels (``kp_pnp``); it may be a () device tensor, and
    ``quadrant`` is the static right-angle steps of a shear derotation (a
    square query the shear kernel serves). ``prior_xy`` / ``prior_radius`` (map px;
    radius <= 0 disables; a (2,) and a () tensor on the device, or host
    values) mask reference keypoints outside the predicted neighbourhood.
    ``noise`` is RANSAC's noise drawn ahead, as in the bucketed program."""
    from gisnav_tpu_torch.raster import rotate_and_crop_auto
    from gisnav_tpu_torch.device import scalar_f32

    h, w = config.image_shape
    oh, ow = config.ortho_shape
    ds = config.detector_downsample

    def fn(models, query, ref_feats, dem, k, crs_affine, prior_xy=None,
           prior_radius: float = -1.0, rotation_deg=None,
           sample_idx: Optional[Any] = None,
           generator: Optional[torch.Generator] = None,
           noise: Optional[torch.Tensor] = None,
           quadrant: Optional[int] = None) -> GeoPose:
        hq, wq = query.shape
        src = query
        if ds > 1:
            src = query.reshape(hq // ds, ds, wq // ds, ds).mean(dim=(1, 3))
        if rotation_deg is not None:
            derot, m_q = rotate_and_crop_auto(
                src[..., None], -scalar_f32(rotation_deg, query.device),
                tuple(src.shape), quadrant=quadrant)
            f_qry = models["superpoint"](derot[..., 0].contiguous())
            kp_rot = f_qry.keypoints
            kp_cam = kp_rot @ m_q[:2, :2].T + m_q[:2, 2]
            kp_match, kp_pnp = kp_rot * ds, kp_cam * ds
        else:
            f_qry = models["superpoint"](src)
            kp_match = kp_pnp = f_qry.keypoints * ds

        ref_mask = ref_feats.mask
        if prior_xy is not None:
            dev = ref_mask.device
            pxy = torch.as_tensor(prior_xy, dtype=torch.float32, device=dev)
            d2 = ((ref_feats.keypoints - pxy[None]) ** 2).sum(dim=1)
            r = torch.as_tensor(prior_radius, dtype=torch.float32,
                                device=dev)
            ref_mask = ref_mask & ((r <= 0) | (d2 <= r * r))

        m_crop = torch.eye(3, dtype=torch.float32, device=query.device)
        return _pose_from_features(
            config, models, kp_match, kp_pnp, f_qry, (h, w),
            ref_feats.keypoints, ref_feats.descriptors, ref_mask, (oh, ow),
            dem, m_crop, k, crs_affine, sample_idx, generator, noise)

    return fn


def _flax_init(shapes: Dict[str, Tuple], generator: torch.Generator
               ) -> Dict[str, Any]:
    """A nested numpy tree of the ``path -> shape`` table drawn from
    ``generator`` with flax's default initialisers: kernels
    ``lecun_normal`` (a normal of std sqrt(1 / fan_in), fan_in the product
    of all but the last axis, truncated to +-2 std), biases zero, LayerNorm
    scales one."""
    def draw(shape):
        fan_in = int(np.prod(shape[:-1]))
        std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
        w = torch.empty(shape, dtype=torch.float32)
        torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                    generator=generator)
        return w.numpy()

    tree: Dict[str, Any] = {}
    for path, shape in shapes.items():
        *parents, leaf = path.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        if leaf == "kernel":
            node[leaf] = draw(shape)
        elif leaf == "scale":
            node[leaf] = np.ones(shape, np.float32)
        else:
            node[leaf] = np.zeros(shape, np.float32)
    return tree


def superpoint_param_shapes(detector_mode: str = "learned"
                            ) -> Dict[str, Tuple]:
    """``path -> shape`` of the JAX SuperPoint's parameter tree (HWIO
    kernels; the detector head only in ``learned`` mode)."""
    convs = [("conv1a", 3, 1, 64), ("conv1b", 3, 64, 64),
             ("conv2a", 3, 64, 64), ("conv2b", 3, 64, 64),
             ("conv3a", 3, 64, 128), ("conv3b", 3, 128, 128),
             ("conv4a", 3, 128, 128), ("conv4b", 3, 128, 128)]
    if detector_mode == "learned":
        convs += [("convPa", 3, 128, 256), ("convPb", 1, 256, 65)]
    convs += [("convDa", 3, 128, 256), ("convDb", 1, 256, 256)]
    shapes: Dict[str, Tuple] = {}
    for name, k, cin, cout in convs:
        shapes[f"{name}/kernel"] = (k, k, cin, cout)
        shapes[f"{name}/bias"] = (cout,)
    return shapes


def lightglue_param_shapes(depth: int, dim: int = 256, heads: int = 4,
                           input_dim: int = 256) -> Dict[str, Tuple]:
    """``path -> shape`` of the JAX LightGlue's parameter tree (Dense
    kernels ``(in, out)``)."""
    shapes: Dict[str, Tuple] = {}

    def dense(name, din, dout, bias=True):
        shapes[f"{name}/kernel"] = (din, dout)
        if bias:
            shapes[f"{name}/bias"] = (dout,)

    def ffn(prefix):
        dense(f"{prefix}/ffn/fc1", 2 * dim, 2 * dim)
        shapes[f"{prefix}/ffn/norm/scale"] = (2 * dim,)
        shapes[f"{prefix}/ffn/norm/bias"] = (2 * dim,)
        dense(f"{prefix}/ffn/fc2", 2 * dim, dim)

    dense("input_proj", input_dim, dim)
    dense("posenc/Wr", 2, dim // heads // 2, bias=False)
    for i in range(depth):
        dense(f"self_{i}/Wqkv", dim, 3 * dim)
        dense(f"self_{i}/out_proj", dim, dim)
        ffn(f"self_{i}")
        for name in ("to_qk", "to_v", "to_out"):
            dense(f"cross_{i}/{name}", dim, dim)
        ffn(f"cross_{i}")
    dense("final_proj", dim, dim)
    dense("matchability", dim, 1)
    return shapes


def init_pipeline_params(generator: torch.Generator,
                         config: PipelineConfig) -> Dict[str, Any]:
    """SuperPoint + LightGlue parameters as a JAX-layout numpy tree
    (``{"superpoint": {"params": ...}, "lightglue": {"params": ...}}``, the
    keys and shapes of the JAX package's ``init_pipeline_params``), drawn
    from ``generator`` with flax's initialisers (:func:`_flax_init`).
    ``weights.params_from_jax`` turns it into the port's tree."""
    return {
        "superpoint": {"params": _flax_init(
            superpoint_param_shapes(config.detector_mode), generator)},
        "lightglue": {"params": _flax_init(
            lightglue_param_shapes(config.lightglue_depth), generator)},
    }


def init_semidense_params(generator: torch.Generator,
                          config: PipelineConfig) -> Dict[str, Any]:
    """LoFTR parameters for the semi-dense mode, as a JAX-layout numpy tree
    (``{"loftr": {"params": ...}}``, the keys and shapes of the JAX init)
    drawn from ``generator`` with flax's default initialisers
    (:func:`_flax_init`). ``config`` is taken for the JAX signature; the
    architecture does not depend on it."""
    from gisnav_tpu_torch.matching.loftr import param_shapes

    return {"loftr": {"params": _flax_init(param_shapes(), generator)}}


def build_frame_to_geopose_semidense(config: PipelineConfig) -> Callable:
    """Detector-free exact-warp frame program, same signature as
    :func:`build_frame_to_geopose`: rotate + GSD-zoom + crop the ortho/DEM
    stack, LoFTR on the (query, crop) pair in place of SuperPoint +
    LightGlue, then the shared tail. The zoom matters here: LoFTR's
    dual-softmax matches coarse cells 1:1 in scale."""
    from gisnav_tpu_torch.raster import rotate_and_crop_auto

    h, w = config.image_shape

    def fn(models, query, ortho, dem, rotation_deg, k, crs_affine,
           sample_idx: Optional[Any] = None,
           generator: Optional[torch.Generator] = None,
           gsd_zoom=None, noise: Optional[torch.Tensor] = None,
           quadrant: Optional[int] = None) -> GeoPose:
        stack = torch.stack([ortho, dem], dim=-1)
        warped, m_crop = rotate_and_crop_auto(stack, rotation_deg, (h, w),
                                              zoom=gsd_zoom,
                                              quadrant=quadrant)
        match = models["loftr"](query, warped[:, :, 0].contiguous())
        return _pose_from_matches(
            config, match.kp0, match.kp1, match.mask,
            warped[:, :, 1].contiguous(), m_crop, k, crs_affine, sample_idx,
            generator, noise)

    return fn
