"""Offline replay harness: recorded frames + ground truth -> error report.

The port's counterpart of ``gisnav_tpu/replay.py``: the same dataset
layout, the same per-frame results and the same summary keys, on the
port's runners (on the card unless ``device="cpu"``). The reference
validated on real NAIP orthophotos + USGS DEM by flying PX4 SITL and
post-processing ULogs (``test/sitl/ulog_analysis/variance_estimation.ipynb``
in hmakelin/gisnav); this harness needs no simulator: given a directory of
recorded camera frames, a ground-truth pose log and a georeferenced
orthophoto, it runs a runner frame by frame and reports the statistics the
notebook computes (per-axis mean/std error, per-frame 10 m gate, error vs
altitude).

Dataset layout (all paths relative to the dataset directory)::

    map.png        north-up grayscale orthophoto (any format cv2 reads)
    map.json       {"left": lon, "bottom": lat, "right": lon, "top": lat,
                    "dem": "dem.png" | constant_meters (optional, default 0),
                    "dem_scale": meters_per_unit (optional, default 1.0)}
    camera.json    {"k": 3x3 intrinsics, "width": int, "height": int}
    poses.csv      header stamp_us,lon,lat,alt_ellipsoid_m[,yaw_deg]
    frames/        <stamp_us>.png per pose row

Backends: ``deep`` runs the cached-reference runner of a bundled weight set
at the dataset's frame size; ``classical`` runs
``classical_frame_to_geopose`` with the reference rotated to the camera
yaw. ``fused`` also runs the per-frame fixes through the port's
``PoseFusionFilter`` UKF. Fixes are re-assembled in float64 on the host
(``pipeline.geopose.geopose_to_wgs84_f64``).

Images are read by their content, whatever their names, as ``cv2.imread``
reads them (``gis/imgcodecs.py`` ``read_image``; the card machine has no
OpenCV): PNG, JPEG (Huffman- or arithmetic-coded, sequential,
progressive or lossless), TIFF and BigTIFF (a GDAL export: tiled or striped,
deflate, LZW or PackBits, predictors 2 and 3, uint8 to float32; CCITT
bilevel; 10- to 14-bit samples), WebP
(lossless, lossy, with alpha, extended or animated: the first frame),
JPEG 2000, GIF,
BMP, PBM / PGM / PPM / PAM, PFM, Sun raster and Radiance HDR. The map and
the frames are read as ``IMREAD_GRAYSCALE`` (each format's grey as OpenCV
makes it; a JPEG, WebP or PNG turned upright by its EXIF orientation, a TIFF by
its ``Orientation`` tag, and a TIFF whose orientation transposes refused,
as ``cv2.imread`` refuses it). The DEM is read as ``IMREAD_UNCHANGED`` and
must be grey: an 8 or 16-bit PNG, or a uint16, int16 or float32 GeoTIFF
(heights times ``dem_scale``). A file cv2 would not read raises
``ValueError`` (naming the JPEG variant where cv2 refuses one: lossless
arithmetic-coded (SOF11), hierarchical or 12-bit; a TIFF of a codec
cv2's libtiff lacks, such as ZSTD or LZMA, is one cv2 would not read), and
so does a variant the port does not read yet (AVIF). A damaged
file is read as ``cv2.imread`` reads it (a PNG whose IEND fails its CRC
reads; one whose IDAT fails it is refused).
"""
from __future__ import annotations

import csv
import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np

from gisnav_tpu_torch.gis.imgcodecs import (IMREAD_GRAYSCALE,
                                            IMREAD_UNCHANGED, read_image)
from gisnav_tpu_torch.gis.jpeg import JPEG_SOI, jpeg_variant

__all__ = ["load_dataset", "replay", "summarize"]


def _read_image(path: str, flag: int) -> np.ndarray:
    """An image file, read by content as ``cv2.imread(path, flag)``."""
    try:
        img = read_image(path, flag)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from e
    if img is None:
        with open(path, "rb") as f:
            data = f.read()
        variant = jpeg_variant(data) if data.startswith(JPEG_SOI) else None
        raise ValueError(f"{path}: {variant} (cv2 does not read it either)"
                         if variant else f"{path}: not an image OpenCV would "
                         f"read (starts {data[:8]!r})")
    return img


def _read_gray8(path: str) -> np.ndarray:
    return _read_image(path, IMREAD_GRAYSCALE)


def load_dataset(path: str) -> Dict:
    """Load and validate a replay dataset directory."""
    with open(os.path.join(path, "map.json")) as f:
        map_meta = json.load(f)
    ortho = _read_gray8(os.path.join(path, "map.png"))
    dem_spec = map_meta.get("dem", 0.0)
    dem_scale = float(map_meta.get("dem_scale", 1.0))
    if isinstance(dem_spec, str):
        dem = _read_image(os.path.join(path, dem_spec), IMREAD_UNCHANGED)
        if dem.ndim != 2:
            raise ValueError(f"{dem_spec}: a grey DEM image is expected")
        dem = dem.astype(np.float32) * dem_scale
    else:
        dem = np.full(ortho.shape[:2], float(dem_spec) * dem_scale,
                      np.float32)
    with open(os.path.join(path, "camera.json")) as f:
        cam = json.load(f)
    k = np.asarray(cam["k"], np.float32)
    rows: List[Dict] = []
    with open(os.path.join(path, "poses.csv")) as f:
        for row in csv.DictReader(f):
            rows.append({
                "stamp_us": int(row["stamp_us"]),
                "lon": float(row["lon"]),
                "lat": float(row["lat"]),
                "alt": float(row["alt_ellipsoid_m"]),
                "yaw_deg": float(row.get("yaw_deg") or 0.0),
            })
    if not rows:
        raise ValueError(f"poses.csv under {path} has no rows")
    frames_dir = os.path.join(path, "frames")
    for r in rows:
        r["frame_path"] = os.path.join(frames_dir, f"{r['stamp_us']}.png")
        if not os.path.exists(r["frame_path"]):
            raise FileNotFoundError(r["frame_path"])
    return {
        "ortho": ortho,
        "dem": dem,
        "bounds": (float(map_meta["left"]), float(map_meta["bottom"]),
                   float(map_meta["right"]), float(map_meta["top"])),
        "k": k,
        "image_size": (int(cam["height"]), int(cam["width"])),
        "poses": rows,
    }


def _step_fn(ds: Dict, aff: np.ndarray, backend: str, weights: str,
             max_keypoints: Optional[int], lightglue_depth: Optional[int],
             device):
    """frame, row, agl, prior -> GeoPose of the chosen backend."""
    if backend == "deep":
        from gisnav_tpu_torch.pipeline.runners import make_cached_deep_runner
        from gisnav_tpu_torch.weights import load_bundled

        params, cfg = load_bundled(weights)
        cfg = dataclasses.replace(
            cfg, image_shape=ds["image_size"],
            **({"max_keypoints": max_keypoints} if max_keypoints else {}),
            **({"lightglue_depth": lightglue_depth} if lightglue_depth
               else {}))
        runner = make_cached_deep_runner(params, cfg, device=device)

        def step(frame, row, agl, use_prior):
            return runner(frame, ds["ortho"], ds["dem"], 0.0, ds["k"], aff,
                          map_stamp=1, altitude_agl=agl,
                          prior_lonlat=use_prior)
        return step
    if backend == "classical":
        from gisnav_tpu_torch.pipeline.classical import (
            classical_frame_to_geopose,
        )
        from gisnav_tpu_torch.pipeline.geopose import PipelineConfig

        ccfg = PipelineConfig(image_shape=ds["image_size"],
                              max_keypoints=max_keypoints or 1024)

        def step(frame, row, agl, use_prior):
            # the reference rotated to the camera yaw
            return classical_frame_to_geopose(
                frame, ds["ortho"], ds["dem"], -row["yaw_deg"], ds["k"], aff,
                config=ccfg, device=device)
        return step
    raise ValueError(f"unsupported replay backend {backend!r}")


def replay(
    path: str,
    weights: str = "learned_lg9",
    backend: str = "deep",
    prior: str = "previous",
    max_keypoints: Optional[int] = None,
    lightglue_depth: Optional[int] = None,
    fused: bool = False,
    progress=None,
    *,
    device=None,
) -> Dict:
    """Run a runner over a dataset; return per-frame results.

    :param prior: position-prior mode — ``none`` (no gating), ``previous``
        (last valid estimate, production-like dead reckoning), ``truth``
        (ground truth; upper-bounds what a good EKF prior would give)
    :param fused: also run the per-frame fixes through the UKF
        (position-only fusion, innovation gating) and report the fused
        track's error per frame — the reference's ULog analysis evaluates
        EKF2's fused output, not raw matcher fixes
    :param device: the runner's and the filter's device; ``None`` is the
        card (raises without one)
    """
    from gisnav_tpu_torch.device import resolve_device
    from gisnav_tpu_torch.geometry.crs import (
        haversine_m,
        pixel_to_wgs84_affine,
    )
    from gisnav_tpu_torch.pipeline.geopose import geopose_to_wgs84_f64

    device = resolve_device(device)
    ds = load_dataset(path)
    left, bottom, right, top = ds["bounds"]
    oh, ow = ds["ortho"].shape[:2]
    aff = pixel_to_wgs84_affine(oh, ow, left, bottom, right, top)
    ground_m = float(np.mean(ds["dem"]))
    step = _step_fn(ds, aff, backend, weights, max_keypoints,
                    lightglue_depth, device)

    ukf = None
    if fused:
        from gisnav_tpu_torch.fusion.filter import (
            PoseFusionFilter,
            SensorConfig,
        )

        # position-only fusion with the production innovation gate; the
        # local frame is ENU meters about the map center
        ukf = PoseFusionFilter(
            {"deep": SensorConfig(
                fuse_mask=(True, True, True, False, False, False),
                rejection_threshold=3.0)},
            backend="ukf", device=device)
    lat_c = 0.5 * (bottom + top)
    m_lat = 111_320.0
    m_lon_c = m_lat * np.cos(np.radians(lat_c))
    lon_c = 0.5 * (left + right)

    def to_enu(lon, lat, alt):
        return np.array([(lon - lon_c) * m_lon_c,
                         (lat - lat_c) * m_lat,
                         alt], np.float64)

    results = []
    prior_lonlat = None
    for i, row in enumerate(ds["poses"]):
        frame = _read_gray8(row["frame_path"])
        agl = row["alt"] - ground_m
        use_prior = None
        if prior == "truth":
            use_prior = (row["lon"], row["lat"])
        elif prior == "previous":
            use_prior = prior_lonlat
        pose = step(frame, row, agl, use_prior)
        out64 = geopose_to_wgs84_f64(pose, np.asarray(aff, np.float64))
        lla = np.array([out64["lon"], out64["lat"],
                        out64["alt_ellipsoid"]], np.float64)
        valid = bool(pose.valid)
        if not np.all(np.isfinite(lla)):
            lla = pose.lon_lat_alt.detach().cpu().numpy().astype(np.float64)
            valid = False
        horiz = float(haversine_m(row["lat"], row["lon"], lla[1], lla[0]))
        # per-axis errors like the reference's ULog notebook (ENU meters)
        m_lon = m_lat * np.cos(np.radians(row["lat"]))
        res = {
            "stamp_us": row["stamp_us"],
            "valid": valid,
            "inliers": int(pose.num_inliers),
            "horiz_m": round(horiz, 3),
            "east_m": round(float((lla[0] - row["lon"]) * m_lon), 3),
            "north_m": round(float((lla[1] - row["lat"]) * m_lat), 3),
            "up_m": round(float(lla[2] - row["alt"]), 3),
            "alt_agl": round(agl, 1),
        }
        if ukf is not None:
            if valid:
                ukf.submit("deep", row["stamp_us"],
                           to_enu(lla[0], lla[1], lla[2]),
                           np.array([0.0, 0.0, 0.0, 1.0]))
            est = ukf.state_at(row["stamp_us"])
            if est is not None:
                err = est["position"] - to_enu(row["lon"], row["lat"],
                                               row["alt"])
                res["fused_horiz_m"] = round(float(np.hypot(*err[:2])), 3)
                res["fused_up_m"] = round(float(err[2]), 3)
        results.append(res)
        if valid and horiz < 200.0:
            prior_lonlat = (float(lla[0]), float(lla[1]))
        if progress:
            progress(i + 1, len(ds["poses"]), res)
    return {"dataset": path, "weights": weights, "frames": results}


def summarize(report: Dict) -> Dict:
    """ULog-notebook-style statistics over a replay report."""
    rows = report["frames"]
    valid = [r for r in rows if r["valid"]]
    out = {
        "frames": len(rows),
        "valid": len(valid),
        "pass_10m": sum(
            1 for r in valid if r["horiz_m"] < 10.0 and abs(r["up_m"]) < 10.0
        ),
    }
    if valid:
        for axis in ("east_m", "north_m", "up_m"):
            vals = np.array([r[axis] for r in valid])
            out[f"mean_abs_{axis}"] = round(float(np.mean(np.abs(vals))), 2)
            out[f"std_{axis}"] = round(float(np.std(vals)), 2)
        out["mean_horiz_m"] = round(
            float(np.mean([r["horiz_m"] for r in valid])), 2)
        out["max_horiz_m"] = round(
            float(np.max([r["horiz_m"] for r in valid])), 2)
        # error vs altitude bands (the notebook's "<150 m" / "<800 m" split)
        for lo, hi in ((0, 150), (150, 800), (800, 1e9)):
            band = [r["horiz_m"] for r in valid if lo <= r["alt_agl"] < hi]
            if band:
                key = f"mean_horiz_{lo}_{'inf' if hi > 1e8 else int(hi)}m_agl"
                out[key] = round(float(np.mean(band)), 2)
    fused = [r for r in rows if "fused_horiz_m" in r]
    if fused:
        out["fused_frames"] = len(fused)
        out["fused_mean_horiz_m"] = round(
            float(np.mean([r["fused_horiz_m"] for r in fused])), 2)
        out["fused_max_horiz_m"] = round(
            float(np.max([r["fused_horiz_m"] for r in fused])), 2)
        out["fused_pass_10m"] = sum(
            1 for r in fused
            if r["fused_horiz_m"] < 10.0 and abs(r["fused_up_m"]) < 10.0)
    return out
