"""Accuracy sweep at the headline bench config on the port (1088x1920, 2048
keypoints, LightGlue-9, ``learned_lg9``).

The PyTorch counterpart of ``tools/sweep_headline.py``: the same arguments
and defaults (plus ``--device``), the same worlds (the shared 1.36 m/px
shape world of ``tests/test_integration.py``, or a world rastered at
``--world-gsd`` m/px), the same map sizing (3x the squared camera
footprint at the camera-diagonal pixel size) and camera (f = 400 px at
640 px wide), the same three runners, and the same JSON line: a pose is
``ok`` when it is valid and within 10 m horizontally and vertically of the
truth (the reference SITL gate, ``test/sitl/sitl_px4.py:263-280`` in
hmakelin/gisnav). The worlds are rendered without OpenCV
(``gisnav_tpu_torch/utils/envelope.py``); the runners run on the card
unless ``--device cpu`` is given.

    python tools/sweep_headline_torch.py --mode warp-bucketed --alts 500 \\
        --world-gsd 0.417 --yaws 7.5 52.5 97.5 142.5 187.5 232.5 277.5 322.5
    python tools/sweep_headline_torch.py --mode warp --alts 500 \\
        --world-gsd 0.417 [--device cpu] [--out FILE]

Prints a line a pose, the card's name and power limit (on the card), then
one JSON line; with ``--out`` also writes that line to a file.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Callable, Optional

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# the flight: near the middle of the world
LAT0, LON0 = 60.025, 24.04
M_PER_DEG_LAT = 111320.0


@dataclasses.dataclass
class SweepWorld:
    """A world raster and its georeference (the top-left corner, degrees a
    pixel, metres a pixel)."""
    img: np.ndarray
    gsd_m: float
    left: float
    top: float
    gsd_lon: float
    gsd_lat: float
    lonlat_to_wpx: Callable


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--alts", type=float, nargs="+", default=[150, 300, 500])
    ap.add_argument("--yaws", type=float, nargs="+",
                    default=[0, 45, 90, 135, 180, 225, 270, 315])
    ap.add_argument("--weights", default="learned_lg9")
    ap.add_argument("--hw", type=int, nargs=2, default=(1088, 1920))
    ap.add_argument("--kp", type=int, default=2048)
    ap.add_argument("--depth", type=int, default=9)
    ap.add_argument("--world-gsd", default=None,
                    help="render from a world rastered at this GSD "
                         "(m/px); 'auto' matches the query GSD at the "
                         "lowest altitude; default: the legacy shared "
                         "~1.36 m/px test world")
    ap.add_argument("--derotate", action="store_true",
                    help="query-side derotation from the known yaw "
                         "(make_cached_deep_runner)")
    ap.add_argument("--bucket-deg", type=float, default=15.0,
                    help="warp-bucketed mode: rotation bucket width; "
                         "sweep yaws at bucket-edge offsets to measure "
                         "the worst-case residual")
    ap.add_argument("--mode", choices=("cached", "warp", "warp-bucketed"),
                    default="cached",
                    help="cached = device-resident map features; warp = "
                         "rotate + crop + re-extract per frame "
                         "(make_deep_runner)")
    ap.add_argument("--prior-m", type=float, default=None,
                    help="cached mode: pass a position prior offset this "
                         "many meters from truth (emulates the fused fix "
                         "the pose node feeds back; enables the "
                         "FOV-radius candidate gate)")
    ap.add_argument("--octave-falloff", type=float, default=0.85,
                    help="matched-world texture amplitude falloff per "
                         "octave; 1.0 = constant power per octave band "
                         "(natural-image statistic)")
    ap.add_argument("--threshold-px", type=float, default=None,
                    help="RANSAC inlier threshold override (query px)")
    ap.add_argument("--hypotheses", type=int, default=None,
                    help="RANSAC hypothesis batch override")
    ap.add_argument("--refine-iters", type=int, default=None,
                    help="Gauss-Newton refine iteration override")
    ap.add_argument("--device", default="cuda",
                    help="where the runners run: cuda (default) or cpu")
    ap.add_argument("--out", default=None)
    return ap.parse_args(argv)


def camera(args) -> tuple:
    """(h, w, f, K): the validated e2e suite's field of view (f = 400 px at
    640 px wide)."""
    h, w = args.hw
    f = 400.0 * w / 640.0
    k = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]], np.float32)
    return h, w, f, k


def make_world(args) -> SweepWorld:
    """The legacy shape world, or a :class:`~gisnav_tpu_torch.utils.
    envelope.MatchedWorld` covering the largest map request (3x the
    footprint at the highest altitude) plus the flight's offsets."""
    from gisnav_tpu_torch.utils import envelope

    h, w, f, _ = camera(args)
    if args.world_gsd is None:
        return SweepWorld(envelope.shape_world(), envelope.M_PER_WPX,
                          envelope.LEFT, envelope.TOP, envelope.GSD_LON,
                          envelope.GSD_LAT, envelope.lonlat_to_wpx)
    gsd = (min(args.alts) / f if args.world_gsd == "auto"
           else float(args.world_gsd))
    side_m = 3.0 * max(args.alts) * max(h, w) / f * 1.1 + 200.0
    mw = envelope.MatchedWorld(side_m, gsd, LON0, LAT0,
                               octave_falloff=args.octave_falloff)
    print(f"matched world: {mw.w_px}x{mw.w_px} px at {mw.gsd_m:.3f} m/px",
          flush=True)
    return SweepWorld(mw.world, mw.gsd_m, mw.left, mw.top, mw.gsd_lon,
                      mw.gsd_lat, mw.lonlat_to_wpx)


def make_map(args, world: SweepWorld, alt: float):
    """North-up map at the production sizing: the bbox layer squares the
    footprint and pads it by one side (3x ground coverage), the GIS node
    asks for it at the camera-diagonal pixel size (INTER_AREA where the
    crop shrinks, else INTER_LINEAR); (ortho, dem, affine)."""
    from gisnav_tpu_torch.geometry.crs import pixel_to_wgs84_affine
    from gisnav_tpu_torch.utils.world import resize_area_u8, resize_linear_u8

    h, w, f, _ = camera(args)
    map_px = int(np.ceil(float(np.hypot(h, w)) / 8)) * 8
    side_m = 3.0 * alt * max(h, w) / float(np.float32(f))
    side_wpx = int(round(side_m / world.gsd_m))
    cx, cy = world.lonlat_to_wpx(LON0, LAT0)
    x0 = int(cx - side_wpx / 2)
    y0 = int(cy - side_wpx / 2)
    crop = world.img[y0:y0 + side_wpx, x0:x0 + side_wpx]
    if crop.shape != (side_wpx, side_wpx):
        raise ValueError(f"map request of {side_wpx} px exceeds the world "
                         f"({crop.shape})")
    resize = resize_area_u8 if side_wpx > map_px else resize_linear_u8
    ortho = resize(crop, map_px, map_px)
    left = world.left + x0 * world.gsd_lon
    top = world.top - y0 * world.gsd_lat
    right = left + side_wpx * world.gsd_lon
    bottom = top - side_wpx * world.gsd_lat
    aff = pixel_to_wgs84_affine(map_px, map_px, left, bottom, right, top)
    return ortho, np.zeros((map_px, map_px), np.float32), aff


def make_runner(args):
    """The mode's runner over the bundle at the sweep's shape."""
    from gisnav_tpu_torch.pipeline.runners import (make_bucketed_warp_runner,
                                                   make_cached_deep_runner,
                                                   make_deep_runner)
    from gisnav_tpu_torch.weights import load_bundled

    h, w, _, _ = camera(args)
    params, base = load_bundled(args.weights)
    overrides = dict(image_shape=(h, w), max_keypoints=args.kp,
                     lightglue_depth=args.depth)
    if args.threshold_px is not None:
        overrides["threshold_px"] = args.threshold_px
    if args.hypotheses is not None:
        overrides["num_hypotheses"] = args.hypotheses
    if args.refine_iters is not None:
        overrides["refine_iters"] = args.refine_iters
    cfg = dataclasses.replace(base, **overrides)
    if args.mode == "warp":
        return make_deep_runner(params, cfg, device=args.device)
    if args.mode == "warp-bucketed":
        return make_bucketed_warp_runner(params, cfg,
                                         bucket_deg=args.bucket_deg,
                                         device=args.device)
    return make_cached_deep_runner(params, cfg, derotate=args.derotate,
                                   device=args.device)


def sweep(args, world: Optional[SweepWorld] = None,
          on_frame: Optional[Callable] = None) -> dict:
    """Fly every altitude and yaw of ``args``; returns the summary (the
    JSON line's object). ``world`` reuses a rendered world; ``on_frame(row,
    ms)`` is called after each pose is assembled, with the host-clock ms
    of the runner's call (synchronised on the card)."""
    import torch

    from gisnav_tpu_torch.geometry.crs import haversine_m
    from gisnav_tpu_torch.pipeline.geopose import geopose_to_wgs84_f64
    from gisnav_tpu_torch.utils.envelope import nadir_frame

    h, w, f, k_cam = camera(args)
    m_per_deg_lon = M_PER_DEG_LAT * np.cos(np.radians(LAT0))
    world = world or make_world(args)
    runner = make_runner(args)
    rows = []
    for ai, alt in enumerate(args.alts):
        ortho, dem, aff = make_map(args, world, alt)
        for yaw in args.yaws:
            lon = LON0 + 0.0004 * np.cos(np.radians(yaw))
            lat = LAT0 + 0.0002 * np.sin(np.radians(yaw))
            cx, cy = world.lonlat_to_wpx(lon, lat)
            frame = nadir_frame(world.img, cx, cy, alt / world.gsd_m, yaw,
                                k_cam, (h, w))
            kw = {}
            if args.mode == "cached" and args.prior_m is not None:
                # the truth displaced by --prior-m (bearing varied per
                # pose): the fused fix the pose node feeds back
                brg = np.radians(yaw + 77.0)
                kw["prior_lonlat"] = (
                    lon + args.prior_m * np.sin(brg) / m_per_deg_lon,
                    lat + args.prior_m * np.cos(brg) / M_PER_DEG_LAT)
            # the map-alignment rotation: +yaw for this renderer (the pose
            # node's rotation); the cached derotation inverts it itself
            rot = yaw if (args.derotate or args.mode.startswith("warp")) \
                else 0.0
            t0 = time.perf_counter()
            pose = runner(frame, ortho, dem, rot, k_cam, aff,
                          map_stamp=ai + 1, altitude_agl=alt, **kw)
            if args.device != "cpu":
                torch.cuda.synchronize()
            frame_ms = (time.perf_counter() - t0) * 1e3
            # f64 host assembly (the device's lla is f32)
            out64 = geopose_to_wgs84_f64(pose, np.asarray(aff, np.float64))
            lla = np.array([out64["lon"], out64["lat"],
                            out64["alt_ellipsoid"]], np.float64)
            if not np.all(np.isfinite(lla)):
                lla = pose.lon_lat_alt.detach().cpu().numpy().astype(
                    np.float64)
            horiz = haversine_m(lat, lon, lla[1], lla[0])
            vert = abs(lla[2] - alt)
            row = {"alt": alt, "yaw": yaw, "valid": bool(pose.valid),
                   "inliers": int(pose.num_inliers),
                   "horiz_m": round(float(horiz), 2),
                   "vert_m": round(float(vert), 2)}
            rows.append(row)
            print(f"alt={alt:5.0f} yaw={yaw:5.1f} valid={row['valid']} "
                  f"inl={row['inliers']:4d} horiz={horiz:7.2f} m "
                  f"vert={vert:6.2f} m", flush=True)
            if on_frame is not None:
                on_frame(row, frame_ms)
    ok = [r for r in rows if r["valid"] and r["horiz_m"] < 10.0
          and r["vert_m"] < 10.0]
    horiz = [r["horiz_m"] for r in rows if r["valid"]]
    mode_tag = args.mode + ("_derot" if args.derotate else "") + (
        f"_prior{args.prior_m:g}m" if args.prior_m is not None else "")
    return {
        "config": f"{h}x{w}_{args.kp}kp_lg{args.depth}_{args.weights}"
                  f"_{mode_tag}",
        "world_gsd_m": round(float(world.gsd_m), 3),
        "poses": len(rows),
        "valid": sum(r["valid"] for r in rows),
        "pass_10m": len(ok),
        "mean_horiz_m": round(float(np.mean(horiz)), 2) if horiz else None,
        "max_horiz_m": round(float(np.max(horiz)), 2) if horiz else None,
        "rows": rows,
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    summary = sweep(args)
    if args.device != "cpu":
        from gisnav_tpu_torch.bench import _card_label

        print(_card_label(), flush=True)
    line = json.dumps(summary)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
