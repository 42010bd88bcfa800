"""Fine-tune harris_lg5 in the cached regime with the port, and fly bundles
through the port's cached runner on the 8-yaw scene of ``chip_smoke.py``'s
path 4, to see whether a short fine-tune leaves the bundle able to fix
every yaw.

    # the port's fine-tune: 10 steps of tools/finetune_bundle.py's recipe
    # (lr 5e-5, seed 7, batch 8, the 600-step difficulty ramp) from the
    # bundled harris_lg5, written as an npz bundle
    python tools/finetune_ramp_check.py --device cpu --steps 10 \\
        --curriculum 600 --out port_ramp10.npz
    # fly bundles (an npz written by either package, or a bundled name)
    python tools/finetune_ramp_check.py --device cpu \\
        --fly harris_lg5 port_ramp10.npz jax_ramp10.npz

The JAX package's own fine-tune of the same recipe is
``JAX_PLATFORMS=cpu python tools/finetune_bundle.py --weights harris_lg5
--regime cached --steps 10 --out jax_ramp10.npz``. Flying both bundles
through one runner holds the serving code fixed, so a difference between
them is the trainer's. Prints one JSON line a bundle: each yaw's validity,
matches, inliers and horizontal error in metres.
"""
import argparse
import json
import logging
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def finetune(args) -> None:
    from gisnav_tpu_torch.train.loop import train
    from gisnav_tpu_torch.train.steps import CachedRegimeConfig
    from gisnav_tpu_torch.weights import (
        infer_config_from_params,
        load_bundled,
        params_to_jax,
        save_npz,
    )

    init = load_bundled("harris_lg5")[0]
    pcfg = infer_config_from_params(init)
    config = CachedRegimeConfig(lightglue_depth=pcfg.lightglue_depth,
                                detector_mode=pcfg.detector_mode,
                                learning_rate=args.lr,
                                curriculum_steps=args.curriculum)
    params = train(steps=args.steps, batch_size=args.batch, config=config,
                   seed=args.seed, device_data=True, init_params=init,
                   device=args.device)
    save_npz(args.out, params_to_jax(params))
    print(f"wrote {args.out}", flush=True)


def fly(args) -> None:
    import torch

    from chip_smoke import HARRIS_SCENE
    from gisnav_tpu_torch.cli import BUNDLED
    from gisnav_tpu_torch.geometry.crs import haversine_m
    from gisnav_tpu_torch.pipeline.geopose import geopose_to_wgs84_f64
    from gisnav_tpu_torch.pipeline.runners import make_cached_deep_runner
    from gisnav_tpu_torch.utils.world import render_scene
    from gisnav_tpu_torch.weights import (
        infer_config_from_params,
        load_bundled,
        load_npz,
    )

    scene = render_scene(**HARRIS_SCENE)
    for name in args.fly:
        wparams = (load_bundled(name)[0] if name in BUNDLED
                   else load_npz(name))
        runner = make_cached_deep_runner(
            wparams, infer_config_from_params(wparams), device=args.device)
        frames = []
        for i, yaw in enumerate(scene.yaws):
            with torch.no_grad():
                pose = runner(scene.frames[i], scene.ortho, scene.dem, yaw,
                              scene.k, scene.crs_affine, map_stamp=1,
                              altitude_agl=scene.alt_m)
            fix = geopose_to_wgs84_f64(pose, scene.crs_affine)
            lon, lat = scene.truth_lonlat[i]
            frames.append({"yaw": yaw, "valid": bool(pose.valid),
                           "matches": int(pose.num_matches),
                           "inliers": int(pose.num_inliers),
                           "error_m": haversine_m(lat, lon, fix["lat"],
                                                  fix["lon"])})
        print(json.dumps({"bundle": name, "frames": frames}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=0,
                    help="fine-tune this many steps (0: none)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=5e-5)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--curriculum", type=int, default=600)
    ap.add_argument("--out", default="tuned_harris_lg5.npz")
    ap.add_argument("--fly", nargs="*", default=[],
                    help="bundles to fly: npz paths or bundled names")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO)
    if args.steps:
        finetune(args)
    if args.fly:
        fly(args)


if __name__ == "__main__":
    main()
