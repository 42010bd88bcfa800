"""Command-line interface of the port: ``run`` launches the node graph,
``train`` trains the matcher.

    python -m gisnav_tpu_torch run --protocol uorb --params params.json
    python -m gisnav_tpu_torch train --steps 1000 --ckpt-dir ckpt
    python -m gisnav_tpu_torch train --init-weights harris_lg5 \
        --regime cached --lr 5e-5 --steps 3000 --out tuned.npz

Counterpart of ``gisnav_tpu/cli.py``'s ``build_app``, ``run`` and
``train`` (``train --init-weights/--out`` is the recipe of
``tools/finetune_bundle.py``: start from a bundle, write an npz bundle that
``run --weights`` loads), on the card by default (``--device cuda``;
``--device cpu`` runs the plain PyTorch versions). The graph runs on the
threaded bus (one worker a subscriber). Not offered yet: the JAX CLI's
other commands and ``run``'s ``--ros``, ``--shm``, ``--wfst``,
``--serial-tcp`` and ``--serial-device``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

BUNDLED = ("harris_lg5", "learned_lg9")


def build_app(args):
    """The production graph from ``run``'s arguments (apart from ``run`` so
    a caller can drive the exact graph it builds).

    ``--backend deep`` with a bundled ``--weights`` name lets the pose node
    load the bundle; an ``.npz`` path is loaded here, its config inferred
    from the tree (LightGlue depth, detector head), and the runner of
    ``--deep-mode`` built on ``--device``.
    """
    from gisnav_tpu_torch.nodes.app import GisNavApp
    from gisnav_tpu_torch.nodes.bus import LocalBus

    params = {}
    if args.params:
        with open(args.params) as f:
            params = json.load(f)
    pose_params = dict(params.get("pose_node") or {})
    pose_params.setdefault("backend", args.backend)
    if args.backend == "deep":
        pose_params.setdefault("weights", args.weights)
        pose_params.setdefault("deep_mode", args.deep_mode)
    params["pose_node"] = pose_params

    deep_runner = None
    if args.backend == "deep" and args.weights not in BUNDLED:
        from gisnav_tpu_torch.pipeline.runners import (
            make_bucketed_warp_runner,
            make_cached_deep_runner,
            make_deep_runner,
        )
        from gisnav_tpu_torch.weights import (
            infer_config_from_params,
            load_npz,
        )

        wparams = load_npz(args.weights)
        make = {"warp": make_deep_runner,
                "warp-bucketed": make_bucketed_warp_runner,
                "cached": make_cached_deep_runner}[args.deep_mode]
        deep_runner = make(wparams, infer_config_from_params(wparams),
                           device=args.device)

    return GisNavApp(bus=LocalBus(async_dispatch=True), params=params,
                     protocol=args.protocol, deep_runner=deep_runner,
                     namespace=args.namespace, device=args.device)


def _cmd_run(args) -> int:
    app = build_app(args)
    app.spin(gis_rate_hz=args.gis_rate)
    print(f"gisnav_tpu_torch running (backend={args.backend}, "
          f"protocol={args.protocol}, device={args.device}); "
          "Ctrl-C to stop", flush=True)
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        print(json.dumps(app.shutdown(), indent=2, default=str))
    return 0


def _train_config(args, init=None):
    """The training config of ``train``'s arguments; with a bundle
    (``init``, JAX layout) its LightGlue depth and detector mode."""
    from gisnav_tpu_torch.train.loftr_steps import LoFTRTrainConfig
    from gisnav_tpu_torch.train.steps import CachedRegimeConfig, TrainConfig

    extra = {} if args.curriculum is None else {
        "curriculum_steps": args.curriculum}
    if args.model == "loftr":
        depth = args.depth
        if init is not None:
            depth = sum(1 for k in init["loftr"]["params"]
                        if k.startswith("self_"))
        return LoFTRTrainConfig(image_shape=tuple(args.image_shape),
                                max_matches=args.max_keypoints, depth=depth,
                                learning_rate=args.lr, **extra)
    depth, mode = args.depth, args.detector_mode
    if init is not None:
        from gisnav_tpu_torch.weights import infer_config_from_params

        pcfg = infer_config_from_params(init)
        depth, mode = pcfg.lightglue_depth, pcfg.detector_mode
    if args.regime == "cached":
        return CachedRegimeConfig(lightglue_depth=depth, detector_mode=mode,
                                  learning_rate=args.lr, **extra)
    return TrainConfig(image_shape=tuple(args.image_shape),
                       max_keypoints=args.max_keypoints,
                       lightglue_depth=depth, learning_rate=args.lr,
                       detector_mode=mode, **extra)


def _load_weights(name: str):
    from gisnav_tpu_torch.weights import load_bundled, load_npz

    if name in BUNDLED + ("loftr",):
        return load_bundled(name)[0]
    return load_npz(name)


def _cmd_train(args) -> int:
    import logging

    logging.basicConfig(level=logging.INFO)
    from gisnav_tpu_torch.train.loop import train

    init = _load_weights(args.init_weights) if args.init_weights else None
    params = train(steps=args.steps, batch_size=args.batch,
                   config=_train_config(args, init), ckpt_dir=args.ckpt_dir,
                   seed=args.seed, init_params=init, device=args.device)
    if args.out:
        from gisnav_tpu_torch.weights import params_to_jax, save_npz

        save_npz(args.out, params_to_jax(params))
        print(f"wrote {args.out}", flush=True)
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="gisnav_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    run = sub.add_parser("run", help="launch the full node graph")
    run.add_argument("--protocol", choices=("uorb", "nmea", "ubx"),
                     default="uorb")
    run.add_argument("--backend", choices=("classical", "deep", "semidense"),
                     default="deep")
    run.add_argument("--weights", default="learned_lg9",
                     help="bundled weight set (learned_lg9 | harris_lg5) or "
                          "a path to an .npz checkpoint")
    run.add_argument("--deep-mode",
                     choices=("cached", "warp", "warp-bucketed"),
                     default="warp-bucketed",
                     help="warp-bucketed: the map crop warped at a "
                          "15-degree-quantised rotation, its features "
                          "cached; warp: the exact per-frame warp; cached: "
                          "the unwarped map's features")
    run.add_argument("--params", help="JSON file with per-node parameters")
    run.add_argument("--namespace", default="gisnav",
                     help="namespace of the health topic")
    run.add_argument("--gis-rate", type=float, default=1.0)
    run.add_argument("--device", default="cuda",
                     help="cuda (default) or cpu")
    run.set_defaults(fn=_cmd_run)

    tr = sub.add_parser("train", help="self-supervised matcher training")
    tr.add_argument("--steps", type=int, default=1000)
    tr.add_argument("--batch", type=int, default=8)
    tr.add_argument("--image-shape", type=int, nargs=2, default=(128, 160))
    tr.add_argument("--max-keypoints", type=int, default=256)
    tr.add_argument("--depth", type=int, default=3)
    tr.add_argument("--lr", type=float, default=1e-4)
    tr.add_argument("--detector-mode", default="learned",
                    choices=("learned", "harris"))
    tr.add_argument("--model", default="superpoint_lightglue",
                    choices=("superpoint_lightglue", "loftr"))
    tr.add_argument("--ckpt-dir", default=None)
    tr.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (host pairs, one step at a "
                         "time)")
    tr.add_argument("--seed", type=int, default=0)
    tr.add_argument("--init-weights", default=None,
                    help="start from a bundle (harris_lg5 | learned_lg9 | "
                         "loftr) or an .npz; its depth and detector mode "
                         "replace --depth and --detector-mode")
    tr.add_argument("--regime", default="warp", choices=("warp", "cached"),
                    help="warp: symmetric pairs; cached: the asymmetric "
                         "cached-reference fine-tune (device pairs)")
    tr.add_argument("--curriculum", type=int, default=None,
                    help="difficulty ramp steps (default: the config's)")
    tr.add_argument("--out", default=None,
                    help="write the trained params as an npz bundle")
    tr.set_defaults(fn=_cmd_train)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
