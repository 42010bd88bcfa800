"""Command-line interface of the port: ``run`` launches the node graph.

    python -m gisnav_tpu_torch run --protocol uorb --params params.json

Counterpart of ``gisnav_tpu/cli.py``'s ``build_app`` and ``run``, on the
card by default (``--device cuda``; ``--device cpu`` runs the plain PyTorch
versions). The graph runs on the threaded bus (one worker a subscriber).
Not offered yet: the JAX CLI's other commands and ``run``'s ``--ros``,
``--shm``, ``--wfst``, ``--serial-tcp`` and ``--serial-device``.
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
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
