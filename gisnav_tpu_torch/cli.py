"""Command-line interface of the port.

    python -m gisnav_tpu_torch run --protocol uorb --params params.json
    python -m gisnav_tpu_torch run --shm --wfst --protocol uorb
    python -m gisnav_tpu_torch train --steps 1000 --ckpt-dir ckpt
    python -m gisnav_tpu_torch replay DATASET --weights harris_lg5 --fused
    python -m gisnav_tpu_torch health --namespace gisnav
    python -m gisnav_tpu_torch doctor --wms-url http://mapserver/wms
    python -m gisnav_tpu_torch serial --protocol nmea --tcp px4:15000
    python -m gisnav_tpu_torch gis-serve --maps maps/ --port 8080
    python -m gisnav_tpu_torch fleet --dry-run up gisnav

Counterpart of ``gisnav_tpu/cli.py`` with its commands, flags and exit
codes (``train --init-weights/--out`` is the recipe of
``tools/finetune_bundle.py``: start from a bundle, write an npz bundle that
``run --weights`` loads). ``run``, ``train`` and ``replay`` run on the card
by default (``--device cuda``; ``--device cpu`` runs the plain PyTorch
versions). ``run`` builds the graph on the threaded in-process bus, or with
``--shm`` on the shared-memory bus, which other processes (``health``,
``serial``, a ROS bridge) attach to. ``health``, ``serial``, ``gis-serve``
and ``fleet`` never touch the card.

Written departures: ``--namespace`` names both the shared-memory bus's
namespace and the health topic, ``/<namespace>/health``, and ``health``
listens there (the JAX CLI listens on a fixed ``/gisnav/health``).
``doctor`` probes CUDA (device name and compute capability, 9.0
expected), builds the five kernel libraries, the shared-memory bus library
and the JPEG codec, and round-trips the PNG and JPEG codecs, where the JAX
CLI probes JAX's devices and OpenCV; it exits 1 when no CUDA device answers
(the port has no CPU fallback).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

BUNDLED = ("harris_lg5", "learned_lg9")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_app(args):
    """The production graph from ``run``'s arguments (apart from ``run`` so
    a caller can drive the exact graph it builds).

    ``--backend deep`` with a bundled ``--weights`` name lets the pose node
    load the bundle; an ``.npz`` path is loaded here, its config inferred
    from the tree (LightGlue depth, detector head), and the runner of
    ``--deep-mode`` built on ``--device``. The bus is the threaded
    ``LocalBus``, or ``ShmBus(namespace)`` with ``--shm``. ``--ros``
    attaches the ROS bridge as ``app.ros_adapter`` (``None``, with a
    warning, without rclpy); ``--serial-tcp`` / ``--serial-device`` attach
    a ``SerialBridge`` as ``app.serial_bridge`` for the nmea and ubx
    protocols (uorb rides the DDS agent).
    """
    from gisnav_tpu_torch.nodes.app import GisNavApp
    from gisnav_tpu_torch.nodes.bus import LocalBus, ShmBus

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

    shm = getattr(args, "shm", False)
    bus = (ShmBus(namespace=args.namespace) if shm
           else LocalBus(async_dispatch=True))
    app = GisNavApp(bus=bus, params=params, protocol=args.protocol,
                    wfst=getattr(args, "wfst", False),
                    deep_runner=deep_runner, namespace=args.namespace,
                    device=args.device)
    app.ros_adapter = None
    if getattr(args, "ros", False):
        from gisnav_tpu_torch.nodes.ros_adapter import maybe_attach

        app.ros_adapter = maybe_attach(bus, protocols=(args.protocol,))
        if app.ros_adapter is None:
            print("[WARN] --ros requested but rclpy is not importable; "
                  "running without the ROS bridge", file=sys.stderr)
    app.serial_bridge = None
    tcp = getattr(args, "serial_tcp", None)
    device = getattr(args, "serial_device", None)
    if (tcp or device) and args.protocol in ("nmea", "ubx"):
        from gisnav_tpu_torch.io.serial_bridge import SerialBridge

        app.serial_bridge = SerialBridge(bus, protocol=args.protocol,
                                         tcp=tcp, device=device)
    return app


def _cmd_run(args) -> int:
    import threading

    app = build_app(args)
    app.spin(gis_rate_hz=args.gis_rate)
    adapter, spin_thread = app.ros_adapter, None
    if adapter is not None:
        spin_thread = threading.Thread(target=adapter.spin, daemon=True,
                                       name="ros-adapter-spin")
        spin_thread.start()
    print(f"gisnav_tpu_torch running (backend={args.backend}, "
          f"protocol={args.protocol}, "
          f"transport={'shm' if args.shm else 'local'}, "
          f"ros={'on' if adapter else 'off'}, device={args.device}); "
          "Ctrl-C to stop", flush=True)
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        if app.serial_bridge is not None:
            app.serial_bridge.close()
        if adapter is not None:
            adapter.close()
            spin_thread.join(timeout=3.0)
        print(json.dumps(app.shutdown(), indent=2, default=str), flush=True)
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


def _cmd_replay(args) -> int:
    """Offline replay: recorded frames + ground truth -> error report
    (dataset layout: ``gisnav_tpu_torch/replay.py``); exit 0 when every
    frame passes 10 m."""
    from gisnav_tpu_torch.replay import replay, summarize

    def progress(i, n, res):
        print(f"[{i}/{n}] stamp={res['stamp_us']} valid={res['valid']} "
              f"inl={res['inliers']:4d} horiz={res['horiz_m']:8.2f} m",
              flush=True)

    report = replay(args.dataset, weights=args.weights, backend=args.backend,
                    prior=args.prior, max_keypoints=args.max_keypoints,
                    lightglue_depth=args.depth, fused=args.fused,
                    progress=None if args.quiet else progress,
                    device=args.device)
    summary = summarize(report)
    print(json.dumps(summary), flush=True)
    if args.out:
        report["summary"] = summary
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0 if summary.get("pass_10m", 0) == summary["frames"] else 1


def _cmd_health(args) -> int:
    """Wait for a heartbeat on ``/<namespace>/health`` over the shared-memory
    bus; exit 0 when one arrives within ``--timeout`` (with ``--strict``,
    every node of it healthy), else 1. The container healthcheck of the
    compose service."""
    import threading

    from gisnav_tpu_torch.nodes.bus import ShmBus

    got = threading.Event()
    report = {}

    def on_health(msg):
        report.update(msg)
        got.set()

    bus = ShmBus(namespace=args.namespace)
    try:
        bus.subscribe(f"/{args.namespace}/health", on_health)
        if not got.wait(timeout=args.timeout):
            print(f"UNHEALTHY: no heartbeat within {args.timeout:.0f} s",
                  flush=True)
            return 1
        unhealthy = [n for n, r in report.items() if not r.get("healthy")]
        if args.strict and unhealthy:
            print(f"UNHEALTHY nodes: {', '.join(unhealthy)}", flush=True)
            return 1
        print(f"healthy ({len(report)} nodes"
              + (f", idle: {', '.join(unhealthy)}" if unhealthy else "")
              + ")", flush=True)
        return 0
    finally:
        bus.close()


# a smooth 16x24 ramp, grey and BGR, through encode_jpeg and decode_jpeg
_JPEG_ROUND_TRIP_LEVELS = 2
_CUDA_PROBE = (
    "import torch\n"
    "print(torch.__version__)\n"
    "if not torch.cuda.is_available():\n"
    "    raise SystemExit(1)\n"
    "print(torch.cuda.get_device_name(0))\n"
    "print('%d.%d' % torch.cuda.get_device_capability(0))\n")


def _cmd_doctor(args) -> int:
    """Environment self-check: the CUDA device, the kernel and bus
    libraries, the WMS if given, the PNG codec; exit 1 on a failure."""
    import subprocess

    import numpy as np

    ok = True
    # the device probe runs in a subprocess with a deadline: a driver that
    # hangs must fail the check, not hang it
    probe = subprocess.Popen([sys.executable, "-c", _CUDA_PROBE],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.DEVNULL, text=True)
    try:
        out, _ = probe.communicate(timeout=args.device_timeout)
        lines = out.strip().splitlines()
        if probe.returncode == 0 and len(lines) == 3:
            ver, name, cap = lines
            tag = "ok" if cap == "9.0" else "FAIL"
            ok &= cap == "9.0"
            print(f"[{tag}] torch {ver}, CUDA device: {name} (compute "
                  f"capability {cap}; the kernels are built for 9.0)")
        else:
            print(f"[FAIL] no CUDA device answers (torch "
                  f"{lines[0] if lines else '?'}; probe exited "
                  f"{probe.returncode}); the port has no CPU fallback")
            ok = False
    except subprocess.TimeoutExpired:
        probe.kill()
        probe.communicate()
        print(f"[FAIL] CUDA device probe exceeded "
              f"{args.device_timeout:.0f} s")
        ok = False
    try:
        from gisnav_tpu_torch.kernels.build import build_all

        libs = build_all()
        print(f"[ok] {len(libs)} kernel libraries: "
              f"{', '.join(sorted(libs))}")
    except Exception as e:  # noqa: BLE001 - reported, the check goes on
        print(f"[FAIL] kernel build: {e}")
        ok = False
    try:
        from gisnav_tpu_torch.native import build_native_lib

        print(f"[ok] native shm bus: {build_native_lib('shmbus')}")
    except Exception as e:  # noqa: BLE001 - reported, the check goes on
        print(f"[FAIL] native shm bus build: {e}")
        ok = False
    if args.wms_url:
        from gisnav_tpu_torch.gis.wms import WMSClient

        if WMSClient(args.wms_url, timeout_s=3.0).is_available():
            print(f"[ok] WMS reachable: {args.wms_url}")
        else:
            print(f"[WARN] WMS not reachable: {args.wms_url}")
    from gisnav_tpu_torch.gis.png import decode_png, encode_png

    img = np.arange(48, dtype=np.uint8).reshape(6, 8)
    if np.array_equal(decode_png(encode_png(img)), img):
        print("[ok] PNG codec (WMS replies, replay datasets)")
    else:
        print("[FAIL] PNG codec round trip")
        ok = False
    try:
        from gisnav_tpu_torch.gis.jpeg import decode_jpeg, encode_jpeg
        from gisnav_tpu_torch.native import build_native_lib

        lib = build_native_lib("jpeg")
        smooth = (np.add.outer(np.arange(16), np.arange(24)) * 4).astype(
            np.uint8)
        err = 0
        for img in (smooth, np.stack([smooth] * 3, -1)):
            out = decode_jpeg(encode_jpeg(img))
            err = max(err, 256 if out is None or out.shape != img.shape
                      else int(np.abs(out.astype(int) - img).max()))
        if err <= _JPEG_ROUND_TRIP_LEVELS:
            print(f"[ok] JPEG codec: {lib} (round trip at quality 95 within "
                  f"{err} levels)")
        else:
            print(f"[FAIL] JPEG codec round trip ({err} levels)")
            ok = False
    except Exception as e:  # noqa: BLE001 - reported, the check goes on
        print(f"[FAIL] JPEG codec: {e}")
        ok = False
    return 0 if ok else 1


def _cmd_serial(args) -> int:
    """Bridge a running graph's mock-GPS output to a pty or a TCP port."""
    from gisnav_tpu_torch.io.serial_bridge import SerialBridge
    from gisnav_tpu_torch.nodes.bus import ShmBus

    bus = ShmBus(namespace=args.namespace)
    if args.tcp:
        bridge = SerialBridge(bus, protocol=args.protocol, tcp=args.tcp)
        print(f"serial bridge up: {args.protocol} -> tcp {args.tcp} "
              f"(connected={bridge.connected}); Ctrl-C to stop", flush=True)
    else:
        bridge = SerialBridge(bus, protocol=args.protocol, link=args.link)
        print(f"serial bridge up: {args.protocol} -> {args.link} "
              f"(pty {bridge.slave_path}); Ctrl-C to stop", flush=True)
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        bridge.close()
        bus.close()
    return 0


def _cmd_gis_serve(args) -> int:
    """Host the self-contained demo GIS service (WMS + WFS-T)."""
    from gisnav_tpu_torch.gis.server import (
        GisServer,
        PostGISStore,
        SQLiteStore,
        load_layers_from_dir,
    )

    layers = {}
    if args.maps:
        if not os.path.isdir(args.maps):
            print(f"maps dir {args.maps!r} not found — generate one with "
                  "tools/make_demo_geotiff_torch.py", file=sys.stderr)
            return 2
        layers = load_layers_from_dir(args.maps)
        if not layers:
            print(f"no GeoTIFFs under {args.maps!r}/imagery or /dem",
                  file=sys.stderr)
            return 2
    store = PostGISStore(args.pg) if args.pg else SQLiteStore(args.db)
    server = GisServer(layers=layers, store=store, host=args.host,
                       port=args.port)
    print(f"GIS server on :{server.port} — WMS layers "
          f"[{', '.join(sorted(layers)) or 'none'}], WFS-T store "
          f"{'postgis' if args.pg else args.db}; Ctrl-C to stop", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.stop()
    return 0


def _fleet_groups(services, hosts):
    """Group services by execution target: a ``service@remote`` goes to
    that ssh target, plain services to every ``--host`` (or locally when
    none is given), as the reference's ``gnc`` addresses them. Returns an
    ordered ``{target-or-None: [services]}`` dict."""
    groups: dict = {}
    plain = []
    for svc in services:
        if "@" in svc:
            name, target = svc.split("@", 1)
            groups.setdefault(target, []).append(name)
        else:
            plain.append(svc)
    if plain or not groups:
        for target in (hosts or [None]):
            groups[target] = plain + groups.get(target, [])
    return groups


def _fleet_command(args, target, services):
    if target is None:
        return ["docker", "compose", "-p", "gisnav-tpu", "-f",
                args.compose_file, args.verb, *args.extra, *services]
    # remotes use the checkout-relative compose file; a leading ~ stays
    # unquoted so the remote shell expands it
    import shlex

    rp = args.remote_path
    rp_q = ("~" + shlex.quote(rp[1:])) if rp.startswith("~") \
        else shlex.quote(rp)
    base = ["docker", "compose", "-p", "gisnav-tpu", "-f",
            "docker/docker-compose.yaml", args.verb, *args.extra, *services]
    return ["ssh", "-o", "BatchMode=yes", target,
            f"cd {rp_q} && " + " ".join(shlex.quote(c) for c in base)]


def _cmd_fleet(args) -> int:
    """Fan a docker compose verb out to local and remote hosts (the
    reference's ``gnc``): each target runs ``docker compose -p gisnav-tpu
    -f <file> VERB ...``; exit with the largest return code."""
    import subprocess
    from concurrent.futures import ThreadPoolExecutor

    cmds = [(t, _fleet_command(args, t, svcs))
            for t, svcs in _fleet_groups(args.services, args.host).items()]
    if args.dry_run:
        for target, cmd in cmds:
            print(f"[{target or 'local'}] {' '.join(cmd)}")
        return 0

    def run_one(item):
        target, cmd = item
        rc = subprocess.run(cmd).returncode
        if rc != 0:
            print(f"[{target or 'local'}] exited {rc}", file=sys.stderr)
        return rc

    with ThreadPoolExecutor(max_workers=max(1, len(cmds))) as pool:
        rcs = list(pool.map(run_one, cmds))
    return max(rcs) if rcs else 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="gisnav_tpu_torch")
    try:
        from importlib.metadata import version

        ver = version("gisnav-tpu")
    except Exception:  # noqa: BLE001 - a source checkout, not installed
        ver = "0.1.0"
    parser.add_argument("--version", action="version",
                        version=f"gisnav_tpu_torch {ver}")
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
    run.add_argument("--ros", action="store_true",
                     help="bridge the bus to ROS 2 topics (needs rclpy)")
    run.add_argument("--params", help="JSON file with per-node parameters")
    run.add_argument("--shm", action="store_true",
                     help="use the shared-memory bus (multi-process graphs)")
    run.add_argument("--namespace", default="gisnav",
                     help="shared-memory bus namespace and health topic "
                          "/<namespace>/health")
    run.add_argument("--wfst", action="store_true",
                     help="also run the WFS-T telemetry sink")
    run.add_argument("--gis-rate", type=float, default=1.0)
    run.add_argument("--serial-tcp", default=None, metavar="HOST:PORT",
                     help="also bridge the mock-GPS output (nmea/ubx) to a "
                          "TCP listener on the simulation container")
    run.add_argument("--serial-device", default=None, metavar="PATH",
                     help="also bridge the mock-GPS output (nmea/ubx) to a "
                          "serial device (HIL, e.g. /dev/ttyUSB0)")
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

    rp = sub.add_parser(
        "replay", help="offline replay of recorded frames vs ground truth")
    rp.add_argument("dataset",
                    help="dataset dir (see gisnav_tpu_torch/replay.py)")
    rp.add_argument("--backend", choices=("deep", "classical"),
                    default="deep")
    rp.add_argument("--weights", default="learned_lg9")
    rp.add_argument("--prior", choices=("none", "previous", "truth"),
                    default="previous")
    rp.add_argument("--max-keypoints", type=int, default=None)
    rp.add_argument("--depth", type=int, default=None)
    rp.add_argument("--fused", action="store_true",
                    help="also evaluate the UKF-fused track")
    rp.add_argument("--out", default=None, help="write full JSON report")
    rp.add_argument("--quiet", action="store_true")
    rp.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    rp.set_defaults(fn=_cmd_replay)

    health = sub.add_parser(
        "health", help="probe a running graph's heartbeat (shm bus)")
    health.add_argument("--namespace", default="gisnav")
    health.add_argument("--timeout", type=float, default=12.0,
                        help="max seconds to wait for one heartbeat "
                             "(published every 5 s)")
    health.add_argument("--strict", action="store_true",
                        help="also require every node to report healthy")
    health.set_defaults(fn=_cmd_health)

    doctor = sub.add_parser("doctor", help="environment self-check")
    doctor.add_argument("--wms-url", default=None)
    doctor.add_argument("--device-timeout", type=float, default=60.0,
                        help="hard deadline for the CUDA device probe")
    doctor.set_defaults(fn=_cmd_doctor)

    serial = sub.add_parser(
        "serial", help="pty bridge: mock-GPS bus output -> autopilot port")
    serial.add_argument("--protocol", choices=("nmea", "ubx"),
                        default="nmea")
    serial.add_argument(
        "--tcp", default=None, metavar="HOST:PORT",
        help="connect a TCP stream instead of opening a pty (socat on the "
             "simulation side turns it back into a serial device)")
    serial.add_argument("--link", default="/tmp/gisnav-gps",
                        help="stable symlink to the pty slave")
    serial.add_argument("--namespace", default="gisnav",
                        help="shared-memory bus namespace of the graph")
    serial.set_defaults(fn=_cmd_serial)

    gis = sub.add_parser(
        "gis-serve",
        help="host the self-contained demo GIS service (WMS + WFS-T)")
    gis.add_argument("--maps", default=None, metavar="DIR",
                     help="maps dir with imagery/ and dem/ GeoTIFFs")
    gis.add_argument("--db", default=":memory:",
                     help="SQLite path for the WFS-T feature store")
    gis.add_argument("--pg", default=None, metavar="DSN",
                     help="PostGIS DSN (overrides --db)")
    gis.add_argument("--host", default="0.0.0.0")
    gis.add_argument("--port", type=int, default=8080)
    gis.set_defaults(fn=_cmd_gis_serve)

    fleet = sub.add_parser(
        "fleet", help="fan compose verbs out to local/remote hosts (gnc)")
    fleet.add_argument("--host", action="append", default=None,
                       help="ssh target (user@host); repeatable")
    fleet.add_argument("--remote-path", default="~/gisnav_tpu",
                       help="repo checkout path on remote hosts")
    fleet.add_argument("--compose-file", default=os.path.join(
        _REPO, "docker", "docker-compose.yaml"))
    fleet.add_argument("--dry-run", action="store_true",
                       help="print the commands without executing")
    fleet.add_argument("verb",
                       help="any docker compose verb (up, down, ps, ...)")
    fleet.add_argument("services", nargs="*",
                       help="service names, optionally service@remote")
    fleet.add_argument("--extra", nargs="*", default=[],
                       help="extra compose args (use = for dashed values, "
                            "e.g. --extra=-d)")
    fleet.set_defaults(fn=_cmd_fleet)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
