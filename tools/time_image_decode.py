#!/usr/bin/env python3
"""Host time of the port's image decoders, one checkout against another.

Times ``gis/imgcodecs.py`` ``decode_image`` on the files of
``chip_smoke.py``'s ``[formats]`` rows: PNG; TIFF uncompressed, LZW +
predictor 2 and deflate + predictor 2 in 16-row strips, and deflate +
predictor 2 in 256-px tiles; GIF with a 256-entry grey table. Each file is
cut at 800 and 2208 px from the centre of path 8's world (seed 7, 3072 px).
The files are written once, by this checkout's
``tests/torch_image_writers.py``, so that every checkout decodes the same
bytes. Each checkout runs in a process of its own that imports its own
package, in rounds that alternate the order (A B, B A, ...); each decode
must equal the raster it was written from. A time is the median over
``--reps`` of one call, after one warm call. Prints one JSON line per
checkout and round, then one line of each checkout's medians over the
rounds, with the machine's card (``nvidia-smi``) where it has one::

    python tools/time_image_decode.py --roots parent . [--rounds 4]

It needs numpy and the port; no card, no OpenCV, no JAX.
"""
import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SIDES = (800, 2208)
WORLD = dict(seed=7, size_px=3072, gsd_m=1.36)  # chip_smoke.py GRAPH_WORLD


def _files() -> list:
    """[(side, kind, bytes, the raster decode_image must give)]."""
    import importlib.util

    sys.path.insert(0, os.path.join(HERE, ".."))
    from gisnav_tpu_torch.gis.png import encode_png
    from gisnav_tpu_torch.utils.world_wms import World

    # the writers by their path: a ``tests`` package installed on the host
    # would shadow this checkout's
    spec = importlib.util.spec_from_file_location(
        "torch_image_writers",
        os.path.join(HERE, "..", "tests", "torch_image_writers.py"))
    writers = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(writers)
    gif_frame, write_gif, write_tiff = (writers.gif_frame, writers.write_gif,
                                        writers.write_tiff)
    raster = World.make(**WORLD).raster
    table = np.repeat(np.arange(256)[:, None], 3, axis=1)
    out = []
    for side in SIDES:
        at = (raster.shape[0] - side) // 2
        grey = np.ascontiguousarray(raster[at:at + side, at:at + side])
        files = {
            "png": encode_png(grey),
            "tiff": write_tiff(grey, rows_per_strip=16),
            "tiff_lzw_pred2": write_tiff(grey, compression=5, predictor=2,
                                         rows_per_strip=16),
            "tiff_deflate_pred2": write_tiff(grey, compression=8,
                                             predictor=2, rows_per_strip=16),
            "tiff_tiled_deflate_pred2": write_tiff(
                grey, compression=8, predictor=2, tile=(256, 256)),
            "gif": write_gif(grey.shape, [gif_frame(grey)], table),
        }
        for kind, data in files.items():
            want = np.repeat(grey[..., None], 3, axis=2) if kind == "gif" \
                else grey
            out.append((side, kind, data, want))
    return out


def _child(root: str, inputs: str, reps: int) -> None:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import gisnav_tpu_torch
    from gisnav_tpu_torch.gis.imgcodecs import decode_image

    if not os.path.abspath(gisnav_tpu_torch.__file__).startswith(root):
        raise SystemExit(f"imported {gisnav_tpu_torch.__file__}, not {root}")
    with open(inputs, "rb") as f:
        files = pickle.load(f)
    ms = {}
    for side, kind, data, want in files:
        img = decode_image(data)
        if img is None or not np.array_equal(img, want):
            raise SystemExit(f"{root}: the {side}-px {kind} decode is not "
                             "the raster it was written from")
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            decode_image(data)
            times.append((time.perf_counter() - t) * 1e3)
        ms[f"{kind}@{side}"] = float(np.median(times))
    print(json.dumps(ms))


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "no card"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--roots", nargs="+", default=["."],
                    help="checkouts to time (each holds gisnav_tpu_torch/)")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=7,
                    help="timed calls of each decode in a round")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--inputs", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        _child(args.child, args.inputs, args.reps)
        return 0
    rows = {root: [] for root in args.roots}
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "files.pkl")
        with open(inputs, "wb") as f:
            pickle.dump(_files(), f)
        for r in range(args.rounds):
            order = args.roots if r % 2 == 0 else args.roots[::-1]
            for root in order:
                proc = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), "--child",
                     root, "--inputs", inputs, "--reps", str(args.reps)],
                    capture_output=True, text=True, check=True)
                ms = json.loads(proc.stdout.strip().splitlines()[-1])
                rows[root].append(ms)
                print(json.dumps({"root": root, "round": r, "ms": ms}))
    card = _card()
    for root, runs in rows.items():
        med = {k: float(np.median([run[k] for run in runs]))
               for k in runs[0]}
        print(json.dumps({"root": root, "rounds": len(runs),
                          "median_ms": med, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
