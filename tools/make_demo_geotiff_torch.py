#!/usr/bin/env python3
"""Render the demo world into georeferenced GeoTIFFs with gisnav_tpu_torch.

The port's counterpart of ``tools/make_demo_geotiff.py``, with its
arguments, defaults and layout, and files byte for byte equal to it: a
single-band uint8 imagery GeoTIFF (``utils/world.py`` ``synthetic_world``)
and a float32 DEM GeoTIFF (``synthetic_dem``, seed + 4) over the demo
extent near KSQL airport (``DEMO_GEOREF``), written by the port's
``gis/geotiff.py``. It needs numpy and the port only: no OpenCV, no JAX,
no ``gisnav_tpu``. Serve the result with::

    python tools/make_demo_geotiff_torch.py --out maps [--size 4096] \\
        [--dem-size 1024] [--seed 7] [--relief-m 12.0]
    python -m gisnav_tpu_torch gis-serve --maps maps
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="docker/mapserver/maps",
                    help="output directory (imagery/ and dem/ subdirs)")
    ap.add_argument("--size", type=int, default=4096,
                    help="imagery size in pixels (square)")
    ap.add_argument("--dem-size", type=int, default=1024,
                    help="DEM size in pixels (square, same extent)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--relief-m", type=float, default=12.0,
                    help="DEM terrain relief amplitude in meters")
    args = ap.parse_args()

    from gisnav_tpu_torch.gis.geotiff import write_geotiff
    from gisnav_tpu_torch.utils.world import (
        DEMO_GEOREF,
        synthetic_dem,
        synthetic_world,
    )

    imagery_dir = os.path.join(args.out, "imagery")
    dem_dir = os.path.join(args.out, "dem")
    os.makedirs(imagery_dir, exist_ok=True)
    os.makedirs(dem_dir, exist_ok=True)

    world = synthetic_world(args.size, seed=args.seed)
    img_path = os.path.join(imagery_dir, "demo_imagery.tif")
    write_geotiff(img_path, world, DEMO_GEOREF.georef(args.size))
    print(f"wrote {img_path} ({args.size}x{args.size} uint8, "
          f"{os.path.getsize(img_path) / 1e6:.1f} MB)")

    dem = synthetic_dem(args.dem_size, seed=args.seed + 4,
                        relief_m=args.relief_m)
    dem_path = os.path.join(dem_dir, "demo_dem.tif")
    write_geotiff(dem_path, dem, DEMO_GEOREF.georef(args.dem_size))
    print(f"wrote {dem_path} ({args.dem_size}x{args.dem_size} float32, "
          f"{os.path.getsize(dem_path) / 1e6:.1f} MB)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
