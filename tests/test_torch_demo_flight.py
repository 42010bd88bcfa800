"""The demo world in use, held against the JAX package on the CPU.

- Serving: the port's ``gis/server.py`` over the port's demo world and DEM
  at ``tests/test_gis_stack.py``'s fixture sizes (``synthetic_world(512,
  seed=3, n_shapes=800)``, ``synthetic_dem(128, base_m=10, relief_m=20)``,
  ``DEMO_GEOREF``), the JAX server over the JAX package's: each GetMap
  raster (PNG) within one grey level of the JAX server's and equal on at
  least 99 % of the pixels, the gate of ``tests/test_torch_gis_server.py``,
  for the imagery and the DEM, on bboxes inside the extent, across its
  edges and beyond it.
- Flying: frames rendered from that 512-px map (``utils/world_wms.py``
  ``GeoWorld``: over the DEM's relief, with the east and north metres of a
  pixel each) at 256x320, 400 m above the DEM, in three rotation buckets;
  the map and DEM each frame's GIS node would fetch (its bbox, the 416-px
  side, the default JPEG) from the port's server. The ``learned_lg9``
  bucketed runner of each package at 512 keypoints, the port's drawing
  its RANSAC samples as the JAX runner does, flies them: every fix of
  both valid and within 10 m of the truth horizontally and vertically, and
  the port's within 2.5 m horizontally and 0.5 m in altitude of the JAX
  fix, or within the JAX runner's own spread over 16 RANSAC draws on that
  frame where it is wider (the runner gates of ``tests/
  test_torch_runners.py``). At this map's 5.6 m pixels (the 512-px world
  at 6.9 m east-west resampled) the 4-point RANSAC moves the fix by metres
  with its draw in both packages.
- The pose node's deep backend takes ``image_shape`` and ``max_keypoints``
  from its parameters (the main path's width set through ``run --params``)
  and keeps the bundle's without them; a frame pairs the raster and the
  affine of one map message when another arrives mid-frame.

``JAX_PLATFORMS=cpu python -m tests.test_torch_demo_flight`` prints the
flight's readings.
"""
import dataclasses
import itertools
import urllib.request

import cv2
import jax
import numpy as np
import pytest
import torch

from gisnav_tpu.gis import server as jserver
from gisnav_tpu.pipeline import geopose as jgp
from gisnav_tpu.pipeline.runners import load_bundled as j_load_bundled
from gisnav_tpu.pipeline.runners import make_bucketed_warp_runner as j_runner
from gisnav_tpu.utils import world as jworld
from gisnav_tpu_torch.geometry.bbox import fov_bounding_box_enu
from gisnav_tpu_torch.geometry.crs import haversine_m, pixel_to_wgs84_affine
from gisnav_tpu_torch.geometry.quaternion import quat_to_matrix
from gisnav_tpu_torch.gis import server as tserver
from gisnav_tpu_torch.gis.png import decode_png
from gisnav_tpu_torch.gis.wms import (
    WMSClient,
    orthoimage_size_for_camera,
    request_orthoimage,
)
from gisnav_tpu_torch.pipeline import geopose as tgp
from gisnav_tpu_torch.pipeline import runners as truns
from gisnav_tpu_torch.utils import world as tworld
from gisnav_tpu_torch.utils.world_wms import (
    GeoWorld,
    camera_attitude_quat,
    east_of,
)
from gisnav_tpu_torch.weights import load_bundled

from tests.test_torch_geometry import jax_ransac_sample

torch.set_num_threads(2)

H, W, K = 256, 320, 512
AGL_M = 400.0
KEYS = 16  # RANSAC draws over which the JAX runner's own spread is taken
# (metres east of the extent's centre, yaw): buckets 1, 2 and 3
STEPS = [(0.0, 20.0), (120.0, 35.0), (-150.0, 50.0)]


def _layers(world_fn, dem_fn, georef):
    img = world_fn(512, seed=3, n_shapes=800)
    dem = dem_fn(128, base_m=10.0, relief_m=20.0)
    return {"imagery": (img, georef(512)), "dem": (dem, georef(128))}


@pytest.fixture(scope="module")
def servers():
    ours = tserver.GisServer(layers=_layers(
        tworld.synthetic_world, tworld.synthetic_dem,
        tworld.DEMO_GEOREF.georef), host="127.0.0.1").start()
    ref = jserver.GisServer(layers=_layers(
        jworld.synthetic_world, jworld.synthetic_dem,
        jworld.DEMO_GEOREF.georef), host="127.0.0.1").start()
    yield ours, ref
    ours.stop()
    ref.stop()


def _bbox(x0, y0, x1, y1):
    """A bbox at fractions of the demo extent (x east, y south)."""
    g = tworld.DEMO_GEOREF
    return (g.left + x0 * g.size_deg, g.top - y1 * g.size_deg,
            g.left + x1 * g.size_deg, g.top - y0 * g.size_deg)


BBOXES = [_bbox(0.2, 0.3, 0.7, 0.6), _bbox(0.4, 0.45, 0.47, 0.5),
          _bbox(-0.2, 0.1, 0.3, 0.5), _bbox(0.6, 0.7, 1.3, 1.2),
          _bbox(1.5, 1.5, 2.0, 2.0)]


@pytest.mark.parametrize("layer", ["imagery", "dem"])
@pytest.mark.parametrize("size", [(256, 256), (416, 416), (300, 500)])
def test_getmap_of_the_demo_world_within_one_level_of_jax(servers, layer,
                                                          size):
    exact = total = 0
    for bbox in BBOXES:
        query = "&".join(f"{k}={v}" for k, v in dict(
            service="WMS", version="1.1.1", request="GetMap", layers=layer,
            styles="", srs="EPSG:4326",
            bbox=",".join(repr(float(v)) for v in bbox), width=size[1],
            height=size[0], format="image/png").items())
        bodies = []
        for srv in servers:
            with urllib.request.urlopen(f"{srv.wms_url}?{query}",
                                        timeout=30) as resp:
                assert resp.status == 200
                assert resp.headers["content-type"] == "image/png"
                bodies.append(resp.read())
        a = decode_png(bodies[0]).astype(int)
        b = cv2.imdecode(np.frombuffer(bodies[1], np.uint8),
                         cv2.IMREAD_UNCHANGED).astype(int)
        assert a.shape == b.shape == size
        assert np.abs(a - b).max() <= 1
        exact += int((a == b).sum())
        total += a.size
    assert exact >= 0.99 * total, exact / total


def _with_jax_draw(config):
    """The port's frame program, drawing RANSAC samples as the JAX runner
    does for its n-th frame."""
    hot = tgp.build_frame_to_geopose_warpcached(config)
    frames = itertools.count(1)

    def fn(*args, sample_idx=None, generator=None):
        key = jax.random.PRNGKey(next(frames))
        return hot(*args, generator=generator,
                   sample_idx=lambda mask, _: jax_ransac_sample(
                       key, mask.cpu().numpy()))

    return fn


def _dist(a, b):
    return (haversine_m(a["lat"], a["lon"], b["lat"], b["lon"]),
            abs(a["alt_ellipsoid"] - b["alt_ellipsoid"]))


@pytest.fixture(scope="module")
def flight(servers):
    ours = servers[0]
    world = GeoWorld(*(x for n in ("imagery", "dem") for x in (
        ours._layers[n].raster, ours._layers[n].georef)))
    client = WMSClient(ours.wms_url)
    f = 400.0 * W / 640.0
    k = np.array([[f, 0.0, W / 2], [0.0, f, H / 2], [0.0, 0.0, 1.0]])
    params, cfg = load_bundled("learned_lg9")
    cfg = dataclasses.replace(cfg, image_shape=(H, W), max_keypoints=K)
    j_params, j_cfg = j_load_bundled("learned_lg9")
    j_cfg = dataclasses.replace(j_cfg, image_shape=(H, W), max_keypoints=K)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(truns, "build_frame_to_geopose_warpcached", _with_jax_draw)
        port = truns.make_bucketed_warp_runner(params, cfg, device="cpu")
    ref, spread_ref = j_runner(j_params, j_cfg), j_runner(j_params, j_cfg)
    lon0, lat0 = (float(v) for v in world.to_lonlat(255.5, 255.5))
    out = []
    for stamp, (east_m, yaw) in enumerate(STEPS):
        lon = east_of(lon0, lat0, east_m)
        alt = float(world.height_at(lon, lat0)) + AGL_M
        frame = world.render_frame(lon, lat0, alt, yaw, k, (H, W))
        bbox = fov_bounding_box_enu(k, W, H, quat_to_matrix(
            camera_attitude_quat(yaw)), AGL_M, lon, lat0)
        side = orthoimage_size_for_camera(W, H)
        ortho, dem = request_orthoimage(
            client, (bbox.left, bbox.bottom, bbox.right, bbox.top), side,
            ["imagery"], dem_layers=["dem"])
        aff = pixel_to_wgs84_affine(*side, bbox.left, bbox.bottom,
                                    bbox.right, bbox.top)
        args = (frame, ortho, dem, yaw, k, aff)
        kw = dict(map_stamp=stamp, altitude_agl=AGL_M)
        p, r = port(*args, **kw), ref(*args, **kw)
        draws = [jgp.geopose_to_wgs84_f64(spread_ref(*args, **kw), aff)
                 for _ in range(KEYS)]
        moves = [_dist(a, b) for a, b in itertools.combinations(draws, 2)]
        out.append({"truth": {"lon": lon, "lat": lat0, "alt_ellipsoid": alt},
                    "port": p, "port_fix": tgp.geopose_to_wgs84_f64(p, aff),
                    "jax": r, "jax_fix": jgp.geopose_to_wgs84_f64(r, aff),
                    "spread": tuple(max(m[i] for m in moves)
                                    for i in (0, 1))})
    return out


def test_both_runners_fix_the_demo_flight_within_10_m(flight):
    for step in flight:
        for side in ("port", "jax"):
            assert bool(step[side].valid), side
            horiz, vert = _dist(step[f"{side}_fix"], step["truth"])
            assert horiz < 10.0 and vert < 10.0, (side, horiz, vert)


def test_port_runner_within_the_runner_gates_of_jax(flight):
    for step in flight:
        horiz, dalt = _dist(step["port_fix"], step["jax_fix"])
        assert abs(int(step["port"].num_matches)
                   - int(step["jax"].num_matches)) <= 5
        assert horiz < max(2.5, step["spread"][0]), (horiz, step["spread"])
        assert dalt < max(0.5, step["spread"][1]), (dalt, step["spread"])


def test_pose_node_takes_the_frame_shape_and_budget_from_its_params():
    from gisnav_tpu_torch.nodes.bus import LocalBus
    from gisnav_tpu_torch.nodes.pose_node import PoseNode

    base = {"backend": "deep", "weights": "learned_lg9",
            "deep_mode": "warp-bucketed"}
    node = PoseNode(LocalBus(), params={**base, "image_shape": [256, 320],
                                        "max_keypoints": 256},
                    device="cpu")
    cfg = node._config
    assert (cfg.image_shape, cfg.max_keypoints) == ((256, 320), 256)
    assert (cfg.lightglue_depth, cfg.detector_mode) == (9, "learned")
    bundled = PoseNode(LocalBus(), params=base, device="cpu")._config
    assert (bundled.image_shape, bundled.max_keypoints) == ((480, 640), 512)


def test_pose_node_pairs_a_frame_with_one_map_message(monkeypatch):
    """On the threaded bus the orthoimage handler may replace the map while
    a frame runs (path 15 on the card: one pose 240 m off, the map shift,
    on a refresh step). The runner gets the raster, DEM, stamp and affine
    of one map message, the one held when the frame began."""
    from gisnav_tpu_torch.geometry.crs import affine_to_proj
    from gisnav_tpu_torch.nodes import pose_node
    from gisnav_tpu_torch.nodes.bus import LocalBus

    seen = []

    class Invalid:
        valid, num_matches = False, 0

    def runner(query, ortho, dem, rotation_deg, k, crs_affine,
               map_stamp=None):
        seen.append((int(ortho[0, 0]), float(dem[0, 0]),
                     float(crs_affine[0, 3]), map_stamp))
        return Invalid()

    def message(n):
        aff = np.eye(4)
        aff[0, 3] = 10.0 * n
        return {"image": np.full((16, 16), n, np.uint8),
                "dem": np.full((16, 16), n, np.float32),
                "crs": affine_to_proj(aff), "stamp_us": n}

    node = pose_node.PoseNode(LocalBus(), params={"image_shape": [8, 8]},
                              deep_runner=runner, device="cpu")
    node._camera_info = {"k": np.eye(3)}
    node._ortho = message(1)
    read_affine = pose_node.proj_to_affine

    def map_arrives(crs):  # the other handler, between affine and call
        out = read_affine(crs)
        node._ortho = message(2)
        return out

    monkeypatch.setattr(pose_node, "proj_to_affine", map_arrives)
    assert node.estimate({"image": np.zeros((8, 8), np.uint8),
                          "stamp_us": 5}) is None
    assert seen == [(1, 1.0, 10.0, 1)]


if __name__ == "__main__":
    # print the readings these tests gate:
    #   JAX_PLATFORMS=cpu python -m tests.test_torch_demo_flight
    srv = servers.__wrapped__()
    for step in flight.__wrapped__(next(srv)):
        rows = {s: _dist(step[f"{s}_fix"], step["truth"])
                for s in ("port", "jax")}
        print(f"truth: port {rows['port'][0]:.3f} / {rows['port'][1]:.3f} m,"
              f" JAX {rows['jax'][0]:.3f} / {rows['jax'][1]:.3f} m; "
              f"port-vs-JAX {_dist(step['port_fix'], step['jax_fix'])}; "
              f"JAX spread {step['spread']}; matches "
              f"{int(step['port'].num_matches)}/"
              f"{int(step['jax'].num_matches)}")
