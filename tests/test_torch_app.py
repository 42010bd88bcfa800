"""The port's node graph (``GisNavApp``) and its ``run`` wiring, on the CPU.

- ``cli.build_app`` as ``tests/test_cli_run.py`` drives the JAX one: the
  backend picks the runner, bundled names and ``.npz`` paths work, the
  protocol picks the mock-GPS node, a params file survives, the bus is the
  threaded one; without a card it raises unless ``--device cpu``; a
  missing bundle raises (no classical fallback).
- A short flight through the port's ``GisNavApp`` and the JAX one on the
  same frames: ``backend=classical``, 480x640 at f = 400 px, 500 m over a
  flat seeded world served as PNG by the loopback stub WMS, 6 steps of
  10 m every 500 ms (20 m/s), the fusion timer driven at 5 Hz stamps.
  Every uORB fix is within 10 m of the truth (interpolated to its stamp)
  horizontally and vertically, both graphs publish fixes at the same
  stamps, and the port's fix is within 1 m of the JAX fix at each.
"""
import argparse
import json

import numpy as np
import pytest
import torch

from gisnav_tpu.gis import WMSClient as JaxWMSClient
from gisnav_tpu.nodes import GisNavApp as JaxGisNavApp
from gisnav_tpu_torch import weights
from gisnav_tpu_torch.cli import build_app, build_parser
from gisnav_tpu_torch.geometry.crs import haversine_m
from gisnav_tpu_torch.gis.wms import WMSClient
from gisnav_tpu_torch.nodes.app import GisNavApp
from gisnav_tpu_torch.nodes.mock_gps import TOPIC_SENSOR_GPS, NMEANode
from gisnav_tpu_torch.utils.world_wms import (
    World,
    WorldWMS,
    camera_attitude_quat,
    east_of,
)

torch.set_num_threads(2)

K = np.array([[400.0, 0, 320.0], [0, 400.0, 240.0], [0, 0, 1.0]])
# 10 m every 500 ms: the 20 m/s of tests/test_integration.py
ALT_M, YAW_DEG, STEP_M, STEPS = 500.0, 15.0, 10.0, 6


def _args(**over):
    base = dict(protocol="uorb", params=None, namespace="gisnav",
                gis_rate=1.0, backend="deep", weights="harris_lg5",
                deep_mode="cached", device="cpu")
    base.update(over)
    return argparse.Namespace(**base)


class TestBuildApp:
    def test_parser_defaults_are_the_production_graph(self):
        args = build_parser().parse_args(["run"])
        assert (args.backend, args.weights, args.deep_mode, args.protocol,
                args.device) == ("deep", "learned_lg9", "warp-bucketed",
                                 "uorb", "cuda")

    def test_runs_on_cuda_unless_asked(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            build_app(_args(backend="classical", device="cuda"))

    def test_deep_backend_attaches_runner(self):
        app = build_app(_args())
        assert app.pose._deep_runner is not None
        assert app.pose._config.detector_mode == "harris"
        assert app.pose._runner_takes_prior  # the cached runner
        assert app.bus._async

    def test_learned_lg9_bucketed(self):
        app = build_app(_args(weights="learned_lg9",
                              deep_mode="warp-bucketed"))
        cfg = app.pose._config
        assert (cfg.lightglue_depth, cfg.detector_mode, cfg.image_shape,
                cfg.max_keypoints) == (9, "learned", (480, 640), 512)
        assert app.pose._runner_takes_map_stamp
        assert not app.pose._runner_takes_prior

    def test_classical_and_semidense(self):
        assert build_app(_args(backend="classical")).pose._deep_runner is None
        assert build_app(_args(backend="semidense")).pose._deep_runner \
            is not None

    def test_npz_path_weights(self):
        app = build_app(_args(weights=weights.PRETRAINED_PATH,
                              deep_mode="warp"))
        assert app.pose._deep_runner is not None
        assert app.pose.param("weights") == weights.PRETRAINED_PATH

    def test_missing_bundle_raises(self, monkeypatch, tmp_path):
        monkeypatch.setattr(weights, "PRETRAINED_PATH",
                            str(tmp_path / "missing.npz"))
        with pytest.raises(FileNotFoundError):
            build_app(_args())

    def test_params_file_overrides_survive(self, tmp_path):
        p = tmp_path / "params.json"
        p.write_text(json.dumps({
            "pose_node": {"min_matches": 21},
            "gis_node": {"wms_url": "http://127.0.0.1:9/wms"},
        }))
        app = build_app(_args(params=str(p), backend="classical"))
        assert app.pose.param("min_matches") == 21
        assert app.pose.param("backend") == "classical"
        assert app.gis.wms.url == "http://127.0.0.1:9/wms"

    def test_protocol_selects_extension_node(self):
        app = build_app(_args(protocol="nmea", backend="classical"))
        assert isinstance(app.mock_gps, NMEANode)

    def test_not_ported_options_raise(self):
        with pytest.raises(NotImplementedError):
            GisNavApp(wfst=True, device="cpu")
        with pytest.raises(NotImplementedError):
            GisNavApp(params={"pose_node": {"dev_topics": True}},
                      device="cpu")


@pytest.fixture(scope="module")
def world_wms():
    world = World.make(seed=7, size_px=2048, gsd_m=1.36)
    with WorldWMS(world) as wms:
        yield world, wms


def _fly(app, world):
    """Fly the track through ``app`` (the inputs of each step in the order
    of ``tests/test_envelope.py``, then the fusion timer at +200 and +400
    ms); returns (fixes, truth(stamp) -> (lon, lat, alt))."""
    lon0, lat0 = world.to_lonlat(1024 - 3 * STEP_M / world.gsd_m, 1024)
    fixes = []
    app.bus.subscribe(TOPIC_SENSOR_GPS, fixes.append)
    app.bus.publish("/camera/camera_info",
                    {"k": K, "width": 640, "height": 480})
    for i in range(STEPS):
        stamp = 1_500_000 + 500_000 * i
        lon = east_of(lon0, lat0, STEP_M * i)
        app.bus.publish("/mavros/global_position/global",
                        {"stamp_us": stamp, "lat": lat0, "lon": lon,
                         "alt_ellipsoid": ALT_M})
        app.bus.publish("/mavros/gimbal_control/device/attitude_status",
                        {"stamp_us": stamp,
                         "quat_xyzw": camera_attitude_quat(YAW_DEG)})
        app.gis.tick()
        app.bus.publish("/camera/image_raw", {
            "stamp_us": stamp, "frame_id": "camera_optical",
            "image": world.render_frame(lon, lat0, ALT_M, YAW_DEG, K)})
        for dt in (200_000, 400_000):
            app.fusion.tick(stamp + dt)
    app.shutdown()

    def truth(stamp):
        east = STEP_M * (stamp - 1_500_000) / 500_000
        return east_of(lon0, lat0, east), lat0, ALT_M

    return fixes, truth


def test_classical_flight_matches_jax_graph(world_wms):
    world, wms = world_wms
    params = {
        "gis_node": {"wms_layers": ["imagery"], "wms_dem_layers": ["dem"],
                     "wms_format": "image/png"},
        "twist_node": {"ground_altitude_m": 0.0},
        "bbox_node": {"ground_altitude_m": 0.0},
        "pose_node": {"ground_altitude_m": 0.0},
    }
    ours, truth = _fly(GisNavApp(params=params, wms_client=WMSClient(
        wms.url), device="cpu"), world)
    ref, _ = _fly(JaxGisNavApp(params=params, wms_client=JaxWMSClient(
        wms.url)), world)
    assert len(ours) >= 4
    assert [f["timestamp_sample"] for f in ours] == \
        [f["timestamp_sample"] for f in ref]
    for got, want in zip(ours, ref):
        lon, lat, alt = truth(got["timestamp_sample"])
        horiz = haversine_m(lat, lon, got["lat"] / 1e7, got["lon"] / 1e7)
        vert = abs(got["alt_ellipsoid"] / 1e3 - alt)
        assert horiz < 10.0 and vert < 10.0, (horiz, vert, got)
        apart = haversine_m(want["lat"] / 1e7, want["lon"] / 1e7,
                            got["lat"] / 1e7, got["lon"] / 1e7)
        dz = abs(got["alt_ellipsoid"] - want["alt_ellipsoid"]) / 1e3
        assert apart < 1.0 and dz < 1.0, (apart, dz, got, want)
        assert got["satellites_used"] == 255
