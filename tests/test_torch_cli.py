"""The port's CLI beyond ``run`` and ``train`` (``tests/test_torch_app.py``,
``test_torch_train_loop.py``), against the JAX CLI where both have a
command, on the CPU.

- ``--help`` lists every command of the JAX CLI; each command takes the
  JAX command's flags (the port adds ``--device`` to ``replay`` and
  ``bench``).
- ``build_app``: ``--shm`` builds the graph on a ``ShmBus`` in
  ``--namespace``, ``--wfst`` adds the sink, ``--serial-tcp`` a TCP
  ``SerialBridge`` for nmea / ubx only, ``--ros`` without rclpy warns and
  carries on; ``run`` on Ctrl-C closes them, prints the stats, returns 0.
- ``fleet --dry-run`` prints the JAX CLI's lines.
- ``doctor`` exits 1 where no CUDA device answers, and says so.
- ``gis-serve`` exits 2 for a missing or empty maps directory.
- ``replay`` exits 0 when every frame passes 10 m and writes the report.
- The training entry points resolve their device like every other: without
  a device they raise where CUDA is absent.
"""
import argparse
import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from gisnav_tpu.cli import build_parser as jax_parser
from gisnav_tpu.cli import main as jax_main
from gisnav_tpu_torch import cli
from gisnav_tpu_torch.nodes.bus import LocalBus, ShmBus

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _options(parser):
    """{command: {option strings}} of an argparse parser."""
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {name: {o for a in p._actions for o in a.option_strings}
            | {a.dest for a in p._actions if not a.option_strings}
            for name, p in sub.choices.items()}


def test_commands_and_flags_cover_the_jax_cli():
    ours, ref = _options(cli.build_parser()), _options(jax_parser())
    assert set(ours) == set(ref)
    for command, flags in ref.items():
        assert flags <= ours[command], (command, flags - ours[command])
    assert ours["run"] - ref["run"] == {"--device"}
    assert ours["replay"] - ref["replay"] == {"--device"}
    assert ours["bench"] - ref["bench"] == {"--device"}
    out = subprocess.run([sys.executable, "-m", "gisnav_tpu_torch",
                          "--help"], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0
    for command in ("run", "train", "replay", "health", "doctor", "serial",
                    "gis-serve", "fleet", "bench"):
        assert command in out.stdout


def _args(*argv):
    return cli.build_parser().parse_args(["run", "--backend", "classical",
                                          "--device", "cpu", *argv])


def test_build_app_shm_wfst_and_health_topic():
    ns = f"cli{os.getpid()}"
    app = cli.build_app(_args("--shm", "--wfst", "--namespace", ns))
    try:
        assert isinstance(app.bus, ShmBus)
        assert app.wfst is not None and app.wfst in app.nodes
        assert app.health_topic == f"/{ns}/health"
        assert app.ros_adapter is None and app.serial_bridge is None
    finally:
        app.shutdown()
        app.bus.close(unlink=True)


@pytest.mark.parametrize("protocol", ["nmea", "ubx", "uorb"])
def test_build_app_serial_tcp(protocol):
    srv = socket.create_server(("127.0.0.1", 0))
    try:
        app = cli.build_app(_args(
            "--protocol", protocol,
            "--serial-tcp", f"127.0.0.1:{srv.getsockname()[1]}"))
        bridge = app.serial_bridge
        try:
            if protocol == "uorb":  # uorb rides the DDS agent
                assert bridge is None
            else:
                assert bridge.connected and bridge.protocol == protocol
            assert isinstance(app.bus, LocalBus) and app.bus._async
        finally:
            if bridge is not None:
                bridge.close()
            app.shutdown()
    finally:
        srv.close()


def test_build_app_ros_without_rclpy_warns(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "rclpy", None)
    app = cli.build_app(_args("--ros"))
    try:
        assert app.ros_adapter is None
        assert "rclpy is not importable" in capsys.readouterr().err
    finally:
        app.shutdown()


def test_run_closes_everything_on_ctrl_c(monkeypatch, capsys):
    """``run --shm --serial-tcp``: Ctrl-C closes the bridge and the bus,
    prints every node's stats and returns 0."""
    ns = f"clirun{os.getpid()}"
    srv = socket.create_server(("127.0.0.1", 0))
    closed = []

    def interrupt(_):
        raise KeyboardInterrupt

    monkeypatch.setattr(cli.time, "sleep", interrupt)
    real_build = cli.build_app
    apps = []

    def build(args):
        app = real_build(args)
        apps.append(app)
        for obj in (app.serial_bridge, app.bus):
            close = obj.close
            monkeypatch.setattr(obj, "close", lambda *a, close=close, o=obj,
                                **k: (closed.append(type(o).__name__),
                                      close(*a, **k)))
        return app

    monkeypatch.setattr(cli, "build_app", build)
    try:
        rc = cli.main(["run", "--backend", "classical", "--device", "cpu",
                       "--protocol", "nmea", "--shm", "--namespace", ns,
                       "--serial-tcp", f"127.0.0.1:{srv.getsockname()[1]}"])
    finally:
        srv.close()
        for app in apps:
            app.bus.close(unlink=True)
    out = capsys.readouterr().out
    assert rc == 0
    assert "transport=shm" in out and "ros=off" in out
    assert set(closed) == {"SerialBridge", "ShmBus"}
    stats = json.loads(out[out.index("{"):])
    assert {"pose_node", "nmea_node", "fusion_node"} <= set(stats)


@pytest.mark.parametrize("argv", [
    ["up", "gisnav"], ["--host", "gis@10.0.0.2", "up", "mapserver"],
    ["up", "gisnav", "--extra=-d"], ["--host", "a@h1", "--host", "b@h2",
                                     "ps"],
    ["down", "mapserver@gis", "postgres@gis", "gisnav"],
    ["--remote-path", "/srv/gis nav", "--host", "h", "logs", "x@h"]])
def test_fleet_dry_run_equals_jax(argv, capsys):
    assert cli.main(["fleet", "--dry-run", *argv]) == 0
    ours = capsys.readouterr().out
    assert jax_main(["fleet", "--dry-run", *argv]) == 0
    assert ours == capsys.readouterr().out and ours


def test_doctor_exits_1_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device answers here")
    out = subprocess.run([sys.executable, "-m", "gisnav_tpu_torch", "doctor",
                          "--device-timeout", "90"],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=240)
    assert out.returncode == 1, out.stdout
    assert "[FAIL] no CUDA device answers" in out.stdout
    assert "[ok] native shm bus" in out.stdout
    assert "[ok] PNG codec" in out.stdout
    assert "[ok] JPEG codec" in out.stdout


def test_gis_serve_refuses_missing_maps(tmp_path, capsys):
    assert cli.main(["gis-serve", "--maps", str(tmp_path / "nope")]) == 2
    assert cli.main(["gis-serve", "--maps", str(tmp_path)]) == 2
    assert "no GeoTIFFs" in capsys.readouterr().err


def test_replay_cli_on_cpu(tmp_path, capsys):
    from gisnav_tpu_torch.utils.world_wms import World, write_replay_dataset

    write_replay_dataset(World.make(seed=7, size_px=3072, gsd_m=1.36),
                         str(tmp_path / "ds"), frames=2)
    out = tmp_path / "r.json"
    rc = cli.main(["replay", str(tmp_path / "ds"), "--weights", "harris_lg5",
                   "--device", "cpu", "--out", str(out)])
    printed = capsys.readouterr().out
    assert rc == 0
    assert "[2/2]" in printed
    report = json.loads(out.read_text())
    assert report["summary"]["pass_10m"] == report["summary"]["frames"] == 2
    assert len(report["frames"]) == 2


def test_train_state_needs_the_card_unless_asked(monkeypatch):
    from gisnav_tpu_torch.train.loftr_steps import (
        LoFTRTrainConfig,
        init_loftr_train_state,
    )
    from gisnav_tpu_torch.train.steps import TrainConfig, init_train_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    small = TrainConfig(image_shape=(32, 48), max_keypoints=16,
                        lightglue_depth=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_train_state(gen, small)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_loftr_train_state(gen, LoFTRTrainConfig(depth=1))
    state, _ = init_train_state(gen, small, device="cpu")
    leaf = next(iter(state.params["superpoint"].values()))
    leaf = next(iter(leaf.values())) if isinstance(leaf, dict) else leaf
    assert leaf.device.type == "cpu"
