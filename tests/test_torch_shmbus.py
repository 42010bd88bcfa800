"""The port's shared-memory bus (``gisnav_tpu_torch/nodes/bus.py`` ``ShmBus``
over its own ``native/shmbus.cpp``) against the JAX package's.

- In-process pub/sub: a numpy payload round trip, delivery between two
  handles of one namespace, an oversize message refused, a ``torch`` object
  refused before it reaches ``pickle``.
- The scenarios of ``tests/test_shmbus_multiprocess.py`` on the port's
  library: a child's checksummed stream read in order and uncorrupted;
  4 processes racing to create a segment, one writer winning; a dead
  writer's lock taken over.
- The wire: segment names are the JAX package's, and a builtins ``dict``
  published by the JAX ``ShmBus`` is read by the port's and vice versa (the
  JAX library is compiled from its source into a temporary directory; the
  tracked ``gisnav_tpu/native/libshmbus.so`` is neither built nor loaded).
- No message of a classical ``GisNavApp`` flight on the CPU holds a
  ``torch`` object, so every one of them can cross the bus.

Every namespace is unique to its test (pid and a counter) and its segments
are unlinked; every process and wait has a deadline.
"""
import ctypes
import itertools
import multiprocessing as mp
import os
import pickle
import subprocess
import time

import numpy as np
import pytest
import torch

import gisnav_tpu.nodes.bus as jbus
from gisnav_tpu_torch import native
from gisnav_tpu_torch.nodes import bus as tbus
from gisnav_tpu_torch.nodes.bus import ShmBus, segment_name

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ns_counter = itertools.count()
FORK = mp.get_context("fork")


def _ns(tag: str) -> str:
    return f"pt{tag}{os.getpid()}_{next(_ns_counter)}"


def _wait(pred, timeout_s: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


class TestInProcess:
    def test_roundtrip_numpy_payload(self):
        bus = ShmBus(namespace=_ns("rt"), slot_size=1 << 20)
        try:
            got = []
            bus.subscribe("/t", got.append)
            img = np.arange(480 * 640, dtype=np.uint8).reshape(480, 640)
            bus.publish("/t", {"stamp_us": 7, "image": img, "k": np.eye(3)})
            assert _wait(lambda: got)
            assert got[0]["stamp_us"] == 7
            np.testing.assert_array_equal(got[0]["image"], img)
            np.testing.assert_array_equal(got[0]["k"], np.eye(3))
        finally:
            bus.close(unlink=True)

    def test_cross_handle_delivery_and_order(self):
        ns = _ns("xh")
        a, b = ShmBus(namespace=ns), ShmBus(namespace=ns)
        try:
            got = []
            b.subscribe("/t", got.append)
            for i in range(5):
                a.publish("/t", {"i": i})
            assert _wait(lambda: len(got) == 5)
            assert [m["i"] for m in got] == list(range(5))
        finally:
            b.close()
            a.close(unlink=True)

    def test_oversize_message_raises(self):
        bus = ShmBus(namespace=_ns("big"), slot_size=1024)
        try:
            with pytest.raises(ValueError, match="slot size"):
                bus.publish("/t", np.zeros(4096, np.uint8))
        finally:
            bus.close(unlink=True)

    @pytest.mark.parametrize("payload", [
        torch.zeros(3), {"pose": torch.eye(3)}, [np.zeros(2), torch.ones(1)],
        {"nested": {"t": torch.nn.Parameter(torch.zeros(2))}}])
    def test_torch_objects_are_refused(self, payload):
        bus = ShmBus(namespace=_ns("tt"), slot_size=1 << 16)
        try:
            with pytest.raises(TypeError, match="cannot cross"):
                bus.publish("/t", payload)
        finally:
            bus.close(unlink=True)

    def test_segment_names_are_the_jax_packages(self):
        for ns, topic in (("gisnav", "/gisnav/health"),
                          ("x", "/fmu/in/sensor_gps")):
            assert segment_name(ns, topic) == jbus._segment_name(ns, topic)

    def test_library_is_built_under_the_port(self):
        path = native.build_native_lib("shmbus")
        assert os.path.dirname(path) == native.NATIVE_BUILD_DIR
        assert os.path.basename(path).startswith("libshmbus_")
        assert not path.startswith(os.path.join(ROOT, "gisnav_tpu") + os.sep)
        assert native.build_native_lib("shmbus") == path


def _writer(ns: str, n: int) -> None:
    bus = ShmBus(namespace=ns, slot_size=1 << 16)
    for i in range(n):
        bus.publish("/s", {"i": i, "arr": np.full(512, i, np.int64)})
        time.sleep(0.001)
    bus.close()


def _racer(ns, results, idx, n_msgs, barrier):
    lib = tbus._lib()
    h = lib.shmbus_create(segment_name(ns, "/race"), 8, 4096)
    assert h
    barrier.wait(timeout=30)  # everyone mapped before anyone publishes
    ok = 0
    for _ in range(n_msgs):
        payload = bytes([idx]) * 100
        if lib.shmbus_publish(h, payload, len(payload)) != 0:
            ok += 1
    barrier.wait(timeout=30)  # stay alive until every racer is done
    lib.shmbus_close(h)
    results.put((idx, ok))


def _hold_and_exit(name: bytes) -> None:
    lib = tbus._lib()
    h = lib.shmbus_create(name, 8, 1024)
    assert lib.shmbus_publish(h, b"x" * 8, 8) != 0
    os._exit(0)  # die without releasing the write lock


class TestMultiProcess:
    def test_cross_process_stream_integrity(self):
        """A child streams 300 checksummed messages; the parent reads an
        in-order, uncorrupted suffix ending at the last one."""
        ns = _ns("st")
        tbus._lib()  # built before the fork
        got = []
        reader = ShmBus(namespace=ns, slot_size=1 << 16)
        try:
            reader.subscribe("/s", got.append)
            p = FORK.Process(target=_writer, args=(ns, 300))
            p.start()
            p.join(timeout=60)
            assert p.exitcode == 0
            assert _wait(lambda: got and got[-1]["i"] == 299, 5.0)
        finally:
            reader.close(unlink=True)
        seqs = [m["i"] for m in got]
        assert seqs == sorted(seqs) and seqs[-1] == 299
        assert all((m["arr"] == m["i"]).all() for m in got)

    def test_concurrent_create_single_writer(self):
        """4 processes race to create and publish: the segment is set up
        once and one process wins the write lock."""
        ns = _ns("race")
        lib = tbus._lib()
        results, barrier = FORK.Queue(), FORK.Barrier(4)
        procs = [FORK.Process(target=_racer,
                              args=(ns, results, i, 50, barrier))
                 for i in range(4)]
        for p in procs:
            p.start()
        counts = dict(results.get(timeout=60) for _ in range(4))
        for p in procs:
            p.join(timeout=30)
            assert p.exitcode == 0
        winners = [i for i, ok in counts.items() if ok > 0]
        assert len(winners) == 1 and counts[winners[0]] == 50, counts
        name = segment_name(ns, "/race")
        h = lib.shmbus_open(name)
        assert h
        try:
            assert lib.shmbus_head(h) == 50
            buf, stamp = (ctypes.c_uint8 * 4096)(), ctypes.c_uint64()
            for seq in range(42, 50):  # the ring keeps the last 8
                n = lib.shmbus_read(h, seq, buf, 4096, ctypes.byref(stamp))
                assert n == 100
                assert bytes(buf[:100]) == bytes([winners[0]]) * 100
        finally:
            lib.shmbus_close(h)
            lib.shmbus_unlink(name)

    def test_dead_writer_takeover(self):
        name = segment_name(_ns("dead"), "/t")
        lib = tbus._lib()
        p = FORK.Process(target=_hold_and_exit, args=(name,))
        p.start()
        p.join(timeout=30)
        assert p.exitcode == 0
        h = lib.shmbus_create(name, 8, 1024)
        try:
            assert lib.shmbus_publish(h, b"y" * 8, 8) != 0  # taken over
        finally:
            lib.shmbus_close(h)
            lib.shmbus_unlink(name)


@pytest.fixture
def jax_shm_lib(tmp_path, monkeypatch):
    """The JAX package's ``ShmBus`` on a library compiled from its own
    source into ``tmp_path`` with its Makefile's flags."""
    src = os.path.join(ROOT, "gisnav_tpu", "native", "shmbus.cpp")
    lib = str(tmp_path / "libshmbus_jax.so")
    subprocess.run(["g++", "-O2", "-fPIC", "-std=c++17", src, "-o", lib,
                    "-shared", "-lrt"], check=True, capture_output=True,
                   timeout=120)
    monkeypatch.setattr(jbus, "build_native_lib", lambda *a, **k: lib)
    monkeypatch.setattr(jbus._NativeLib, "_instance", None)
    yield lib


class TestInterop:
    MESSAGE = {"stamp_us": 1_500_000, "sentence": "$GPGGA,interop*00",
               "healthy": True, "idle_s": 0.5, "nodes": ["a", "b"],
               "nested": {"lat": 600200000, "t": (1, 2.5)}}

    def test_jax_publishes_port_reads(self, jax_shm_lib):
        ns = _ns("j2p")
        port, jax_side = ShmBus(namespace=ns), jbus.ShmBus(namespace=ns)
        try:
            got = []
            port.subscribe("/gisnav/health", got.append)
            time.sleep(0.05)
            jax_side.publish("/gisnav/health", self.MESSAGE)
            assert _wait(lambda: got)
            assert got == [self.MESSAGE]
        finally:
            port.close()
            jax_side.close(unlink=True)

    def test_port_publishes_jax_reads(self, jax_shm_lib):
        ns = _ns("p2j")
        port, jax_side = ShmBus(namespace=ns), jbus.ShmBus(namespace=ns)
        try:
            got = []
            jax_side.subscribe("/fmu/in/sensor_gps", got.append)
            time.sleep(0.05)  # the JAX reader starts from the head it reads
            port.publish("/fmu/in/sensor_gps", self.MESSAGE)
            assert _wait(lambda: got)
            assert got == [self.MESSAGE]
        finally:
            jax_side.close()
            port.close(unlink=True)


def test_classical_flight_messages_hold_no_torch_object():
    """Every message of a 4-step classical ``GisNavApp`` flight on the CPU
    (the loopback stub WMS over a seeded world) pickles without a
    ``torch`` object, so the flight could run over the shared-memory
    bus; the flight reaches the mock-GPS output."""
    from gisnav_tpu_torch.nodes.app import GisNavApp
    from gisnav_tpu_torch.nodes.bus import LocalBus
    from gisnav_tpu_torch.nodes.mock_gps import TOPIC_SENSOR_GPS
    from gisnav_tpu_torch.utils.world_wms import (
        World,
        WorldWMS,
        camera_attitude_quat,
        east_of,
    )

    class CheckingBus(LocalBus):
        def __init__(self):
            super().__init__()
            self.topics = {}

        def publish(self, topic, message):
            self.topics[topic] = self.topics.get(topic, 0) + 1
            tbus._dumps(message)  # raises TypeError on a torch object
            pickle.loads(tbus._dumps(message))
            super().publish(topic, message)

    k = np.array([[400.0, 0, 320.0], [0, 400.0, 240.0], [0, 0, 1.0]])
    world = World.make(seed=7, size_px=2048, gsd_m=1.36)
    with WorldWMS(world) as wms:
        bus = CheckingBus()
        ground = {"ground_altitude_m": 0.0}
        app = GisNavApp(bus=bus, device="cpu", params={
            "gis_node": {"wms_url": wms.url, "wms_layers": ["imagery"],
                         "wms_dem_layers": ["dem"],
                         "wms_format": "image/png"},
            "pose_node": {"backend": "classical", **ground},
            "twist_node": dict(ground), "bbox_node": dict(ground)})
        fixes = []
        bus.subscribe(TOPIC_SENSOR_GPS, fixes.append)
        bus.publish("/camera/camera_info", {"k": k, "width": 640,
                                            "height": 480})
        lon0, lat0 = world.to_lonlat(1024, 1024)
        for i in range(4):
            stamp = 1_500_000 + 500_000 * i
            lon = east_of(lon0, lat0, 10.0 * i)
            bus.publish("/mavros/global_position/global",
                        {"stamp_us": stamp, "lat": lat0, "lon": lon,
                         "alt_ellipsoid": 500.0})
            bus.publish("/mavros/gimbal_control/device/attitude_status",
                        {"stamp_us": stamp,
                         "quat_xyzw": camera_attitude_quat(15.0)})
            app.gis.tick()
            bus.publish("/camera/image_raw", {
                "stamp_us": stamp, "frame_id": "camera_optical",
                "image": world.render_frame(lon, lat0, 500.0, 15.0, k)})
            for dt in (100_000, 200_000, 300_000, 400_000):
                app.fusion.tick(stamp + dt)  # past the mock GPS's warm-up
        bus.publish(app.health_topic, app.health())
        app.shutdown()
    assert fixes, "the flight produced no SensorGps fix"
    assert {TOPIC_SENSOR_GPS, "/gisnav/pose_node/pose",
            "/gisnav/gis_node/orthoimage"} <= set(bus.topics)
