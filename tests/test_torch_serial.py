"""The port's serial bridge and its cross-process CLI against the JAX
package's.

- The same bus messages through the JAX ``SerialBridge`` and the port's
  give byte-equal output: NMEA sentences with CRLF and framed UBX NAV-PVT,
  on the pty and over TCP; a fix published while the TCP peer is down is
  dropped, and the next one reconnects; the pty's symlink comes and goes
  with the bridge; ``device=`` writes to an existing file.
- The three scenarios of ``tests/test_multiprocess_deploy.py`` on the
  port's CLI: ``python -m gisnav_tpu_torch serial`` bridges NMEA from
  another process's ``ShmBus`` to its pty; ``health`` sees a heartbeat on
  ``/<namespace>/health`` and exits 0, and exits 1 without one. Each
  subprocess has a deadline.
"""
import itertools
import os
import select
import socket
import subprocess
import sys
import threading
import time

import pytest

from gisnav_tpu.io.serial_bridge import SerialBridge as JaxSerialBridge
from gisnav_tpu.io.ubx import make_nav_pvt as jax_make_nav_pvt
from gisnav_tpu.nodes.bus import LocalBus as JaxLocalBus
from gisnav_tpu_torch.io.serial_bridge import SerialBridge
from gisnav_tpu_torch.nodes.bus import LocalBus, ShmBus, _lib, segment_name
from gisnav_tpu_torch.nodes.mock_gps import TOPIC_NAV_PVT, TOPIC_NMEA_SENTENCE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI_DEADLINE_S = 120.0
_ns_counter = itertools.count()
SENTENCES = ["$GPGGA,120000.00,6001.5000,N,02402.4000,E,1,12,0.00,"
             "497.2,M,0.0,M,,*5A", "$GPVTG,45.0,T,,M,10.00,N,18.52,K*4F",
             "$GPHDT,22.5,T*00"]


def _ns(tag):
    return f"ps{tag}{os.getpid()}_{next(_ns_counter)}"


def _pvts():
    return [jax_make_nav_pvt(
        lat=600250000 + 10 * i, lon=240400000 - 7 * i,
        altitude_ellipsoid=500.0 + i, altitude_amsl=480.0 + i,
        yaw_degrees=22.5 + i, h_variance_rad=0.01, vel_n_m_s=1.2,
        vel_e_m_s=-0.3, vel_d_m_s=0.01, cog=0.4, s_variance_m_s=0.5,
        timestamp=1_700_000_000_000_000 + 500_000 * i, eph=2.5, epv=3.0,
        satellites_visible=255) for i in range(3)]


def _messages(protocol):
    if protocol == "nmea":
        return TOPIC_NMEA_SENTENCE, [{"stamp_us": i, "sentence": s}
                                     for i, s in enumerate(SENTENCES)]
    return TOPIC_NAV_PVT, _pvts()


def _read(fd, n, timeout_s=5.0):
    buf = b""
    deadline = time.monotonic() + timeout_s
    while len(buf) < n and time.monotonic() < deadline:
        r, _, _ = select.select([fd], [], [], 0.1)
        if r:
            buf += os.read(fd, 4096)
    return buf


def _through(make_bridge, make_bus, protocol):
    """The bytes one bridge writes to its pty for the messages."""
    bus = make_bus()
    bridge = make_bridge(bus, protocol=protocol)
    try:
        topic, msgs = _messages(protocol)
        for m in msgs:
            bus.publish(topic, m)
        return _read(bridge._slave, bridge.bytes_written)
    finally:
        bridge.close()


@pytest.mark.parametrize("protocol", ["nmea", "ubx"])
def test_pty_bytes_equal_jax(protocol):
    ours = _through(SerialBridge, LocalBus, protocol)
    ref = _through(JaxSerialBridge, JaxLocalBus, protocol)
    assert ours == ref and len(ours) > 0
    if protocol == "nmea":
        assert ours == "".join(s + "\r\n" for s in SENTENCES).encode()
    else:
        assert ours[:2] == b"\xb5\x62" and len(ours) == 3 * 100


def _tcp_bytes(make_bridge, make_bus, protocol):
    srv = socket.create_server(("127.0.0.1", 0))
    srv.settimeout(5.0)
    got = []

    def accept():
        conn, _ = srv.accept()
        conn.settimeout(2.0)
        data = b""
        try:
            while True:
                chunk = conn.recv(65536)
                if not chunk:
                    break
                data += chunk
        except socket.timeout:
            pass
        got.append(data)
        conn.close()

    t = threading.Thread(target=accept)
    t.start()
    bus = make_bus()
    bridge = make_bridge(bus, protocol=protocol,
                         tcp=f"127.0.0.1:{srv.getsockname()[1]}")
    try:
        assert bridge.connected
        topic, msgs = _messages(protocol)
        for m in msgs:
            bus.publish(topic, m)
    finally:
        bridge.close()
        t.join(timeout=10.0)
        srv.close()
    assert not t.is_alive()
    return got[0]


@pytest.mark.parametrize("protocol", ["nmea", "ubx"])
def test_tcp_bytes_equal_jax(protocol):
    ours = _tcp_bytes(SerialBridge, LocalBus, protocol)
    assert ours == _tcp_bytes(JaxSerialBridge, JaxLocalBus, protocol)
    assert len(ours) > 0


def test_tcp_drops_fixes_while_down_then_reconnects():
    probe = socket.create_server(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    bus = LocalBus()
    bridge = SerialBridge(bus, protocol="nmea", tcp=f"127.0.0.1:{port}",
                          connect_timeout_s=0.1)
    srv = None
    try:
        assert not bridge.connected
        bus.publish(TOPIC_NMEA_SENTENCE, {"stamp_us": 1,
                                          "sentence": "$GPGGA,lost*00"})
        assert bridge.bytes_written == 0
        srv = socket.create_server(("127.0.0.1", port))
        srv.settimeout(5.0)
        got = []

        def accept():
            conn, _ = srv.accept()
            conn.settimeout(5.0)
            got.append(conn.recv(64))
            conn.close()

        t = threading.Thread(target=accept)
        t.start()
        time.sleep(0.15)  # past the back-off floor
        bus.publish(TOPIC_NMEA_SENTENCE, {"stamp_us": 2,
                                          "sentence": "$GPGGA,back*00"})
        if not bridge.connected:  # the first fix may only re-arm the dial
            time.sleep(0.15)
            bus.publish(TOPIC_NMEA_SENTENCE, {"stamp_us": 3,
                                              "sentence": "$GPGGA,back*00"})
        t.join(timeout=5.0)
        assert not t.is_alive()
        assert got and got[0].endswith(b"$GPGGA,back*00\r\n")
    finally:
        bridge.close()
        if srv is not None:
            srv.close()


def test_symlink_lifecycle_and_device_mode(tmp_path):
    link = str(tmp_path / "gps")
    bridge = SerialBridge(LocalBus(), protocol="nmea", link=link)
    assert os.path.islink(link)
    assert os.readlink(link) == bridge.slave_path
    bridge.close()
    assert not os.path.exists(link)
    dev = tmp_path / "ttyFAKE"
    dev.write_bytes(b"")
    bus = LocalBus()
    bridge = SerialBridge(bus, protocol="nmea", device=str(dev))
    bus.publish(TOPIC_NMEA_SENTENCE, {"stamp_us": 1,
                                      "sentence": SENTENCES[0]})
    bridge.close()
    assert dev.read_bytes() == (SENTENCES[0] + "\r\n").encode()
    with pytest.raises(ValueError):
        SerialBridge(LocalBus(), protocol="uorb")
    with pytest.raises(ValueError):
        SerialBridge(LocalBus(), link=link, tcp="127.0.0.1:1")


def _cli(*args):
    return [sys.executable, "-m", "gisnav_tpu_torch", *args]


def _env():
    return {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def test_serial_cli_bridges_nmea_across_processes(tmp_path):
    """``serial`` in its own process bridges what this process publishes on
    the shared-memory bus to the pty it creates."""
    ns, link = _ns("ser"), str(tmp_path / "gps")
    proc = subprocess.Popen(_cli("serial", "--protocol", "nmea", "--link",
                                 link, "--namespace", ns),
                            stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True, cwd=ROOT,
                            env=_env())
    bus = None
    try:
        r, _, _ = select.select([proc.stdout], [], [], CLI_DEADLINE_S)
        assert r, "serial did not come up"
        line = proc.stdout.readline()
        assert "serial bridge up" in line, line
        assert os.path.islink(link)
        bus = ShmBus(namespace=ns)
        fd = os.open(os.path.realpath(link), os.O_RDONLY | os.O_NONBLOCK)
        try:
            data, deadline = b"", time.monotonic() + 30.0
            while time.monotonic() < deadline and b"\r\n" not in data:
                bus.publish(TOPIC_NMEA_SENTENCE,
                            {"stamp_us": 1, "sentence": "$GPGGA,xproc*00"})
                r, _, _ = select.select([fd], [], [], 0.25)
                if r:
                    data += os.read(fd, 4096)
            assert b"$GPGGA,xproc*00\r\n" in data, data
        finally:
            os.close(fd)
    finally:
        proc.terminate()
        proc.communicate(timeout=30)
        if bus is not None:
            bus.close(unlink=True)


def test_health_cli_sees_heartbeat():
    """``health`` (another process) hears the heartbeat this process
    publishes on ``/<namespace>/health`` and exits 0."""
    ns = _ns("hb")
    bus = ShmBus(namespace=ns)
    stop = threading.Event()

    def beat():
        while not stop.is_set():
            bus.publish(f"/{ns}/health",
                        {"pose_node": {"idle_s": 0.1, "healthy": True},
                         "wfst_node": {"idle_s": 30.0, "healthy": True}})
            stop.wait(0.5)

    t = threading.Thread(target=beat, daemon=True)
    t.start()
    try:
        proc = subprocess.run(_cli("health", "--namespace", ns, "--timeout",
                                   "20", "--strict"),
                              capture_output=True, text=True, cwd=ROOT,
                              env=_env(), timeout=CLI_DEADLINE_S)
    finally:
        stop.set()
        t.join(timeout=5.0)
        bus.close(unlink=True)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert "healthy (2 nodes)" in proc.stdout


def test_health_cli_fails_without_heartbeat():
    ns = _ns("none")
    proc = subprocess.run(_cli("health", "--namespace", ns, "--timeout",
                               "2"),
                          capture_output=True, text=True, cwd=ROOT,
                          env=_env(), timeout=CLI_DEADLINE_S)
    _lib().shmbus_unlink(segment_name(ns, f"/{ns}/health"))
    assert proc.returncode == 1
    assert "UNHEALTHY" in proc.stdout
