"""Serial bridge: mock-GPS bus messages -> autopilot GPS port bytes.

The port's copy of ``gisnav_tpu/io/serial_bridge.py``: the same
transports and the same bytes (NMEA sentences with CRLF, framed UBX
NAV-PVT). The reference feeds its NMEA/UBX mock-GPS output to the
autopilot through an external socat bridge (``docker/docker-compose*.yaml``
socat services and ``docker/px4/entrypoint.sh`` tcp-listen->pty in
hmakelin/gisnav). This module replaces the middleware-side hop with three
transports:

* **pty** (same-host deployment): open a pseudo-terminal, optionally symlink
  it to a stable path, and write each published fix as wire bytes — point the
  autopilot's serial GPS driver (``GPS_1_CONFIG`` / ``SERIALx_PROTOCOL`` /
  ``GPS_TYPE``) at the link.
* **tcp** (cross-container deployment): connect to a TCP listener on the
  simulation container (a plain ``socat tcp-listen:<port>,reuseaddr,fork
  pty,raw,echo=0,link=...`` on the autopilot side turns the stream back into
  a serial device, exactly the reference's topology with the roles kept:
  bytes originate here, the pty lives next to the autopilot). The connection
  is lazy and self-healing: fixes published while the sim is down are
  dropped (GPS is a lossy realtime feed; stale fixes must never be replayed)
  and the next fix reconnects.
* **device** (HIL deployment): open an existing serial device (the wire to a
  real FCU's GPS port, e.g. ``/dev/ttyUSB0``) in raw mode and write to it.

Usage (CLI)::

    python -m gisnav_tpu_torch serial --protocol nmea --link /tmp/gisnav-gps
    python -m gisnav_tpu_torch serial --protocol nmea --tcp px4:15000
"""
from __future__ import annotations

import os
import socket
import termios
import time
import tty
from typing import Optional

from gisnav_tpu_torch.io.ubx import frame_nav_pvt

__all__ = ["SerialBridge"]


class SerialBridge:
    """Subscribe a mock-GPS topic and write wire bytes to a pty or socket.

    :param bus: the bus the node graph publishes on (LocalBus or ShmBus)
    :param protocol: "nmea" (sentences + CRLF) or "ubx" (framed NAV-PVT)
    :param link: optional stable symlink path for the pty slave (pty mode)
    :param tcp: optional ``host:port`` — connect a TCP stream instead of
        opening a pty (cross-container mode; mutually exclusive with *link*)
    :param device: optional path of an EXISTING serial device to write to
        (HIL mode; mutually exclusive with *link*/*tcp*)
    :param connect_timeout_s: per-attempt TCP connect budget; also the
        reconnect back-off floor so a down simulator can't stall the bus
        callback for longer than one timeout per published fix
    """

    def __init__(self, bus, protocol: str = "nmea",
                 link: Optional[str] = None, tcp: Optional[str] = None,
                 device: Optional[str] = None,
                 connect_timeout_s: float = 1.0):
        if protocol not in ("nmea", "ubx"):
            raise ValueError(f"unsupported serial protocol {protocol!r}")
        if sum(map(bool, (link, tcp, device))) > 1:
            raise ValueError(
                "pass at most one of link= (pty), tcp=, device=")
        from gisnav_tpu_torch.nodes.mock_gps import (
            TOPIC_NAV_PVT,
            TOPIC_NMEA_SENTENCE,
        )

        self.protocol = protocol
        self.link = link
        self.bytes_written = 0
        self._sock: Optional[socket.socket] = None
        self._master = self._slave = -1
        self.slave_path: Optional[str] = None
        if tcp:
            host, _, port = tcp.rpartition(":")
            if not host or not port.isdigit():
                raise ValueError(f"tcp target must be host:port, got {tcp!r}")
            self._tcp_addr = (host, int(port))
            self._connect_timeout_s = float(connect_timeout_s)
            self._next_attempt = 0.0
            self._try_connect()
        elif device:
            self._tcp_addr = None
            # O_NOCTTY: a serial device must never become our controlling
            # terminal; raw mode for byte transparency (real ttys only —
            # a plain file has no terminal attributes to set: termios
            # raises, which the JAX bridge's ``except OSError`` misses)
            self._master = os.open(device, os.O_RDWR | os.O_NOCTTY)
            try:
                tty.setraw(self._master)
            except (OSError, termios.error):
                pass
            self.slave_path = device
        else:
            self._tcp_addr = None
            self._master, self._slave = os.openpty()
            # The bridge must be byte-transparent like the socat hop it
            # replaces (reference docker/nmea/entrypoint.sh): raw mode on
            # BOTH ends, or the slave's canonical line discipline mangles
            # NMEA CRLF (ICRNL) and buffers binary UBX frames until a stray
            # newline arrives.
            tty.setraw(self._master)
            tty.setraw(self._slave)
            self.slave_path = os.ttyname(self._slave)
            if link:
                if os.path.islink(link) or os.path.exists(link):
                    os.unlink(link)
                os.symlink(self.slave_path, link)
        topic = TOPIC_NMEA_SENTENCE if protocol == "nmea" else TOPIC_NAV_PVT
        bus.subscribe(topic, self._on_message)

    @property
    def connected(self) -> bool:
        """TCP mode: whether a live connection is currently held."""
        return self._sock is not None

    def _try_connect(self) -> None:
        now = time.monotonic()
        if now < self._next_attempt:
            return
        self._next_attempt = now + self._connect_timeout_s
        try:
            sock = socket.create_connection(
                self._tcp_addr, timeout=self._connect_timeout_s)
            # fixes are tiny and latency-sensitive: never coalesce
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = sock
        except OSError:
            self._sock = None

    def _on_message(self, msg) -> None:
        if self.protocol == "nmea":
            data = (msg["sentence"] + "\r\n").encode("ascii")
        else:
            data = frame_nav_pvt(msg)
        if self._tcp_addr is not None:
            if self._sock is None:
                self._try_connect()
                if self._sock is None:
                    return  # sim down: drop, never queue stale fixes
            try:
                self._sock.sendall(data)
                self.bytes_written += len(data)
            except OSError:  # peer gone; reconnect on the next fix
                try:
                    self._sock.close()
                finally:
                    self._sock = None
            return
        try:
            os.write(self._master, data)
            self.bytes_written += len(data)
        except OSError:  # reader gone; keep running (fail-soft)
            pass

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None
        if self.link and os.path.islink(self.link):
            os.unlink(self.link)
        if self._master >= 0:
            os.close(self._master)
        if self._slave >= 0:
            os.close(self._slave)
