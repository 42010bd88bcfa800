"""Application wiring: construct and connect the full node graph.

Counterpart of ``gisnav_tpu/nodes/app.py`` (the launch-file equivalent of
the reference, ``launch/base.launch.py`` / ``local.launch.py`` in
hmakelin/gisnav): the bbox, GIS, pose and twist nodes, the fusion node and
the protocol-selected mock-GPS node over one bus and one transform graph,
the VO odom frame bootstrapped from the first global fix. Timers (GIS
publish, fusion output, health) run from ``spin``, or the caller drives
them (``gis.tick()``, ``fusion.tick(stamp)``).

The pose, twist and fusion nodes run on the card unless ``device="cpu"``.
``wfst=True`` adds the WFS-T telemetry sink, which ``health`` never
reports stale (a sink may be idle), as in the JAX app.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, Optional

import numpy as np

from gisnav_tpu_torch.constants import ROS_NAMESPACE
from gisnav_tpu_torch.geometry.quaternion import quat_to_matrix
from gisnav_tpu_torch.geometry.se3 import make_transform
from gisnav_tpu_torch.nodes.bbox_node import BBoxNode
from gisnav_tpu_torch.nodes.bus import LocalBus
from gisnav_tpu_torch.nodes.fusion_node import FusionNode
from gisnav_tpu_torch.nodes.gis_node import GISNode
from gisnav_tpu_torch.nodes.mock_gps import NMEANode, UBXNode, UORBNode
from gisnav_tpu_torch.nodes.pose_node import TOPIC_POSE, PoseNode
from gisnav_tpu_torch.nodes.tf import TransformGraph
from gisnav_tpu_torch.nodes.twist_node import TwistNode
from gisnav_tpu_torch.nodes.wfst_node import WFSTNode

__all__ = ["GisNavApp", "PROTOCOLS"]

PROTOCOLS = {"uorb": UORBNode, "nmea": NMEANode, "ubx": UBXNode}
_log = logging.getLogger("gisnav_tpu_torch.app")


class GisNavApp:
    """The full perception graph in one process.

    :param protocol: mock-GPS output ("uorb" | "nmea" | "ubx"), the
        reference's launch argument
    :param wfst: also run the WFS-T telemetry sink
    :param deep_runner: optional runner for the pose node (an ``.npz``
        weight set built by the caller)
    :param namespace: the health topic is ``/<namespace>/health``
    :param device: the pose, twist and fusion nodes' device; ``None`` is
        the card
    """

    def __init__(self, bus=None,
                 params: Optional[Dict[str, Dict[str, Any]]] = None,
                 wms_client=None, protocol: str = "uorb",
                 wfst: bool = False, deep_runner=None,
                 namespace: str = ROS_NAMESPACE, *, device=None):
        if protocol not in PROTOCOLS:
            raise ValueError(f"unknown protocol {protocol!r}")
        params = params or {}
        self.bus = bus or LocalBus()
        self.tf = TransformGraph()
        self.health_topic = f"/{namespace}/health"

        self.bbox = BBoxNode(self.bus, params.get("bbox_node"), self.tf)
        self.gis = GISNode(self.bus, params.get("gis_node"), self.tf,
                           wms_client=wms_client)
        self.pose = PoseNode(self.bus, params.get("pose_node"), self.tf,
                             deep_runner=deep_runner, device=device)
        self.twist = TwistNode(self.bus, params.get("twist_node"), self.tf,
                               device=device)
        self.fusion = FusionNode(self.bus, params.get("fusion_node"),
                                 self.tf, device=device)
        self.mock_gps = PROTOCOLS[protocol](
            self.bus, params.get(f"{protocol}_node"), self.tf)
        self.wfst = (WFSTNode(self.bus, params.get("wfst_node"), self.tf)
                     if wfst else None)

        # gisnav_odom starts aligned with gisnav_map: the first global fix
        # seeds the VO pose (the reference bootstraps from the FCU's tf,
        # twist_node.py:417-477)
        self._vo_bootstrapped = False
        self._bootstrap_lock = threading.Lock()
        self.bus.subscribe(TOPIC_POSE, self._bootstrap_vo)

        self._stop = threading.Event()
        self._threads = []

    def _bootstrap_vo(self, pose_msg) -> None:
        with self._bootstrap_lock:
            if self._vo_bootstrapped:
                return
            self.twist.initialize_pose(make_transform(
                quat_to_matrix(np.asarray(pose_msg["quat_xyzw"])),
                np.asarray(pose_msg["position"])))
            self._vo_bootstrapped = True

    @property
    def nodes(self):
        out = [self.bbox, self.gis, self.pose, self.twist, self.fusion,
               self.mock_gps]
        return out if self.wfst is None else out + [self.wfst]

    def spin(self, gis_rate_hz: float = 1.0,
             fusion_rate_hz: float = 5.0) -> None:
        """Start the timers in background threads and return: the GIS
        publish, the fusion output at a fixed rate (the reference publishes
        robot_localization at 5 Hz, which keeps mock-GPS output alive
        through VO dropouts) and the health report every 5 s."""

        def every(period_s: float, fn):
            def loop():
                while not self._stop.is_set():
                    try:
                        fn()
                    except Exception:  # noqa: BLE001 - a timer keeps going
                        _log.exception("timer %r failed", fn)
                    self._stop.wait(period_s)
            return loop

        for target in (
                every(1.0 / gis_rate_hz, self.gis.tick),
                every(1.0 / fusion_rate_hz, self.fusion.tick_now),
                every(5.0, lambda: self.bus.publish(self.health_topic,
                                                    self.health()))):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)

    def health(self, stale_after_s: float = 10.0) -> Dict[str, Dict]:
        """Per-node liveness (the reference relies on Docker healthchecks;
        here the graph is one process and reports on itself)."""
        now = time.time()
        return {n.name: {"idle_s": round(now - n.last_activity, 1),
                         "healthy": (now - n.last_activity < stale_after_s
                                     or n is self.wfst)}
                for n in self.nodes}

    def shutdown(self) -> Dict[str, Dict]:
        """Stop the timers and the bus's workers; per-node handler timing
        stats (the reference dumps cProfile stats at shutdown)."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
        close = getattr(self.bus, "close", None)
        if close is not None:
            close()
        return {n.name: n.timing_stats() for n in self.nodes}
