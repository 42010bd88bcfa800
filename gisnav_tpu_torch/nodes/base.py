"""Node base class: bus wiring, parameters, fail-soft handlers, profiling.

The port's copy of ``gisnav_tpu/nodes/base.py``.
"""
from __future__ import annotations

import logging
import time
from collections import defaultdict
from typing import Any, Dict, Optional

__all__ = ["Node"]


class Node:
    """Minimal node: named, bus-attached, parameterized, profiled.

    Subscriptions are explicit ``bus.subscribe`` calls, parameters are a
    plain dict with defaults in code, and every handler is wrapped to
    log-and-continue instead of raising (the reference's fail-soft
    pattern). Per-handler cumulative timings are kept for ``timing_stats``.
    """

    def __init__(self, name: str, bus, params: Optional[Dict[str, Any]] = None,
                 tf=None):
        self.name = name
        self.bus = bus
        self.tf = tf
        self._params: Dict[str, Any] = dict(params or {})
        self.log = logging.getLogger(name)
        self._timings: Dict[str, list] = defaultdict(lambda: [0, 0.0])
        self.last_activity: float = time.time()

    def param(self, key: str, default: Any = None) -> Any:
        return self._params.get(key, default)

    def subscribe(self, topic: str, handler) -> None:
        """Subscribe with fail-soft + timing instrumentation."""
        hname = getattr(handler, "__name__", str(handler))

        def wrapped(msg):
            t0 = time.perf_counter()
            try:
                handler(msg)
            except Exception as e:  # noqa: BLE001 — log and continue
                self.log.warning("%s failed: %r", hname, e, exc_info=True)
            finally:
                rec = self._timings[hname]
                rec[0] += 1
                rec[1] += time.perf_counter() - t0
                self.last_activity = time.time()

        self.bus.subscribe(topic, wrapped)

    def publish(self, topic: str, message) -> None:
        self.bus.publish(topic, message)

    def timing_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-handler call counts and cumulative seconds."""
        return {
            k: {"calls": v[0], "total_s": v[1],
                "mean_ms": (v[1] / v[0] * 1e3 if v[0] else 0.0)}
            for k, v in self._timings.items()
        }
