"""Node base class: bus wiring, parameters, fail-soft handlers, profiling.

The port's copy of ``gisnav_tpu/nodes/base.py``; ``timing_stats`` adds the
p50 and p90 of each handler's recent calls.
"""
from __future__ import annotations

import logging
import time
from collections import defaultdict, deque
from typing import Any, Dict, Optional

import numpy as np

__all__ = ["Node"]


class Node:
    """Minimal node: named, bus-attached, parameterized, profiled.

    Subscriptions are explicit ``bus.subscribe`` calls, parameters are a
    plain dict with defaults in code, and every handler is wrapped to
    log-and-continue instead of raising (the reference's fail-soft
    pattern). Per-handler call counts, cumulative time and the durations of
    the last ``RECENT`` calls are kept for ``timing_stats``.
    """

    RECENT = 1024

    def __init__(self, name: str, bus, params: Optional[Dict[str, Any]] = None,
                 tf=None):
        self.name = name
        self.bus = bus
        self.tf = tf
        self._params: Dict[str, Any] = dict(params or {})
        self.log = logging.getLogger(name)
        self._timings: Dict[str, list] = defaultdict(
            lambda: [0, 0.0, deque(maxlen=self.RECENT)])
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
                dt = time.perf_counter() - t0
                rec = self._timings[hname]
                rec[0] += 1
                rec[1] += dt
                rec[2].append(dt)
                self.last_activity = time.time()

        self.bus.subscribe(topic, wrapped)

    def publish(self, topic: str, message) -> None:
        self.bus.publish(topic, message)

    def timing_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-handler call counts, cumulative seconds, the mean, and the
        p50 and p90 of the recent calls in milliseconds (host clock)."""
        out = {}
        for k, (calls, total, recent) in list(self._timings.items()):
            ms = np.asarray(list(recent), np.float64) * 1e3
            out[k] = {"calls": calls, "total_s": total,
                      "mean_ms": total / calls * 1e3 if calls else 0.0,
                      "p50_ms": float(np.median(ms)) if ms.size else 0.0,
                      "p90_ms": (float(np.percentile(ms, 90)) if ms.size
                                 else 0.0)}
        return out
