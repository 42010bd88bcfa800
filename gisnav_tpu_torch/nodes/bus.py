"""In-process node-graph transport.

The port's counterpart of ``gisnav_tpu/nodes/bus.py`` ``LocalBus`` in its
synchronous mode: ``publish`` calls every subscriber inline, which is how a
graph in one process (one process owns the card) dispatches. Payloads are
Python objects (dicts of arrays, like the reference's ROS messages); topics
follow ``gisnav_tpu_torch.constants``. The port has no counterpart yet of
the JAX bus's threaded dispatch or of its shared-memory transport.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any, Callable, Dict, List

__all__ = ["LocalBus"]


class LocalBus:
    """In-process topic dispatch: subscribers run inline, in subscription
    order."""

    def __init__(self):
        self._subs: Dict[str, List[Callable[[Any], None]]] = defaultdict(list)

    def subscribe(self, topic: str, callback: Callable[[Any], None]) -> None:
        self._subs[topic].append(callback)

    def publish(self, topic: str, message: Any) -> None:
        for cb in list(self._subs.get(topic, ())):
            cb(message)
