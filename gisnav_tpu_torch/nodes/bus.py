"""In-process node-graph transport.

The port's counterpart of ``gisnav_tpu/nodes/bus.py`` ``LocalBus``. By
default ``publish`` calls every subscriber inline, in subscription order.
With ``async_dispatch=True`` (what ``run`` builds) each subscriber gets a
worker thread with a queue of 4 messages, and a message for a full queue is
dropped (sensor QoS: a slow consumer sees the newest frames, never a
backlog). Handlers that issue device work take ``utils.devlock`` so the
workers launch one node's kernels at a time. Payloads are Python objects
(dicts of arrays, like the reference's ROS messages); topics follow
``gisnav_tpu_torch.constants``. The JAX bus's shared-memory transport is
not ported.
"""
from __future__ import annotations

import logging
import queue
import threading
from collections import defaultdict
from typing import Any, Callable, Dict, List, Tuple

__all__ = ["LocalBus"]

_log = logging.getLogger("gisnav_tpu_torch.bus")
_STOP = object()
QUEUE_DEPTH = 4


class LocalBus:
    """In-process topic dispatch, synchronous or one worker a subscriber.

    ``dropped`` counts the messages an asynchronous bus dropped because a
    subscriber's queue was full.
    """

    def __init__(self, async_dispatch: bool = False):
        self._subs: Dict[str, List[Callable[[Any], None]]] = defaultdict(list)
        self._async = async_dispatch
        self._lock = threading.Lock()
        self._workers: List[Tuple[queue.Queue, threading.Thread]] = []
        self.dropped = 0

    def subscribe(self, topic: str, callback: Callable[[Any], None]) -> None:
        with self._lock:
            self._subs[topic].append(
                self._enqueuer(callback) if self._async else callback)

    def _enqueuer(self, callback: Callable[[Any], None]
                  ) -> Callable[[Any], None]:
        q: queue.Queue = queue.Queue(maxsize=QUEUE_DEPTH)
        started = threading.Event()

        def worker():
            while True:
                item = q.get()
                if item is _STOP:
                    return
                try:
                    callback(item)
                except Exception:  # noqa: BLE001 - a node fails soft
                    _log.exception("subscriber %r failed", callback)

        def enqueue(msg):
            # the worker starts with the first message: a graph that is
            # built and never driven starts no thread
            if not started.is_set():
                with self._lock:
                    if not started.is_set():
                        t = threading.Thread(target=worker, daemon=True)
                        t.start()
                        self._workers.append((q, t))
                        started.set()
            try:
                q.put_nowait(msg)
            except queue.Full:
                with self._lock:
                    self.dropped += 1

        return enqueue

    def publish(self, topic: str, message: Any) -> None:
        with self._lock:
            subs = list(self._subs.get(topic, ()))
        for cb in subs:
            cb(message)

    def close(self, timeout_s: float = 2.0) -> None:
        """Stop the worker threads after the handler each one is in (a
        daemon thread inside a device call at interpreter teardown can
        abort the process); later publishes reach no subscriber."""
        with self._lock:
            workers, self._workers = self._workers, []
            self._subs.clear()
        for q, _ in workers:
            try:
                q.put(_STOP, timeout=timeout_s)
            except queue.Full:  # a stuck worker behind a full queue
                pass
        for _, t in workers:
            t.join(timeout=timeout_s)
