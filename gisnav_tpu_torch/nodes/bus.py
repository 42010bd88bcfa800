"""Node-graph transports: the in-process bus and the shared-memory bus.

The port's counterpart of ``gisnav_tpu/nodes/bus.py``. Both transports
share one ``publish`` / ``subscribe`` interface:

- :class:`LocalBus`: in-process dispatch. By default ``publish`` calls
  every subscriber inline, in subscription order. With
  ``async_dispatch=True`` each subscriber gets a worker thread with a queue
  of 4 messages, and a message for a full queue is dropped (sensor QoS: a
  slow consumer sees the newest frames, never a backlog).
- :class:`ShmBus`: multi-process pub/sub over the native seqlock ring bus
  (``native/shmbus.cpp``, the port's own copy of the JAX package's, with
  the same segment layout, magic and slot protocol). A topic is a POSIX
  shared-memory segment ``/gisnav_<sha1(namespace + topic)[:16]>``, as in
  the JAX package, so a JAX graph and a port graph in one namespace share
  segments. Messages are pickled; one reader thread a subscription polls
  the ring and calls the subscriber, and a reader that falls behind skips
  to the newest message. The library is built at first use
  (``native.build_native_lib``); a failed build raises.

Handlers that issue device work take ``utils.devlock`` so threads launch
one node's kernels at a time. Payloads are Python objects (dicts of numpy
arrays and builtins, like the reference's ROS messages); topics follow
``gisnav_tpu_torch.constants``. A ``torch`` object never crosses the
shared-memory bus: ``ShmBus.publish`` raises ``TypeError`` on one (a CUDA
tensor would carry device storage into another process).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import io
import logging
import os
import pickle
import queue
import threading
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Tuple

from gisnav_tpu_torch.native import build_native_lib

__all__ = ["LocalBus", "ShmBus", "segment_name"]

_log = logging.getLogger("gisnav_tpu_torch.bus")
_STOP = object()
QUEUE_DEPTH = 4
WORKER_NAME = "gisnav-bus-worker"


class LocalBus:
    """In-process topic dispatch, synchronous or one worker a subscriber.

    ``dropped`` counts the messages an asynchronous bus dropped because a
    subscriber's queue was full. After :meth:`close` a message that reaches
    an enqueuer (one that ``publish`` took before the close) is dropped, and
    no worker starts for it.
    """

    def __init__(self, async_dispatch: bool = False):
        self._subs: Dict[str, List[Callable[[Any], None]]] = defaultdict(list)
        self._async = async_dispatch
        self._lock = threading.Lock()
        self._workers: List[Tuple[queue.Queue, threading.Thread]] = []
        self._closed = False
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
            # built and never driven starts no thread. ``_closed`` is read
            # under the lock that ``close`` sets it under, so a worker is
            # either started before the close (and stopped by it) or never
            if self._closed:
                return
            if not started.is_set():
                with self._lock:
                    if self._closed:
                        return
                    if not started.is_set():
                        t = threading.Thread(target=worker, daemon=True,
                                             name=WORKER_NAME)
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
            self._closed = True
            workers, self._workers = self._workers, []
            self._subs.clear()
        for q, _ in workers:
            try:
                q.put(_STOP, timeout=timeout_s)
            except queue.Full:  # a stuck worker behind a full queue
                pass
        for _, t in workers:
            t.join(timeout=timeout_s)


_UINT64_MAX = ctypes.c_uint64(-1).value


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The loaded native library, its C entry points typed."""
    lib = ctypes.CDLL(build_native_lib("shmbus"))
    vp, u64, cp = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p
    for fn, restype, argtypes in (
            ("shmbus_create", vp, [cp, u64, u64]),
            ("shmbus_open", vp, [cp]),
            ("shmbus_publish", u64, [vp, cp, u64]),
            ("shmbus_head", u64, [vp]),
            ("shmbus_read", u64, [vp, u64, ctypes.POINTER(ctypes.c_uint8),
                                  u64, ctypes.POINTER(u64)]),
            ("shmbus_slot_size", u64, [vp]),
            ("shmbus_writer_acquire", ctypes.c_int, [vp]),
            ("shmbus_writer_release", None, [vp]),
            ("shmbus_close", None, [vp]),
            ("shmbus_unlink", ctypes.c_int, [cp])):
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def segment_name(namespace: str, topic: str) -> bytes:
    """The shared-memory segment of ``topic`` in ``namespace`` (the JAX
    package's naming)."""
    digest = hashlib.sha1(f"{namespace}{topic}".encode()).hexdigest()[:16]
    return f"/gisnav_{digest}".encode()


class _NoTorchPickler(pickle.Pickler):
    """Pickles a message and refuses any ``torch`` object in it."""

    def reducer_override(self, obj):
        if type(obj).__module__.split(".")[0] == "torch":
            raise TypeError(f"a {type(obj).__name__} cannot cross the "
                            "shared-memory bus: publish numpy arrays")
        return NotImplemented


def _dumps(message: Any) -> bytes:
    buf = io.BytesIO()
    _NoTorchPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(message)
    return buf.getvalue()


class ShmBus:
    """Multi-process pub/sub over the native shared-memory ring bus.

    :param namespace: isolates topic segments between graphs and tests
    :param slots: ring depth a topic (a reader further behind skips ahead)
    :param slot_size: largest pickled message a topic carries; a segment
        is ``slots * slot_size`` bytes of ``/dev/shm``, sparse until written
    :param poll_interval_s: a reader's first sleep on an empty ring; it
        doubles to 10 ms while the ring stays empty

    ``dropped`` counts the messages readers skipped by falling behind. A
    topic has one writing process (the segment's pid lock, taken over when
    its holder died); within a process, publishes of a topic are serialised.
    """

    def __init__(self, namespace: str = "gisnav", slots: int = 8,
                 slot_size: int = 32 * 1024 * 1024,
                 poll_interval_s: float = 0.0005):
        self._lib = _lib()
        self._namespace = namespace
        self._slots = slots
        self._slot_size = slot_size
        self._poll = poll_interval_s
        self._lock = threading.Lock()
        self._handles: Dict[str, Tuple[int, threading.Lock]] = {}
        self._created: List[bytes] = []
        self._readers: List[threading.Thread] = []
        self._stop = threading.Event()
        self.dropped = 0

    def _handle(self, topic: str) -> Tuple[int, threading.Lock]:
        with self._lock:
            if topic not in self._handles:
                name = segment_name(self._namespace, topic)
                h = self._lib.shmbus_create(name, self._slots,
                                            self._slot_size)
                if not h:
                    raise OSError(f"shmbus_create failed for {topic}")
                self._handles[topic] = (h, threading.Lock())
                self._created.append(name)
            return self._handles[topic]

    def publish(self, topic: str, message: Any) -> None:
        payload = _dumps(message)
        if len(payload) > self._slot_size:
            raise ValueError(f"message of {len(payload)} bytes exceeds slot "
                             f"size {self._slot_size} on {topic}")
        handle, lock = self._handle(topic)
        with lock:
            seq = self._lib.shmbus_publish(handle, payload, len(payload))
        if seq == 0:
            raise OSError(f"shmbus_publish failed on {topic} (another live "
                          "process holds its write lock)")

    def subscribe(self, topic: str, callback: Callable[..., None], *,
                  stamped: bool = False) -> None:
        """Call ``callback(message)`` for each message published on
        ``topic`` from now on; ``stamped``: ``callback(message, stamp_us)``
        with the publisher's wall-clock stamp (``CLOCK_REALTIME``, us),
        comparable across processes."""
        handle, _ = self._handle(topic)
        buf = (ctypes.c_uint8 * self._slot_size)()
        stamp = ctypes.c_uint64()
        start = self._lib.shmbus_head(handle)  # what is published from now

        def reader():
            seq = start
            backoff = self._poll
            while not self._stop.is_set():
                n = self._lib.shmbus_read(handle, seq, buf, self._slot_size,
                                          ctypes.byref(stamp))
                if n == 0:
                    time.sleep(backoff)
                    backoff = min(backoff * 2, 0.01)
                    continue
                backoff = self._poll
                if n == _UINT64_MAX:  # overwritten: skip to the newest
                    head = self._lib.shmbus_head(handle)
                    with self._lock:
                        self.dropped += max(head - seq, 0)
                    seq = head
                    continue
                seq += 1
                try:
                    msg = pickle.loads(ctypes.string_at(buf, n))
                    if stamped:
                        callback(msg, stamp.value)
                    else:
                        callback(msg)
                except Exception:  # noqa: BLE001 - a node fails soft
                    _log.exception("subscriber %r failed", callback)

        t = threading.Thread(target=reader, daemon=True,
                             name=f"shmbus-reader {topic}")
        t.start()
        self._readers.append(t)

    def close(self, unlink: bool = False, timeout_s: float = 2.0) -> None:
        """Stop the readers (after the handler each one is in), unmap the
        segments, and with ``unlink`` remove the ones this bus opened."""
        self._stop.set()
        for t in self._readers:
            t.join(timeout=timeout_s)
        with self._lock:
            handles, self._handles = self._handles, {}
            created = self._created
            if unlink:
                self._created = []
        for h, _ in handles.values():
            self._lib.shmbus_close(h)
        if unlink:  # also after an earlier close without it
            for name in created:
                self._lib.shmbus_unlink(name)
