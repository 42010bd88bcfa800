"""Process-wide device dispatch lock for the multi-threaded node graph.

The port's copy of ``gisnav_tpu/utils/devlock.py``. Every node handler
that issues device work takes :data:`device_lock`, so the graph's worker
threads issue one node's kernels at a time: one card runs one stream of
them anyway, and the host stages that gain from threads (rendering, IO)
stay outside the lock. The reference runs each node in its own process
(ROS 2 executors); this lock is the equivalent boundary for a graph in one
process.
"""
from __future__ import annotations

import threading

__all__ = ["device_lock"]

#: Reentrant: a locked handler may call helpers that also take the lock.
device_lock = threading.RLock()
