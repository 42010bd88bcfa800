"""Host-side stamped transform graph (tf2-equivalent).

The port's own copy of ``gisnav_tpu/nodes/tf.py``. The reference leans hard
on tf2's time-travel semantics: stamped transform interpolation, static
transforms, frame-chain composition and a fall-back-to-latest on
extrapolation failure (``_transformations.py:185-225`` in hmakelin/gisnav;
frame bootstrapping at ``pose_node.py:389-473`` and
``twist_node.py:417-477``). This module reimplements that contract without
ROS: per-edge time-indexed buffers with slerp/lerp interpolation and
graph-path composition.
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from gisnav_tpu_torch.geometry.se3 import compose, interpolate_transform, invert

__all__ = ["TransformGraph", "TransformLookupError"]


class TransformLookupError(KeyError):
    """No path between the requested frames (or empty buffers)."""


class _Edge:
    """Time-indexed buffer of transforms for one (parent -> child) edge."""

    __slots__ = ("stamps", "transforms", "static", "max_age_us")

    def __init__(self, max_age_us: int):
        self.stamps: List[int] = []
        self.transforms: List[np.ndarray] = []
        self.static = False
        self.max_age_us = max_age_us

    def insert(self, stamp_us: int, h: np.ndarray, static: bool) -> None:
        if static:
            self.stamps = [0]
            self.transforms = [h]
            self.static = True
            return
        i = bisect.bisect(self.stamps, stamp_us)
        self.stamps.insert(i, stamp_us)
        self.transforms.insert(i, h)
        # prune old entries
        cutoff = stamp_us - self.max_age_us
        while len(self.stamps) > 1 and self.stamps[0] < cutoff:
            self.stamps.pop(0)
            self.transforms.pop(0)

    def at(self, stamp_us: Optional[int]) -> np.ndarray:
        """Interpolated transform at a time; latest when ``stamp_us`` is None
        or out of range (the reference's fallback-to-latest behavior)."""
        if not self.stamps:
            raise TransformLookupError("empty edge buffer")
        if self.static or stamp_us is None:
            return self.transforms[-1]
        if stamp_us <= self.stamps[0]:
            return self.transforms[0]
        if stamp_us >= self.stamps[-1]:
            return self.transforms[-1]
        i = bisect.bisect(self.stamps, stamp_us)
        t0, t1 = self.stamps[i - 1], self.stamps[i]
        alpha = (stamp_us - t0) / max(t1 - t0, 1)
        return interpolate_transform(
            self.transforms[i - 1], self.transforms[i], alpha
        )


class TransformGraph:
    """Thread-safe frame graph with stamped edges.

    Frames are strings (REP 103 / REP 105 frame ids); edges are directed
    parent -> child but lookups traverse both directions.

    :param max_age_s: dynamic-edge history length (tf2 default 10 s)
    """

    def __init__(self, max_age_s: float = 10.0):
        self._edges: Dict[Tuple[str, str], _Edge] = {}
        self._adj: Dict[str, List[str]] = {}
        self._max_age_us = int(max_age_s * 1e6)
        self._lock = threading.Lock()

    def add(self, parent: str, child: str, h: np.ndarray,
            stamp_us: int = 0, static: bool = False) -> None:
        """Record ``child -> parent``-composable transform: ``h`` maps points
        in the CHILD frame to the PARENT frame (ROS tf convention)."""
        h = np.asarray(h, dtype=np.float64)
        if h.shape != (4, 4):
            raise ValueError(f"transform of shape {h.shape}")
        with self._lock:
            key = (parent, child)
            if key not in self._edges:
                self._edges[key] = _Edge(self._max_age_us)
                self._adj.setdefault(parent, []).append(child)
                self._adj.setdefault(child, []).append(parent)
            self._edges[key].insert(int(stamp_us), h, static)

    def can_transform(self, target: str, source: str) -> bool:
        with self._lock:
            return self._find_path(target, source) is not None

    def lookup(self, target: str, source: str,
               stamp_us: Optional[int] = None) -> np.ndarray:
        """4x4 transform mapping points in ``source`` to ``target``.

        Uses per-edge interpolation at ``stamp_us``; edges clamp to their
        newest/oldest sample rather than failing on extrapolation
        (reference semantics, ``_transformations.py:211-219``).
        """
        with self._lock:
            path = self._find_path(target, source)
            if path is None:
                raise TransformLookupError(
                    f"no transform path {source} -> {target}"
                )
            out = np.eye(4)
            # walk from target toward source; ``out`` stays target<-current
            for cur, nxt in zip(path[:-1], path[1:]):
                if (cur, nxt) in self._edges:
                    # stored edge maps nxt(child) -> cur(parent): use as-is
                    h = self._edges[(cur, nxt)].at(stamp_us)
                    out = compose(out, h)
                else:
                    # stored edge maps cur(child) -> nxt(parent): invert
                    h = self._edges[(nxt, cur)].at(stamp_us)
                    out = compose(out, invert(h))
            return out

    def _find_path(self, target: str, source: str) -> Optional[List[str]]:
        """BFS from target to source over the undirected frame graph."""
        if target == source:
            return [target]
        if target not in self._adj or source not in self._adj:
            return None
        prev: Dict[str, str] = {target: target}
        frontier = [target]
        while frontier:
            nxt = []
            for node in frontier:
                for nb in self._adj.get(node, ()):
                    if nb in prev:
                        continue
                    prev[nb] = node
                    if nb == source:
                        path = [nb]
                        while path[-1] != target:
                            path.append(prev[path[-1]])
                        return list(reversed(path))
                    nxt.append(nb)
            frontier = nxt
        return None
