"""Profiling: per-stage wall timers + the torch device profiler.

The port's counterpart of ``gisnav_tpu/utils/profiling.py``. The reference
wraps every node's spin in cProfile and dumps the top-20 cumulative stats
at shutdown (``ros/gisnav/gisnav/__init__.py:126-170`` in
hmakelin/gisnav). Here the same habit is split into:

- :class:`StageTimer`: named host-clock sections with summary stats. A
  stage that ran on the card (``device=`` a CUDA device) synchronises that
  device before each clock read, since PyTorch returns before the card
  finishes;
- :func:`device_profile`: a ``torch.profiler`` trace around a block,
  written as a chrome trace (``chrome://tracing``, Perfetto) under
  ``logdir``.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch

__all__ = ["StageTimer", "device_profile"]


class StageTimer:
    """Accumulates wall time per named stage.

    Usage::

        timer = StageTimer()
        with timer("extract", device=frame.device):
            ...
        print(timer.report())
    """

    def __init__(self):
        self._acc: Dict[str, list] = defaultdict(lambda: [0, 0.0, 0.0])

    @contextlib.contextmanager
    def __call__(self, stage: str, device=None) -> Iterator[None]:
        cuda = device is not None and torch.device(device).type == "cuda"
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            rec = self._acc[stage]
            rec[0] += 1
            rec[1] += dt
            rec[2] = max(rec[2], dt)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "calls": calls,
                "total_s": round(total, 4),
                "mean_ms": round(total / calls * 1e3, 3) if calls else 0.0,
                "max_ms": round(mx * 1e3, 3),
            }
            for name, (calls, total, mx) in sorted(
                self._acc.items(), key=lambda kv: -kv[1][1]
            )
        }

    def report(self, top: int = 20) -> str:
        lines = [f"{'stage':<28}{'calls':>8}{'total s':>10}{'mean ms':>10}"
                 f"{'max ms':>10}"]
        for name, s in list(self.summary().items())[:top]:
            lines.append(
                f"{name:<28}{s['calls']:>8}{s['total_s']:>10.3f}"
                f"{s['mean_ms']:>10.2f}{s['max_ms']:>10.2f}"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_profile(logdir: str) -> Iterator[torch.profiler.profile]:
    """Trace the block with ``torch.profiler`` (the host, and the card
    when CUDA is available) and write ``<logdir>/trace.json``; yields the
    profiler (``key_averages()`` for sums by kernel)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
