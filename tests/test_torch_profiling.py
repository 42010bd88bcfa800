"""The port's ``utils/profiling.py`` against the JAX package's.

- ``StageTimer``: the same summary and report as the JAX timer for the
  same stages and clock readings; a stage on a CUDA device synchronises it
  before each clock read (counted here with a stand-in), a CPU stage never.
- ``device_profile``: a ``torch.profiler`` trace of the block written as
  ``<logdir>/trace.json`` (a chrome trace), its ``key_averages`` holding
  the block's operators.
"""
import itertools
import json

import torch

from gisnav_tpu.utils import profiling as jprof
from gisnav_tpu_torch.utils import profiling as tprof

torch.set_num_threads(2)


def _drive(module, monkeypatch):
    clock = itertools.count(0.0, 0.0125)
    monkeypatch.setattr(module.time, "perf_counter", lambda: next(clock))
    timer = module.StageTimer()
    for stage in ("extract", "match", "extract", "pnp", "match", "extract"):
        with timer(stage):
            pass
    return timer


def test_stage_timer_equals_jax(monkeypatch):
    ours, ref = _drive(tprof, monkeypatch), _drive(jprof, monkeypatch)
    assert ours.summary() == ref.summary()
    assert ours.report() == ref.report()
    assert ours.summary()["extract"]["calls"] == 3


def test_stage_timer_syncs_a_cuda_stage(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    timer = tprof.StageTimer()
    with timer("host"):
        pass
    with timer("host", device="cpu"):
        pass
    assert synced == []
    with timer("device", device="cuda:0"):
        pass
    assert synced == ["cuda:0", "cuda:0"]
    assert timer.summary()["device"]["calls"] == 1


def test_device_profile_writes_a_chrome_trace(tmp_path):
    a = torch.rand(64, 64)
    with tprof.device_profile(str(tmp_path / "trace")) as prof:
        (a @ a).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    assert any(e.key == "aten::mm" for e in prof.key_averages())
