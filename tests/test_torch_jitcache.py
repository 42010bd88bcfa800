"""The port's build cache key against the JAX package's ``utils/jitcache.py``.

The key hashes the JAX key's CPU fields plus the card, the CUDA runtime,
``nvcc`` and torch: it is stable, it moves with the card's name or the
toolkit, the kernels' libraries are built under ``kernels/_build/<key>/``,
and on a host without a card ``enable_persistent_cache()`` returns ``None``,
as the JAX one does on the CPU backend. No compiler runs.
"""
import os

import jax
import pytest
import torch

from gisnav_tpu.utils import jitcache as jjit
from gisnav_tpu_torch.kernels import build
from gisnav_tpu_torch.utils import jitcache


def test_key_is_stable_and_holds_the_jax_cpu_fields():
    first = jitcache.host_key()
    assert first == jitcache.host_key() and len(first) == 12
    assert jitcache.cache_dir() == os.path.join(jitcache.BUILD_ROOT, first)
    assert os.path.basename(jitcache.BUILD_ROOT) == "_build"
    assert os.path.dirname(build._target("conv")) == jitcache.cache_dir()
    # the CPU part is the JAX key's: its hash of the same fields
    import hashlib

    assert hashlib.sha256(jitcache._cpu_fields().encode()).hexdigest()[
        :12] == jjit._host_key()


@pytest.mark.parametrize("field,values", [
    ("_gpu_fields", ("NVIDIA H100 80GB HBM3|sm_90|cuda 12.8",
                     "NVIDIA H200|sm_90|cuda 12.8")),
    ("_gpu_fields", ("NVIDIA H100 80GB HBM3|sm_90|cuda 12.8",
                     "NVIDIA H100 80GB HBM3|sm_90|cuda 12.9")),
    ("_nvcc_version", ("Build cuda_12.8.r12.8/compiler.35404655_0",
                       "Build cuda_12.9.r12.9/compiler.35813241_0"))])
def test_key_moves_with_the_card_and_the_toolkit(monkeypatch, field,
                                                 values):
    keys = []
    for value in values:
        monkeypatch.setattr(jitcache, field, lambda v=value: v)
        keys.append(jitcache.host_key())
        assert keys[-1] == jitcache.host_key()
    assert keys[0] != keys[1]


def test_no_cache_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert jitcache.enable_persistent_cache() is None
    assert jitcache._gpu_fields() == "none"
    assert jax.default_backend() == "cpu"
    assert jjit.enable_persistent_cache() is None
    with pytest.raises(RuntimeError, match="CUDA card"):
        build.build_all()
