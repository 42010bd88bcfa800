"""Where the port keeps what it compiles, keyed by the host's identity.

The port's counterpart of ``gisnav_tpu/utils/jitcache.py``. The JAX package
keys XLA's persistent compilation cache by the host CPU, because an
executable compiled for other CPU features aborts the process that loads
it. The port compiles two things: the CUDA kernels (``kernels/build.py``,
one shared library a source, built by ``nvcc`` for ``sm_90a``) and the
frame programs' CUDA graphs (``pipeline/graph.py``). A graph lives in the
process that captured it and is never written out. The libraries are
cached on disk under ``kernels/_build/<key>/``, where ``<key>`` hashes the
JAX key's CPU fields plus the card's name and compute capability, the CUDA
runtime PyTorch was built with, the ``nvcc`` release and the torch version:
a library built for another card or toolkit is then never loaded, and a
checkout that moves to another machine builds its own.
"""
from __future__ import annotations

import functools
import hashlib
import os
import platform
import subprocess
from typing import Optional

import torch

__all__ = ["cache_dir", "enable_persistent_cache", "host_key"]

BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "kernels", "_build")


def _cpu_fields() -> str:
    """The lines of ``/proc/cpuinfo`` the JAX key hashes (flags and the
    model's identity, one processor block), else the platform's names."""
    try:
        ident = []
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "model name", "model\t",
                                    "cpu family", "stepping")):
                    ident.append(line)
                if line.startswith("power management"):
                    break  # one processor block is enough
        if ident:
            return "".join(sorted(set(ident)))
    except OSError:
        pass
    return platform.machine() + platform.processor()


def _gpu_fields() -> str:
    """The card's name and compute capability and the CUDA runtime PyTorch
    was built with; ``none`` without a card."""
    if not torch.cuda.is_available():
        return "none"
    major, minor = torch.cuda.get_device_capability(0)
    return (f"{torch.cuda.get_device_name(0)}|sm_{major}{minor}|"
            f"cuda {torch.version.cuda}")


@functools.lru_cache(maxsize=1)
def _nvcc_version() -> str:
    """The last line of ``nvcc --version`` (its build), ``none`` without a
    compiler."""
    from gisnav_tpu_torch.kernels.build import _nvcc

    try:
        out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return "none"
    lines = out.strip().splitlines()
    return lines[-1] if lines else "none"


def host_key() -> str:
    fields = [_cpu_fields(), _gpu_fields(), _nvcc_version(),
              f"torch {torch.__version__}"]
    return hashlib.sha256("\n".join(fields).encode()).hexdigest()[:12]


def cache_dir() -> str:
    return os.path.join(BUILD_ROOT, host_key())


def enable_persistent_cache() -> Optional[str]:
    """Create and return this host's build directory. Returns ``None`` on a
    host without a card, as the JAX package leaves its cache off on the CPU
    backend: there is nothing to build there."""
    if not torch.cuda.is_available():
        return None
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    return path
