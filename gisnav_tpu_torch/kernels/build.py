"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``*.cu`` source in this directory is one shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` into ``_build/<key>/``
(``_build`` is listed in ``.gitignore``; ``<key>`` is
``utils.jitcache.host_key()``, the host's CPU, card, CUDA runtime, ``nvcc``
and torch, so a library built elsewhere is never loaded). The library name
carries a hash of its source and of every ``*.cuh`` header beside it, so an
edited kernel or header is rebuilt and a built one is reused. All missing libraries build in parallel, one ``nvcc``
process per source. A failed build raises: there is no fallback to the plain
PyTorch versions on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

from gisnav_tpu_torch.utils.jitcache import cache_dir, enable_persistent_cache

__all__ = ["SOURCES", "aligned16", "build_all", "library", "check",
           "check_device", "on_device", "ptr", "stream_of", "typed"]

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("conv", "nms_select", "lightglue_block", "attention", "shear")
_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
          "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _target(name: str, src_dir: str = _HERE) -> str:
    """The library path of ``name``: its hash covers the source, every
    shared header of the directory (by name and bytes) and the flags."""
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    headers = sorted(n for n in os.listdir(src_dir) if n.endswith(".cuh"))
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(src_dir, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(cache_dir(),
                        f"lib{name}_{digest.hexdigest()[:12]}.so")


def build_all(verbose: bool = False) -> Dict[str, str]:
    """Compile every source whose library is missing; return name -> path."""
    if enable_persistent_cache() is None:
        raise RuntimeError("the kernels are built for a CUDA card and this "
                           "host has none")
    targets = {n: _target(n) for n in SOURCES}
    procs = {}
    for name, out in targets.items():
        if os.path.exists(out):
            continue
        tmp = out + f".{os.getpid()}.tmp"
        cmd = [_nvcc(), *_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, os.path.join(_HERE, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if verbose and log:
            print(f"[nvcc {name}]\n{log}", flush=True)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``name`` (``conv``, ``nms_select``, ...)."""
    with _lock:
        if name not in _libs:
            for n, path in build_all().items():
                _libs.setdefault(n, ctypes.CDLL(path))
        return _libs[name]


def typed(lib: ctypes.CDLL, signatures: Dict[str, list]) -> ctypes.CDLL:
    """Declare argument and return types of the library's C entry points
    once (pointers and the stream as ``c_void_p``: an undeclared pointer
    would be cut to a 32-bit int)."""
    if not getattr(lib, "_typed", False):
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib._typed = True
    return lib


def check_device(what: str, *tensors) -> None:
    """Raise unless every tensor lies on the first one's CUDA device: the
    kernels take raw pointers and would fault on host memory."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: all tensors must be on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")


def check(rc: int, what: str) -> None:
    """Raise if a kernel's C entry point reported a refused launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (code {rc})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def aligned16(t):
    """``t`` contiguous at a 16-byte aligned address (copied if a view
    starts elsewhere): the kernels stage their inputs by 16-byte copies."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def on_device(t):
    """The launch's context: ``t``'s card made the current device, since
    the entry points set kernel attributes on, and size their grids from,
    the current device."""
    import torch

    return torch.cuda.device(t.device)


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
