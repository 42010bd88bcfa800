"""Host C++ libraries of the port, built at first use.

``build_native_lib(name)`` compiles ``native/<name>.cpp`` once with the host
C++ compiler (``$CXX``, else ``g++``) into ``native/_build/`` and returns
the library's path, for ``ctypes`` to load. Six sources live here:
``shmbus.cpp`` (the shared-memory bus, ``nodes/bus.py``), ``jpeg.cpp``
(the JPEG codec, ``gis/jpeg.py``), ``imgcodecs.cpp`` (the byte coders
of TIFF, GIF, BMP and Radiance HDR, ``gis/coders.py``), ``webp.cpp``
(the WebP decoder, ``gis/webp.py``), ``jpeg2000.cpp`` (the JPEG 2000
decoder, ``gis/jpeg2000.py``) and ``fax3.cpp`` (TIFF's CCITT decoders,
``gis/coders.py``). ``jpeg2000.cpp`` alone is built with
``-ffp-contract=off``: its 9/7 wavelet and colour transform must round
each multiply and add as OpenJPEG's SSE code does, which a compiler that
fuses them into FMAs (GCC's default where the target has FMA, as on ARM)
would not. A library's name hashes its source and
the flags, so an edited source is rebuilt and a built one reused; each
build writes a temporary file of its own and renames it into place, so
processes that build at once all end with one whole library. A failed build
raises ``RuntimeError`` with the compiler's output.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import threading

__all__ = ["build_native_lib", "NATIVE_DIR", "NATIVE_BUILD_DIR"]

NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
NATIVE_BUILD_DIR = os.path.join(NATIVE_DIR, "_build")
# gisnav_tpu/native/Makefile's compile and link flags
_CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17"]
_LD_FLAGS = ["-shared", "-lrt"]
_EXTRA_FLAGS = {"jpeg2000": ["-ffp-contract=off"]}
_WHAT = {"shmbus": "shm bus", "jpeg": "JPEG codec",
         "imgcodecs": "image byte coders", "webp": "WebP decoder",
         "jpeg2000": "JPEG 2000 decoder", "fax3": "CCITT decoder"}
_build_lock = threading.Lock()


def build_native_lib(name: str = "shmbus") -> str:
    """Compile ``native/<name>.cpp`` once into ``native/_build/`` and return
    the library's path."""
    src = os.path.join(NATIVE_DIR, f"{name}.cpp")
    cxx_flags = _CXX_FLAGS + _EXTRA_FLAGS.get(name, [])
    with open(src, "rb") as f:
        digest = hashlib.sha256(" ".join(cxx_flags + _LD_FLAGS).encode()
                                + b"\0" + f.read()).hexdigest()[:12]
    out = os.path.join(NATIVE_BUILD_DIR, f"lib{name}_{digest}.so")
    what = _WHAT.get(name, name)
    with _build_lock:
        if os.path.exists(out):
            return out
        os.makedirs(NATIVE_BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [os.environ.get("CXX", "g++"), *cxx_flags, src, "-o", tmp,
               *_LD_FLAGS]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"{what} build: cannot run {cmd[0]}: {e}"
                               ) from e
        if proc.returncode != 0:
            raise RuntimeError(f"{what} build failed ({' '.join(cmd)}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        return out
