"""gisnav_tpu_torch: the PyTorch/CUDA port of gisnav_tpu for NVIDIA Hopper.

A package of its own beside ``gisnav_tpu`` (the JAX reference, which it never
imports). Layout mirrors the JAX package: ``features/`` (SuperPoint, NMS,
SIFT), ``matching/`` (LightGlue, LoFTR, MNN), ``raster/`` (warp), ``pnp/``
(DEM lift, RANSAC), ``geometry/``, ``pipeline/`` (geopose programs and
runners), ``fusion/`` (EKF, UKF), ``io/`` (mock-GPS encoders), ``gis/``
(WMS, PNG), ``nodes/`` (the node graph), ``train/`` (self-supervised
training), ``cli.py`` (``run``, ``train``) and ``kernels/`` (the
hand-written CUDA kernels, built at first use).

Each subpackage's ``__init__`` exports the names its ``gisnav_tpu``
counterpart exports, so ``from gisnav_tpu.<path> import <name>`` becomes
``from gisnav_tpu_torch.<path> import <name>``. Importing a subpackage
builds nothing: the kernels and the host C++ libraries are built at their
first use.
"""

__version__ = "0.1.0"

from gisnav_tpu_torch import constants  # noqa: F401,E402
from gisnav_tpu_torch.device import resolve_device  # noqa: F401,E402

__all__ = ["constants", "resolve_device", "__version__"]
