"""gisnav_tpu_torch: the PyTorch/CUDA port of gisnav_tpu for NVIDIA Hopper.

A package of its own beside ``gisnav_tpu`` (the JAX reference, which it never
imports). Layout mirrors the JAX package: ``features/`` (SuperPoint, NMS,
SIFT), ``matching/`` (LightGlue, LoFTR, MNN), ``raster/`` (warp), ``pnp/``
(DEM lift, RANSAC), ``geometry/``, ``pipeline/`` (geopose programs and
runners), ``fusion/`` (EKF, UKF), ``io/`` (mock-GPS encoders), ``gis/``
(WMS, PNG), ``nodes/`` (the node graph), ``train/`` (self-supervised
training), ``cli.py`` (``run``, ``train``) and ``kernels/`` (the
hand-written CUDA kernels, built at first use).
"""
from gisnav_tpu_torch.device import resolve_device  # noqa: F401

__all__ = ["resolve_device"]
