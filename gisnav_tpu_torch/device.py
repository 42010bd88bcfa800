"""Device selection for the port's entry points.

The port runs on the card. The CPU is used only when a caller asks for it
(``device="cpu"``), as the tests do; there is no silent CPU fallback.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "strict_fp32", "scalar_f32"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``cuda`` by default; raise if CUDA is absent unless ``cpu`` is asked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gisnav_tpu_torch runs on CUDA and no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev


def strict_fp32() -> None:
    """Turn TF32 off: geometry, the warp and RANSAC need true f32 (a TF32
    product keeps ~3 decimal digits, metres of error on absolute
    coordinates)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def scalar_f32(v, device) -> torch.Tensor:
    """A () f32 tensor on ``device``: a tensor as it is (a graphed program's
    input, already on the device), a host number filled there (never a
    copy from pageable host memory, which a CUDA graph cannot capture)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((), float(v), dtype=torch.float32, device=device)
