"""Harris corner response, the parameter-free detector of the ``harris``
detector mode.

Counterpart of ``gisnav_tpu/features/harris.py``, which computes it in XLA
with no Pallas kernel; plain PyTorch on tensors is its port. The order of
operations is the JAX package's: Sobel gradients / 8 on the edge-replicated
image, the 5-tap Gaussian normalised by its sum applied down the columns and
then along the rows (summed tap by tap in index order), ``det - k tr^2``
clamped at 0 and divided by the image's own maximum.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["harris_response"]


def _pad_edge(x: torch.Tensor, left: int, right: int, top: int,
              bottom: int) -> torch.Tensor:
    """Edge-replicate a (B, H, W) batch (``replicate`` needs a 4-D view)."""
    pads = (left, right, top, bottom)
    return F.pad(x[:, None], pads, mode="replicate")[:, 0]


def _separable_blur(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Separable blur of a (B, H, W) batch: columns, then rows."""
    k = kernel / torch.sum(kernel)
    n = kernel.shape[0]
    pad = (n - 1) // 2
    h, w = x.shape[-2:]
    xp = _pad_edge(x, 0, 0, pad, pad)
    cols = sum(xp[:, i:i + h, :] * k[i] for i in range(n))
    xp = _pad_edge(cols, pad, pad, 0, 0)
    return sum(xp[:, :, i:i + w] * k[i] for i in range(n))


def harris_response(image: torch.Tensor, k: float = 0.04,
                    blur_sigma: float = 1.0) -> torch.Tensor:
    """Harris response of an (H, W) grayscale image in [0, 1], or of each
    image of a (B, H, W) batch: det(M) - k tr(M)^2 over the blurred
    structure tensor M, clamped at 0 and normalised by each image's maximum
    (so ``select_keypoints`` score thresholds stay meaningful)."""
    single = image.dim() == 2
    img = image.float()[None] if single else image.float()
    p = _pad_edge(img, 1, 1, 1, 1)
    gx = ((p[:, :-2, 2:] + 2 * p[:, 1:-1, 2:] + p[:, 2:, 2:])
          - (p[:, :-2, :-2] + 2 * p[:, 1:-1, :-2] + p[:, 2:, :-2])) / 8.0
    gy = ((p[:, 2:, :-2] + 2 * p[:, 2:, 1:-1] + p[:, 2:, 2:])
          - (p[:, :-2, :-2] + 2 * p[:, :-2, 1:-1] + p[:, :-2, 2:])) / 8.0

    taps = torch.arange(-2, 3, dtype=torch.float32, device=img.device)
    gauss = torch.exp(-0.5 * (taps / blur_sigma) ** 2)
    ixx = _separable_blur(gx * gx, gauss)
    iyy = _separable_blur(gy * gy, gauss)
    ixy = _separable_blur(gx * gy, gauss)

    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    resp = torch.clamp(det - k * tr * tr, min=0.0)
    peak = torch.clamp(resp.amax(dim=(-2, -1), keepdim=True), min=1e-12)
    out = resp / peak
    return out[0] if single else out
