"""Classical descriptor matching on the device: kNN + Lowe ratio + mutual
check.

Counterpart of ``gisnav_tpu/matching/mnn.py`` (the reference VO matcher,
``cv2.BFMatcher.knnMatch`` with ratio test 0.7, recast as one distance
matrix). The JAX package computes the distance matrix as a plain product
outside any Pallas kernel, so here it is ``torch.matmul`` in true f32
(``mnn_ratio_match`` turns TF32 off, ``device.strict_fp32``); on SIFT's
integer-valued descriptors every entry is then exact.

Ties: ``jax.lax.top_k`` and ``jnp.argmin`` take the lowest index, and so do
the two first-index argmins here (``torch.topk`` gives no order on ties).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from gisnav_tpu_torch.device import strict_fp32

__all__ = ["mnn_ratio_match", "root_sift"]


def root_sift(desc: torch.Tensor) -> torch.Tensor:
    """RootSIFT transform: L1-normalize then sqrt."""
    l1 = torch.sum(torch.abs(desc), dim=-1, keepdim=True)
    return torch.sqrt(desc / torch.clamp(l1, min=1e-12))


def mnn_ratio_match(desc0: torch.Tensor, desc1: torch.Tensor,
                    mask0: Optional[torch.Tensor] = None,
                    mask1: Optional[torch.Tensor] = None, *,
                    ratio: float = 0.7, mutual: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """L2 kNN matching with Lowe ratio test; fixed shapes.

    :param desc0: (K0, D) query descriptors
    :param desc1: (K1, D) train descriptors, K1 >= 2
    :param ratio: Lowe ratio threshold (reference uses 0.7)
    :param mutual: additionally require mutual nearest neighbors
    :return: (matches0 (K0,) int32 index into set 1 or -1,
              dists (K0,) best L2 distance, inf where unmatched)
    """
    strict_fp32()
    k0, k1 = desc0.shape[0], desc1.shape[0]
    dev = desc0.device
    if mask0 is None:
        mask0 = torch.ones(k0, dtype=torch.bool, device=dev)
    if mask1 is None:
        mask1 = torch.ones(k1, dtype=torch.bool, device=dev)

    d0 = desc0.float()
    d1 = desc1.float()
    # squared L2 distance matrix via one product, in the JAX order
    sq0 = torch.sum(d0 * d0, dim=1, keepdim=True)
    sq1 = torch.sum(d1 * d1, dim=1, keepdim=True)
    d2 = sq0 + sq1.T - 2.0 * (d0 @ d1.T)
    d2 = torch.clamp(d2, min=0.0)
    big = torch.tensor(1e12, dtype=torch.float32, device=dev)
    d2 = torch.where(mask0[:, None] & mask1[None, :], d2, big)

    # two nearest neighbors per query row, the lower index first on ties
    nn0 = torch.argmin(d2, dim=1)
    best = d2.gather(1, nn0[:, None])[:, 0]
    second = d2.scatter(1, nn0[:, None], float("inf")).min(dim=1).values

    ok = best < (ratio * ratio) * second  # squared-distance ratio test
    ok = ok & mask0 & (best < big)

    if mutual:
        nn1 = torch.argmin(d2, dim=0)  # (K1,)
        ok = ok & (nn1[nn0] == torch.arange(k0, device=dev))

    matches0 = torch.where(ok, nn0, torch.full_like(nn0, -1)).int()
    dists = torch.where(ok, torch.sqrt(best),
                        torch.full_like(best, float("inf")))
    return matches0, dists
