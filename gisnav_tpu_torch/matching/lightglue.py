"""LightGlue glue shared by the fused forward: keypoint normalisation and
mutual-argmax match extraction.

Counterpart of ``gisnav_tpu/matching/lightglue.py`` (``normalize_keypoints``,
``_extract_matches``, ``MatchResult``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["MatchResult", "normalize_keypoints", "extract_matches"]


class MatchResult(NamedTuple):
    """``matches0[i]`` is the set-1 index matched to keypoint i of set 0,
    or -1; ``mscores0[i]`` its confidence."""

    matches0: torch.Tensor  # (K0,) int64
    matches1: torch.Tensor  # (K1,) int64
    mscores0: torch.Tensor  # (K0,) f32
    mscores1: torch.Tensor  # (K1,) f32
    scores: torch.Tensor  # (K0, K1) assignment probabilities


def normalize_keypoints(kpts: torch.Tensor, height: int,
                        width: int) -> torch.Tensor:
    """Centre and scale pixel coords to ~[-1, 1] (LightGlue convention)."""
    size = torch.tensor([width, height], dtype=torch.float32,
                        device=kpts.device)
    return (kpts - size / 2.0) / (torch.max(size) / 2.0)


def extract_matches(scores: torch.Tensor, mask0: torch.Tensor,
                    mask1: torch.Tensor, threshold: float) -> MatchResult:
    """Mutual argmax with a confidence threshold (first index on ties)."""
    k0, k1 = scores.shape
    m0, s0 = torch.argmax(scores, dim=1), torch.amax(scores, dim=1)
    m1, s1 = torch.argmax(scores, dim=0), torch.amax(scores, dim=0)
    mutual0 = torch.arange(k0, device=scores.device) == m1[m0]
    mutual1 = torch.arange(k1, device=scores.device) == m0[m1]
    ok0 = mutual0 & (s0 > threshold) & mask0
    ok1 = mutual1 & (s1 > threshold) & mask1
    neg = torch.tensor(-1, device=scores.device)
    zero = torch.zeros((), device=scores.device)
    return MatchResult(
        matches0=torch.where(ok0, m0, neg),
        matches1=torch.where(ok1, m1, neg),
        mscores0=torch.where(ok0, s0, zero),
        mscores1=torch.where(ok1, s1, zero),
        scores=scores,
    )
