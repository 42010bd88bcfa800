"""SuperPoint keypoint detector + descriptor (learned detector head).

Counterpart of ``gisnav_tpu/features/superpoint.py`` on its per-image route:
the VGG trunk runs as four fused stages (``features.conv``), the 3x3 heads
through the same conv kernel, and the 1x1 heads as f32 matmuls of the bf16
activations (plain matmuls outside the kernels, as in the JAX package). The
detector is a 65-channel softmax decoded by 8x8 pixel shuffle; descriptors
are L2-normalised and sampled bilinearly at the keypoints.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
from torch import nn

from gisnav_tpu_torch.features.conv import conv_stage, stem_stage
from gisnav_tpu_torch.features.nms import (
    select_keypoints,
    select_keypoints_tiled,
)

__all__ = ["SuperPoint", "SuperPointFeatures", "sample_descriptors"]

_CONVS = ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b",
          "conv4a", "conv4b", "convPa", "convDa")


class SuperPointFeatures(NamedTuple):
    keypoints: torch.Tensor  # (K, 2) f32 pixel xy
    scores: torch.Tensor  # (K,)
    descriptors: torch.Tensor  # (K, 256) L2-normalised
    mask: torch.Tensor  # (K,) bool


def _rsqrt_normalize(v: torch.Tensor) -> torch.Tensor:
    return v * torch.rsqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-12)


def sample_descriptors(kpts: torch.Tensor, dmap: torch.Tensor,
                       stride: int = 8) -> torch.Tensor:
    """Bilinear sample of the (hc, wc, D) descriptor map at pixel keypoints
    (cell centres at stride/2 - 0.5), re-normalised."""
    hc, wc, _ = dmap.shape
    gx = (kpts[:, 0] - stride / 2 + 0.5) / stride
    gy = (kpts[:, 1] - stride / 2 + 0.5) / stride
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    fx = (gx - x0)[:, None]
    fy = (gy - y0)[:, None]
    x0 = torch.clamp(x0.long(), 0, wc - 1)
    y0 = torch.clamp(y0.long(), 0, hc - 1)
    x1 = torch.clamp(x0 + 1, 0, wc - 1)
    y1 = torch.clamp(y0 + 1, 0, hc - 1)
    out = (dmap[y0, x0] * (1 - fx) * (1 - fy) + dmap[y0, x1] * fx * (1 - fy)
           + dmap[y1, x0] * (1 - fx) * fy + dmap[y1, x1] * fx * fy)
    return _rsqrt_normalize(out)


class SuperPoint(nn.Module):
    """SuperPoint forward for one (H, W) f32 image in [0, 1], or a (B, H, W)
    batch run image by image (the batch is 1-2 in every pipeline mode) with
    every output stacked; H, W % 8 == 0.

    ``params`` is the port's SuperPoint tree (``weights.params_from_jax``):
    3x3 kernels ``(9, Cin, Cout)`` bf16, 1x1 kernels in Linear layout.
    ``select_tiles`` other than (1, 1) splits the keypoint budget evenly
    over that grid (``select_keypoints_tiled``), for large reference rasters.
    """

    def __init__(self, params: Dict[str, Dict[str, torch.Tensor]],
                 max_keypoints: int = 1024, score_threshold: float = 0.0005,
                 select_tiles: Tuple[int, int] = (1, 1)):
        super().__init__()
        self.max_keypoints = max_keypoints
        self.score_threshold = score_threshold
        self.select_tiles = tuple(select_tiles)
        for name in _CONVS + ("convPb", "convDb"):
            self.register_buffer(name + "_w", params[name]["weight"])
            self.register_buffer(name + "_b", params[name]["bias"])

    def _p(self, name):
        return getattr(self, name + "_w"), getattr(self, name + "_b")

    @torch.no_grad()
    def forward(self, image: torch.Tensor) -> SuperPointFeatures:
        if image.dim() == 3:
            per_image = [self.forward(im) for im in image]
            return SuperPointFeatures(*(torch.stack(f)
                                        for f in zip(*per_image)))
        h, w = image.shape
        v = stem_stage(image.float(), *self._p("conv1a"), *self._p("conv1b"),
                       pool=True)
        v = conv_stage(v, *self._p("conv2a"), *self._p("conv2b"), pool=True)
        v = conv_stage(v, *self._p("conv3a"), *self._p("conv3b"), pool=True)
        v = conv_stage(v, *self._p("conv4a"), *self._p("conv4b"), pool=False)
        hc, wc = h // 8, w // 8

        wpb, bpb = self._p("convPb")
        cpa = conv_stage(v, *self._p("convPa"))
        logits = cpa.float() @ wpb.float().T + bpb
        probs = torch.softmax(logits, dim=-1)[..., :64]
        heatmap = probs.reshape(hc, wc, 8, 8).permute(0, 2, 1, 3)
        heatmap = heatmap.reshape(h, w)

        wdb, bdb = self._p("convDb")
        cda = conv_stage(v, *self._p("convDa"))
        dmap = _rsqrt_normalize(cda.float() @ wdb.float().T + bdb)

        if self.select_tiles != (1, 1):
            kpts, scores, valid = select_keypoints_tiled(
                heatmap, self.max_keypoints, self.select_tiles,
                self.score_threshold)
        else:
            kpts, scores, valid = select_keypoints(
                heatmap, self.max_keypoints, self.score_threshold)
        return SuperPointFeatures(kpts, scores,
                                  sample_descriptors(kpts, dmap), valid)
