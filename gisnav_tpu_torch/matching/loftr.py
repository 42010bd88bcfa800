"""Semi-dense detector-free matcher (LoFTR-style).

Counterpart of ``gisnav_tpu/matching/loftr.py``, which runs in XLA with no
Pallas kernel; plain PyTorch on tensors is its port, in f32 throughout
(TF32 off, ``device.strict_fp32``: the dual softmax divides by a 0.1
temperature, and TF32 products move its argmaxes).

1. A shared conv backbone gives fine features at 1/2 (d=128) and coarse
   features at 1/8 (d=256) resolution. Its convs pad as flax's ``"SAME"``:
   a stride-2 3x3 conv on an even side pads (0, 1), not (1, 1).
2. Coarse features + a 2-D sinusoidal position encoding run through
   ``depth`` self/cross blocks of ELU-kernel linear attention.
3. Dual softmax over the coarse similarity, mutual-argmax filtering (first
   index on ties, in both packages) and a top-``max_matches`` selection.
4. Fine refinement: the 5x5 fine-feature window around each coarse match in
   image 1 is correlated with the match's fine feature in image 0 and
   soft-argmaxed to a sub-pixel position, for all matches at once.

``params`` is the port's LoFTR tree (``weights.params_from_jax``): conv
weights f32 OIHW, Dense weights ``(out, in)``, LayerNorm ``weight``/``bias``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["LoFTR", "LoFTRMatches", "param_shapes"]

_LN_EPS = 1e-6  # flax LayerNorm
# (name, input channels, output channels, stride) of the backbone's convs
_BACKBONE = (("stem", 1, 64, 2), ("c1a", 64, 128, 1),
             ("fine_out", 128, 128, 1), ("c2", 128, 192, 2),
             ("c2b", 192, 192, 1), ("c3", 192, 256, 2),
             ("coarse_out", 256, 256, 1))
_STRIDE = {name: stride for name, _, _, stride in _BACKBONE}


class LoFTRMatches(NamedTuple):
    """Fixed-size semi-dense match set (full-resolution pixel xy)."""

    kp0: torch.Tensor  # (M, 2) in image 0
    kp1: torch.Tensor  # (M, 2) in image 1, sub-pixel refined
    confidence: torch.Tensor  # (M,)
    mask: torch.Tensor  # (M,) bool


def param_shapes(dim: int = 256, depth: int = 4) -> Dict[str, Tuple]:
    """``path -> shape`` of the JAX module's parameter tree (flax layout:
    conv kernels HWIO, Dense kernels ``(in, out)``)."""
    shapes: Dict[str, Tuple] = {}
    for name, cin, cout, _ in _BACKBONE:
        shapes[f"backbone/{name}/kernel"] = (3, 3, cin, cout)
        shapes[f"backbone/{name}/bias"] = (cout,)
    dense = {"q": (dim, dim), "k": (dim, dim), "v": (dim, dim),
             "merge": (dim, dim), "fc1": (2 * dim, 2 * dim),
             "fc2": (2 * dim, dim)}
    for i in range(depth):
        for block in (f"self_{i}", f"cross_{i}"):
            for name, (din, dout) in dense.items():
                shapes[f"{block}/{name}/kernel"] = (din, dout)
                shapes[f"{block}/{name}/bias"] = (dout,)
            for name, n in (("norm1", 2 * dim), ("norm2", dim)):
                shapes[f"{block}/{name}/scale"] = (n,)
                shapes[f"{block}/{name}/bias"] = (n,)
    return shapes


def _sine_pos_encoding(h: int, w: int, dim: int,
                       device=None) -> torch.Tensor:
    """2-D sinusoidal position encoding, (h * w, dim): [sin y, cos y, sin x,
    cos x] over ``dim / 4`` frequencies."""
    if dim % 4:
        raise ValueError(f"dim must be a multiple of 4, got {dim}")
    d4 = dim // 4
    step = np.float32(-np.log(np.float32(10000.0))) / np.float32(max(d4 - 1,
                                                                      1))
    freqs = torch.exp(torch.arange(d4, dtype=torch.float32, device=device)
                      * float(step))
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None] * freqs
    xs = torch.arange(w, dtype=torch.float32, device=device)[:, None] * freqs
    pe_y = torch.cat([torch.sin(ys), torch.cos(ys)], dim=-1)
    pe_x = torch.cat([torch.sin(xs), torch.cos(xs)], dim=-1)
    pe = torch.cat([pe_y[:, None, :].expand(h, w, 2 * d4),
                    pe_x[None, :, :].expand(h, w, 2 * d4)], dim=-1)
    return pe.reshape(h * w, dim)


def _linear_attention(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """ELU-kernel linear attention, q (Nq, H, D), k/v (Nk, H, D)
    -> (Nq, H, D)."""
    qp = F.elu(q) + 1.0
    kp = F.elu(k) + 1.0
    kv = torch.einsum("khd,khe->hde", kp, v)
    z = kp.sum(dim=0)
    num = torch.einsum("qhd,hde->qhe", qp, kv)
    den = torch.einsum("qhd,hd->qh", qp, z)[..., None]
    return num / torch.clamp(den, min=1e-6)


def _layer_norm(x, weight, bias):
    """flax ``LayerNorm`` (variance as E[x^2] - E[x]^2, eps 1e-6)."""
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    return (x - mu) * torch.rsqrt(var + _LN_EPS) * weight + bias


class _LoFTRBlock(nn.Module):
    """One attention block (self or cross) with the LoFTR update MLP."""

    def __init__(self, node: Dict[str, Any], dim: int, heads: int):
        super().__init__()
        self.dim, self.heads = dim, heads
        for name in ("q", "k", "v", "merge", "fc1", "fc2", "norm1",
                     "norm2"):
            self.register_buffer(name + "_w", node[name]["weight"])
            self.register_buffer(name + "_b", node[name]["bias"])

    def _p(self, name):
        return getattr(self, name + "_w"), getattr(self, name + "_b")

    def forward(self, x: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
        h, dh = self.heads, self.dim // self.heads
        q = F.linear(x, *self._p("q")).reshape(-1, h, dh)
        k = F.linear(source, *self._p("k")).reshape(-1, h, dh)
        v = F.linear(source, *self._p("v")).reshape(-1, h, dh)
        msg = _linear_attention(q, k, v).reshape(-1, self.dim)
        msg = F.linear(msg, *self._p("merge"))
        y = F.linear(torch.cat([x, msg], dim=-1), *self._p("fc1"))
        y = F.relu(_layer_norm(y, *self._p("norm1")))
        y = F.linear(y, *self._p("fc2"))
        return x + _layer_norm(y, *self._p("norm2"))


def _conv_same(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               stride: int) -> torch.Tensor:
    """3x3 conv of an NCHW batch with flax's ``"SAME"`` padding: the total
    padding ``max((out - 1) * stride + 3 - in, 0)``, its smaller half
    before."""
    pads = []
    for size in (x.shape[-1], x.shape[-2]):  # F.pad order: W, then H
        out = -(-size // stride)
        total = max((out - 1) * stride + 3 - size, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x, pads), weight, bias, stride=stride)


class _Backbone(nn.Module):
    """Conv pyramid: fine (1/2, d=128) and coarse (1/8, d=256) features."""

    def __init__(self, node: Dict[str, Dict[str, torch.Tensor]]):
        super().__init__()
        for name, _, _, _ in _BACKBONE:
            self.register_buffer(name + "_w", node[name]["weight"])
            self.register_buffer(name + "_b", node[name]["bias"])

    def _conv(self, name, x):
        return _conv_same(x, getattr(self, name + "_w"),
                          getattr(self, name + "_b"), _STRIDE[name])

    def forward(self, image: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(H, W) image -> fine (H/2, W/2, 128), coarse (H/8, W/8, 256)."""
        x = image[None, None].float()
        x = F.relu(self._conv("stem", x))
        x = F.relu(self._conv("c1a", x))
        fine = self._conv("fine_out", x)
        x = F.relu(self._conv("c2", x))
        x = F.relu(self._conv("c2b", x))
        x = F.relu(self._conv("c3", x))
        coarse = self._conv("coarse_out", x)
        return fine[0].permute(1, 2, 0), coarse[0].permute(1, 2, 0)


class LoFTR(nn.Module):
    """Semi-dense matcher over an image pair (sides multiples of 8)."""

    def __init__(self, params: Dict[str, Any], dim: int = 256,
                 heads: int = 8, depth: int = 4, max_matches: int = 1024,
                 temperature: float = 0.1,
                 confidence_threshold: float = 0.2, window: int = 5):
        super().__init__()
        self.dim, self.heads, self.depth = dim, heads, depth
        self.max_matches = max_matches
        self.temperature = temperature
        self.confidence_threshold = confidence_threshold
        self.window = window
        self.backbone = _Backbone(params["backbone"])
        self.self_blocks = nn.ModuleList(
            _LoFTRBlock(params[f"self_{i}"], dim, heads)
            for i in range(depth))
        self.cross_blocks = nn.ModuleList(
            _LoFTRBlock(params[f"cross_{i}"], dim, heads)
            for i in range(depth))

    @torch.no_grad()
    def forward(self, image0: torch.Tensor,
                image1: torch.Tensor) -> LoFTRMatches:
        h0, w0 = image0.shape
        h1, w1 = image1.shape
        fine0, coarse0 = self.backbone(image0)
        fine1, coarse1 = self.backbone(image1)
        hc0, wc0 = coarse0.shape[:2]
        hc1, wc1 = coarse1.shape[:2]
        dev = coarse0.device
        f0 = coarse0.reshape(hc0 * wc0, self.dim) + _sine_pos_encoding(
            hc0, wc0, self.dim, dev)
        f1 = coarse1.reshape(hc1 * wc1, self.dim) + _sine_pos_encoding(
            hc1, wc1, self.dim, dev)
        for sb, cb in zip(self.self_blocks, self.cross_blocks):
            f0, f1 = sb(f0, f0), sb(f1, f1)
            f0, f1 = cb(f0, f1), cb(f1, f0)

        # dual-softmax coarse assignment, mutual argmax
        f0n = f0 / torch.clamp(torch.linalg.norm(f0, dim=-1, keepdim=True),
                               min=1e-6)
        f1n = f1 / torch.clamp(torch.linalg.norm(f1, dim=-1, keepdim=True),
                               min=1e-6)
        sim = (f0n @ f1n.T) / self.temperature
        p = torch.softmax(sim, dim=1) * torch.softmax(sim, dim=0)
        n0 = hc0 * wc0
        best1 = torch.argmax(p, dim=1)
        score = p.amax(dim=1)
        best0 = torch.argmax(p, dim=0)
        mutual = best0[best1] == torch.arange(n0, device=dev)
        score = torch.where(mutual, score, torch.zeros_like(score))

        conf, idx0 = torch.topk(score, self.max_matches)
        idx1 = best1[idx0]
        valid = conf > self.confidence_threshold
        kp0 = torch.stack([(idx0 % wc0 + 0.5) * (w0 / wc0),
                           (idx0 // wc0 + 0.5) * (h0 / hc0)], dim=1)
        kp1c = torch.stack([(idx1 % wc1 + 0.5) * (w1 / wc1),
                            (idx1 // wc1 + 0.5) * (h1 / hc1)], dim=1)
        kp1 = self._refine(fine0, fine1, kp0, kp1c)
        return LoFTRMatches(kp0=kp0, kp1=kp1, confidence=conf, mask=valid)

    def _refine(self, fine0, fine1, kp0, kp1c):
        """Correlate each match's 5x5 fine window in image 1 with its fine
        feature in image 0; soft-argmax the offset (1/2-resolution cells,
        corners clipped into the map, centres truncated toward zero as
        ``astype(int32)`` does)."""
        wsz = self.window
        r = wsz // 2
        hf0, wf0, d = fine0.shape
        hf1, wf1, _ = fine1.shape
        c0 = (kp0 / 2.0).to(torch.int32).long()
        c1 = (kp1c / 2.0).to(torch.int32).long()
        center = fine0[torch.clamp(c0[:, 1], 0, hf0 - 1),
                       torch.clamp(c0[:, 0], 0, wf0 - 1)]  # (M, d)
        y0 = torch.clamp(c1[:, 1] - r, 0, hf1 - wsz)
        x0 = torch.clamp(c1[:, 0] - r, 0, wf1 - wsz)
        taps = torch.arange(wsz, device=fine1.device)
        win = fine1[(y0[:, None] + taps)[:, :, None],
                    (x0[:, None] + taps)[:, None, :]]  # (M, w, w, d)
        corr = torch.einsum("mijd,md->mij", win, center) / math.sqrt(d)
        prob = torch.softmax(corr.reshape(-1, wsz * wsz), dim=-1).reshape(
            -1, wsz, wsz)
        tf = taps.float()
        dy = (prob * tf[None, :, None]).sum(dim=(1, 2)) - r
        dx = (prob * tf[None, None, :]).sum(dim=(1, 2)) - r
        return kp1c + 2.0 * torch.stack([dx, dy], dim=1)
