"""LightGlue matcher: the module route, the route dispatch, and the glue
both routes share (keypoint normalisation, mutual-argmax match extraction).

Counterpart of ``gisnav_tpu/matching/lightglue.py``. ``LightGlue`` is the
layer-by-layer forward of the flax module over the same converted tree:
rotary self-attention and bidirectional cross-attention blocks with the
module's bf16 rounding points (every ``Dense`` of a block rounds its inputs,
its product and its bias sum to bf16; LayerNorm, gelu, softmax and the
assignment head stay f32). Its attention goes to ``masked_attention`` (the
CUDA kernel on the card) for the shapes ``attention_supported`` names and to
the plain einsum form for all others, as the JAX module does.

``LightGlueMatcher`` picks the route as ``apply_lightglue`` of the JAX
package does: the fused forward (``lightglue_fused``) where
``fused_lightglue_supported`` holds (both keypoint counts multiples of 512),
the module route elsewhere. The choice depends on the shapes alone, so a CPU
tensor takes the route, and through the plain versions the arithmetic, that
a CUDA tensor of the same shape takes.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch
from torch import nn

from gisnav_tpu_torch.matching.attention import (
    attention_supported,
    masked_attention,
    masked_attention_plain,
)

__all__ = ["MatchResult", "normalize_keypoints", "extract_matches",
           "assignment", "LightGlue", "LightGlueMatcher"]

_BF16 = torch.bfloat16
_LN_EPS = 1e-6


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


def _apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved feature pairs: x (K, H, D); cos/sin (K, D/2)."""
    x = x.float()
    x1, x2 = x[..., 0::2], x[..., 1::2]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.stack([x1 * c - x2 * s, x1 * s + x2 * c],
                       dim=-1).reshape(x.shape)


def _attention(q, k, v, mask_k):
    """Masked scaled dot-product attention, q/k/v (K, H, D) -> f32: the
    kernel for the shapes it takes, the JAX module's einsum form for all
    others."""
    if attention_supported(q.shape[0], k.shape[0], q.shape[-1]):
        return masked_attention(q, k, v, mask_k)
    return masked_attention_plain(q, k, v, mask_k, additive_bias=False)


class _Dense(nn.Module):
    """A flax ``Dense`` with ``dtype=bfloat16``: bf16 input, weight and
    bias, the product rounded to bf16 before the bias is added in bf16."""

    def __init__(self, node: Dict[str, torch.Tensor]):
        super().__init__()
        self.register_buffer("w", node["weight"].T.contiguous().to(_BF16))
        self.register_buffer("b", node["bias"].to(_BF16))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x.to(_BF16).float() @ self.w.float()).to(_BF16) + self.b


class _FFN(nn.Module):
    """LightGlue update: x + MLP([x | message])."""

    def __init__(self, node: Dict[str, Any]):
        super().__init__()
        self.fc1, self.fc2 = _Dense(node["fc1"]), _Dense(node["fc2"])
        self.register_buffer("lns", node["norm"]["weight"])
        self.register_buffer("lnb", node["norm"]["bias"])

    def forward(self, x, message):
        y = self.fc1(torch.cat([x, message.float()], dim=-1)).float()
        mu = y.mean(dim=-1, keepdim=True)
        var = torch.clamp((y * y).mean(dim=-1, keepdim=True) - mu * mu,
                          min=0.0)
        y = (y - mu) * torch.rsqrt(var + _LN_EPS) * self.lns + self.lnb
        y = nn.functional.gelu(y, approximate="tanh")
        return x + self.fc2(y).float()


class _SelfBlock(nn.Module):
    def __init__(self, node: Dict[str, Any], dim: int, heads: int):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.wqkv = _Dense(node["Wqkv"])  # columns h*3*dh + comp*dh + d
        self.out_proj = _Dense(node["out_proj"])
        self.ffn = _FFN(node["ffn"])

    def forward(self, x, cos, sin, mask):
        n, h = x.shape[0], self.heads
        qkv = self.wqkv(x).reshape(n, h, 3, self.dim // h)
        q = _apply_rotary(qkv[:, :, 0], cos, sin)
        k = _apply_rotary(qkv[:, :, 1], cos, sin)
        msg = _attention(q, k, qkv[:, :, 2], mask).reshape(n, self.dim)
        return self.ffn(x, self.out_proj(msg))


class _CrossBlock(nn.Module):
    """Bidirectional cross-attention with a shared query/key projection."""

    def __init__(self, node: Dict[str, Any], dim: int, heads: int):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.to_qk, self.to_v = _Dense(node["to_qk"]), _Dense(node["to_v"])
        self.to_out = _Dense(node["to_out"])
        self.ffn = _FFN(node["ffn"])

    def forward(self, x0, x1, mask0, mask1):
        h, dh = self.heads, self.dim // self.heads
        qk0, qk1 = (self.to_qk(x).reshape(-1, h, dh) for x in (x0, x1))
        v0, v1 = (self.to_v(x).reshape(-1, h, dh) for x in (x0, x1))
        m0 = _attention(qk0, qk1, v1, mask1).reshape(-1, self.dim)
        m1 = _attention(qk1, qk0, v0, mask0).reshape(-1, self.dim)
        return (self.ffn(x0, self.to_out(m0)), self.ffn(x1, self.to_out(m1)))


def assignment(x0, x1, mask0, mask1, wf, bf, wm, bm, dim: int,
               threshold: float) -> MatchResult:
    """Double-softmax assignment head with sigmoid matchability (f32);
    ``wf``/``wm`` in (in, out) layout."""
    md0 = (x0 @ wf + bf) / float(dim) ** 0.25
    md1 = (x1 @ wf + bf) / float(dim) ** 0.25
    sim = md0 @ md1.T
    z0 = torch.sigmoid((x0 @ wm + bm)[:, 0])
    z1 = torch.sigmoid((x1 @ wm + bm)[:, 0])
    zero = torch.zeros((), device=x0.device)
    pairmask = mask0[:, None] & mask1[None, :]
    sim = torch.where(pairmask, sim, torch.full_like(zero, -1e9))
    scores = (torch.softmax(sim, dim=1) * torch.softmax(sim, dim=0)
              * (z0[:, None] * z1[None, :]))
    scores = torch.where(pairmask, scores, zero)
    return extract_matches(scores, mask0, mask1, threshold)


class LightGlue(nn.Module):
    """Module-route LightGlue forward over two fixed-size keypoint sets.

    ``params`` is the port's LightGlue tree (``weights.params_from_jax``);
    Wqkv keeps its natural column order ``h*3*dh + comp*dh + d``.
    """

    def __init__(self, params: Dict[str, Any], depth: int = 9,
                 heads: int = 4, dim: int = 256,
                 filter_threshold: float = 0.1):
        super().__init__()
        self.depth, self.heads, self.dim = depth, heads, dim
        self.filter_threshold = filter_threshold

        def dense(name, node):  # f32 Dense, (in, out) layout
            self.register_buffer(name + "_w", node["weight"].T.contiguous())
            if "bias" in node:
                self.register_buffer(name + "_b", node["bias"])

        dense("input_proj", params["input_proj"])
        dense("posenc", params["posenc"]["Wr"])
        dense("final_proj", params["final_proj"])
        dense("matchability", params["matchability"])
        self.self_blocks = nn.ModuleList(
            _SelfBlock(params[f"self_{i}"], dim, heads) for i in range(depth))
        self.cross_blocks = nn.ModuleList(
            _CrossBlock(params[f"cross_{i}"], dim, heads)
            for i in range(depth))

    @torch.no_grad()
    def forward(self, kpts0, desc0, mask0, size0, kpts1, desc1, mask1,
                size1) -> MatchResult:
        x0 = desc0.float() @ self.input_proj_w + self.input_proj_b
        x1 = desc1.float() @ self.input_proj_w + self.input_proj_b
        p0 = normalize_keypoints(kpts0, size0[0], size0[1]) @ self.posenc_w
        p1 = normalize_keypoints(kpts1, size1[0], size1[1]) @ self.posenc_w
        cos0, sin0, cos1, sin1 = (torch.cos(p0), torch.sin(p0),
                                  torch.cos(p1), torch.sin(p1))
        for sb, cb in zip(self.self_blocks, self.cross_blocks):
            x0 = sb(x0, cos0, sin0, mask0)
            x1 = sb(x1, cos1, sin1, mask1)
            x0, x1 = cb(x0, x1, mask0, mask1)
        return assignment(x0, x1, mask0, mask1, self.final_proj_w,
                          self.final_proj_b, self.matchability_w,
                          self.matchability_b, self.dim,
                          self.filter_threshold)


class LightGlueMatcher(nn.Module):
    """Fused or module-route forward, picked per call from the keypoint
    counts as ``apply_lightglue`` of the JAX package picks it. Each route's
    weights are prepared at its first use."""

    def __init__(self, params: Dict[str, Any], depth: int = 9,
                 heads: int = 4, dim: int = 256,
                 filter_threshold: float = 0.1):
        super().__init__()
        self._params = params
        self._kw = dict(depth=depth, heads=heads, dim=dim,
                        filter_threshold=filter_threshold)
        self._routes: Dict[str, nn.Module] = {}

    def route(self, k0: int, k1: int) -> str:
        from gisnav_tpu_torch.matching.lightglue_fused import (
            fused_lightglue_supported,
        )

        fused = fused_lightglue_supported(k0, k1, self._kw["dim"],
                                          self._kw["heads"])
        return "fused" if fused else "module"

    def forward(self, kpts0, desc0, mask0, size0, kpts1, desc1, mask1,
                size1) -> MatchResult:
        name = self.route(kpts0.shape[0], kpts1.shape[0])
        if name not in self._routes:
            from gisnav_tpu_torch.matching import lightglue_fused

            cls = lightglue_fused.LightGlue if name == "fused" else LightGlue
            self._routes[name] = cls(self._params, **self._kw)
        return self._routes[name](kpts0, desc0, mask0, size0, kpts1, desc1,
                                  mask1, size1)
