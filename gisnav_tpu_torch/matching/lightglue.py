"""LightGlue matcher: the module route, the route dispatch, and the glue
both routes share (keypoint normalisation, mutual-argmax match extraction).

Counterpart of ``gisnav_tpu/matching/lightglue.py``. ``lightglue_forward``
is the flax module's forward over the converted tree, with a leading pair
axis in place of the JAX package's vmap over pairs: rotary self-attention
and bidirectional cross-attention blocks with the module's bf16 rounding
points (every ``Dense`` of a block rounds its inputs, its product and its
bias sum to bf16; LayerNorm, gelu, softmax and the assignment head stay
f32). Each attention of a layer is one pair-batched call of
``MaskedAttention`` (the CUDA kernel on the card, with the JAX package's
analytic backward) for the shapes ``attention_supported`` names, and the
plain einsum form under autograd for all others, as the JAX module routes
them. Nothing is detached, so training takes its gradient through
``scores`` from the f32 masters, each cast at use as ``Dense(dtype=
bfloat16)`` casts it. ``LightGlue`` is the same forward for one pair,
without a gradient, over the tree with its bf16 weights rounded once.

``LightGlueMatcher`` picks the route as ``apply_lightglue`` of the JAX
package does: the fused forward (``lightglue_fused``) where
``fused_lightglue_supported`` holds (both keypoint counts multiples of 512),
the module route elsewhere. The choice depends on the shapes alone, so a CPU
tensor takes the route, and through the plain versions the arithmetic, that
a CUDA tensor of the same shape takes. ``apply_lightglue`` and
``match_features`` are the JAX package's functional entry points over it:
the matcher of the last tree called with is kept, so each route's weights
are laid out once for a tree called over and over, not at every match; a
caller may pass a ``LightGlueMatcher`` of their own in the tree's place.

Every Dense product of both routes that the JAX package computes outside a
Pallas kernel goes through ``parallel.tp.product``: on a tree from
``parallel.mesh.shard_params_tp`` with a ``model`` axis above 1 its weight
is sharded and the product is formed output slice by slice, each on its
shard's device; on a plain tree it is one product.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch
from torch import nn

from gisnav_tpu_torch.device import resolve_device
from gisnav_tpu_torch.matching.attention import attention_with_grad
from gisnav_tpu_torch.parallel.tp import (
    Sharded,
    leaves,
    map_tree,
    product,
    whole,
)

__all__ = ["MatchResult", "normalize_keypoints", "extract_matches",
           "assignment", "LightGlue", "LightGlueMatcher", "lightglue_forward",
           "apply_lightglue", "match_features"]

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
    """Centre and scale pixel coords to ~[-1, 1] (LightGlue convention).
    The size is filled on the device (no host copy: a CUDA graph holds
    this)."""
    size = torch.full((2,), float(width), dtype=torch.float32,
                      device=kpts.device)
    size[1:].fill_(float(height))
    return (kpts - size / 2.0) / (torch.max(size) / 2.0)


def extract_matches(scores: torch.Tensor, mask0: torch.Tensor,
                    mask1: torch.Tensor, threshold: float) -> MatchResult:
    """Mutual argmax with a confidence threshold (first index on ties), of
    one (K0, K1) score matrix or of a (B, K0, K1) batch."""
    k0, k1 = scores.shape[-2:]
    m0, s0 = torch.argmax(scores, dim=-1), torch.amax(scores, dim=-1)
    m1, s1 = torch.argmax(scores, dim=-2), torch.amax(scores, dim=-2)
    mutual0 = torch.arange(k0, device=scores.device) == torch.gather(
        m1, -1, m0)
    mutual1 = torch.arange(k1, device=scores.device) == torch.gather(
        m0, -1, m1)
    ok0 = mutual0 & (s0 > threshold) & mask0
    ok1 = mutual1 & (s1 > threshold) & mask1
    neg = torch.full((), -1, dtype=torch.int64, device=scores.device)
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
    """Rotate interleaved feature pairs: x (..., K, H, D); cos/sin (..., K,
    D/2); f32."""
    x = x.float()
    x1, x2 = x[..., 0::2], x[..., 1::2]
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.stack([x1 * c - x2 * s, x1 * s + x2 * c],
                       dim=-1).reshape(x.shape)


def _attention(q, k, v, mask_k):
    """Masked scaled dot-product attention, q/k/v (B, K, H, D) -> f32, with
    its gradient: the kernel's Function for the shapes it takes, the JAX
    module's einsum form for all others."""
    return attention_with_grad(q, k, v, mask_k)


def _bf16_body(x, w, b):
    w = w.to(_BF16).float()
    return (x.to(_BF16).float() @ w.T).to(_BF16) + b.to(_BF16)


def _f32_body(x, w, b):
    y = x @ w.T
    return y if b is None else y + b


def _affine(x, w, b):
    """``x @ w + b`` of a weight in (in, out) layout."""
    return x @ w + b


def _dense_bf16(x: torch.Tensor, node: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
    """flax ``Dense(dtype=bfloat16)``: input, weight and bias rounded to
    bf16, the product formed in f32 and rounded once to bf16 (as XLA forms a
    bf16 dot), the bias added in bf16. The weight may be an f32 master or
    already bf16, whole or sharded; every cast passes the gradient."""
    return product(x, node["weight"], node["bias"], _bf16_body)


def _dense_f32(x: torch.Tensor, node: Dict[str, torch.Tensor]
               ) -> torch.Tensor:
    return product(x, node["weight"], node.get("bias"), _f32_body)


def _layer_norm(y: torch.Tensor, node: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
    """flax ``LayerNorm(dtype=float32)``: fast variance, clamped at 0 (a
    sharded scale or bias gathered whole)."""
    y = y.float()
    mu = y.mean(dim=-1, keepdim=True)
    var = torch.clamp((y * y).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    return (y - mu) * torch.rsqrt(var + _LN_EPS) * \
        whole(node["weight"], y.device) + whole(node["bias"], y.device)


def _ffn(node, x, message):
    """LightGlue update: x + MLP([x | message])."""
    y = _dense_bf16(torch.cat([x, message.float()], dim=-1), node["fc1"])
    y = nn.functional.gelu(_layer_norm(y, node["norm"]), approximate="tanh")
    return x + _dense_bf16(y, node["fc2"]).float()


def _self_block(node, x, cos, sin, mask, heads):
    """Rotary self-attention; Wqkv's columns are h*3*dh + comp*dh + d."""
    b, n, dim = x.shape
    qkv = _dense_bf16(x, node["Wqkv"]).reshape(b, n, heads, 3, dim // heads)
    q = _apply_rotary(qkv[..., 0, :], cos, sin)
    k = _apply_rotary(qkv[..., 1, :], cos, sin)
    msg = _attention(q, k, qkv[..., 2, :], mask).reshape(b, n, dim)
    return _ffn(node["ffn"], x, _dense_bf16(msg, node["out_proj"]))


def _cross_block(node, x0, x1, mask0, mask1, heads):
    """Bidirectional cross-attention with a shared query/key projection."""
    b, _, dim = x0.shape
    qk0, qk1 = (_dense_bf16(x, node["to_qk"]).reshape(b, -1, heads,
                                                       dim // heads)
                for x in (x0, x1))
    v0, v1 = (_dense_bf16(x, node["to_v"]).reshape(b, -1, heads,
                                                    dim // heads)
              for x in (x0, x1))
    m0 = _attention(qk0, qk1, v1, mask1).reshape(b, -1, dim)
    m1 = _attention(qk1, qk0, v0, mask0).reshape(b, -1, dim)
    return (_ffn(node["ffn"], x0, _dense_bf16(m0, node["to_out"])),
            _ffn(node["ffn"], x1, _dense_bf16(m1, node["to_out"])))


def assignment(x0, x1, mask0, mask1, wf, bf, wm, bm, dim: int,
               threshold: float) -> MatchResult:
    """Double-softmax assignment head with sigmoid matchability (f32), of
    one pair or of a leading pair axis; ``wf``/``wm`` in (in, out)
    layout, whole or sharded."""
    md0 = product(x0, wf, bf, _affine) / float(dim) ** 0.25
    md1 = product(x1, wf, bf, _affine) / float(dim) ** 0.25
    sim = md0 @ md1.transpose(-1, -2)
    z0 = torch.sigmoid(product(x0, wm, bm, _affine)[..., 0])
    z1 = torch.sigmoid(product(x1, wm, bm, _affine)[..., 0])
    zero = torch.zeros((), device=x0.device)
    pairmask = mask0[..., :, None] & mask1[..., None, :]
    sim = torch.where(pairmask, sim, torch.full_like(zero, -1e9))
    scores = (torch.softmax(sim, dim=-1) * torch.softmax(sim, dim=-2)
              * (z0[..., :, None] * z1[..., None, :]))
    scores = torch.where(pairmask, scores, zero)
    return extract_matches(scores, mask0, mask1, threshold)


def lightglue_forward(params: Dict[str, Any], kpts0, desc0, mask0, size0,
                      kpts1, desc1, mask1, size1, *, depth: int,
                      heads: int = 4, dim: int = 256,
                      filter_threshold: float = 0.0) -> MatchResult:
    """The flax module's forward over B pairs of keypoint sets: kpts (B, K,
    2), desc (B, K, 256), mask (B, K), sizes (h, w). ``params`` is the
    port's LightGlue tree, f32 masters for training (or, for inference, its
    bf16-``Dense`` weights already rounded). Returns a batched
    :class:`MatchResult` whose ``scores`` (B, K0, K1) is differentiable."""
    x0 = _dense_f32(desc0.float(), params["input_proj"])
    x1 = _dense_f32(desc1.float(), params["input_proj"])
    p0 = _dense_f32(normalize_keypoints(kpts0, size0[0], size0[1]),
                    params["posenc"]["Wr"])
    p1 = _dense_f32(normalize_keypoints(kpts1, size1[0], size1[1]),
                    params["posenc"]["Wr"])
    cos0, sin0, cos1, sin1 = (torch.cos(p0), torch.sin(p0), torch.cos(p1),
                              torch.sin(p1))
    for i in range(depth):
        node = params[f"self_{i}"]
        x0 = _self_block(node, x0, cos0, sin0, mask0, heads)
        x1 = _self_block(node, x1, cos1, sin1, mask1, heads)
        x0, x1 = _cross_block(params[f"cross_{i}"], x0, x1, mask0, mask1,
                              heads)
    fp, mp = params["final_proj"], params["matchability"]
    return assignment(x0, x1, mask0, mask1, fp["weight"].T, fp["bias"],
                      mp["weight"].T, mp["bias"], dim, filter_threshold)


_BF16_DENSE = {"self": ("Wqkv", "out_proj"), "cross": ("to_qk", "to_v",
                                                         "to_out")}


def _in_out(node: Dict[str, torch.Tensor], dtype=None
            ) -> Dict[str, torch.Tensor]:
    """A Dense node whose weight is stored in (in, out) layout, the layout
    the matmul reads, and seen through ``.T`` in the tree's (out, in);
    a sharded leaf shard by shard."""
    def each(t, fn):
        return t.map(fn) if isinstance(t, Sharded) else fn(t)

    out = {k: each(v, lambda t: t.to(dtype or t.dtype))
           for k, v in node.items()}
    out["weight"] = each(out["weight"], lambda t: t.T.contiguous().T)
    return out


class LightGlue(nn.Module):
    """Module-route LightGlue forward over two fixed-size keypoint sets:
    :func:`lightglue_forward` for one pair, without a gradient.

    ``params`` is the port's LightGlue tree (``weights.params_from_jax``).
    The weights of its bf16 ``Dense`` layers are rounded to bf16 once here,
    which ``lightglue_forward`` would do at every use, and every weight is
    stored in the (in, out) layout that the matmul reads.
    """

    def __init__(self, params: Dict[str, Any], depth: int = 9,
                 heads: int = 4, dim: int = 256,
                 filter_threshold: float = 0.1):
        super().__init__()
        self.depth, self.heads, self.dim = depth, heads, dim
        self.filter_threshold = filter_threshold
        tree = dict(params)
        for name in ("input_proj", "final_proj", "matchability"):
            tree[name] = _in_out(params[name])
        tree["posenc"] = {"Wr": _in_out(params["posenc"]["Wr"])}
        for i in range(depth):
            for kind, names in _BF16_DENSE.items():
                node = dict(params[f"{kind}_{i}"])
                for name in names:
                    node[name] = _in_out(node[name], _BF16)
                node["ffn"] = {**node["ffn"],
                               "fc1": _in_out(node["ffn"]["fc1"], _BF16),
                               "fc2": _in_out(node["ffn"]["fc2"], _BF16)}
                tree[f"{kind}_{i}"] = node
        self._tree = tree

    @torch.no_grad()
    def forward(self, kpts0, desc0, mask0, size0, kpts1, desc1, mask1,
                size1) -> MatchResult:
        res = lightglue_forward(
            self._tree, kpts0[None], desc0[None], mask0[None], size0,
            kpts1[None], desc1[None], mask1[None], size1, depth=self.depth,
            heads=self.heads, dim=self.dim,
            filter_threshold=self.filter_threshold)
        return MatchResult(*(t[0] for t in res))


class LightGlueMatcher(nn.Module):
    """Fused or module-route forward, picked per call from the keypoint
    counts as ``apply_lightglue`` of the JAX package picks it. Each route's
    weights are prepared at its first use."""

    def __init__(self, params: Dict[str, Any], depth: int = 9,
                 heads: int = 4, dim: int = 256,
                 filter_threshold: float = 0.1):
        super().__init__()
        self.depth, self.heads, self.dim = depth, heads, dim
        self.filter_threshold = filter_threshold
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


# the matcher of apply_lightglue / match_features: the last tree called
# with, (key, leaf state, tree, matcher); holding the tree keeps its id its own
_LAST: list = [None]


def _leaf_state(params) -> tuple:
    """Each leaf's identity and, for a tensor, its version counter, which
    an in-place operation on the tensor advances. Writes that bypass the
    counter (through ``.data``, or a CUDA graph's replay writing the leaf)
    leave it as it was."""
    return tuple((id(t), t._version) if isinstance(t, torch.Tensor)
                 else id(t) for t in leaves(params))


def _matcher_for(params, device: torch.device, depth: int, heads: int,
                 dim: int, filter_threshold: float) -> LightGlueMatcher:
    """``params`` itself where it is a :class:`LightGlueMatcher` of this
    configuration; else the matcher of the tree (carried to ``device``),
    built at its first use and kept while the same tree is called with in
    the same configuration on the same device and :func:`_leaf_state`
    holds. One tree is kept: a caller who switches between trees, or writes
    their leaves past the version counter, holds a matcher of their own."""
    config = (depth, heads, dim, float(filter_threshold))
    if isinstance(params, LightGlueMatcher):
        held = (params.depth, params.heads, params.dim,
                float(params.filter_threshold))
        if held != config:
            raise ValueError(f"the matcher's (depth, heads, dim, threshold) "
                             f"{held} is not the call's {config}")
        return params
    key = (id(params), device, config)
    state = _leaf_state(params)
    last = _LAST[0]
    if last is None or last[0] != key or last[1] != state:
        on_device = map_tree(lambda t: t.to(device) if isinstance(
            t, torch.Tensor) else t, params)
        last = (key, state, params, LightGlueMatcher(
            on_device, depth=depth, heads=heads, dim=dim,
            filter_threshold=filter_threshold))
        _LAST[0] = last
    return last[3]


def apply_lightglue(model, params, kpts0, desc0, mask0, size0, kpts1,
                    desc1, mask1, size1) -> MatchResult:
    """Match two fixed-size keypoint sets by the route the JAX package's
    ``apply_lightglue`` takes on an accelerator: the fused forward (the
    block kernel on the card) where ``fused_lightglue_supported`` holds for
    the two set sizes, the module route (the masked attention kernel)
    elsewhere.

    ``model`` gives the configuration only (``depth``, ``heads``, ``dim``,
    ``filter_threshold``: a :class:`LightGlue`, a :class:`LightGlueMatcher`
    or the fused ``LightGlue``), as the flax module does in the JAX
    package; ``params`` is the port's LightGlue tree
    (``weights.params_from_jax(tree, device)["lightglue"]``) or a
    :class:`LightGlueMatcher` of that configuration. It runs on the
    keypoints' device.

    The matcher of a tree is kept for the next call with the same tree,
    configuration and device, and built anew when a leaf is replaced or an
    in-place operation advances its version counter. A write that bypasses
    the counter (through ``.data``, or a CUDA graph's replay writing the
    leaves) is not seen and the fused route keeps the old weights: after
    one, pass a ``LightGlueMatcher`` built on the updated tree."""
    matcher = _matcher_for(params, kpts0.device, model.depth, model.heads,
                           model.dim, model.filter_threshold)
    return matcher(kpts0, desc0, mask0, size0, kpts1, desc1, mask1, size1)


def match_features(params, feats0, size0, feats1, size1, *,
                   input_dim: int = 256, depth: int = 9,
                   filter_threshold: float = 0.1,
                   device=None) -> MatchResult:
    """Match two ``SuperPointFeatures``-like sets (``keypoints``,
    ``descriptors``, ``mask``; tensors or arrays), the JAX package's
    functional entry point: :func:`apply_lightglue` with a LightGlue of
    ``depth`` layers, 4 heads and width 256. ``size0`` / ``size1`` are the
    images' (height, width); ``params`` is the port's LightGlue tree, whose
    input projection must take ``input_dim`` descriptors, or a
    :class:`LightGlueMatcher` of that configuration on ``device`` (which
    matcher is kept, and when it is built anew, is
    :func:`apply_lightglue`'s).

    Runs on ``device``: ``cuda`` unless the caller passes ``cpu`` (where
    the kernels' plain versions run); without a card it raises."""
    dev = resolve_device(device)
    tree = params._params if isinstance(params, LightGlueMatcher) else params
    w = tree["input_proj"]["weight"]  # (out, in), or sharded on out
    width = (w.shards[0] if isinstance(w, Sharded) else w).shape[-1]
    if width != input_dim:
        raise ValueError(f"the tree's input projection takes {width}-dim "
                         f"descriptors, not input_dim={input_dim}")

    def on(feats):
        return [torch.as_tensor(getattr(feats, f), device=dev)
                for f in ("keypoints", "descriptors", "mask")]

    matcher = _matcher_for(params, dev, depth, 4, 256, filter_threshold)
    return matcher(*on(feats0), size0, *on(feats1), size1)
