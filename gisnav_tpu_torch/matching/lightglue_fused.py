"""Fused LightGlue forward: one CUDA block kernel per attention stage.

Counterpart of ``gisnav_tpu/matching/lightglue_fused.py``. The same
computation over the same (converted) parameters:

- input projection and the Fourier rotary encoding;
- rotary folded into a column-permuted Wqkv ``[q, swap(q), k, swap(k), v]``
  (``swap(x @ W + b) == x @ (W P) + b P``), so rotation is two elementwise
  multiply-adds;
- with equal set sizes both residual streams stay concatenated and each
  self/cross stage is ONE ``fused_block`` call with ``sets=2`` (the cross
  stage picks the opposite key half inside the kernel);
- the double-softmax assignment head with sigmoid matchability.

Every bf16 cast of the JAX forward is mirrored: qkv and its bias in bf16, the
rotated q/k rounded to bf16, and inside the block the rounding points of
``_block_reference``. ``fused_block`` runs ``fused_block_plain`` for CPU
tensors and for CUDA tensors makes the two launches of
``kernels/lightglue_block.cu``: the attention, its keys split
``attention.key_splits`` ways over a thread-block cluster, then the FFN
epilogue. Its gradient recomputes through ``fused_block_plain``, as the JAX
package's ``custom_vjp`` does through ``_block_reference``.

On a tree from ``parallel.mesh.shard_params_tp`` with a ``model`` axis above
1, the Dense products the JAX package computes outside its kernel (the input
and positional projections, Wqkv, the cross block's ``wcat``, ``final_proj``
and the matchability head) go through ``parallel.tp.product``, each output
slice on its shard's device; Wqkv and ``wcat`` are gathered, permuted or
concatenated, and cut again over the same devices. The block's own weights
are gathered whole onto the device where the block runs.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from gisnav_tpu_torch.kernels import LAUNCHES
from gisnav_tpu_torch.kernels.build import (
    check,
    check_device,
    library,
    on_device,
    ptr,
    stream_of,
    typed,
)
from gisnav_tpu_torch.matching.attention import key_splits
from gisnav_tpu_torch.matching.lightglue import (
    MatchResult,
    _affine,
    assignment,
    normalize_keypoints,
)
from gisnav_tpu_torch.parallel.tp import Sharded, product, tree_device, whole

__all__ = ["fused_block", "fused_block_plain", "fused_lightglue_supported",
           "LightGlue"]

_BLK_Q = 512
_LN_EPS = 1e-6
_BF16 = torch.bfloat16


def fused_lightglue_supported(k0: int, k1: int, dim: int,
                              heads: int) -> bool:
    """The shapes the fused forward serves (the JAX package's predicate);
    all others take the module route (``lightglue.LightGlueMatcher``)."""
    return (dim == 256 and heads == 4 and k0 % _BLK_Q == 0
            and k1 % _BLK_Q == 0
            and max(k0, k1) * dim * 2 * 2 <= 16 * 1024 * 1024)


def _r(t: torch.Tensor) -> torch.Tensor:
    """Round f32 to bf16 and back."""
    return t.to(_BF16).float()


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    c = float(np.sqrt(2.0 / np.pi).astype(np.float32))
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))


# ---------------------------------------------------------------------------
# the block: plain version and CUDA kernel
# ---------------------------------------------------------------------------


def _block_plain(x, q, k, v, bias_k, wout, bout, w1x, w1m, b1, lns, lnb, w2,
                 b2, heads):
    kq, dim = x.shape
    kk = k.shape[0]
    dh = dim // heads
    scale = 1.0 / float(dh) ** 0.5
    qh = q.float().reshape(kq, heads, dh).transpose(0, 1)
    kh = k.float().reshape(kk, heads, dh).transpose(0, 1)
    vh = v.float().reshape(kk, heads, dh).transpose(0, 1)
    logits = (qh @ kh.transpose(1, 2)) * scale + bias_k.reshape(1, 1, kk)
    p = torch.softmax(logits, dim=-1)
    msg = (_r(p) @ vh).transpose(0, 1).reshape(kq, dim)
    m2 = _r(_r(msg) @ wout.float() + bout)
    y = _r(_r(x.float()) @ w1x.float() + m2 @ w1m.float() + b1)
    mu = y.mean(dim=1, keepdim=True)
    var = torch.clamp((y * y).mean(dim=1, keepdim=True) - mu * mu, min=0.0)
    yn = (y - mu) * torch.rsqrt(var + _LN_EPS) * lns + lnb
    y2 = _r(_r(_gelu_tanh(yn)) @ w2.float() + b2)
    return x.float() + y2


def fused_block_plain(x, q, k, v, bias, wout, bout, w1x, w1m, b1, lns, lnb,
                      w2, b2, *, heads: int = 4, sets: int = 1,
                      cross: bool = False) -> torch.Tensor:
    """x + FFN([x | out_proj(attn(q, k, v))]) over ``sets`` concatenated
    streams; query half s attends key half s, or 1 - s with ``cross``.

    x (sets*Kq, dim) f32; q (sets*Kq, dim), k/v (sets*Kk, dim) bf16; bias
    (sets, Kk) f32 additive key mask; weights (in, out) bf16, vectors f32.
    """
    kq = x.shape[0] // sets
    kk = k.shape[0] // sets
    outs = []
    for s in range(sets):
        ks = (1 - s) if (cross and sets == 2) else s
        outs.append(_block_plain(
            x[s * kq:(s + 1) * kq], q[s * kq:(s + 1) * kq],
            k[ks * kk:(ks + 1) * kk], v[ks * kk:(ks + 1) * kk], bias[ks],
            wout, bout, w1x, w1m, b1, lns, lnb, w2, b2, heads))
    return torch.cat(outs, dim=0)


def _lib():
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return typed(library("lightglue_block"), {
        "gisnav_lg_attention": [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                                ctypes.c_float, vp],
        "gisnav_lg_ffn": [vp] * 12 + [ci, vp]})


def _attention_cuda(q, k, v, bias, heads, sets, cross):
    """The first launch: msg (sets*Kq, dim) bf16. One 4-warp block per 64
    query rows (of all sets) and head, the keys of a set split by
    ``key_splits`` over a thread-block cluster."""
    n, dim = q.shape
    kk = k.shape[0] // sets
    splits = key_splits(n, kk, heads, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    msg = torch.empty((n, dim), dtype=_BF16, device=q.device)
    with on_device(q):
        check(_lib().gisnav_lg_attention(
            ptr(q), ptr(k), ptr(v), ptr(bias), ptr(msg), n, kk, heads, sets,
            int(cross and sets == 2), splits, 1.0 / float(dim // heads) ** 0.5,
            stream_of(q)), "lightglue attention")
    LAUNCHES["fused_block"] += 1
    return msg


def _ffn_cuda(x, msg, wout, bout, w1x, w1m, b1, lns, lnb, w2, b2):
    """The second launch: x + FFN([x | out_proj(msg)]) (sets*Kq, dim) f32."""
    out = torch.empty_like(x)
    with on_device(x):
        check(_lib().gisnav_lg_ffn(ptr(x), ptr(msg), ptr(wout), ptr(bout),
                                   ptr(w1x), ptr(w1m), ptr(b1), ptr(lns),
                                   ptr(lnb), ptr(w2), ptr(b2), ptr(out),
                                   x.shape[0], stream_of(x)), "lightglue ffn")
    LAUNCHES["fused_block"] += 1
    return out


def _fused_block_cuda(x, q, k, v, bias, wout, bout, w1x, w1m, b1, lns, lnb,
                      w2, b2, heads, sets, cross):
    n, dim = x.shape
    kk = k.shape[0] // sets
    bf = (q, k, v, wout, w1x, w1m, w2)
    f32 = (x, bias, bout, b1, lns, lnb, b2)
    if any(t.dtype != _BF16 for t in bf) or any(
            t.dtype != torch.float32 for t in f32):
        raise TypeError("fused_block: bf16 q/k/v/weights, f32 x/bias/vectors")
    if not all(t.is_contiguous() for t in bf + f32):
        raise ValueError("fused_block takes contiguous tensors")
    check_device("fused_block", *bf, *f32)
    if dim != 256 or heads != 4 or sets not in (1, 2) or \
            q.shape != x.shape or k.shape != v.shape or \
            k.shape[1] != dim or wout.shape != (256, 256) or \
            w1x.shape != (256, 512) or w1m.shape != (256, 512) or \
            w2.shape != (512, 256) or bias.shape != (sets, kk) or \
            n % (64 * sets) or kk % 64:
        raise ValueError(f"fused_block: unsupported shapes x{tuple(x.shape)} "
                         f"k{tuple(k.shape)} sets={sets}")
    msg = _attention_cuda(q, k, v, bias, heads, sets, cross)
    return _ffn_cuda(x, msg, wout, bout, w1x, w1m, b1, lns, lnb, w2, b2)


def _fused_block_route(x, q, k, v, bias, wout, bout, w1x, w1m, b1, lns, lnb,
                      w2, b2, heads, sets, cross):
    if not x.is_cuda:
        return fused_block_plain(x, q, k, v, bias, wout, bout, w1x, w1m, b1,
                                 lns, lnb, w2, b2, heads=heads, sets=sets,
                                 cross=cross)
    return _fused_block_cuda(x, q, k, v, bias, wout, bout, w1x, w1m, b1, lns,
                             lnb, w2, b2, heads, sets, cross)


class _FusedBlock(torch.autograd.Function):
    """The fused block with a gradient that recomputes through the plain
    version, the cotangent cast to the output's dtype (the JAX package's
    ``_fused_block_bwd`` and ``_fused_block_dual_bwd``)."""

    @staticmethod
    def forward(ctx, heads, sets, cross, *args):
        ctx.kw = dict(heads=heads, sets=sets, cross=cross)
        ctx.save_for_backward(*args)
        return _fused_block_route(*args, heads, sets, cross)

    @staticmethod
    def backward(ctx, g):
        out, vjp = torch.func.vjp(
            lambda *a: fused_block_plain(*a, **ctx.kw), *ctx.saved_tensors)
        return (None, None, None, *vjp(g.to(out.dtype)))


def fused_block(x, q, k, v, bias, wout, bout, w1x, w1m, b1, lns, lnb, w2, b2,
                *, heads: int = 4, sets: int = 1,
                cross: bool = False) -> torch.Tensor:
    """One fused transformer block (see :func:`fused_block_plain`),
    differentiable through ``_FusedBlock``."""
    return _FusedBlock.apply(heads, sets, cross, x, q, k, v, bias, wout,
                             bout, w1x, w1m, b1, lns, lnb, w2, b2)


# ---------------------------------------------------------------------------
# rotary via weight permutation
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _qkv_perm(heads: int, dh: int) -> np.ndarray:
    """Natural flax Wqkv column ``h*3*dh + comp*dh + d`` -> component-major
    layout with q/k pair-split lanes (evens then odds per head)."""
    perm = np.zeros(heads * 3 * dh, np.int64)
    for h in range(heads):
        for comp in range(3):
            for d in range(dh):
                j = h * 3 * dh + comp * dh + d
                if comp < 2:
                    t = (comp * heads * dh + h * dh + (d % 2) * (dh // 2)
                         + d // 2)
                else:
                    t = comp * heads * dh + h * dh + d
                perm[t] = j
    return perm


@functools.lru_cache(maxsize=8)
def _qkv_perm_ext(heads: int, dh: int) -> np.ndarray:
    """Columns of the extended operand ``[q, swap(q), k, swap(k), v]``."""
    dim = heads * dh
    base = _qkv_perm(heads, dh)
    pq, pk, pv = base[:dim], base[dim:2 * dim], base[2 * dim:]
    swap = np.zeros(dim, np.int64)
    for h in range(heads):
        for i in range(dh // 2):
            swap[h * dh + i] = h * dh + dh // 2 + i
            swap[h * dh + dh // 2 + i] = h * dh + i
    return np.concatenate([pq, pq[swap], pk, pk[swap], pv])


def _matmul(x, w, _):
    return x @ w


def _cs_full(cos, sin, heads):
    """(K, dim) rotary multipliers: rotated = q * C + swap(q) * S."""
    c = torch.cat([cos, cos], dim=1).repeat(1, heads)
    s = torch.cat([-sin, sin], dim=1).repeat(1, heads)
    return c, s


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------


class LightGlue(nn.Module):
    """Fused LightGlue forward over two fixed-size keypoint sets.

    ``params`` is the port's LightGlue tree (``weights.params_from_jax``),
    whole or one mesh row's (``parallel.mesh.shard_params_tp``); the weights
    are prepared once, in the layouts and types the forward uses, on the
    devices the tree lies on (the block's on the row's first device).
    """

    def __init__(self, params: Dict[str, Any], depth: int = 9,
                 heads: int = 4, dim: int = 256,
                 filter_threshold: float = 0.1):
        super().__init__()
        self.depth, self.heads, self.dim = depth, heads, dim
        self.filter_threshold = filter_threshold
        dh = dim // heads
        dev = tree_device(params)
        perm = torch.as_tensor(_qkv_perm_ext(heads, dh), device=dev)

        def in_out(w, dtype=torch.float32):  # Linear (out, in) -> (in, out)
            if isinstance(w, Sharded):
                return w.map(lambda t: t.T.contiguous().to(dtype),
                             axis=1 - w.axis)
            return w.T.contiguous().to(dtype)

        def dense(node, dtype=torch.float32):
            return in_out(node["weight"], dtype), node["bias"]

        def full(node, dtype):  # the block's operand: gathered whole
            return (in_out(whole(node["weight"], dev), dtype),
                    whole(node["bias"], dev))

        def recut(w, like):  # cut as ``like`` is, over its devices
            if isinstance(like, Sharded):
                return Sharded.split(w, like.devices, axis=1)
            return w

        def ffn(node):
            w1 = whole(node["fc1"]["weight"], dev).T.to(_BF16)
            return (w1[:dim].contiguous(), w1[dim:].contiguous(),
                    whole(node["fc1"]["bias"], dev),
                    whole(node["norm"]["weight"], dev),
                    whole(node["norm"]["bias"], dev),
                    *full(node["fc2"], _BF16))

        self.wi, self.bi = dense(params["input_proj"])
        self.wr = in_out(params["posenc"]["Wr"]["weight"])
        self.layers = []
        for i in range(depth):
            sp, cp = params[f"self_{i}"], params[f"cross_{i}"]
            wqkv = whole(sp["Wqkv"]["weight"], dev).T[:, perm]
            bqkv = whole(sp["Wqkv"]["bias"], dev)[perm]
            wcat = torch.cat([whole(cp[n]["weight"], dev).T
                              for n in ("to_qk", "to_v")], dim=1)
            bcat = torch.cat([whole(cp[n]["bias"], dev)
                              for n in ("to_qk", "to_v")])
            self.layers.append({
                "wqkv": recut(wqkv.contiguous().to(_BF16),
                              sp["Wqkv"]["weight"]),
                "bqkv": bqkv.to(_BF16),
                "self_out": full(sp["out_proj"], _BF16),
                "self_ffn": ffn(sp["ffn"]),
                "wcat": recut(wcat.contiguous().to(_BF16),
                              cp["to_qk"]["weight"]),
                "bcat": bcat.to(_BF16),
                "cross_out": full(cp["to_out"], _BF16),
                "cross_ffn": ffn(cp["ffn"]),
            })
        self.wf, self.bf = dense(params["final_proj"])
        self.wm, self.bm = dense(params["matchability"])

    def _rot(self, main, swap, cf, sf):
        return (main.float() * cf + swap.float() * sf).to(_BF16)

    def _proj(self, x, w, b):
        """bf16(x) @ w rounded to bf16, plus the bf16 bias (the JAX bf16
        matmul semantics, computed in f32)."""
        return (_r(x) @ w.float()).to(_BF16) + b

    @torch.no_grad()
    def forward(self, kpts0, desc0, mask0, size0, kpts1, desc1, mask1,
                size1) -> MatchResult:
        dim, heads = self.dim, self.heads
        x0 = product(desc0.float(), self.wi, self.bi, _affine)
        x1 = product(desc1.float(), self.wi, self.bi, _affine)
        p0 = product(normalize_keypoints(kpts0, size0[0], size0[1]),
                     self.wr, None, _matmul)
        p1 = product(normalize_keypoints(kpts1, size1[0], size1[1]),
                     self.wr, None, _matmul)
        cf0, sf0 = _cs_full(torch.cos(p0), torch.sin(p0), heads)
        cf1, sf1 = _cs_full(torch.cos(p1), torch.sin(p1), heads)
        zero = torch.zeros((), device=x0.device)
        neg = torch.full((), -1e9, device=x0.device)
        bias0 = torch.where(mask0, zero, neg)[None]
        bias1 = torch.where(mask1, zero, neg)[None]

        k0 = kpts0.shape[0]
        dual = k0 == kpts1.shape[0]
        if dual:
            xx = torch.cat([x0, x1])
            cf, sf = torch.cat([cf0, cf1]), torch.cat([sf0, sf1])
            bias2 = torch.cat([bias0, bias1]).contiguous()

        def self_qkv(x, layer, cf_, sf_):
            qkv = product(x, layer["wqkv"], layer["bqkv"], self._proj)
            q = self._rot(qkv[:, :dim], qkv[:, dim:2 * dim], cf_, sf_)
            k = self._rot(qkv[:, 2 * dim:3 * dim], qkv[:, 3 * dim:4 * dim],
                          cf_, sf_)
            return q, k, qkv[:, 4 * dim:].contiguous()

        for layer in self.layers:
            wo = (*layer["self_out"], *layer["self_ffn"])
            if dual:
                q, k, v = self_qkv(xx, layer, cf, sf)
                xx = fused_block(xx, q, k, v, bias2, *wo, heads=heads, sets=2)
            else:
                q, k, v = self_qkv(x0, layer, cf0, sf0)
                x0 = fused_block(x0, q, k, v, bias0, *wo, heads=heads)
                q, k, v = self_qkv(x1, layer, cf1, sf1)
                x1 = fused_block(x1, q, k, v, bias1, *wo, heads=heads)

            wo = (*layer["cross_out"], *layer["cross_ffn"])
            if dual:
                qv = product(xx, layer["wcat"], layer["bcat"], self._proj)
                qk, v = qv[:, :dim].contiguous(), qv[:, dim:].contiguous()
                xx = fused_block(xx, qk, qk, v, bias2, *wo, heads=heads,
                                 sets=2, cross=True)
            else:
                qv0 = product(x0, layer["wcat"], layer["bcat"], self._proj)
                qv1 = product(x1, layer["wcat"], layer["bcat"], self._proj)
                qk0, v0 = qv0[:, :dim].contiguous(), qv0[:, dim:].contiguous()
                qk1, v1 = qv1[:, :dim].contiguous(), qv1[:, dim:].contiguous()
                x0, x1 = (
                    fused_block(x0, qk0, qk1, v1, bias1, *wo, heads=heads),
                    fused_block(x1, qk1, qk0, v0, bias0, *wo, heads=heads))

        if dual:
            x0, x1 = xx[:k0], xx[k0:]

        return assignment(x0, x1, mask0, mask1, self.wf, self.bf, self.wm,
                          self.bm, dim, self.filter_threshold)
