"""Masked multi-head attention: CUDA kernel and its plain version.

Counterpart of ``gisnav_tpu/matching/pallas_attention.py``
(``masked_attention_pallas``, ``pallas_attention_supported``), the attention
of the LightGlue module route::

    out = softmax(q k^T / sqrt(D) + key_bias) v        per head

with q (Kq, H, D), k/v (Kk, H, D) cast to bf16, a key mask (Kk,) turned into
an additive f32 bias (0 / -1e9), f32 logits and softmax, the normalised
probabilities rounded to bf16 before P.V, and an f32 (Kq, H, D) result. The
logits never reach device memory. A leading pair axis (B, K, H, D) runs B
problems of one shape in one launch pair, as the JAX package's vmap of the
kernel over training pairs does. ``MaskedAttention`` is the kernel with the
JAX package's analytic gradient (``_attention_bwd``), in plain PyTorch.

A CPU tensor runs the plain version; a CUDA tensor launches
``kernels/attention.cu`` or raises. The kernel is two launches a call (row
statistics, then P.V) over a grid that also splits the keys, so that a few
thousand rows fill the card; ``key_splits`` chooses the split.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

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

__all__ = ["masked_attention", "masked_attention_plain",
           "masked_attention_backward", "MaskedAttention",
           "attention_with_grad", "attention_supported", "key_splits"]

_BLK_Q = 256
_BF16 = torch.bfloat16


def attention_supported(kq: int, kk: int, head_dim: int) -> bool:
    """The shapes ``masked_attention`` takes (those of the TPU kernel)."""
    return (kq % _BLK_Q == 0 and kk % 128 == 0
            and head_dim in (32, 64, 128)
            and kk * head_dim * 4 <= 4 * 1024 * 1024)


def key_splits(kq: int, kk: int, heads: int, sms: int) -> int:
    """How many ways the kernel splits the keys: the smallest of 1, 2, 4, 8
    that puts at least three 4-warp blocks on each of ``sms`` multiprocessors
    (one block owns 64 query rows of a head), with at least one 64-key tile a
    split."""
    blocks = (kq // 64) * heads
    splits = 1
    while splits < 8 and blocks * splits < 3 * sms and 2 * splits <= kk // 64:
        splits *= 2
    return splits


def _key_bias(mask_k: torch.Tensor) -> torch.Tensor:
    return torch.where(mask_k, 0.0, -1e9)  # f32, one launch


def masked_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask_k: torch.Tensor,
                           additive_bias: bool = True) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, for any shape, with or
    without the leading pair axis of :func:`masked_attention`.

    ``additive_bias`` says how scale and mask enter the f32 logits: as the
    kernel has them, ``logits * D^-1/2 + (0 | -1e9)``, or (False) as the
    JAX module has them outside the kernel's shapes,
    ``where(mask, logits / sqrt(D), -1e9)``.
    """
    d = q.shape[-1]
    qh = q.to(_BF16).float().transpose(-3, -2)  # (..., H, Kq, D)
    kh = k.to(_BF16).float().transpose(-3, -2)
    vh = v.to(_BF16).float().transpose(-3, -2)
    logits = qh @ kh.transpose(-2, -1)
    mask = mask_k[..., None, None, :]
    if additive_bias:
        logits = logits * (1.0 / float(d) ** 0.5) + _key_bias(mask)
    else:
        logits = torch.where(mask, logits / float(np.sqrt(np.float32(d))),
                             torch.full_like(logits[..., :1, :1, :1], -1e9))
    p = torch.softmax(logits, dim=-1)
    return (p.to(_BF16).float() @ vh).transpose(-3, -2).contiguous()


def masked_attention_backward(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, mask_k: torch.Tensor,
                              g: torch.Tensor):
    """Analytic gradient of the attention (``_attention_bwd`` of the JAX
    package), with or without the pair axis: the weights recomputed in f32
    from the un-rounded q and k, the mask as ``where(mask, logits * D^-1/2,
    -1e9)``, and each gradient returned in its input's dtype."""
    d = q.shape[-1]
    scale = 1.0 / float(d) ** 0.5
    qf, kf, vf = (t.float().transpose(-3, -2) for t in (q, k, v))
    logits = (qf @ kf.transpose(-2, -1)) * scale  # (..., H, Kq, Kk)
    logits = torch.where(mask_k[..., None, None, :], logits,
                         torch.full_like(logits[..., :1, :1, :1], -1e9))
    p = torch.softmax(logits, dim=-1)
    gf = g.float().transpose(-3, -2)  # (..., H, Kq, D)
    dv = p.transpose(-2, -1) @ gf
    dp = gf @ vf.transpose(-2, -1)
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-2, -1) @ qf) * scale
    return tuple(t.transpose(-3, -2).to(ref.dtype).contiguous()
                 for t, ref in ((dq, q), (dk, k), (dv, v)))


def _lib():
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return typed(library("attention"), {
        "gisnav_masked_attention": [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci,
                                    ci, ci, ctypes.c_float, vp]})


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask_k: torch.Tensor) -> torch.Tensor:
    """q (Kq, H, D), k/v (Kk, H, D), mask_k (Kk,) bool -> (Kq, H, D) f32;
    or, with a leading pair axis, q (B, Kq, H, D), k/v (B, Kk, H, D),
    mask_k (B, Kk) -> (B, Kq, H, D): one launch pair for all B, each pair's
    output bit-equal to its own call."""
    batched = q.dim() == 4
    if not batched:
        q, k, v, mask_k = q[None], k[None], v[None], mask_k[None]
    pairs, kq, heads, d = q.shape
    kk = k.shape[1]
    if q.dim() != 4 or k.shape != (pairs, kk, heads, d) or \
            v.shape != k.shape or mask_k.shape != (pairs, kk) or \
            mask_k.dtype != torch.bool:
        raise ValueError(f"masked_attention: q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"mask{tuple(mask_k.shape)} {mask_k.dtype}")
    if not attention_supported(kq, kk, d):
        raise ValueError(f"masked_attention: unsupported Kq={kq} Kk={kk} "
                         f"D={d} (see attention_supported)")
    if not q.is_cuda:
        out = masked_attention_plain(q, k, v, mask_k)
        return out if batched else out[0]
    qb, kb, vb = (t.to(_BF16).contiguous() for t in (q, k, v))
    bias = _key_bias(mask_k).contiguous()
    check_device("masked_attention", qb, kb, vb, bias)
    # the split depends on one pair's shape, so that a pair's sums run in
    # the order of its own call
    splits = key_splits(kq, kk, heads, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    out = torch.empty((pairs, kq, heads, d), dtype=torch.float32,
                      device=q.device)
    stats = torch.empty((splits, pairs, heads, kq, 2), dtype=torch.float32,
                        device=q.device)
    with on_device(qb):
        check(_lib().gisnav_masked_attention(
            ptr(qb), ptr(kb), ptr(vb), ptr(bias), ptr(stats), ptr(out), kq,
            kk, heads, pairs, d, splits, 1.0 / float(d) ** 0.5,
            stream_of(qb)),
            "masked_attention")
    LAUNCHES["masked_attention"] += 2  # statistics, then P.V
    return out if batched else out[0]


class MaskedAttention(torch.autograd.Function):
    """``masked_attention`` with the JAX package's ``custom_vjp``: the
    forward is the kernel on the card (the plain version on the CPU), the
    backward :func:`masked_attention_backward` in plain PyTorch (XLA in the
    JAX package, not a kernel). q, k and v are saved in the dtypes they came
    in."""

    @staticmethod
    def forward(ctx, q, k, v, mask_k):
        ctx.save_for_backward(q, k, v, mask_k)
        return masked_attention(q, k, v, mask_k)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask_k = ctx.saved_tensors
        return (*masked_attention_backward(q, k, v, mask_k, g), None)


def attention_with_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask_k: torch.Tensor) -> torch.Tensor:
    """Differentiable masked attention, with or without the pair axis: the
    kernel's Function for the shapes ``attention_supported`` names, the JAX
    module's einsum form under autograd for all others (as the JAX module's
    ``_attention`` routes them)."""
    if attention_supported(q.shape[-3], k.shape[-3], q.shape[-1]):
        return MaskedAttention.apply(q, k, v, mask_k)
    return masked_attention_plain(q, k, v, mask_k, additive_bias=False)
