"""Masked multi-head attention: CUDA kernel and its plain version.

Counterpart of ``gisnav_tpu/matching/pallas_attention.py``
(``masked_attention_pallas``, ``pallas_attention_supported``), the attention
of the LightGlue module route::

    out = softmax(q k^T / sqrt(D) + key_bias) v        per head

with q (Kq, H, D), k/v (Kk, H, D) cast to bf16, a key mask (Kk,) turned into
an additive f32 bias (0 / -1e9), f32 logits and softmax, the normalised
probabilities rounded to bf16 before P.V, and an f32 (Kq, H, D) result. The
logits never reach device memory. Forward only.

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
    ptr,
    stream_of,
    typed,
)

__all__ = ["masked_attention", "masked_attention_plain",
           "attention_supported", "key_splits"]

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
    """The kernel's arithmetic in plain PyTorch, for any shape.

    ``additive_bias`` says how scale and mask enter the f32 logits: as the
    kernel has them, ``logits * D^-1/2 + (0 | -1e9)``, or (False) as the
    JAX module has them outside the kernel's shapes,
    ``where(mask, logits / sqrt(D), -1e9)``.
    """
    d = q.shape[-1]
    qh = q.to(_BF16).float().transpose(0, 1)  # (H, Kq, D)
    kh = k.to(_BF16).float().transpose(0, 1)
    vh = v.to(_BF16).float().transpose(0, 1)
    logits = qh @ kh.transpose(1, 2)
    if additive_bias:
        logits = logits * (1.0 / float(d) ** 0.5) + _key_bias(mask_k)
    else:
        logits = torch.where(mask_k, logits / float(np.sqrt(np.float32(d))),
                             torch.full_like(logits[:1, :1, :1], -1e9))
    p = torch.softmax(logits, dim=-1)
    return (p.to(_BF16).float() @ vh).transpose(0, 1).contiguous()


def _lib():
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return typed(library("attention"), {
        "gisnav_masked_attention": [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci,
                                    ci, ctypes.c_float, vp]})


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask_k: torch.Tensor) -> torch.Tensor:
    """q (Kq, H, D), k/v (Kk, H, D), mask_k (Kk,) bool -> (Kq, H, D) f32."""
    kq, heads, d = q.shape
    kk = k.shape[0]
    if k.shape != (kk, heads, d) or v.shape != k.shape or \
            mask_k.shape != (kk,) or mask_k.dtype != torch.bool:
        raise ValueError(f"masked_attention: q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"mask{tuple(mask_k.shape)} {mask_k.dtype}")
    if not attention_supported(kq, kk, d):
        raise ValueError(f"masked_attention: unsupported Kq={kq} Kk={kk} "
                         f"D={d} (see attention_supported)")
    if not q.is_cuda:
        return masked_attention_plain(q, k, v, mask_k)
    qb, kb, vb = (t.to(_BF16).contiguous() for t in (q, k, v))
    bias = _key_bias(mask_k).contiguous()
    check_device("masked_attention", qb, kb, vb, bias)
    splits = key_splits(kq, kk, heads, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    out = torch.empty((kq, heads, d), dtype=torch.float32, device=q.device)
    stats = torch.empty((splits, heads, kq, 2), dtype=torch.float32,
                        device=q.device)
    check(_lib().gisnav_masked_attention(
        ptr(qb), ptr(kb), ptr(vb), ptr(bias), ptr(stats), ptr(out), kq, kk,
        heads, d, splits, 1.0 / float(d) ** 0.5, stream_of(qb)),
        "masked_attention")
    LAUNCHES["masked_attention"] += 2  # statistics, then P.V
    return out
