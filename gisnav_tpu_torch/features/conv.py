"""SuperPoint VGG-trunk stages: CUDA kernels and their plain versions.

Counterpart of ``gisnav_tpu/features/pallas_conv.py`` (``stem_stage`` and
``conv_stage``). Each stage is conv3x3 + bias + relu [-> conv3x3 + bias +
relu] [-> 2x2 maxpool] on an (H, W, C) NHWC image, bf16 operands with f32
accumulation and the rounding of the JAX reference ``vgg_stage_reference``:
the conv sum rounded to bf16, the f32 bias added, relu, rounded to bf16.

Weights come in the layout the kernels take (``weights.params_from_jax``):
3x3 kernels as ``(9, Cin, Cout)`` bf16 (HWIO with the taps flattened), biases
as f32. A CPU tensor runs the plain PyTorch version; a CUDA tensor launches
the kernel of ``kernels/conv.cu`` or raises: one launch a conv of a stage,
and one for the whole stem (conv1a is computed inside conv1b's halo patch, so
its (H, W, 64) output never reaches device memory). Both entries are
``torch.autograd.Function``s whose backward recomputes through the plain
version, as the JAX package's ``custom_vjp``s do through the XLA mirror.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

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

__all__ = ["stem_stage", "stem_stage_plain", "conv_stage", "conv_stage_plain"]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _conv_relu_plain(x: torch.Tensor, w9: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """(H, W, Cin) -> (H, W, Cout) bf16, reference rounding."""
    cin, cout = w9.shape[1], w9.shape[2]
    wt = w9.float().reshape(3, 3, cin, cout).permute(3, 2, 0, 1)
    y = F.conv2d(x.float().permute(2, 0, 1)[None], wt, padding=1)[0]
    y = y.permute(1, 2, 0).to(torch.bfloat16).float()
    return torch.relu(y + b.float()).to(torch.bfloat16)


def _pool2(y: torch.Tensor) -> torch.Tensor:
    h, w, c = y.shape
    return y.reshape(h // 2, 2, w // 2, 2, c).amax(dim=(1, 3))


def conv_stage_plain(x, w1, b1, w2=None, b2=None, *, pool: bool = False):
    y = _conv_relu_plain(x.to(torch.bfloat16), w1, b1)
    if w2 is not None:
        y = _conv_relu_plain(y, w2, b2)
    return _pool2(y) if pool else y


def stem_stage_plain(img, w1a, b1a, w1b, b1b, *, pool: bool = True):
    x = img.to(torch.bfloat16)[..., None]
    return conv_stage_plain(x, w1a, b1a, w1b, b1b, pool=pool)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


def _lib():
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return typed(library("conv"), {
        "gisnav_conv3x3": [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp],
        "gisnav_stem": [vp] * 6 + [ci, ci, ci, vp]})


def _check_tensors(what, x, x_dtype, *params):
    """params: (9, Cin, Cout) bf16 weights and f32 biases, alternating."""
    check_device(what, x, *params)
    if x.dtype != x_dtype or any(t.dtype != torch.bfloat16
                                 for t in params[0::2]):
        raise TypeError(f"{what} takes {x_dtype} input and bf16 weights")
    if any(t.dtype != torch.float32 for t in params[1::2]):
        raise TypeError(f"{what} takes f32 biases")
    if not all(t.is_contiguous() for t in (x, *params)):
        raise ValueError(f"{what} takes contiguous tensors")


def _check_args(x, w9, b, cin):
    _check_tensors("conv kernel", x, torch.bfloat16, w9, b)
    if w9.shape[:2] != (9, cin) or cin not in (64, 128) or w9.shape[2] % 64:
        raise ValueError(f"unsupported conv shape {tuple(w9.shape)}: the "
                         f"kernel takes 64 or 128 input channels and a "
                         f"multiple of 64 output channels")


def _conv_cuda(x: torch.Tensor, w9: torch.Tensor, b: torch.Tensor,
               pool: bool) -> torch.Tensor:
    h, w, cin = x.shape
    _check_args(x, w9, b, cin)
    cout = w9.shape[2]
    if pool and (h % 2 or w % 2):
        raise ValueError(f"2x2 pool needs even H, W, got {(h, w)}")
    shape = (h // 2, w // 2, cout) if pool else (h, w, cout)
    out = torch.empty(shape, dtype=torch.bfloat16, device=x.device)
    with on_device(x):
        check(_lib().gisnav_conv3x3(ptr(x), ptr(w9), ptr(b), ptr(out), h, w,
                                    cin, cout, int(pool), stream_of(x)),
              "conv3x3")
    LAUNCHES["conv_stage"] += 1
    return out


def _stem_cuda(img: torch.Tensor, w1a: torch.Tensor, b1a: torch.Tensor,
               w1b: torch.Tensor, b1b: torch.Tensor,
               pool: bool) -> torch.Tensor:
    if img.dim() != 2 or w1a.shape != (9, 1, 64) or w1b.shape != (9, 64, 64):
        raise ValueError(f"stem kernel takes an (H, W) image and 1->64->64 "
                         f"weights, got {tuple(img.shape)}, "
                         f"{tuple(w1a.shape)}, {tuple(w1b.shape)}")
    _check_tensors("stem kernel", img, torch.float32, w1a, b1a, w1b, b1b)
    h, w = img.shape
    if pool and (h % 2 or w % 2):
        raise ValueError(f"2x2 pool needs even H, W, got {(h, w)}")
    shape = (h // 2, w // 2, 64) if pool else (h, w, 64)
    out = torch.empty(shape, dtype=torch.bfloat16, device=img.device)
    with on_device(img):
        check(_lib().gisnav_stem(ptr(img), ptr(w1a), ptr(b1a), ptr(w1b),
                                 ptr(b1b), ptr(out), h, w, int(pool),
                                 stream_of(img)),
              "stem")
    LAUNCHES["stem_stage"] += 1
    return out


def _conv_stage_route(x, w1, b1, w2, b2, pool):
    if not x.is_cuda:
        return conv_stage_plain(x, w1, b1, w2, b2, pool=pool)
    if w2 is None:
        return _conv_cuda(x, w1, b1, pool)
    return _conv_cuda(_conv_cuda(x, w1, b1, False), w2, b2, pool)


def _stem_route(img, w1a, b1a, w1b, b1b, pool):
    if not img.is_cuda:
        return stem_stage_plain(img, w1a, b1a, w1b, b1b, pool=pool)
    return _stem_cuda(img, w1a, b1a, w1b, b1b, pool)


def _vjp_plain(plain, saved, g, **kw):
    """Gradients of ``plain(*saved, **kw)`` for the cotangent ``g`` cast to
    the output's dtype (the JAX package's ``_conv_stage_bwd`` and
    ``_stem_bwd``); ``None`` for absent inputs."""
    present = [t for t in saved if t is not None]
    out, vjp = torch.func.vjp(lambda *a: plain(*a, **kw), *present)
    grads = iter(vjp(g.to(out.dtype)))
    return tuple(None if t is None else next(grads) for t in saved)


class _ConvStage(torch.autograd.Function):
    """The conv stage with a gradient that recomputes through the plain
    version, as the JAX package's ``custom_vjp`` does through its XLA
    mirror."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, pool):
        ctx.pool = pool
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return _conv_stage_route(x, w1, b1, w2, b2, pool)

    @staticmethod
    def backward(ctx, g):
        return (*_vjp_plain(conv_stage_plain, ctx.saved_tensors, g,
                            pool=ctx.pool), None)


class _StemStage(torch.autograd.Function):
    """The stem with a gradient through the plain version (``_stem_bwd``)."""

    @staticmethod
    def forward(ctx, img, w1a, b1a, w1b, b1b, pool):
        ctx.pool = pool
        ctx.save_for_backward(img, w1a, b1a, w1b, b1b)
        return _stem_route(img, w1a, b1a, w1b, b1b, pool)

    @staticmethod
    def backward(ctx, g):
        return (*_vjp_plain(stem_stage_plain, ctx.saved_tensors, g,
                            pool=ctx.pool), None)


def conv_stage(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
               w2: Optional[torch.Tensor] = None,
               b2: Optional[torch.Tensor] = None, *,
               pool: bool = False) -> torch.Tensor:
    """(H, W, Cin) bf16 -> (H[/2], W[/2], Cout) bf16, differentiable."""
    return _ConvStage.apply(x, w1, b1, w2, b2, pool)


def stem_stage(img: torch.Tensor, w1a: torch.Tensor, b1a: torch.Tensor,
               w1b: torch.Tensor, b1b: torch.Tensor, *,
               pool: bool = True) -> torch.Tensor:
    """(H, W) f32 grayscale -> (H[/2], W[/2], 64) bf16, differentiable."""
    return _StemStage.apply(img, w1a, b1a, w1b, b1b, pool)
