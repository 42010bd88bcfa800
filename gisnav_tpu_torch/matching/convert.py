"""LightGlue weight conversion: official PyTorch checkpoint -> JAX-layout
tree.

The port's copy of ``gisnav_tpu/matching/convert.py``: the official
LightGlue release layout becomes the JAX package's static-depth tree
(Linear ``(out, in)`` -> Dense ``(in, out)``, f32), which
``weights.params_from_jax`` takes like a bundled one:

- ``input_proj`` (identity when the checkpoint has none), ``posenc.Wr``;
- ``transformers.{i}.self_attn.{Wqkv, out_proj, ffn}`` -> ``self_{i}``,
  with ``Wqkv``'s interleaved q/k/v columns put in component-major order;
- ``transformers.{i}.cross_attn.{to_qk, to_v, to_out, ffn}`` ->
  ``cross_{i}``;
- the deepest requested ``log_assignment`` head -> ``final_proj``,
  ``matchability``.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np

from gisnav_tpu_torch.features.convert import to_numpy

__all__ = ["lightglue_params_from_torch", "load_lightglue_checkpoint"]


def _dense(flat: Mapping[str, np.ndarray], name: str, required=True):
    w = flat.get(f"{name}.weight")
    if w is None:
        if required:
            raise KeyError(f"missing '{name}.weight' in checkpoint")
        return None
    out = {"kernel": np.ascontiguousarray(w.T.astype(np.float32))}
    b = flat.get(f"{name}.bias")
    if b is not None:
        out["bias"] = b.astype(np.float32)
    return out


def _qkv_deinterleave(dense: Dict, heads: int) -> Dict:
    """The official ``SelfBlock`` splits its fused projection as
    ``(head, head_dim, 3)`` (q/k/v interleaved per scalar); the JAX module
    as ``(head, 3, head_dim)``. Permute the transposed kernel's columns and
    the bias from ``h*3*dh + d*3 + comp`` to ``h*3*dh + comp*dh + d``."""
    kernel = dense["kernel"]  # (in, 3 * dim)
    out_dim = kernel.shape[1]
    dh = out_dim // 3 // heads
    kernel = (kernel.reshape(-1, heads, dh, 3).transpose(0, 1, 3, 2)
              .reshape(-1, out_dim))
    out = {"kernel": np.ascontiguousarray(kernel)}
    if "bias" in dense:
        out["bias"] = np.ascontiguousarray(
            dense["bias"].reshape(heads, dh, 3).transpose(0, 2, 1)
            .reshape(-1))
    return out


def _ffn(flat, prefix: str) -> Dict:
    """Sequential(Linear(2d, 2d), LayerNorm, GELU, Linear(2d, d))."""
    return {
        "fc1": _dense(flat, f"{prefix}.0"),
        "norm": {"scale": flat[f"{prefix}.1.weight"].astype(np.float32),
                 "bias": flat[f"{prefix}.1.bias"].astype(np.float32)},
        "fc2": _dense(flat, f"{prefix}.3"),
    }


def lightglue_params_from_torch(state_dict: Mapping[str, object],
                                depth: int = 9, heads: int = 4) -> Dict:
    """Official LightGlue state dict -> ``{"params": ...}``.

    :param depth: transformer layers to take (<= the checkpoint's depth)
    :param heads: attention heads (to unscramble ``Wqkv``)
    """
    flat = {k: to_numpy(v) for k, v in state_dict.items()}
    layer_ids = sorted({int(m.group(1)) for k in flat
                        for m in [re.match(r"transformers\.(\d+)\.", k)]
                        if m})
    if not layer_ids:
        raise KeyError("no 'transformers.N.*' entries found; keys look "
                       "like: " + ", ".join(sorted(flat)[:8]))
    if depth > len(layer_ids):
        raise ValueError(f"requested depth {depth} > checkpoint depth "
                         f"{len(layer_ids)}")

    input_proj = _dense(flat, "input_proj", required=False)
    if input_proj is None:
        # checkpoints whose input and model widths agree carry no input
        # projection (nn.Identity); the module always projects
        dim = flat["posenc.Wr.weight"].shape[0] * 2 * heads
        input_proj = {"kernel": np.eye(dim, dtype=np.float32),
                      "bias": np.zeros(dim, np.float32)}
    params: Dict = {"input_proj": input_proj,
                    "posenc": {"Wr": _dense(flat, "posenc.Wr")}}
    for i in range(depth):
        p = f"transformers.{i}"
        params[f"self_{i}"] = {
            "Wqkv": _qkv_deinterleave(_dense(flat, f"{p}.self_attn.Wqkv"),
                                      heads),
            "out_proj": _dense(flat, f"{p}.self_attn.out_proj"),
            "ffn": _ffn(flat, f"{p}.self_attn.ffn"),
        }
        params[f"cross_{i}"] = {
            "to_qk": _dense(flat, f"{p}.cross_attn.to_qk"),
            "to_v": _dense(flat, f"{p}.cross_attn.to_v"),
            "to_out": _dense(flat, f"{p}.cross_attn.to_out"),
            "ffn": _ffn(flat, f"{p}.cross_attn.ffn"),
        }
    last = depth - 1
    for head in ("final_proj", "matchability"):
        params[head] = (
            _dense(flat, f"log_assignment.{last}.{head}", required=False)
            or _dense(flat, f"log_assignment.{head}"))
    return {"params": params}


def load_lightglue_checkpoint(path: str, depth: int = 9) -> Dict:
    """Load a ``.pth`` checkpoint on the CPU (tensors only) and convert."""
    import torch

    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return lightglue_params_from_torch(state, depth)
