"""Bundled weights for the port: npz loader and JAX-tree conversion.

The bundles in ``weights/`` are flattened flax trees stored as float16 npz
(keys like ``lightglue/params/self_0/Wqkv/kernel``). ``load_npz`` restores the
nested tree as numpy f32 without flax; ``params_from_jax`` turns such a tree
(or one taken from the JAX package) into the port's tensors:

- 3x3 conv kernels, HWIO ``(3, 3, Cin, Cout)``, become ``(9, Cin, Cout)`` bf16,
  the layout the conv kernel takes (the JAX package casts them to bf16 too);
- 1x1 conv kernels and flax Dense kernels ``(in, out)`` become Linear layout
  ``(out, in)`` (bf16 for the SuperPoint 1x1 heads, f32 for LightGlue, whose
  forward casts them where the JAX forward does);
- LayerNorm ``scale``/``bias`` become ``weight``/``bias``; biases stay f32.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from gisnav_tpu_torch.pipeline.geopose import PipelineConfig

__all__ = ["LEARNED_LG9_PATH", "LEARNED_LG9_CONFIG", "load_npz",
           "params_from_jax", "infer_config_from_params", "load_bundled"]

WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                           "weights")
LEARNED_LG9_PATH = os.path.join(WEIGHTS_DIR, "gisnav_tpu_learned_lg9.npz")

LEARNED_LG9_CONFIG = PipelineConfig(
    image_shape=(480, 640), max_keypoints=512, lightglue_depth=9,
    detector_mode="learned", min_matches=15)
"""Config of ``weights/gisnav_tpu_learned_lg9.npz``: learned SuperPoint
detector + 9-layer LightGlue, the production architecture."""


def load_npz(path: str) -> Dict[str, Any]:
    """npz of ``a/b/c`` keys -> nested dict of numpy arrays (floats -> f32)."""
    tree: Dict[str, Any] = {}
    with np.load(path) as data:
        for key, value in data.items():
            node = tree
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = (np.asarray(value, np.float32)
                               if value.dtype.kind == "f" else value)
    return tree


def _inner(tree):
    return tree["params"] if "params" in tree else tree


def _t(a, dtype, device):
    return torch.as_tensor(np.asarray(a, np.float32)).to(device=device,
                                                         dtype=dtype)


def _convert_superpoint(sp, device):
    out = {}
    for name, leaf in _inner(sp).items():
        k = np.asarray(leaf["kernel"], np.float32)
        kh, kw, cin, cout = k.shape
        if (kh, kw) == (3, 3):
            w = _t(k.reshape(9, cin, cout), torch.bfloat16, device)
        else:
            w = _t(k.reshape(cin, cout).T, torch.bfloat16, device)
        out[name] = {"weight": w.contiguous(),
                     "bias": _t(leaf["bias"], torch.float32, device)}
    return out


def _convert_dense_tree(node, device):
    if "kernel" in node:  # Dense
        dense = {"weight": _t(np.asarray(node["kernel"]).T, torch.float32,
                              device).contiguous()}
        if "bias" in node:
            dense["bias"] = _t(node["bias"], torch.float32, device)
        return dense
    if "scale" in node:  # LayerNorm
        return {"weight": _t(node["scale"], torch.float32, device),
                "bias": _t(node["bias"], torch.float32, device)}
    return {k: _convert_dense_tree(v, device) for k, v in node.items()}


def params_from_jax(tree, device="cpu") -> Dict[str, Any]:
    """JAX param tree (``{"superpoint": ..., "lightglue": ...}``, with or
    without the ``params`` level, numpy or jax arrays) -> the port's tree."""
    out = {}
    if "superpoint" in tree:
        out["superpoint"] = _convert_superpoint(tree["superpoint"], device)
    if "lightglue" in tree:
        out["lightglue"] = _convert_dense_tree(_inner(tree["lightglue"]),
                                               device)
    return out


def infer_config_from_params(params) -> PipelineConfig:
    """Config of a JAX-layout deep-weights tree: LightGlue depth = number of
    ``self_N`` blocks; the detector head ``convPa`` means learned mode."""
    lg = params.get("lightglue")
    if lg is None:
        raise ValueError(
            "checkpoint has no 'lightglue' params - not a deep-mode bundle "
            f"(top-level keys: {sorted(params)})")
    depth = sum(1 for k in _inner(lg) if str(k).startswith("self_"))
    mode = ("learned" if "convPa" in _inner(params.get("superpoint", {}))
            else "harris")
    return dataclasses.replace(
        LEARNED_LG9_CONFIG,
        lightglue_depth=depth or LEARNED_LG9_CONFIG.lightglue_depth,
        detector_mode=mode)


def load_bundled(name: str = "learned_lg9"
                 ) -> Tuple[Dict[str, Any], PipelineConfig]:
    """Bundled weights by name -> (JAX-layout numpy tree, PipelineConfig).

    Only ``learned_lg9`` is ported so far; the other bundles need the Harris
    detector or LoFTR."""
    if name != "learned_lg9":
        raise ValueError(f"bundle {name!r} is not ported to gisnav_tpu_torch")
    if not os.path.exists(LEARNED_LG9_PATH):
        raise FileNotFoundError(f"no bundled weights at {LEARNED_LG9_PATH}")
    tree = load_npz(LEARNED_LG9_PATH)
    return tree, infer_config_from_params(tree)
