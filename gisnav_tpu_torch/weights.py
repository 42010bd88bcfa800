"""Bundled weights for the port: npz loader and JAX-tree conversion.

The bundles in ``weights/`` (or in ``$GISNAV_TPU_WEIGHTS_DIR`` when set, as
for the JAX package) are flattened flax trees stored as float16 npz (keys
like ``lightglue/params/self_0/Wqkv/kernel``): ``harris_lg5`` (Harris
detector + LightGlue-5, the default), ``learned_lg9`` (learned detector +
LightGlue-9) and ``loftr`` (semi-dense LoFTR). ``load_npz`` restores the
nested tree as numpy f32 without flax; ``params_from_jax`` turns such a tree
(or one taken from the JAX package or the checkpoint converters) into the
port's tensors:

- 3x3 conv kernels, HWIO ``(3, 3, Cin, Cout)``, become ``(9, Cin, Cout)`` bf16,
  the layout the conv kernel takes (the JAX package casts them to bf16 too);
- 1x1 conv kernels and flax Dense kernels ``(in, out)`` become Linear layout
  ``(out, in)`` (bf16 for the SuperPoint 1x1 heads, f32 for LightGlue, whose
  forward casts them where the JAX forward does);
- LayerNorm ``scale``/``bias`` become ``weight``/``bias``; biases stay f32;
- LoFTR is f32 throughout: its 3x3 conv kernels become f32 OIHW for
  ``F.conv2d``, its Dense and LayerNorm leaves as above.

``load_pretrained(path=None)`` is the JAX package's loader: the bundle at
``path`` (default ``PRETRAINED_PATH``, ``harris_lg5``) as that JAX-layout
tree. ``params_from_jax(..., master=True)`` keeps every leaf f32 for
training; ``params_to_jax`` turns the port's tree back into the JAX layout
and ``save_npz`` writes it in the bundles' format.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from gisnav_tpu_torch.pipeline.geopose import PipelineConfig
from gisnav_tpu_torch.pipeline.runners import (
    LEARNED_LG9_CONFIG,
    PRETRAINED_CONFIG,
    SEMIDENSE_CONFIG,
)

__all__ = ["WEIGHTS_DIR", "PRETRAINED_PATH", "LEARNED_LG9_PATH",
           "LOFTR_PATH", "load_npz", "load_pretrained", "save_npz",
           "params_from_jax", "params_to_jax", "infer_config_from_params",
           "load_bundled"]

WEIGHTS_DIR = os.environ.get(
    "GISNAV_TPU_WEIGHTS_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                 "weights"))
PRETRAINED_PATH = os.path.join(WEIGHTS_DIR, "gisnav_tpu_harris_lg5.npz")
LEARNED_LG9_PATH = os.path.join(WEIGHTS_DIR, "gisnav_tpu_learned_lg9.npz")
LOFTR_PATH = os.path.join(WEIGHTS_DIR, "gisnav_tpu_loftr.npz")


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


def load_pretrained(path: Optional[str] = None) -> Dict[str, Any]:
    """The bundle at ``path`` (default ``PRETRAINED_PATH``) as its
    JAX-layout numpy tree, as the JAX package's ``load_pretrained`` returns
    it; ``params_from_jax(tree, device)`` carries it to the card. Raises
    ``FileNotFoundError`` when there is no such file."""
    path = path or PRETRAINED_PATH
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no bundled weights at {path}; train with "
            "'python -m gisnav_tpu_torch train' or convert public "
            "checkpoints (features/convert.py, matching/convert.py)")
    return load_npz(path)


def _inner(tree):
    return tree["params"] if "params" in tree else tree


def _t(a, dtype, device):
    """A tensor of its own memory: never a view of the caller's array (a
    JAX array's host buffer, which a train step updating the tensor in
    place would write into while a dispatched JAX program still reads it)."""
    return torch.from_numpy(np.array(a, np.float32)).to(device=device,
                                                        dtype=dtype)


def _convert_superpoint(sp, device, master=False):
    wdtype = torch.float32 if master else torch.bfloat16
    out = {}
    for name, leaf in _inner(sp).items():
        k = np.asarray(leaf["kernel"], np.float32)
        kh, kw, cin, cout = k.shape
        if (kh, kw) == (3, 3):
            w = _t(k.reshape(9, cin, cout), wdtype, device)
        else:
            w = _t(k.reshape(cin, cout).T, wdtype, device)
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


def _convert_loftr(node, device):
    node = _inner(node)
    backbone = {
        name: {"weight": _t(np.transpose(np.asarray(leaf["kernel"]),
                                         (3, 2, 0, 1)), torch.float32,
                            device).contiguous(),
               "bias": _t(leaf["bias"], torch.float32, device)}
        for name, leaf in node["backbone"].items()}
    blocks = {k: _convert_dense_tree(v, device) for k, v in node.items()
              if k != "backbone"}
    return {"backbone": backbone, **blocks}


def params_from_jax(tree, device="cpu", master: bool = False
                    ) -> Dict[str, Any]:
    """JAX param tree (``{"superpoint": ..., "lightglue": ...}`` or
    ``{"loftr": ...}``, with or without the ``params`` level, numpy or jax
    arrays) -> the port's tree. ``master=True`` keeps every leaf f32 (the
    SuperPoint kernels too, unrounded): the masters training updates and
    casts at each use, as flax keeps f32 parameters."""
    out = {}
    if "superpoint" in tree:
        out["superpoint"] = _convert_superpoint(tree["superpoint"], device,
                                                master)
    if "lightglue" in tree:
        out["lightglue"] = _convert_dense_tree(_inner(tree["lightglue"]),
                                               device)
    if "loftr" in tree:
        out["loftr"] = _convert_loftr(tree["loftr"], device)
    return out


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def _dense_tree_to_jax(node):
    if "weight" in node:
        w = _np(node["weight"])
        if w.ndim == 2:  # Dense
            out = {"kernel": w.T.copy()}
            if "bias" in node:
                out["bias"] = _np(node["bias"])
            return out
        return {"scale": w, "bias": _np(node["bias"])}  # LayerNorm
    return {k: _dense_tree_to_jax(v) for k, v in node.items()}


def params_to_jax(tree) -> Dict[str, Any]:
    """The port's tree (either precision) -> the JAX layout as f32 numpy,
    with the ``params`` level: the inverse of :func:`params_from_jax`."""
    out: Dict[str, Any] = {}
    if "superpoint" in tree:
        sp = {}
        for name, leaf in tree["superpoint"].items():
            w = _np(leaf["weight"])
            if w.ndim == 3:  # (9, Cin, Cout)
                k = w.reshape(3, 3, w.shape[1], w.shape[2])
            else:  # Linear (out, in) -> (1, 1, in, out)
                k = w.T.reshape(1, 1, w.shape[1], w.shape[0])
            sp[name] = {"kernel": k.copy(), "bias": _np(leaf["bias"])}
        out["superpoint"] = {"params": sp}
    if "lightglue" in tree:
        out["lightglue"] = {"params": _dense_tree_to_jax(tree["lightglue"])}
    if "loftr" in tree:
        node = tree["loftr"]
        backbone = {
            name: {"kernel": np.transpose(_np(leaf["weight"]),
                                          (2, 3, 1, 0)).copy(),
                   "bias": _np(leaf["bias"])}
            for name, leaf in node["backbone"].items()}
        blocks = {k: _dense_tree_to_jax(v) for k, v in node.items()
                  if k != "backbone"}
        out["loftr"] = {"params": {"backbone": backbone, **blocks}}
    return out


def jax_leaf_layout(keys: Tuple[str, ...], shape: Tuple[int, ...]
                    ) -> Tuple[Tuple[str, ...], Tuple[int, ...], tuple]:
    """Where a leaf of the port's tree (``keys`` from the root, ``shape``)
    comes from in the JAX layout, as :func:`params_from_jax` converts it:
    the JAX leaf's keys (no ``params`` level), its JAX shape and, for each
    JAX axis, the port axis it becomes (None for the taps that a 1x1 or
    3x3 conv's conversion folds away). A leaf already in the JAX layout
    (``kernel``, ``scale``) maps to itself."""
    keys, shape = tuple(keys), tuple(shape)
    if keys[-1] != "weight":
        return keys, shape, tuple(range(len(shape)))
    if len(shape) == 1:  # LayerNorm scale
        return keys[:-1] + ("scale",), shape, (0,)
    keys = keys[:-1] + ("kernel",)
    if keys[0] == "superpoint":
        if len(shape) == 3:  # (9, Cin, Cout) <- (3, 3, Cin, Cout)
            return keys, (3, 3) + shape[1:], (None, None, 1, 2)
        # Linear (Cout, Cin) <- (1, 1, Cin, Cout)
        return keys, (1, 1, shape[1], shape[0]), (None, None, 1, 0)
    if len(shape) == 4:  # LoFTR conv (Cout, Cin, kh, kw) <- HWIO
        return keys, (shape[2], shape[3], shape[1], shape[0]), (2, 3, 1, 0)
    return keys, shape[::-1], (1, 0)  # Dense (out, in) <- (in, out)


def save_npz(path: str, tree) -> None:
    """Write a JAX-layout tree (numpy arrays or tensors) as the bundles are
    stored: keys flattened with ``/``, floats as float16, compressed. The
    JAX package's ``load_npz``, :func:`load_npz` and ``run --weights`` read
    it."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for key, value in node.items():
            name = f"{prefix}/{key}" if prefix else str(key)
            if isinstance(value, dict):
                walk(value, name)
            else:
                a = (value.detach().cpu().numpy()
                     if isinstance(value, torch.Tensor) else np.asarray(value))
                flat[name] = a.astype(np.float16) if a.dtype.kind == "f" else a

    walk(tree, "")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **flat)


def infer_config_from_params(params) -> PipelineConfig:
    """Config of a JAX-layout deep-weights tree, from ``PRETRAINED_CONFIG``
    as in the JAX package: LightGlue depth = number of ``self_N`` blocks;
    the detector head ``convPa`` means learned mode."""
    lg = params.get("lightglue")
    if lg is None:
        raise ValueError(
            "checkpoint has no 'lightglue' params - not a deep-mode bundle "
            f"(top-level keys: {sorted(params)})")
    depth = sum(1 for k in _inner(lg) if str(k).startswith("self_"))
    mode = ("learned" if "convPa" in _inner(params.get("superpoint", {}))
            else "harris")
    return dataclasses.replace(
        PRETRAINED_CONFIG,
        lightglue_depth=depth or PRETRAINED_CONFIG.lightglue_depth,
        detector_mode=mode)


def load_bundled(name: str = "harris_lg5"
                 ) -> Tuple[Dict[str, Any], PipelineConfig]:
    """Bundled weights by name -> (JAX-layout numpy tree, PipelineConfig):
    ``harris_lg5`` with ``PRETRAINED_CONFIG``, ``learned_lg9`` with
    ``LEARNED_LG9_CONFIG``, ``loftr`` with ``SEMIDENSE_CONFIG``."""
    bundles = {"harris_lg5": (PRETRAINED_PATH, PRETRAINED_CONFIG),
               "learned_lg9": (LEARNED_LG9_PATH, LEARNED_LG9_CONFIG),
               "loftr": (LOFTR_PATH, SEMIDENSE_CONFIG)}
    if name not in bundles:
        raise ValueError(f"unknown bundled weights {name!r}")
    path, config = bundles[name]
    return load_pretrained(path), config
