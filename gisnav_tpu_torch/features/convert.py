"""SuperPoint weight conversion: PyTorch checkpoint -> JAX-layout tree.

The port's copy of ``gisnav_tpu/features/convert.py``: the public MagicLeap
``superpoint_v1.pth`` state dict (or any mapping with the same layer names)
becomes the JAX package's SuperPoint tree (conv kernels OIHW -> HWIO, f32),
which ``weights.params_from_jax`` takes like a bundled one. No network
access: pass a local checkpoint path or a loaded mapping.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

__all__ = ["superpoint_params_from_torch", "load_superpoint_checkpoint",
           "SUPERPOINT_LAYERS"]

SUPERPOINT_LAYERS = (
    "conv1a", "conv1b", "conv2a", "conv2b",
    "conv3a", "conv3b", "conv4a", "conv4b",
    "convPa", "convPb", "convDa", "convDb",
)


def to_numpy(v) -> np.ndarray:
    """A tensor (any device) or array-like -> numpy array."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def superpoint_params_from_torch(state_dict: Mapping[str, object]) -> Dict:
    """SuperPoint state dict -> ``{"params": {layer: {"kernel", "bias"}}}``.

    :param state_dict: ``<layer>.weight`` / ``<layer>.bias`` for every layer
        of :data:`SUPERPOINT_LAYERS`; module prefixes (``net.``) are
        stripped.
    """
    flat = {}
    for key, value in state_dict.items():
        k = key.split(".")
        if len(k) >= 2:
            flat[(k[-2], k[-1])] = to_numpy(value)

    params = {}
    for layer in SUPERPOINT_LAYERS:
        if (layer, "weight") not in flat:
            raise KeyError(
                f"missing '{layer}.weight' in checkpoint "
                f"(found layers: {sorted({a for a, _ in flat})})")
        w = flat[(layer, "weight")]
        b = flat[(layer, "bias")]
        params[layer] = {
            "kernel": np.transpose(w, (2, 3, 1, 0)).astype(np.float32),
            "bias": b.astype(np.float32)}
    return {"params": params}


def load_superpoint_checkpoint(path: str) -> Dict:
    """Load a ``.pth`` checkpoint on the CPU (tensors only) and convert."""
    import torch

    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return superpoint_params_from_torch(state)
