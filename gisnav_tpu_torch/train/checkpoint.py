"""Parameter checkpoints of the port's training.

Counterpart of ``gisnav_tpu/train/checkpoint.py`` (orbax there): a
checkpoint is ``<directory>/<step>/params.pt``, the port's parameter tree
saved with ``torch.save`` from the CPU, and only the newest three are kept
(orbax's ``max_to_keep=3``).
"""
from __future__ import annotations

import os
import shutil
from typing import Any, List, Optional

import torch

__all__ = ["save_params", "load_params", "latest_step"]

MAX_TO_KEEP = 3


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(n) for n in os.listdir(directory)
                  if n.isdigit() and os.path.isfile(
                      os.path.join(directory, n, "params.pt")))


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.detach().cpu().clone()


def save_params(directory: str, step: int, params: Any) -> None:
    """Save a params tree as checkpoint ``step`` under ``directory``."""
    path = os.path.join(os.path.abspath(directory), str(int(step)))
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, "params.pt.tmp")
    torch.save(_to_cpu(params), tmp)
    os.replace(tmp, os.path.join(path, "params.pt"))
    for old in _steps(directory)[:-MAX_TO_KEEP]:
        shutil.rmtree(os.path.join(directory, str(old)))


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def _like(tree, like, path=""):
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            raise ValueError(f"checkpoint tree differs from `like` at "
                             f"{path or '/'}")
        return {k: _like(tree[k], like[k], f"{path}/{k}") for k in like}
    if tuple(tree.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {path} has shape "
                         f"{tuple(tree.shape)}, expected {tuple(like.shape)}")
    return tree.to(device=like.device, dtype=like.dtype)


def load_params(directory: str, step: Optional[int] = None,
                like: Any = None) -> Any:
    """Restore a params tree (the latest step by default) on the CPU, or,
    with ``like``, in its structure, shapes, dtypes and devices."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    tree = torch.load(os.path.join(directory, str(int(step)), "params.pt"),
                      map_location="cpu", weights_only=True)
    return tree if like is None else _like(tree, like)
