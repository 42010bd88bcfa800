"""Device mesh + placement helpers for multi-stream scale-out.

The port's counterpart of ``gisnav_tpu/parallel/mesh.py``. The JAX package
builds a ``(data, model)`` ``jax.sharding.Mesh``: ``data`` batches camera
streams into one pjit'd program, ``model`` output-shards the Dense kernels
(XLA inserts the collectives). PyTorch has no sharded array behind one
program, so here a :class:`Mesh` is a grid of ``torch.device``s with the
same ``shape`` mapping, and placement is explicit:

- :func:`shard_batch` splits the leading (stream) axis into one block a
  data slice and puts each block on its slice's device;
- :func:`shard_params_tp` with a ``model`` axis of 1 replicates the weights
  onto each data slice's device. A ``model`` axis above 1 needs the Dense
  products inside the fused LightGlue block (K4) split across cards with
  their reductions between them; that forward, like the mesh-parallel train
  step, is not ported (``ROADMAP.md`` Queue 1 item 4) and raises.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "shard_batch", "shard_params_tp"]


class Mesh:
    """A grid of devices with named axes (``devices[data, model]``)."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              axis_names: Sequence[str] = ("data", "model"),
              devices: Optional[Sequence] = None) -> Mesh:
    """Create a (data, model) mesh over the available devices.

    :param n_devices: total devices to use (default: all)
    :param model_parallel: size of the model (tensor-parallel) axis
    :param devices: the devices to lay out (default: every CUDA card; a
        host without one raises unless devices are given)
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh lays out CUDA cards and this host "
                               "has none; pass devices=[...] for others")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by "
                         f"model={model_parallel}")
    grid = np.empty(n, dtype=object)
    grid[:] = devs[:n]
    return Mesh(grid.reshape(n // model_parallel, model_parallel),
                tuple(axis_names))


def _map(tree, fn):
    """``fn`` over the leaves (tensors, arrays) of a tree of dicts, lists
    and tuples (named or not), keeping its structure."""
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _to(leaf, device: torch.device) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.to(device)
    return torch.as_tensor(np.asarray(leaf), device=device)


def shard_batch(mesh: Mesh, batch) -> List:
    """One block of a stream-batched tree a ``data`` slice: block i holds
    streams ``[i * b, (i + 1) * b)`` of every leaf (``b`` = streams /
    data slices, which must divide) on the slice's device."""
    n_data = mesh.shape[mesh.axis_names[0]]
    sizes = set()
    _map(batch, lambda a: sizes.add(int(np.shape(a)[0])))
    if len(sizes) != 1:
        raise ValueError(f"leaves disagree on the stream axis: {sizes}")
    n = sizes.pop()
    if n % n_data:
        raise ValueError(f"{n} streams do not divide over {n_data} data "
                         f"slices")
    b = n // n_data
    return [_map(batch, lambda a, i=i: _to(a[i * b:(i + 1) * b],
                                           mesh.devices[i, 0]))
            for i in range(n_data)]


def _tp_spec(path_str: str, value, model_axis: str) -> tuple:
    """Tensor-parallel spec for one parameter, as the JAX package's
    ``PartitionSpec`` (a tuple of axis names, ``None`` for a replicated
    dim). Dense kernels (2D) shard their output features over the model
    axis; matching biases (1D) likewise; everything else (conv kernels,
    layernorm scales) is replicated."""
    if value.ndim == 2 and "kernel" in path_str:
        return (None, model_axis)
    if value.ndim == 1 and "bias" in path_str and value.shape[0] % 2 == 0:
        return (model_axis,)
    return ()


def shard_params_tp(mesh: Mesh, params, model_axis: str = "model") -> List:
    """The weights on each data slice's device, one tree a slice.

    With a ``model`` axis of 1 this is replication (the JAX package's
    ``NamedSharding`` with every spec cut to the axis size 1). A larger
    ``model`` axis needs the tensor-parallel forward, which is not ported:
    it raises ``NotImplementedError``.
    """
    if mesh.shape[model_axis] > 1:
        raise NotImplementedError(
            "a model axis above 1 needs the tensor-parallel forward (the "
            "Dense products inside the fused LightGlue block split across "
            "cards) and the mesh-parallel train step; neither is ported "
            "(ROADMAP.md Queue 1 item 4)")
    return [_map(params, lambda a, d=d: _to(a, d))
            for d in mesh.devices[:, 0]]
