"""Device mesh + placement helpers for multi-stream scale-out.

The port's counterpart of ``gisnav_tpu/parallel/mesh.py``. The JAX package
builds a ``(data, model)`` ``jax.sharding.Mesh``: ``data`` batches camera
streams into one pjit'd program, ``model`` output-shards the Dense kernels
(XLA inserts the collectives). PyTorch has no sharded array behind one
program, so here a :class:`Mesh` is a grid of ``torch.device``s with the
same ``shape`` mapping, and placement is explicit:

- :func:`shard_batch` splits the leading (stream) axis into one block a
  data slice and puts each block on its slice's device;
- :func:`shard_params_tp` gives each data slice (a mesh row) its tree of
  the weights: a leaf that JAX's spec output-shards over ``model`` is a
  ``parallel.tp.Sharded``, slot j of row i holding JAX's shard j on
  ``devices[i, j]``; every other leaf is replicated onto the row's first
  device ``devices[i, 0]``. The programs read the shards through
  ``parallel.tp`` (the sharded Dense product; kernels take their operands
  gathered whole).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gisnav_tpu_torch.parallel.tp import Sharded, map_tree

__all__ = ["Mesh", "make_mesh", "shard_batch", "shard_params_tp",
           "run_rows"]


class Mesh:
    """A grid of devices with named axes (``devices[data, model]``)."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def row_on_one_device(self, i: int) -> bool:
        """Whether every slot of data row ``i`` is one device (a row laid
        over one card slot by slot): its programs can be one CUDA graph."""
        return len(set(self.devices[i])) == 1


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
    map_tree(lambda a: sizes.add(int(np.shape(a)[0])), batch)
    if len(sizes) != 1:
        raise ValueError(f"leaves disagree on the stream axis: {sizes}")
    n = sizes.pop()
    if n % n_data:
        raise ValueError(f"{n} streams do not divide over {n_data} data "
                         f"slices")
    b = n // n_data
    return [map_tree(lambda a, i=i: _to(a[i * b:(i + 1) * b],
                                        mesh.devices[i, 0]), batch)
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


def _split_axis(keys: Tuple[str, ...], shape: Tuple[int, ...],
                axes: Tuple[Optional[int], ...], model_axis: str,
                model_size: int) -> Optional[int]:
    """The port axis that JAX's spec splits over the model axis, or None
    where it replicates the leaf (the spec, or its divisibility fallback).
    The spec reads the leaf's JAX keys and shape; ``axes`` maps each JAX
    axis to the port's (``weights.jax_leaf_layout``)."""
    spec = _tp_spec("/".join(keys), np.broadcast_to(np.float32(0), shape),
                    model_axis)
    split = [d for d, n in enumerate(spec) if n is not None]
    if not split or any(shape[d] % model_size for d in split):
        return None
    return axes[split[0]]


def shard_params_tp(mesh: Mesh, params, model_axis: str = "model") -> List:
    """The weights of each data slice (mesh row), one tree a row.

    A leaf that the JAX package's ``shard_params_tp`` output-shards (its
    ``_tp_spec``, replicated where a dim does not divide by the model size)
    becomes a :class:`parallel.tp.Sharded` whose shard j is JAX's shard j,
    on ``devices[i, j]``; every other leaf is a tensor on the row's first
    device ``devices[i, 0]``. With a ``model`` axis of 1 every leaf is
    replicated, as the JAX package's specs cut to the axis size 1.
    """
    from gisnav_tpu_torch.weights import jax_leaf_layout

    model_size = mesh.shape[model_axis]

    def row(i):
        devs = list(mesh.devices[i])

        def place(keys, leaf):
            axis = None if model_size == 1 else _split_axis(
                *jax_leaf_layout(keys, np.shape(leaf)), model_axis,
                model_size)
            if axis is None:
                return _to(leaf, devs[0])
            whole = leaf.detach() if isinstance(leaf, torch.Tensor) \
                else torch.as_tensor(np.asarray(leaf))
            return Sharded.split(whole, devs, axis)

        return map_tree(place, params, path=())

    return [row(i) for i in range(mesh.devices.shape[0])]


def run_rows(calls: Sequence[Tuple[torch.device, Callable]],
             streams: Dict[int, "torch.cuda.Stream"]) -> List:
    """``fn()`` of each ``(device, fn)``, a mesh row's work on its first
    device, in order. A CUDA row runs on a side stream of its device
    (``streams`` keeps one a row), forked from the device's current stream
    and joined back to it after the last row, so the rows on one card
    overlap as the streams of one tick do; inside a graph capture the
    fork and join are the graph's branches. A CPU row runs in place."""
    from gisnav_tpu_torch.pipeline.graph import side_streams

    outs, forked = [], []
    for i, (dev, fn) in enumerate(calls):
        if dev.type != "cuda":
            outs.append(fn())
            continue
        stream = streams.get(i)
        if stream is None or stream.device != dev:
            stream = streams[i] = side_streams(dev, 1)[0]
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            outs.append(fn())
        forked.append(stream)
    for stream in forked:
        torch.cuda.current_stream(stream.device).wait_stream(stream)
    return outs
