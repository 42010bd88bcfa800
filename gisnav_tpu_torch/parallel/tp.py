"""Tensor parallelism over a mesh row: sharded leaves and the sharded Dense
product.

The JAX package output-shards every Dense kernel over the mesh's ``model``
axis (``parallel/mesh.py`` ``_tp_spec``) and lets XLA partition the
products that read them; its Pallas calls get their operands replicated.
Here the same happens explicitly, in one process:

- a :class:`Sharded` leaf is its list of shards, shard j on model slot j's
  device, split along the output axis;
- :func:`product` computes a Dense product output slice by slice, each
  slice on its shard's device with its weight shard, and gathers the slices
  back onto the input's device in shard order (``torch.cat``); autograd
  carries the gradient back through ``.to(device)`` and ``cat`` to each
  shard;
- :func:`whole` gathers a leaf onto one device, for an operand a kernel or
  an elementwise op takes whole.

A row whose slots are one device runs the same code: every ``.to`` is then
a no-op.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

__all__ = ["Sharded", "product", "whole", "map_tree", "leaves",
           "tree_device", "gather_tree"]


class Sharded:
    """A tensor split along ``axis`` into ``shards`` (shard j on model slot
    j's device), as JAX's ``addressable_shards`` of one mesh row hold it."""

    def __init__(self, shards: Sequence[torch.Tensor], axis: int):
        self.shards: List[torch.Tensor] = list(shards)
        self.axis = axis

    @classmethod
    def split(cls, t: torch.Tensor, devices: Sequence[torch.device],
              axis: int) -> "Sharded":
        """``t`` cut into ``len(devices)`` equal slices along ``axis``, slice
        j on ``devices[j]``."""
        return cls([s.to(d) for s, d in zip(t.chunk(len(devices), axis),
                                             devices)], axis)

    @property
    def devices(self) -> List[torch.device]:
        return [s.device for s in self.shards]

    @property
    def sizes(self) -> List[int]:
        return [s.shape[self.axis] for s in self.shards]

    @property
    def shape(self) -> torch.Size:
        shape = list(self.shards[0].shape)
        shape[self.axis] = sum(self.sizes)
        return torch.Size(shape)

    @property
    def T(self) -> "Sharded":  # noqa: N802 (torch's name)
        return self.map(lambda s: s.T, axis=1 - self.axis)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor],
            axis: Optional[int] = None) -> "Sharded":
        """``fn`` on every shard; ``axis`` where ``fn`` moves the split."""
        return Sharded([fn(s) for s in self.shards],
                       self.axis if axis is None else axis)

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: shard 0's, the row's
        first device), differentiable to every shard."""
        dev = self.shards[0].device if device is None else device
        return torch.cat([s.to(dev) for s in self.shards], dim=self.axis)

    def __repr__(self) -> str:
        return (f"Sharded({tuple(self.shape)}, axis={self.axis}, "
                f"devices={[str(d) for d in self.devices]})")


def whole(t, device=None):
    """``t`` whole: a :class:`Sharded` gathered onto ``device``, a tensor
    (or None) as it is."""
    return t.gather(device) if isinstance(t, Sharded) else t


def product(x: torch.Tensor, weight, bias, body: Callable) -> torch.Tensor:
    """``body(x, weight, bias)``, the Dense product with its casts, output
    slice by output slice where ``weight`` is :class:`Sharded` (split along
    its output axis): slice j is ``body`` of ``x`` on shard j's device with
    weight shard j and bias slice j, and the slices are gathered onto
    ``x``'s device in shard order along the last axis. A plain ``weight``
    is one product on ``x``'s device (a sharded bias gathered there)."""
    if not isinstance(weight, Sharded):
        return body(x, weight, whole(bias, x.device))
    if bias is None:
        biases = [None] * len(weight.shards)
    elif isinstance(bias, Sharded):
        biases = bias.shards
    else:
        biases = bias.split(weight.sizes)
    outs = [body(x.to(w.device), w, None if b is None else b.to(w.device))
            for w, b in zip(weight.shards, biases)]
    return torch.cat([o.to(x.device) for o in outs], dim=-1)


def map_tree(fn, tree, path=None):
    """``fn`` over the leaves of a tree of dicts, lists and tuples (named or
    not), keeping its structure; a :class:`Sharded` is a leaf. ``fn(leaf)``,
    or ``fn(path, leaf)`` where ``path`` is given (``()`` at the root): the
    keys from the root to the leaf, as strings."""
    def walk(node, keys):
        if isinstance(node, dict):
            return {k: walk(v, keys + (str(k),)) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v, keys) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, keys) for v in node)
        return fn(node) if path is None else fn(keys, node)

    return walk(tree, () if path is None else tuple(path))


def leaves(tree) -> List:
    """The leaves of a tree of dicts in insertion order, a :class:`Sharded`
    as itself."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in leaves(v)]
    return [tree]


def tree_device(tree) -> torch.device:
    """The device of a mesh row's tree: its first device, where replicated
    leaves and every shard 0 lie."""
    leaf = leaves(tree)[0]
    return leaf.shards[0].device if isinstance(leaf, Sharded) \
        else leaf.device


def gather_tree(tree):
    """A tree with every :class:`Sharded` leaf gathered onto the tree's
    first device; plain leaves as they are."""
    dev = tree_device(tree)
    return map_tree(lambda leaf: whole(leaf, dev), tree)
