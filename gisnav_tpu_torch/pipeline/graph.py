"""Frame programs captured as CUDA graphs: the port's counterpart of
``jax.jit``.

The JAX runners compile each frame into one device program
(``gisnav_tpu/pipeline/runners.py``: the bucketed per-frame program and one
cached frame a ``(shape, downsample)``). PyTorch runs a frame eagerly, as
hundreds of launches issued one by one from Python, and the card waits for
the host between them. :class:`FrameGraph` captures a frame program once
per input shape with ``torch.cuda.graph`` and replays it: one launch of the
whole frame from the host.

- **Inputs.** The program is a function of tensors only (nested tuples,
  lists and dicts of them). The first call copies each input into a static
  buffer on the card, warms up on a side stream and captures; every later
  call copies its inputs into those buffers and replays. Inputs may lie on
  the host (the query frame is uploaded straight into its buffer). The
  arguments named ``sticky`` (a bucket's features, a DEM) are copied only
  when the caller passes other tensor objects than last time; the program
  holds the last ones, so an identity is never reused while it is held.
- **Outputs.** Inside the graph every output is copied into one packed
  buffer; a replay returns views of one clone of it, which the next replay
  cannot overwrite. The first call returns the warm-up's own result: the
  same kernels on the same inputs.
- **Launch counts.** ``kernels.LAUNCHES`` is bumped by the kernel wrappers
  in Python, which a replay does not run. The counts the wrappers add
  while the graph is captured (no kernel runs then) are taken back and
  added on every replay, so a replayed frame counts what an eager frame
  counts.
- **Threads.** The capture runs under ``utils.devlock.device_lock`` with
  ``capture_error_mode="thread_local"``: another thread's device work (the
  fusion node's filters run outside that lock) neither joins nor breaks it.
  Copy-in, replay and copy-out hold the program's own lock.
- **No fallback.** A capture that fails raises :class:`CaptureError`; the
  program never runs the frame eagerly on the card instead. On the CPU
  (``device="cpu"``, asked for by the caller) it calls the function.
- **What a program must not do.** Read a value back to the host: a
  ``.item()``, a tensor in an ``if``, a 0-d tensor as an index, a
  ``torch.linalg`` call that checks its ``info`` (the ``_ex`` forms do
  not), ``torch.multinomial``; or copy from pageable host memory
  (``torch.tensor([...], device=...)``). PyTorch's default routes for the
  frame's small ``torch.linalg`` factorisations capture as they are.

Graphs live in the process that captured them (they are never written out)
and hold the weights of the models they were captured with.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from gisnav_tpu_torch.device import strict_fp32
from gisnav_tpu_torch.kernels import LAUNCHES
from gisnav_tpu_torch.utils.devlock import device_lock

__all__ = ["FrameGraph", "CaptureError"]

_ALIGN = 16  # byte alignment of each output inside the packed buffer


class CaptureError(RuntimeError):
    """A frame program could not be captured as a CUDA graph."""


def _flatten(tree) -> Tuple[List[torch.Tensor], Any]:
    """Leaves of a tree of tuples (named or not), lists and dicts, and the
    spec that :func:`_unflatten` rebuilds it from."""
    if isinstance(tree, torch.Tensor):
        return [tree], None
    if isinstance(tree, dict):
        keys = list(tree)
        leaves, specs = [], []
        for k in keys:
            sub, spec = _flatten(tree[k])
            leaves += sub
            specs.append((len(sub), spec))
        return leaves, ("dict", keys, specs)
    if isinstance(tree, (tuple, list)):
        leaves, specs = [], []
        for item in tree:
            sub, spec = _flatten(item)
            leaves += sub
            specs.append((len(sub), spec))
        return leaves, (type(tree), None, specs)
    raise TypeError(f"a frame program takes and returns tensors, got "
                    f"{type(tree).__name__}")


def _unflatten(spec, leaves: Sequence[torch.Tensor]):
    if spec is None:
        return leaves[0]
    kind, keys, specs = spec
    items, i = [], 0
    for n, sub in specs:
        items.append(_unflatten(sub, leaves[i:i + n]))
        i += n
    if kind == "dict":
        return dict(zip(keys, items))
    if kind in (tuple, list):
        return kind(items)
    return kind(*items)  # a NamedTuple


def _signature(leaves) -> list:
    return [(t.shape, t.dtype) for t in leaves]


class FrameGraph:
    """``fn(*args)`` captured once as a CUDA graph and replayed per call.

    :param fn: the frame program, a function of tensors returning a tree
        of tensors; it must not read a value back to the host
    :param device: the card it runs on; a CPU device calls ``fn`` eagerly
    :param sticky: indices of the arguments copied in only when their
        tensors change (by identity)

    After the capture, ``launches`` holds the kernel launches of one replay,
    ``capture_ms`` the capture's host time and ``pool_bytes`` the memory the
    capture reserved for the graph's private pool.
    """

    def __init__(self, fn: Callable, device, sticky: Sequence[int] = ()):
        self.fn = fn
        self.device = torch.device(device)
        self.sticky = frozenset(sticky)
        self.launches: dict = {}
        self.capture_ms: Optional[float] = None
        self.pool_bytes: Optional[int] = None
        self.replays = 0
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._lock = threading.Lock()

    def __call__(self, *args):
        if self.device.type != "cuda":
            return self.fn(*args)
        per_arg = [_flatten(a) for a in args]
        leaves = [t for sub, _ in per_arg for t in sub]
        if self._graph is None:
            return self._capture(per_arg, leaves)
        if _signature(leaves) != self._signature or \
                [s for _, s in per_arg] != self._specs:
            raise ValueError("a frame graph replays one input signature; "
                             "key a new one for other shapes or dtypes")
        with self._lock:
            for i, (src, dst, arg) in enumerate(
                    zip(leaves, self._static, self._leaf_arg)):
                if arg in self.sticky and src is self._held[i]:
                    continue
                dst.copy_(src)
                self._held[i] = src if arg in self.sticky else None
            self._graph.replay()
            packed = self._packed.clone()
            for name, n in self.launches.items():
                LAUNCHES[name] += n
            self.replays += 1
        return _unflatten(self._out_spec, [
            packed[off:off + size].view(dtype).view(shape)
            for off, size, dtype, shape in self._layout])

    def _capture(self, per_arg, leaves):
        dev = self.device
        with device_lock, self._lock, torch.no_grad():
            strict_fp32()
            self._static = [torch.empty(t.shape, dtype=t.dtype, device=dev)
                            .copy_(t) for t in leaves]
            self._leaf_arg = [a for a, (sub, _) in enumerate(per_arg)
                              for _ in sub]
            self._held = [t if a in self.sticky else None
                          for t, a in zip(leaves, self._leaf_arg)]
            self._signature = _signature(leaves)
            self._specs = [s for _, s in per_arg]
            static_args, i = [], 0
            for sub, spec in per_arg:
                static_args.append(_unflatten(spec, self._static[i:i + len(
                    sub)]))
                i += len(sub)

            # warm-up on a side stream (lazy handles and workspaces, the
            # kernels' one-time attribute queries); its result is this
            # call's result
            cur = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                out = self.fn(*static_args)
            cur.wait_stream(side)

            before = dict(LAUNCHES)
            graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            try:
                with torch.cuda.graph(graph,
                                      capture_error_mode="thread_local"):
                    reserved = torch.cuda.memory_reserved(dev)
                    captured = self.fn(*static_args)
                    self._pack(captured)
                torch.cuda.synchronize(dev)
            except Exception as e:  # noqa: BLE001 - re-raised as ours
                LAUNCHES.update(before)
                raise CaptureError(f"capturing the frame program failed: "
                                   f"{e}") from e
            self.capture_ms = (time.perf_counter() - t0) * 1e3
            self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
            self.launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                             if LAUNCHES[k] != before[k]}
            LAUNCHES.update(before)  # nothing ran while capturing
            self._graph = graph
        return out

    def _pack(self, outputs) -> None:
        """Inside the capture: one uint8 buffer holding every output, each
        at a 16-byte aligned offset (so a slice views back as its dtype)."""
        leaves, self._out_spec = _flatten(outputs)
        layout, off = [], 0
        for t in leaves:
            size = t.numel() * t.element_size()
            layout.append((off, size, t.dtype, t.shape))
            off += -(-size // _ALIGN) * _ALIGN
        self._packed = torch.empty(max(off, _ALIGN), dtype=torch.uint8,
                                   device=self.device)
        for (o, size, dtype, shape), t in zip(layout, leaves):
            self._packed[o:o + size].view(dtype).view(shape).copy_(t)
        self._layout = layout
