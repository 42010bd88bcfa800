"""Multi-stream scale-out: N camera feeds in one device program.

The port's counterpart of ``gisnav_tpu/pipeline/multistream.py``, which
vmaps the cached-reference frame over a leading stream axis and jits it.
Each stream has its own query frame, reference features, DEM, intrinsics,
CRS affine and RANSAC draw; the models are shared.

On the card a tick is one CUDA graph (``pipeline.graph.FrameGraph``) that
holds the N cached frame programs. By default each program is captured on
a stream of its own, forked from the capture stream and joined back to it,
so the graph's N branches are independent and the card overlaps the small
kernels of different feeds; ``fork_streams=False`` captures them one after
another on one stream. On the CPU the same frame function runs stream by
stream.

:func:`build_mesh_multistream_pipeline` runs the tick over a ``(data,
model)`` mesh, the counterpart of the JAX package's jitted multistream
program on sharded streams and weights: each data row runs its block of
streams on its first device with its own tree of the weights
(``parallel.mesh.shard_params_tp``: LightGlue's Dense products over the
row's model slots), and the poses are gathered back in stream order.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Sequence

import numpy as np
import torch

from gisnav_tpu_torch.pipeline.geopose import (
    GeoPose,
    PipelineConfig,
    build_frame_to_geopose_cached,
)
from gisnav_tpu_torch.pipeline.graph import (
    FrameGraph,
    _flatten,
    side_streams,
)

__all__ = ["build_multistream_pipeline", "build_mesh_multistream_pipeline",
           "shard_stream_batch"]


def _stack(poses: Sequence[GeoPose]) -> GeoPose:
    return GeoPose(*(torch.stack(field) for field in zip(*poses)))


def _is_generators(draws) -> bool:
    return isinstance(draws, (list, tuple)) and len(draws) > 0 and all(
        isinstance(g, torch.Generator) for g in draws)


def build_multistream_pipeline(config: PipelineConfig,
                               fork_streams: bool = True
                               ) -> Callable[..., GeoPose]:
    """The cached-reference frame over a leading stream axis.

    Returned signature::

        fn(models, queries, ref_feats, dems, ks, crs_affines, draws)
            -> GeoPose

    where ``queries`` (n, h, w), every field of ``ref_feats``, ``dems``,
    ``ks`` and ``crs_affines`` have a leading ``(n_streams,)`` axis and the
    result is a :class:`GeoPose` with that axis on every field. ``draws``
    is either one ``torch.Generator`` a stream (RANSAC's noise is drawn from
    each, outside the graph) or the RANSAC samples: an (n, num_hypotheses,
    4) index tensor, or on the CPU a sequence of per-stream ``sample_idx``
    entries (arrays or callables of the match mask, as the frame program
    takes them). On the card one graph is captured per models object and
    input signature and replayed for every later tick; ``fn.graphs`` holds
    them. ``graph=False`` runs the tick eagerly on the card, the streams one
    after another.
    """
    frame_fn = build_frame_to_geopose_cached(config)
    graphs: Dict[tuple, FrameGraph] = {}

    def tick(models, queries, ref_feats, dems, ks, affs, draws,
             noise: bool, streams=()):
        def one(i):
            feats = type(ref_feats)(*(f[i] for f in ref_feats))
            kw = {"noise": draws[i]} if noise else {"sample_idx": draws[i]}
            return frame_fn(models, queries[i], feats, dems[i], ks[i],
                            affs[i], **kw)

        n = int(queries.shape[0])
        if not streams:
            return _stack([one(i) for i in range(n)])
        # one branch a stream: each waits for the tick's inputs and the
        # tick's end waits for every branch
        cur = torch.cuda.current_stream(queries.device)
        poses = []
        for i, s in enumerate(streams):
            s.wait_stream(cur)
            with torch.cuda.stream(s):
                poses.append(one(i))
        for s in streams:
            cur.wait_stream(s)
        return _stack(poses)

    def fn(models, queries, ref_feats, dems, ks, crs_affines, draws,
           graph: bool = True) -> GeoPose:
        n = int(queries.shape[0])
        dev = queries.device if isinstance(queries, torch.Tensor) \
            else torch.device("cpu")
        if _is_generators(draws):
            from gisnav_tpu_torch.pnp.ransac import draw_noise

            if len(draws) != n:
                raise ValueError(f"{len(draws)} generators for {n} streams")
            draws = torch.stack([draw_noise(g, config.num_hypotheses,
                                            config.max_keypoints)
                                 for g in draws])
            noise = True
        else:
            noise = False
        if dev.type == "cuda" and not isinstance(draws, torch.Tensor):
            draws = torch.as_tensor(np.asarray(draws), dtype=torch.long)
        if isinstance(draws, torch.Tensor):
            draws = draws.to(dev)  # a generator of another card drew them
        if dev.type != "cuda" or not graph:
            return tick(models, queries, ref_feats, dems, ks, crs_affines,
                        draws, noise)
        args = (queries, ref_feats, dems, ks, crs_affines, draws)
        key = (id(models), noise, *((t.shape, t.dtype)
                                    for t in _flatten(args)[0]))
        if key not in graphs:
            streams = tuple(side_streams(dev, n)) if fork_streams else ()
            graphs[key] = FrameGraph(
                lambda q, rf, d, k, a, dr: tick(models, q, rf, d, k, a, dr,
                                                noise, streams),
                dev, sticky=(1, 2))
            graphs[key].models = models  # held: the key is its identity
        return graphs[key](*args)

    fn.graphs = graphs
    return fn


def build_mesh_multistream_pipeline(config: PipelineConfig
                                    ) -> Callable[..., GeoPose]:
    """The multistream tick over a ``(data, model)`` mesh.

    Returned signature::

        fn(mesh, row_models, blocks, draws) -> GeoPose

    ``row_models[i]`` is ``build_models`` of row i's tree from
    ``parallel.mesh.shard_params_tp``; ``blocks[i]`` is row i's block of
    ``shard_stream_batch(mesh, (queries, ref_feats, dems, ks,
    crs_affines))``; ``draws`` holds every stream's RANSAC draw in stream
    order (generators or sample indices, as
    :func:`build_multistream_pipeline` takes them). Row i runs its streams
    on its first device with its draws, on a side stream of its own
    (``parallel.mesh.run_rows``: the rows on one card overlap). A row whose
    slots are one card replays one graph a row as the single-device tick
    does; a row that spans cards runs eagerly (a CUDA graph captures one
    card's stream). ``fn.modes`` maps each row to ``"graph"``, ``"eager"``
    or ``"cpu"``. The result lies on row 0's first device, stream i of the
    output being stream i of the input.
    """
    from gisnav_tpu_torch.parallel.mesh import run_rows

    tick = build_multistream_pipeline(config)
    modes: Dict[int, str] = {}
    streams: Dict[int, torch.cuda.Stream] = {}

    def fn(mesh, row_models, blocks, draws) -> GeoPose:
        if len(row_models) != len(blocks):
            raise ValueError(f"{len(row_models)} model rows for "
                             f"{len(blocks)} blocks")
        calls, start = [], 0
        for i, (models, block) in enumerate(zip(row_models, blocks)):
            n = int(block[0].shape[0])
            dev = block[0].device
            graph = mesh.row_on_one_device(i)
            modes[i] = ("graph" if graph else "eager") \
                if dev.type == "cuda" else "cpu"
            calls.append((dev, lambda m=models, b=block, d=draws[
                start:start + n], g=graph: tick(m, *b, d, graph=g)))
            start += n
        if start != len(draws):
            raise ValueError(f"{len(draws)} draws for {start} streams")
        poses = run_rows(calls, streams)
        out = blocks[0][0].device
        return GeoPose(*(torch.cat([f.to(out) for f in fields])
                         for fields in zip(*poses)))

    fn.modes = modes
    fn.graphs = tick.graphs
    return fn


def shard_stream_batch(mesh, batch_tree) -> Any:
    """Place a stream-batched tree with the leading axis over ``data``:
    ``parallel.mesh.shard_batch``, one block of streams a data slice."""
    from gisnav_tpu_torch.parallel.mesh import shard_batch

    return shard_batch(mesh, batch_tree)
