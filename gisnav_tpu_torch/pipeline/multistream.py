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
from gisnav_tpu_torch.pipeline.graph import FrameGraph, _flatten

__all__ = ["build_multistream_pipeline", "shard_stream_batch"]


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
    them.
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

    def fn(models, queries, ref_feats, dems, ks, crs_affines, draws
           ) -> GeoPose:
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
        if dev.type != "cuda":
            return tick(models, queries, ref_feats, dems, ks, crs_affines,
                        draws, noise)
        if not isinstance(draws, torch.Tensor):
            draws = torch.as_tensor(np.asarray(draws), dtype=torch.long)
        args = (queries, ref_feats, dems, ks, crs_affines, draws)
        key = (id(models), noise, *((t.shape, t.dtype)
                                    for t in _flatten(args)[0]))
        if key not in graphs:
            streams = tuple(torch.cuda.Stream(dev) for _ in range(n)) \
                if fork_streams else ()
            graphs[key] = FrameGraph(
                lambda q, rf, d, k, a, dr: tick(models, q, rf, d, k, a, dr,
                                                noise, streams),
                dev, sticky=(1, 2))
            graphs[key].models = models  # held: the key is its identity
        return graphs[key](*args)

    fn.graphs = graphs
    return fn


def shard_stream_batch(mesh, batch_tree) -> Any:
    """Place a stream-batched tree with the leading axis over ``data``:
    ``parallel.mesh.shard_batch``, one block of streams a data slice."""
    from gisnav_tpu_torch.parallel.mesh import shard_batch

    return shard_batch(mesh, batch_tree)
