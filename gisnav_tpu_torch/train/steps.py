"""Training steps for SuperPoint + LightGlue (joint, end to end).

Counterpart of ``gisnav_tpu/train/steps.py``. The step differentiates the
whole of the JAX step: SuperPoint on the ``xla_batched`` route
(``features.superpoint.superpoint_batched``) over the stacked (2B, H, W)
images, the module route of LightGlue (``matching.lightglue.lightglue_forward``)
over the B pairs at once in place of the JAX package's vmap, so that every
attention of a layer is one pair-batched ``MaskedAttention`` call (on the
card the CUDA kernel, with the JAX package's analytic gradient), the matcher
NLL against the known transform and, in ``learned`` mode, the Harris
distillation loss of the detector head. Gradients reach the detector head
through the keypoints' soft-argmax offsets, as in the JAX package.

PyTorch updates in place: ``TrainState.params`` is the port's tree of f32
``nn.Parameter`` masters, ``TrainState.opt_state`` a ``torch.optim.AdamW``
over its leaves (the update of ``optax.adamw``: betas 0.9 / 0.999, eps 1e-8
outside the square root, decay on the old parameter; ``capturable`` on the
card), and a step returns the same state with its device step counter
advanced in place. A chunk runs ``chunk`` steps on pairs generated on the
device under the curriculum and keeps its metrics on the device, averaged,
so the host reads them once a chunk as it reads a ``lax.scan``'s.

On the card a chunk is one CUDA graph replay (``pipeline.graph.FrameGraph``
with autograd on: forward, backward and AdamW of every step, the pair
draws from the caller's generator registered with the graph), the
counterpart of the JAX loop's jitted chunk; so is the host-data step, one
graph an input signature. A graph is captured per state (its optimizer)
and generator and holds them; the first call returns the side-stream
warm-up's result, a real chunk or step. ``fn.eager`` runs the same chunk
or step op by op. On the CPU both are the eager calls.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch
from torch import nn

from gisnav_tpu_torch.features.harris import harris_response
from gisnav_tpu_torch.features.nms import simple_nms
from gisnav_tpu_torch.features.superpoint import superpoint_batched
from gisnav_tpu_torch.matching.lightglue import lightglue_forward
from gisnav_tpu_torch.pipeline.graph import FrameGraph

__all__ = ["TrainConfig", "TrainState", "AdamW", "tree_leaves",
           "master_params", "init_train_state", "matcher_loss",
           "detector_distill_loss", "make_train_step", "CachedRegimeConfig",
           "make_cached_regime_train_step", "make_cached_regime_chunk",
           "make_device_train_chunk", "curriculum", "graphed"]


class TrainState(NamedTuple):
    params: Any  # the port's tree of f32 nn.Parameter masters
    opt_state: Any  # torch.optim.AdamW over the tree's leaves
    step: torch.Tensor  # () int64 on the params' device


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    image_shape: Tuple[int, int] = (128, 160)
    max_keypoints: int = 256
    lightglue_depth: int = 3
    learning_rate: float = 1e-4
    weight_decay: float = 1e-5
    gt_radius_px: float = 3.0  # keypoint-reprojection radius for positives
    detector_mode: str = "learned"  # "harris" = train descriptors/matcher only
    detector_loss_weight: float = 1.0  # Harris-distillation CE ("learned")
    # curriculum: augmentation difficulty ramps 0 -> 1 over this many steps
    curriculum_steps: int = 4000


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a nested dict in key order (the optimizer's order)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree)
                for leaf in tree_leaves(tree[key])]
    return [tree]


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def master_params(jax_tree, device) -> Dict[str, Any]:
    """A JAX-layout tree -> the port's tree of f32 ``nn.Parameter``s on
    ``device`` (``weights.params_from_jax(..., master=True)``)."""
    from gisnav_tpu_torch.weights import params_from_jax

    return _map_tree(lambda t: nn.Parameter(t.contiguous()),
                     params_from_jax(jax_tree, device, master=True))


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``optax.adamw(learning_rate, weight_decay)``: ``init`` binds a
    ``torch.optim.AdamW`` with the same update to a tree's leaves, built
    ``capturable`` (its step count and bias corrections on the device, in
    f32 as optax computes them) where the leaves lie on the card, so a
    graphed step can replay it."""

    learning_rate: float
    weight_decay: float = 1e-4

    def init(self, params) -> torch.optim.AdamW:
        leaves = tree_leaves(params)
        return torch.optim.AdamW(leaves, lr=self.learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=self.weight_decay,
                                 capturable=leaves[0].is_cuda)


def init_train_state(generator: torch.Generator, config: TrainConfig,
                     device=None) -> Tuple[TrainState, AdamW]:
    """Random init (``pipeline.geopose.init_pipeline_params``, drawn from
    ``generator`` on the CPU) moved to ``device`` (``None``: the card, or
    raise without one), and a fresh AdamW."""
    from gisnav_tpu_torch.device import resolve_device
    from gisnav_tpu_torch.pipeline.geopose import (
        PipelineConfig,
        init_pipeline_params,
    )

    pcfg = PipelineConfig(image_shape=config.image_shape,
                          max_keypoints=config.max_keypoints,
                          lightglue_depth=config.lightglue_depth,
                          detector_mode=config.detector_mode)
    dev = resolve_device(device)
    params = master_params(init_pipeline_params(generator, pcfg), dev)
    tx = AdamW(config.learning_rate, weight_decay=config.weight_decay)
    return TrainState(params=params, opt_state=tx.init(params),
                      step=torch.zeros((), dtype=torch.int64,
                                       device=dev)), tx


@torch.no_grad()
def _ground_truth_assignment(kp0, mask0, kp1, mask1, homography, radius):
    """GT match index of each kp0 from the known homography, or -1; any
    number of leading pair axes."""
    kp0, kp1 = kp0.detach(), kp1.detach()
    ones = torch.ones_like(kp0[..., :1])
    proj = torch.cat([kp0, ones], dim=-1) @ homography.transpose(-1, -2)
    proj = proj[..., :2] / torch.clamp(proj[..., 2:3], min=1e-6)
    d2 = ((proj[..., :, None, :] - kp1[..., None, :, :]) ** 2).sum(dim=-1)
    d2 = torch.where(mask1[..., None, :], d2,
                     torch.full_like(d2[..., :1, :1], float("inf")))
    nn_idx = torch.argmin(d2, dim=-1)
    ok = (d2.amin(dim=-1) < radius * radius) & mask0
    return torch.where(ok, nn_idx, torch.full_like(nn_idx, -1))


def matcher_loss(scores, gt_idx, mask0):
    """LightGlue-style NLL of (..., K0, K1) scores: -log P(i, gt_i) for
    positives, -log(1 - sum_j P(i, :)) for confirmed negatives; one value
    a pair."""
    pos = gt_idx >= 0
    p_match = torch.gather(scores, -1,
                           torch.clamp(gt_idx, min=0)[..., None])[..., 0]
    pos_loss = -torch.log(torch.clamp(p_match, 1e-9, 1.0))
    neg_loss = -torch.log(torch.clamp(1.0 - scores.sum(dim=-1), 1e-9, 1.0))
    zero = torch.zeros((), device=scores.device)
    loss = torch.where(pos, pos_loss, torch.where(mask0, neg_loss, zero))
    denom = torch.clamp(mask0.sum(dim=-1).float(), min=1.0)
    return loss.sum(dim=-1) / denom


@torch.no_grad()
def _harris_cell_labels(images: torch.Tensor, thr: float = 0.02
                        ) -> torch.Tensor:
    """(B, H, W) images -> (B, H/8, W/8) int64 cell labels distilling
    Harris: the index (0..63) of each 8x8 cell's NMS'd Harris argmax, or 64
    (the dustbin) where the cell has no corner above ``thr``."""
    b, h, w = images.shape
    hc, wc = h // 8, w // 8
    nms = simple_nms(harris_response(images.float()), radius=4)
    cells = nms.reshape(b, hc, 8, wc, 8).permute(0, 1, 3, 2, 4)
    cells = cells.reshape(b, hc, wc, 64)
    carg = torch.argmax(cells, dim=-1)
    return torch.where(cells.amax(dim=-1) > thr, carg,
                       torch.full_like(carg, 64))


def detector_distill_loss(logits: torch.Tensor,
                          images: torch.Tensor) -> torch.Tensor:
    """Cross-entropy of the (B, hc, wc, 65) detector cell logits against
    per-image Harris pseudo-labels."""
    labels = _harris_cell_labels(images)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None])[..., 0].mean()


def _match_loss(lg_params, depth, f0, size0, f1, size1, homography, radius):
    """Matcher NLL and GT recall, each the mean over the pairs."""
    res = lightglue_forward(lg_params, f0.keypoints, f0.descriptors,
                            f0.mask, size0, f1.keypoints, f1.descriptors,
                            f1.mask, size1, depth=depth)
    gt = _ground_truth_assignment(f0.keypoints, f0.mask, f1.keypoints,
                                  f1.mask, homography, radius)
    loss = matcher_loss(res.scores, gt, f0.mask).mean()
    hit = (res.matches0 == gt) & (gt >= 0)
    recall = hit.sum(dim=-1) / torch.clamp((gt >= 0).sum(dim=-1), min=1)
    return loss, recall.float().mean()


def _optimizer_step(state: TrainState, loss_fn, *batch,
                    metric: str = "gt_recall"):
    """One step in place: the gradients zeroed where they are (a graphed
    step keeps its buffers), forward and backward, AdamW, the step counter
    advanced on the device."""
    opt = state.opt_state
    opt.zero_grad(set_to_none=False)
    loss, aux = loss_fn(state.params, *batch)
    loss.backward()
    opt.step()
    state.step.add_(1)
    return state, {"loss": loss.detach(), metric: aux.detach()}


def graphed(fn) -> Callable:
    """``fn(state, *args) -> (state, metrics)``, a step or a chunk, replayed
    on the card as one graph a (state, generators, input signature): the
    tensor arguments (a batch) are the graph's inputs, the generator
    arguments (a chunk's pair draws, given first) are registered with it.
    A state is its step counter, its optimizer and its parameter tensors,
    each by identity: a state rebuilt around any other tensor (another
    step, as ``state._replace(step=...)`` makes) is captured anew. A graph
    lives as long as the returned function (``.graphs.clear()`` frees
    them) and holds its state and the gradient buffers the step writes and
    AdamW reads (a caller that sets them to None later, as
    ``zero_grad(set_to_none=True)`` does, must not free the graph's
    memory). On the CPU, and as ``.eager``, ``fn`` itself."""
    graphs: Dict[tuple, FrameGraph] = {}

    def call(state: TrainState, *args):
        if not state.step.is_cuda:
            return fn(state, *args)
        gens = tuple(a for a in args if isinstance(a, torch.Generator))
        batch = args[len(gens):]
        key = (id(state.step), id(state.opt_state),
               *map(id, tree_leaves(state.params)), *map(id, gens),
               *((tuple(b.shape), b.dtype) for b in batch))
        graph = graphs.get(key)
        if graph is not None:
            return state, graph(*batch)
        graph = graphs[key] = FrameGraph(
            lambda *b: fn(state, *gens, *b)[1], state.step.device,
            grad=True, generators=gens)
        try:
            metrics = graph(*batch)
        except BaseException:
            del graphs[key]
            raise
        graph.held = (state, gens,
                      [p.grad for p in tree_leaves(state.params)])
        return state, metrics

    call.eager = fn
    call.graphs = graphs
    return call


def _train_step_fn(config: TrainConfig) -> Callable:
    """The eager step of :func:`make_train_step`."""
    h, w = config.image_shape

    def loss_fn(params, image0, image1, homography):
        bsz = image0.shape[0]
        images = torch.cat([image0, image1], dim=0)
        feats, det_logits = superpoint_batched(
            params["superpoint"], images,
            max_keypoints=config.max_keypoints,
            detector_mode=config.detector_mode, return_logits=True)
        f0 = type(feats)(*(t[:bsz] for t in feats))
        f1 = type(feats)(*(t[bsz:] for t in feats))
        loss, recall = _match_loss(params["lightglue"],
                                   config.lightglue_depth, f0, (h, w), f1,
                                   (h, w), homography.float(),
                                   config.gt_radius_px)
        if det_logits is not None:
            loss = loss + config.detector_loss_weight * \
                detector_distill_loss(det_logits, images)
        return loss, recall

    def train_step(state: TrainState, image0, image1, homography):
        return _optimizer_step(state, loss_fn, image0, image1, homography)

    train_step.loss_fn = loss_fn  # (params, *batch) -> (loss, gt_recall)
    return train_step


def make_train_step(config: TrainConfig, tx: AdamW) -> Callable:
    """(state, image0, image1, homography) -> (state, metrics) over (B, H,
    W) image pairs and (B, 3, 3) transforms; ``tx`` is the state's
    optimizer's transformation (kept for the JAX signature). On the card
    one graph replay a step (:func:`graphed`)."""
    del tx
    eager = _train_step_fn(config)
    step = graphed(eager)
    step.loss_fn = eager.loss_fn  # (params, *batch) -> (loss, gt_recall)
    return step


@dataclasses.dataclass(frozen=True)
class CachedRegimeConfig:
    """Asymmetric (cached-reference deployment regime) fine-tune config: a
    small rotated query against a large north-up reference with a tiled
    keypoint budget."""

    q_shape: Tuple[int, int] = (256, 320)
    r_shape: Tuple[int, int] = (576, 640)
    q_keypoints: int = 256
    r_keypoints: int = 512
    r_tile_grid: Tuple[int, int] = (4, 4)
    lightglue_depth: int = 5
    learning_rate: float = 5e-5  # fine-tune from the symmetric checkpoint
    weight_decay: float = 1e-5
    gt_radius_px: float = 4.0  # in reference px (coarser than the query)
    detector_mode: str = "harris"
    curriculum_steps: int = 1000  # angle/blur ramp (scale stays asymmetric)


def make_cached_regime_train_step(config: CachedRegimeConfig,
                                  tx: AdamW) -> Callable:
    """Asymmetric step: query and reference through separate extractor
    settings (global top-K, tiled budget), then the matcher NLL against the
    known query -> reference transform."""
    del tx

    def loss_fn(params, query, ref, transform):
        sp = params["superpoint"]
        fq = superpoint_batched(sp, query, max_keypoints=config.q_keypoints,
                                detector_mode=config.detector_mode)
        fr = superpoint_batched(sp, ref, max_keypoints=config.r_keypoints,
                                detector_mode=config.detector_mode,
                                select_tiles=config.r_tile_grid)
        return _match_loss(params["lightglue"], config.lightglue_depth, fq,
                           config.q_shape, fr, config.r_shape,
                           transform.float(), config.gt_radius_px)

    def train_step(state: TrainState, query, ref, transform):
        return _optimizer_step(state, loss_fn, query, ref, transform)

    train_step.loss_fn = loss_fn
    return train_step


def curriculum(step: torch.Tensor, curriculum_steps: int) -> torch.Tensor:
    """Difficulty d = clip(step / curriculum_steps, 0, 1), on the device."""
    if curriculum_steps > 0:
        return torch.clamp(step.float() / curriculum_steps, 0.0, 1.0)
    return torch.ones((), device=step.device)


def _run_chunk(state, step_fn, batch_fn, chunk):
    metrics = []
    for _ in range(chunk):
        state, m = step_fn(state, *batch_fn(state.step))
        metrics.append(m)
    return state, {k: torch.stack([m[k] for m in metrics]).mean()
                   for k in metrics[0]}


def make_cached_regime_chunk(config: CachedRegimeConfig, tx: AdamW,
                             batch_size: int, chunk: int = 10) -> Callable:
    """(state, generator) -> (state, metrics): ``chunk`` asymmetric steps
    on pairs generated on the device; one graph replay on the card."""
    from gisnav_tpu_torch.train.device_data import device_batch_asymmetric

    step_fn = make_cached_regime_train_step(config, tx)

    def chunk_fn(state: TrainState, generator: torch.Generator):
        def batch(step):
            d = curriculum(step, config.curriculum_steps)
            return device_batch_asymmetric(
                generator, batch_size, config.q_shape, config.r_shape,
                max_angle_deg=30.0 + 150.0 * d, max_blur_sigma=1.2 * d,
                shadow_strength=0.45 * d)

        return _run_chunk(state, step_fn, batch, chunk)

    return graphed(chunk_fn)


def make_device_train_chunk(config: TrainConfig, tx: AdamW,
                            batch_size: int, chunk: int = 20) -> Callable:
    """(state, generator) -> (state, metrics): ``chunk`` train steps on
    pairs generated on the device (``train.device_data.device_batch``)
    under the curriculum; the metrics stay on the device, averaged. On the
    card one graph replay a chunk (:func:`graphed`)."""
    from gisnav_tpu_torch.train.device_data import device_batch

    del tx
    step_fn = _train_step_fn(config)

    def chunk_fn(state: TrainState, generator: torch.Generator):
        def batch(step):
            d = curriculum(step, config.curriculum_steps)
            return device_batch(
                generator, batch_size, config.image_shape,
                max_angle_deg=20.0 + 160.0 * d, max_scale=0.3 + 1.3 * d,
                max_shift=0.06 + 0.06 * d, max_blur_sigma=1.6 * d,
                shadow_strength=0.45 * d)

        return _run_chunk(state, step_fn, batch, chunk)

    return graphed(chunk_fn)
