"""Training step for the semi-dense LoFTR matcher.

Counterpart of ``gisnav_tpu/train/loftr_steps.py``: cross-entropy of the
coarse dual-softmax assignment against ground-truth cell correspondences
from the known 3x3 transform, plus a clamped L2 term on the fine-refined
keypoints of the selected matches. The JAX package runs LoFTR in XLA with
no Pallas kernel, so this is plain PyTorch: no kernel of the port launches
on this path. The pairs are a Python loop (LoFTR runs one pair a call).
On the card a chunk is one CUDA graph replay, as in ``train.steps``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from gisnav_tpu_torch.train.steps import (
    AdamW,
    TrainState,
    _optimizer_step,
    _run_chunk,
    curriculum,
    graphed,
    master_params,
)

__all__ = ["LoFTRTrainConfig", "init_loftr_train_state",
           "make_loftr_train_step", "make_loftr_device_train_chunk"]


@dataclasses.dataclass(frozen=True)
class LoFTRTrainConfig:
    image_shape: Tuple[int, int] = (128, 160)
    max_matches: int = 256
    depth: int = 2
    learning_rate: float = 1e-4
    weight_decay: float = 1e-5
    fine_loss_weight: float = 0.25
    # curriculum as in train.steps.TrainConfig
    curriculum_steps: int = 2000


def _model(config: LoFTRTrainConfig, params):
    from gisnav_tpu_torch.matching.loftr import LoFTR

    return LoFTR(params["loftr"], depth=config.depth,
                 max_matches=config.max_matches)


def init_loftr_train_state(generator: torch.Generator,
                           config: LoFTRTrainConfig, device=None):
    """flax's init of the JAX module's tree (``param_shapes`` at
    ``config.depth``), as f32 ``nn.Parameter`` masters on ``device``
    (``None``: the card, or raise without one)."""
    from gisnav_tpu_torch.device import resolve_device
    from gisnav_tpu_torch.matching.loftr import param_shapes
    from gisnav_tpu_torch.pipeline.geopose import _flax_init

    tree = {"loftr": {"params": _flax_init(param_shapes(depth=config.depth),
                                           generator)}}
    dev = resolve_device(device)
    params = master_params(tree, dev)
    tx = AdamW(config.learning_rate, weight_decay=config.weight_decay)
    return TrainState(params=params, opt_state=tx.init(params),
                      step=torch.zeros((), dtype=torch.int64,
                                       device=dev)), tx


def _coarse_gt(homography, h: int, w: int, stride: int = 8):
    """Ground-truth coarse assignment: for each image0 cell centre, the
    image1 cell index it lands in, or -1 outside; and the projections."""
    hc, wc = h // stride, w // stride
    dev = homography.device
    ys, xs = torch.meshgrid(torch.arange(hc, device=dev),
                            torch.arange(wc, device=dev), indexing="ij")
    centers = torch.stack([(xs.reshape(-1) + 0.5) * stride,
                           (ys.reshape(-1) + 0.5) * stride], dim=1).float()
    ones = torch.ones_like(centers[:, :1])
    proj = torch.cat([centers, ones], dim=1) @ homography.float().T
    proj = proj[:, :2] / torch.clamp(proj[:, 2:3], min=1e-6)
    cx = torch.floor(proj[:, 0] / stride).long()
    cy = torch.floor(proj[:, 1] / stride).long()
    inside = (cx >= 0) & (cx < wc) & (cy >= 0) & (cy < hc)
    return torch.where(inside, cy * wc + cx, torch.full_like(cx, -1)), proj


def make_loftr_train_step(config: LoFTRTrainConfig, tx: AdamW) -> Callable:
    del tx
    h, w = config.image_shape

    def per_pair(model, im0, im1, hom):
        matches, p = model.match(im0, im1, return_scores=True)
        gt_idx, _ = _coarse_gt(hom, h, w)
        pos = gt_idx >= 0
        p_gt = torch.gather(p, 1, torch.clamp(gt_idx, min=0)[:, None])[:, 0]
        zero = torch.zeros((), device=p.device)
        coarse = -torch.log(torch.clamp(p_gt, 1e-9, 1.0))
        coarse = torch.where(pos, coarse, zero).sum() / torch.clamp(
            pos.sum().float(), min=1.0)
        # fine loss: selected matches' kp1 against the GT projection of kp0
        ones = torch.ones_like(matches.kp0[:, :1])
        proj = torch.cat([matches.kp0, ones], dim=1) @ hom.float().T
        proj = proj[:, :2] / torch.clamp(proj[:, 2:3], min=1e-6)
        in1 = ((proj[:, 0] >= 0) & (proj[:, 0] < w) & (proj[:, 1] >= 0)
               & (proj[:, 1] < h))
        sel = matches.mask & in1
        d2 = torch.clamp(((matches.kp1 - proj) ** 2).sum(dim=1), max=64.0)
        fine = torch.where(sel, d2, zero).sum() / torch.clamp(
            sel.sum().float(), min=1.0)
        hit = (torch.argmax(p, dim=1) == gt_idx) & pos
        acc = hit.sum() / torch.clamp(pos.sum().float(), min=1.0)
        return coarse + config.fine_loss_weight * fine, acc

    def loss_fn(params, image0, image1, homography):
        model = _model(config, params)
        losses, accs = zip(*(per_pair(model, *pair) for pair in
                             zip(image0, image1, homography)))
        return torch.stack(losses).mean(), torch.stack(accs).mean()

    def train_step(state: TrainState, image0, image1, homography):
        return _optimizer_step(state, loss_fn, image0, image1, homography,
                               metric="coarse_acc")

    train_step.loss_fn = loss_fn
    return train_step


def make_loftr_device_train_chunk(config: LoFTRTrainConfig, tx: AdamW,
                                  batch_size: int, chunk: int = 10
                                  ) -> Callable:
    """``chunk`` steps on pairs generated on the device (see
    ``train.steps.make_device_train_chunk``); one graph replay on the
    card."""
    from gisnav_tpu_torch.train.device_data import device_batch

    step_fn = make_loftr_train_step(config, tx)

    def chunk_fn(state: TrainState, generator: torch.Generator):
        def batch(step):
            d = curriculum(step, config.curriculum_steps)
            return device_batch(
                generator, batch_size, config.image_shape,
                max_angle_deg=20.0 + 160.0 * d, max_scale=0.3 + 1.3 * d,
                max_shift=0.06 + 0.06 * d, max_blur_sigma=1.6 * d)

        return _run_chunk(state, step_fn, batch, chunk)

    return graphed(chunk_fn)
