"""Training loop of the self-supervised matcher training.

Counterpart of ``gisnav_tpu/train/loop.py`` (``train``), also run by
``python -m gisnav_tpu_torch train``::

    from gisnav_tpu_torch.train.loop import train
    params = train(steps=1000, ckpt_dir="ckpt")  # on the card

On the card the pairs are generated on the device and the loop advances in
chunks of 10 steps, reading the metrics once a chunk; on the CPU
(``device="cpu"``) the host generator feeds one step at a time. The config's
type picks the model: ``TrainConfig`` (SuperPoint + LightGlue, symmetric
pairs), ``CachedRegimeConfig`` (the asymmetric cached-reference fine-tune of
``tools/finetune_bundle.py``, device pairs only) or ``LoFTRTrainConfig``.
"""
from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch

from gisnav_tpu_torch.device import resolve_device, strict_fp32
from gisnav_tpu_torch.train.checkpoint import save_params
from gisnav_tpu_torch.train.data import make_homography_batch
from gisnav_tpu_torch.train.steps import (
    CachedRegimeConfig,
    TrainConfig,
    TrainState,
    init_train_state,
    make_train_step,
    master_params,
)

__all__ = ["train", "CHUNK"]

log = logging.getLogger("gisnav_tpu_torch.train")

CHUNK = 10  # steps a device chunk (the JAX loop's fixed scan length)


def _structure(tree, prefix=""):
    """{path: shape} of a nested dict of arrays or tensors."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}"
        if isinstance(value, dict):
            out.update(_structure(value, path))
        else:
            out[path] = tuple(np.shape(value))
    return out


def _init_state(config, seed: int, device):
    gen = torch.Generator().manual_seed(seed)
    if isinstance(config, CachedRegimeConfig):
        return init_train_state(gen, TrainConfig(
            lightglue_depth=config.lightglue_depth,
            detector_mode=config.detector_mode,
            learning_rate=config.learning_rate,
            weight_decay=config.weight_decay), device)
    if type(config).__name__ == "LoFTRTrainConfig":
        from gisnav_tpu_torch.train.loftr_steps import init_loftr_train_state

        return init_loftr_train_state(gen, config, device)
    return init_train_state(gen, config, device)


def train(
    steps: int = 1000,
    batch_size: int = 8,
    config=None,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 200,
    log_every: int = 20,
    seed: int = 0,
    device_data: Optional[bool] = None,
    init_params=None,
    device=None,
):
    """Run self-supervised training; returns the port's params tree.

    ``device`` is ``cuda`` unless the caller asks for the CPU (raises without
    a card). ``device_data`` defaults to True on the card (pairs generated on
    the device, ``CHUNK`` steps a host read) and False on the CPU (the host
    generator, one step at a time). ``init_params``: a JAX-layout tree (a
    bundle from ``weights.load_bundled`` or ``load_npz``) to start from
    instead of the random init, with a fresh optimizer; its structure must
    match the config's architecture (``ValueError`` otherwise).
    """
    config = config or TrainConfig()
    dev = resolve_device(device)
    strict_fp32()
    if device_data is None:
        device_data = dev.type != "cpu"
    is_loftr = type(config).__name__ == "LoFTRTrainConfig"
    cached = isinstance(config, CachedRegimeConfig)
    state, tx = _init_state(config, seed, dev)
    if init_params is not None:
        from gisnav_tpu_torch.weights import params_to_jax

        want = _structure(params_to_jax(state.params))
        got = _structure(init_params)
        if got != want:
            raise ValueError(
                "init_params tree structure does not match the config's "
                f"architecture: {sorted(got)} vs {sorted(want)}")
        params = master_params(init_params, dev)
        state = TrainState(params=params, opt_state=tx.init(params),
                           step=state.step)
    t0 = time.time()

    if device_data:
        if is_loftr:
            from gisnav_tpu_torch.train.loftr_steps import (
                make_loftr_device_train_chunk as make_chunk,
            )
        elif cached:
            from gisnav_tpu_torch.train.steps import (
                make_cached_regime_chunk as make_chunk,
            )
        else:
            from gisnav_tpu_torch.train.steps import (
                make_device_train_chunk as make_chunk,
            )
        chunk_fn = make_chunk(config, tx, batch_size, chunk=CHUNK)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 1)
        metric_key = "coarse_acc" if is_loftr else "gt_recall"
        done = 0
        while done < steps:
            state, metrics = chunk_fn(state, gen)
            done += CHUNK
            log.info("step %d loss %.4f %s %.3f (%.2f steps/s)", done,
                     float(metrics["loss"]), metric_key,
                     float(metrics[metric_key]), done / (time.time() - t0))
            if ckpt_dir and (done % ckpt_every < CHUNK or done >= steps):
                save_params(ckpt_dir, done, state.params)
        return state.params
    if is_loftr or cached:
        raise NotImplementedError(
            "LoFTR and cached-regime training use the on-device data path; "
            "pass device_data=True (or run on the card)")

    step_fn = make_train_step(config, tx)
    rng = np.random.default_rng(seed)
    for i in range(1, steps + 1):
        batch = make_homography_batch(rng, batch_size, config.image_shape)
        state, metrics = step_fn(
            state, *(torch.as_tensor(a, device=dev) for a in batch))
        if i % log_every == 0:
            log.info("step %d loss %.4f gt_recall %.3f (%.2f steps/s)", i,
                     float(metrics["loss"]), float(metrics["gt_recall"]),
                     i / (time.time() - t0))
        if ckpt_dir and (i % ckpt_every == 0 or i == steps):
            save_params(ckpt_dir, i, state.params)
    return state.params
