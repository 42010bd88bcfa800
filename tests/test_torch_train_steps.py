"""One training step of the port against the JAX package's, on the CPU.

``make_train_step`` (learned detector, LightGlue-1, 64x80 pairs, 256
keypoints: the attention runs through K5's Function, in its plain
version) from ``init_pipeline_params`` carried across from JAX, on one host
batch:

- loss within 1e-3 relative, ``gt_recall`` within 0.02 (a mutual argmax of
  near-uniform random-init scores may flip);
- the gradient of every parameter within 5 % (relative norm) of JAX's, and
  all of them within 2 % (the bf16 casts round sums in other orders);
- the AdamW update: the first step moves each parameter by about
  ``lr * sign(gradient)``, so an element whose gradient is a rounding error
  may move the other way. Every element within 2 lr + 1e-6 of JAX's
  update, and 95 % of them within 1e-6.

The optimizer and the losses alone: ``test_torch_train_losses.py``.

The initial state keeps its step counter on the params' device, as the JAX
state keeps its step on the device (the curriculum reads it inside a
chunk): with ``resolve_device`` pointed at another device than the CPU
(``meta``), ``init_train_state`` and ``init_loftr_train_state`` with
``device=None`` put the params and the step there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gisnav_tpu.train import steps as JS
from gisnav_tpu.train.data import make_homography_batch
from gisnav_tpu_torch.train import steps as TS
from gisnav_tpu_torch.weights import params_to_jax

torch.set_num_threads(2)

CFG = dict(image_shape=(64, 80), max_keypoints=256, lightglue_depth=1)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v, np.float32)
    return out


@pytest.mark.parametrize("which", ["superpoint_lightglue", "loftr"])
def test_initial_step_lies_with_the_params(monkeypatch, which):
    from gisnav_tpu_torch import device
    from gisnav_tpu_torch.train import loftr_steps as TL

    monkeypatch.setattr(device, "resolve_device",
                        lambda device=None: torch.device("meta"))
    gen = torch.Generator().manual_seed(0)
    if which == "loftr":
        state, _ = TL.init_loftr_train_state(gen, TL.LoFTRTrainConfig(
            depth=1))
    else:
        state, _ = TS.init_train_state(gen, TS.TrainConfig(**CFG))
    assert TS.tree_leaves(state.params)[0].device.type == "meta"
    assert state.step.device.type == "meta"
    assert state.step.dtype == torch.int64 and state.step.shape == ()


def _loss_fn(step):
    return [c.cell_contents for c in step.__closure__
            if getattr(c.cell_contents, "__name__", "") == "loss_fn"][0]


def test_train_step_vs_jax():
    jcfg, tcfg = JS.TrainConfig(**CFG), TS.TrainConfig(**CFG)
    jstate, jtx = JS.init_train_state(jax.random.PRNGKey(0), jcfg)
    jparams = jax.tree.map(np.asarray, jstate.params)
    batch = make_homography_batch(np.random.default_rng(0), 2,
                                  CFG["image_shape"])
    jargs = tuple(jnp.asarray(a) for a in batch)
    (jl, jr), jg = jax.jit(jax.value_and_grad(
        _loss_fn(JS.make_train_step(jcfg, jtx)), has_aux=True))(
        jstate.params, *jargs)
    upd, _ = jtx.update(jg, jstate.opt_state, jstate.params)
    jnew = optax.apply_updates(jstate.params, upd)

    params = TS.master_params(jparams, "cpu")
    tx = TS.AdamW(tcfg.learning_rate, tcfg.weight_decay)
    state = TS.TrainState(params, tx.init(params),
                          torch.zeros((), dtype=torch.int64))
    state, m = TS.make_train_step(tcfg, tx)(
        state, *(torch.as_tensor(a) for a in batch))
    assert int(state.step) == 1
    assert abs(float(m["loss"]) - float(jl)) <= 1e-3 * abs(float(jl))
    assert abs(float(m["gt_recall"]) - float(jr)) <= 0.02

    grads = _flat(params_to_jax(TS._map_tree(lambda p: p.grad, params)))
    jgrads = _flat(jax.tree.map(np.asarray, jg))
    assert set(grads) == set(jgrads)
    num = den = 0.0
    for key, want in jgrads.items():
        diff = np.linalg.norm(grads[key] - want)
        assert diff <= 0.05 * np.linalg.norm(want) + 1e-12, key
        num, den = num + diff ** 2, den + np.linalg.norm(want) ** 2
    assert np.sqrt(num / den) <= 0.02

    got = _flat(params_to_jax(params))
    want = _flat(jax.tree.map(np.asarray, jnew))
    lr = tcfg.learning_rate
    diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert diffs.max() <= 2 * lr + 1e-6
    assert (diffs <= 1e-6).mean() >= 0.95
