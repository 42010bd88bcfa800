"""One LoFTR training step of the port against the JAX package's.

``make_loftr_train_step`` (64x80 pairs, LoFTR-1, 32 matches) from the JAX
init carried across, on one batch of two pairs: the loss to 1e-3 relative,
``coarse_acc`` to 0.05 (an argmax of near-uniform random-init scores may
flip), the gradient of every parameter within 5 % (relative norm; f32
throughout, but the top-K of the mutual scores may pick another tied cell,
which moves the fine term), and ``_coarse_gt`` exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from gisnav_tpu.train import loftr_steps as JL
from gisnav_tpu.train.data import make_homography_batch
from gisnav_tpu_torch.train import loftr_steps as TL
from gisnav_tpu_torch.train import steps as TS
from gisnav_tpu_torch.weights import params_to_jax

torch.set_num_threads(2)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v, np.float32)
    return out


def test_coarse_gt_vs_jax():
    hom = make_homography_batch(np.random.default_rng(2), 1,
                                (64, 80)).homography[0]
    idx, proj = TL._coarse_gt(torch.as_tensor(hom), 64, 80)
    jidx, jproj = JL._coarse_gt(jnp.asarray(hom), 64, 80)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(proj.numpy(), np.asarray(jproj), atol=1e-4)


def test_loftr_step_vs_jax():
    kw = dict(image_shape=(64, 80), max_matches=32, depth=1)
    jcfg, tcfg = JL.LoFTRTrainConfig(**kw), TL.LoFTRTrainConfig(**kw)
    jstate, jtx = JL.init_loftr_train_state(jax.random.PRNGKey(0), jcfg)
    batch = make_homography_batch(np.random.default_rng(0), 2, (64, 80))
    step = JL.make_loftr_train_step(jcfg, jtx)
    loss_fn = [c.cell_contents for c in step.__closure__
               if getattr(c.cell_contents, "__name__", "") == "loss_fn"][0]
    (jl, jacc), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jstate.params, *(jnp.asarray(a) for a in batch))

    params = TS.master_params(jax.tree.map(np.asarray, jstate.params),
                              "cpu")
    tx = TS.AdamW(tcfg.learning_rate, tcfg.weight_decay)
    state = TS.TrainState(params, tx.init(params),
                          torch.zeros((), dtype=torch.int64))
    state, m = TL.make_loftr_train_step(tcfg, tx)(
        state, *(torch.as_tensor(a) for a in batch))
    assert int(state.step) == 1
    assert abs(float(m["loss"]) - float(jl)) <= 1e-3 * abs(float(jl))
    assert abs(float(m["coarse_acc"]) - float(jacc)) <= 0.05
    got = _flat(params_to_jax(TS._map_tree(lambda p: p.grad, params)))
    want = _flat(jax.tree.map(np.asarray, jg))
    assert set(got) == set(want)
    for key, w in want.items():
        assert np.linalg.norm(got[key] - w) <= 0.05 * np.linalg.norm(w) \
            + 1e-12, key
