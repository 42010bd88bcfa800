"""One cached-regime (asymmetric) training step of the port against the JAX
package's, on the CPU.

``make_cached_regime_train_step`` with the Harris detector (its
``CachedRegimeConfig`` default), a 64x80 query at 256 keypoints against a
128x160 reference at 256 keypoints on a 2x2 tile grid, LightGlue-1 (so the
attention is K5's Function at 256 / 256), from ``init_pipeline_params``
carried across from JAX, on a batch of ``device_batch_asymmetric`` from
the JAX module: the loss to 1e-3 relative, ``gt_recall`` to 0.05 and every
parameter's gradient within 5 % (relative norm; bf16 casts round sums in
other orders).
"""
import jax
import numpy as np
import torch

from gisnav_tpu.train import steps as JS
from gisnav_tpu.train.device_data import device_batch_asymmetric
from gisnav_tpu_torch.train import steps as TS
from gisnav_tpu_torch.weights import params_to_jax

torch.set_num_threads(2)

CFG = dict(q_shape=(64, 80), r_shape=(128, 160), q_keypoints=256,
           r_keypoints=256, r_tile_grid=(2, 2), lightglue_depth=1)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v, np.float32)
    return out


def test_cached_regime_step_vs_jax():
    jcfg, tcfg = JS.CachedRegimeConfig(**CFG), TS.CachedRegimeConfig(**CFG)
    jstate, jtx = JS.init_train_state(jax.random.PRNGKey(0), JS.TrainConfig(
        lightglue_depth=1, detector_mode="harris"))
    batch = device_batch_asymmetric(jax.random.PRNGKey(1), 2, CFG["q_shape"],
                                    CFG["r_shape"], max_angle_deg=45.0)
    step = JS.make_cached_regime_train_step(jcfg, jtx)
    loss_fn = [c.cell_contents for c in step.__closure__
               if getattr(c.cell_contents, "__name__", "") == "loss_fn"][0]
    (jl, jr), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jstate.params, *batch)

    params = TS.master_params(jax.tree.map(np.asarray, jstate.params),
                              "cpu")
    tx = TS.AdamW(tcfg.learning_rate, tcfg.weight_decay)
    state = TS.TrainState(params, tx.init(params),
                          torch.zeros((), dtype=torch.int64))
    state, m = TS.make_cached_regime_train_step(tcfg, tx)(
        state, *(torch.as_tensor(np.asarray(a)) for a in batch))
    assert abs(float(m["loss"]) - float(jl)) <= 1e-3 * abs(float(jl))
    assert abs(float(m["gt_recall"]) - float(jr)) <= 0.05
    got = _flat(params_to_jax(TS._map_tree(
        lambda p: torch.zeros_like(p) if p.grad is None else p.grad,
        params)))
    want = _flat(jax.tree.map(np.asarray, jg))
    assert set(got) == set(want)
    for key, w in want.items():
        assert np.linalg.norm(got[key] - w) <= 0.05 * np.linalg.norm(w) \
            + 1e-12, key
