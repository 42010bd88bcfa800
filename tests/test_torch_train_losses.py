"""The optimizer and the losses of the port's training against the JAX
package's, on shared inputs.

- ``AdamW`` against ``optax.adamw``: three updates on the same gradients,
  to 1e-6 (the same update: betas 0.9 / 0.999, eps 1e-8 outside the square
  root, the decay on the old parameter).
- ``_ground_truth_assignment`` and ``_harris_cell_labels`` exactly;
  ``matcher_loss`` and ``detector_distill_loss`` to 1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from gisnav_tpu.train import steps as JS
from gisnav_tpu.train.data import make_homography_batch
from gisnav_tpu_torch.train import steps as TS

torch.set_num_threads(2)


def test_adamw_matches_optax():
    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=(7, 5)).astype(np.float32),
          "b": {"c": rng.normal(size=(11,)).astype(np.float32)}}
    grads = [jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
        np.float32), p0) for _ in range(3)]
    tx = optax.adamw(1e-3, weight_decay=1e-2)
    jp, opt = jax.tree.map(jnp.asarray, p0), None
    opt = tx.init(jp)
    tp = TS._map_tree(lambda a: torch.nn.Parameter(torch.tensor(a)), p0)
    topt = TS.AdamW(1e-3, weight_decay=1e-2).init(tp)
    for g in grads:
        upd, opt = tx.update(jax.tree.map(jnp.asarray, g), opt, jp)
        jp = optax.apply_updates(jp, upd)
        for leaf, gl in zip(TS.tree_leaves(tp), TS.tree_leaves(g)):
            leaf.grad = torch.tensor(gl)
        topt.step()
    for a, b in zip(TS.tree_leaves(tp), TS.tree_leaves(
            jax.tree.map(np.asarray, jp))):
        np.testing.assert_allclose(a.detach().numpy(), b, atol=1e-6, rtol=0)


def test_losses_vs_jax():
    rng = np.random.default_rng(4)
    b, k0, k1 = 2, 40, 48
    kp0 = rng.uniform(0, 80, (b, k0, 2)).astype(np.float32)
    kp1 = kp0[:, :k1 - 8] + rng.normal(0, 1.5, (b, k1 - 8, 2))
    kp1 = np.concatenate([kp1, rng.uniform(0, 80, (b, 8, 2))],
                         axis=1).astype(np.float32)
    m0, m1 = rng.random((b, k0)) > 0.2, rng.random((b, k1)) > 0.2
    hom = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
    hom[:, :2, 2] = rng.normal(0, 0.5, (b, 2))
    gt = TS._ground_truth_assignment(*(torch.as_tensor(a) for a in (
        kp0, m0, kp1, m1, hom)), 3.0)
    jgt = jax.vmap(lambda *a: JS._ground_truth_assignment(*a, 3.0))(
        kp0, m0, kp1, m1, hom)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(jgt))

    scores = rng.random((b, k0, k1)).astype(np.float32) / k1
    got = TS.matcher_loss(torch.as_tensor(scores), gt, torch.as_tensor(m0))
    want = jax.vmap(JS.matcher_loss)(scores, jgt, m0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)

    images = make_homography_batch(np.random.default_rng(1), 2,
                                   (64, 80)).image0
    labels = TS._harris_cell_labels(torch.as_tensor(images))
    jlabels = jax.vmap(JS._harris_cell_labels)(jnp.asarray(images))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    assert (labels.numpy() < 64).any() and (labels.numpy() == 64).any()
    logits = rng.normal(0, 2, (2, 8, 10, 65)).astype(np.float32)
    got = TS.detector_distill_loss(torch.as_tensor(logits),
                                   torch.as_tensor(images))
    want = JS.detector_distill_loss(jnp.asarray(logits), jnp.asarray(images))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
