"""The training routes of the port's models against the JAX package's.

- Selection (``select_keypoints(..., prefer_kernel=False)``, the JAX
  package's ``prefer_pallas=False`` route, and its tiled variant): the
  keypoints as a set (the top-K over more than 128 cells may order tied
  cells differently) to 1e-5 px, and the gradient of an order-free scalar
  of the valid keypoints with respect to the heatmap (it flows through the
  soft-argmax offsets) to 1e-4 of its largest |value|.
- SuperPoint on the ``xla_batched`` route (trained learned_lg9 weights, so
  that the heatmap has real peaks): the detector logits to 2e-2 plus 1 %
  (they reach ~8; the bf16 activations round at 2^-8), the valid
  keypoints as a set to 1e-2 px (their soft-argmax offsets read a heatmap
  of those logits at temperature 0.1), and the parameter gradients of
  order-free scalars of the keypoints, the descriptors and the logits
  within 5 % (relative norm; bf16 convs round sums in other orders).
- LightGlue's trainable route over two pairs (random init, LightGlue-1 at
  256 keypoints, so the attention is K5's Function): ``scores`` to 1e-3
  and the gradients of a weighted sum of them with respect to every
  parameter, the keypoints and the descriptors within 5 %.
- The rounding of the one LightGlue forward that the inference module and
  training share, against flax: ``Dense(dtype=bfloat16)`` (the product of
  bf16 operands formed in f32 and rounded once) within one bf16 ulp of
  flax's output everywhere and exact on at least 99.9 % of it, and never
  further from flax than a bf16 matmul (the alternative form); the same
  output from f32 masters and from weights rounded to bf16 beforehand;
  ``LayerNorm(dtype=float32)`` within 1e-5 (f32 reductions in another
  order).
"""
import jax
import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gisnav_tpu.features import nms as jnms
from gisnav_tpu.features.superpoint import SuperPoint as JSP
from gisnav_tpu.matching.lightglue import LightGlue as JLG
from gisnav_tpu.train.data import make_homography_batch
from gisnav_tpu_torch.features import nms as tnms
from gisnav_tpu_torch.features.superpoint import superpoint_batched
from gisnav_tpu_torch.matching.lightglue import (
    _dense_bf16,
    _layer_norm,
    lightglue_forward,
)
from gisnav_tpu_torch.pipeline.geopose import (
    _flax_init,
    lightglue_param_shapes,
)
from gisnav_tpu_torch.train.steps import _map_tree, master_params
from gisnav_tpu_torch.weights import load_bundled, params_to_jax

torch.set_num_threads(2)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v, np.float32)
    return out


def _assert_grads(got_tree, want_tree, rel=0.05):
    got, want = _flat(got_tree), _flat(want_tree)
    assert set(got) == set(want)
    for key, w in want.items():
        assert np.linalg.norm(got[key] - w) <= rel * np.linalg.norm(w) \
            + 1e-12, (key, np.linalg.norm(got[key] - w), np.linalg.norm(w))


def _heatmaps(seed, b, h, w):
    rng = np.random.default_rng(seed)
    return (rng.random((b, h, w)) ** 6).astype(np.float32)


def _set(kp, valid):
    kp = np.asarray(kp)[np.asarray(valid)]
    return kp[np.lexsort(kp.T)]


@pytest.mark.parametrize("h,w,k", [(64, 80, 256), (64, 80, 100),
                                   (24, 32, 64)])
def test_select_xla_route_vs_jax(h, w, k):
    """(24, 32, 64) has fewer cells than keypoints: the flat top-K and
    ``refine_subpixel``."""
    heat = _heatmaps(h + k, 2, h, w)
    vec = np.random.default_rng(1).normal(size=2).astype(np.float32)
    th = torch.tensor(heat, requires_grad=True)
    kp, sc, valid = tnms.select_keypoints(th, k, 0.05, prefer_kernel=False)
    (valid[..., None] * torch.sin(kp @ torch.tensor(vec))[..., None]
     ).sum().backward()

    def jscalar(hm):
        kp, sc, va = jax.vmap(lambda x: jnms.select_keypoints(
            x, k, 0.05, prefer_pallas=False))(hm)
        return jnp.sum(jnp.where(va, jnp.sin(kp @ vec), 0.0)), (kp, va)

    (_, (jkp, jva)), jg = jax.value_and_grad(jscalar, has_aux=True)(
        jnp.asarray(heat))
    for i in range(2):
        np.testing.assert_allclose(_set(kp[i].detach(), valid[i]),
                                   _set(jkp[i], jva[i]), atol=1e-5)
    jg = np.asarray(jg)
    assert np.abs(jg).max() > 0
    assert np.abs(th.grad.numpy() - jg).max() <= 1e-4 * np.abs(jg).max()


def test_select_tiled_batch_vs_jax():
    heat = _heatmaps(3, 2, 96, 128)
    kp, sc, valid = tnms.select_keypoints_tiled(torch.tensor(heat), 64,
                                                (2, 2), 0.05)
    for i in range(2):
        jkp, jsc, jva = jnms.select_keypoints_tiled(jnp.asarray(heat[i]), 64,
                                                    (2, 2), 0.05)
        np.testing.assert_allclose(_set(kp[i], valid[i]), _set(jkp, jva),
                                   atol=1e-5)


def test_superpoint_batched_vs_jax():
    sp_params = load_bundled("learned_lg9")[0]["superpoint"]
    pairs = make_homography_batch(np.random.default_rng(1), 1, (64, 80))
    imgs = np.concatenate([pairs.image0, pairs.image1])
    rng = np.random.default_rng(2)
    vd = rng.normal(size=256).astype(np.float32)
    wl = rng.normal(size=(2, 8, 10, 65)).astype(np.float32)
    model = JSP(max_keypoints=256, detector_mode="learned",
                conv_backend="xla_batched")

    def scalars(f, logits, xp):
        v = f.mask[..., None]
        t = (lambda a: a) if xp is jnp else torch.as_tensor
        return ((v * (f.descriptors @ t(vd))[..., None] ** 2).sum(),
                (v * xp.sin(f.keypoints)).sum(), (logits * t(wl)).sum())

    tp = master_params({"superpoint": sp_params}, "cpu")["superpoint"]
    for which in range(3):
        def jfn(p):
            f, lg = model.apply(p, jnp.asarray(imgs), return_logits=True)
            return scalars(f, lg, jnp)[which], (f, lg)

        (jv, (jf, jlg)), jg = jax.value_and_grad(jfn, has_aux=True)(
            sp_params)
        for node in tp.values():
            for t in node.values():
                t.grad = None
        f, lg = superpoint_batched(tp, torch.as_tensor(imgs),
                                   max_keypoints=256, return_logits=True)
        scalars(f, lg, torch)[which].backward()
        if which == 0:
            np.testing.assert_allclose(lg.detach().numpy(), np.asarray(jlg),
                                       atol=2e-2, rtol=1e-2)
            for i in range(2):
                np.testing.assert_allclose(
                    _set(f.keypoints[i].detach(), f.mask[i]),
                    _set(jf.keypoints[i], jf.mask[i]), atol=1e-2)
        got = params_to_jax({"superpoint": _map_tree(
            lambda t: torch.zeros_like(t) if t.grad is None else t.grad,
            tp)})["superpoint"]
        _assert_grads(got, jax.tree.map(np.asarray, jg))


def test_lightglue_train_vs_jax():
    rng = np.random.default_rng(0)
    b, k = 2, 256
    tree = {"lightglue": {"params": _flax_init(
        lightglue_param_shapes(1), torch.Generator().manual_seed(0))}}
    kp0, kp1 = (rng.uniform(0, 80, (b, k, 2)).astype(np.float32)
                for _ in range(2))
    d0, d1 = (rng.normal(size=(b, k, 256)).astype(np.float32)
              for _ in range(2))
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    m0, m1 = rng.random((b, k)) > 0.2, rng.random((b, k)) > 0.2
    wts = rng.normal(size=(b, k, k)).astype(np.float32)
    model = JLG(depth=1, filter_threshold=0.0)

    def jfn(p, a0, e0):
        s = jax.vmap(lambda *x: model.apply(p, x[0], x[1], x[2], (64, 80),
                                            x[3], x[4], x[5],
                                            (64, 80)).scores)(
            a0, e0, m0, kp1, d1, m1)
        return jnp.sum(s * wts), s

    (_, js), (jg, jgk, jgd) = jax.value_and_grad(
        jfn, argnums=(0, 1, 2), has_aux=True)(tree["lightglue"], kp0, d0)
    tp = master_params(tree, "cpu")["lightglue"]
    tk0 = torch.tensor(kp0, requires_grad=True)
    td0 = torch.tensor(d0, requires_grad=True)
    res = lightglue_forward(tp, tk0, td0, torch.tensor(m0), (64, 80),
                            torch.tensor(kp1), torch.tensor(d1),
                            torch.tensor(m1), (64, 80), depth=1)
    (res.scores * torch.tensor(wts)).sum().backward()
    np.testing.assert_allclose(res.scores.detach().numpy(), np.asarray(js),
                               atol=1e-3)
    for got, want in ((tk0.grad, jgk), (td0.grad, jgd)):
        want = np.asarray(want)
        assert np.linalg.norm(got.numpy() - want) <= 0.05 * \
            np.linalg.norm(want)
    got = params_to_jax({"lightglue": _map_tree(lambda t: t.grad, tp)})
    _assert_grads(got["lightglue"], jax.tree.map(np.asarray, jg))


@pytest.mark.parametrize("n,din,dout", [(256, 256, 768), (300, 512, 256)])
def test_dense_and_layer_norm_round_as_flax(n, din, dout):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, din)).astype(np.float32)
    kernel = rng.normal(0, din ** -0.5, (din, dout)).astype(np.float32)
    bias = rng.normal(0, 0.1, dout).astype(np.float32)
    want = np.asarray(fnn.Dense(dout, dtype=jnp.bfloat16).apply(
        {"params": {"kernel": kernel, "bias": bias}}, x), np.float32)
    node = {"weight": torch.tensor(kernel.T), "bias": torch.tensor(bias)}
    got = _dense_bf16(torch.tensor(x), node)
    rounded = _dense_bf16(torch.tensor(x), {k: v.to(torch.bfloat16)
                                            for k, v in node.items()})
    assert got.dtype == torch.bfloat16 and torch.equal(got, rounded)
    got = got.float().numpy()
    bf = torch.bfloat16
    other = (torch.tensor(x).to(bf) @ node["weight"].to(bf).T
             + node["bias"].to(bf)).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp)
    assert np.mean(got != want) <= 1e-3
    assert np.sum(got != want) <= np.sum(other != want)

    y = (rng.normal(size=(n, dout)) * 3 + 1).astype(np.float32)
    scale = (1 + rng.normal(0, 0.3, dout)).astype(np.float32)
    shift = rng.normal(0, 0.3, dout).astype(np.float32)
    want = np.asarray(fnn.LayerNorm(epsilon=1e-6, dtype=jnp.float32).apply(
        {"params": {"scale": scale, "bias": shift}}, y))
    got = _layer_norm(torch.tensor(y), {"weight": torch.tensor(scale),
                                        "bias": torch.tensor(shift)})
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
