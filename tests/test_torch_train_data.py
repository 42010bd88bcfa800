"""The port's training data against the JAX package's.

- ``make_homography_batch`` from the same numpy seed against the JAX
  module (OpenCV's bicubic resize and ``warpPerspective``): the homographies
  exactly, the textures to 1e-5, the warped views to 1e-4 (OpenCV 5 samples
  at float positions; its coordinate arithmetic rounds apart from the
  port's float64 map by up to ~3e-5).
- ``jax_cubic_weights`` against ``jax.image.resize(..., "cubic")`` of the
  identity (the weight matrix itself) to 5e-6 (XLA fuses the f32 kernel
  arithmetic), up- and downsampling.
- Every ``device_data`` function fed the JAX module's own draws (the unit
  uniforms and normals from its ``jax.random`` keys, in its order): the
  textures, the affine, the blur, the shadows, ``device_batch`` and
  ``device_batch_asymmetric``, to 1e-4 (f32 sums in another order; a blob
  pixel within rounding of its threshold may flip, so at most 1e-3 of the
  pixels may differ by more).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gisnav_tpu.train import data as jdata
from gisnav_tpu.train import device_data as jdd
from gisnav_tpu_torch.train import data as tdata
from gisnav_tpu_torch.train import device_data as tdd

torch.set_num_threads(2)


@pytest.mark.parametrize("shape", [(128, 160), (64, 80)])
def test_make_homography_batch_vs_opencv(shape):
    want = jdata.make_homography_batch(np.random.default_rng(3), 3, shape)
    got = tdata.make_homography_batch(np.random.default_rng(3), 3, shape)
    np.testing.assert_array_equal(got.homography, want.homography)
    np.testing.assert_allclose(got.image0, want.image0, atol=1e-5)
    np.testing.assert_allclose(got.image1, want.image1, atol=1e-4)


@pytest.mark.parametrize("n_in,n_out", [(6, 128), (48, 160), (128, 128),
                                        (128, 160), (24, 576), (200, 64)])
def test_jax_cubic_weights(n_in, n_out):
    want = jax.image.resize(jnp.eye(n_in, dtype=jnp.float32), (n_out, n_in),
                            method="cubic")
    np.testing.assert_allclose(tdd.jax_cubic_weights(n_in, n_out).numpy(),
                               np.asarray(want), atol=5e-6)


def _unit(k, shape=()):
    return jax.random.uniform(k, shape, jnp.float32)


def _jax_draws(key, batch, tex_shape, noise_shape, n=6):
    """The JAX module's draws of ``device_batch`` / ``_asymmetric`` as the
    port's ``draw_pairs`` lays them out."""
    rows = []
    for k in jax.random.split(key, batch):
        k_tex, k_aff, k_pho, k_blur, k_sh = jax.random.split(k, 5)
        kt = jax.random.split(k_tex, 6)
        kg, kb, kn = jax.random.split(k_pho, 3)
        rows.append({
            "octaves": [_unit(kk, (o, o)) for kk, o in
                        zip(kt[:4], (6, 16, 48, 128))],
            "blob": _unit(kt[4], (24, 24)), "level": _unit(kt[5]),
            "affine": jnp.stack([_unit(kk) for kk in
                                 jax.random.split(k_aff, 4)]),
            "blur": jnp.stack([_unit(kk) for kk in
                               jax.random.split(k_blur)]),
            "photo": jnp.stack([_unit(kg), _unit(kb)]),
            "noise": jax.random.normal(kn, noise_shape),
            "shadows": jnp.stack([jnp.stack([
                _unit(kk) for kk in jax.random.split(kq, 5)])
                for kq in jax.random.split(k_sh, n)]).reshape(n, 5)})

    def t(xs):
        return torch.tensor(np.asarray(jnp.stack(xs)))

    return {"octaves": [t([r["octaves"][i] for r in rows])
                        for i in range(4)],
            **{key: t([r[key] for r in rows]) for key in rows[0]
               if key != "octaves"}}


def _close(got, want, atol=1e-4):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    diff = np.abs(got - np.asarray(want))
    assert (diff > atol).mean() <= 1e-3, (diff.max(), (diff > atol).sum())


def test_texture_affine_blur_shadows_vs_jax():
    key = jax.random.PRNGKey(5)
    shape = (64, 80)
    d = _jax_draws(key, 1, shape, shape)
    k_tex, k_aff, _, _, k_sh = jax.random.split(
        jax.random.split(key, 1)[0], 5)
    _close(tdd._texture(d["octaves"], d["blob"], d["level"], shape)[0],
           jdd._texture(k_tex, shape))
    _close(tdd._random_affine(d["affine"], shape, 60.0, 0.8, 0.1)[0],
           jdd._random_affine(k_aff, shape, 60.0, 0.8, 0.1), 1e-5)
    img = np.random.default_rng(0).random((2, *shape)).astype(np.float32)
    sig = np.array([0.7, 1.6], np.float32)
    _close(tdd._gaussian_blur(torch.tensor(img), torch.tensor(sig)),
           jnp.stack([jdd._gaussian_blur(jnp.asarray(i), s)
                      for i, s in zip(img, sig)]), 1e-5)
    _close(tdd._cast_shadows(d["shadows"], torch.tensor(img[:1]), 0.3)[0],
           jdd._cast_shadows(k_sh, jnp.asarray(img[0]), 6, 0.3), 1e-5)


def test_device_batch_vs_jax():
    key = jax.random.PRNGKey(3)
    shape = (64, 80)
    kw = dict(max_angle_deg=60.0, max_scale=0.8, max_shift=0.1,
              max_blur_sigma=1.2, shadow_strength=0.3)
    want = jdd.device_batch(key, 3, shape, **kw)
    got = tdd.compose_pairs(_jax_draws(key, 3, shape, shape), shape, **kw)
    for g, w in zip(got, want):
        _close(g, w)


def test_device_batch_asymmetric_vs_jax():
    key = jax.random.PRNGKey(4)
    q, r = (64, 80), (144, 160)
    kw = dict(max_angle_deg=90.0, max_blur_sigma=1.0, shadow_strength=0.3)
    want = jdd.device_batch_asymmetric(key, 2, q, r, **kw)
    got = tdd.compose_asymmetric(_jax_draws(key, 2, r, q), q, r, **kw)
    for g, w in zip(got, want):
        _close(g, w)


def test_device_batch_draws_on_generator():
    """The draw-and-compose entry runs from a torch.Generator: shapes,
    ranges and the transform's last row."""
    gen = torch.Generator().manual_seed(0)
    img0, img1, a = tdd.device_batch(gen, 2, (64, 80), max_angle_deg=30.0)
    assert img0.shape == img1.shape == (2, 64, 80)
    assert float(img1.min()) >= 0.0 and float(img1.max()) <= 1.0
    np.testing.assert_array_equal(a[:, 2].numpy(), [[0, 0, 1]] * 2)
    q, r, a = tdd.device_batch_asymmetric(gen, 2, (64, 80), (144, 160))
    assert q.shape == (2, 64, 80) and r.shape == (2, 144, 160)
