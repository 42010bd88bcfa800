"""The Harris detector of the port against the JAX package's.

- ``harris_response`` on seeded images (64x80 and 480x640), a constant image
  and a (B, H, W) batch: within 1e-6 absolute of the JAX response on the
  normalised scale (the port keeps the JAX order of operations; measured
  bit-equal on the CPU);
- SuperPoint in the ``harris`` detector mode with the bundled ``harris_lg5``
  weights at 120x160 and 128 keypoints, against the JAX ``SuperPoint`` on
  the CPU: every JAX keypoint reproduced to 1e-3 px; a port keypoint the
  JAX module does not give lies in the rows of the bottom border band
  (``h - border - nms_radius <= y < h - border``), where the port's select
  takes the TPU kernel's route for a height that is no multiple of 32
  (rows at or below ``h - border`` zeroed before the NMS, so they do not
  suppress) and the JAX CPU route does not (measured: 87 JAX keypoints, all
  reproduced, and 2 more at y = 114.9 and 115.0); descriptors at shared
  keypoints within the conv tests' bf16 tolerance (1 ulp relative + 1e-2,
  ``tests/test_torch_conv.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gisnav_tpu.features.harris import harris_response as j_harris
from gisnav_tpu.features.superpoint import SuperPoint as JSuperPoint
from gisnav_tpu.pipeline.runners import load_bundled as j_load_bundled
from gisnav_tpu_torch.features.harris import harris_response
from gisnav_tpu_torch.features.superpoint import SuperPoint
from gisnav_tpu_torch.utils.world import render_scene
from gisnav_tpu_torch.weights import load_bundled, params_from_jax

torch.set_num_threads(2)

TOL = 1e-6


def _images(shape, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((n, *shape)).astype(np.float32)


@pytest.mark.parametrize("shape", [(64, 80), (480, 640)])
def test_harris_response_vs_jax(shape):
    img = _images(shape, 1)[0]
    got = harris_response(torch.as_tensor(img)).numpy()
    want = np.asarray(j_harris(jnp.asarray(img)))
    assert got.shape == shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert got.max() == pytest.approx(1.0)


def test_harris_response_constant_image():
    img = np.full((48, 64), 0.37, np.float32)
    got = harris_response(torch.as_tensor(img)).numpy()
    assert np.isfinite(got).all() and (got == 0).all()
    np.testing.assert_array_equal(got, np.asarray(j_harris(jnp.asarray(img))))


def test_harris_response_batch_vs_jax():
    """Each image of a batch is normalised by its own maximum."""
    imgs = _images((40, 56), 3, seed=1)
    imgs[1] *= 0.1  # another scale, same normalised response
    got = harris_response(torch.as_tensor(imgs)).numpy()
    for i, img in enumerate(imgs):
        np.testing.assert_allclose(got[i], np.asarray(j_harris(
            jnp.asarray(img))), rtol=0, atol=TOL)
        np.testing.assert_allclose(got[i], harris_response(
            torch.as_tensor(img)).numpy(), rtol=0, atol=0)


def test_superpoint_harris_mode_vs_jax():
    h, w, k, border, radius = 120, 160, 128, 4, 4
    params, cfg = load_bundled("harris_lg5")
    assert cfg.detector_mode == "harris"
    j_params, _ = j_load_bundled("harris_lg5")
    img = render_scene(seed=4, h=h, w=w, yaws=[30.0]).frames[0].astype(
        np.float32) / 255.0
    sp = SuperPoint(params_from_jax(params)["superpoint"], k,
                    detector_mode="harris")
    assert not hasattr(sp, "convPa_w") and not hasattr(sp, "convPb_w")
    got = sp(torch.as_tensor(img))
    want = JSuperPoint(max_keypoints=k, detector_mode="harris").apply(
        j_params["superpoint"], jnp.asarray(img))
    a = got.keypoints[got.mask].numpy()
    b = np.asarray(want.keypoints)[np.asarray(want.mask)]
    d = np.linalg.norm(b[:, None] - a[None], axis=-1)
    print(f"harris keypoints: port {len(a)}, JAX {len(b)}")
    assert len(b) > 40
    assert (d.min(axis=1) < 1e-3).all()
    extra = a[d.min(axis=0) >= 1e-3]
    assert ((extra[:, 1] >= h - border - radius - 0.5)
            & (extra[:, 1] < h - border)).all(), extra
    assert len(extra) <= 0.05 * len(b)
    nearest = d.argmin(axis=1)
    da = got.descriptors[got.mask].numpy()[nearest]
    db = np.asarray(want.descriptors)[np.asarray(want.mask)]
    tol = 1e-2 + 2.0 ** -7 * np.abs(db)
    assert not (np.abs(da - db) > tol).any(), np.abs(da - db).max()


def test_superpoint_harris_mode_batch_and_unknown_mode():
    params = params_from_jax(load_bundled("harris_lg5")[0])["superpoint"]
    sp = SuperPoint(params, 64, detector_mode="harris")
    imgs = torch.as_tensor(_images((64, 96), 2, seed=2))
    batch = sp(imgs)
    for i in range(2):
        one = sp(imgs[i])
        assert torch.equal(batch.keypoints[i], one.keypoints)
        assert torch.equal(batch.descriptors[i], one.descriptors)
    with pytest.raises(ValueError, match="detector_mode"):
        SuperPoint(params, 64, detector_mode="sift")
    # the learned mode needs the detector head this tree does not have
    with pytest.raises(KeyError):
        SuperPoint(params, 64)
