"""Shear resample (K6), 3-shear rotation and warp routing of the port
against the JAX package.

- ``shear_last_axis_plain`` (what a CPU tensor runs) against the TPU kernel
  ``shear_last_axis_pallas`` in Pallas interpret mode on a (2, 256, 384)
  stack and against the jnp branch of ``_shear_x``: atol 1e-5 on values in
  [0, 1] (the same f32 expression; a fused multiply-add on one side moves an
  interpolation weight by an ulp).
- ``shear_first_axis_plain`` (the y-shear) against the transpose route it
  replaces, bit for bit, and against the JAX package's ``_shear_y`` on both
  its branches (jnp, and the TPU kernel in interpret mode): atol 1e-5 on
  values in [0, 1], as above.
- ``rotate_and_crop_center_shear`` against the JAX one (jnp shears) at the
  angles of the JAX package's shear tests, right angles and one beyond 45
  degrees included: crop to 1e-4, matrix to 1e-5 relative to its
  raster-scale entries; and against its own former route (the y-shear as
  an x-shear between two transposes), bit for bit.
- zoom-less ``rotate_and_crop_center`` and ``compose_crs_after_warp``
  against ``raster/warp.py``; ``rotate_and_crop_auto`` takes the gather for
  a CPU stack, as the JAX function does on the CPU backend.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gisnav_tpu import raster as jraster
from gisnav_tpu.raster import shear as jshear
from gisnav_tpu.raster.pallas_shear import shear_last_axis_pallas
from gisnav_tpu_torch import raster as traster
from gisnav_tpu_torch.raster import shear as tshear
from gisnav_tpu_torch.raster.shear import rotate_and_crop_center_shear
from gisnav_tpu_torch.raster.shear_kernel import (
    shear_first_axis,
    shear_first_axis_plain,
    shear_last_axis,
    shear_last_axis_plain,
)

torch.set_num_threads(2)


def _stack(seed, shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("shift", [0.41, -0.41, 0.70, -0.70, 0.0])
def test_plain_vs_pallas_interpret(shift):
    img = _stack(0, (2, 256, 384))
    got = shear_last_axis(torch.as_tensor(img), shift, 128.0).numpy()
    with pltpu.force_tpu_interpret_mode():
        ref = shear_last_axis_pallas(jnp.asarray(img), jnp.float32(shift),
                                     128.0)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=0)
    xla = jshear._shear_x(jnp.asarray(img), jnp.float32(shift), 192, 128,
                          use_pallas=False)
    np.testing.assert_allclose(got, np.asarray(xla), atol=1e-5, rtol=0)


def _transpose_route(img, shift, center):
    return shear_last_axis_plain(img.transpose(-1, -2).contiguous(), shift,
                                 center).transpose(-1, -2).contiguous()


@pytest.mark.parametrize("shape", [(2, 256, 384), (1, 384, 384)])
@pytest.mark.parametrize("shift", [0.41, -0.41, 0.999, -0.999])
def test_first_axis_plain_vs_transpose_route(shape, shift):
    img = torch.as_tensor(_stack(6, shape))
    cx = shape[2] // 2
    got = shear_first_axis_plain(img, shift, float(cx))
    assert torch.equal(got, _transpose_route(img, shift, float(cx)))
    if shape[1] >= 384:  # in the wrapper's supported set: the same values
        assert torch.equal(shear_first_axis(img, shift, float(cx)), got)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("shape,shift", [((2, 384, 256), 0.41),
                                         ((1, 384, 384), -0.70)])
def test_first_axis_vs_jax_shear_y(use_pallas, shape, shift):
    img = _stack(7, shape)
    cx, cy = shape[2] // 2, shape[1] // 2
    got = shear_first_axis(torch.as_tensor(img), shift, float(cx)).numpy()
    with pltpu.force_tpu_interpret_mode():
        ref = jshear._shear_y(jnp.asarray(img), jnp.float32(shift), cx, cy,
                              use_pallas=use_pallas)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("angle", [20.0, -33.0, 61.5, 117.0])
def test_shear_rotation_equals_transpose_route(angle, monkeypatch):
    """The rotation's y-shear through ``shear_first_axis`` gives the bits
    of the route it replaced (an x-shear between two transposes)."""
    stack = torch.as_tensor(_stack(8, (384, 384, 2)))
    got = rotate_and_crop_center_shear(stack, angle, (128, 192))
    monkeypatch.setattr(tshear, "shear_first_axis_plain", _transpose_route)
    ref = rotate_and_crop_center_shear(stack, angle, (128, 192))
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_unsupported_shapes_raise():
    with pytest.raises(ValueError, match="128"):
        shear_last_axis(torch.zeros(1, 100, 384), 0.1, 50.0)
    with pytest.raises(ValueError, match="128"):
        shear_last_axis(torch.zeros(1, 128, 256), 0.1, 64.0)
    with pytest.raises(ValueError, match="shift"):
        shear_last_axis(torch.zeros(1, 128, 384), 1.0, 64.0)
    # the first axis is the sheared one: (C, 256, 384) is too short there
    with pytest.raises(ValueError, match="shear_first_axis"):
        shear_first_axis(torch.zeros(1, 256, 384), 0.1, 192.0)
    with pytest.raises(ValueError, match="shift"):
        shear_first_axis(torch.zeros(1, 384, 128), -1.0, 64.0)
    assert shear_first_axis_plain(torch.zeros(1, 10, 12), 0.3,
                                  5.0).shape == (1, 10, 12)
    # the plain version serves any shape
    assert shear_last_axis_plain(torch.zeros(1, 10, 12), 0.3,
                                 5.0).shape == (1, 10, 12)


@pytest.mark.parametrize("angle", [0.0, 30.0, -30.0, 45.0, 117.0, -135.0,
                                   90.0, 180.0, 270.0, -90.0, 61.5])
def test_shear_rotation_vs_jax(angle):
    stack = _stack(1, (384, 384, 2))
    got, gm = rotate_and_crop_center_shear(torch.as_tensor(stack), angle,
                                           (128, 192))
    ref, rm = jshear.rotate_and_crop_center_shear(
        jnp.asarray(stack), angle, (128, 192), use_pallas=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(gm.numpy(), np.asarray(rm), rtol=1e-5,
                               atol=1e-5)


def test_shear_rotation_plain_shear_for_any_side():
    stack = _stack(2, (100, 100, 1))
    got, gm = rotate_and_crop_center_shear(torch.as_tensor(stack), 20.0,
                                           (40, 60))
    ref, rm = jshear.rotate_and_crop_center_shear(
        jnp.asarray(stack), 20.0, (40, 60), use_pallas=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)
    with pytest.raises(ValueError, match="square"):
        rotate_and_crop_center_shear(torch.zeros(64, 96, 1), 5.0, (8, 8))


@pytest.mark.parametrize("angle,zoom", [(25.0, None), (-140.0, None),
                                        (12.0, 0.6)])
def test_rotate_and_crop_center_and_auto_vs_jax(angle, zoom):
    stack = _stack(3, (160, 224, 2))
    ref, rm = jraster.rotate_and_crop_center(jnp.asarray(stack), angle,
                                             (64, 96), zoom)
    for fn in (traster.rotate_and_crop_center, traster.rotate_and_crop_auto):
        got, gm = fn(torch.as_tensor(stack), angle, (64, 96), zoom)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                                   rtol=0)
        np.testing.assert_allclose(gm.numpy(), np.asarray(rm), rtol=1e-5,
                                   atol=1e-5)


def test_auto_takes_gather_for_cpu_square_stack():
    """On the CPU the JAX function takes the gather even for a square stack
    the shear would serve; so does the port for a CPU tensor."""
    stack = _stack(4, (384, 384, 1))
    got, _ = traster.rotate_and_crop_auto(torch.as_tensor(stack), 33.0,
                                          (64, 64))
    ref, _ = jraster.rotate_and_crop_auto(jnp.asarray(stack), 33.0, (64, 64))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)


def test_compose_crs_after_warp_vs_jax():
    rng = np.random.default_rng(5)
    crs = rng.normal(size=(4, 4))
    _, m = traster.rotate_and_crop_center(torch.zeros(64, 64, 1), 17.0,
                                          (16, 16))
    np.testing.assert_allclose(
        traster.compose_crs_after_warp(crs, m),
        jraster.compose_crs_after_warp(crs, m.numpy()), rtol=1e-12)
