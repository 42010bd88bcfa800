"""Keypoint NMS-select of the port against the JAX package.

``nms_select_plain`` (what a CPU tensor runs) against the TPU kernel
``nms_select_pallas`` in Pallas interpret mode (cell max exact, positions to
1e-5 px, tied survivors included) and against the XLA path that JAX runs on
the CPU: its cell max exactly, its positions on cells with a single NMS
survivor (the XLA path takes the argmax of the NMS'd map where the kernel
averages tied survivors). ``select_keypoints`` is compared as sets (top-k tie
order differs between ``torch.topk`` and ``approx_max_k``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gisnav_tpu.features import nms as jnms
from gisnav_tpu.features.pallas_nms import nms_select_pallas
from gisnav_tpu_torch.features.nms import select_keypoints
from gisnav_tpu_torch.features.nms_kernel import nms_select, nms_select_plain

torch.set_num_threads(2)


def _heat(seed, h, w):
    rng = np.random.default_rng(seed)
    return (rng.random((h, w)) ** 8).astype(np.float32)


def _xla_cells(heat, border=4):
    h, w = heat.shape
    nms = np.asarray(jnms.simple_nms(jnp.asarray(heat), 4))
    ys, xs = np.mgrid[0:h, 0:w]
    inb = (xs >= border) & (xs < w - border) & (ys >= border) & \
        (ys < h - border)
    nms = np.where(inb, nms, 0.0)
    cells = nms.reshape(h // 4, 4, w // 4, 4)
    table = np.asarray(jnms._cell_keypoint_table(
        jnp.asarray(nms), jnp.asarray(heat), 4))
    count = (cells > 0).sum(axis=(1, 3))
    return cells.max(axis=(1, 3)), table, count


def test_plain_vs_pallas_kernel_interpret():
    heat = _heat(0, 64, 256)
    heat[20, 40] = heat[20, 41] = 0.999  # tied survivors in one cell
    cm, cx, cy = (t.numpy() for t in nms_select_plain(torch.as_tensor(heat),
                                                      4))
    with pltpu.force_tpu_interpret_mode():
        ref = [np.asarray(o) for o in nms_select_pallas(jnp.asarray(heat), 4)]
    np.testing.assert_array_equal(cm, ref[0])
    np.testing.assert_allclose(cx, ref[1], atol=1e-5)
    np.testing.assert_allclose(cy, ref[2], atol=1e-5)
    assert cx[5, 10] == pytest.approx(40.5, abs=0.01)  # tie averaged


def test_plain_vs_xla_path():
    heat = _heat(1, 64, 128)
    cm, cx, cy = (t.numpy() for t in nms_select(torch.as_tensor(heat), 4))
    ref_max, table, count = _xla_cells(heat)
    np.testing.assert_array_equal(cm, ref_max)
    single = (count == 1).reshape(-1)
    assert single.sum() > 50
    got = np.stack([cx.reshape(-1), cy.reshape(-1)], 1)
    np.testing.assert_allclose(got[single], table[single], atol=1e-5)


def _as_set(kp, sc, valid):
    kp, sc, valid = (np.asarray(a) for a in (kp, sc, valid))
    order = np.lexsort((kp[valid][:, 1], kp[valid][:, 0]))
    return kp[valid][order], np.sort(sc[valid])


@pytest.mark.parametrize("h", [96, 100])
def test_select_keypoints_sets(h):
    """h=96: the kernel's native case. h=100 (not a multiple of 32): the
    port zeroes rows at or below h - border as the JAX package does before
    its padded kernel call, so the reference is the XLA path on that input."""
    heat = _heat(2, h, 128)
    k = 512
    kp, sc, valid = select_keypoints(torch.as_tensor(heat), k)
    src = heat.copy()
    if h % 32:
        src[h - 4:] = 0.0
        assert kp[valid][:, 1].max() < h - 4
    ref = jnms.select_keypoints(jnp.asarray(src), k, prefer_pallas=False)
    got_kp, got_sc = _as_set(kp.numpy(), sc.numpy(), valid.numpy())
    ref_kp, ref_sc = _as_set(*ref)
    np.testing.assert_array_equal(got_sc, ref_sc)
    np.testing.assert_allclose(got_kp, ref_kp, atol=1e-5)
