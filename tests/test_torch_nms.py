"""Keypoint NMS-select of the port against the JAX package.

``nms_select_plain`` (what a CPU tensor runs) against the TPU kernel
``nms_select_pallas`` in Pallas interpret mode (cell max exact, positions to
4 f32 ulps of the image's largest coordinate, tied survivors included) and
against the XLA path that JAX runs on the CPU: its cell max exactly, its
positions on cells with a single NMS survivor (the XLA path takes the argmax
of the NMS'd map where the kernel averages tied survivors).
``select_keypoints`` is compared as sets (top-k tie order differs between
``torch.topk`` and ``approx_max_k``). The position tolerance: ATen's and
XLA's ``exp`` differ by an ulp on some inputs, and one ulp of a soft-argmax
weight can move the rounded position ``x + dx`` by an ulp of x (1.5e-5 px
at 128-255 px).

``nms_cellmax_plain`` (K7) is exact against the TPU kernel
``nms_cellmax_pallas`` in interpret mode and against ``nms_select_plain``'s
cell max. ``select_keypoints_tiled``, the kernel-less route (one tile:
``select_keypoints(prefer_pallas=False)`` of the JAX package), is held
against the JAX functions: scores exactly, positions to 1e-5 px, compared
as sets, tile by tile.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gisnav_tpu.features import nms as jnms
from gisnav_tpu.features.pallas_nms import (
    nms_cellmax_pallas,
    nms_cellmax_supported,
    nms_select_pallas,
)
from gisnav_tpu_torch.features import nms_kernel as tk
from gisnav_tpu_torch.features.nms import (
    refine_subpixel,
    select_keypoints,
    select_keypoints_tiled,
    simple_nms,
)
from gisnav_tpu_torch.features.nms_kernel import (
    nms_cellmax,
    nms_cellmax_plain,
    nms_select,
    nms_select_plain,
)

torch.set_num_threads(2)


def _pos_tol(h, w):
    """4 f32 ulps of the largest pixel coordinate of an (h, w) image."""
    return 4 * float(np.spacing(np.float32(max(h, w))))


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
    np.testing.assert_allclose(cx, ref[1], rtol=0, atol=_pos_tol(64, 256))
    np.testing.assert_allclose(cy, ref[2], rtol=0, atol=_pos_tol(64, 256))
    assert cx[5, 10] == pytest.approx(40.5, abs=0.01)  # tie averaged


@pytest.mark.parametrize("h,w", [(64, 256), (36, 52)])
def test_nms_select_outputs_share_one_allocation(h, w):
    heat = torch.as_tensor(_heat(7, h, w))
    got = nms_select(heat, 4)
    base = got[0].untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == base for t in got)
    assert [t.data_ptr() - base for t in got] == [
        i * (h // 4) * (w // 4) * 4 for i in range(3)]
    for g, want in zip(got, nms_select_plain(heat, 4)):
        assert g.shape == (h // 4, w // 4) and g.is_contiguous()
        assert torch.equal(g, want)


def test_plain_vs_xla_path():
    heat = _heat(1, 64, 128)
    cm, cx, cy = (t.numpy() for t in nms_select(torch.as_tensor(heat), 4))
    ref_max, table, count = _xla_cells(heat)
    np.testing.assert_array_equal(cm, ref_max)
    single = (count == 1).reshape(-1)
    assert single.sum() > 50
    got = np.stack([cx.reshape(-1), cy.reshape(-1)], 1)
    np.testing.assert_allclose(got[single], table[single], rtol=0,
                               atol=_pos_tol(64, 128))


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
    np.testing.assert_allclose(got_kp, ref_kp, rtol=0, atol=_pos_tol(h, 128))


@pytest.mark.parametrize("h,w", [(64, 256), (96, 384)])
def test_cellmax_plain_vs_pallas_interpret(h, w):
    heat = _heat(3, h, w)
    heat[20, 40] = heat[20, 41] = 0.999
    got = nms_cellmax(torch.as_tensor(heat), 4)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(nms_cellmax_pallas(jnp.asarray(heat), 4))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert torch.equal(got, nms_select_plain(torch.as_tensor(heat), 4)[0])
    assert torch.equal(got, nms_cellmax_plain(torch.as_tensor(heat), 4))


def test_cellmax_predicate_and_refusal():
    for h, w, border in [(64, 256, 4), (64, 128, 4), (48, 256, 4),
                         (64, 320, 4), (64, 256, 0), (1088, 1920, 4),
                         (2048, 2048, 4)]:
        assert tk.nms_cellmax_supported(h, w, border) == \
            nms_cellmax_supported(h, w, 4, 4, border), (h, w, border)
    with pytest.raises(ValueError, match="nms_cellmax"):
        nms_cellmax(torch.zeros(64, 128), 4)


def test_simple_nms_and_refine_vs_jax():
    heat = _heat(4, 40, 56)
    np.testing.assert_array_equal(
        simple_nms(torch.as_tensor(heat)).numpy(),
        np.asarray(jnms.simple_nms(jnp.asarray(heat))))
    kp = np.array([[0, 0], [5, 7], [55, 39], [20, 1]], np.float32)
    np.testing.assert_allclose(
        refine_subpixel(torch.as_tensor(heat), torch.as_tensor(kp)).numpy(),
        np.asarray(jnms.refine_subpixel(jnp.asarray(heat), jnp.asarray(kp))),
        atol=1e-5)


@pytest.mark.parametrize("h,w,k", [(64, 128, 256), (30, 50, 128)])
def test_select_keypoints_plain_route_sets(h, w, k):
    """(64, 128): the cell route; (30, 50): too few cells of 4x4, so the
    top-K runs over all pixels with ``refine_subpixel``."""
    heat = _heat(5, h, w)
    kp, sc, valid = select_keypoints_tiled(torch.as_tensor(heat), k, (1, 1))
    ref = jnms.select_keypoints(jnp.asarray(heat), k, prefer_pallas=False)
    got_kp, got_sc = _as_set(kp.numpy(), sc.numpy(), valid.numpy())
    ref_kp, ref_sc = _as_set(*ref)
    assert len(ref_sc) > 10
    np.testing.assert_array_equal(got_sc, ref_sc)
    np.testing.assert_allclose(got_kp, ref_kp, atol=1e-5)


@pytest.mark.parametrize("k,tiles", [(256, (2, 2)), (100, (2, 4)),
                                     (64, (1, 1))])
def test_select_keypoints_tiled_sets_per_tile(k, tiles):
    """k=100 over 8 tiles: 12 a tile, 96 slots, 4 padded invalid."""
    heat = _heat(6, 128, 256)
    kp, sc, valid = (t.numpy() for t in select_keypoints_tiled(
        torch.as_tensor(heat), k, tiles))
    ref = [np.asarray(a) for a in jnms.select_keypoints_tiled(
        jnp.asarray(heat), k, tiles)]
    assert kp.shape == ref[0].shape == (k, 2)
    k_tile = max(1, k // (tiles[0] * tiles[1]))
    n = k_tile * tiles[0] * tiles[1]
    assert not valid[n:].any() and not ref[2][n:].any()
    for t in range(tiles[0] * tiles[1]):
        sl = slice(t * k_tile, (t + 1) * k_tile)
        got_kp, got_sc = _as_set(kp[sl], sc[sl], valid[sl])
        ref_kp, ref_sc = _as_set(ref[0][sl], ref[1][sl], ref[2][sl])
        assert len(ref_sc) > 3
        np.testing.assert_array_equal(got_sc, ref_sc)
        np.testing.assert_allclose(got_kp, ref_kp, atol=1e-5)
