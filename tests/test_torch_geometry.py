"""Warp, DEM lift, RANSAC-PnP and geopose assembly of the port against the
JAX package, on the same numpy inputs.

Tolerances: the warp 1e-4 (f32 bilinear of values in [0, 1] and metres),
RANSAC r/t 1e-3 relative with equal inlier counts (same injected hypothesis
sample, f32 solves in another order), the f32 geopose at f32 rounding of
absolute coordinates, the f64 re-assembly to 1e-9.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gisnav_tpu.pipeline import geopose as jgp
from gisnav_tpu.pnp.dem import gather_elevation as j_gather
from gisnav_tpu.pnp.ransac import ransac_pnp as j_ransac
from gisnav_tpu.raster.warp import rotate_and_crop_center as j_rotate
from gisnav_tpu_torch.pipeline import geopose as tgp
from gisnav_tpu_torch.pnp.dem import gather_elevation
from gisnav_tpu_torch.pnp.ransac import ransac_pnp
from gisnav_tpu_torch.raster.warp import rotate_and_crop_center

torch.set_num_threads(2)


def jax_ransac_sample(key, mask, num_hypotheses=64):
    """The hypothesis indices ``gisnav_tpu.pnp.ransac`` draws from ``key``."""
    fmask = jnp.asarray(mask).astype(jnp.float32)
    probs = fmask / jnp.sum(fmask)
    keys = jax.random.split(key, num_hypotheses)
    n = fmask.shape[0]
    return np.asarray(jax.vmap(lambda k: jax.random.choice(
        k, n, shape=(4,), replace=False, p=probs))(keys))


@pytest.mark.parametrize("angle,zoom", [(23.0, 0.8), (-140.0, 1.3)])
def test_rotate_and_crop_center_zoom(angle, zoom):
    rng = np.random.default_rng(0)
    stack = np.stack([rng.random((96, 80)), rng.random((96, 80)) * 30],
                     -1).astype(np.float32)
    got, m = rotate_and_crop_center(torch.as_tensor(stack), angle, (48, 64),
                                    zoom)
    ref, m_ref = j_rotate(jnp.asarray(stack), jnp.float32(angle), (48, 64),
                          zoom=jnp.float32(zoom))
    np.testing.assert_allclose(m.numpy(), np.asarray(m_ref), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_gather_elevation():
    rng = np.random.default_rng(1)
    dem = rng.random((40, 50)).astype(np.float32)
    pts = rng.uniform(-5, 55, (200, 2)).astype(np.float32)
    got = gather_elevation(torch.as_tensor(dem), torch.as_tensor(pts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        j_gather(jnp.asarray(dem), jnp.asarray(pts))))


def _pnp_problem(seed, n=256, outliers=0.3):
    rng = np.random.default_rng(seed)
    pts3d = np.zeros((n, 3), np.float32)
    pts3d[:, :2] = rng.uniform(200, 1800, (n, 2))
    pts3d[:, 2] = rng.uniform(-5, 5, n)
    a = np.radians(17.0)
    r = np.array([[np.cos(a), np.sin(a), 0], [-np.sin(a), np.cos(a), 0],
                  [0, 0, 1.0]])
    cam = np.array([1000.0, 950.0, -900.0])
    t = -r @ cam
    k = np.array([[800.0, 0, 640], [0, 800.0, 480], [0, 0, 1]])
    pc = pts3d @ r.T + t
    pix = (pc @ k.T)[:, :2] / (pc @ k.T)[:, 2:3]
    pix += rng.normal(0, 0.5, pix.shape)
    bad = rng.random(n) < outliers
    pix[bad] = rng.uniform(0, 1280, (bad.sum(), 2))
    mask = rng.random(n) > 0.1
    return (pts3d, pix.astype(np.float32), k.astype(np.float32), mask)


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_pnp_with_injected_jax_sample(seed):
    pts3d, pix, k, mask = _pnp_problem(seed)
    key = jax.random.PRNGKey(seed + 3)
    ref = j_ransac(jnp.asarray(pts3d), jnp.asarray(pix), jnp.asarray(k),
                   jnp.asarray(mask), key=key)
    got = ransac_pnp(torch.as_tensor(pts3d), torch.as_tensor(pix),
                     torch.as_tensor(k), torch.as_tensor(mask),
                     sample_idx=jax_ransac_sample(key, mask))
    assert bool(got.valid) and bool(ref.valid)
    assert int(got.num_inliers) == int(ref.num_inliers)
    np.testing.assert_allclose(got.r.numpy(), np.asarray(ref.r), atol=1e-3)
    t_ref = np.asarray(ref.t)
    np.testing.assert_allclose(got.t.numpy(), t_ref,
                               atol=1e-3 * np.abs(t_ref).max())


def test_ransac_pnp_own_sampler_recovers_pose():
    pts3d, pix, k, mask = _pnp_problem(5)
    gen = torch.Generator().manual_seed(0)
    got = ransac_pnp(torch.as_tensor(pts3d), torch.as_tensor(pix),
                     torch.as_tensor(k), torch.as_tensor(mask), generator=gen)
    cam = -got.r.numpy().T @ got.t.numpy()
    np.testing.assert_allclose(cam, [1000.0, 950.0, -900.0], atol=2.0)


def _pose_inputs(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-np.pi, np.pi)
    r = np.array([[np.cos(a), np.sin(a), 0], [-np.sin(a), np.cos(a), 0],
                  [0, 0, 1.0]]) @ np.diag([1.0, 1.0, 1.0])
    t = -r @ np.array([700.0, 650.0, -460.0])
    a2 = np.radians(30.0)
    m_crop = np.array([[0.8 * np.cos(a2), -0.8 * np.sin(a2), 300.0],
                       [0.8 * np.sin(a2), 0.8 * np.cos(a2), 120.0],
                       [0, 0, 1.0]])
    from gisnav_tpu_torch.geometry.crs import pixel_to_wgs84_affine

    aff = pixel_to_wgs84_affine(2208, 2208, -122.27, 37.51, -122.24, 37.53)
    return [x.astype(np.float32) for x in (r, t, m_crop, aff)], aff


def test_assemble_geopose_and_f64():
    (r, t, m_crop, aff), aff64 = _pose_inputs(2)
    got = tgp.assemble_geopose(*(torch.as_tensor(a) for a in
                                 (r, t, m_crop, aff)))
    ref = jgp.assemble_geopose(*(jnp.asarray(a) for a in (r, t, m_crop, aff)))
    ecef, quat, lla, cam = (g.numpy() for g in got)
    np.testing.assert_allclose(cam, np.asarray(ref[3]), rtol=1e-5)
    np.testing.assert_allclose(lla[:2], np.asarray(ref[2])[:2], atol=1e-5)
    np.testing.assert_allclose(lla[2], np.asarray(ref[2])[2], atol=1e-2)
    np.testing.assert_allclose(ecef, np.asarray(ref[0]), atol=1.0)
    np.testing.assert_allclose(quat, np.asarray(ref[1]), atol=1e-5)

    fields = dict(ecef_position=ecef, ecef_quat=quat, lon_lat_alt=lla,
                  r_raster=r, cam_pos_raster=cam, m_crop=m_crop,
                  num_matches=0, num_inliers=0, valid=True, matched_qry=0,
                  matched_ref=0, match_mask=0)
    out = tgp.geopose_to_wgs84_f64(
        tgp.GeoPose(**{k: torch.as_tensor(np.asarray(v)) for k, v in
                       fields.items()}), aff64)
    want = jgp.geopose_to_wgs84_f64(jgp.GeoPose(**fields), aff64)
    for key in ("lon", "lat", "alt_ellipsoid"):
        assert out[key] == pytest.approx(want[key], abs=1e-9)
    np.testing.assert_allclose(out["ecef"], want["ecef"], atol=1e-6)
    np.testing.assert_allclose(out["quat_ecef"], want["quat_ecef"],
                               atol=1e-9)
