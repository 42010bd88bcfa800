"""The port's classical frame program (``pipeline/classical.py``) against
the JAX package's, on ``tests/test_pipeline.py``'s scenes (the fractal
768x768 world at 1.45 m/px, a 480x640 nadir query at f = 400 px).

- The tail on the JAX package's own features: the JAX crop, its cv2 SIFT
  features of query and crop and its RANSAC draw (``PRNGKey(seed)``,
  rebuilt on the port's match mask) through the port's matcher, DEM lift,
  RANSAC-PnP and geopose assembly: the fix of the JAX tail to 1 mm.
- The whole program with the port's SIFT (no OpenCV) and the port's own
  RANSAC generator: ``tests/test_pipeline.py``'s own gates, 1.0 m east and
  north and 2.0 m in altitude at crop rotations 0 and 28 deg, a spread under
  1 m (2 m in altitude) over rotations 0, -40 and 90 deg, under 2 m with the
  DEM relief. Each test prints the port's distance from the JAX fix.

On the CPU the rotate + crop is the gather warp in both packages (on the
card the port takes the 3-shear kernel for a square map whose side is a
multiple of 128, as the JAX package does on an accelerator).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gisnav_tpu.features.sift import extract_sift as cv_sift
from gisnav_tpu.features.sift import pad_features as j_pad
from gisnav_tpu.pipeline import PipelineConfig as JConfig
from gisnav_tpu.pipeline import classical as jcls
from gisnav_tpu.pipeline.geopose import geopose_to_wgs84_f64 as j_wgs84
from gisnav_tpu.raster import rotate_and_crop_auto as j_rotate
from gisnav_tpu_torch.pipeline import classical as tcls
from gisnav_tpu_torch.pipeline.geopose import PipelineConfig
from gisnav_tpu_torch.pipeline.geopose import geopose_to_wgs84_f64 as t_wgs84
from tests.test_pipeline import (
    H_ORTHO,
    IMG_SHAPE,
    K_CAM,
    W_ORTHO,
    _render_query,
    _world,
)
from tests.test_torch_geometry import jax_ransac_sample

torch.set_num_threads(2)

CFG = PipelineConfig(image_shape=IMG_SHAPE, ortho_shape=(H_ORTHO, W_ORTHO))
J_CFG = JConfig(image_shape=IMG_SHAPE, ortho_shape=(H_ORTHO, W_ORTHO))
M_EAST = 111320 * np.cos(np.radians(60))
M_NORTH = 110574


@pytest.fixture(scope="module")
def world():
    # the rng fixture's seed, as tests/test_pipeline.py draws its world
    return _world(np.random.default_rng(42))


def _errors(fix, aff, cam_px, alt_m):
    want = aff @ np.append([cam_px[0], cam_px[1], -alt_m / -aff[2, 2]], 1.0)
    return ((fix["lon"] - want[0]) * M_EAST,
            (fix["lat"] - want[1]) * M_NORTH, fix["alt_ellipsoid"] - alt_m)


def _port_and_jax(query, ortho, dem, rot, aff):
    pose = tcls.classical_frame_to_geopose(query, ortho, dem, rot, K_CAM, aff,
                                           CFG, device="cpu")
    jpose = jcls.classical_frame_to_geopose(query, ortho, dem, rot, K_CAM,
                                            aff, J_CFG)
    fix, jfix = t_wgs84(pose, aff), j_wgs84(jpose, aff)
    d = np.hypot((fix["lon"] - jfix["lon"]) * M_EAST,
                 (fix["lat"] - jfix["lat"]) * M_NORTH)
    print(f"rotation {rot}: port matches {int(pose.num_matches)} inliers "
          f"{int(pose.num_inliers)}, JAX {int(jpose.num_matches)} / "
          f"{int(jpose.num_inliers)}; port-vs-JAX {d:.4f} m horizontal, "
          f"{abs(fix['alt_ellipsoid'] - jfix['alt_ellipsoid']):.4f} m "
          f"altitude")
    assert bool(pose.valid)
    return pose, fix


@pytest.mark.parametrize("rotation_deg", [0.0, 28.0])
def test_tail_on_jax_features_vs_jax_tail(world, rotation_deg):
    ortho, aff = world
    query, _, _ = _render_query(ortho, aff, (400.0, 350.0), 28.0, 400.0)
    ys, xs = np.mgrid[0:H_ORTHO, 0:W_ORTHO]
    dem = (2.0 * np.sin(xs / 120.0) * np.cos(ys / 90.0)).astype(np.float32)
    stack = jnp.stack([jnp.asarray(ortho, jnp.float32), jnp.asarray(dem)], -1)
    warped, m_crop = j_rotate(stack, jnp.float32(rotation_deg), IMG_SHAPE)
    ref_img = np.clip(np.asarray(warped[:, :, 0]), 0, 255).astype(np.uint8)
    kq = J_CFG.max_keypoints
    fq = j_pad(*cv_sift(query, kq), kq)
    fr = j_pad(*cv_sift(ref_img, kq), kq)
    key = jax.random.PRNGKey(3)
    want = jcls._device_tail(J_CFG)(
        *(jnp.asarray(a) for a in (fq.keypoints, fq.descriptors, fq.mask,
                                   fr.keypoints, fr.descriptors, fr.mask)),
        warped[:, :, 1], m_crop, jnp.asarray(K_CAM, jnp.float32),
        jnp.asarray(aff, jnp.float32), key)
    got = tcls._device_tail(CFG)(
        *(torch.as_tensor(a) for a in (fq.keypoints, fq.descriptors, fq.mask,
                                       fr.keypoints, fr.descriptors,
                                       fr.mask)),
        torch.as_tensor(np.asarray(warped[:, :, 1])),
        torch.as_tensor(np.asarray(m_crop)),
        torch.as_tensor(K_CAM, dtype=torch.float32),
        torch.as_tensor(aff, dtype=torch.float32),
        sample_idx=lambda mask, _: jax_ransac_sample(key, mask.numpy()))
    assert bool(got.valid) and bool(want.valid)
    assert int(got.num_matches) == int(want.num_matches) > 100
    assert int(got.num_inliers) == int(want.num_inliers)
    a, b = t_wgs84(got, aff), j_wgs84(want, aff)
    d = np.hypot((a["lon"] - b["lon"]) * M_EAST, (a["lat"] - b["lat"])
                 * M_NORTH)
    dalt = abs(a["alt_ellipsoid"] - b["alt_ellipsoid"])
    print(f"tail on JAX features: {d * 1e3:.4f} mm, altitude "
          f"{dalt * 1e3:.4f} mm")
    assert np.hypot(d, dalt) < 1e-3


@pytest.mark.parametrize("rotation_deg", [0.0, 28.0])
def test_recovers_camera_position(world, rotation_deg):
    ortho, aff = world
    cam_px, alt_m = (400.0, 350.0), 400.0
    query, _, _ = _render_query(ortho, aff, cam_px, 28.0, alt_m)
    dem = np.zeros((H_ORTHO, W_ORTHO), np.float32)
    pose, fix = _port_and_jax(query, ortho, dem, rotation_deg, aff)
    err_e, err_n, err_u = _errors(fix, aff, cam_px, alt_m)
    print(f"errors east {err_e:.3f} north {err_n:.3f} up {err_u:.3f} m")
    assert abs(err_e) < 1.0 and abs(err_n) < 1.0, (err_e, err_n)
    assert abs(err_u) < 2.0, err_u
    from gisnav_tpu_torch.geometry.crs import wgs84_to_ecef

    want_ecef = np.array(wgs84_to_ecef(fix["lon"], fix["lat"],
                                       fix["alt_ellipsoid"]))
    assert np.allclose(fix["ecef"], want_ecef, atol=1e-6)
    # the device's f32 ECEF within ~2 m of the f64 one
    assert np.linalg.norm(pose.ecef_position.numpy() - want_ecef) < 2.0


def test_rotation_invariance(world):
    """The geopose must not depend on the reference crop's rotation."""
    ortho, aff = world
    query, *_ = _render_query(ortho, aff, (380.0, 380.0), -40.0, 350.0)
    dem = np.zeros((H_ORTHO, W_ORTHO), np.float32)
    outs = []
    for rot in (0.0, -40.0, 90.0):
        _, o = _port_and_jax(query, ortho, dem, rot, aff)
        outs.append([o["lon"], o["lat"], o["alt_ellipsoid"]])
    outs = np.array(outs)
    spread_m = (np.ptp(outs[:, :2], axis=0) * [M_EAST, M_NORTH]).max()
    print(f"rotation spread {spread_m:.3f} m, altitude "
          f"{np.ptp(outs[:, 2]):.3f} m")
    assert spread_m < 1.0, outs
    assert np.ptp(outs[:, 2]) < 2.0


def test_dem_relief(world):
    """With relief in the DEM the solve stays accurate (z-lift sign and
    units)."""
    ortho, aff = world
    cam_px = (400.0, 350.0)
    query, _, _ = _render_query(ortho, aff, cam_px, 0.0, 400.0)
    ys, xs = np.mgrid[0:H_ORTHO, 0:W_ORTHO]
    dem = (2.0 * np.sin(xs / 120.0) * np.cos(ys / 90.0)).astype(np.float32)
    _, fix = _port_and_jax(query, ortho, dem, 0.0, aff)
    err_e, err_n, _ = _errors(fix, aff, cam_px, 400.0)
    assert np.hypot(err_e, err_n) < 2.0


def test_query_of_another_size(world):
    """A crop smaller than the query (360x480 against 480x640): SIFT runs on
    each image alone instead of on one stack, and the fix still meets the
    1 m gate."""
    ortho, aff = world
    cam_px, alt_m = (400.0, 350.0), 400.0
    query, _, _ = _render_query(ortho, aff, cam_px, 0.0, alt_m)
    cfg = PipelineConfig(image_shape=(360, 480), ortho_shape=ortho.shape)
    pose = tcls.classical_frame_to_geopose(
        query, ortho, np.zeros_like(ortho, np.float32), 0.0, K_CAM, aff, cfg,
        device="cpu")
    assert bool(pose.valid)
    err_e, err_n, _ = _errors(t_wgs84(pose, aff), aff, cam_px, alt_m)
    assert abs(err_e) < 1.0 and abs(err_n) < 1.0, (err_e, err_n)


def test_classical_raises_without_cuda(world, monkeypatch):
    ortho, aff = world
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcls.classical_frame_to_geopose(
            ortho[:480, :640], ortho, np.zeros_like(ortho, np.float32), 0.0,
            K_CAM, aff, CFG)
