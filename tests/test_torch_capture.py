"""Every program the port replays as a CUDA graph, held on the CPU against
what a capture refuses, and the parity of their tensor inputs with the JAX
package.

- **The host-read guard** (``pipeline.graph.HostReadGuard``, a
  ``TorchDispatchMode``): each graphed program runs once unguarded (the
  warm-up a ``FrameGraph`` runs before it captures: uploads of cached
  constants) and then under the guard, which raises on a read of a device
  value on the host (``aten._local_scalar_dense``: ``.item()``, ``bool()``,
  ``int()`` of a tensor; a linalg ``info`` check), on an output whose shape
  depends on the data (``nonzero``, ``masked_select``, ``unique``), on
  ``multinomial`` and on a tensor made from host data inside the program
  (``aten.lift_fresh``: on the card a copy from pageable memory). One case
  a program, at a small size: the bucketed and cached frames and the
  bucket refresh, the map extraction, the exact-warp frame
  (gather with zoom and the zoom-less 3-shear rotation, its quadrant
  static), the derotated cached frame, the semi-dense frame, the classical
  rotate + crop and tail, the UKF's and EKF's predict and two updates, the
  three train chunks and the host-data train step. AdamW's own update is
  PyTorch's ``capturable`` one on the card; on the CPU (not capturable) it
  reads its step count, so the chunks' ``opt.step`` runs outside the guard
  and everything around it (pairs, forward, backward, the zeroed
  gradients, the device step counter, the curriculum) inside.
- **Parity**, each tolerance named:
  - the crop matrix built from a () angle and zoom against the JAX
    package's ``rotate_and_crop_center`` matrix (rtol 1e-6 + 1 ulp of the
    largest entry) and bit-equal to the host-number route; the gather crop
    too, and the 3-shear rotation from a () angle with a given quadrant
    bit-equal to the one that reads its angle on the host;
  - the filter steps with a () ``dt`` and threshold against
    ``gisnav_tpu/fusion/ukf.py`` and ``ekf.py`` (1e-5 relative to each
    array's largest entry, a 1e-6 floor), and bit-equal to the port's steps
    with host numbers;
  - the device-data train chunk (the step counter on the device, read by
    the curriculum inside) against the same steps run one at a time with
    the curriculum taken from a host counter: the same losses, bit for bit,
    and the ramp's values at each step.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gisnav_tpu.fusion import ekf as jekf
from gisnav_tpu.fusion import ukf as jukf
from gisnav_tpu.raster import warp as jwarp
from gisnav_tpu_torch.features.sift import extract_sift_batch, pad_features
from gisnav_tpu_torch.fusion import ekf as tekf
from gisnav_tpu_torch.fusion import ukf as tukf
from gisnav_tpu_torch.pipeline import classical as tcls
from gisnav_tpu_torch.pipeline import geopose as tgp
from gisnav_tpu_torch.pipeline.graph import CaptureError, HostReadGuard
from gisnav_tpu_torch.pnp.ransac import draw_noise
from gisnav_tpu_torch.raster import shear as tshear
from gisnav_tpu_torch.raster import warp as twarp
from gisnav_tpu_torch.train import device_data as DD
from gisnav_tpu_torch.train import loftr_steps as TL
from gisnav_tpu_torch.train import steps as TS
from gisnav_tpu_torch.utils.world import render_scene
from gisnav_tpu_torch.weights import params_from_jax

torch.set_num_threads(2)

H, W = 96, 128  # the query; the map 256 px, the shear stack 384 px
CFG = tgp.PipelineConfig(image_shape=(H, W), ortho_shape=(256, 256),
                         max_keypoints=64, lightglue_depth=1,
                         ref_tile_grid=(4, 4))


@pytest.fixture(scope="module")
def world():
    scene = render_scene(seed=3, h=H, w=W, yaws=[20.0], map_side=256,
                         coverage=2.0)
    gen = torch.Generator().manual_seed(0)
    models = tgp.build_models(params_from_jax(
        tgp.init_pipeline_params(gen, CFG)), CFG)
    f32 = np.float32
    q = torch.as_tensor(scene.frames[0].astype(f32)) / 255.0
    ortho = torch.as_tensor(scene.ortho.astype(f32)) / 255.0
    dem = torch.as_tensor(scene.dem)
    k = torch.as_tensor(scene.k.astype(f32))
    aff = torch.as_tensor(scene.crs_affine.astype(f32))
    return scene, models, q, ortho, dem, k, aff


def _noise(n, seed=5):
    return draw_noise(torch.Generator().manual_seed(seed),
                      CFG.num_hypotheses, n)


def _guarded(fn, *args):
    """``fn(*args)`` once as the warm-up, then under the guard."""
    fn(*args)
    with HostReadGuard():
        return fn(*args)


def _frames(world):
    scene, models, q, ortho, dem, k, aff = world
    angle, zoom = torch.tensor(20.0), torch.tensor(0.75)
    kp = CFG.max_keypoints
    refresh = tgp.build_warp_reference_extractor(CFG)
    feats, dem_crop, m_crop = refresh(models, ortho, dem, 0.0, 0.75)
    cached_cfg = dataclasses.replace(CFG, detector_downsample=2)
    cached = tgp.build_frame_to_geopose_cached(cached_cfg)
    ref = tgp.build_reference_extractor(CFG)(models, ortho)
    exact = tgp.build_frame_to_geopose(CFG)
    hot = tgp.build_frame_to_geopose_warpcached(CFG)
    prior = (torch.tensor([128.0, 128.0]), torch.tensor(90.0))
    return {
        "bucketed_frame": (lambda *a: hot(models, *a[:-1], noise=a[-1]),
                           q, feats, dem_crop, m_crop, k, aff, _noise(kp)),
        "bucket_refresh": (lambda *a: refresh(models, *a), ortho, dem,
                           angle, zoom),
        "map_extraction": (
            lambda o: tgp.build_reference_extractor(CFG)(
                models, o.float() / 255.0),
            torch.as_tensor(scene.ortho)),
        "cached_frame": (
            lambda *a: cached(models, *a[:5], prior_xy=a[5],
                              prior_radius=a[6], noise=a[7]),
            q, ref, dem, k, aff, *prior, _noise(kp)),
        "cached_frame_derotate": (
            lambda *a: cached(models, *a[:5], prior_xy=a[5],
                              prior_radius=a[6], noise=a[7],
                              rotation_deg=a[8]),
            q, ref, dem, k, aff, *prior, _noise(kp), angle),
        "exact_warp_zoom": (
            lambda *a: exact(models, *a[:6], gsd_zoom=a[6], noise=a[7]),
            q, ortho, dem, angle, k, aff, zoom, _noise(kp)),
        "exact_warp_shear": (
            lambda s, a: tshear.rotate_and_crop_center_shear(
                s, a, (H, W), quadrant=1),
            torch.rand((384, 384, 2), generator=torch.Generator()
                       .manual_seed(1)), torch.tensor(97.0)),
    }


def _semidense_case(world):
    scene, _, q, ortho, dem, k, aff = world
    cfg = dataclasses.replace(CFG, max_keypoints=32)
    gen = torch.Generator().manual_seed(2)
    models = tgp.build_models(params_from_jax(
        tgp.init_semidense_params(gen, cfg)), cfg)
    fn = tgp.build_frame_to_geopose_semidense(cfg)
    return (lambda *a: fn(models, *a[:6], gsd_zoom=a[6], noise=a[7]),
            q, ortho, dem, torch.tensor(20.0), k, aff, torch.tensor(0.75),
            _noise(32))


def _classical_cases(world):
    scene = world[0]
    cfg = dataclasses.replace(CFG, max_keypoints=128)
    warp = tcls.warp_program((H, W))
    ortho, dem = torch.as_tensor(scene.ortho), torch.as_tensor(scene.dem)
    ref_img, dem_crop, m_crop = warp(ortho, dem, 20.0)
    qry = torch.as_tensor(scene.frames[0])
    raw_q, raw_r = extract_sift_batch(torch.stack([qry, ref_img]), 128,
                                      device="cpu")
    fq, fr = pad_features(*raw_q, 128), pad_features(*raw_r, 128)
    tail = tcls._device_tail(cfg)
    k, aff = world[5], world[6]
    return {
        "classical_warp": (warp, ortho, dem, torch.tensor(20.0)),
        "classical_tail": (
            lambda *a: tail(*a[:-1], noise=a[-1]), fq.keypoints,
            fq.descriptors, fq.mask, fr.keypoints, fr.descriptors, fr.mask,
            dem_crop, m_crop, k, aff, _noise(128)),
    }


def _filter_state(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, 15).astype(np.float32)
    x[:3] = [120.0, -40.0, 300.0]
    x[3:6] = [0.05, -0.03, 1.2]
    a = rng.normal(0, 0.1, (15, 15)).astype(np.float32)
    p = (a @ a.T + 0.5 * np.eye(15)).astype(np.float32)
    z = (x[:6] + rng.normal(0, 0.3, 6)).astype(np.float32)
    zv = (x[6:12] + rng.normal(0, 0.2, 6)).astype(np.float32)
    r = np.array([4.0, 4.0, 9.0, 0.003, 0.003, 0.003], np.float32)
    mask = np.array([1, 1, 1, 0, 1, 1], np.float32)
    q = np.linspace(0.01, 0.06, 15).astype(np.float32)
    return x, p, z, zv, r, mask, q


_FILTERS = {
    "ekf": (tekf.ekf_predict, tekf.ekf_update_pose, tekf.ekf_update_velocity,
            jekf.ekf_predict, jekf.ekf_update_pose, jekf.ekf_update_velocity),
    "ukf": (tukf.ukf_predict, tukf.ukf_update_pose, tukf.ukf_update_velocity,
            jukf.ukf_predict, jukf.ukf_update_pose, jukf.ukf_update_velocity),
}


def _filter_cases():
    x, p, z, zv, r, mask, q = (torch.as_tensor(a) for a in _filter_state())
    cases = {}
    for name, (pred, upd_pose, upd_vel, *_) in _FILTERS.items():
        cases[f"{name}_predict"] = (
            lambda x, p, dt, q, f=pred: f(tekf.EKFState(x, p), dt, q),
            x, p, torch.tensor(0.25), q)
        for what, f, zz in (("pose", upd_pose, z), ("velocity", upd_vel, zv)):
            cases[f"{name}_update_{what}"] = (
                lambda x, p, *a, f=f: f(tekf.EKFState(x, p), *a),
                x, p, zz, r, mask, torch.tensor(3.0))
    return cases


TRAIN_CFG = TS.TrainConfig(image_shape=(64, 80), max_keypoints=32,
                           lightglue_depth=1)
CACHED_CFG = TS.CachedRegimeConfig(q_shape=(64, 80), r_shape=(128, 160),
                                   q_keypoints=32, r_keypoints=64,
                                   r_tile_grid=(2, 2), lightglue_depth=1)
LOFTR_CFG = TL.LoFTRTrainConfig(image_shape=(64, 80), max_matches=16,
                                depth=1)


def _unguarded_optimizer(state):
    """The state's AdamW with its ``step`` run outside the guard (on the
    card it is capturable; on the CPU it reads its step count)."""
    from torch.utils._python_dispatch import _disable_current_modes

    opt = state.opt_state
    step = opt.step

    def outside(*a, **kw):
        with _disable_current_modes():
            return step(*a, **kw)

    opt.step = outside
    return state


def _train_case(name):
    gen = torch.Generator().manual_seed(0)
    if name == "train_chunk":
        state, tx = TS.init_train_state(gen, TRAIN_CFG, "cpu")
        chunk = TS.make_device_train_chunk(TRAIN_CFG, tx, 2, chunk=2)
    elif name == "train_chunk_cached_regime":
        state, tx = TS.init_train_state(gen, dataclasses.replace(
            TRAIN_CFG, detector_mode="harris"), "cpu")
        chunk = TS.make_cached_regime_chunk(CACHED_CFG, tx, 2, chunk=2)
    elif name == "train_chunk_loftr":
        state, tx = TL.init_loftr_train_state(gen, LOFTR_CFG, "cpu")
        chunk = TL.make_loftr_device_train_chunk(LOFTR_CFG, tx, 1, chunk=2)
    else:
        state, tx = TS.init_train_state(gen, TRAIN_CFG, "cpu")
        step = TS.make_train_step(TRAIN_CFG, tx)
        pairs = DD.device_batch(torch.Generator().manual_seed(4), 2, (64, 80))
        _unguarded_optimizer(state)
        return lambda *b: step(state, *b)[1], *pairs
    _unguarded_optimizer(state)
    data = torch.Generator().manual_seed(9)
    return (lambda: chunk(state, data)[1],)


PROGRAMS = ["bucketed_frame", "bucket_refresh", "map_extraction",
            "cached_frame", "cached_frame_derotate", "exact_warp_zoom",
            "exact_warp_shear", "semidense_frame", "classical_warp",
            "classical_tail", *_filter_cases(), "train_chunk",
            "train_chunk_cached_regime", "train_chunk_loftr",
            "train_step_host_data"]


@pytest.mark.parametrize("program", PROGRAMS)
def test_graphed_program_reads_nothing_on_the_host(world, program):
    if program == "semidense_frame":
        fn, *args = _semidense_case(world)
    elif program.startswith("classical"):
        fn, *args = _classical_cases(world)[program]
    elif program.startswith(("ekf", "ukf")):
        fn, *args = _filter_cases()[program]
    elif program.startswith("train"):
        fn, *args = _train_case(program)
    else:
        fn, *args = _frames(world)[program]
    out = _guarded(fn, *args)
    assert out is not None


@pytest.mark.parametrize("refused", ["item", "if", "index", "nonzero",
                                     "multinomial", "tensor", "inv"])
def test_guard_refuses_what_capture_refuses(refused):
    x = torch.rand(8)
    programs = {
        "item": lambda: x.sum().item(),
        "if": lambda: 1 if x.sum() > 0 else 0,
        "index": lambda: x[x.argmax()],
        "nonzero": lambda: x[x > 0.5],
        "multinomial": lambda: torch.multinomial(x, 2),
        "tensor": lambda: x * torch.tensor(2.0),
        "inv": lambda: torch.linalg.inv(torch.eye(3) + x[:1]),
    }
    with pytest.raises(CaptureError):
        with HostReadGuard():
            programs[refused]()
    with HostReadGuard():  # and lets the capturable forms through
        torch.linalg.inv_ex(torch.eye(3) + x[:1])
        x.index_select(0, x.argmax().reshape(1))
        torch.where(x > 0.5, x, torch.full((), 2.0))


@pytest.mark.parametrize("angle,zoom", [(0.0, None), (33.3, 0.8),
                                        (-151.7, 1.37), (270.0, None)])
def test_device_built_crop_matrix_vs_jax(angle, zoom):
    rng = np.random.default_rng(1)
    stack = rng.random((300, 420, 2)).astype(np.float32)
    want_crop, want_m = jwarp.rotate_and_crop_center(
        jnp.asarray(stack), jnp.float32(angle), (64, 96),
        None if zoom is None else jnp.float32(zoom))
    host_crop, host_m = twarp.rotate_and_crop_center(
        torch.as_tensor(stack), angle, (64, 96), zoom)
    args = (torch.as_tensor(stack), torch.tensor(angle), (64, 96),
            None if zoom is None else torch.tensor(np.float32(zoom)))
    with HostReadGuard():
        crop, m = twarp.rotate_and_crop_center(*args)
    assert torch.equal(m, host_m) and torch.equal(crop, host_crop)
    want_m = np.asarray(want_m)
    tol = 1e-6 * np.abs(want_m) + np.spacing(np.abs(want_m).max())
    assert (np.abs(m.numpy() - want_m) <= tol).all()
    np.testing.assert_allclose(crop.numpy(), np.asarray(want_crop),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("angle", [20.0, -33.0, 117.0, 200.5])
def test_shear_rotation_from_a_device_angle_equals_host_angle(angle):
    stack = torch.rand((384, 384, 2), generator=torch.Generator()
                       .manual_seed(2))
    want = tshear.rotate_and_crop_center_shear(stack, angle, (96, 128))
    angle_t = torch.tensor(angle)
    with HostReadGuard():
        got = tshear.rotate_and_crop_center_shear(
            stack, angle_t, (96, 128),
            quadrant=tshear.rotation_quadrant(angle))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _close(got, want):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * scale


@pytest.mark.parametrize("backend", ["ekf", "ukf"])
def test_filter_steps_with_tensor_dt_and_threshold_vs_jax(backend):
    """Each step from the port's state before it, as the JAX step takes
    it: a step's tolerance, not a chained flight's."""
    pred, upd_pose, upd_vel, jpred, jupd_pose, jupd_vel = _FILTERS[backend]
    x, p, z, zv, r, mask, q = _filter_state(3)
    t = torch.as_tensor
    state = tekf.EKFState(t(x), t(p))

    def jstate():
        return jekf.EKFState(x=jnp.asarray(state.x.numpy()),
                             p=jnp.asarray(state.p.numpy()))

    for dt, thr in ((0.25, 0.0), (0.1, 3.0), (0.5, 1e-3)):
        want = jpred(jstate(), jnp.float32(dt), jnp.asarray(q))
        host = pred(state, float(np.float32(dt)), t(q))
        state = pred(state, torch.tensor(np.float32(dt)), t(q))
        assert torch.equal(state.x, host.x) and torch.equal(state.p, host.p)
        _close(state.x, want.x)
        _close(state.p, want.p)
        for jf, f, zz in ((jupd_pose, upd_pose, z), (jupd_vel, upd_vel, zv)):
            want = jf(jstate(), jnp.asarray(zz), jnp.asarray(r),
                      jnp.asarray(mask), jnp.float32(thr))
            host = f(state, t(zz), t(r), t(mask), float(np.float32(thr)))
            state = f(state, t(zz), t(r), t(mask),
                      torch.tensor(np.float32(thr)))
            assert torch.equal(state.x, host.x)
            assert torch.equal(state.p, host.p)
            _close(state.x, want.x)
            _close(state.p, want.p)


def test_chunk_with_device_step_equals_steps_with_host_counter(monkeypatch):
    cfg = dataclasses.replace(TRAIN_CFG, curriculum_steps=2)
    seen = []
    batch = DD.device_batch

    def recorded(*a, **kw):
        seen.append(float(kw["max_angle_deg"]))
        return batch(*a, **kw)

    monkeypatch.setattr(DD, "device_batch", recorded)
    state, tx = TS.init_train_state(torch.Generator().manual_seed(0), cfg,
                                    "cpu")
    assert state.step.device == TS.tree_leaves(state.params)[0].device
    state, m = TS.make_device_train_chunk(cfg, tx, 2, chunk=3)(
        state, torch.Generator().manual_seed(9))
    assert int(state.step) == 3
    assert seen == [20.0, 100.0, 180.0]  # d = 0, 1/2, 1: read on the device

    ref, tx = TS.init_train_state(torch.Generator().manual_seed(0), cfg,
                                  "cpu")
    step = TS.make_train_step(cfg, tx)
    gen = torch.Generator().manual_seed(9)
    losses = []
    for i in range(3):
        d = TS.curriculum(torch.tensor(i), cfg.curriculum_steps)
        pairs = batch(gen, 2, cfg.image_shape, max_angle_deg=20.0 + 160.0 * d,
                      max_scale=0.3 + 1.3 * d, max_shift=0.06 + 0.06 * d,
                      max_blur_sigma=1.6 * d, shadow_strength=0.45 * d)
        ref, mi = step(ref, *pairs)
        losses.append(mi["loss"])
    assert torch.equal(m["loss"], torch.stack(losses).mean())
    for a, b in zip(TS.tree_leaves(state.params), TS.tree_leaves(ref.params)):
        assert torch.equal(a, b)
