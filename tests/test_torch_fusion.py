"""The port's fusion filters against the JAX package's, on the CPU.

The same seeded inputs (numpy) go through ``gisnav_tpu.fusion`` (JAX on the
CPU) and ``gisnav_tpu_torch.fusion`` (``device="cpu"``). Tolerances:

- one filter step: x within 1e-5 relative + 1e-5 absolute, P within 1e-4
  of its largest entry (f32 sums in another order);
- ``PoseFusionFilter`` over the km-scale track of
  ``tests/test_fusion.py::TestFilterScaleStability`` with 6-DoF fixes:
  positions within 1 mm and body velocities within 1 mm/s of the JAX
  filter's at every step (with position-only fixes the attitude is
  unobserved and both filters' body-frame split is chaotic: only the
  tracking bound of the JAX test is held);
- a P that is not positive definite gives NaN, not an exception (XLA's
  Cholesky), and the next absolute fix re-seeds the filter.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gisnav_tpu.fusion import ekf as jax_ekf
from gisnav_tpu.fusion import filter as jax_filter
from gisnav_tpu.fusion import ukf as jax_ukf
from gisnav_tpu.geometry.quaternion import euler_to_quat
from gisnav_tpu_torch.fusion import ekf, ukf
from gisnav_tpu_torch.fusion.filter import PoseFusionFilter, SensorConfig

torch.set_num_threads(2)

STEPS = {
    "ekf_predict": (jax_ekf.ekf_predict, ekf.ekf_predict),
    "ukf_predict": (jax_ukf.ukf_predict, ukf.ukf_predict),
    "ekf_update_pose": (jax_ekf.ekf_update_pose, ekf.ekf_update_pose),
    "ekf_update_velocity": (jax_ekf.ekf_update_velocity,
                            ekf.ekf_update_velocity),
    "ukf_update_pose": (jax_ukf.ukf_update_pose, ukf.ukf_update_pose),
    "ukf_update_velocity": (jax_ukf.ukf_update_velocity,
                            ukf.ukf_update_velocity),
}


def _state(seed):
    """A km-scale mean with a wide, well-conditioned covariance."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=15).astype(np.float32)
    x[:3] = x[:3] * 1000.0
    x[3:6] = rng.uniform(-1.0, 1.0, 3)
    a = rng.normal(size=(15, 15)).astype(np.float32)
    p = (a @ a.T / 15 + np.eye(15)).astype(np.float32)
    return rng, x, p


def _close(jax_state, torch_state):
    xj, pj = np.asarray(jax_state.x), np.asarray(jax_state.p)
    xt, pt = torch_state.x.numpy(), torch_state.p.numpy()
    np.testing.assert_allclose(xt, xj, rtol=1e-5, atol=1e-5)
    assert np.abs(pt - pj).max() <= 1e-4 * np.abs(pj).max()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(STEPS))
def test_filter_step_matches_jax(name, seed):
    jax_fn, torch_fn = STEPS[name]
    rng, x, p = _state(seed)
    jax_s = jax_ekf.EKFState(jnp.asarray(x), jnp.asarray(p))
    torch_s = ekf.EKFState(torch.tensor(x), torch.tensor(p))
    if name.endswith("predict"):
        q = (np.abs(rng.normal(size=15)) * 0.05).astype(np.float32)
        dt = np.float32(0.25)
        _close(jax_fn(jax_s, dt, jnp.asarray(q)),
               torch_fn(torch_s, float(dt), torch.tensor(q)))
        return
    first = 0 if name.endswith("pose") else 6
    z = (x[first:first + 6] + rng.normal(size=6)).astype(np.float32)
    r = (np.abs(rng.normal(size=6)) + 0.1).astype(np.float32)
    mask = np.array([1, 1, 1, 0, 1, 1], np.float32)
    # gate off, gate passing, gate rejecting (then x and P pass through)
    for thr in (0.0, 3.0, 0.1):
        out_j = jax_fn(jax_s, z, r, mask, np.float32(thr))
        out_t = torch_fn(torch_s, torch.tensor(z), torch.tensor(r),
                         torch.tensor(mask), thr)
        _close(out_j, out_t)
        if thr == 0.1:  # unchanged but for the angle wrap's rounding
            np.testing.assert_allclose(out_t.x.numpy(), x, rtol=0,
                                       atol=1e-6)


def _km_track(i, scale=1000.0):
    return np.array([scale + 2.0 * i + np.sin(i), scale * 0.5 + 1.5 * i,
                     500.0 + 0.1 * i])


@pytest.mark.parametrize("backend", ["ekf", "ukf"])
def test_fusion_filter_km_track_matches_jax(backend):
    """6-DoF fixes (the pose sensor's mask in the fusion node) along the
    km-scale track; the two filters agree at every step."""
    quat = np.array([0.0, 0.0, 0.0, 1.0])
    jf = jax_filter.PoseFusionFilter(
        {"deep": jax_filter.SensorConfig(rejection_threshold=3.0)},
        backend=backend)
    tf = PoseFusionFilter({"deep": SensorConfig(rejection_threshold=3.0)},
                          backend=backend, device="cpu")
    for i in range(120):
        stamp = 1_000_000 + i * 500_000
        for f in (jf, tf):
            f.submit("deep", stamp, _km_track(i), quat)
        ej, et = jf.state_at(stamp + 100_000), tf.state_at(stamp + 100_000)
        np.testing.assert_allclose(et["position"], ej["position"], rtol=0,
                                   atol=1e-3)
        np.testing.assert_allclose(et["velocity_body"], ej["velocity_body"],
                                   rtol=0, atol=1e-3)
    assert np.linalg.norm(et["position"] - _km_track(119)) < 3.0


@pytest.mark.parametrize("backend", ["ekf", "ukf"])
def test_fusion_filter_km_track_position_only(backend):
    """Position-only fixes, as ``tests/test_fusion.py`` feeds the JAX
    filter: the port's filter stays finite and tracks within that test's
    3 m. The attitude is then unobserved and the split of motion between
    attitude and body velocity is chaotic (f32 rounding differences grow
    to metres within 20 steps in either package), so the two filters are
    not compared step by step here."""
    f = PoseFusionFilter(
        {"deep": SensorConfig(fuse_mask=(True,) * 3 + (False,) * 3,
                              rejection_threshold=3.0)},
        backend=backend, device="cpu")
    errs = []
    for i in range(120):
        stamp = 1_000_000 + i * 500_000
        f.submit("deep", stamp, _km_track(i), np.array([0.0, 0, 0, 1]))
        est = f.state_at(stamp)
        assert np.all(np.isfinite(est["position"])), i
        errs.append(float(np.linalg.norm(est["position"] - _km_track(i))))
    assert np.mean(errs[-40:]) < 3.0


def test_vo_differential_stream_matches_jax():
    """An absolute fix, then differential VO at 10 Hz implying 2 m/s."""
    q = euler_to_quat(0, 0, 0.3)
    filters = [
        jax_filter.PoseFusionFilter({
            "deep": jax_filter.SensorConfig(),
            "vo": jax_filter.SensorConfig(differential=True)}),
        PoseFusionFilter({"deep": SensorConfig(),
                          "vo": SensorConfig(differential=True)},
                         device="cpu")]
    for f in filters:
        f.submit("vo", 1_000_000, [0, 0, 0], q)
        assert not f.initialized
        f.submit("deep", 1_100_000, [0, 0, 100], q)
        for i in range(1, 21):
            f.submit("vo", 1_100_000 + 100_000 * i, [0.2 * i, 0, 0], q,
                     np.diag([0.01] * 6))
    ej, et = (f.state_at(3_200_000) for f in filters)
    np.testing.assert_allclose(et["position"], ej["position"], atol=1e-3)
    np.testing.assert_allclose(et["velocity_body"], ej["velocity_body"],
                               atol=1e-3)
    assert abs(np.linalg.norm(et["velocity_body"]) - 2.0) < 0.5


def test_non_pd_covariance_gives_nan_and_reseeds():
    _, x, p = _state(2)
    bad = p.copy()
    bad[0, 0] = -5.0
    out = ukf.ukf_predict(ekf.EKFState(torch.tensor(x), torch.tensor(bad)),
                          0.1, torch.ones(15) * 0.01)
    assert torch.isnan(out.x).all() and torch.isnan(out.p).all()
    ref = jax_ukf.ukf_predict(jax_ekf.EKFState(jnp.asarray(x),
                                               jnp.asarray(bad)),
                              np.float32(0.1), jnp.ones(15) * 0.01)
    assert np.isnan(np.asarray(ref.x)).all()

    f = PoseFusionFilter({"deep": SensorConfig(),
                          "vo": SensorConfig(differential=True)},
                         backend="ukf", device="cpu")
    q = euler_to_quat(0, 0, 0)
    f.submit("deep", 1_000_000, np.array([1.0, 2.0, 100.0]), q)
    f._state = f._state._replace(p=torch.tensor(bad))
    # the predict of the next submit NaNs the state; the one after re-seeds
    f.submit("deep", 1_500_000, np.array([2.0, 3.0, 100.0]), q)
    assert not np.isfinite(f.state_at(1_500_000)["position"]).all()
    f.submit("deep", 2_000_000, np.array([3.0, 4.0, 100.0]), q)
    est = f.state_at(2_000_000)
    np.testing.assert_allclose(est["position"], [3.0, 4.0, 100.0],
                               atol=1e-3)
    f.submit("vo", 2_500_000, np.array([3.5, 4.0, 100.0]), q)
    assert np.isfinite(f.state_at(2_500_000)["position"]).all()


@pytest.mark.parametrize("backend", ["ekf", "ukf"])
def test_innovation_gate_rejects_outlier(backend):
    """A 500 m jump is rejected with the gate on and fused without it; the
    port's and the JAX filter's answers agree either way."""
    q = euler_to_quat(0, 0, 0)
    rng = np.random.default_rng(4)
    noise = rng.normal(0, 1.0, (40, 3))
    for thr, far in ((3.0, False), (0.0, True)):
        pair = [
            jax_filter.PoseFusionFilter(
                {"deep": jax_filter.SensorConfig(rejection_threshold=thr)},
                backend=backend),
            PoseFusionFilter({"deep": SensorConfig(rejection_threshold=thr)},
                             backend=backend, device="cpu")]
        for f in pair:
            for i in range(40):
                f.submit("deep", 1_000_000 + 200_000 * i,
                         np.array([1.0 * i, 0, 100]) + noise[i], q,
                         np.diag([1.0] * 3 + [0.01] * 3))
            f.submit("deep", 9_000_000, np.array([540.0, 0, 100]), q,
                     np.diag([1.0] * 3 + [0.01] * 3))
        ej, et = (f.state_at(9_000_000) for f in pair)
        np.testing.assert_allclose(et["position"], ej["position"],
                                   atol=1e-2)
        err = np.linalg.norm(et["position"] - [40.0, 0, 100])
        assert (err > 50.0) if far else (err < 10.0), (thr, err)
