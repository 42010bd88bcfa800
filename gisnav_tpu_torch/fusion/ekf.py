"""15-state EKF in PyTorch (robot_localization-equivalent).

Counterpart of ``gisnav_tpu/fusion/ekf.py``. The reference delegates fusion
to the C++ ``robot_localization`` package (``launch/params/
ekf_global_node.yaml:30-50`` in hmakelin/gisnav): a 15-state omnidirectional
EKF over (x, y, z, roll, pitch, yaw, vx, vy, vz, vroll, vpitch, vyaw, ax,
ay, az) fusing 6-DoF poses. The nonlinear transition is written once, for
any leading batch shape (the UKF pushes its 31 sigma points through it in
one call), and the EKF takes its Jacobian from ``torch.func.jacfwd``, as
the JAX filter takes it from ``jax.jacfwd``.

Everything is f32 with f32 products, as in the JAX filter (which forces f32
matmul precision): the caller turns TF32 off (``device.strict_fp32``), since
a TF32 product keeps ~3 decimal digits of absolute map-frame positions. A
failed inverse gives NaN, as XLA's does, never an exception: the fusion
filter's divergence reset reads that NaN.

State layout (as robot_localization):
  [0:3]  position (world frame)
  [3:6]  orientation roll, pitch, yaw (world frame)
  [6:9]  linear velocity (BODY frame)
  [9:12] angular velocity (BODY frame)
  [12:15] linear acceleration (BODY frame)
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["EKFState", "ekf_init", "ekf_predict", "ekf_update_pose",
           "ekf_update_velocity", "STATE_DIM", "POSE_DIM"]

STATE_DIM = 15
POSE_DIM = 6


class EKFState(NamedTuple):
    x: torch.Tensor  # (15,) f32
    p: torch.Tensor  # (15, 15) f32


def _rot_from_rpy(rpy: torch.Tensor) -> torch.Tensor:
    """Body -> world rotation from roll, pitch, yaw (ZYX), (..., 3, 3)."""
    r, p, y = rpy.unbind(-1)
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return torch.stack([
        torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
                    -1),
        torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
                    -1),
        torch.stack([-sp, cp * sr, cp * cr], -1)], -2)


def _euler_rate_matrix(rpy: torch.Tensor) -> torch.Tensor:
    """Body angular velocity -> euler-angle rates, (..., 3, 3).

    tan and sec are clamped to the flyable-pitch regime (|pitch| <~ 84
    deg), as in the JAX filter: near the singularity they reach 1e6, and a
    sampled covariance (UKF sigma points) squares that into P.
    """
    r, p = rpy[..., 0], rpy[..., 1]
    cr, sr = torch.cos(r), torch.sin(r)
    cp = torch.clamp(torch.cos(p), min=0.1)
    tp = torch.clamp(torch.tan(p), -10.0, 10.0)
    one, zero = torch.ones_like(r), torch.zeros_like(r)
    return torch.stack([torch.stack([one, sr * tp, cr * tp], -1),
                        torch.stack([zero, cr, -sr], -1),
                        torch.stack([zero, sr / cp, cr / cp], -1)], -2)


def _transition(x: torch.Tensor, dt: float) -> torch.Tensor:
    """Nonlinear state transition (constant body acceleration), (..., 15)."""
    pos, rpy = x[..., 0:3], x[..., 3:6]
    v, w, a = x[..., 6:9], x[..., 9:12], x[..., 12:15]
    step = (v * dt + 0.5 * a * dt * dt)[..., None]
    pos_new = pos + (_rot_from_rpy(rpy) @ step)[..., 0]
    rpy_new = rpy + (_euler_rate_matrix(rpy) @ w[..., None])[..., 0] * dt
    return torch.cat([pos_new, rpy_new, v + a * dt, w, a], dim=-1)


def _wrap_angle(a: torch.Tensor) -> torch.Tensor:
    return torch.atan2(torch.sin(a), torch.cos(a))


def _with_wrapped_angles(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x[:3], _wrap_angle(x[3:6]), x[6:]])


def _nan_where_failed(m: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """XLA's semantics of a failed factorisation: the whole result NaN
    (read on the host by nobody here, so no device sync)."""
    return torch.where(info == 0, m, torch.full_like(m, float("nan")))


def inv_nan(a: torch.Tensor) -> torch.Tensor:
    inv, info = torch.linalg.inv_ex(a)
    return _nan_where_failed(inv, info)


def cholesky_nan(a: torch.Tensor) -> torch.Tensor:
    chol, info = torch.linalg.cholesky_ex(a)
    return _nan_where_failed(chol, info)


def ekf_init(x0, p0_diag, device) -> EKFState:
    """Filter state from a (15,) mean and a scalar or (15,) P diagonal."""
    x = torch.as_tensor(np.asarray(x0, np.float32), device=device)
    p = torch.diag(torch.as_tensor(
        np.broadcast_to(np.asarray(p0_diag, np.float32), (STATE_DIM,)).copy(),
        device=device))
    return EKFState(x=x, p=p)


def _diag_q(q_diag: torch.Tensor, dt: float) -> torch.Tensor:
    return torch.diag(q_diag) * max(dt, float(np.float32(1e-6)))


def ekf_predict(state: EKFState, dt: float, q_diag: torch.Tensor
                ) -> EKFState:
    """Integrate the motion model over ``dt`` seconds (an f32 value) and
    propagate P with the transition's Jacobian; ``q_diag`` is the (15,)
    process noise per second."""
    f = partial(_transition, dt=dt)
    x_new = f(state.x)
    jac = torch.func.jacfwd(f)(state.x)
    p_new = jac @ state.p @ jac.T + _diag_q(q_diag, dt)
    return EKFState(x=_with_wrapped_angles(x_new), p=p_new)


def _gate(innov, s_inv, rejection_threshold: float) -> torch.Tensor:
    """1 to fuse, 0 to reject: the Mahalanobis innovation gate in standard
    deviations (robot_localization's ``poseN_rejection_threshold``); <= 0
    disables it. A NaN distance rejects."""
    thr = np.float32(rejection_threshold)
    if thr <= 0:
        return torch.ones((), device=innov.device)
    d2 = innov @ s_inv @ innov
    return (d2 <= float(thr * thr)).to(torch.float32)


def _ekf_update(state: EKFState, z, r_diag, mask, first: int,
                rejection_threshold: float, wrap: bool) -> EKFState:
    """Linear update observing ``x[first:first + 6]``. Masked components
    get zero H rows and a unit R diagonal, so their gain columns are exactly
    zero and S stays well-conditioned (a 1e12 masked variance makes S's f32
    inverse leak error into the live block)."""
    dev = state.x.device
    h = torch.zeros((POSE_DIM, STATE_DIM), device=dev)
    h[:, first:first + POSE_DIM] = torch.eye(POSE_DIM, device=dev)
    h = h * mask[:, None]
    innov = z - state.x[first:first + POSE_DIM]
    if wrap:
        innov = _with_wrapped_angles(innov)
    innov = innov * mask
    r = torch.diag(torch.where(mask > 0, r_diag, torch.ones_like(r_diag)))
    s = h @ state.p @ h.T + r
    s_inv = inv_nan(s)
    k = _gate(innov, s_inv, rejection_threshold) * (state.p @ h.T @ s_inv)
    x_new = _with_wrapped_angles(state.x + k @ innov)
    # Joseph form for numerical stability
    ikh = torch.eye(STATE_DIM, device=dev) - k @ h
    p_new = ikh @ state.p @ ikh.T + k @ r @ k.T
    return EKFState(x=x_new, p=p_new)


def ekf_update_pose(state: EKFState, z, r_diag, mask,
                    rejection_threshold: float = 0.0) -> EKFState:
    """Update with a world-frame 6-DoF pose (x, y, z, roll, pitch, yaw);
    ``r_diag`` its variances, ``mask`` 1 to fuse a component, 0 to ignore
    it (robot_localization's per-sensor config vector)."""
    return _ekf_update(state, z, r_diag, mask, 0, rejection_threshold,
                       wrap=True)


def ekf_update_velocity(state: EKFState, z, r_diag, mask,
                        rejection_threshold: float = 0.0) -> EKFState:
    """Update with a body-frame velocity (vx, vy, vz, vroll, vpitch, vyaw):
    robot_localization's ``pose_differential`` mode fuses VO this way."""
    return _ekf_update(state, z, r_diag, mask, 6, rejection_threshold,
                       wrap=False)
