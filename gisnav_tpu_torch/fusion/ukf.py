"""15-state Unscented Kalman Filter in PyTorch (sigma-point transform).

Counterpart of ``gisnav_tpu/fusion/ukf.py``. The reference's GLOBAL filter
is robot_localization's UKF (``ekf_global_node`` in hmakelin/gisnav); this
mirrors ``fusion.ekf``'s interface with the Merwe-scaled sigma-point
transform, so ``PoseFusionFilter`` runs either backend. The 31 sigma points
go through the transition as one batch.

As in the JAX filter: f32 with f32 products (TF32 off), weighted means
centred on sigma point 0, the masked-R trick and a Joseph-style covariance
update. A covariance that is not positive definite gives NaN sigma points
(``cholesky_ex``, XLA's semantics), never an exception, and the fusion
filter's divergence reset re-seeds from the next absolute fix.
"""
from __future__ import annotations

import numpy as np
import torch

from gisnav_tpu_torch.fusion.ekf import (
    POSE_DIM,
    STATE_DIM,
    EKFState,
    _diag_q,
    _gate,
    _transition,
    _with_wrapped_angles,
    cholesky_nan,
    inv_nan,
)

__all__ = ["ukf_predict", "ukf_update_pose", "ukf_update_velocity"]

# alpha = 0.5 keeps the weights O(1) at f32 (w0_m = -3, a ~1.9-SD spread);
# robot_localization's 1e-3 assumes f64 and its +-1e6 weights amplify the
# transition's curvature residual into P (see the JAX module)
_ALPHA, _BETA, _KAPPA = 0.5, 2.0, 0.0
_LAMBDA = _ALPHA ** 2 * (STATE_DIM + _KAPPA) - STATE_DIM

_WM = np.concatenate([
    np.array([_LAMBDA / (STATE_DIM + _LAMBDA)], np.float32),
    np.full(2 * STATE_DIM, 0.5 / (STATE_DIM + _LAMBDA), np.float32),
])
_WC = _WM.copy()
_WC[0] += 1.0 - _ALPHA ** 2 + _BETA


def _weights(device) -> tuple:
    return (torch.as_tensor(_WM, device=device),
            torch.as_tensor(_WC, device=device))


def _sigma_points(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Merwe scaled sigma points (2n+1, n), from a symmetrised P with a
    jitter relative to its scale."""
    psym = 0.5 * (p + p.T)
    jitter = 1e-6 * (torch.trace(psym) / STATE_DIM) + 1e-9
    psym = psym + jitter * torch.eye(STATE_DIM, device=p.device)
    deltas = cholesky_nan((STATE_DIM + _LAMBDA) * psym).T
    return torch.cat([x[None], x[None] + deltas, x[None] - deltas])


def _centred_mean(pts: torch.Tensor, wm: torch.Tensor) -> torch.Tensor:
    """Weighted mean centred on point 0 (exact, since the weights sum to
    1): summing O(1) weights against km-scale absolute positions would
    build f32 cancellation noise that breaks P's definiteness."""
    return pts[0] + (pts - pts[0][None]).T @ wm


def _weighted_outer(wc, a, b) -> torch.Tensor:
    return torch.einsum("i,ij,ik->jk", wc, a, b)


def ukf_predict(state: EKFState, dt: float, q_diag: torch.Tensor
                ) -> EKFState:
    """Unscented predict: the sigma points through the motion model."""
    wm, wc = _weights(state.x.device)
    prop = _transition(_sigma_points(state.x, state.p), dt)
    x_new = _centred_mean(prop, wm)
    diff = prop - x_new[None]
    p_new = _weighted_outer(wc, diff, diff) + _diag_q(q_diag, dt)
    return EKFState(x=_with_wrapped_angles(x_new), p=p_new)


def _ukf_update(state: EKFState, z, r_diag, mask, first: int,
                rejection_threshold: float) -> EKFState:
    wm, wc = _weights(state.x.device)
    sigmas = _sigma_points(state.x, state.p)
    zs = sigmas[:, first:first + POSE_DIM]  # linear observation
    z_pred = _centred_mean(zs, wm)
    # masked components: zero observation deviations and a unit R diagonal
    # (not a 1e12 variance, whose f32 inverse leaks into the live block)
    dz = (zs - z_pred[None]) * (mask > 0)[None, :]
    dx = sigmas - state.x[None]
    r = torch.diag(torch.where(mask > 0, r_diag, torch.ones_like(r_diag)))
    s = _weighted_outer(wc, dz, dz) + r
    c = _weighted_outer(wc, dx, dz)
    s_inv = inv_nan(s)
    innov = z - z_pred
    if first == 0:  # pose observation: wrap the angle residuals
        innov = _with_wrapped_angles(innov)
    innov = innov * mask
    k = _gate(innov, s_inv, rejection_threshold) * (c @ s_inv)
    x_new = _with_wrapped_angles(state.x + k @ innov)
    # Joseph-style 4-term update: equal to P - K S K' for the exact gain,
    # but stays symmetric and near-PSD under f32 gain error
    p_new = state.p - k @ c.T - c @ k.T + k @ s @ k.T
    return EKFState(x=x_new, p=0.5 * (p_new + p_new.T))


def ukf_update_pose(state: EKFState, z, r_diag, mask,
                    rejection_threshold: float = 0.0) -> EKFState:
    """Unscented update with a 6-DoF pose measurement."""
    return _ukf_update(state, z, r_diag, mask, 0, rejection_threshold)


def ukf_update_velocity(state: EKFState, z, r_diag, mask,
                        rejection_threshold: float = 0.0) -> EKFState:
    """Unscented update with a body-frame velocity measurement."""
    return _ukf_update(state, z, r_diag, mask, 6, rejection_threshold)
