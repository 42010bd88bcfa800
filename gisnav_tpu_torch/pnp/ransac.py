"""Batched RANSAC-PnP with fixed shapes, in true f32.

Counterpart of ``gisnav_tpu/pnp/ransac.py``: a fixed batch of 4-point
plane-homography hypotheses (decomposed with the intrinsics, orthonormalised
by the polar Newton iteration with the adjugate inverse), each scored
against every correspondence; the best is polished by fixed-iteration Huber
Gauss-Newton on the full 3D points. Convention ``x ~ K (R X + t)``.

Hypothesis samples come from a ``torch.Generator`` (four distinct indices
per hypothesis, weighted by the validity mask), or from ``sample_idx`` so a
caller can reproduce another implementation's draw. The caller keeps TF32
off (``device.strict_fp32``): raw pixel coordinates need full f32.

Nothing here reads a value back to the host, so a frame program that calls
:func:`ransac_pnp` can be captured as a CUDA graph: the draw is split into
its noise (:func:`draw_noise`, which advances the generator and runs
outside the graph, into a static buffer) and the selection that runs inside
it, the solves and the inverse do not check their ``info`` on the host
(``valid`` carries finiteness), and the best hypothesis is picked by an
index tensor, not read back as a number.

``project_points`` is the pinhole projection ``K (R X + t)`` in f32, its
3x3 products written as multiply-adds so that no TF32 matmul rounds them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = ["PnPResult", "ransac_pnp", "project_points", "draw_samples",
           "draw_noise"]


class PnPResult(NamedTuple):
    r: torch.Tensor  # (3, 3) object -> camera
    t: torch.Tensor  # (3,)
    inliers: torch.Tensor  # (N,) bool
    num_inliers: torch.Tensor  # () int
    valid: torch.Tensor  # () bool


def _rows_times(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x @ m.T`` of (N, 3) rows and a 3x3 ``m`` as multiply-adds."""
    return x[:, 0:1] * m[:, 0] + x[:, 1:2] * m[:, 1] + x[:, 2:3] * m[:, 2]


def project_points(pts3d: torch.Tensor, r: torch.Tensor, t: torch.Tensor,
                   k: torch.Tensor) -> torch.Tensor:
    """Pinhole projection ``K (R X + t)`` of (N, 3) points -> (N, 2) pixel
    coordinates, f32 on the tensors' device."""
    pc = _rows_times(r.float(), pts3d.float()) + t.float()
    pc = _rows_times(k.float(), pc)
    return pc[:, :2] / torch.clamp(pc[:, 2:3], min=1e-9)


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``linalg.solve`` without the host read of ``info``."""
    return torch.linalg.solve_ex(a, b, check_errors=False).result


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _inv3(m: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse via the adjugate."""
    c0 = _cross(m[..., :, 1], m[..., :, 2])
    c1 = _cross(m[..., :, 2], m[..., :, 0])
    c2 = _cross(m[..., :, 0], m[..., :, 1])
    det = torch.sum(m[..., :, 0] * c0, dim=-1)
    adj = torch.stack([c0, c1, c2], dim=-2)
    det = torch.where(torch.abs(det) < 1e-12,
                      torch.full_like(det, 1e-12), det)
    return adj / det[..., None, None]


def _orthonormalize(m: torch.Tensor) -> torch.Tensor:
    """Scaled polar Newton iteration onto SO(3), 4 steps, batched."""
    x = m
    for _ in range(4):
        xit = _inv3(x).transpose(-1, -2)
        g = torch.sqrt(
            torch.clamp(torch.linalg.matrix_norm(xit), min=1e-12)
            / torch.clamp(torch.linalg.matrix_norm(x), min=1e-12))
        g = g[..., None, None]
        x = 0.5 * (g * x + xit / g)
    return x


def _homography_4pt(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Batched DLT homographies from (B, 4, 2) -> (B, 4, 2), h33 = 1."""
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    zeros, ones = torch.zeros_like(x), torch.ones_like(x)
    rows_u = torch.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y], -1)
    rows_v = torch.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y], -1)
    a = torch.cat([rows_u, rows_v], dim=-2)  # (B, 8, 8)
    b = torch.cat([u, v], dim=-1)  # (B, 8)
    at = a.transpose(-1, -2)
    ata = at @ a + 1e-8 * torch.eye(8, dtype=a.dtype, device=a.device)
    h = _solve(ata, at @ b[..., None])[..., 0]
    h = torch.cat([h, torch.ones_like(h[..., :1])], dim=-1)
    return h.reshape(-1, 3, 3)


def _pose_from_homography(h: torch.Tensor):
    a1, a2, a3 = h[..., :, 0], h[..., :, 1], h[..., :, 2]
    s = torch.sign(a3[..., 2:3])
    a1, a2, a3 = a1 * s, a2 * s, a3 * s
    lam = 2.0 / torch.clamp(torch.linalg.norm(a1, dim=-1)
                            + torch.linalg.norm(a2, dim=-1), min=1e-9)
    lam = lam[..., None]
    r1, r2 = a1 * lam, a2 * lam
    r3 = _cross(r1, r2)
    r = _orthonormalize(torch.stack([r1, r2, r3], dim=-1))
    return r, a3 * lam


def _rodrigues(w: torch.Tensor) -> torch.Tensor:
    theta = torch.linalg.norm(w)
    k = w / torch.clamp(theta, min=1e-12)
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    kmat = torch.stack([
        torch.stack([zero, -k[2], k[1]]),
        torch.stack([k[2], zero, -k[0]]),
        torch.stack([-k[1], k[0], zero])])
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    r = (eye + torch.sin(theta) * kmat
         + (1.0 - torch.cos(theta)) * (kmat @ kmat))
    return torch.where(theta < 1e-9, eye, r)


def _gauss_newton(r, t, pts3d_n, pts2d_n, weights, iters, huber_delta):
    eye6 = torch.eye(6, dtype=r.dtype, device=r.device)
    for _ in range(iters):
        pc = pts3d_n @ r.T + t
        z = torch.clamp(pc[:, 2], min=1e-6)
        res = pc[:, :2] / z[:, None] - pts2d_n
        rn = torch.linalg.norm(res, dim=1)
        w_h = torch.where(rn <= huber_delta, torch.ones_like(rn),
                          huber_delta / torch.clamp(rn, min=1e-12))
        w = weights * w_h
        x, y = pc[:, 0], pc[:, 1]
        inv_z = 1.0 / z
        zr = torch.zeros_like(z)
        j_proj = torch.stack([
            torch.stack([inv_z, zr, -x * inv_z * inv_z], dim=1),
            torch.stack([zr, inv_z, -y * inv_z * inv_z], dim=1)], dim=1)
        px, py, pz = pc[:, 0], pc[:, 1], pc[:, 2]
        skew = torch.stack([
            torch.stack([zr, pz, -py], dim=1),
            torch.stack([-pz, zr, px], dim=1),
            torch.stack([py, -px, zr], dim=1)], dim=1)
        j_pc = torch.cat([skew, torch.eye(3, dtype=pc.dtype, device=pc.device)
                          .expand(pc.shape[0], 3, 3)], dim=2)
        jac = j_proj @ j_pc  # (N, 2, 6)
        jw = jac * w[:, None, None]
        jtj = torch.einsum("nik,nil->kl", jw, jac) + 1e-6 * eye6
        jtr = torch.einsum("nik,ni->k", jw, res)
        delta = -_solve(jtj, jtr)
        r = _rodrigues(delta[:3]) @ r
        t = t + delta[3:]
    return r, t


def draw_noise(generator: Optional[torch.Generator], num_hypotheses: int,
               n: int, device=None) -> torch.Tensor:
    """(num_hypotheses, n) Exp(1) noise from ``generator`` (the default
    generator of ``device`` when None): the random half of
    :func:`draw_samples`, as ``torch.multinomial`` draws it."""
    if generator is not None:
        device = generator.device
    return torch.empty((num_hypotheses, n), device=device).exponential_(
        1, generator=generator)


def draw_samples(mask: torch.Tensor, num_hypotheses: int,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(num_hypotheses, 4) distinct indices per row, drawn with weights
    ``mask / sum(mask)`` (uniform when the mask is empty).

    This is ``torch.multinomial(probs.expand(num_hypotheses, -1), 4,
    replacement=False, generator=generator)`` as ATen computes it (the
    exponential race: the top 4 of ``probs / q``, q ~ Exp(1) drawn into a
    fresh contiguous (num_hypotheses, N) tensor), so the same generator
    state gives the same indices, bit for bit. Written out, it reads
    nothing back to the host (``multinomial`` checks its input there), and
    ``noise`` (:func:`draw_noise`) can be drawn ahead, outside a CUDA
    graph."""
    probs = mask.float()
    probs = torch.where(probs.sum() > 0, probs, torch.ones_like(probs))
    if noise is None:
        noise = draw_noise(generator, num_hypotheses, probs.shape[0],
                           probs.device)
    return torch.topk(probs / noise, 4).indices


def ransac_pnp(pts3d, pts2d, k, mask=None, *, sample_idx=None,
               generator=None, noise=None, num_hypotheses: int = 64,
               threshold_px: float = 8.0, min_inliers: int = 10,
               refine_iters: int = 10) -> PnPResult:
    """Robust pose from (N, 3) object / (N, 2) image correspondences.

    :param sample_idx: optional (num_hypotheses, 4) hypothesis indices;
        drawn with ``generator`` when absent
    :param noise: optional (num_hypotheses, N) :func:`draw_noise` output to
        draw with in place of ``generator``
    """
    dt = torch.float32
    pts3d, pts2d, k = pts3d.to(dt), pts2d.to(dt), k.to(dt)
    n = pts3d.shape[0]
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=pts3d.device)
    fmask = mask.to(dt)
    count = torch.clamp(fmask.sum(), min=1.0)

    k_inv = torch.linalg.inv_ex(k, check_errors=False).inverse
    pts2d_n = (torch.cat([pts2d, torch.ones_like(pts2d[:, :1])], dim=1)
               @ k_inv.T)[:, :2]
    threshold_n = threshold_px / (0.5 * (k[0, 0] + k[1, 1]))

    centroid = (pts3d * fmask[:, None]).sum(0) / count
    centered = pts3d - centroid
    scale = torch.sqrt(((centered ** 2).sum(1) * fmask).sum() / count)
    scale = torch.clamp(scale, min=1e-6)
    pts3d_n = centered / scale

    if sample_idx is None:
        sample_idx = draw_samples(mask, num_hypotheses, generator, noise)
    idx = torch.as_tensor(sample_idx, device=pts3d.device).long()
    h = _homography_4pt(pts3d_n[idx][..., :2], pts2d_n[idx])
    rs, ts = _pose_from_homography(h)  # (B, 3, 3), (B, 3)
    pc = torch.einsum("nj,bij->bni", pts3d_n, rs) + ts[:, None, :]
    z = torch.clamp(pc[..., 2], min=1e-6)
    err = torch.linalg.norm(pc[..., :2] / z[..., None] - pts2d_n, dim=-1)
    inl = (err < threshold_n) & mask & (pc[..., 2] > 0)
    best = torch.argmax(inl.sum(dim=1)).reshape(1)  # no host read
    r_best, t_best = rs.index_select(0, best)[0], ts.index_select(0, best)[0]

    pc = pts3d_n @ r_best.T + t_best
    z = torch.clamp(pc[:, 2], min=1e-6)
    err0 = torch.linalg.norm(pc[:, :2] / z[:, None] - pts2d_n, dim=1)
    w0 = ((err0 < threshold_n) & mask).to(dt)
    r_ref, t_ref = _gauss_newton(r_best, t_best, pts3d_n, pts2d_n, w0,
                                 refine_iters, threshold_n)

    pc = pts3d_n @ r_ref.T + t_ref
    z = torch.clamp(pc[:, 2], min=1e-6)
    err = torch.linalg.norm(pc[:, :2] / z[:, None] - pts2d_n, dim=1)
    inliers = (err < threshold_n) & mask & (pc[:, 2] > 0)
    num_inliers = inliers.sum()
    t_full = scale * t_ref - r_ref @ centroid
    finite = torch.isfinite(r_ref).all() & torch.isfinite(t_full).all()
    return PnPResult(r=r_ref, t=t_full, inliers=inliers,
                     num_inliers=num_inliers,
                     valid=(num_inliers >= min_inliers) & finite)
