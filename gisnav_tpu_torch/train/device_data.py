"""Training pairs generated on the device.

Counterpart of ``gisnav_tpu/train/device_data.py`` (``_texture``,
``_random_affine``, ``_gaussian_blur``, ``_cast_shadows``, ``device_batch``,
``device_batch_asymmetric``): multi-octave textures with thresholded blobs,
an affine partner view through the port's ``warp_affine`` with the exact 3x3
ground truth, unequal blur, a photometric gap and cast shadows in one view.

``jax.random`` and ``torch.Generator`` give different numbers, so each
function is split in two: a draw (unit uniforms and normals from a
``torch.Generator`` on the device, all of a batch at once) and a
deterministic compose that maps them into the JAX module's ranges
(``max(lo, u * (hi - lo) + lo)``, as ``jax.random.uniform`` does) and builds
the images. The tests feed the JAX module's own draws into the compose.

The octaves are resized with ``jax.image.resize``'s cubic weights (Keys'
cubic with a = -0.5; taps outside the image are dropped and the rest
renormalised), as one weight matrix an axis; ``F.interpolate``'s bicubic
(a = -0.75, clamped edges) is another function.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gisnav_tpu_torch.raster.warp import warp_affine

__all__ = ["device_batch", "device_batch_asymmetric", "draw_pairs",
           "compose_pairs", "compose_asymmetric", "jax_cubic_weights"]

_OCTAVES = (6, 16, 48, 128)
_BLOB = 24


@functools.lru_cache(maxsize=32)
def _cubic_weights_np(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) f32: ``compute_weight_mat`` of ``jax.image`` for the
    cubic kernel, scale n_out / n_in, no translation, antialiased."""
    f32 = np.float32
    scale = f32(n_out) / f32(n_in)
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None])
    x = (x / kernel_scale).astype(f32)
    w = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    w = np.where(x >= 1.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x
                 + f32(2.0), w)
    w = np.where(x >= 2.0, f32(0.0), w).astype(f32)
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).T.astype(f32)


def jax_cubic_weights(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """``jax.image.resize(..., "cubic")`` along one axis as an (n_out, n_in)
    matrix."""
    return torch.as_tensor(_cubic_weights_np(n_in, n_out), device=device)


def _resize(grid: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """(B, n, m) -> (B, h, w) with the JAX cubic weights."""
    h, w = shape
    wy = jax_cubic_weights(grid.shape[-2], h, grid.device)
    wx = jax_cubic_weights(grid.shape[-1], w, grid.device)
    return wy @ grid @ wx.T


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _uniform(u: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jax.random.uniform(minval=lo, maxval=hi)`` from its unit draw."""
    lo, hi = _f32(lo, u.device), _f32(hi, u.device)
    return torch.maximum(lo, u * (hi - lo) + lo)


def _texture(octaves, blob, level_u, shape) -> torch.Tensor:
    """Multi-octave noise mixed with thresholded blobs: (B, h, w)."""
    acc = None
    for grid in octaves:
        r = _resize(grid, shape)
        acc = r if acc is None else acc + r
    acc = acc - acc.amin(dim=(1, 2), keepdim=True)
    acc = acc / torch.clamp(acc.amax(dim=(1, 2), keepdim=True), min=1e-6)
    level = _uniform(level_u, 0.4, 0.6)
    blobs = (_resize(blob, shape) > level[:, None, None]).float()
    return 0.55 * acc + 0.45 * blobs


def _affine(c, si, t0, t1) -> torch.Tensor:
    """(B, 3, 3) ``[[c, -si, t0], [si, c, t1], [0, 0, 1]]``."""
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -si, t0], dim=-1),
                        torch.stack([si, c, t1], dim=-1),
                        torch.stack([zero, zero, one], dim=-1)], dim=-2)


def _random_affine(u: torch.Tensor, shape, max_angle_deg, max_scale,
                   max_shift) -> torch.Tensor:
    """(B, 3, 3) img0 px -> img1 px from the unit draws u (B, 4): angle,
    log-uniform scale in [1/(1+max_scale), 1+max_scale], shift."""
    h, w = shape
    dev = u.device
    m_ang, m_shift = _f32(max_angle_deg, dev), _f32(max_shift, dev)
    ls = torch.log(1.0 + _f32(max_scale, dev))
    ang = torch.deg2rad(_uniform(u[:, 0], -m_ang, m_ang))
    s = torch.exp(_uniform(u[:, 1], -ls, ls))
    tx = _uniform(u[:, 2], -m_shift, m_shift) * w
    ty = _uniform(u[:, 3], -m_shift, m_shift) * h
    c, si = torch.cos(ang) * s, torch.sin(ang) * s
    cx, cy = w / 2.0, h / 2.0
    # rotate and scale about the image centre, then shift
    return _affine(c, si, cx - c * cx + si * cy + tx,
                   cy - si * cx - c * cy + ty)


def _gaussian_blur(img: torch.Tensor, sigma: torch.Tensor,
                   radius: int = 3) -> torch.Tensor:
    """Separable 7-tap Gaussian of each image of (B, H, W) at its own sigma
    (B,), SAME zero padding, down the columns and then along the rows."""
    b = img.shape[0]
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32,
                        device=img.device)
    g = torch.exp(-0.5 * (offs / torch.clamp(sigma[:, None], min=1e-3)) ** 2)
    g = g / g.sum(dim=1, keepdim=True)
    n = 2 * radius + 1
    x = F.conv2d(img[None], g.reshape(b, 1, n, 1), padding=(radius, 0),
                 groups=b)
    x = F.conv2d(x, g.reshape(b, 1, 1, n), padding=(0, radius), groups=b)
    return x[0]


def _cast_shadows(u: torch.Tensor, img: torch.Tensor,
                  max_strength) -> torch.Tensor:
    """Soft dark quads in (B, H, W), one for each row of the unit draws u
    (B, n, 5): corner x, y, width, height, strength."""
    _, h, w = img.shape
    ys = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=img.device)[None, :]
    soft = 1.5
    for i in range(u.shape[1]):
        ui = u[:, i, :, None, None]
        x0 = _uniform(ui[:, 0], 0.0, float(w))
        y0 = _uniform(ui[:, 1], 0.0, float(h))
        bw = _uniform(ui[:, 2], 0.04, 0.14) * w
        bh = _uniform(ui[:, 3], 0.04, 0.14) * h
        s = max_strength * _uniform(ui[:, 4], 0.25, 1.0)
        mx = (torch.sigmoid((xs - x0) / soft)
              * torch.sigmoid((x0 + bw - xs) / soft))
        my = (torch.sigmoid((ys - y0) / soft)
              * torch.sigmoid((y0 + bh - ys) / soft))
        img = img * (1.0 - s * mx * my)
    return img


def draw_pairs(generator: torch.Generator, batch: int,
               tex_shape: Tuple[int, int], noise_shape: Tuple[int, int],
               shadow_quads: int = 6) -> Dict[str, object]:
    """The random draws of a batch, on the generator's device: unit
    uniforms and standard normals, in the JAX module's roles."""
    dev = generator.device

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    return {"octaves": [rand(batch, o, o) for o in _OCTAVES],
            "blob": rand(batch, _BLOB, _BLOB), "level": rand(batch),
            "affine": rand(batch, 4), "blur": rand(batch, 2),
            "photo": rand(batch, 2),
            "noise": torch.randn((batch, *noise_shape), generator=generator,
                                 device=dev),
            "shadows": rand(batch, shadow_quads, 5)}


def _blur_view(img, draws, max_blur_sigma, which):
    """Blur view ``which`` (0 or 1) at its own sigma in [0, max)."""
    s = _uniform(draws["blur"][:, which], 0.0, max_blur_sigma)
    return _gaussian_blur(img, s)


def _gap(img, draws, shadow_strength):
    """Gain, bias, noise, clip, then the shadows (the query view only)."""
    gain = 1.0 + _uniform(draws["photo"][:, 0], -0.3, 0.3)
    bias = _uniform(draws["photo"][:, 1], -0.15, 0.15)
    img = torch.clamp(img * gain[:, None, None] + bias[:, None, None]
                      + 0.02 * draws["noise"], 0.0, 1.0)
    if draws["shadows"].shape[1]:
        img = _cast_shadows(draws["shadows"], img, shadow_strength)
    return img


def compose_pairs(draws, shape: Tuple[int, int], max_angle_deg=180.0,
                  max_scale=1.6, max_shift=0.12, max_blur_sigma=1.6,
                  shadow_strength=0.45):
    """``device_batch``'s images from its draws: (image0, image1,
    transform), transform mapping image0 px to image1 px."""
    img0 = _texture(draws["octaves"], draws["blob"], draws["level"], shape)
    a = _random_affine(draws["affine"], shape, max_angle_deg, max_scale,
                       max_shift)
    inv = torch.linalg.inv_ex(a).inverse  # no host sync for the check
    img1 = torch.stack([warp_affine(im[..., None], m, shape)[..., 0]
                        for im, m in zip(img0, inv)])
    img0 = _blur_view(img0, draws, max_blur_sigma, 0)
    img1 = _blur_view(img1, draws, max_blur_sigma, 1)
    return img0, _gap(img1, draws, shadow_strength), a


def compose_asymmetric(draws, q_shape: Tuple[int, int],
                       r_shape: Tuple[int, int], max_angle_deg=180.0,
                       scale_lo=0.6, scale_hi=1.4, max_blur_sigma=1.2,
                       shadow_strength=0.45):
    """``device_batch_asymmetric``'s images from its draws: (query,
    reference, transform), transform mapping query px to reference px."""
    hq, wq = q_shape
    hr, wr = r_shape
    dev = draws["affine"].device
    ref = _texture(draws["octaves"], draws["blob"], draws["level"], r_shape)
    u = draws["affine"]
    m_ang = _f32(max_angle_deg, dev)
    ang = torch.deg2rad(_uniform(u[:, 0], -m_ang, m_ang))
    s = torch.exp(_uniform(u[:, 1], np.log(np.float32(scale_lo)),
                           np.log(np.float32(scale_hi))))
    half_diag = 0.5 * s * float(np.sqrt(np.float32(hq * hq + wq * wq)))
    cx = _uniform(u[:, 2], half_diag, wr - half_diag)
    cy = _uniform(u[:, 3], half_diag, hr - half_diag)
    c, si = torch.cos(ang) * s, torch.sin(ang) * s
    cqx, cqy = wq / 2.0, hq / 2.0
    a = _affine(c, si, cx - c * cqx + si * cqy, cy - si * cqx - c * cqy)
    query = torch.stack([warp_affine(r[..., None], m, q_shape)[..., 0]
                         for r, m in zip(ref, a)])
    query = _blur_view(query, draws, max_blur_sigma, 0)
    ref_b = _blur_view(ref, draws, max_blur_sigma, 1)
    return _gap(query, draws, shadow_strength), ref_b, a


def device_batch(generator: torch.Generator, batch: int,
                 shape: Tuple[int, int], max_angle_deg=180.0, max_scale=1.6,
                 max_shift=0.12, max_blur_sigma=1.6, shadow_quads: int = 6,
                 shadow_strength=0.45):
    """(image0, image1, transform) batch generated on the generator's
    device; the ranges may be device scalars (the curriculum)."""
    draws = draw_pairs(generator, batch, shape, shape, shadow_quads)
    return compose_pairs(draws, shape, max_angle_deg, max_scale, max_shift,
                         max_blur_sigma, shadow_strength)


def device_batch_asymmetric(generator: torch.Generator, batch: int,
                            q_shape: Tuple[int, int] = (256, 320),
                            r_shape: Tuple[int, int] = (576, 640),
                            max_angle_deg=180.0, scale_lo: float = 0.6,
                            scale_hi: float = 1.4, max_blur_sigma=1.2,
                            shadow_quads: int = 6, shadow_strength=0.45):
    """Cached-reference regime: (query, reference, transform), a small
    rotated query inside a large north-up reference."""
    draws = draw_pairs(generator, batch, r_shape, q_shape, shadow_quads)
    return compose_asymmetric(draws, q_shape, r_shape, max_angle_deg,
                              scale_lo, scale_hi, max_blur_sigma,
                              shadow_strength)
