"""SIFT in plain PyTorch, and the structured keypoint wire format.

Counterpart of ``gisnav_tpu/features/sift.py``. The JAX package calls
OpenCV's SIFT on the host (``cv2.SIFT_create(nfeatures=...)``); the port
computes the same function on tensors, so it needs no OpenCV: Lowe's SIFT
(IJCV 2004) as OpenCV 4/5 implements it (``modules/features2d/src/sift*``),
with its constants, its order of steps and its float32 arithmetic where it
decides which keypoints survive:

- the initial image: the input doubled by bilinear interpolation and blurred
  by ``sqrt(max(1.6^2 - 4 * 0.5^2, 0.01))``;
- ``round(log2(min(2H, 2W)) - 2) + 1`` octaves of 6 Gaussians (3 layers an
  octave) and 5 differences of Gaussians; separable blurs with
  ``round(8 sigma + 1) | 1`` taps and reflect-101 borders; each octave
  starts from every second pixel of the previous octave's layer 3;
- extrema of the 3x3x3 neighbourhood (``>=`` all 26 neighbours for a
  maximum, ``<=`` for a minimum), 5 px from the border, above
  ``floor(0.5 * 0.04 / 3 * 255)``; up to 5 quadratic refinement steps that
  may move the sample, then the contrast (0.04 / 3) and edge (ratio 10)
  tests;
- a 36-bin orientation histogram (Gaussian weight, sigma 1.5 x the scale,
  radius ``round(4.5 x scale)``) smoothed by [1 4 6 4 1] / 16, one keypoint
  for every peak at 0.8 of the maximum or more, with a parabolic fit; the
  angle is reported as ``360 - angle``, OpenCV's convention;
- duplicates removed, the ``nfeatures`` best by response kept (with every
  keypoint that ties the last one), positions and sizes halved for the
  doubled first octave;
- a 4x4x8 descriptor on the rotated patch, trilinear binning, clamped at 0.2
  of its norm, renormalised to 512 and saturated to integers in 0..255.

Everything uniform is batched: the pyramid of a stack of images, all
candidates' refinement as one masked loop, orientation and descriptor
windows as fixed windows per chunk of keypoints sorted by their radius,
with masks. The ragged counts (candidates, keypoints) are read on the host,
as the JAX function's output is ragged too. The blurs are ``F.conv2d``
products, so the entry points turn TF32 off (``device.strict_fp32``): a
TF32 blur moves the difference of Gaussians by more than the contrast
test's margin.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gisnav_tpu_torch.device import resolve_device, strict_fp32

__all__ = [
    "KEYPOINT_DTYPE",
    "SiftFeatures",
    "extract_sift",
    "extract_sift_batch",
    "pack_keypoints",
    "unpack_keypoints",
    "pad_features",
]

KEYPOINT_DTYPE = np.dtype(
    [
        ("x", np.float32),
        ("y", np.float32),
        ("z", np.float32),
        ("size", np.float32),
        ("angle", np.float32),
        ("descriptor", np.float32, (128,)),
    ]
)
"""Wire format identical to the reference's SIFT-over-PointCloud2 records."""

# OpenCV's SIFT constants (sift.simd.hpp) and SIFT_create's defaults
_LAYERS = 3
_SIGMA = 1.6
_INIT_SIGMA = 0.5
_CONTRAST = 0.04
_EDGE = 10.0
_BORDER = 5
_INTERP_STEPS = 5
_ORI_BINS = 36
_ORI_SIG = 1.5
_ORI_RADIUS = 3 * _ORI_SIG
_ORI_PEAK = 0.8
_D = 4  # descriptor width
_N = 8  # descriptor orientation bins
_DESCR_SCL = 3.0
_DESCR_MAG_THR = 0.2
_INT_DESCR = 512.0
_FLT_EPS = float(np.finfo(np.float32).eps)
# cv::hal::fastAtan2's polynomial, in degrees
_ATAN = [np.float32(c) * np.float32(180 / np.pi) for c in (
    0.9997878412794807, -0.3258083974640975, 0.1555786518463281,
    -0.04432655554792128)]
# window samples a chunk may hold (keypoints x window area)
_CHUNK = {"cuda": 1 << 25, "cpu": 1 << 21}


class SiftFeatures(NamedTuple):
    keypoints: np.ndarray  # (K, 2) float32 xy
    sizes: np.ndarray  # (K,)
    angles: np.ndarray  # (K,) degrees
    descriptors: np.ndarray  # (K, 128) float32
    mask: np.ndarray  # (K,) bool


def _f32(x) -> np.float32:
    return np.float32(x)


def _gaussian_kernel(sigma: float) -> np.ndarray:
    """``cv::getGaussianKernel(round(8 sigma + 1) | 1, sigma, CV_32F)``:
    double-precision taps normalised to a sum of 1, then cast to f32."""
    n = int(round(sigma * 8 + 1)) | 1
    half = (n - 1) // 2
    x = np.arange(-half, 0, dtype=np.float64)
    side = np.exp(x * x * (-0.5 / (sigma * sigma)))
    scale = 1.0 / (1.0 + 2.0 * side.sum())
    return np.concatenate([side, [1.0], side[::-1]]) * scale


def _reflect101(idx: torch.Tensor, n: int) -> torch.Tensor:
    """OpenCV's BORDER_REFLECT_101 index map, repeated for any overhang."""
    if n == 1:
        return torch.zeros_like(idx)
    m = torch.remainder(idx, 2 * (n - 1))
    return torch.where(m < n, m, 2 * (n - 1) - m)


def _blur(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Separable blur of (B, H, W) by the taps ``k``, row pass then column
    pass, reflect-101 borders (``cv::GaussianBlur`` with ``Size()``)."""
    n, r = k.numel(), k.numel() // 2
    h, w = x.shape[-2:]
    y = x[:, None]
    if r < w:
        y = F.pad(y, (r, r, 0, 0), mode="reflect")  # reflect-101
    else:  # a kernel wider than the image reflects more than once
        y = y[..., _reflect101(torch.arange(-r, w + r, device=x.device), w)]
    y = F.conv2d(y, k.view(1, 1, 1, n))
    if r < h:
        y = F.pad(y, (0, 0, r, r), mode="reflect")
    else:
        y = y[:, :, _reflect101(torch.arange(-r, h + r, device=x.device), h)]
    return F.conv2d(y, k.view(1, 1, n, 1))[:, 0]


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """``cv::resize`` to twice the size, INTER_LINEAR (half-pixel centres,
    edge clamped): on 8-bit values the 0.25 / 0.75 weights are exact."""
    def axis(a, dim):
        n = a.shape[dim]
        i = torch.arange(n, device=a.device)
        lo = a.index_select(dim, torch.clamp(i - 1, min=0))
        hi = a.index_select(dim, torch.clamp(i + 1, max=n - 1))
        even, odd = 0.25 * lo + 0.75 * a, 0.75 * a + 0.25 * hi
        return torch.stack([even, odd], dim=dim + 1).flatten(dim, dim + 1)

    return axis(axis(x, 1), 2)


def _pyramid(images: torch.Tensor):
    """Gaussian and DoG pyramids of a (B, H, W) float stack: per octave a
    (B, 6, h, w) Gaussian and a (B, 5, h, w) DoG."""
    def taps(sigma):
        return torch.as_tensor(_gaussian_kernel(sigma).astype(np.float32),
                               device=images.device)

    s = _f32(_SIGMA)
    sig_diff = np.sqrt(max(s * s - _f32(_INIT_SIGMA) ** 2 * 4, _f32(0.01)))
    base = _blur(_upsample2(images), taps(float(sig_diff)))
    n_oct = int(round(math.log2(min(base.shape[-2:])) - 2)) + 1
    k = 2.0 ** (1.0 / _LAYERS)
    sig = [_SIGMA] + [math.sqrt((k ** i * _SIGMA) ** 2
                                - (k ** (i - 1) * _SIGMA) ** 2)
                      for i in range(1, _LAYERS + 3)]
    kernels = [None] + [taps(v) for v in sig[1:]]
    gauss, dogs = [], []
    for o in range(n_oct):
        if o == 0:
            layers = [base]
        else:
            prev = gauss[-1][:, _LAYERS]
            h, w = prev.shape[-2] // 2, prev.shape[-1] // 2
            layers = [prev[:, :2 * h:2, :2 * w:2]]
        for i in range(1, _LAYERS + 3):
            layers.append(_blur(layers[-1], kernels[i]))
        g = torch.stack(layers, dim=1)
        gauss.append(g)
        dogs.append(g[:, 1:] - g[:, :-1])
    return gauss, dogs


class _Flat(NamedTuple):
    """A pyramid's octaves packed into one flat tensor, with the per-octave
    offset of image b (``base[o] + b * stride[o]``) and sizes."""
    data: torch.Tensor
    base: torch.Tensor  # (O,)
    stride: torch.Tensor  # (O,) elements of one image's octave
    h: torch.Tensor  # (O,)
    w: torch.Tensor  # (O,)


def _flatten(levels: List[torch.Tensor]) -> _Flat:
    dev = levels[0].device
    sizes = [t.numel() for t in levels]
    base = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    return _Flat(torch.cat([t.reshape(-1) for t in levels]),
                 torch.as_tensor(base, device=dev),
                 torch.as_tensor([t[0].numel() for t in levels], device=dev),
                 torch.as_tensor([t.shape[-2] for t in levels], device=dev),
                 torch.as_tensor([t.shape[-1] for t in levels], device=dev))


def _extrema(dogs: List[torch.Tensor]) -> torch.Tensor:
    """(M, 5) candidates (b, octave, layer, r, c) of every octave."""
    thr = math.floor(0.5 * _CONTRAST / _LAYERS * 255)
    out = []
    for o, dog in enumerate(dogs):
        h, w = dog.shape[-2:]
        if h <= 2 * _BORDER or w <= 2 * _BORDER:
            continue
        mx = F.max_pool3d(dog[:, None], 3, stride=1)[:, 0]
        mn = -F.max_pool3d(-dog[:, None], 3, stride=1)[:, 0]
        v = dog[:, 1:_LAYERS + 1, 1:-1, 1:-1]
        ext = ((v == mx) & (v > thr)) | ((v == mn) & (v < -thr))
        # rows and columns [BORDER, size - BORDER), one less in the crop
        ext = ext[:, :, _BORDER - 1:h - _BORDER - 1,
                  _BORDER - 1:w - _BORDER - 1]
        b, layer, r, c = ext.nonzero(as_tuple=True)
        out.append(torch.stack([b, torch.full_like(b, o), layer + 1,
                                r + _BORDER, c + _BORDER], dim=1))
    if not out:
        return torch.zeros((0, 5), dtype=torch.long, device=dogs[0].device)
    return torch.cat(out)


def _solve3(h, g):
    """``Matx33f::solve(dD, DECOMP_LU)``: Cramer's rule in f32, zeros where
    the determinant is 0 (OpenCV's 3x3 fast solve)."""
    a = [[h[..., i, j] for j in range(3)] for i in range(3)]
    b0, b1, b2 = g[..., 0], g[..., 1], g[..., 2]
    det = (a[0][0] * (a[1][1] * a[2][2] - a[2][1] * a[1][2])
           - a[0][1] * (a[1][0] * a[2][2] - a[2][0] * a[1][2])
           + a[0][2] * (a[1][0] * a[2][1] - a[2][0] * a[1][1]))
    ok = det != 0
    d = 1 / torch.where(ok, det, torch.ones_like(det))
    x0 = d * (b0 * (a[1][1] * a[2][2] - a[1][2] * a[2][1])
              - a[0][1] * (b1 * a[2][2] - a[1][2] * b2)
              + a[0][2] * (b1 * a[2][1] - a[1][1] * b2))
    x1 = d * (a[0][0] * (b1 * a[2][2] - a[1][2] * b2)
              - b0 * (a[1][0] * a[2][2] - a[1][2] * a[2][0])
              + a[0][2] * (a[1][0] * b2 - b1 * a[2][0]))
    x2 = d * (a[0][0] * (a[1][1] * b2 - b1 * a[2][1])
              - a[0][1] * (a[1][0] * b2 - b1 * a[2][0])
              + b0 * (a[1][0] * a[2][1] - a[1][1] * a[2][0]))
    x = torch.stack([x0, x1, x2], dim=-1)
    return torch.where(ok[..., None], x, torch.zeros_like(x))


def _derivatives(dog: _Flat, b, o, layer, r, c):
    """Centre value, gradient (x, y, s) and Hessian of the DoG at integer
    samples, with OpenCV's scaling (``adjustLocalExtrema``). The 3x3x3
    neighbourhood is gathered at once."""
    h, w = dog.h[o], dog.w[o]
    at = dog.base[o] + b * dog.stride[o] + (layer * h + r) * w + c
    nb = torch.arange(27, device=at.device)
    off = ((nb // 9 - 1)[None] * (h * w)[:, None]
           + ((nb // 3) % 3 - 1)[None] * w[:, None] + (nb % 3 - 1)[None])
    cube = dog.data[at[:, None] + off]

    def v(dl=0, dy=0, dx=0):
        return cube[:, (dl + 1) * 9 + (dy + 1) * 3 + dx + 1]

    img_scale = _f32(1.0 / 255)
    d1, d2, dx2 = img_scale * _f32(0.5), img_scale, img_scale * _f32(0.25)
    v0 = v()
    grad = torch.stack([(v(0, 0, 1) - v(0, 0, -1)) * d1,
                        (v(0, 1, 0) - v(0, -1, 0)) * d1,
                        (v(1, 0, 0) - v(-1, 0, 0)) * d1], dim=-1)
    v2 = v0 * 2
    dxx = (v(0, 0, 1) + v(0, 0, -1) - v2) * d2
    dyy = (v(0, 1, 0) + v(0, -1, 0) - v2) * d2
    dss = (v(1, 0, 0) + v(-1, 0, 0) - v2) * d2
    dxy = (v(0, 1, 1) - v(0, 1, -1) - v(0, -1, 1) + v(0, -1, -1)) * dx2
    dxs = (v(1, 0, 1) - v(1, 0, -1) - v(-1, 0, 1) + v(-1, 0, -1)) * dx2
    dys = (v(1, 1, 0) - v(1, -1, 0) - v(-1, 1, 0) + v(-1, -1, 0)) * dx2
    hess = torch.stack([torch.stack([dxx, dxy, dxs], -1),
                        torch.stack([dxy, dyy, dys], -1),
                        torch.stack([dxs, dys, dss], -1)], -2)
    return v0, grad, hess, (dxx, dyy, dxy)


def _refine(dog: _Flat, cand: torch.Tensor):
    """``adjustLocalExtrema`` for every candidate at once: returns the kept
    rows' final (b, o, layer, r, c), offsets (xc, xr, xi) and response."""
    b, o, layer, r, c = cand.unbind(1)
    n = cand.shape[0]
    dev = cand.device
    active = torch.ones(n, dtype=torch.bool, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    x = torch.zeros((n, 3), device=dev)
    big = float(_f32((2 ** 31 - 1) // 3))
    for _ in range(_INTERP_STEPS):
        if not bool(active.any()):
            break
        _, grad, hess, _ = _derivatives(dog, b, o, layer, r, c)
        step = -_solve3(hess, grad)  # (xc, xr, xi)
        x = torch.where(active[:, None], step, x)
        conv = active & (step.abs() < 0.5).all(1)
        done |= conv
        active &= ~conv
        active &= ~(step.abs() > big).any(1)
        mv = torch.where(active[:, None], torch.round(step),
                         torch.zeros_like(step)).long()
        c, r, layer = c + mv[:, 0], r + mv[:, 1], layer + mv[:, 2]
        h, w = dog.h[o], dog.w[o]
        inside = ((layer >= 1) & (layer <= _LAYERS) & (c >= _BORDER)
                  & (c < w - _BORDER) & (r >= _BORDER) & (r < h - _BORDER))
        active &= inside
        # rows that left the octave read their last sample from now on
        c, r, layer = (torch.where(inside, c, c - mv[:, 0]),
                       torch.where(inside, r, r - mv[:, 1]),
                       torch.where(inside, layer, layer - mv[:, 2]))
    v0, grad, _, (dxx, dyy, dxy) = _derivatives(dog, b, o, layer, r, c)
    contr = v0 * _f32(1.0 / 255) + (grad * x).sum(1) * _f32(0.5)
    tr, det = dxx + dyy, dxx * dyy - dxy * dxy
    keep = (done & (contr.abs() * _LAYERS >= _f32(_CONTRAST))
            & (det > 0) & ~(tr * tr * _f32(_EDGE)
                            >= _f32((_EDGE + 1) ** 2) * det))
    idx = keep.nonzero()[:, 0]
    final = torch.stack([b, o, layer, r, c], dim=1)[idx]
    return final, x[idx], contr.abs()[idx]


def _fast_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``cv::fastAtan2`` in degrees, [0, 360)."""
    ax, ay = x.abs(), y.abs()
    c = torch.minimum(ax, ay) / (torch.maximum(ax, ay)
                                 + _f32(np.finfo(np.float64).eps))
    c2 = c * c
    a = (((_ATAN[3] * c2 + _ATAN[2]) * c2 + _ATAN[1]) * c2 + _ATAN[0]) * c
    a = torch.where(ax >= ay, a, 90 - a)
    a = torch.where(x < 0, 180 - a, a)
    return torch.where(y < 0, 360 - a, a)


def _chunks(radius: torch.Tensor, budget: int):
    """Order keypoints by window radius and cut them into chunks of at most
    ``budget`` window samples: yields (indices, chunk radius)."""
    order = torch.argsort(radius, stable=True)
    rad = radius[order].cpu().numpy()
    area = (2 * rad.astype(np.int64) + 1) ** 2
    start = 0
    while start < len(rad):
        # radii ascend: the chunk [start, end) fits while (end - start) *
        # area[end - 1] does, and always holds its first keypoint
        fits = np.arange(1, len(rad) - start + 1) * area[start:] <= budget
        end = start + max(1, int(np.argmin(fits)) if not fits.all()
                          else len(fits))
        yield order[start:end], int(rad[end - 1])
        start = end


def _window(rad: int, dev):
    off = torch.arange(-rad, rad + 1, device=dev)
    return (off[:, None].expand(-1, 2 * rad + 1).reshape(-1),
            off[None, :].expand(2 * rad + 1, -1).reshape(-1))


def _gradients(gauss: _Flat, b, o, layer, cy, cx, dy, dx, valid):
    """Central differences (dx, dy) of the Gaussian image over windows
    (offsets ``dy``, ``dx``) around the centres (``cy``, ``cx``); invalid
    samples read the centre, which lies inside the octave's border."""
    w = gauss.w[o][:, None]
    centre = gauss.base[o] + b * gauss.stride[o] + (
        layer * gauss.h[o] + cy) * gauss.w[o] + cx
    at = centre[:, None] + dy * w + dx
    at = torch.where(valid, at, centre[:, None].expand_as(at))
    gx = gauss.data[at + 1] - gauss.data[at - 1]
    gy = gauss.data[at - w] - gauss.data[at + w]
    return gx, gy


def _orientations(gauss: _Flat, pts: torch.Tensor, x: torch.Tensor,
                  budget: int):
    """``calcOrientationHist`` and the peak search: (keypoint row, angle)
    pairs, the angle in OpenCV's reported convention."""
    b, o, layer, r, c = pts.unbind(1)
    dev = pts.device
    n = pts.shape[0]
    scl = _f32(_SIGMA) * torch.pow(
        torch.tensor(2.0, device=dev),
        (layer.float() + x[:, 2]) / _LAYERS)
    radius = torch.round(_f32(_ORI_RADIUS) * scl).long()
    sigma = _f32(_ORI_SIG) * scl
    expf = -1 / (2 * sigma * sigma)
    hist = torch.zeros((n, _ORI_BINS), device=dev)
    for idx, rad in _chunks(radius, budget):
        dy, dx = _window(rad, dev)
        yy, xx = r[idx, None] + dy, c[idx, None] + dx
        h, w = gauss.h[o[idx]][:, None], gauss.w[o[idx]][:, None]
        valid = ((dy.abs() <= radius[idx, None])
                 & (dx.abs() <= radius[idx, None])
                 & (yy > 0) & (yy < h - 1) & (xx > 0) & (xx < w - 1))
        gx, gy = _gradients(gauss, b[idx], o[idx], layer[idx], r[idx],
                            c[idx], dy, dx, valid)
        wgt = torch.exp((dy * dy + dx * dx).float() * expf[idx, None])
        ori = _fast_atan2(gy, gx)
        mag = torch.sqrt(gx * gx + gy * gy)
        bins = torch.round(_f32(_ORI_BINS / 360) * ori).long()
        bins = torch.where(bins >= _ORI_BINS, bins - _ORI_BINS, bins)
        bins = torch.where(bins < 0, bins + _ORI_BINS, bins)
        contrib = torch.where(valid, wgt * mag, torch.zeros_like(mag))
        part = torch.zeros((len(idx), _ORI_BINS), device=dev)
        part.scatter_add_(1, bins, contrib)
        hist[idx] = part
    t = hist
    sm = ((t.roll(2, 1) + t.roll(-2, 1)) * _f32(1 / 16)
          + (t.roll(1, 1) + t.roll(-1, 1)) * _f32(4 / 16)
          + t * _f32(6 / 16))
    thr = sm.max(1).values * _f32(_ORI_PEAK)
    left, right = sm.roll(1, 1), sm.roll(-1, 1)
    peak = (sm > left) & (sm > right) & (sm >= thr[:, None])
    row, j = peak.nonzero(as_tuple=True)
    hl, hc, hr = left[row, j], sm[row, j], right[row, j]
    bin_ = j.float() + _f32(0.5) * (hl - hr) / (hl - 2 * hc + hr)
    bin_ = torch.where(bin_ < 0, bin_ + _ORI_BINS,
                       torch.where(bin_ >= _ORI_BINS, bin_ - _ORI_BINS,
                                   bin_))
    angle = 360 - _f32(360 / _ORI_BINS) * bin_
    angle = torch.where((angle - 360).abs() < _FLT_EPS,
                        torch.zeros_like(angle), angle)
    return row, angle


def _descriptors(gauss: _Flat, pts, x, angle, budget: int) -> torch.Tensor:
    """``calcSIFTDescriptor`` for every keypoint: (N, 128) f32 integers."""
    b, o, layer, r0, c0 = pts.unbind(1)
    dev = pts.device
    n = pts.shape[0]
    ptx = c0.float() + x[:, 0]
    pty = r0.float() + x[:, 1]
    pr, pc = torch.round(pty).long(), torch.round(ptx).long()
    scl = _f32(_SIGMA) * torch.pow(
        torch.tensor(2.0, device=dev),
        (layer.float() + x[:, 2]) / _LAYERS)
    ori = 360 - angle
    ori = torch.where((ori - 360).abs() < _FLT_EPS, torch.zeros_like(ori),
                      ori)
    rad_ori = ori * _f32(math.pi / 180)
    hist_width = _f32(_DESCR_SCL) * scl
    cos_t = torch.cos(rad_ori) / hist_width
    sin_t = torch.sin(rad_ori) / hist_width
    h, w = gauss.h[o], gauss.w[o]
    radius = torch.round(hist_width * _f32(1.4142135623730951)
                         * _f32(_D + 1) * _f32(0.5)).long()
    radius = torch.minimum(radius, torch.sqrt(
        (w * w + h * h).double()).long())
    nh = (_D + 2) * (_D + 2) * (_N + 2)
    hist = torch.zeros((n, nh), device=dev)
    for idx, rad in _chunks(radius, budget):
        di, dj = _window(rad, dev)
        ct, st = cos_t[idx, None], sin_t[idx, None]
        fi, fj = di.float(), dj.float()
        c_rot = fj * ct - fi * st
        r_rot = fj * st + fi * ct
        rbin = r_rot + _D // 2 - _f32(0.5)
        cbin = c_rot + _D // 2 - _f32(0.5)
        yy, xx = pr[idx, None] + di, pc[idx, None] + dj
        hh, ww = h[idx, None], w[idx, None]
        valid = ((di.abs() <= radius[idx, None])
                 & (dj.abs() <= radius[idx, None])
                 & (rbin > -1) & (rbin < _D) & (cbin > -1) & (cbin < _D)
                 & (yy > 0) & (yy < hh - 1) & (xx > 0) & (xx < ww - 1))
        gx, gy = _gradients(gauss, b[idx], o[idx], layer[idx], pr[idx],
                            pc[idx], di, dj, valid)
        wgt = torch.exp((c_rot * c_rot + r_rot * r_rot)
                        * _f32(-1.0 / (_D * _D * 0.5)))
        obin = (_fast_atan2(gy, gx) - ori[idx, None]) * _f32(_N / 360)
        mag = torch.sqrt(gx * gx + gy * gy) * wgt
        mag = torch.where(valid, mag, torch.zeros_like(mag))
        rf, cf, of = torch.floor(rbin), torch.floor(cbin), torch.floor(obin)
        rbin, cbin, obin = rbin - rf, cbin - cf, obin - of
        ri, ci, oi = rf.long(), cf.long(), of.long()
        oi = torch.where(oi < 0, oi + _N, oi)
        oi = torch.where(oi >= _N, oi - _N, oi)
        v_r1 = mag * rbin
        v_r0 = mag - v_r1
        v_rc11 = v_r1 * cbin
        v_rc10 = v_r1 - v_rc11
        v_rc01 = v_r0 * cbin
        v_rc00 = v_r0 - v_rc01
        v111 = v_rc11 * obin
        v101 = v_rc10 * obin
        v011 = v_rc01 * obin
        v001 = v_rc00 * obin
        vals = [v_rc00 - v001, v001, v_rc01 - v011, v011,
                v_rc10 - v101, v101, v_rc11 - v111, v111]
        base = ((ri + 1) * (_D + 2) + ci + 1) * (_N + 2) + oi
        base = torch.where(valid, base, torch.zeros_like(base))
        offs = [0, 1, _N + 2, _N + 3, (_D + 2) * (_N + 2),
                (_D + 2) * (_N + 2) + 1, (_D + 3) * (_N + 2),
                (_D + 3) * (_N + 2) + 1]
        part = torch.zeros((len(idx), nh), device=dev)
        part.scatter_add_(1, torch.cat([base + k for k in offs], 1),
                          torch.cat(vals, 1))
        hist[idx] = part
    hist = hist.view(n, _D + 2, _D + 2, _N + 2)[:, 1:_D + 1, 1:_D + 1]
    raw = hist[..., :_N].clone()
    raw[..., 0] += hist[..., _N]
    raw[..., 1] += hist[..., _N + 1]
    raw = raw.reshape(n, _D * _D * _N)
    thr = torch.sqrt((raw * raw).sum(1, keepdim=True)) * _f32(_DESCR_MAG_THR)
    raw = torch.minimum(raw, thr)
    nrm = _f32(_INT_DESCR) / torch.clamp(
        torch.sqrt((raw * raw).sum(1, keepdim=True)), min=_FLT_EPS)
    return torch.clamp(torch.round(raw * nrm), 0, 255)


def _lexsort(keys) -> torch.Tensor:
    """Indices ordering rows by ``keys`` (most significant first), each a
    (key, descending) pair."""
    order = None
    for key, desc in reversed(keys):
        k = key if order is None else key[order]
        o = torch.sort(k, descending=desc, stable=True).indices
        order = o if order is None else order[o]
    return order


def extract_sift_batch(images, max_keypoints: int = 1024, *, device=None
                       ) -> List[Tuple[torch.Tensor, ...]]:
    """SIFT on a (B, H, W) uint8 stack: per image (keypoints (N, 2), sizes
    (N,), angles (N,) degrees, descriptors (N, 128) f32) on the device, as
    :func:`extract_sift` gives them."""
    dev = resolve_device(device)
    strict_fp32()
    imgs = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images)
                           else images, device=dev)
    if imgs.dtype != torch.uint8 or imgs.dim() != 3:
        raise ValueError("extract_sift takes (H, W) uint8 images")
    n_img = imgs.shape[0]
    budget = _CHUNK[dev.type]
    gauss, dogs = _pyramid(imgs.float())
    dog, gss = _flatten(dogs), _flatten(gauss)
    cand = _extrema(dogs)
    pts, x, resp = _refine(dog, cand)
    # candidates that converge to one sample are one keypoint (OpenCV keeps
    # identical keypoints once, removeDuplicatedSorted)
    key = (dog.base[pts[:, 1]] + pts[:, 0] * dog.stride[pts[:, 1]]
           + (pts[:, 2] * dog.h[pts[:, 1]] + pts[:, 3]) * dog.w[pts[:, 1]]
           + pts[:, 4])
    order = torch.argsort(key, stable=True)
    ks = key[order]
    first = torch.ones_like(ks, dtype=torch.bool)
    first[1:] = ks[1:] != ks[:-1]
    sel = order[first]
    pts, x, resp = pts[sel], x[sel], resp[sel]
    row, angle = _orientations(gss, pts, x, budget)
    pts, x, resp = pts[row], x[row], resp[row]
    octave = pts[:, 1]
    scale = (2.0 ** octave.float())
    ptx = (pts[:, 4].float() + x[:, 0]) * scale
    pty = (pts[:, 3].float() + x[:, 1]) * scale
    size = _f32(_SIGMA) * torch.pow(
        torch.tensor(2.0, device=dev),
        (pts[:, 2].float() + x[:, 2]) / _LAYERS) * scale * 2
    img_idx = pts[:, 0]
    # retainBest: the max_keypoints best responses of each image and every
    # keypoint tying the last of them
    by_resp = _lexsort([(img_idx, False), (resp, True)])
    counts = torch.bincount(img_idx, minlength=n_img)
    starts = torch.cumsum(counts, 0) - counts
    cut = torch.full((n_img,), -math.inf, device=dev)
    over = counts > max_keypoints if max_keypoints > 0 else counts < 0
    if bool(over.any()):
        at = by_resp[(starts + max_keypoints - 1)[over]]
        cut[over] = resp[at]
    keep = resp >= cut[img_idx]
    # OpenCV's order (removeDuplicatedSorted): x, y ascending, size
    # descending, angle ascending, response descending
    kept = keep.nonzero()[:, 0]
    kept = kept[_lexsort([(img_idx[kept], False), (ptx[kept], False),
                          (pty[kept], False), (size[kept], True),
                          (angle[kept], False), (resp[kept], True)])]
    desc = _descriptors(gss, pts[kept], x[kept], angle[kept], budget)
    pts2 = torch.stack([ptx[kept], pty[kept]], dim=1) * _f32(0.5)
    sizes = size[kept] * _f32(0.5)
    angles = angle[kept]
    n_per = torch.bincount(img_idx[kept], minlength=n_img).tolist()
    out, start = [], 0
    for n in n_per:
        s = slice(start, start + n)
        out.append((pts2[s], sizes[s], angles[s], desc[s]))
        start += n
    return out


def extract_sift(image, max_keypoints: int = 1024, *, device=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """SIFT detect + compute, capped like the reference CPU path (1024
    keypoints), on the device.

    :param image: (H, W) uint8 grayscale, numpy or a tensor
    :return: (keypoints (N, 2), sizes (N,), angles (N,) degrees,
              descriptors (N, 128) f32), tensors on the device
    """
    img = image if torch.is_tensor(image) else np.asarray(image)
    return extract_sift_batch(img[None], max_keypoints, device=device)[0]


def pad_features(pts, sizes, angles, descs, max_keypoints: int
                 ) -> SiftFeatures:
    """Pad/truncate ragged SIFT output to a fixed size with a validity mask.
    Numpy in, numpy out (the wire format's arrays); tensors in, tensors on
    their device out."""
    if torch.is_tensor(pts):
        n = min(len(pts), max_keypoints)
        dev = pts.device

        def pad(a, shape, dtype=torch.float32):
            out = torch.zeros(shape, dtype=dtype, device=dev)
            out[:n] = a[:n]
            return out

        mask = torch.zeros(max_keypoints, dtype=torch.bool, device=dev)
        mask[:n] = True
        return SiftFeatures(pad(pts, (max_keypoints, 2)),
                            pad(sizes, (max_keypoints,)),
                            pad(angles, (max_keypoints,)),
                            pad(descs, (max_keypoints, 128)), mask)
    n = min(len(pts), max_keypoints)
    kp = np.zeros((max_keypoints, 2), np.float32)
    sz = np.zeros(max_keypoints, np.float32)
    an = np.zeros(max_keypoints, np.float32)
    de = np.zeros((max_keypoints, descs.shape[1] if descs.size else 128),
                  np.float32)
    mask = np.zeros(max_keypoints, bool)
    kp[:n] = pts[:n]
    sz[:n] = sizes[:n]
    an[:n] = angles[:n]
    de[:n] = descs[:n]
    mask[:n] = True
    return SiftFeatures(kp, sz, an, de, mask)


def pack_keypoints(feats: SiftFeatures) -> bytes:
    """Serialize features into the reference's structured wire format."""
    feats = SiftFeatures(*(a.detach().cpu().numpy() if torch.is_tensor(a)
                           else a for a in feats))
    n = int(feats.mask.sum())
    data = np.empty(n, dtype=KEYPOINT_DTYPE)
    data["x"] = feats.keypoints[:n, 0]
    data["y"] = feats.keypoints[:n, 1]
    data["z"] = 0.0
    data["size"] = feats.sizes[:n]
    data["angle"] = feats.angles[:n]
    data["descriptor"] = feats.descriptors[:n]
    return data.tobytes()


def unpack_keypoints(raw: bytes, max_keypoints: int) -> SiftFeatures:
    """Parse the structured wire format back into padded fixed-size arrays."""
    data = np.frombuffer(raw, dtype=KEYPOINT_DTYPE)
    pts = np.stack([data["x"], data["y"]], axis=1)
    return pad_features(pts, data["size"], data["angle"], data["descriptor"],
                        max_keypoints)
