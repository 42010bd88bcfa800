"""The port's SIFT (plain PyTorch, no OpenCV) against the JAX package's
``extract_sift`` (OpenCV's SIFT), on the CPU.

Two textures: ``tests/test_pipeline.py``'s fractal world seen by its query
camera (480x640, 1024 keypoints) and ``tests/test_features.py``'s blurred
random checkerboard (240x320, 512 keypoints). A cv2 keypoint counts as
reproduced when a port keypoint lies within 0.05 px of it, with its size to
1e-3 relative and its angle to 0.1 deg; a reproduced keypoint's descriptor
counts as equal when every element is within 1 of cv2's (the elements are
integers after OpenCV's rounding, and the port sums the trilinear
histogram in another order).

Measured (OpenCV 5.0.0, PyTorch 2.13 on the CPU; both return the cap plus
the keypoints that tie its last response, 1025 and 513):

- fractal query: 100 % of cv2's 1025 keypoints reproduced, all within
  0.5 px, descriptors 100 % within 1 (95.9 % equal);
- checkerboard: 99.81 % of 513 (one miss, a second orientation peak whose
  angle moved past 0.1 deg), descriptors 100 % within 1 (99.8 % equal);
  uncapped, all of cv2's 3357 keypoints, the same count.

Gates: 99 % of keypoints and 99 % of descriptors (the measured figures less
1 %, room for a few orientation peaks at the 0.8 ratio or histogram bin
edges to flip with the summation order), and every cv2 keypoint within
0.5 px of a port keypoint.
"""
import numpy as np
import pytest
import torch

from gisnav_tpu.features import sift as jsift
from gisnav_tpu_torch.features import sift as tsift
from tests.test_features import TestSiftWire
from tests.test_pipeline import _render_query, _world

torch.set_num_threads(2)

GATE = 0.99


def _checkerboard():
    return TestSiftWire()._checkerboardish(np.random.default_rng(42))


def _fractal_query():
    ortho, aff = _world(np.random.default_rng(42))
    return _render_query(ortho, aff, (400.0, 350.0), 28.0, 400.0)[0]


TEXTURES = {"fractal": (_fractal_query, 1024),
            "checkerboard": (_checkerboard, 512)}


def _port(img, n):
    return [a.numpy() for a in tsift.extract_sift(img, n, device="cpu")]


def _reproduced(cv, port):
    """Per cv2 keypoint: reproduced (position, size, angle), the index of
    the port keypoint it matched, and the distance to the nearest port
    keypoint."""
    (p, s, a), (tp, ts, ta) = cv[:3], port[:3]
    d = np.linalg.norm(p[:, None] - tp[None], axis=-1)
    da = np.abs((a[:, None] - ta[None] + 180.0) % 360.0 - 180.0)
    ds = np.abs(s[:, None] - ts[None]) / s[:, None]
    cost = np.where((da <= 0.1) & (ds <= 1e-3), d, np.inf)
    j = cost.argmin(1)
    return cost[np.arange(len(p)), j] <= 0.05, j, d.min(1)


@pytest.fixture(scope="module", params=sorted(TEXTURES))
def texture(request):
    make, n = TEXTURES[request.param]
    img = make()
    return request.param, img, n, jsift.extract_sift(img, n), _port(img, n)


def test_keypoints_and_descriptors_vs_cv2(texture):
    name, img, n, cv, port = texture
    assert img.dtype == np.uint8
    # OpenCV keeps every keypoint tying the n-th response (the orientation
    # peaks of one extremum share it): n or a few more
    assert len(port[0]) == len(cv[0]) >= n
    ok, j, nearest = _reproduced(cv, port)
    diff = np.abs(cv[3][ok] - port[3][j[ok]]).max(1)
    print(f"{name}: {ok.mean():.2%} of {len(ok)} keypoints reproduced, "
          f"{(nearest < 0.5).mean():.2%} within 0.5 px; descriptors "
          f"{(diff <= 1).mean():.2%} within 1, {(diff == 0).mean():.2%} "
          f"equal")
    assert ok.mean() >= GATE
    assert (nearest < 0.5).all()
    assert (diff <= 1).mean() >= GATE
    # what cv2 returns: f32 arrays, integer descriptors in 0..255
    for a, b in zip(cv, port):
        assert b.dtype == np.float32 and a.shape[1:] == b.shape[1:]
    assert np.array_equal(port[3], np.round(port[3]))
    assert port[3].min() >= 0 and port[3].max() <= 255
    assert (port[2] >= 0).all() and (port[2] < 360).all()


def test_cap_keeps_the_best_responses():
    """Uncapped, the port's set is cv2's; capped at 512 it is cv2's 512
    highest responses and every keypoint tying the 512th."""
    import cv2

    img = _checkerboard()
    kps = cv2.SIFT_create().detect(img, None)
    cv_all = [np.array([k.pt for k in kps], np.float32),
              np.array([k.size for k in kps], np.float32),
              np.array([k.angle for k in kps], np.float32)]
    resp = np.array([k.response for k in kps])
    port_all = _port(img, 0)
    ok, _, _ = _reproduced(cv_all, port_all)
    assert len(port_all[0]) == len(kps) > 512 and ok.mean() >= GATE
    best = np.nonzero(resp >= np.sort(resp)[::-1][511])[0]
    port_cap = _port(img, 512)
    assert len(port_cap[0]) == len(best) < len(kps)
    ok, _, _ = _reproduced([a[best] for a in cv_all], port_cap)
    assert ok.mean() >= GATE
    # the capped set is a subset of the uncapped one
    ok, _, _ = _reproduced(port_cap, port_all)
    assert ok.all()


def test_empty_image():
    img = np.zeros((64, 64), np.uint8)
    pts, sizes, angles, descs = tsift.extract_sift(img, device="cpu")
    assert pts.shape == (0, 2) and descs.shape == (0, 128)
    assert sizes.shape == angles.shape == (0,)
    feats = tsift.pad_features(pts, sizes, angles, descs, 128)
    assert int(feats.mask.sum()) == 0
    assert isinstance(feats, tsift.SiftFeatures)


def test_wire_bytes_equal_jax(texture):
    """The port's wire format is the JAX package's: the same features give
    the same bytes, from numpy or from tensors, and read back the same."""
    _, _, n, cv, port = texture
    for feats in (cv, port):
        want = jsift.pack_keypoints(jsift.pad_features(*feats, n))
        assert tsift.pack_keypoints(tsift.pad_features(*feats, n)) == want
        on_dev = tsift.pad_features(*(torch.as_tensor(a) for a in feats), n)
        assert isinstance(on_dev.keypoints, torch.Tensor)
        assert tsift.pack_keypoints(on_dev) == want
        back, jback = (m.unpack_keypoints(want, n) for m in (tsift, jsift))
        for a, b in zip(back, jback):
            np.testing.assert_array_equal(a, b)
    assert tsift.KEYPOINT_DTYPE == jsift.KEYPOINT_DTYPE
    assert tsift.KEYPOINT_DTYPE.itemsize == 532


def test_batch_equals_single_images():
    """A stack of two images gives each image's own features."""
    a, b = _checkerboard(), _checkerboard()[::-1].copy()
    both = tsift.extract_sift_batch(np.stack([a, b]), 256, device="cpu")
    for img, got in zip((a, b), both):
        want = tsift.extract_sift(img, 256, device="cpu")
        for x, y in zip(got, want):
            assert torch.equal(x, y)


def test_extract_sift_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsift.extract_sift(_checkerboard())
