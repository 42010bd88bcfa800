"""The port's developer images (``nodes/viz.py``, drawn in numpy by
``utils/drawing.py``) against the JAX package's (drawn with OpenCV), and the
pose node's dev topics.

- The match and position images equal the JAX module's pixel for pixel on
  seeded keypoints anywhere inside both images (anti-aliased match lines,
  keypoint discs, inlier discs, the position disc and cross), and with
  ``max_draw`` and masked pairs.
- ``utils/drawing.py``'s ``LINE_AA`` line equals ``cv2.line(..., 1,
  LINE_AA)`` pixel for pixel on grey and BGR canvases over seeded
  segments: shallow, steep, diagonal, zero-length, off the canvas on
  either side, and canvases of 1 to 3 pixels a side (the clipping edges).
- The same ``None`` cases (a position off the raster).
- ``PoseNode(dev_topics=True)`` publishes both images on a classical fix.
"""
import zlib

import cv2
import numpy as np
import pytest

from gisnav_tpu.nodes import viz as jviz
from gisnav_tpu_torch.nodes import viz as tviz
from gisnav_tpu_torch.utils import drawing


def _equal(ours, ref):
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    assert np.array_equal(ours, ref), np.argwhere(ours != ref)[:8].tolist()


@pytest.mark.parametrize("seed,n", [(0, 40), (1, 5), (2, 120), (3, 200),
                                    (4, 60)])
def test_draw_matches_marks_within_one_pixel(seed, n):
    """Keypoints anywhere inside both images, as the pose node gives
    them: the port's image is the JAX module's, pixel for pixel."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 256, (120, 160)).astype(np.uint8)
    r = rng.integers(0, 256, (150, 200)).astype(np.uint8)
    kq = rng.uniform(0, [159, 119], (n, 2))
    kr = rng.uniform(0, [199, 149], (n, 2))
    mask = rng.random(n) > 0.3
    ours, ref = (m.draw_matches(q, r, kq, kr, mask) for m in (tviz, jviz))
    assert ours.shape == (150, 360, 3)
    _equal(ours, ref)
    assert (ours == (0, 120, 255)).all(2).any()
    assert (ours[..., 1] > ours[..., 2].astype(int) + 30).any()


def test_draw_matches_max_draw_and_masked_pairs():
    q = np.full((48, 64), 30, np.uint8)
    r = np.full((64, 80), 60, np.uint8)
    kq = np.array([[10.0, 10.0], [20.0, 20.0], [5.0, 5.0]])
    kr = np.array([[15.0, 12.0], [25.0, 22.0], [7.0, 9.0]])
    imgs = []
    for mod in (tviz, jviz):
        img = mod.draw_matches(q, r, kq, kr, np.array([True, True, False]))
        assert img.shape == (64, 144, 3)
        assert (img[5, 5] == (30, 30, 30)).all()  # masked out: not drawn
        imgs.append(img)
    _equal(*imgs)
    k = np.tile(np.array([[5.0, 5.0], [25.0, 20.0]]), (25, 1))
    ours, ref = (m.draw_matches(q, r, k, k, np.ones(50, bool), max_draw=3)
                 for m in (tviz, jviz))
    _equal(ours, ref)


@pytest.mark.parametrize("cam", [[50.7, 40.2], [2.0, 97.9], [119.5, 0.3],
                                 [60.0, 50.0]])
def test_draw_position_marks_equal(cam):
    rng = np.random.default_rng(3)
    ref_img = rng.integers(0, 256, (100, 120)).astype(np.uint8)
    pts = rng.uniform(-3, 125, (60, 2))
    mask = rng.random(60) > 0.2
    for args in ((), (pts, mask)):
        ours, ref = (m.draw_position(ref_img, np.array([*cam, 1.0]), *args)
                     for m in (tviz, jviz))
        _equal(ours, ref)
        for colour in ((0, 255, 0), (0, 0, 255)):
            assert (ours == colour).all(2).any(), colour


def _aa_segments(kind, rng, h, w):
    """Seeded segments of one kind on an (h, w) canvas."""
    for _ in range(24):
        x0, y0 = (int(v) for v in rng.integers(0, [w, h]))
        if kind == "shallow":
            d = rng.integers(-3 * w, 3 * w + 1), rng.integers(-w, w + 1) // 3
            yield (x0, y0), (x0 + int(d[0]), y0 + int(d[1]))
        elif kind == "steep":
            d = rng.integers(-h, h + 1) // 3, rng.integers(-3 * h, 3 * h + 1)
            yield (x0, y0), (x0 + int(d[0]), y0 + int(d[1]))
        elif kind == "diagonal":
            d = int(rng.integers(-h, h + 1))
            yield (x0, y0), (x0 + d, y0 + d * int(rng.choice([-1, 1])))
        elif kind == "zero-length":
            yield (x0, y0), (x0, y0)
        else:  # off the canvas: either end, or both, outside it
            p = rng.integers(-2 * max(h, w), 3 * max(h, w), 4)
            yield (int(p[0]), int(p[1])), (int(p[2]), int(p[3]))


@pytest.mark.parametrize("shape", [(97, 131), (1, 1), (2, 3), (3, 1),
                                   (64, 2)], ids=str)
@pytest.mark.parametrize("kind", ["shallow", "steep", "diagonal",
                                  "zero-length", "off-canvas"])
@pytest.mark.parametrize("channels", [1, 3])
def test_line_aa_is_cv2(kind, shape, channels):
    rng = np.random.default_rng(zlib.crc32(repr((kind, shape, channels))
                                           .encode()))
    full = shape + ((3,) if channels == 3 else ())
    img = rng.integers(0, 256, full).astype(np.uint8)
    for p0, p1 in _aa_segments(kind, rng, *shape):
        colour = (tuple(int(c) for c in rng.integers(0, 256, 3))
                  if channels == 3 else int(rng.integers(0, 256)))
        ours, ref = img.copy(), img.copy()
        drawing.line(ours, p0, p1, colour, 1, drawing.LINE_AA)
        cv2.line(ref, p0, p1, colour, 1, cv2.LINE_AA)
        _equal(ours, ref)
        img = ref  # later segments cross earlier ones


def test_line_aa_rejects_a_thick_line():
    img = np.zeros((8, 8, 3), np.uint8)
    for call in (
            lambda: drawing.line(img, (0, 0), (3, 3), (1, 2, 3), 2,
                                 drawing.LINE_AA),
            lambda: drawing.line(img, (0, 0), (3, 3), (1, 2, 3), 1, 4),
            lambda: drawing.line(img, (0, 0), (3, 3), (1, 2), 1,
                                 drawing.LINE_AA)):
        with pytest.raises(ValueError):
            call()


def test_draw_position_none_off_the_raster():
    ref_img = np.zeros((64, 64), np.uint8)
    for cam in ([-5.0, 10.0, 1.0], [10.0, 99.0, 1.0], [64.0, 3.0, 1.0],
                [3.0, 64.2, 1.0], [-1.5, 3.0, 1.0]):
        assert tviz.draw_position(ref_img, np.array(cam)) is None
        assert jviz.draw_position(ref_img, np.array(cam)) is None


def test_pose_node_publishes_dev_images():
    """``dev_topics=True``: each classical fix of a 2-step ``GisNavApp``
    flight on the CPU (the loopback stub WMS over a seeded world) publishes
    the match and position images (BGR uint8 numpy) at the frame's stamp,
    the camera's position marked inside the map."""
    from gisnav_tpu_torch.nodes.app import GisNavApp
    from gisnav_tpu_torch.nodes.pose_node import (
        TOPIC_MATCHES_IMAGE,
        TOPIC_POSE,
        TOPIC_POSITION_IMAGE,
    )
    from gisnav_tpu_torch.utils.world_wms import (
        World,
        WorldWMS,
        camera_attitude_quat,
    )

    k = np.array([[400.0, 0, 320.0], [0, 400.0, 240.0], [0, 0, 1.0]])
    world = World.make(seed=7, size_px=2048, gsd_m=1.36)
    with WorldWMS(world) as wms:
        app = GisNavApp(device="cpu", params={
            "gis_node": {"wms_url": wms.url, "wms_layers": ["imagery"],
                         "wms_dem_layers": ["dem"],
                         "wms_format": "image/png"},
            "pose_node": {"backend": "classical", "dev_topics": True,
                          "ground_altitude_m": 0.0},
            "twist_node": {"ground_altitude_m": 0.0},
            "bbox_node": {"ground_altitude_m": 0.0}})
        got = {TOPIC_MATCHES_IMAGE: [], TOPIC_POSITION_IMAGE: [],
               TOPIC_POSE: []}
        for topic, out in got.items():
            app.bus.subscribe(topic, out.append)
        app.bus.publish("/camera/camera_info", {"k": k, "width": 640,
                                                "height": 480})
        lon, lat = world.to_lonlat(1024, 1024)
        for stamp in (1_500_000, 2_000_000):
            app.bus.publish("/mavros/global_position/global",
                            {"stamp_us": stamp, "lat": lat, "lon": lon,
                             "alt_ellipsoid": 500.0})
            app.bus.publish("/mavros/gimbal_control/device/attitude_status",
                            {"stamp_us": stamp,
                             "quat_xyzw": camera_attitude_quat(15.0)})
            app.gis.tick()
            app.bus.publish("/camera/image_raw", {
                "stamp_us": stamp, "frame_id": "camera_optical",
                "image": world.render_frame(lon, lat, 500.0, 15.0, k)})
        app.shutdown()
    poses = [p["stamp_us"] for p in got[TOPIC_POSE]]
    assert len(poses) == 2
    for topic in (TOPIC_MATCHES_IMAGE, TOPIC_POSITION_IMAGE):
        assert [m["stamp_us"] for m in got[topic]] == poses
        for m in got[topic]:
            img = m["image"]
            assert isinstance(img, np.ndarray) and img.dtype == np.uint8
            assert img.ndim == 3 and img.shape[2] == 3
    side = got[TOPIC_POSITION_IMAGE][0]["image"].shape[0]
    assert got[TOPIC_MATCHES_IMAGE][0]["image"].shape == (side, 640 + side,
                                                          3)
    disc = (got[TOPIC_POSITION_IMAGE][0]["image"] == (0, 255, 0)).all(2)
    ys, xs = np.nonzero(disc)
    # the camera is at the map's centre, where the GIS node put it
    assert abs(xs.mean() - side / 2) < 15 and abs(ys.mean() - side / 2) < 15
