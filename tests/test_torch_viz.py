"""The port's developer images (``nodes/viz.py``, drawn in numpy) against
the JAX package's (drawn with OpenCV), and the pose node's dev topics.

- Backgrounds: every pixel neither image marks equals ``cv2.cvtColor(...,
  COLOR_GRAY2BGR)`` of the input, in both.
- Marks: every pixel the JAX image marks lies within 1 px (8-neighbour) of
  a port mark, and the reverse; so do the marks of each kind. In the match
  image (keypoints inside both images, as the pose node gives them): a
  pixel of the flat keypoint colour lies within 1 px of a red-over-green
  mark of the other image, a clearly green line pixel (green 30 levels
  over red) within 1 px of a green-over-red one (where a later
  anti-aliased line crosses a disc, the blend may read as either). In the
  position image each of the three flat colours is equal pixel for pixel.
- The same ``None`` cases (a position off the raster) and ``max_draw``.
- ``PoseNode(dev_topics=True)`` publishes both images on a classical fix.
"""
import cv2
import numpy as np
import pytest
from scipy.ndimage import binary_dilation

from gisnav_tpu.nodes import viz as jviz
from gisnav_tpu_torch.nodes import viz as tviz

NEAR = np.ones((3, 3), bool)


def _near(a, b):
    """Whether every pixel of mask ``a`` lies within 1 px of mask ``b``."""
    return not (a & ~binary_dilation(b, NEAR)).any()


def _red_over_green(img, marked):
    return marked & (img[..., 2].astype(int) > img[..., 1].astype(int))


def _green_over_red(img, marked, margin=0):
    return marked & (img[..., 1].astype(int) > img[..., 2].astype(int)
                     + margin)


@pytest.mark.parametrize("seed,n", [(0, 40), (1, 5), (2, 120), (3, 200),
                                    (4, 60)])
def test_draw_matches_marks_within_one_pixel(seed, n):
    """Keypoints anywhere inside both images, as the pose node gives
    them."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 256, (120, 160)).astype(np.uint8)
    r = rng.integers(0, 256, (150, 200)).astype(np.uint8)
    kq = rng.uniform(0, [159, 119], (n, 2))
    kr = rng.uniform(0, [199, 149], (n, 2))
    mask = rng.random(n) > 0.3
    ours, ref = (m.draw_matches(q, r, kq, kr, mask) for m in (tviz, jviz))
    assert ours.shape == ref.shape == (150, 360, 3)
    assert ours.dtype == ref.dtype == np.uint8
    bg = np.zeros_like(ref)
    bg[:120, :160] = cv2.cvtColor(q, cv2.COLOR_GRAY2BGR)
    bg[:150, 160:] = cv2.cvtColor(r, cv2.COLOR_GRAY2BGR)
    m_ours, m_ref = ((img != bg).any(axis=2) for img in (ours, ref))
    plain = ~m_ours & ~m_ref
    assert np.array_equal(ours[plain], bg[plain])
    assert np.array_equal(ref[plain], bg[plain])
    assert _near(m_ref, m_ours) and _near(m_ours, m_ref)
    for a, b, ma, mb in ((ours, ref, m_ours, m_ref), (ref, ours, m_ref,
                                                       m_ours)):
        # keypoint discs: the flat keypoint colour of one image near a
        # keypoint-coloured (red over green) mark of the other
        assert _near((a == (0, 120, 255)).all(2), _red_over_green(b, mb))
        # lines: a clearly green mark of one image near a green mark of
        # the other (where a line crosses a disc the blend is either)
        assert _near(_green_over_red(a, ma, 30), _green_over_red(b, mb))
    assert (ours == (0, 120, 255)).all(2).any()
    assert _green_over_red(ours, m_ours, 30).any()


def test_draw_matches_max_draw_and_masked_pairs():
    q = np.full((48, 64), 30, np.uint8)
    r = np.full((64, 80), 60, np.uint8)
    kq = np.array([[10.0, 10.0], [20.0, 20.0], [5.0, 5.0]])
    kr = np.array([[15.0, 12.0], [25.0, 22.0], [7.0, 9.0]])
    for mod in (tviz, jviz):
        img = mod.draw_matches(q, r, kq, kr, np.array([True, True, False]))
        assert img.shape == (64, 144, 3)
        assert (img[5, 5] == (30, 30, 30)).all()  # masked out: not drawn
    k = np.tile(np.array([[5.0, 5.0], [25.0, 20.0]]), (25, 1))
    ours, ref = (m.draw_matches(q, r, k, k, np.ones(50, bool), max_draw=3)
                 for m in (tviz, jviz))
    assert np.array_equal((ours != 30).any(2), (ours != 30).any(2))
    assert _near((ref != ours).any(2), (ref != ours).any(2))


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
        bg = cv2.cvtColor(ref_img, cv2.COLOR_GRAY2BGR)
        plain = ~(ours != bg).any(2) & ~(ref != bg).any(2)
        assert np.array_equal(ours[plain], bg[plain])
        for colour in ((180, 180, 0), (0, 255, 0), (0, 0, 255)):
            a, b = ((img == colour).all(2) for img in (ours, ref))
            assert _near(a, b) and _near(b, a)
            assert np.array_equal(a, b), colour
        assert (ours == (0, 255, 0)).all(2).any()


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
