"""The port's ``TwistNode`` (visual odometry) against the JAX package's.

Each node runs on its own ``LocalBus`` and gets the same messages: camera
info, a global position that sets the distance to ground, then the frames
of a straight, level flight rendered by ``utils/world.render_flight`` (20 m
steps at 300 m above flat ground, f = 400 px, 480x640, the yaw drifting by
4 deg), after ``initialize_pose`` with the first camera's true pose.

- With OpenCV's features in both nodes (the JAX package's
  ``extract_sift`` patched into the port's node) and the JAX node's RANSAC
  draw (``PRNGKey(0)``, rebuilt on the port's match mask) injected into the
  port's ``ransac_pnp``: every published pose equals the JAX node's to
  1 mm and 1e-6 in the quaternion (measured 0.12 mm and 5e-8).
- With the port's own SIFT (no OpenCV) and its own RANSAC generator: the
  same number of poses, each step's translation within 0.5 m of the true
  20 m step, and the integrated position within 2 m of the truth after 5
  steps (measured: step errors 0.18-0.33 m, 0.78 m after 5 steps).
- The nadir gate and the ``initialize_pose`` gate behave as the JAX node's:
  no pose while the camera looks off-nadir (and no match across the
  slew), none published before ``initialize_pose``.
- The topic and node names equal the JAX package's.
"""
import jax
import numpy as np
import pytest
import torch

from gisnav_tpu import constants as jconst
from gisnav_tpu.features.sift import extract_sift as cv_sift
from gisnav_tpu.nodes import twist_node as jtwist
from gisnav_tpu.nodes.bus import LocalBus as JBus
from gisnav_tpu_torch import constants as tconst
from gisnav_tpu_torch.nodes import twist_node as ttwist
from gisnav_tpu_torch.nodes.bus import LocalBus
from gisnav_tpu_torch.utils.world import render_flight
from tests.test_torch_geometry import jax_ransac_sample

torch.set_num_threads(2)

STEPS = 6
NADIR = np.array([1.0, 0.0, 0.0, 0.0])  # optical axis down (xyzw)
SIDEWAYS = np.array([np.sqrt(0.5), 0.0, 0.0, np.sqrt(0.5)])  # horizontal


@pytest.fixture(scope="module")
def flight():
    return render_flight(seed=3, h=480, w=640, steps=STEPS)


def _fly(node_cls, bus_cls, flight, initialize=True, attitudes=None, **kw):
    """Drive a twist node over the frames of ``flight``: (published poses,
    step outputs)."""
    bus = bus_cls()
    node = node_cls(bus, **kw)
    published, steps = [], []
    bus.subscribe(jtwist.TOPIC_TWIST_POSE, published.append)
    if initialize:
        node.initialize_pose(flight.poses[0])
    bus.publish(jconst.ROS_TOPIC_CAMERA_INFO,
                {"k": flight.k, "width": 640, "height": 480})
    bus.publish(jconst.ROS_TOPIC_MAVROS_GLOBAL_POSITION,
                {"alt_ellipsoid": flight.alt_m})
    step = node.step

    def record(msg):
        steps.append(step(msg))
        return steps[-1]

    node.step = record  # the image handler steps through the recorder
    for i in range(len(flight.frames)):
        if attitudes is not None:
            bus.publish(jconst.ROS_TOPIC_MAVROS_GIMBAL_DEVICE_ATTITUDE_STATUS,
                        {"quat_xyzw": attitudes[i]})
        bus.publish(jconst.ROS_TOPIC_IMAGE,
                    {"image": flight.frames[i], "stamp_us": i * 100_000})
    return published, steps


def _cv2_port(monkeypatch):
    """The port's node with OpenCV's features and the JAX node's draw."""
    ransac = ttwist.ransac_pnp

    def jax_draw(obj, pts, k, mask, generator=None, **kw):
        idx = jax_ransac_sample(jax.random.PRNGKey(0), mask.numpy())
        return ransac(obj, pts, k, mask, sample_idx=idx, **kw)

    monkeypatch.setattr(ttwist, "ransac_pnp", jax_draw)
    monkeypatch.setattr(ttwist, "extract_sift", lambda img, n, device=None:
                        tuple(torch.as_tensor(a) for a in cv_sift(img, n)))


def test_poses_equal_jax_on_cv2_features(flight, monkeypatch):
    _cv2_port(monkeypatch)
    want, _ = _fly(jtwist.TwistNode, JBus, flight)
    got, _ = _fly(ttwist.TwistNode, LocalBus, flight, device="cpu")
    assert len(got) == len(want) == STEPS - 1
    for a, b in zip(got, want):
        dpos = np.abs(a["position"] - b["position"]).max()
        dq = np.abs(a["quat_xyzw"] - b["quat_xyzw"]).max()
        print(f"port-vs-JAX position {dpos * 1e3:.4f} mm, quaternion "
              f"{dq:.2e}")
        assert dpos < 1e-3 and dq < 1e-6
        assert a["stamp_us"] == b["stamp_us"]
        assert a["frame_id"] == b["frame_id"] == "gisnav_odom"
        np.testing.assert_array_equal(a["covariance"], b["covariance"])


def test_own_sift_tracks_the_truth(flight):
    got, _ = _fly(ttwist.TwistNode, LocalBus, flight, device="cpu")
    assert len(got) == STEPS - 1
    prev = flight.poses[0][:3, 3]
    for i, pose in enumerate(got, start=1):
        truth = flight.poses[i][:3, 3]
        step_err = np.linalg.norm((pose["position"] - prev)
                                  - (truth - flight.poses[i - 1][:3, 3]))
        err = np.linalg.norm(pose["position"] - truth)
        print(f"step {i}: step error {step_err:.3f} m, position error "
              f"{err:.3f} m")
        assert step_err < 0.5
        prev = pose["position"]
    assert err < 2.0


def test_nadir_and_initialize_gates_as_jax(flight, monkeypatch):
    """Frame 2 looks sideways: no pose there nor at frame 3 (its previous
    frame was dropped); without ``initialize_pose`` the node steps but
    publishes nothing. Both nodes step alike."""
    _cv2_port(monkeypatch)
    att = [NADIR, NADIR, SIDEWAYS, NADIR, NADIR, NADIR]
    for init in (True, False):
        runs = [_fly(cls, bus, flight, initialize=init, attitudes=att, **kw)
                for cls, bus, kw in ((jtwist.TwistNode, JBus, {}),
                                     (ttwist.TwistNode, LocalBus,
                                      {"device": "cpu"}))]
        (jpub, jsteps), (tpub, tsteps) = runs
        pattern = [s is not None for s in tsteps]
        assert pattern == [s is not None for s in jsteps]
        assert pattern == [False, True, False, False, True, True]
        assert len(tpub) == len(jpub) == (3 if init else 0)


def test_node_waits_for_camera_info(flight):
    node = ttwist.TwistNode(LocalBus(), device="cpu")
    assert node.step({"image": flight.frames[0], "stamp_us": 0}) is None
    assert node._prev is None


def test_twist_node_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttwist.TwistNode(LocalBus())


def test_constants_equal_jax():
    for name in ("ROS_NAMESPACE", "TWIST_NODE_NAME", "ROS_TOPIC_CAMERA_INFO",
                 "ROS_TOPIC_IMAGE", "ROS_TOPIC_MAVROS_GLOBAL_POSITION",
                 "ROS_TOPIC_MAVROS_GIMBAL_DEVICE_ATTITUDE_STATUS",
                 "ROS_TOPIC_RELATIVE_POSE"):
        assert getattr(tconst, name) == getattr(jconst, name), name
    assert ttwist.TOPIC_TWIST_POSE == jtwist.TOPIC_TWIST_POSE == \
        "/gisnav/twist_node/pose"
