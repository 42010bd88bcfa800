"""The port's ``replay`` against the JAX package's, on the CPU.

- ``load_dataset`` returns what the JAX loader returns on the same files:
  a dataset the port writes (``utils/world_wms.py``
  ``write_replay_dataset``), and one with a colour map, colour frames and a
  16-bit DEM image written by OpenCV (colour becomes grey as libpng makes
  it under ``imread``'s grey flag, exactly). A JPEG under the layout's PNG
  name is read by content, equal to ``cv2.imread``'s grey read and to the
  JAX loader's; a file of neither format raises ``ValueError``; a missing
  frame ``FileNotFoundError``.
- A flight stored as a camera stores it: JPEG frames turned 90 degrees
  with an Exif APP1 (Orientation 6) and the map a 256-entry grey palette
  PNG. Every frame and the map read as ``cv2.imread`` reads them, and the
  ``harris_lg5`` replay matches the JAX one within the PNG flight's gates
  (the port read such frames sideways, and refused the palette map,
  before it applied EXIF orientation and read palette PNG).
- ``summarize`` equals the JAX one on the same report.
- ``harris_lg5`` ``replay`` with ``--fused`` on 4 frames through both
  packages, the port's cached program drawing RANSAC samples as the JAX
  runner does: equal ``frames`` / ``valid`` / ``pass_10m``, each frame's
  fix within the cached runner's gates of the JAX fix (2.5 m horizontally,
  0.5 m in altitude: ``ROADMAP.md`` Queue 3 item 2; measured 0.2 m and
  0.04 m), the fused track within 2.5 m of the JAX track; the same on the
  flight recorded as JPEG.
- The classical backend on 3 frames: valid and within 10 m in both
  packages (their RANSAC draws differ), within 2.5 m of each other.
"""
import csv
import itertools
import json
import os

import cv2
import jax
import numpy as np
import pytest
import torch

import gisnav_tpu_torch.pipeline.runners as truns
from gisnav_tpu import replay as jreplay
from gisnav_tpu_torch import replay as treplay
from gisnav_tpu_torch.utils.world_wms import World, write_replay_dataset
from tests.test_torch_geometry import jax_ransac_sample

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def world():
    return World.make(seed=7, size_px=3072, gsd_m=1.36)


@pytest.fixture(scope="module")
def flight(world, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("flight"))
    write_replay_dataset(world, root, frames=4)
    return root


def _equal_datasets(a, b):
    assert set(a) == set(b)
    for key in ("ortho", "dem", "k"):
        assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape
        np.testing.assert_array_equal(a[key], b[key])
    assert a["bounds"] == b["bounds"]
    assert a["image_size"] == b["image_size"]
    assert a["poses"] == b["poses"]


def test_load_dataset_equals_jax(flight):
    ours, ref = treplay.load_dataset(flight), jreplay.load_dataset(flight)
    _equal_datasets(ours, ref)
    assert ours["image_size"] == (480, 640) and len(ours["poses"]) == 4
    assert ours["ortho"].shape == (800, 800)


def test_load_colour_images_and_16bit_dem(tmp_path, world):
    root = str(tmp_path)
    write_replay_dataset(world, root, frames=2)
    rng = np.random.default_rng(0)
    cv2.imwrite(os.path.join(root, "map.png"),
                rng.integers(0, 256, (64, 64, 3)).astype(np.uint8))
    for name in os.listdir(os.path.join(root, "frames")):
        cv2.imwrite(os.path.join(root, "frames", name),
                    rng.integers(0, 256, (480, 640, 3)).astype(np.uint8))
    cv2.imwrite(os.path.join(root, "dem.png"),
                rng.integers(0, 65536, (16, 16)).astype(np.uint16))
    meta_path = os.path.join(root, "map.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta.update(dem="dem.png", dem_scale=0.01)
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    ours, ref = treplay.load_dataset(root), jreplay.load_dataset(root)
    # colour to grey: libpng's conversion, as the JAX loader's imread
    _equal_datasets(ours, ref)
    assert ours["dem"].dtype == np.float32 and ours["dem"].max() > 255
    for row in ours["poses"]:
        frame = treplay._read_gray8(row["frame_path"])
        np.testing.assert_array_equal(frame, cv2.imread(
            row["frame_path"], cv2.IMREAD_GRAYSCALE))
        bgr = cv2.imread(row["frame_path"], cv2.IMREAD_COLOR)
        assert np.abs(frame.astype(int) - cv2.cvtColor(
            bgr, cv2.COLOR_BGR2GRAY)).max() <= 1  # libpng truncates


def test_load_dataset_refusals(tmp_path, world):
    root = str(tmp_path)
    write_replay_dataset(world, root, frames=2)
    os.remove(os.path.join(root, "frames", "1000000.png"))
    with pytest.raises(FileNotFoundError):
        treplay.load_dataset(root)
    write_replay_dataset(world, root, frames=2)
    # a JPEG under the PNG name is read by its content, as cv2.imread does
    rng = np.random.default_rng(1)
    ok, jpeg = cv2.imencode(".jpg", rng.integers(0, 256, (24, 40, 3)).astype(
        np.uint8))
    with open(os.path.join(root, "map.png"), "wb") as f:
        f.write(jpeg.tobytes())
    ours, ref = treplay.load_dataset(root), jreplay.load_dataset(root)
    np.testing.assert_array_equal(ours["ortho"], cv2.imread(
        os.path.join(root, "map.png"), cv2.IMREAD_GRAYSCALE))
    _equal_datasets(ours, ref)
    with open(os.path.join(root, "map.png"), "wb") as f:
        f.write(b"GIF89a not an image the port reads")
    with pytest.raises(ValueError, match="not an image OpenCV would read"):
        treplay.load_dataset(root)
    with open(os.path.join(root, "poses.csv"), "w", newline="") as f:
        csv.writer(f).writerow(["stamp_us", "lon", "lat", "alt_ellipsoid_m"])
    cv2.imwrite(os.path.join(root, "map.png"), np.zeros((8, 8), np.uint8))
    with pytest.raises(ValueError, match="no rows"):
        treplay.load_dataset(root)


def test_summarize_equals_jax():
    rng = np.random.default_rng(2)
    frames = []
    for i in range(9):
        row = {"stamp_us": i, "valid": bool(i % 4), "inliers": 40 + i,
               "horiz_m": float(rng.uniform(0, 14)),
               "east_m": float(rng.normal(0, 3)),
               "north_m": float(rng.normal(0, 3)),
               "up_m": float(rng.normal(0, 6)),
               "alt_agl": float([100.0, 500.0, 900.0][i % 3])}
        if i > 1:
            row.update(fused_horiz_m=float(rng.uniform(0, 12)),
                       fused_up_m=float(rng.normal(0, 5)))
        frames.append(row)
    for report in ({"frames": frames}, {"frames": frames[:1]},
                   {"frames": [dict(f, valid=False) for f in frames]}):
        assert treplay.summarize(report) == jreplay.summarize(report)


def _jax_draws(monkeypatch):
    """The port's cached program drawing RANSAC samples as the JAX runner
    does for its n-th frame (``PRNGKey(n)``)."""
    build = truns.build_frame_to_geopose_cached

    def patched(config):
        fn, frames = build(config), itertools.count(1)

        def run(*args, **kw):
            key = jax.random.PRNGKey(next(frames))
            kw.pop("generator", None)
            kw["sample_idx"] = lambda mask, _: jax_ransac_sample(
                key, mask.cpu().numpy())
            return fn(*args, **kw)

        return run

    monkeypatch.setattr(truns, "build_frame_to_geopose_cached", patched)


def _harris_replay_matches_jax(root, monkeypatch):
    _jax_draws(monkeypatch)
    ours = treplay.replay(root, weights="harris_lg5", fused=True,
                          device="cpu")
    ref = jreplay.replay(root, weights="harris_lg5", fused=True)
    s_ours, s_ref = treplay.summarize(ours), jreplay.summarize(ref)
    assert {k: s_ours[k] for k in ("frames", "valid", "pass_10m",
                                   "fused_frames", "fused_pass_10m")} == {
        k: s_ref[k] for k in ("frames", "valid", "pass_10m", "fused_frames",
                              "fused_pass_10m")}
    assert s_ours["pass_10m"] == s_ours["frames"] == 4
    assert ours["weights"] == ref["weights"] == "harris_lg5"
    for a, b in zip(ours["frames"], ref["frames"]):
        assert set(a) == set(b) and a["stamp_us"] == b["stamp_us"]
        horiz = np.hypot(a["east_m"] - b["east_m"],
                         a["north_m"] - b["north_m"])
        assert horiz < 2.5 and abs(a["up_m"] - b["up_m"]) < 0.5, (a, b)
        assert abs(a["fused_horiz_m"] - b["fused_horiz_m"]) < 2.5
        assert abs(a["inliers"] - b["inliers"]) <= 0.1 * b["inliers"] + 1


def test_harris_replay_matches_jax(flight, monkeypatch):
    _harris_replay_matches_jax(flight, monkeypatch)


def test_harris_replay_matches_jax_on_jpeg(world, tmp_path, monkeypatch):
    """The same flight recorded as JPEG (cv2.imencode's bytes at 95): both
    packages read the same Y planes, so the gates are the PNG flight's
    (measured 0.28 m and 0.07 m at most, 0.17 m and 0.04 m on PNG)."""
    root = str(tmp_path)
    write_replay_dataset(world, root, frames=4, image_format="jpeg")
    with open(os.path.join(root, "map.png"), "rb") as f:
        assert f.read(2) == b"\xff\xd8"
    _equal_datasets(treplay.load_dataset(root), jreplay.load_dataset(root))
    _harris_replay_matches_jax(root, monkeypatch)


def test_classical_replay_both_packages(world, tmp_path):
    root = str(tmp_path)
    write_replay_dataset(world, root, frames=3)
    ours = treplay.replay(root, backend="classical", device="cpu")
    ref = jreplay.replay(root, backend="classical")
    for report, summarize in ((ours, treplay.summarize),
                              (ref, jreplay.summarize)):
        s = summarize(report)
        assert s["valid"] == s["pass_10m"] == 3, s
    for a, b in zip(ours["frames"], ref["frames"]):
        assert np.hypot(a["east_m"] - b["east_m"],
                        a["north_m"] - b["north_m"]) < 2.5
    with pytest.raises(ValueError, match="unsupported"):
        treplay.replay(root, backend="semidense", device="cpu")


def _store_as_camera(root):
    """Rewrite a dataset's frames as a camera stores them (pixels turned
    90 degrees, baseline JPEG, an Exif APP1 with Orientation 6) and its map
    as a 256-entry grey palette PNG."""
    from gisnav_tpu_torch.gis.jpeg import encode_jpeg
    from tests.torch_image_writers import (exif_tiff, with_exif_app1,
                                           write_png)

    for name in os.listdir(os.path.join(root, "frames")):
        path = os.path.join(root, "frames", name)
        upright = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        stored = np.ascontiguousarray(np.rot90(upright, 1))  # a 6 turns back
        with open(path, "wb") as f:
            f.write(with_exif_app1(encode_jpeg(stored), exif_tiff(6)))
    path = os.path.join(root, "map.png")
    ortho = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    with open(path, "wb") as f:
        f.write(write_png(ortho, 8, 3, palette=np.repeat(
            np.arange(256)[:, None], 3, axis=1)))
    return ortho


def test_harris_replay_matches_jax_on_camera_frames(world, tmp_path,
                                                    monkeypatch):
    root = str(tmp_path)
    write_replay_dataset(world, root, frames=4)
    ortho = _store_as_camera(root)
    ours, ref = treplay.load_dataset(root), jreplay.load_dataset(root)
    _equal_datasets(ours, ref)
    np.testing.assert_array_equal(ours["ortho"], ortho)
    for row in ours["poses"]:
        frame = treplay._read_gray8(row["frame_path"])
        assert frame.shape == (480, 640)
        np.testing.assert_array_equal(frame, cv2.imread(
            row["frame_path"], cv2.IMREAD_GRAYSCALE))
    _harris_replay_matches_jax(root, monkeypatch)
