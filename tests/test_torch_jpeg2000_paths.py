"""JPEG 2000 on the port's paths, on the CPU: the committed fixtures and
path 17's flight, and the replay and WMS routes through both packages.

- The fixture set (``tests/data/torch_jp2``, written by
  ``tools/make_torch_image_fixtures.py``) is whole, under 1 MiB with its
  flight, holds cv2's digests, and the port decodes every file to them
  under both flags.
- The flight (``flight/``, ``chip_smoke.py``'s path 17) holds the PNG
  dataset's arrays by sha256, cv2's grey digest of each JPEG 2000 file and
  cv2's digest of its 16-bit DEM; ``load_dataset`` over it equals the JAX
  package's (map, frames, DEM as uint16 times ``dem_scale``).
- Both routes through both packages on the same bytes: the ``harris_lg5``
  replay over a JPEG 2000 dataset with a 16-bit DEM (the replay tests'
  gates), and ``request_orthoimage`` / ``get_map`` over a stub WMS that
  answers ``image/jp2``.
- ``chip_smoke.j2k_mosaic`` repeats the fixture tile into the 4096-px RGB
  image path 17 times, which cv2 reads as the port does.
"""
import hashlib
import io
import json
import os
import shutil

import cv2
import numpy as np
import pytest
from PIL import Image

from gisnav_tpu import replay as jreplay
from gisnav_tpu.gis import wms as jax_wms
from gisnav_tpu_torch import replay as treplay
from gisnav_tpu_torch.gis.imgcodecs import decode_image, read_image
from gisnav_tpu_torch.gis.wms import WMSClient, request_orthoimage
from gisnav_tpu_torch.utils.world_wms import World, write_replay_dataset
from tests.test_torch_jpeg2000 import _assert_same, _pil
from tests.test_torch_nodes import _serve

cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_SILENT)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "torch_jp2")
FIXTURE_LIMIT = 1024 * 1024  # the set with its flight
KEYS = {"unchanged": cv2.IMREAD_UNCHANGED,
        "grayscale": cv2.IMREAD_GRAYSCALE}


def _digest(img):
    if img is None:
        return None
    return {"shape": list(img.shape), "dtype": str(img.dtype),
            "sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes())
            .hexdigest()}


with open(os.path.join(FIXTURES, "digests.json")) as _f:
    DIGESTS = json.load(_f)
with open(os.path.join(FIXTURES, "flight", "flight.json")) as _f:
    FLIGHT = json.load(_f)


def test_jp2_fixture_set_is_whole():
    assert sorted(os.listdir(FIXTURES)) == sorted(
        [*DIGESTS, "digests.json", "flight"])
    total = sum(os.path.getsize(os.path.join(d, n))
                for d, _, names in os.walk(FIXTURES) for n in names)
    assert total < FIXTURE_LIMIT, total
    assert sorted(FLIGHT["png_sha256"]) == sorted(FLIGHT["jp2_cv2"])
    assert len(FLIGHT["png_sha256"]) == FLIGHT["frames"] + 1
    flight = os.path.join(FIXTURES, "flight")
    assert sorted(os.listdir(flight)) == sorted(
        ["camera.json", "flight.json", "frames", "map.json", "map.png",
         "poses.csv", FLIGHT["dem"]])
    # the set holds what its digests say: images, refusals and failures
    kinds = {json.dumps(d["unchanged"] is None) for d in DIGESTS.values()}
    assert kinds == {"true", "false"}


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_jp2_fixture_digests_are_cv2s(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    assert hashlib.sha256(data).hexdigest() == DIGESTS[name]["file_sha256"]
    for key, flag in KEYS.items():
        assert _digest(cv2.imdecode(np.frombuffer(data, np.uint8), flag)) \
            == DIGESTS[name][key], key


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_jp2_fixture_decodes_as_cv2(name):
    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as f:
        data = f.read()
    for key, flag in KEYS.items():
        assert _digest(decode_image(data, flag)) == DIGESTS[name][key], key
        assert _digest(read_image(path, flag)) == DIGESTS[name][key], key


@pytest.mark.parametrize("name", sorted(FLIGHT["jp2_cv2"]))
def test_flight_files_decode_as_cv2(name):
    path = os.path.join(FIXTURES, "flight", name)
    want = FLIGHT["jp2_cv2"][name]
    assert _digest(cv2.imread(path, cv2.IMREAD_GRAYSCALE)) == want
    assert _digest(read_image(path, cv2.IMREAD_GRAYSCALE)) == want


def test_flight_dem_is_cv2s_uint16():
    path = os.path.join(FIXTURES, "flight", FLIGHT["dem"])
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert _digest(ref) == FLIGHT["dem_cv2"]
    assert ref.dtype == np.uint16
    _assert_same(ref, read_image(path, cv2.IMREAD_UNCHANGED), "dem")


def test_flight_is_the_png_datasets(tmp_path):
    """The PNG dataset of the manifest's arguments holds the arrays whose
    sha256 the fixture tool recorded (what path 17 checks on the card
    machine), and the flight loads in both packages alike: map, frames and
    the 16-bit DEM times ``dem_scale``."""
    root = str(tmp_path)
    write_replay_dataset(World.make(**FLIGHT["world"]), root,
                         frames=FLIGHT["frames"], hw=tuple(FLIGHT["hw"]),
                         coverage=FLIGHT["coverage"])
    for name, want in FLIGHT["png_sha256"].items():
        assert _digest(read_image(os.path.join(root, name),
                                  cv2.IMREAD_UNCHANGED)) == want, name
    flight = os.path.join(FIXTURES, "flight")
    png, ours = treplay.load_dataset(root), treplay.load_dataset(flight)
    ref = jreplay.load_dataset(flight)
    for key in ("ortho", "dem", "k"):
        _assert_same(ref[key], ours[key], key)
    assert ours["poses"] == ref["poses"]
    assert [p["lon"] for p in png["poses"]] == [p["lon"] for p in
                                               ours["poses"]]
    err = np.abs(ours["ortho"].astype(int) - png["ortho"])
    assert err.mean() < 1.5, err.mean()  # 30:1
    raw = cv2.imread(os.path.join(flight, FLIGHT["dem"]),
                     cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(
        ours["dem"], raw.astype(np.float32) * np.float32(FLIGHT["dem_scale"]))
    for name in sorted(FLIGHT["jp2_cv2"])[1:]:
        frame = read_image(os.path.join(flight, name), cv2.IMREAD_GRAYSCALE)
        twin = read_image(os.path.join(root, name), cv2.IMREAD_UNCHANGED)
        assert np.abs(frame.astype(int) - twin).mean() < 1.5, name


# -- the replay and WMS routes through both packages -----------------------

@pytest.fixture(scope="module")
def world():
    return World.make(seed=7, size_px=3072, gsd_m=1.36)


def _as_jp2(src: str, dst: str, rate=None) -> None:
    """Copy replay dataset ``src`` to ``dst`` with its map and frames
    re-encoded as JPEG 2000 by Pillow under their layout names
    (irreversible at ``rate``:1, else reversible), and a reversible 16-bit
    DEM in decimetres named in ``map.json``."""
    shutil.copytree(src, dst)
    names = ["map.png"] + [os.path.join("frames", n) for n in
                           os.listdir(os.path.join(src, "frames"))]
    opts = {} if rate is None else {"irreversible": True,
                                    "quality_mode": "rates",
                                    "quality_layers": [rate]}
    for name in names:
        img = cv2.imread(os.path.join(src, name), cv2.IMREAD_UNCHANGED)
        with open(os.path.join(dst, name), "wb") as f:
            f.write(_pil(img, "L", **opts))
        if name == "map.png":
            h, w = img.shape
    y, x = np.mgrid[:h, :w]
    dem = np.round(2 + 2 * np.sin(x / 90.0) * np.cos(y / 70.0)).astype(
        np.uint16)
    with open(os.path.join(dst, "dem.jp2"), "wb") as f:
        f.write(_pil(dem, "I;16"))
    with open(os.path.join(dst, "map.json")) as f:
        meta = json.load(f)
    meta.update(dem="dem.jp2", dem_scale=0.1)
    with open(os.path.join(dst, "map.json"), "w") as f:
        json.dump(meta, f)


@pytest.mark.parametrize("rate", [None, 25], ids=["reversible", "rate25"])
def test_load_dataset_equals_jax(world, tmp_path, rate):
    png, jp2 = str(tmp_path / "png"), str(tmp_path / "jp2")
    write_replay_dataset(world, png, frames=3)
    _as_jp2(png, jp2, rate)
    ours, ref = treplay.load_dataset(jp2), jreplay.load_dataset(jp2)
    assert set(ours) == set(ref)
    for key in ("ortho", "dem", "k"):
        _assert_same(ref[key], ours[key], key)
    assert ours["poses"] == ref["poses"]
    assert ours["dem"].dtype == np.float32 and ours["dem"].max() > 0
    if rate is None:  # reversible: the PNG dataset's arrays
        _assert_same(treplay.load_dataset(png)["ortho"], ours["ortho"], "map")


def test_harris_replay_matches_jax_on_jp2(world, tmp_path, monkeypatch):
    """The replay tests' 4-frame flight recorded as irreversible JPEG 2000
    at 20:1 with a 16-bit DEM: both packages read the same pixels and
    heights, so the gates are the PNG flight's."""
    from tests.test_torch_replay import _harris_replay_matches_jax

    png, jp2 = str(tmp_path / "png"), str(tmp_path / "jp2")
    write_replay_dataset(world, png, frames=4)
    _as_jp2(png, jp2, 20)
    _harris_replay_matches_jax(jp2, monkeypatch)


def _pil_bytes(img: np.ndarray, **kw) -> bytes:
    f = io.BytesIO()
    Image.fromarray(img).save(f, "JPEG2000", **kw)
    return f.getvalue()


@pytest.mark.parametrize("kind", ["grey_irreversible", "rgb_reversible",
                                  "rgba_irreversible", "grey16_raw"])
def test_wms_jp2_reply_equals_jax(world, kind):
    """A GetMap answered as ``image/jp2`` (Pillow's bytes of a world crop):
    both packages' clients and ``request_orthoimage`` give equal rasters."""
    crop = np.ascontiguousarray(world.raster[500:596, 700:820])
    irr = {"irreversible": True, "quality_mode": "rates",
           "quality_layers": [15]}
    body = {"grey_irreversible": lambda: _pil_bytes(crop, **irr),
            "rgb_reversible": lambda: _pil_bytes(np.stack(
                [crop, crop[::-1], crop[:, ::-1]], axis=2)),
            "rgba_irreversible": lambda: _pil_bytes(np.stack(
                [crop, crop[::-1], crop, crop[:, ::-1]], axis=2), **irr),
            "grey16_raw": lambda: _pil(crop.astype(np.uint16) * 250, "I;16",
                                       no_jp2=True)}[kind]()
    server = _serve("image/jp2", body)
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/wms"
        ours, ref = WMSClient(url), jax_wms.WMSClient(url)
        bb = (24.0, 60.0, 24.01, 60.01)
        for grey in (False, True):
            _assert_same(ref.get_map(["x"], bb, (96, 120), grayscale=grey,
                                     format_="image/jp2"),
                         ours.get_map(["x"], bb, (96, 120), grayscale=grey,
                                      format_="image/jp2"),
                         f"get_map grey {grey}")
        got = request_orthoimage(ours, bb, (96, 120), ["x"], ["dem"],
                                 format_="image/jp2")
        want = jax_wms.request_orthoimage(ref, bb, (96, 120), ["x"], ["dem"],
                                          format_="image/jp2")
        for a, b in zip(got, want):
            _assert_same(b, a, "request_orthoimage")
    finally:
        server.shutdown()
        server.server_close()


def test_mosaic_is_an_image_cv2_reads():
    """Path 17's 4096x4096 RGB image (the fixture tile repeated 8 x 8) and
    a 3 x 2 one decode as cv2 decodes them, each tile the tile's pixels."""
    import chip_smoke

    with open(os.path.join(FIXTURES, chip_smoke.JP2_TILE), "rb") as f:
        tile = f.read()
    one = decode_image(tile)
    small = chip_smoke.j2k_mosaic(tile, 3, 2)
    got = decode_image(small)
    _assert_same(cv2.imdecode(np.frombuffer(small, np.uint8), -1), got, "3x2")
    np.testing.assert_array_equal(got[512:, 1024:], one)
    big = chip_smoke.j2k_mosaic(tile, 8, 8)
    got = decode_image(big)
    _assert_same(cv2.imdecode(np.frombuffer(big, np.uint8), -1), got, "8x8")
    assert got.shape == (4096, 4096, 3)
