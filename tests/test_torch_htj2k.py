"""HTJ2K (JPEG 2000 Part 15, ITU-T T.814) read as cv2 5.0 reads it
(OpenJPEG 2.5's HT block decoder), on the CPU.

- The committed set (``tests/data/torch_htj2k``, written by
  ``tools/make_torch_image_fixtures.py`` with
  ``tests/torch_image_writers.py`` ``htj2k_encode``) is whole, under 1.5
  MiB with its flight, holds cv2's digests, and the port decodes every file
  to them under both flags.
- Path 17's HTJ2K flight (``flight/``): the JPEG 2000 flight's map and
  frames as cv2 decodes them, re-coded as irreversible HT, and its DEM as
  reversible 16-bit HT; cv2's digests in ``flight.json``, the port's reads
  equal to them, ``load_dataset`` equal to the JAX package's.
- A seeded sweep of the writer (depths 8-16 and signed, 0-5 levels, both
  wavelets, RCT / ICT, tiles, precincts, code-blocks from 4x4 to 64x64,
  empty code-blocks, SigProp and MagRef, styles, CAP with and without
  CPF): each file decoded by the port as cv2 decodes it. cv2 is the
  oracle of the writer's tables, never the port's own decoder.
- Both packages' GIS nodes over a stub WMS serving HT maps and HT DEMs
  publish the same map and DEM tick by tick.
"""
import hashlib
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from urllib.parse import parse_qs, urlparse

import cv2
import numpy as np
import pytest

from gisnav_tpu import replay as jreplay
from gisnav_tpu_torch import replay as treplay
from gisnav_tpu_torch.gis.imgcodecs import decode_image, read_image
from gisnav_tpu_torch.gis.jpeg2000 import last_decode_timing
from gisnav_tpu_torch.utils.world_wms import World
from tests.test_torch_jpeg2000 import _assert_same
from tests.torch_image_writers import htj2k_encode, ht_vlc_rows

cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_SILENT)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "torch_htj2k")
FLIGHT_DIR = os.path.join(FIXTURES, "flight")
FIXTURE_LIMIT = 1536 * 1024  # the set with its flight
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
with open(os.path.join(FLIGHT_DIR, "flight.json")) as _f:
    FLIGHT = json.load(_f)


def _cv2_and_port(data: bytes, what: str):
    """The port's decodes equal cv2's under both flags."""
    buf = np.frombuffer(data, np.uint8)
    for flag in KEYS.values():
        _assert_same(cv2.imdecode(buf, flag), decode_image(data, flag),
                     f"{what} flag {flag}")


# -- the committed set -------------------------------------------------------

def test_htj2k_fixture_set_is_whole():
    assert sorted(os.listdir(FIXTURES)) == sorted(
        [*DIGESTS, "digests.json", "flight"])
    total = sum(os.path.getsize(os.path.join(d, n))
                for d, _, names in os.walk(FIXTURES) for n in names)
    assert total < FIXTURE_LIMIT, total
    # images and the variants cv2 gives None for
    kinds = {d["unchanged"] is None for d in DIGESTS.values()}
    assert kinds == {True, False}
    assert sorted(FLIGHT["ht_cv2"]) == sorted(
        ["map.png"] + [f"frames/{t}.png" for t in
                       range(1000000, 1000000 + 500000 * FLIGHT["frames"],
                             500000)])
    assert sorted(os.listdir(FLIGHT_DIR)) == sorted(
        ["camera.json", "flight.json", "frames", "map.json", "map.png",
         "poses.csv", FLIGHT["dem"]])


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_htj2k_fixture_digests_are_cv2s(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    assert hashlib.sha256(data).hexdigest() == DIGESTS[name]["file_sha256"]
    for key, flag in KEYS.items():
        assert _digest(cv2.imdecode(np.frombuffer(data, np.uint8), flag)) \
            == DIGESTS[name][key], key


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_htj2k_fixture_decodes_as_cv2(name):
    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as f:
        data = f.read()
    for key, flag in KEYS.items():
        assert _digest(decode_image(data, flag)) == DIGESTS[name][key], key
        assert _digest(read_image(path, flag)) == DIGESTS[name][key], key


# -- path 17's HTJ2K flight --------------------------------------------------

@pytest.mark.parametrize("name", sorted(FLIGHT["ht_cv2"]))
def test_htj2k_flight_files_decode_as_cv2(name):
    path = os.path.join(FLIGHT_DIR, name)
    want = FLIGHT["ht_cv2"][name]
    assert _digest(cv2.imread(path, cv2.IMREAD_GRAYSCALE)) == want
    assert _digest(read_image(path, cv2.IMREAD_GRAYSCALE)) == want
    # near the JPEG 2000 file it re-codes
    part1 = FLIGHT["part1_bytes"][name]
    assert abs(os.path.getsize(path) - part1) <= 0.1 * part1


def test_htj2k_flight_dem_is_the_jp2_flights():
    """The DEM, reversible 16-bit HT, decodes bit-equal to the JPEG 2000
    flight's (cv2's uint16 digest, the same in both manifests)."""
    path = os.path.join(FLIGHT_DIR, FLIGHT["dem"])
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert _digest(ref) == FLIGHT["dem_cv2"]
    with open(os.path.join(ROOT, "tests", "data", "torch_jp2", "flight",
                           "flight.json")) as f:
        assert json.load(f)["dem_cv2"] == FLIGHT["dem_cv2"]
    _assert_same(ref, read_image(path, cv2.IMREAD_UNCHANGED), "dem")


def test_htj2k_flight_loads_as_jax():
    ours, ref = treplay.load_dataset(FLIGHT_DIR), jreplay.load_dataset(
        FLIGHT_DIR)
    for key in ("ortho", "dem", "k"):
        _assert_same(ref[key], ours[key], key)
    assert ours["poses"] == ref["poses"]
    part1 = treplay.load_dataset(os.path.join(ROOT, "tests", "data",
                                              "torch_jp2", "flight"))
    np.testing.assert_array_equal(ours["dem"], part1["dem"])
    err = np.abs(ours["ortho"].astype(int) - part1["ortho"])
    assert err.mean() < 3.0, err.mean()


def test_decode_timing_reads_the_last_decode():
    """The native decoder's per-call timer: tier 1 and the wavelet inside
    the whole call, read after a decode."""
    with open(os.path.join(FLIGHT_DIR, "frames", "1000000.png"), "rb") as f:
        data = f.read()
    decode_image(data, cv2.IMREAD_GRAYSCALE)
    t = last_decode_timing()
    assert t["total"] > 0 and t["tier1"] > 0 and t["wavelet"] > 0
    assert t["tier1"] + t["wavelet"] <= t["total"]


def test_vlc_tables_are_prefix_codes():
    """Each context of both CxtVLC tables is a complete prefix code whose
    codewords decode to distinct quads (T.814 Annex C)."""
    for first in (True, False):
        rows = ht_vlc_rows(first)
        for c in range(8):
            mine = [r for r in rows if r[0] == c]
            assert sum(2.0 ** -r[6] for r in mine) == 1.0
            codes = [(r[5], r[6]) for r in mine]
            for i, (a, la) in enumerate(codes):
                for b, lb in codes[i + 1:]:
                    n = min(la, lb)
                    assert (a ^ b) & ((1 << n) - 1), (first, c, a, b)


# -- the writer's sweep --------------------------------------------------------

def _case(seed: int) -> tuple:
    """A seeded image and writer options."""
    rng = np.random.default_rng([25, seed])
    world = World.make(seed=seed % 5, size_px=256, gsd_m=1.0)
    h, w = int(rng.integers(3, 90)), int(rng.integers(3, 90))
    y, x = int(rng.integers(0, 256 - h)), int(rng.integers(0, 256 - w))
    grey = world.raster[y:y + h, x:x + w]
    kind = seed % 6
    kw = {"levels": int(rng.integers(0, 6)),
          "reversible": bool(rng.integers(0, 2)),
          "step": float(2.0 ** rng.uniform(-1, 4)),
          "cblk": (int(2 ** rng.integers(2, 7)), int(2 ** rng.integers(2, 7))),
          "passes": int(rng.integers(1, 4)),
          "cap": bool(rng.integers(0, 4)), "cpf": bool(rng.integers(0, 2))}
    if kw["cblk"][0] * kw["cblk"][1] > 4096:
        kw["cblk"] = (kw["cblk"][0], 4096 // kw["cblk"][0])
    if kw["passes"] > 1:
        kw["drop"] = int(rng.integers(0, 3))
    if rng.integers(0, 3) == 0:
        kw["style"] = int(rng.choice([0x08, 0x3f, 0x04, 0x01]))
    if rng.integers(0, 3) == 0:
        kw["tile"] = (int(rng.integers(8, 64)), int(rng.integers(8, 64)))
    if rng.integers(0, 3) == 0:
        kw["precincts"] = [(int(rng.integers(2 if r else 1, 8)),
                            int(rng.integers(2 if r else 1, 8)))
                           for r in range(kw["levels"] + 1)]
    if rng.integers(0, 4) == 0:
        kw["empty_included"] = True
    if kind == 0:
        img = grey
    elif kind == 1:  # three components, RCT / ICT
        img = np.stack([grey, np.roll(grey, 3, 0), np.roll(grey, 5, 1)], -1)
    elif kind == 2:  # 9-16 bits
        prec = int(rng.integers(9, 17))
        img = ((grey.astype(np.uint32) << (prec - 8))
               | rng.integers(0, 1 << (prec - 8), grey.shape)).astype(
            np.uint16)
        kw["prec"] = prec
        kw["step"] *= 1 << (prec - 8)
    elif kind == 3:  # signed
        img = grey.astype(np.int16) - 128
        kw["prec"] = 8
    elif kind == 4:  # flat with a patch: empty code-blocks
        img = np.full_like(grey, 77)
        img[h // 3:h // 2, w // 4:w // 2] = grey[h // 3:h // 2, w // 4:w // 2]
    else:  # four components, no MCT
        img = np.stack([grey, grey[::-1], grey[:, ::-1], 255 - grey], -1)
        kw["mct"] = False
    return np.ascontiguousarray(img), kw


@pytest.mark.parametrize("seed", range(48))
def test_writer_sweep_decodes_as_cv2(seed):
    img, kw = _case(seed)
    data = htj2k_encode(img, **kw)
    _cv2_and_port(data, f"seed {seed} {kw}")


@pytest.mark.parametrize("kind", ["rev", "irr", "refine", "rgb"])
def test_writer_reversible_round_trip_through_cv2(kind):
    """The writer's files as cv2 reads them: the reversible ones give the
    pixels back, the others lie near them (what the tables must give)."""
    world = World.make(seed=3, size_px=256, gsd_m=1.0)
    g = np.ascontiguousarray(world.raster[17:117, 30:151])
    img = np.stack([g, g[::-1], g[:, ::-1]], -1) if kind == "rgb" else g
    kw = {"rev": {}, "rgb": {}, "irr": {"reversible": False, "step": 2.0},
          "refine": {"passes": 3, "drop": 1}}[kind]
    data = htj2k_encode(img, **kw)
    got = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    want = img[..., ::-1] if img.ndim == 3 else img
    err = np.abs(got.astype(int) - want)
    if kind in ("rev", "rgb"):
        assert err.max() == 0
    else:
        assert err.mean() < 2.0, err.mean()
    _cv2_and_port(data, kind)


# -- both GIS nodes over a stub WMS serving HT ---------------------------------

class _HtWms(BaseHTTPRequestHandler):
    """GetMap: ``server.replies[(layer, index of the bbox)]``, HT
    bytes."""

    def log_message(self, *args):
        pass

    def do_GET(self):
        q = {k.lower(): v[0] for k, v in parse_qs(
            urlparse(self.path).query).items()}
        vals = sorted(float(v) for v in q.get("bbox", "").split(","))
        k = next(i for i, bb in enumerate(BBOXES)
                 if np.allclose(sorted(bb), vals))
        body = self.server.replies[q.get("layers", ""), k]
        self.send_response(200)
        self.send_header("content-type", "image/jp2")
        self.send_header("content-length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


BBOXES = [(24.0, 60.0, 24.01, 60.01), (24.05, 60.0, 24.06, 60.01),
          (24.1, 60.02, 24.11, 60.03)]


@pytest.fixture(scope="module")
def ht_wms():
    """A loopback WMS answering each bbox's imagery with an irreversible
    HT map and its DEM with reversible 16-bit HT."""
    world = World.make(seed=7, size_px=512, gsd_m=1.36)
    server = HTTPServer(("127.0.0.1", 0), _HtWms)
    server.replies = {}
    for k, bb in enumerate(BBOXES):
        key = k
        grey = np.ascontiguousarray(world.raster[40 * k:40 * k + 96,
                                                 60 * k:60 * k + 96])
        dem = (grey.astype(np.uint16) * 37 + 1000).astype(np.uint16)
        server.replies["imagery", key] = htj2k_encode(
            grey, reversible=False, step=2.0 + k, jp2=k == 1)
        server.replies["dem", key] = htj2k_encode(dem, levels=3,
                                                  passes=1 + k % 2 * 2)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}/wms", server
    server.shutdown()
    server.server_close()
    thread.join(timeout=5)


def _ticks(pkg: str, url: str) -> list:
    """The GIS node of one package asking for ``image/jp2`` over the three
    bboxes: what it publishes at each tick."""
    if pkg == "jax":
        from gisnav_tpu.geometry.bbox import BBox
        from gisnav_tpu.nodes.bus import LocalBus
        from gisnav_tpu.nodes.gis_node import TOPIC_ORTHOIMAGE, GISNode
    else:
        from gisnav_tpu_torch.geometry.bbox import BBox
        from gisnav_tpu_torch.nodes.bus import LocalBus
        from gisnav_tpu_torch.nodes.gis_node import TOPIC_ORTHOIMAGE, GISNode
    bus = LocalBus()
    got = []
    bus.subscribe(TOPIC_ORTHOIMAGE, got.append)
    node = GISNode(bus, params={"wms_url": url, "wms_format": "image/jp2",
                                "wms_layers": ["imagery"],
                                "wms_dem_layers": ["dem"]})
    node._camera_info_cb({"width": 64, "height": 48})
    out = []
    for k, bb in enumerate(BBOXES):
        node._bbox_cb({"stamp_us": 1_000_000 * (k + 1), "bbox": BBox(*bb)})
        node.tick()
        out.append((got[-1]["image"], got[-1]["dem"]) if got else None)
    return out


def test_gis_nodes_publish_the_same_ht_maps(ht_wms):
    url, server = ht_wms
    ours, ref = _ticks("torch", url), _ticks("jax", url)
    assert len(ours) == len(ref) == len(BBOXES)
    for k, (a, b) in enumerate(zip(ours, ref)):
        assert a is not None and b is not None, k
        _assert_same(b[0], a[0], f"tick {k} map")
        _assert_same(b[1], a[1], f"tick {k} dem")
        assert a[1].dtype == np.float32 and a[1].max() > 0
