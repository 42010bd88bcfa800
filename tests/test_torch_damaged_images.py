"""Damaged and truncated images read as cv2 5.0 reads them.

The JAX package's WMS client and ``replay`` see only what ``cv2.imdecode``
/ ``cv2.imread`` give, so the port's decoders (``gis/imgcodecs.py``) must
give cv2's outcome on damaged bytes too: an equal array, None where cv2
gives None, and ``ValueError`` naming the limit where cv2 raises
``cv2.error`` (``loadsave.cpp``'s ``validateInputImageSize``).

- The seeded damage sweep (``tests/torch_image_writers.py``
  ``damage_ops``: cuts at 25-99 %, single-byte and 4-byte XOR flips, zeroed
  8-byte runs) under both flags, one case per committed fixture
  (``damage_fixtures``) and per file cv2 or Pillow writes here (PNG, LZW /
  deflate / PackBits / uncompressed TIFF, GIF), against cv2 in this
  process.
- The committed digests (``tests/data/torch_damaged/digests.json``, written
  by ``tools/make_torch_image_fixtures.py --damaged-out``) held without
  cv2, as ``chip_smoke.py`` path 21 holds them on the card machine.
- Both packages' ``GISNode`` over a stub WMS that damages its replies on
  a schedule (an IDAT flip: the previous map kept; a truncated DEM: a zero
  DEM; a corrupt LZW strip: cv2's partial DEM), tick by tick.
- Both packages' ``replay`` over a flight with a PNG frame whose IEND
  fails its CRC (libpng warns, cv2 reads it).
"""
import functools
import io
import json
import os
import struct
import threading
import zlib
from http.server import BaseHTTPRequestHandler, HTTPServer
from urllib.parse import parse_qs, urlparse

import cv2
import numpy as np
import pytest

from gisnav_tpu_torch import replay as treplay
from gisnav_tpu_torch.gis.imgcodecs import decode_image, image_format
from gisnav_tpu_torch.gis.png import PNG_SIGNATURE
from gisnav_tpu_torch.utils.world_wms import World, write_replay_dataset
from tests.torch_image_writers import (damage_digest, damage_fixtures,
                                       damage_ops, gif_frame, idat_flipped,
                                       strip_corrupted, write_bmp,
                                       write_gif, write_tiff)

cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_SILENT)
DATA = os.path.join(os.path.dirname(__file__), "data")
FLAGS = (cv2.IMREAD_UNCHANGED, cv2.IMREAD_GRAYSCALE)
DIGESTS = os.path.join(DATA, "torch_damaged", "digests.json")


@functools.lru_cache(maxsize=None)
def _fixtures() -> dict:
    return damage_fixtures(DATA)


@functools.lru_cache(maxsize=None)
def _written() -> dict:
    """Seeded 120x160 files as cv2 writes them (PNG; LZW, deflate,
    PackBits and uncompressed TIFF) and as Pillow writes GIF."""
    from PIL import Image

    rng = np.random.default_rng(24)
    bgr = cv2.GaussianBlur(rng.integers(0, 256, (120, 160, 3), np.uint8),
                           (0, 0), 3)
    grey = np.ascontiguousarray(bgr[..., 0])
    out = {f"cv2_{name}.png": cv2.imencode(".png", img)[1].tobytes()
           for name, img in (("bgr", bgr), ("grey", grey),
                             ("bgra", np.dstack([bgr, grey])),
                             ("u16", grey.astype(np.uint16) * 257))}
    for comp, name in ((5, "lzw"), (8, "deflate"), (32773, "packbits"),
                       (1, "none")):
        for kind, img in (("bgr", bgr), ("grey", grey)):
            out[f"cv2_{name}_{kind}.tif"] = cv2.imencode(
                ".tif", img, [cv2.IMWRITE_TIFF_COMPRESSION, comp])[1] \
                .tobytes()
    for kind, img in (("grey", grey), ("rgb", bgr[..., ::-1])):
        f = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(img)).save(f, "GIF")
        out[f"pil_{kind}.gif"] = f.getvalue()
    return out


def _cv2(data: bytes, flag: int):
    try:
        return cv2.imdecode(np.frombuffer(data, np.uint8), flag)
    except cv2.error:
        return "raises"


def _port(data: bytes, flag: int):
    """decode_image's outcome; its size-limit ValueError is cv2's raise,
    any other exception fails the test."""
    try:
        return decode_image(data, flag)
    except ValueError as err:
        if "cv2.imdecode raises cv2.error" not in str(err):
            raise
        return "raises"


def _sweep(name: str, data: bytes) -> list:
    bad = []
    for op, damaged in damage_ops(name, data):
        for flag in FLAGS:
            want = damage_digest(_cv2(damaged, flag))
            got = damage_digest(_port(damaged, flag))
            if got != want:
                bad.append((op, flag, want, got))
    return bad


@pytest.mark.parametrize("name", sorted(_fixtures()))
def test_damaged_fixture_as_cv2(name):
    """Every seeded damage of a committed fixture, both flags: cv2's
    outcome (an equal array, None, or a raise on its size limits)."""
    assert _sweep(name, _fixtures()[name]) == []


@pytest.mark.parametrize("name", sorted(_written()))
def test_damaged_cv2_and_pillow_files_as_cv2(name):
    """The same on files cv2 and Pillow write, as GIS servers do: a
    damaged LZW or deflate TIFF strip keeps its rows up to the damage,
    zeros after (libtiff's RGBA reader); a PNG or GIF whose data fails
    gives None."""
    assert _sweep(name, _written()[name]) == []


def _digests() -> dict:
    with open(DIGESTS) as f:
        return json.load(f)


@pytest.mark.parametrize("sub", ["torch_images", "torch_webp", "torch_jp2",
                                 "torch_jpegx", "torch_tiffx",
                                 "torch_htj2k"])
def test_damaged_digests_without_cv2(sub):
    """The committed digests of every damaged fixture, held without cv2
    (as the card machine holds them): the seed and the fixtures remake the
    bytes, the port's decodes give the digests."""
    want = _digests()
    assert want["seed"] == 24 and want["flags"] == [-1, 0]
    names = [n for n in sorted(_fixtures()) if n.startswith(sub + "/")]
    assert names and all(n in want["files"] for n in names)
    bad = []
    for name in names:
        ops = dict(damage_ops(name, _fixtures()[name]))
        assert sorted(ops) == sorted(want["files"][name]), name
        for op, digests in want["files"][name].items():
            got = [damage_digest(_port(ops[op], f)) for f in (-1, 0)]
            if got != digests:
                bad.append((name, op, digests, got))
    assert bad == []


def test_digests_cover_every_outcome():
    """The committed sweep holds arrays, Nones and cv2's raises."""
    kinds = {("None" if d is None else d if d == "raises" else "array")
             for ops in _digests()["files"].values()
             for pair in ops.values() for d in pair}
    assert kinds == {"None", "raises", "array"}


def _oversized() -> dict:
    """Headers each format's decoder accepts, over cv2's limits: name ->
    (bytes, the limit cv2's error names)."""
    bmp = bytearray(write_bmp(np.zeros((4, 4, 3), np.uint8), 24))
    struct.pack_into("<i", bmp, 22, (1 << 20) + 1)
    gif = bytearray(write_gif((4, 5), [gif_frame(np.zeros((4, 5),
                                                          np.uint8))],
                              global_palette=[[0, 0, 0], [9, 9, 9]]))
    struct.pack_into("<HH", gif, 6, 40000, 30000)
    jpg = bytearray(cv2.imencode(".jpg", np.zeros((16, 16), np.uint8))[1]
                    .tobytes())
    struct.pack_into(">HH", jpg, jpg.index(b"\xff\xc0") + 5, 60000, 60000)
    tif = bytearray(write_tiff(np.zeros((4, 4), np.uint8)))
    tif_w = [e for e in _tiff_entries(bytes(tif)) if e[0] == 256][0]
    struct.pack_into("<I", tif, tif_w[1], (1 << 20) + 1)
    png = (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", 40000, 40000, 8, 0, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(b"\0" * 100)) + _chunk(b"IEND", b""))
    return {
        "bmp": (bytes(bmp), "CV_IO_MAX_IMAGE_HEIGHT"),
        "png": (png, "CV_IO_MAX_IMAGE_PIXELS"),
        "gif": (bytes(gif), "CV_IO_MAX_IMAGE_PIXELS"),
        "jpeg": (bytes(jpg), "CV_IO_MAX_IMAGE_PIXELS"),
        "tiff": (bytes(tif), "CV_IO_MAX_IMAGE_WIDTH"),
        "pgm": (b"P5\n2000000 1\n255\n" + b"\0" * 64,
                "CV_IO_MAX_IMAGE_WIDTH"),
        "pam": (b"P7\nWIDTH 40000\nHEIGHT 30000\nDEPTH 1\nMAXVAL 255\n"
                b"TUPLTYPE GRAYSCALE\nENDHDR\n" + b"\0" * 64,
                "CV_IO_MAX_IMAGE_PIXELS"),
        "pfm": (b"Pf\n40000 30000\n-1\n" + b"\0" * 64,
                "CV_IO_MAX_IMAGE_PIXELS"),
        "hdr": (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 30000 "
                b"+X 40000\n" + b"\0" * 64, "CV_IO_MAX_IMAGE_PIXELS"),
    }


def _tiff_entries(tiff: bytes) -> list:
    """(tag, the value's offset) of a little-endian TIFF's first IFD."""
    ifd = struct.unpack_from("<I", tiff, 4)[0]
    return [(struct.unpack_from("<H", tiff, ifd + 2 + 12 * i)[0],
             ifd + 10 + 12 * i)
            for i in range(struct.unpack_from("<H", tiff, ifd)[0])]


@pytest.mark.parametrize("fmt", ["bmp", "gif", "hdr", "jpeg", "pam", "pfm",
                                 "pgm", "png", "tiff"])
def test_size_limits_raise_naming_them(fmt):
    """A header each decoder accepts, over ``validateInputImageSize``'s
    limits (2^20 rows or columns, 2^30 pixels): cv2.error in cv2,
    ValueError naming the limit in the port, under both flags."""
    data, limit = _oversized()[fmt]
    for flag in FLAGS:
        with pytest.raises(cv2.error):
            cv2.imdecode(np.frombuffer(data, np.uint8), flag)
        with pytest.raises(ValueError, match=limit):
            decode_image(data, flag)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


@pytest.mark.parametrize("first", [b"IDAT", b"IEND", b"tEXt", b"PLTE"])
def test_png_chunk_before_ihdr_gives_none(first):
    """A well-formed chunk where IHDR should be first: OpenCV's readHeader
    and libpng both refuse it, so cv2 gives None under both flags."""
    bodies = {b"IDAT": zlib.compress(b"\0" * 7), b"IEND": b"",
              b"tEXt": b"k\0v", b"PLTE": b"\0" * 6}
    ihdr = _chunk(b"IHDR", struct.pack(">IIBBBBB", 2, 2, 8, 0, 0, 0, 0))
    data = (b"\x89PNG\r\n\x1a\n" + _chunk(first, bodies[first]) + ihdr
            + _chunk(b"IDAT", zlib.compress(b"\0" * 6)) + _chunk(b"IEND", b""))
    for flag in FLAGS:
        assert cv2.imdecode(np.frombuffer(data, np.uint8), flag) is None
        assert decode_image(data, flag) is None


@pytest.mark.parametrize("side", [64, 720])
def test_png_stream_end_near_a_read_boundary_as_cv2(side):
    """A zlib stream with data past the image (0 B to 20 KB of it), its end
    cut by 0-6 bytes, split into two IDATs near where the image's data
    ends: libpng inflates 8 KiB of a chunk at a time and checks the
    stream's end from where the image ended, so cv2's image or None
    depends on those places. At 720 px the stream spans over 32 such
    pieces."""
    rng = np.random.default_rng(side)
    img = rng.integers(0, 256, (side, side), np.uint8)
    rows = b"".join(b"\0" + r.tobytes() for r in img)
    ihdr = _chunk(b"IHDR", struct.pack(">IIBBBBB", side, side, 8, 0, 0, 0,
                                       0))
    bad = []
    for extra in (0, 16, 3000, 20000):
        c = zlib.compressobj(9)
        stream = c.compress(rows) + c.flush(zlib.Z_FULL_FLUSH)
        at = len(stream)  # the image's data ends here
        stream += c.compress(b"\0" * extra) + c.flush()
        for cut in (0, 1, 2, 4, 6, len(stream) - at):
            s = stream[:len(stream) - cut]
            for shift in (-9000, -8192, -100, -6, -3, -1, 0, 1, 2, 3, 6,
                          100, 8192):
                first = max(1, at + shift)
                data = (PNG_SIGNATURE + ihdr + _chunk(b"IDAT", s[:first])
                        + (_chunk(b"IDAT", s[first:]) if first < len(s)
                           else b"") + _chunk(b"IEND", b""))
                want = damage_digest(_cv2(data, cv2.IMREAD_UNCHANGED))
                got = damage_digest(_port(data, cv2.IMREAD_UNCHANGED))
                if got != want:
                    bad.append((extra, cut, shift, want, got))
    assert bad == []


# -- the GIS nodes over a damaging WMS ---------------------------------------

def lzw_dem(dem: np.ndarray) -> bytes:
    """The DEM as an LZW GeoTIFF of 8-row strips."""
    return write_tiff(dem, compression=5, rows_per_strip=8)


class _Damaging(BaseHTTPRequestHandler):
    """GetMap: imagery as PNG (every 4th reply with an IDAT byte flipped),
    the DEM as an LZW GeoTIFF (every 3rd reply cut in half, the 2nd with
    a corrupt strip). ``server.log``: (layer, reply number, damage)."""

    def log_message(self, *args):
        pass

    def do_GET(self):  # noqa: N802 (http.server's name)
        q = {k.lower(): v[0] for k, v in parse_qs(urlparse(self.path).query)
             .items()}
        s = self.server
        h, w = int(q["height"]), int(q["width"])
        left = float(q["bbox"].split(",")[0])
        if q["layers"] == "dem":
            s.dem_n += 1
            body = lzw_dem(np.full((h, w), 3 + s.dem_n % 5, np.uint8))
            damage = ("cut" if s.dem_n % 3 == 0 else
                      "lzw" if s.dem_n == 2 else "")
            if damage == "cut":
                body = body[:len(body) // 2]
            elif damage:
                body = strip_corrupted(body)
            ctype = "image/tiff"
            s.log.append(("dem", s.dem_n, damage))
        else:
            s.img_n += 1
            rng = np.random.default_rng(int(left * 1e4) % 2 ** 32)
            body = cv2.imencode(".png", rng.integers(0, 256, (h, w), np.uint8)
                                )[1].tobytes()
            damage = "idat" if s.img_n % 4 == 0 else ""
            if damage:
                body = idat_flipped(body)
            ctype = "image/png"
            s.log.append(("imagery", s.img_n, damage))
        self.send_response(200)
        self.send_header("content-type", ctype)
        self.send_header("content-length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def _server():
    server = HTTPServer(("127.0.0.1", 0), _Damaging)
    server.img_n = server.dem_n = 0
    server.log = []
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


def test_gis_nodes_over_a_damaging_wms_equal_jax():
    """Both packages' GIS nodes, each over its own damaging stub, tick by
    tick (the bbox moved a whole map each tick): the same maps and DEMs
    published on every tick; a damaged image keeps the previous map (no
    DEM asked), a cut DEM publishes zeros, the corrupt LZW strip cv2's
    partial DEM."""
    from gisnav_tpu.geometry.bbox import BBox as JBBox
    from gisnav_tpu.nodes.bus import LocalBus as JBus
    from gisnav_tpu.nodes.gis_node import (GISNode as JGISNode,
                                           TOPIC_ORTHOIMAGE as JTOPIC)
    from gisnav_tpu_torch.geometry.bbox import BBox
    from gisnav_tpu_torch.nodes.bus import LocalBus
    from gisnav_tpu_torch.nodes.gis_node import TOPIC_ORTHOIMAGE, GISNode

    runs = []
    for bus_cls, node_cls, topic, bbox_cls in (
            (LocalBus, GISNode, TOPIC_ORTHOIMAGE, BBox),
            (JBus, JGISNode, JTOPIC, JBBox)):
        server, thread = _server()
        try:
            bus, got = bus_cls(), []
            bus.subscribe(topic, got.append)
            node = node_cls(bus, params={
                "wms_url": f"http://127.0.0.1:{server.server_address[1]}"
                           "/wms", "wms_format": "image/png",
                "wms_layers": ["imagery"], "wms_dem_layers": ["dem"]})
            node._camera_info_cb({"width": 48, "height": 32})
            for tick in range(12):
                left = 24.0 + 0.02 * tick
                node._bbox_cb({"stamp_us": 1_000_000 * (tick + 1),
                               "bbox": bbox_cls(left, 60.0, left + 0.01,
                                                60.01)})
                node.tick()
            runs.append((got, list(server.log)))
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=5)
    (ours, log), (ref, ref_log) = runs
    assert log == ref_log
    assert len(ours) == len(ref) == 12  # a map on every tick
    for a, b in zip(ours, ref):
        assert a["stamp_us"] == b["stamp_us"]
        for key in ("image", "dem"):
            assert a[key].dtype == b[key].dtype and \
                a[key].shape == b[key].shape
            np.testing.assert_array_equal(a[key], b[key])
    # the schedule: the image replies 4, 8, 12 damaged keep the map, and
    # ask no DEM; the DEM replies 3, 6 cut (zeros), the 2nd partial
    kept = [i for i in range(1, 12) if ours[i]["stamp_us"]
            == ours[i - 1]["stamp_us"]]
    assert kept == [3, 7, 11]
    assert ("imagery", 4, "idat") in log and ("dem", 2, "lzw") in log
    dems = [m["dem"] for i, m in enumerate(ours) if i not in kept]
    assert len(dems) == 9 and not dems[2].any() and not dems[5].any()
    partial = dems[1]  # strip 1 (rows 8-15) zero after its damage
    assert partial[:8].all() and partial[16:].all()
    assert not partial[15].any() and partial[8].all()


# -- replay over a flight with an IEND-damaged frame ---------------------------

def test_replay_reads_an_iend_damaged_frame_as_jax(tmp_path, monkeypatch):
    """A PNG frame whose IEND fails its CRC (libpng warns; cv2, and so the
    JAX ``replay``, reads it): the port's replay reads it too (it refused
    the frame before) and replays as the JAX package does."""
    from tests.test_torch_replay import _harris_replay_matches_jax

    root = str(tmp_path)
    write_replay_dataset(World.make(seed=7, size_px=3072, gsd_m=1.36), root,
                         frames=4)
    frames = sorted(os.listdir(os.path.join(root, "frames")))
    path = os.path.join(root, "frames", frames[1])
    with open(path, "rb") as f:
        data = bytearray(f.read())
    data[-1] ^= 0x5A  # IEND's CRC
    with open(path, "wb") as f:
        f.write(bytes(data))
    assert image_format(bytes(data)) == "PNG"
    ref = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    assert ref is not None
    np.testing.assert_array_equal(treplay._read_gray8(path), ref)
    _harris_replay_matches_jax(root, monkeypatch)
