"""The port's JPEG 2000 decoder against OpenCV's on cut and damaged files,
on the CPU: where OpenJPEG's strict decoder gives up, where it lets the
tiles read so far stand, and what it makes of a changed byte.

- Files cut at every byte (and read back from disk every seventh cut, where
  ``cv2.imread`` streams the file): a JP2 file, a tiled raw codestream,
  tile-parts by resolution, SOP and EPH markers (a missing EPH fails, a
  missing SOP is only warned about).
- Tiles' end-of-stream rules: each tile-part count (TNsot) known or 0, the
  tile-parts reordered, a codestream cut at the end of each tile-part and
  one or two bytes after it: two bytes after a tile OpenJPEG can decode let
  the tiles read so far stand; a stream that ends right after the last
  tile's first tile-part, their count unknown, reads as if EOC followed
  (the tiles read in several tile-parts dropped); several tile-parts of
  one tile make OpenJPEG look ahead once for one more (``TPsot ==
  TNsot``).
- Seeded byte changes in each file.

Every case equals cv2 (None where cv2 gives None) under both flags.
"""
import io
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from gisnav_tpu_torch.gis.imgcodecs import decode_image, read_image
from tests.test_torch_jpeg2000 import _assert_same
from tests.torch_image_writers import openjpeg_encode

cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_SILENT)
FLAGS = (cv2.IMREAD_UNCHANGED, cv2.IMREAD_GRAYSCALE)


def _same_as_cv2(data: bytes, what: str):
    buf = np.frombuffer(data, np.uint8)
    for flag in FLAGS:
        got = decode_image(data, flag)
        _assert_same(cv2.imdecode(buf, flag), got, f"{what} flag {flag}")


def _files() -> dict:
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (24, 30, 3)).astype(np.uint8)
    f = io.BytesIO()
    Image.fromarray(a).save(f, "JPEG2000")
    g = io.BytesIO()
    Image.fromarray(a).save(g, "JPEG2000", no_jp2=True, tile_size=(16, 16),
                            num_resolutions=3)
    return {"pil_jp2": f.getvalue(), "pil_j2k_tiles": g.getvalue(),
            "opj_tileparts": openjpeg_encode(a, tiles=(16, 16), numres=3,
                                             tile_parts="R", rates=(10, 0)),
            "opj_sop_eph": openjpeg_encode(a, sop=True, eph=True, numres=4,
                                           rates=(10, 2))}


FILES = _files()


@pytest.mark.parametrize("name", sorted(FILES))
def test_cut_at_every_byte(name, tmp_path):
    data = FILES[name]
    path = str(tmp_path / "cut.jp2")
    for cut in range(1, len(data)):
        part = data[:cut]
        _same_as_cv2(part, f"cut {cut}")
        if cut % 7 == 0:
            with open(path, "wb") as f:
                f.write(part)
            for flag in FLAGS:
                _assert_same(cv2.imread(path, flag), read_image(path, flag),
                             f"imread cut {cut} flag {flag}")


@pytest.mark.parametrize("name", sorted(FILES))
def test_changed_bytes(name):
    data = FILES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    for _ in range(300):
        bad = bytearray(data)
        at = int(rng.integers(0, len(data)))
        bad[at] = int(rng.integers(0, 256))
        _same_as_cv2(bytes(bad), f"byte {at}")


# -- the tiles' end-of-stream rules ---------------------------------------------

def _sots(data: bytes) -> list:
    out, at = [], 0
    while (at := data.find(b"\xff\x90\x00\x0a", at)) >= 0:
        out.append(at)
        at += 1
    return out


def _tnsot(data: bytes, value: int, which=None) -> bytes:
    out = bytearray(data)
    for k, at in enumerate(_sots(data)):
        if which is None or k in which:
            out[at + 11] = value
    return bytes(out)


def _ends(data: bytes) -> list:
    return [at + struct.unpack(">I", data[at + 6:at + 10])[0]
            for at in _sots(data)]


def _around_ends(data: bytes, what: str):
    for end in _ends(data):
        for extra in (0, 1, 2, 3, 12, 14):
            if end + extra <= len(data):
                _same_as_cv2(data[:end + extra], f"{what} end {end}+{extra}")


_GREY = np.random.default_rng(5).integers(0, 256, (24, 30)).astype(np.uint8)
TILED = {"one_tile": openjpeg_encode(_GREY, numres=3),
         "four_tiles": openjpeg_encode(_GREY, tiles=(16, 16), numres=3),
         "tile_parts": openjpeg_encode(_GREY, tiles=(16, 16), numres=3,
                                       tile_parts="R")}


@pytest.mark.parametrize("tnsot", [None, 0], ids=["tnsot_known", "tnsot0"])
@pytest.mark.parametrize("name", sorted(TILED))
def test_cut_around_tile_parts(name, tnsot):
    data = TILED[name] if tnsot is None else _tnsot(TILED[name], tnsot)
    _around_ends(data, name)


@pytest.mark.parametrize("order", [(3, 2, 1, 0), (0, 1, 3, 2), (1, 0, 2, 3)],
                         ids=str)
@pytest.mark.parametrize("tnsot", [1, 0])
def test_tiles_in_any_order(order, tnsot):
    data = TILED["four_tiles"]
    sots = _sots(data)
    eoc = len(data) - 2
    parts = [data[s:(sots[k + 1] if k + 1 < len(sots) else eoc)]
             for k, s in enumerate(sots)]
    stream = _tnsot(data[:sots[0]] + b"".join(parts[k] for k in order)
                    + b"\xff\xd9", tnsot)
    _same_as_cv2(stream, "whole")
    assert decode_image(stream) is not None
    _around_ends(stream, f"order {order}")


@pytest.mark.parametrize("tile", range(4))
def test_one_tile_of_unknown_count(tile):
    _around_ends(_tnsot(TILED["four_tiles"], 0, {tile}), f"tile {tile}")


def test_one_more_tile_part_than_declared():
    """TNsot one short on every tile-part of tile 0 (TPsot reaches TNsot):
    OpenJPEG counts one more tile-part once it has looked ahead."""
    data = TILED["tile_parts"]
    sots = _sots(data)
    bad = bytearray(data)
    for at in sots:
        if struct.unpack(">H", data[at + 4:at + 6])[0] == 0:
            bad[at + 11] = 2
    _same_as_cv2(bytes(bad), "TNsot short")
    _around_ends(bytes(bad), "TNsot short")
