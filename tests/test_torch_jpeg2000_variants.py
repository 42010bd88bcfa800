"""The port's JPEG 2000 decoder against OpenCV's on the variants Pillow
does not write, on the CPU: OpenJPEG's own encoder (Pillow's bundled
``libopenjp2`` through ``tests/torch_image_writers.py``), JP2 boxes written
around codestreams, and codestreams with patched headers.

- OpenJPEG's encoder: every code-block style (bypass, reset, termall,
  vertically causal, predictable termination, segmentation symbols, all 64
  combinations, reversible with three layers and irreversible), tile-parts
  by resolution, layer and component, SOP and EPH markers, an ROI (RGN
  maxshift), POC progression changes, precincts under each progression,
  precisions 9-16 bits, 1 and 3 components, sub-sampled components and
  image offsets (cv2: None), each colour space in a JP2 file.
- JP2 boxes: ``colr`` enumerated 16, 17, 18, 12, 24, 14 and unknown, ICC,
  repeated and malformed; ``pclr`` / ``cmap`` palettes (8, 5 and 16 bits,
  4 channels, signed, index clamping, direct use, OpenJPEG's "weird cmap"
  repair) and their errors; ``cdef`` channel swaps, alpha and errors;
  ``bpcc``, ``ihdr`` placement and size, XLBox and length-0 boxes,
  misplaced and unknown boxes, boxes out of order.
- Patched codestreams: ``SIZ`` precisions 4-16 bits on a reversible
  16-bit file (Sentinel-2's 15, DEMs' 12), ``COD`` code-block style bits on
  data coded without them, its progression order and MCT; RGN, COM, TLM
  and unknown markers added; a POC that leaves the top resolutions out
  (OpenJPEG then stops the wavelet, colour transform and level shift at
  the highest resolution decoded); COD, COC, QCD, QCC, RGN, POC, PLT and
  COM in a tile-part header; packet headers packed into PPT and PPM
  markers (``j2k_with_ppt`` / ``j2k_with_ppm``) and malformed ones.
  HTJ2K has its own file, ``tests/test_torch_htj2k.py``.

Every case equals cv2 bit for bit under both flags (None where cv2 gives
None).
"""
import struct

import cv2
import numpy as np
import pytest

from gisnav_tpu_torch.gis.imgcodecs import decode_image
from tests.test_torch_jpeg2000 import _assert_same, _check, _pil, _scene
from tests.torch_image_writers import (JP2_FTYP_BOX, JP2_SIGNATURE_BOX,
                                       j2k_codestream, j2k_insert,
                                       j2k_marker, j2k_patch_cod,
                                       j2k_patch_precision, j2k_segment,
                                       j2k_with_ppm, j2k_with_ppt, jp2_box,
                                       jp2_cdef, jp2_cmap, jp2_colr,
                                       jp2_ihdr, jp2_pclr, jp2_wrap,
                                       openjpeg_encode)

cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_SILENT)


def _samples(name: str, h: int, w: int, c: int, prec: int = 8):
    rng = np.random.default_rng(sum(map(ord, name)))
    base = np.add.outer(np.arange(h) * 7, np.arange(w) * 5)
    img = np.stack([(base * (k + 1) + rng.integers(0, 1 << max(prec - 3, 1),
                                                    (h, w))) % (1 << prec)
                    for k in range(c)], axis=-1)
    return img[..., 0] if c == 1 else img


# -- OpenJPEG's encoder --------------------------------------------------------

ENCODER = {}
for _mode in range(64):
    ENCODER[f"style{_mode}_layers"] = dict(mode=_mode, rates=(30, 8, 0))
    ENCODER[f"style{_mode}_irreversible"] = dict(mode=_mode,
                                                 irreversible=True,
                                                 rates=(12,))
for _tp in "RLC":
    ENCODER[f"tileparts_{_tp}"] = dict(tile_parts=_tp, rates=(20, 5, 0))
    ENCODER[f"tileparts_{_tp}_tiles_rpcl"] = dict(
        tile_parts=_tp, tiles=(24, 20), numres=4, rates=(20, 5, 0),
        progression="RPCL")
ENCODER.update({
    "sop": dict(sop=True),
    "eph": dict(eph=True),
    "sop_eph_tiles_layers": dict(sop=True, eph=True, rates=(40, 10, 0),
                                 tiles=(32, 32), numres=3),
    "roi1": dict(roi=(0, 1)),
    "roi5": dict(roi=(0, 5)),
    "roi12": dict(roi=(0, 12)),
    "roi_irreversible": dict(roi=(0, 7), irreversible=True, rates=(10,)),
    "poc_layers": dict(pocs=[(1, 0, 0, 1, 6, 3, "LRCP"),
                             (1, 0, 0, 3, 6, 3, "LRCP")], rates=(30, 10, 0)),
    "poc_rlcp_cprl": dict(pocs=[(1, 0, 0, 2, 3, 3, "RLCP"),
                                (1, 3, 0, 2, 6, 3, "CPRL")], rates=(30, 0)),
    "poc_rpcl_pcrl": dict(pocs=[(1, 0, 0, 1, 2, 3, "RPCL"),
                                (1, 0, 0, 1, 6, 3, "PCRL")], rates=(30, 0)),
    **{f"precincts_{p}": dict(precincts=[(5, 5), (4, 4), (4, 4), (3, 3)],
                              progression=p, rates=(25, 0))
       for p in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")},
    "subsampled": dict(subsampling=(2, 2)),
    "offset": dict(offset=(3, 5)),
    "tiles_origin0": dict(tiles=(20, 20, 0, 0), numres=3),
    **{f"prec{p}": dict(prec=p) for p in (9, 12, 15, 16)},
    "prec12_irreversible": dict(prec=12, irreversible=True, rates=(8,)),
    "signed": dict(sgnd=True),
    "cblk4x4": dict(cblk=(4, 4)),
    "cblk8x128": dict(cblk=(8, 128)),
    "cblk128x8": dict(cblk=(128, 8)),
    "res1": dict(numres=1),
    "res2_irreversible": dict(numres=2, irreversible=True),
    **{f"jp2_colour_space{c}": dict(jp2=True, colour_space=c)
       for c in (1, 2, 3)},
})


@pytest.mark.parametrize("comps", [1, 3])
@pytest.mark.parametrize("name", sorted(ENCODER))
def test_openjpeg_encoder(name, comps):
    kw = ENCODER[name]
    h, w = (64, 64) if comps == 3 else (37, 45)
    img = _samples(name, h, w, comps, kw.get("prec", 8))
    if kw.get("sgnd"):
        img = img - 128
    _check(openjpeg_encode(img, **kw))


# -- JP2 boxes -----------------------------------------------------------------

def _codestreams():
    grey = _samples("grey", 20, 26, 1)
    rgb = _samples("rgb", 20, 26, 3)
    return {"grey": openjpeg_encode(grey, numres=3),
            "index": openjpeg_encode(_samples("index", 20, 26, 1) % 12,
                                     numres=3),
            "index12": openjpeg_encode(_samples("index12", 20, 26, 1) % 12,
                                       numres=3, prec=12),
            "rgb": openjpeg_encode(rgb, numres=3),
            "rgba": openjpeg_encode(_samples("rgba", 20, 26, 4), numres=3),
            "two": openjpeg_encode(rgb[..., :2], numres=3),
            "rgb12": openjpeg_encode(_samples("rgb12", 20, 26, 3, 12),
                                     numres=3, prec=12)}


def _ihdr(nc: int, bpc: int = 7) -> bytes:
    return jp2_ihdr(20, 26, nc, bpc)


def _boxes() -> dict:
    cs = _codestreams()
    rng = np.random.default_rng(6)
    pal = rng.integers(0, 256, (10, 3))
    pal16 = rng.integers(0, 65536, (10, 3))
    pal4 = rng.integers(0, 256, (10, 4))
    maps3 = jp2_cmap([(0, 1, 0), (0, 1, 1), (0, 1, 2)])
    out = {}
    for e in (16, 17, 18, 12, 24, 14, 99, 0):
        for kind, nc, bpc in (("grey", 1, 7), ("rgb", 3, 7), ("rgba", 4, 7),
                              ("two", 2, 7), ("rgb12", 3, 11)):
            out[f"{kind}_colr{e}"] = jp2_wrap(cs[kind],
                                              [_ihdr(nc, bpc), jp2_colr(e)])
    rgb = cs["rgb"]
    out.update({
        "icc": jp2_wrap(rgb, [_ihdr(3), jp2_colr(icc=b"\0" * 40)]),
        "meth3_then_17": jp2_wrap(rgb, [_ihdr(3), jp2_box(
            b"colr", bytes([3, 0, 0]) + b"xxxx"), jp2_colr(17)]),
        "two_colr_17_16": jp2_wrap(rgb, [_ihdr(3), jp2_colr(17),
                                         jp2_colr(16)]),
        "no_colr": jp2_wrap(rgb, [_ihdr(3)]),
        "colr_short": jp2_wrap(rgb, [_ihdr(3), jp2_box(b"colr", b"\1\0")]),
        "colr_6": jp2_wrap(rgb, [_ihdr(3), jp2_box(b"colr",
                                                   b"\1\0\0\0\0\x10")]),
        "colr_long": jp2_wrap(rgb, [_ihdr(3), jp2_box(
            b"colr", b"\1\0\0\0\0\0\x11abc")]),
    })
    for sp in (16, 17):
        idx = cs["index"]
        out[f"pclr3_{sp}"] = jp2_wrap(idx, [_ihdr(1), jp2_colr(sp),
                                            jp2_pclr(pal, [8] * 3), maps3])
        out[f"pclr16_{sp}"] = jp2_wrap(idx, [_ihdr(1), jp2_colr(sp),
                                             jp2_pclr(pal16, [16] * 3),
                                             maps3])
        out[f"pclr4_{sp}"] = jp2_wrap(idx, [
            _ihdr(1), jp2_colr(sp), jp2_pclr(pal4, [8] * 4),
            jp2_cmap([(0, 1, i) for i in range(4)])])
        out[f"pclr_index12_{sp}"] = jp2_wrap(cs["index12"], [
            _ihdr(1, 11), jp2_colr(sp), jp2_pclr(pal, [8] * 3), maps3])
    idx = cs["index"]
    out.update({
        "pclr_5bit": jp2_wrap(idx, [_ihdr(1), jp2_colr(16),
                                    jp2_pclr(pal % 32, [5] * 3), maps3]),
        "pclr_signed": jp2_wrap(idx, [_ihdr(1), jp2_colr(16),
                                      jp2_pclr(pal, [8] * 3, [1, 0, 0]),
                                      maps3]),
        "pclr_without_cmap": jp2_wrap(idx, [_ihdr(1), jp2_colr(16),
                                            jp2_pclr(pal, [8] * 3)]),
        "cmap_without_pclr": jp2_wrap(idx, [_ihdr(1), jp2_colr(16),
                                            jp2_cmap([(0, 1, 0)])]),
        "cmap_before_pclr": jp2_wrap(idx, [_ihdr(1), jp2_colr(16), maps3,
                                           jp2_pclr(pal, [8] * 3)]),
        "cmap_bad_pcol": jp2_wrap(idx, [
            _ihdr(1), jp2_colr(16), jp2_pclr(pal, [8] * 3),
            jp2_cmap([(0, 1, 0), (0, 1, 2), (0, 1, 1)])]),
        "cmap_mixed": jp2_wrap(rgb, [
            _ihdr(3), jp2_colr(16), jp2_pclr(pal, [8] * 3),
            jp2_cmap([(0, 1, 0), (1, 0, 0), (2, 0, 0)])]),
        "cmap_direct": jp2_wrap(rgb, [
            _ihdr(3), jp2_colr(16), jp2_pclr(pal, [8] * 3),
            jp2_cmap([(0, 0, 0), (1, 0, 0), (2, 0, 0)])]),
        "cmap_weird": jp2_wrap(idx, [
            _ihdr(1), jp2_colr(16), jp2_pclr(pal, [8] * 3),
            jp2_cmap([(0, 0, 0), (0, 0, 0), (0, 0, 0)])]),
        "cmap_component_out_of_range": jp2_wrap(idx, [
            _ihdr(1), jp2_colr(16), jp2_pclr(pal, [8] * 3),
            jp2_cmap([(1, 1, 0), (0, 1, 1), (0, 1, 2)])]),
    })
    defs = {"swap": [(0, 0, 3), (1, 0, 2), (2, 0, 1)],
            "alpha": [(0, 0, 1), (1, 0, 2), (2, 0, 3), (3, 1, 0)],
            "premultiplied": [(0, 0, 1), (1, 0, 2), (2, 0, 3), (3, 2, 0)],
            "two_alpha": [(0, 0, 1), (1, 0, 2), (2, 1, 0), (3, 1, 0)],
            "incomplete": [(0, 0, 1), (1, 0, 2)],
            "channel_out_of_range": [(0, 0, 1), (1, 0, 2), (2, 0, 3),
                                     (4, 0, 4)],
            "association_out_of_range": [(0, 0, 1), (1, 0, 2), (2, 0, 9)],
            "unassociated": [(0, 0, 65535), (1, 0, 65535), (2, 0, 65535)],
            "alpha_first": [(0, 1, 0), (1, 0, 1), (2, 0, 2), (3, 0, 3)]}
    for name, d in defs.items():
        four = len(d) == 4 or name == "channel_out_of_range"
        out[f"cdef_{name}"] = jp2_wrap(cs["rgba"] if four else rgb, [
            _ihdr(4 if four else 3), jp2_colr(16), jp2_cdef(d)])
    colr = jp2_colr(16)
    body = _ihdr(3) + colr
    out.update({
        "cdef_empty": jp2_wrap(rgb, [_ihdr(3), colr,
                                     jp2_box(b"cdef", b"\0\0")]),
        "bpcc": jp2_wrap(rgb, [_ihdr(3, 255), jp2_box(b"bpcc", b"\7\7\7"),
                               colr]),
        "bpcc_short": jp2_wrap(rgb, [_ihdr(3, 255), jp2_box(b"bpcc",
                                                            b"\7\7"), colr]),
        "ihdr_last": jp2_wrap(rgb, [colr, _ihdr(3)]),
        "ihdr_missing": jp2_wrap(rgb, [colr]),
        "ihdr_twice": jp2_wrap(rgb, [_ihdr(3), jp2_ihdr(21, 26, 3, 7),
                                     colr]),
        "ihdr_bad_size": jp2_wrap(rgb, [jp2_box(b"ihdr", struct.pack(
            ">IIHBBB", 20, 26, 3, 7, 7, 0)), colr]),
        "ihdr_no_components": jp2_wrap(rgb, [jp2_ihdr(20, 26, 0, 7), colr]),
        "ihdr_other_height": jp2_wrap(rgb, [jp2_ihdr(21, 26, 3, 7), colr]),
        "ihdr_other_components": jp2_wrap(rgb, [jp2_ihdr(20, 26, 2, 7),
                                                colr]),
        "ihdr_compression3": jp2_wrap(rgb, [jp2_box(b"ihdr", struct.pack(
            ">IIHBBBB", 20, 26, 3, 7, 3, 0, 0)), colr]),
        "uuid_xml_res": jp2_wrap(rgb, [_ihdr(3), colr, jp2_box(
            b"res ", b"\0" * 10)], before=[jp2_box(b"uuid", b"x" * 16)],
            after=[jp2_box(b"xml ", b"<a/>")]),
        "colr_before_jp2h": jp2_wrap(rgb, [_ihdr(3)],
                                     before=[jp2_colr(17)]),
        "colr_after_jp2h": jp2_wrap(rgb, [_ihdr(3)], after=[jp2_colr(17)]),
        "cdef_after_jp2h": jp2_wrap(rgb, [_ihdr(3), colr], after=[
            jp2_cdef([(0, 0, 3), (1, 0, 2), (2, 0, 1)])]),
        "jp2c_length0": jp2_wrap(rgb, [_ihdr(3), colr], jp2c_length=0),
        "jp2c_xlbox": jp2_wrap(rgb, [_ihdr(3), colr], jp2c_length=1),
        "jp2c_length_short": jp2_wrap(rgb, [_ihdr(3), colr],
                                      jp2c_length=20),
        "box_after_jp2c": jp2_wrap(rgb, [_ihdr(3), colr])
        + jp2_box(b"xml ", b"<a/>"),
        "jp2h_xlbox": JP2_SIGNATURE_BOX + JP2_FTYP_BOX
        + jp2_box(b"jp2h", body, length=1) + jp2_box(b"jp2c", rgb),
        "jp2h_length0": JP2_SIGNATURE_BOX + JP2_FTYP_BOX
        + jp2_box(b"jp2h", body, length=0) + jp2_box(b"jp2c", rgb),
        "sub_box_xlbox": jp2_wrap(rgb, [_ihdr(3), jp2_box(
            b"colr", bytes([1, 0, 0]) + struct.pack(">I", 17), length=1)]),
        "sub_box_length0": jp2_wrap(rgb, [_ihdr(3), jp2_box(
            b"colr", bytes([1, 0, 0]) + struct.pack(">I", 17), length=0)]),
        "sub_box_too_long": jp2_wrap(rgb, [_ihdr(3), jp2_box(
            b"colr", bytes([1, 0, 0]) + struct.pack(">I", 17), length=99)]),
        "jp2c_before_jp2h": JP2_SIGNATURE_BOX + JP2_FTYP_BOX
        + jp2_box(b"jp2c", rgb) + jp2_box(b"jp2h", _ihdr(3)),
        "no_ftyp": JP2_SIGNATURE_BOX + jp2_box(b"jp2h", _ihdr(3))
        + jp2_box(b"jp2c", rgb),
        "ftyp_odd_size": JP2_SIGNATURE_BOX + jp2_box(
            b"ftyp", b"jp2 \0\0\0\0jp2") + jp2_box(b"jp2h", _ihdr(3))
        + jp2_box(b"jp2c", rgb),
        "ftyp_twice": JP2_SIGNATURE_BOX + JP2_FTYP_BOX + JP2_FTYP_BOX
        + jp2_box(b"jp2h", _ihdr(3)) + jp2_box(b"jp2c", rgb),
        "signature_twice": JP2_SIGNATURE_BOX + JP2_SIGNATURE_BOX
        + JP2_FTYP_BOX + jp2_box(b"jp2h", _ihdr(3)) + jp2_box(b"jp2c", rgb),
        "jp2h_twice": JP2_SIGNATURE_BOX + JP2_FTYP_BOX
        + jp2_box(b"jp2h", _ihdr(3) + jp2_colr(17))
        + jp2_box(b"jp2h", body) + jp2_box(b"jp2c", rgb),
        "unknown_box_in_jp2h": jp2_wrap(rgb, [_ihdr(3), jp2_box(
            b"abcd", b"xyz"), colr]),
    })
    return out


BOXES = _boxes()


@pytest.mark.parametrize("name", sorted(BOXES))
def test_jp2_boxes(name, tmp_path):
    _check(BOXES[name], tmp_path / "b.jp2")


def test_box_cases_read_images():
    """The box corpus is no corpus of failures: most of it decodes, in
    colour, grey, with alpha and at 16 bits."""
    shapes = set()
    for data in BOXES.values():
        img = decode_image(data)
        if img is not None:
            shapes.add((img.ndim, img.shape[-1] if img.ndim == 3 else 1,
                        str(img.dtype)))
    assert sum(decode_image(d) is not None for d in BOXES.values()) > 40
    assert {(2, 1, "uint8"), (3, 3, "uint8"), (3, 4, "uint8"),
            (3, 3, "uint16"), (2, 1, "uint16")} <= shapes


# -- patched codestreams ---------------------------------------------------------

def _i16() -> bytes:
    img = (_scene("i16", 33, 41, 1)[..., 0].astype(np.uint16) << 8) | \
        _scene("lo", 33, 41, 1)[..., 0]
    return j2k_codestream(_pil(img, "I;16", no_jp2=True))


@pytest.mark.parametrize("prec", [4, 7, 8, 9, 10, 12, 15, 16])
def test_siz_precision(prec):
    """A reversible 16-bit codestream read at ``prec`` bits (as a 12-bit
    DEM or Sentinel-2's 15-bit band is coded): uint16 as coded under
    IMREAD_UNCHANGED, shifted to 8 bits under IMREAD_GRAYSCALE; under 8
    bits cv2 gives None."""
    data = j2k_patch_precision(_i16(), prec)
    _check(data)
    if prec > 8:
        assert decode_image(data).dtype == np.uint16


@pytest.mark.parametrize("style", [1, 2, 4, 8, 16, 32, 0x15, 0x2a, 0x3f,
                                   0x80, 0xc0])
@pytest.mark.parametrize("irreversible", [False, True], ids=["rev", "irr"])
def test_cod_style_patched(style, irreversible):
    """COD's code-block style byte set on data coded without it: both
    decoders read the same bits the same wrong way (or give up alike); the
    HT mixed bit (0x80) fails as OpenJPEG fails."""
    img = _scene(f"style{style}", 40, 48, 3)
    data = _pil(img, "RGB", no_jp2=True,
                **({"irreversible": True} if irreversible else {}))
    _check(j2k_patch_cod(data, style=style))


@pytest.mark.parametrize("progression", range(6))
def test_cod_progression_patched(progression):
    img = _scene("prog", 40, 48, 3)
    data = _pil(img, "RGB", no_jp2=True, quality_mode="rates",
                quality_layers=[20, 5], num_resolutions=3)
    _check(j2k_patch_cod(data, progression=progression))


@pytest.mark.parametrize("mct", [0, 1, 2])
def test_cod_mct_patched(mct):
    for img in (_scene("mct", 24, 30, 3), _scene("mct1", 24, 30, 1)[..., 0]):
        data = _pil(img, "RGB" if img.ndim == 3 else "L", no_jp2=True)
        _check(j2k_patch_cod(data, mct=mct))


def test_rgn_and_com_inserted():
    """An RGN marker added to a codestream coded without an ROI (cv2's
    output on such bytes is deterministic), and COM / TLM / unknown
    markers in the main header."""
    data = _pil(_scene("rgn", 30, 36, 1)[..., 0], "L", no_jp2=True)
    for seg in (j2k_segment(0xff5e, bytes([0, 0, 3])),
                j2k_segment(0xff5e, bytes([0, 0, 40])),
                j2k_segment(0xff64, b"\0\1hello"),
                j2k_segment(0xff55, bytes([0, 0x40]) + b"\0" * 4),
                j2k_segment(0xff6f, b"\0\0")):
        _check(j2k_insert(data, seg))


PACKED = {f"{kind}_{name}_{m}": (kind, kw, m)
          for kind in ("ppt", "ppm") for m in (1, 3)
          for name, kw in {
              "layers": dict(rates=(30, 8, 0)),
              "lossless": {},
              "rlcp": dict(progression="RLCP", rates=(20, 0)),
              "irreversible": dict(irreversible=True, rates=(10,)),
              "tiles": dict(tiles=(16, 16), numres=3),
              "tiles_layers": dict(tiles=(20, 24), numres=3,
                                   rates=(20, 5, 0)),
              "tiles_odd_rlcp": dict(tiles=(17, 19), numres=2,
                                     progression="RLCP")}.items()}


@pytest.mark.parametrize("comps", [1, 3])
@pytest.mark.parametrize("name", sorted(PACKED))
def test_packed_packet_headers(name, comps):
    """The packet headers moved out of the packets into PPT markers (each
    tile-part's header) or PPM markers (the main header, one Nppm run a
    tile-part, read on across tiles), one or three markers of them (cut
    inside an Nppm field: None, as cv2 gives)."""
    kind, kw, markers = PACKED[name]
    img = _samples(name, 37, 45, comps)
    cs = openjpeg_encode(img, **{"numres": 4, **kw})
    moved = (j2k_with_ppt if kind == "ppt" else j2k_with_ppm)(cs, markers)
    _check(moved)
    if decode_image(moved) is not None:
        _assert_same(decode_image(cs), decode_image(moved), name)


def test_packed_headers_malformed():
    """A repeated marker index, PPT under PPM, an Nppm running past the
    markers, too few bytes for an Nppm: None, as cv2 gives."""
    cs = openjpeg_encode(_samples("bad", 30, 36, 1), numres=3,
                         rates=(20, 0))
    ppm = j2k_with_ppm(cs, 2)
    at = ppm.index(b"\xff\x60")
    second = ppm.index(b"\xff\x60", at + 2)
    dup = bytearray(ppm)
    dup[second + 4] = 0
    long_n = bytearray(ppm)
    long_n[at + 5:at + 9] = struct.pack(">I", 10 ** 6)
    both = j2k_with_ppt(j2k_insert(cs, j2k_segment(0xff60,
                                                   b"\0\0\0\0\0")))
    short = j2k_insert(cs, j2k_segment(0xff60, b"\0\0\0"))
    for bad in (bytes(dup), bytes(long_n), both, short):
        _check(bad)
        assert decode_image(bad) is None


def test_marker_helpers():
    data = _pil(_scene("m", 20, 24, 1)[..., 0], "L", no_jp2=True)
    assert data[j2k_marker(data, 0xff51):][:2] == b"\xff\x51"
    assert data[j2k_marker(data, 0xff52):][:2] == b"\xff\x52"
    _assert_same(decode_image(data), decode_image(j2k_patch_cod(data)), "")


@pytest.mark.parametrize("res1", [1, 2, 4])
@pytest.mark.parametrize("kind", ["grey_rev", "grey_irr", "rgb_rev", "rgb_irr",
                                  "rgb_irr_tiles", "grey_rev_tiles"])
def test_poc_leaving_out_resolutions(kind, res1):
    """A POC whose resolutions stop short of the top: OpenJPEG decodes the
    packets it lists, runs the wavelet, colour transform and level shift
    only up to the highest resolution decoded, and hands over the tile
    buffer as it stands (one tile) or that resolution's area (tiles)."""
    img = _scene(kind, 40, 52, 3 if "rgb" in kind else 1)
    img = img if "rgb" in kind else img[..., 0]
    kw = {"no_jp2": True, "num_resolutions": 5}
    if "irr" in kind:
        kw["irreversible"] = True
    if "tiles" in kind:
        kw["tile_size"] = (32, 32)
        kw["num_resolutions"] = 4
    data = _pil(img, "RGB" if "rgb" in kind else "L", **kw)
    nc = 3 if "rgb" in kind else 1
    poc = j2k_segment(0xff5f, bytes([0, 0, 0, 1, res1, nc, 0]))
    _check(j2k_insert(data, poc))


def _in_first_tile_part(cs: bytes, segment: bytes) -> bytes:
    """``segment`` placed in the first tile-part's header (after SOT), its
    Psot grown to match."""
    sot = cs.index(b"\xff\x90\x00\x0a")
    psot = struct.unpack(">I", cs[sot + 6:sot + 10])[0]
    out = bytearray(cs[:sot + 12] + segment + cs[sot + 12:])
    out[sot + 6:sot + 10] = struct.pack(">I", psot + len(segment))
    return bytes(out)


def _tile_header_cases():
    img = _scene("tph", 36, 44, 3)
    cs = _pil(img, "RGB", no_jp2=True, quality_mode="rates",
              quality_layers=[20, 6], num_resolutions=4)
    cod_at = j2k_marker(cs, 0xff52)
    cod_len = struct.unpack(">H", cs[cod_at + 2:cod_at + 4])[0]
    cod = bytearray(cs[cod_at:cod_at + 2 + cod_len])
    qcd_at = j2k_marker(cs, 0xff5c)
    qcd = bytearray(cs[qcd_at:qcd_at + 2 + struct.unpack(
        ">H", cs[qcd_at + 2:qcd_at + 4])[0]])
    rlcp = bytearray(cod)
    rlcp[5] = 1
    styled = bytearray(cod)
    styled[12] = 0x08
    guard = bytearray(qcd)
    guard[4] = (guard[4] & 0x1f) | (3 << 5)
    coc = j2k_segment(0xff53, bytes([1, 0]) + bytes(cod[9:14]))
    qcc = j2k_segment(0xff5d, bytes([2]) + bytes(guard[4:]))
    return cs, {"cod_rlcp": bytes(rlcp), "cod_style": bytes(styled),
                "qcd_guard": bytes(guard), "coc": coc, "qcc": qcc,
                "rgn": j2k_segment(0xff5e, bytes([0, 0, 4])),
                "poc": j2k_segment(0xff5f, bytes([0, 0, 0, 2, 3, 3, 1])),
                "plt_com": j2k_segment(0xff58, b"\0\x05\x05")
                + j2k_segment(0xff64, b"\0\1x")}


_TPH_CS, _TPH = _tile_header_cases()


@pytest.mark.parametrize("name", sorted(_TPH))
def test_tile_part_header_markers(name):
    """COD, COC, QCD, QCC, RGN and POC in the first tile-part's header
    override the main header's for that tile (PLT and COM are skipped):
    the data, coded under the main header's, is read the same (wrong) way
    by both decoders."""
    _check(_in_first_tile_part(_TPH_CS, _TPH[name]))
