#!/usr/bin/env python
"""Write the image fixtures the port's decoders are held to, with OpenCV's
digests of them.

The port reads images without OpenCV (``gisnav_tpu_torch/gis/jpeg.py``,
``gis/png.py``); these files are the variants users meet that its baseline
codec did not read, and ``digests.json`` holds what ``cv2.imdecode`` makes
of each under ``IMREAD_UNCHANGED`` and ``IMREAD_GRAYSCALE`` (the sha256 of
the pixels with their shape and dtype, or null where cv2 gives None) and
the sha256 of the file. ``tests/test_torch_png.py`` rebuilds the digests
with cv2 and fails on drift, the CPU tests hold the port's pixels to cv2's,
and ``chip_smoke.py``'s JPEG phase holds the card machine's build to the
digests. Needs OpenCV and Pillow (not on the card machine)::

    python tools/make_torch_image_fixtures.py [--out tests/data/torch_images]
        [--webp-out tests/data/torch_webp] [--jp2-out tests/data/torch_jp2]
        [--jpegx-out tests/data/torch_jpegx]
        [--tiffx-out tests/data/torch_tiffx]
        [--htj2k-out tests/data/torch_htj2k] [--htj2k-only]
        [--damaged-out tests/data/torch_damaged] [--damaged-only]

The damaged set (``--damaged-out``) holds no files: its ``digests.json``
has cv2's outcome of every seeded damage (``tests/torch_image_writers.py``
``damage_ops``: cuts, byte flips, zeroed runs) of every committed fixture
under 200 KB in the five sets, under both flags (the pixels' sha256 with
shape and dtype, null for None, "raises" where cv2 raises on its size
limits), so that the bytes are remade from the fixtures and the seed on a
machine without OpenCV (``chip_smoke.py`` path 21). ``--damaged-only``
rewrites it from the committed fixtures alone.

The WebP set (``--webp-out``, its own ``digests.json`` of the same form,
under 1 MiB with its flight) holds cv2's and Pillow's files of every kind
the port's decoder reads (VP8L, VP8 at qualities 1-100, ALPH raw and
compressed with each filter, a palette image, EXIF in VP8X, animations
with a frame at an offset) and ``flight/``: a replay dataset of
``utils/world_wms.py`` ``write_replay_dataset`` (path 8's world, 8 frames
at 1088x1920, the map at 1.3x the footprint) with the map and frames
written as WebP by cv2 at quality 90, and ``flight/flight.json`` holding
the call's arguments, the sha256 of the PNG dataset's arrays (so a machine
without cv2 can check its own PNG dataset is this one) and cv2's grey
digests of the WebP files.

The JPEG 2000 set (``--jp2-out``, its own ``digests.json``, under 1 MiB
with its flight) holds Pillow's files (grey, RGB, RGBA, YCbCr, 16-bit,
grey + alpha, signed; reversible and irreversible; layers, tiles,
progressions; a raw codestream), cv2's, OpenJPEG's encoder's through
``tests/torch_image_writers.py`` (every code-block style with SOP/EPH,
tile-parts with POC, an ROI, packet headers packed into PPT and, over
tiles, PPM markers), JP2 boxes written around codestreams (a
palette with its component map, channel definitions that swap colours),
codestreams with ``SIZ`` patched to 12 and 15 bits, a file cut before EOC,
the 512-px RGB tile ``chip_smoke.py`` repeats into a 4096-px image, and
``flight/``: path 8's world as for the WebP flight, the map and 8 frames
as irreversible grey JP2 at ``JP2_FLIGHT["rates"]`` (under the layout's
PNG names) and a reversible 16-bit DEM (``dem.jp2``, decimetres, named in
``map.json`` with ``dem_scale`` 0.1), with ``flight.json`` holding the PNG
dataset's array digests and cv2's digests of the JP2 files.

The lossless and arithmetic-coded JPEG set (``--jpegx-out``, its own
``digests.json``, 2.3 MB with its flight) holds libjpeg-turbo's
lossless files (``tests/torch_image_writers.py`` ``libjpeg_encode``:
every predictor, a point transform, a restart every two rows, grey, RGB
and CMYK, precisions 2-8), ``lossless_jpeg``'s subsampled RGB with a
restart and a scan a component, and arithmetic-coded transcodes of cv2's
files (``libjpeg_transcode``: sequential and progressive, DAC
conditioning, restarts, CMYK); and ``flight/``: path 8's world as for the
WebP flight, cv2's quality-90 files of the map and 8 frames transcoded to
arithmetic coding (the map progressive, the frames sequential) under the
layout's PNG names and the map's also sequential (``map_sequential.jpg``,
timed beside the progressive one), with ``flight.json`` holding the PNG
dataset's array
digests, cv2's grey digests of each file, and the lossless frame
``chip_smoke.py`` writes from the first frame's pixels with
``lossless_jpeg`` (its bytes' sha256 and cv2's digests of them).

The HTJ2K set (``--htj2k-out``, its own ``digests.json``, under 1.5 MiB
with its flight; ``--htj2k-only`` writes it alone, then the damaged
digests) holds HT codestreams of ``tests/torch_image_writers.py``
``htj2k_encode`` (each wavelet, depth and transform, SigProp and MagRef,
styles, tiles, precincts, code-block sizes, empty code-blocks, CAP and CPF,
and the variants cv2 gives None for) and ``flight/``: the JPEG 2000
flight's map and frames as cv2 decodes them, re-coded as irreversible HT
near the sizes of their JPEG 2000 files (under the same names), its DEM as
reversible 16-bit HT (``dem.jp2``, bit-equal), with ``flight.json``
holding the steps, sizes and cv2's digests (``ht_cv2``, ``dem_cv2``).

The TIFF variants set (``--tiffx-out``, its own ``digests.json``, under
1 MiB) holds Pillow's libtiff files (``tests/torch_image_writers.py``
``pillow_tiff``: CCITT RLE, RLEW, Group 3 1-D and 2-D, Group 4 with
``FillOrder`` 2 and MinIsWhite, ZSTD and LZMA DEMs and images), CCITT
1-D files of ``ccitt_1d`` (Group 3 without EOLs, tiled RLE), seeded
damage of a Group 4 and a Group 3 strip (a cut byte count), 10- to 14-bit
samples, the codecs and pairings cv2 gives None for or reads as zeros,
a predictor on uncompressed strips, 4x4 YCbCr strips of an odd width,
JPEG-in-TIFF with separate planes, BMP bitfields that are not whole
bytes; and the files of ``chip_smoke.py``'s path 19: the DEM layer its
stub WMS serves (``dem_u16_zstd_2208.tif``, a 2208-px uint16 ZSTD
GeoTIFF with predictor 2, cv2: None; and its float32 twin), and path
16's 2208-px map thresholded at its mean, as Group 4 and Group 3 2-D
(timed beside PNG of the same pixels).

Content is drawn from the port's seeded world (``utils/world_wms.py``):

- progressive JPEG (cv2), grey and colour at 4:2:0, 4:4:4 and 4:2:2, with
  and without a restart interval, at 217x301 and 45x61 (libjpeg always
  optimises a progressive file's tables: ``IMWRITE_JPEG_OPTIMIZE`` changes
  no byte of one); a grey progressive and a baseline file of the same
  pixels at 800 px (the smoke's decode timing); a progressive file cut
  inside a scan (cv2: None) and one cut after its third scan and closed
  with EOI (cv2 block-smooths its unknown coefficients);
- CMYK JPEG (Pillow's Adobe-inverted CMYK, 4:4:4 and progressive 4:2:0)
  and YCCK (the 4:4:4 file with its Adobe transform set to 2);
- JPEG with an Exif APP1, orientations 1-8 in both TIFF byte orders, a
  progressive one, and malformed ones (an XMP APP1 first, the orientation
  after a Make whose string lies past the end, an IFD that claims more
  entries than it holds, an orientation value cut short);
- PNG (``tests/torch_image_writers.py`` unless named): palette at depths
  1, 2, 4 and 8, with and without tRNS, a 256-entry grey palette, a
  Pillow-quantised palette; grey at depths 1, 2 and 4; grey + alpha at 8
  and 16 bits; RGB with a tRNS colour at 8 and 16 bits; Adam7 at several
  types and depths; gAMA and sRGB (libpng's gamma path under the grey
  flag); eXIf orientations;
- the other formats OpenCV reads (13x17 px each): TIFF (tiled LZW with
  predictor 2 in big-endian order, uint16 and int16 and float32 DEMs with
  predictors 2 and 3, BigTIFF with old-style LZW, planar PackBits RGB,
  unassociated RGBA, 16-bit RGB, a 4-bit palette, CMYK, 2x2 YCbCr,
  orientations 6 and 3 (tiled), 1-bit MinIsWhite in FillOrder 2, an
  uncompressed tile that is not whole KiB, Pillow's JPEG-in-TIFF), GIF (a
  transparent image smaller than its screen, interlace with a local table,
  cv2's), BMP (RLE8, RLE4, 5-6-5 bitfields, cv2's V5 BGRA, OS/2, top-down
  1-bit), PGM / PPM / PBM / PAM (ASCII with maxval 100, 16-bit, cv2's),
  PFM (both byte orders), Sun raster and Radiance HDR (RLE and flat).
"""
from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import struct
import sys

import cv2
import numpy as np
from PIL import Image

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

from gisnav_tpu_torch.utils.world_wms import World  # noqa: E402
from tests.torch_image_writers import (  # noqa: E402
    DAMAGE_SEED, bmp_rle_encode, chunk, damage_digest, damage_fixtures,
    damage_ops, exif_tiff, gif_frame, j2k_codestream,
    j2k_patch_precision, j2k_with_ppm, j2k_with_ppt, jp2_cdef, jp2_cmap,
    jp2_colr, jp2_ihdr, jp2_pclr, jp2_wrap, JCS_CMYK, JCS_RGB, libjpeg_encode,
    j2k_with_coc, libjpeg_transcode, lossless_jpeg, openjpeg_encode,
    thunder_encode, webp_anim, htj2k_encode,
    webp_anmf, webp_chunk, webp_chunks, webp_riff, webp_vp8x, with_exif_app1,
    write_bmp, write_gif, write_hdr, write_png, write_sun, write_tiff,
    ccitt_1d, pillow_tiff)

OUT = os.path.join(os.path.dirname(__file__), os.pardir, "tests", "data",
                   "torch_images")
WEBP_OUT = os.path.join(os.path.dirname(__file__), os.pardir, "tests",
                        "data", "torch_webp")
FLAGS = {"unchanged": cv2.IMREAD_UNCHANGED, "grayscale": cv2.IMREAD_GRAYSCALE}
SIZE_LIMIT = 512 * 1024
WEBP_SIZE_LIMIT = 1024 * 1024  # the WebP set and its flight
# the flight of chip_smoke.py's path 16 (write_replay_dataset's arguments)
FLIGHT = {"world": {"seed": 7, "size_px": 3072, "gsd_m": 1.36},
          "frames": 8, "hw": [1088, 1920], "coverage": 1.3, "quality": 90}
JP2_OUT = os.path.join(os.path.dirname(__file__), os.pardir, "tests",
                       "data", "torch_jp2")
JP2_SIZE_LIMIT = 1024 * 1024  # the JPEG 2000 set and its flight
# path 17's flight: path 16's, irreversible JPEG 2000 at these compression
# ratios (map, frames) and a reversible uint16 DEM in decimetres
JP2_FLIGHT = {"world": FLIGHT["world"], "frames": 8, "hw": [1088, 1920],
              "coverage": 1.3, "rates": [30, 25], "dem": "dem.jp2",
              "dem_scale": 0.1}


HTJ2K_OUT = os.path.join(os.path.dirname(__file__), os.pardir, "tests",
                         "data", "torch_htj2k")
HTJ2K_SIZE_LIMIT = 1536 * 1024  # the HTJ2K set and its flight
# path 17's HTJ2K flight: cv2's decodes of the JPEG 2000 flight's map and
# frames as irreversible HT (9/7, 5 levels) at a base step found for each
# file to land near its JPEG 2000 file's size, and cv2's uint16 of its DEM
# as reversible 16-bit HT
HTJ2K_FLIGHT = {"source": "torch_jp2/flight", "levels": 5, "dem": "dem.jp2",
                "size_within": 0.05}
JPEGX_OUT = os.path.join(os.path.dirname(__file__), os.pardir, "tests",
                         "data", "torch_jpegx")
JPEGX_SIZE_LIMIT = 2560 * 1024  # the lossless / arithmetic set, flight
# path 18's flight: path 16's, cv2's quality-90 files transcoded to
# arithmetic coding (and the map's also sequential, timed beside the
# progressive one); the lossless frame chip_smoke.py writes from the first
# frame's decoded pixels
TIFFX_OUT = os.path.join(os.path.dirname(__file__), os.pardir, "tests",
                         "data", "torch_tiffx")
TIFFX_SIZE_LIMIT = 1024 * 1024
DAMAGED_OUT = os.path.join(os.path.dirname(__file__), os.pardir, "tests",
                           "data", "torch_damaged")
JPEGX_FLIGHT = {"world": FLIGHT["world"], "frames": 8, "hw": [1088, 1920],
                "coverage": 1.3, "quality": 90,
                "map_sequential": "map_sequential.jpg",
                "lossless_from": "frames/1000000.png", "lossless_psv": 1}


def _sos_offsets(data: bytes):
    """Byte offsets of a JPEG's SOS markers."""
    out, i = [], 2
    while i + 4 <= len(data):
        if data[i] != 0xFF or data[i + 1] in (0x00, 0xFF) or (
                0xD0 <= data[i + 1] <= 0xD7):
            i += 1
            continue
        m = data[i + 1]
        if m == 0xD9:
            break
        if m == 0xDA:
            out.append(i)
        i += 2 + struct.unpack(">H", data[i + 2:i + 4])[0]
    return out


def _cv2_jpeg(img, *params) -> bytes:
    ok, buf = cv2.imencode(".jpg", img, list(params))
    assert ok
    return buf.tobytes()


def _pil_cmyk(cmyk: np.ndarray, **kw) -> bytes:
    bio = io.BytesIO()
    Image.fromarray(cmyk, "CMYK").save(bio, "JPEG", quality=90, **kw)
    return bio.getvalue()


def build() -> dict:
    """name -> file bytes."""
    world = World.make(seed=7, size_px=1024, gsd_m=1.36)
    r = world.raster

    def grey(h, w, y=0, x=0):
        return np.ascontiguousarray(r[y:y + h, x:x + w])

    def bgr(h, w):
        return np.ascontiguousarray(np.stack(
            [grey(h, w, 0, 0), grey(h, w, 100, 50), grey(h, w, 200, 300)],
            axis=2))

    files = {}
    P = (cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    S = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
         "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
         "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422}
    g, c = grey(217, 301), bgr(217, 301)
    files["prog_grey_217x301.jpg"] = _cv2_jpeg(g, *P)
    files["prog_grey_217x301_rst_opt.jpg"] = _cv2_jpeg(
        g, *P, cv2.IMWRITE_JPEG_RST_INTERVAL, 5,
        cv2.IMWRITE_JPEG_OPTIMIZE, 1)
    for sub in ("420", "444"):
        sf = (cv2.IMWRITE_JPEG_SAMPLING_FACTOR, S[sub])
        files[f"prog_bgr{sub}_217x301.jpg"] = _cv2_jpeg(c, *P, *sf)
        files[f"prog_bgr{sub}_217x301_rst.jpg"] = _cv2_jpeg(
            c, *P, *sf, cv2.IMWRITE_JPEG_RST_INTERVAL, 3)
    files["prog_bgr422_45x61_rst_opt.jpg"] = _cv2_jpeg(
        bgr(45, 61), *P, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, S["422"],
        cv2.IMWRITE_JPEG_RST_INTERVAL, 2, cv2.IMWRITE_JPEG_OPTIMIZE, 1,
        cv2.IMWRITE_JPEG_QUALITY, 80)
    big = grey(800, 800, 100, 100)
    files["prog_grey_800.jpg"] = _cv2_jpeg(big, *P,
                                           cv2.IMWRITE_JPEG_QUALITY, 60)
    files["base_grey_800.jpg"] = _cv2_jpeg(big, cv2.IMWRITE_JPEG_QUALITY, 60)
    whole = files["prog_grey_217x301.jpg"]
    sos = _sos_offsets(whole)
    files["prog_grey_cut.jpg"] = whole[:(sos[3] + sos[4]) // 2]
    files["prog_grey_cut_eoi.jpg"] = whole[:sos[3]] + b"\xff\xd9"

    rng = np.random.default_rng(3)
    cmyk = np.clip(np.stack([grey(61, 83, 0, 0), grey(61, 83, 40, 90),
                             grey(61, 83, 300, 10),
                             rng.integers(0, 120, (61, 83))], axis=2), 0,
                   255).astype(np.uint8)
    files["cmyk_444.jpg"] = _pil_cmyk(cmyk, subsampling=0)
    files["cmyk_420_prog.jpg"] = _pil_cmyk(cmyk, subsampling=2,
                                           progressive=True)
    ycck = bytearray(files["cmyk_444.jpg"])
    at = ycck.find(b"Adobe")
    assert at > 0
    ycck[at + 11] = 2  # the Adobe transform: YCCK
    files["ycck_444.jpg"] = bytes(ycck)

    eg, ec = _cv2_jpeg(grey(48, 64, 500, 500)), _cv2_jpeg(bgr(48, 64))
    for o in range(1, 9):
        files[f"exif_o{o}_mm.jpg"] = with_exif_app1(eg, exif_tiff(o, b"MM"))
        files[f"exif_o{o}_ii.jpg"] = with_exif_app1(ec, exif_tiff(o, b"II"))
    files["exif_o6_prog.jpg"] = with_exif_app1(
        _cv2_jpeg(bgr(48, 64), *P), exif_tiff(6))
    xmp = b"http://ns.adobe.com/xap/1.0/\0<x:xmpmeta/>"
    files["exif_o6_xmp_first.jpg"] = _xmp_first(eg, xmp)
    e = ">"
    make_past_end = (b"MM" + struct.pack(e + "HI", 42, 8)
                     + struct.pack(e + "H", 2)
                     + struct.pack(e + "HHII", 0x010F, 2, 100, 5000)
                     + struct.pack(e + "HHIH", 0x0112, 3, 1, 6) + b"\0\0"
                     + struct.pack(e + "I", 0))
    files["exif_o6_after_bad_make.jpg"] = with_exif_app1(eg, make_past_end)
    claims_more = exif_tiff(6)[:-4]
    claims_more = claims_more[:8] + struct.pack(e + "H", 5) + claims_more[10:]
    files["exif_o6_short_ifd.jpg"] = with_exif_app1(eg, claims_more)
    files["exif_o6_cut_value.jpg"] = with_exif_app1(eg, exif_tiff(6)[:-7])

    h, w = 37, 53
    pal_img = grey(h, w, 10, 700)
    for depth in (1, 2, 4, 8):
        n = min(1 << depth, 200)
        palette = rng.integers(0, 256, (n, 3))
        idx = (pal_img.astype(int) * n // 256).astype(np.uint8)
        files[f"pal{depth}.png"] = write_png(idx, depth, 3, palette=palette)
        files[f"pal{depth}_trns.png"] = write_png(
            idx, depth, 3, palette=palette,
            trns=bytes(rng.integers(0, 256, max(1, n // 2)).astype(
                np.uint8)))
        if depth < 8:
            files[f"grey{depth}.png"] = write_png(
                pal_img >> (8 - depth), depth, 0)
    files["pal8_grey256_217x301.png"] = write_png(
        g, 8, 3, palette=np.repeat(np.arange(256)[:, None], 3, axis=1))
    bio = io.BytesIO()
    Image.fromarray(c[..., ::-1]).quantize(64).save(bio, "PNG")
    files["pillow_pal.png"] = bio.getvalue()
    ga = np.stack([grey(h, w), grey(h, w, 300, 300)], axis=2)
    files["grey_alpha8.png"] = write_png(ga, 8, 4)
    files["grey_alpha16.png"] = write_png(
        ga.astype(np.uint16) * 257 + 3, 16, 4)
    rgb = bgr(h, w)[..., ::-1]
    key = rgb[5, 7]
    files["rgb_trns8.png"] = write_png(rgb, 8, 2, trns=struct.pack(
        ">3H", *map(int, key)))
    rgb16 = rgb.astype(np.uint16) * 257
    files["rgb_trns16.png"] = write_png(rgb16, 16, 2, trns=struct.pack(
        ">3H", *map(int, rgb16[5, 7])))
    files["adam7_grey8.png"] = write_png(grey(h, w), 8, 0, interlace=True)
    files["adam7_grey1.png"] = write_png(grey(h, w) >> 7, 1, 0,
                                         interlace=True)
    files["adam7_grey16.png"] = write_png(
        grey(h, w).astype(np.uint16) * 251, 16, 0, interlace=True)
    files["adam7_rgb8.png"] = write_png(rgb, 8, 2, interlace=True)
    files["adam7_rgba8.png"] = write_png(
        np.concatenate([rgb, grey(h, w, 600, 600)[..., None]], axis=2), 8,
        6, interlace=True)
    files["adam7_pal4_trns.png"] = write_png(
        pal_img >> 4, 4, 3, interlace=True,
        palette=rng.integers(0, 256, (16, 3)), trns=b"\x00\x80\x40")
    files["adam7_5x3.png"] = write_png(bgr(5, 3)[..., ::-1], 8, 2,
                                       interlace=True)
    gama = chunk(b"gAMA", struct.pack(">I", 45455))
    files["rgb8_gama.png"] = write_png(rgb, 8, 2, before=[gama])
    files["pal8_srgb.png"] = write_png(
        (pal_img >> 2).astype(np.uint8), 8, 3, before=[chunk(b"sRGB", b"\0")],
        palette=rng.integers(0, 256, (64, 3)))
    files["exif_o6.png"] = write_png(grey(h, w), 8, 0,
                                     before=[chunk(b"eXIf", exif_tiff(6))])
    files["exif_o3_ii_rgb.png"] = write_png(
        rgb, 8, 2, after=[chunk(b"eXIf", exif_tiff(3, b"II"))])
    files.update(other_formats(grey, bgr, rng))
    return files


def other_formats(grey, bgr, rng) -> dict:
    """TIFF, GIF, BMP, Netpbm, PFM, Sun raster and Radiance fixtures of 13x17
    pixels (``tests/torch_image_writers.py`` unless cv2 or Pillow is
    named)."""
    h, w = 13, 17
    g, c = grey(h, w, 40, 40), bgr(h, w)
    rgb = c[..., ::-1]
    files = {}
    files["tiff_grey_lzw_pred2_tiled_mm.tif"] = write_tiff(
        g, order=b"MM", tile=(16, 16), compression=5, predictor=2)
    files["tiff_u16_deflate_pred2.tif"] = write_tiff(
        g.astype(np.uint16) * 201, compression=8, predictor=2,
        rows_per_strip=8)
    files["tiff_i16_dem_deflate_pred2_tiled.tif"] = write_tiff(
        (g.astype(np.int16) * 13 - 400), tile=(16, 16), compression=8,
        predictor=2)
    files["tiff_f32_dem_deflate_pred3_tiled.tif"] = write_tiff(
        g.astype(np.float32) * np.float32(3.7) - 120, tile=(16, 16),
        compression=32946, predictor=3)
    files["tiff_bigtiff_lzw_old.tif"] = write_tiff(
        g, bigtiff=True, compression=5, lzw_old=True, rows_per_strip=5)
    files["tiff_rgb_planar2_packbits.tif"] = write_tiff(
        rgb, planar=2, compression=32773)
    files["tiff_rgba_unassoc.tif"] = write_tiff(
        np.concatenate([rgb, grey(h, w, 300, 300)[..., None]], axis=2),
        extra_samples=[2], compression=8)
    files["tiff_u16_rgb.tif"] = write_tiff(rgb[:8, :9].astype(np.uint16)
                                           * 257 + 5)
    files["tiff_palette4.tif"] = write_tiff(
        g >> 4, bits=4, photometric=3,
        colormap=rng.integers(0, 65536, (16, 3)))
    files["tiff_cmyk.tif"] = write_tiff(
        np.concatenate([rgb, g[..., None] // 3], axis=2), photometric=5)
    files["tiff_ycbcr22.tif"] = write_tiff(rgb, photometric=6,
                                           subsampling=(2, 2))
    files["tiff_o6.tif"] = write_tiff(g, orientation=6, compression=8)
    files["tiff_o3_tiled.tif"] = write_tiff(c, orientation=3, tile=(16, 16),
                                            compression=8)
    files["tiff_1bit_miniswhite_fo2.tif"] = write_tiff(
        g >> 7, bits=1, photometric=0, fill_order=2)
    files["tiff_raw_tile_512.tif"] = write_tiff(g, tile=(32, 16))
    bio = io.BytesIO()
    Image.fromarray(rgb).save(bio, "TIFF", compression="jpeg", quality=85)
    files["tiff_jpeg_ycbcr_pillow.tif"] = bio.getvalue()
    pal = rng.integers(0, 256, (16, 3))
    idx = (g >> 4).astype(np.uint8)
    files["gif_trans_screen.gif"] = write_gif(
        (h + 4, w + 6), [gif_frame(idx, left=2, top=3, transparent=5)], pal,
        background=9)
    files["gif_interlace_local.gif"] = write_gif(
        (h, w), [gif_frame(idx, interlace=True, local_palette=pal[::-1])])
    files["gif_cv2.gif"] = _cv2(".gif", c)
    files["bmp_rle8.bmp"] = write_bmp(
        idx, 8, pal, compression=1, data=bmp_rle_encode(idx[::-1], False))
    files["bmp_rle4.bmp"] = write_bmp(
        idx, 4, pal, compression=2, data=bmp_rle_encode(idx[::-1], True))
    files["bmp_565.bmp"] = write_bmp(
        (g.astype(np.uint16) << 5) | (g >> 3), 16, compression=3,
        masks=(0xF800, 0x7E0, 0x1F))
    files["bmp_v5_bgra_cv2.bmp"] = _cv2(
        ".bmp", np.concatenate([c, g[..., None]], axis=2))
    files["bmp_os2_pal8.bmp"] = write_bmp(g, 8, rng.integers(0, 256,
                                                          (256, 3)),
                                          header=12)
    files["bmp_topdown_pal1.bmp"] = write_bmp(g >> 7, 1, pal[:2],
                                              top_down=True)
    files["p2_max100.pgm"] = (b"P2\n# a comment\n%d %d\n100\n" % (w, h)
                              + b" ".join(b"%d" % v for v in
                                          (g % 101).ravel()) + b"\n")
    files["p5_16bit.pgm"] = b"P5 %d %d 60000\n" % (w, h) + (
        g.astype(">u2") * 233).tobytes()
    files["p3_cv2.ppm"] = _cv2(".ppm", c[:5, :7], cv2.IMWRITE_PXM_BINARY, 0)
    files["p4_cv2.pbm"] = _cv2(".pbm", (g > 120).astype(np.uint8) * 255)
    files["p6_cv2.ppm"] = _cv2(".ppm", c)
    files["pam_rgb_cv2.pam"] = _cv2(".pam", c, cv2.IMWRITE_PAM_TUPLETYPE,
                                    cv2.IMWRITE_PAM_FORMAT_RGB)
    files["pam_grey_alpha.pam"] = (
        b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH 2\nMAXVAL 255\n"
        b"TUPLTYPE GRAYSCALE_ALPHA\nENDHDR\n" % (w, h)
        + np.stack([g, 255 - g], axis=2).tobytes())
    f = g.astype(np.float32) / np.float32(97)
    files["pfm_grey_le.pfm"] = b"Pf\n%d %d\n-1.0\n" % (w, h) + \
        f[::-1].astype("<f4").tobytes()
    files["pfm_rgb_be_scale2.pfm"] = b"PF\n7 5\n2.0\n" + (
        rgb[5:0:-1, :7].astype(np.float32) / np.float32(50)).astype(
            ">f4").tobytes()
    files["sun_map8.ras"] = write_sun(g, 8, rng.integers(0, 256, (256, 3)))
    files["sun_24.ras"] = write_sun(c, 24)
    files["sun_32.ras"] = write_sun(
        np.concatenate([g[..., None], c], axis=2), 32)
    rgbe = np.concatenate([rgb, (g[..., None] % 9 + 124).astype(np.uint8)],
                          axis=2)
    rgbe[:, :12] = rgbe[:, :1]  # runs to code
    files["hdr_rle.hdr"] = write_hdr(rgbe)
    files["hdr_flat_rgbe.hdr"] = write_hdr(
        rgbe, rle=False, header=b"#?RGBE\nFORMAT=32-bit_rle_rgbe\n\n")
    return files


def _pil_webp(img: np.ndarray, **kw) -> bytes:
    """Pillow's WebP of an RGB(A) or grey array."""
    f = io.BytesIO()
    Image.fromarray(img).save(f, "WEBP", **kw)
    return f.getvalue()


def _pil_webp_anim(frames, **kw) -> bytes:
    f = io.BytesIO()
    ims = [Image.fromarray(x) for x in frames]
    ims[0].save(f, "WEBP", save_all=True, append_images=ims[1:], **kw)
    return f.getvalue()


def webp_files() -> dict:
    """name -> WebP file bytes: cv2's and Pillow's files, and chunks
    assembled around their bitstreams where neither writes a variant."""
    world = World.make(seed=7, size_px=1024, gsd_m=1.36)
    r = world.raster
    g = np.ascontiguousarray(r[300:345, 400:461])  # 45x61
    c = np.ascontiguousarray(np.stack([g, r[500:545, 100:161],
                                       r[700:745, 600:661]], axis=2))
    a = np.ascontiguousarray(np.concatenate(
        [c, r[100:145, 800:861, None]], axis=2))  # BGRA
    q = (cv2.IMWRITE_WEBP_QUALITY,)
    files = {"vp8l_bgr.webp": _cv2(".webp", c),
             "vp8l_grey.webp": _cv2(".webp", g),
             "vp8l_bgra.webp": _cv2(".webp", a),
             "vp8l_1x1.webp": _cv2(".webp", c[:1, :1]),
             "vp8_grey_q50_13x17.webp": _cv2(".webp", g[:13, :17], *q, 50),
             "vp8_bgra_q70.webp": _cv2(".webp", a, *q, 70),
             "vp8_alpha_pil.webp": _pil_webp(a[..., [2, 1, 0, 3]],
                                             quality=70, alpha_quality=40,
                                             method=6),
             "vp8l_palette4_pil.webp": _pil_webp(
                 (g // 64 * 85).astype(np.uint8), lossless=True)}
    for quality in (1, 50, 90, 100):
        files[f"vp8_q{quality}.webp"] = _cv2(".webp", c, *q, quality)
    vp8 = webp_chunks(files["vp8_q90.webp"])[0][1]
    vp8l = webp_chunks(files["vp8l_bgr.webp"])[0][1]
    h, w = g.shape
    for filt in range(4):  # raw ALPH, each filter
        alph = bytes([filt << 2]) + a[..., 3].tobytes()
        files[f"alph_raw_filter{filt}.webp"] = webp_riff(
            [webp_vp8x(0x10, w, h), webp_chunk(b"ALPH", alph),
             webp_chunk(b"VP8 ", vp8)])
    files["exif6_vp8x.webp"] = webp_riff(
        [webp_vp8x(0x08, w, h), webp_chunk(b"VP8L", vp8l),
         webp_chunk(b"EXIF", exif_tiff(6, b"II"))])
    small = webp_chunks(_cv2(".webp", c[:20, :24]))[0][1]
    files["anim_offset_alpha.webp"] = webp_riff(
        [webp_vp8x(0x12, 40, 30), webp_anim(),
         webp_anmf(6, 4, 24, 20, webp_chunk(b"VP8L", small))])
    files["anim_pil.webp"] = _pil_webp_anim(
        [c[:30, :40, ::-1], c[10:40, 20:60, ::-1]], quality=60, duration=50)
    files["vp8_truncated.webp"] = files["vp8_q90.webp"][:300]
    return files


def write_flight(out: str) -> dict:
    """chip_smoke.py's path-16 flight in ``out``: the PNG dataset of
    ``FLIGHT`` re-encoded as WebP by cv2, and its manifest."""
    import shutil
    import tempfile

    from gisnav_tpu_torch.utils.world_wms import write_replay_dataset

    world = World.make(**FLIGHT["world"])
    manifest = {**FLIGHT, "png_sha256": {}, "webp_cv2": {}}
    with tempfile.TemporaryDirectory() as png:
        write_replay_dataset(world, png, frames=FLIGHT["frames"],
                             hw=tuple(FLIGHT["hw"]),
                             coverage=FLIGHT["coverage"])
        os.makedirs(os.path.join(out, "frames"), exist_ok=True)
        names = ["map.png"] + [os.path.join("frames", n) for n in sorted(
            os.listdir(os.path.join(png, "frames")))]
        for name in names:
            img = cv2.imread(os.path.join(png, name), cv2.IMREAD_UNCHANGED)
            data = _cv2(".webp", img, cv2.IMWRITE_WEBP_QUALITY,
                        FLIGHT["quality"])
            with open(os.path.join(out, name), "wb") as f:
                f.write(data)
            manifest["png_sha256"][name] = pixel_digest(img)
            manifest["webp_cv2"][name] = pixel_digest(cv2.imdecode(
                np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE))
        for name in ("map.json", "camera.json", "poses.csv"):
            shutil.copy(os.path.join(png, name), os.path.join(out, name))
    with open(os.path.join(out, "flight.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    return manifest


def _pil_jp2(img: np.ndarray, mode: str = None, **kw) -> bytes:
    """Pillow's JPEG 2000 (OpenJPEG) of an array: ``mode`` "I;16" for
    uint16, else the array's own mode."""
    f = io.BytesIO()
    if mode == "I;16":
        im = Image.frombytes("I;16", img.shape[::-1],
                             img.astype("<u2").tobytes())
    elif mode:
        im = Image.frombytes(mode, (img.shape[1], img.shape[0]),
                             np.ascontiguousarray(img).tobytes())
    else:
        im = Image.fromarray(img)
    im.save(f, "JPEG2000", **kw)
    return f.getvalue()


def jp2_files() -> dict:
    """name -> JPEG 2000 file bytes: Pillow's, cv2's and OpenJPEG's
    encoder's files, JP2 boxes around codestreams, patched codestreams."""
    world = World.make(seed=7, size_px=1024, gsd_m=1.36)
    r = world.raster
    g = np.ascontiguousarray(r[300:347, 400:461])  # 47x61
    c = np.ascontiguousarray(np.stack([g, r[500:547, 100:161],
                                       r[700:747, 600:661]], axis=2))
    a = np.ascontiguousarray(np.concatenate(
        [c, r[100:147, 800:861, None]], axis=2))
    i16 = (g.astype(np.uint16) << 8) | r[600:647, 200:261]
    irr = {"irreversible": True, "quality_mode": "rates"}
    files = {
        "pil_grey_rev.jp2": _pil_jp2(g),
        "pil_grey_irr_layers_rpcl.jp2": _pil_jp2(
            g, quality_layers=[40, 10], progression="RPCL", **irr),
        "pil_rgb_irr.jp2": _pil_jp2(c, quality_layers=[12], **irr),
        "pil_rgba_rev_tiles.jp2": _pil_jp2(a, mode="RGBA",
                                           tile_size=(32, 24)),
        "pil_ycbcr.jp2": _pil_jp2(c, mode="YCbCr"),
        "pil_i16.jp2": _pil_jp2(i16, mode="I;16"),
        "pil_la.jp2": _pil_jp2(a[..., :2], mode="LA"),
        "pil_signed.j2k": _pil_jp2(g, no_jp2=True, signed=True),
        "pil_raw_cprl_tiles.j2k": _pil_jp2(
            c, no_jp2=True, tile_size=(33, 21), progression="CPRL",
            num_resolutions=3),
        "cv2_rgb_x250.jp2": _cv2(".jp2", c[..., ::-1],
                                 cv2.IMWRITE_JPEG2000_COMPRESSION_X1000,
                                 250),
        "opj_styles_sop_eph.j2k": openjpeg_encode(
            c, mode=63, sop=True, eph=True, numres=4, rates=(20, 6, 0)),
        "opj_tileparts_poc.j2k": openjpeg_encode(
            g, tiles=(32, 32), numres=3, tile_parts="R", rates=(15, 0),
            pocs=[(t, 0, 0, 2, 2, 1, "RLCP") for t in range(1, 5)]
            + [(t, 2, 0, 2, 3, 1, "LRCP") for t in range(1, 5)]),
        "opj_roi.j2k": openjpeg_encode(c, roi=(0, 6), numres=4,
                                       rates=(10,), irreversible=True),
        "jp2_pclr_cmap.jp2": jp2_wrap(
            openjpeg_encode(g // 32, numres=3),
            [jp2_ihdr(*g.shape, 1, 7), jp2_colr(16),
             jp2_pclr(np.stack([np.arange(8) * 36, 255 - np.arange(8) * 30,
                                np.arange(8) * 9], axis=1), [8, 8, 8]),
             jp2_cmap([(0, 1, 0), (0, 1, 1), (0, 1, 2)])]),
        "jp2_cdef_swap_alpha.jp2": jp2_wrap(
            openjpeg_encode(a, numres=4),
            [jp2_ihdr(*g.shape, 4, 7), jp2_colr(16),
             jp2_cdef([(0, 0, 3), (1, 0, 2), (2, 0, 1), (3, 1, 0)])]),
        "j2k_siz12.j2k": j2k_patch_precision(
            j2k_codestream(_pil_jp2(i16 >> 4, mode="I;16")), 12),
        "j2k_siz15_sentinel.jp2": None,
        "pil_cut_before_eoc.jp2": _pil_jp2(g)[:-2],
        "j2k_ppt.j2k": j2k_with_ppt(openjpeg_encode(
            c, numres=3, rates=(20, 5, 0)), 2),
        "j2k_ppm_tiles.j2k": j2k_with_ppm(openjpeg_encode(
            g, tiles=(32, 32), numres=3, rates=(15, 0)), 2),
        "rgb512_irr_tile.j2k": openjpeg_encode(
            np.tile(c, (11, 9, 1))[:512, :512], irreversible=True,
            rates=(20,), tiles=(512, 512)),
    }
    # the MCT over components of both wavelets (COC markers): OpenJPEG
    # runs component 0's transform over the others' samples as they stand
    rev = _pil_jp2(c, no_jp2=True)
    files["j2k_mct_53_97.j2k"] = j2k_with_coc(j2k_with_coc(rev, 1, 0), 2, 0)
    files["j2k_mct_97_53.j2k"] = j2k_with_coc(
        _pil_jp2(c, no_jp2=True, irreversible=True), 0, 1)
    s15 = _pil_jp2(i16 >> 1, mode="I;16")
    at = s15.index(b"jp2c") + 4
    files["j2k_siz15_sentinel.jp2"] = s15[:at] + j2k_patch_precision(
        s15[at:], 15)
    return files


def write_jp2_flight(out: str) -> dict:
    """chip_smoke.py's path-17 flight in ``out``: the PNG dataset of
    ``JP2_FLIGHT`` re-encoded as irreversible JPEG 2000 by Pillow, a
    reversible 16-bit DEM, and its manifest."""
    import shutil
    import tempfile

    from gisnav_tpu_torch.utils.world_wms import write_replay_dataset

    spec = JP2_FLIGHT
    world = World.make(**spec["world"])
    manifest = {**spec, "png_sha256": {}, "jp2_cv2": {}}
    with tempfile.TemporaryDirectory() as png:
        write_replay_dataset(world, png, frames=spec["frames"],
                             hw=tuple(spec["hw"]),
                             coverage=spec["coverage"])
        os.makedirs(os.path.join(out, "frames"), exist_ok=True)
        names = ["map.png"] + [os.path.join("frames", n) for n in sorted(
            os.listdir(os.path.join(png, "frames")))]
        for name in names:
            img = cv2.imread(os.path.join(png, name), cv2.IMREAD_UNCHANGED)
            rate = spec["rates"][0 if name == "map.png" else 1]
            data = _pil_jp2(img, irreversible=True, quality_mode="rates",
                            quality_layers=[rate])
            with open(os.path.join(out, name), "wb") as f:
                f.write(data)
            manifest["png_sha256"][name] = pixel_digest(img)
            manifest["jp2_cv2"][name] = pixel_digest(cv2.imdecode(
                np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE))
        h, w = manifest["png_sha256"]["map.png"]["shape"]
        y, x = np.mgrid[:h, :w]
        dem = np.round(2 + 2 * np.sin(x / 300.0) * np.cos(y / 250.0)
                       ).astype(np.uint16)
        data = _pil_jp2(dem, mode="I;16")
        with open(os.path.join(out, spec["dem"]), "wb") as f:
            f.write(data)
        manifest["dem_cv2"] = pixel_digest(cv2.imdecode(
            np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED))
        with open(os.path.join(png, "map.json")) as f:
            meta = json.load(f)
        meta.update(dem=spec["dem"], dem_scale=spec["dem_scale"])
        with open(os.path.join(out, "map.json"), "w") as f:
            json.dump(meta, f, indent=1)
        for name in ("camera.json", "poses.csv"):
            shutil.copy(os.path.join(png, name), os.path.join(out, name))
    with open(os.path.join(out, "flight.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    return manifest


def htj2k_files() -> dict:
    """name -> HTJ2K file bytes (``tests/torch_image_writers.py``
    ``htj2k_encode``; world content, 47x61 unless named): each wavelet,
    depth, component count and transform, refinement passes, the
    vertically causal style, tiles, precincts, code-block sizes, empty
    code-blocks, CAP and CPF markers, and the variants cv2 gives None for
    (signed samples, an RGN shift, mixed mode, two layers whose second
    lands in the cleanup's segment, CAP in a tile-part header)."""
    world = World.make(seed=7, size_px=1024, gsd_m=1.36)
    r = world.raster
    g = np.ascontiguousarray(r[300:347, 400:461])
    c = np.ascontiguousarray(np.stack([g, r[500:547, 100:161],
                                       r[700:747, 600:661]], axis=2))
    a = np.ascontiguousarray(np.concatenate(
        [c, r[100:147, 800:861, None]], axis=2))
    i16 = (g.astype(np.uint16) << 8) | r[600:647, 200:261]
    big = np.ascontiguousarray(r[100:229, 200:371])  # 129x171
    irr = {"reversible": False, "step": 3.0}
    files = {
        "ht_grey_rev.j2c": htj2k_encode(g),
        "ht_grey_rev_levels0.j2c": htj2k_encode(g, levels=0),
        "ht_grey_irr.jph": htj2k_encode(g, jp2=True, **irr),
        "ht_rgb_rct.j2c": htj2k_encode(c[..., ::-1]),
        "ht_rgb_ict_sigprop.jph": htj2k_encode(c[..., ::-1], passes=2,
                                               jp2=True, **irr),
        "ht_rgb_no_mct.j2c": htj2k_encode(c[..., ::-1], mct=False, **irr),
        "ht_rgba_rev.jph": htj2k_encode(a[..., [2, 1, 0, 3]], jp2=True),
        "ht_grey_refine3.j2c": htj2k_encode(big, passes=3, levels=4),
        "ht_grey_irr_refine3_drop2.j2c": htj2k_encode(
            big, passes=3, drop=2, **irr),
        "ht_vsc_refine3.j2c": htj2k_encode(big, passes=3, style=0x08,
                                           cblk=(32, 16)),
        "ht_styles_3f.j2c": htj2k_encode(g, passes=3, style=0x3f),
        "ht_i16_rev.jph": htj2k_encode(i16, jp2=True, levels=3),
        "ht_12bit_irr.j2c": htj2k_encode((i16 >> 4).astype(np.uint16),
                                         prec=12, reversible=False,
                                         step=40.0),
        "ht_signed.j2c": htj2k_encode(g.astype(np.int16) - 128, prec=8),
        "ht_tiles_precincts.j2c": htj2k_encode(
            big, tile=(64, 48), levels=3, cblk=(16, 16),
            precincts=[(4, 4), (5, 4), (5, 5), (6, 6)]),
        "ht_cblk4x4.j2c": htj2k_encode(g, cblk=(4, 4), levels=2),
        "ht_cblk64x8_odd.j2c": htj2k_encode(
            np.ascontiguousarray(r[10:43, 20:57]), cblk=(64, 8), levels=1),
        "ht_flat_empty.j2c": htj2k_encode(
            np.full((40, 52), 131, np.uint8), levels=3, cblk=(8, 8)),
        "ht_empty_included.j2c": htj2k_encode(
            np.full((40, 52), 131, np.uint8), levels=3, cblk=(8, 8),
            empty_included=True),
        "ht_no_cap.j2c": htj2k_encode(g, cap=False, **irr),
        "ht_cpf.j2c": htj2k_encode(g, cpf=True),
        "ht_rgn.j2c": htj2k_encode(g, roi=(0, 3)),
        "ht_mixed.j2c": htj2k_encode(g, style=0x80),
        "ht_layers2.j2c": htj2k_encode(g, layers=2, passes=3),
        "ht_layers3_late_termall.j2c": htj2k_encode(
            big, layers=3, passes=3, late=True, style=0x04, cblk=(16, 16)),
    }
    cs = files["ht_grey_rev.j2c"]
    at = cs.index(b"\xff\x90")
    sod = cs.index(b"\xff\x93", at)
    cap = struct.pack(">HHIH", 0xFF50, 8, 0x00020000, 0)
    psot = struct.unpack(">I", cs[at + 6:at + 10])[0] + len(cap)
    files["ht_cap_in_tile_part.j2c"] = (cs[:at + 6] + struct.pack(">I", psot)
                                        + cs[at + 10:sod] + cap + cs[sod:])
    return files


def _ht_near(img: np.ndarray, target: int, within: float, **kw) -> tuple:
    """(bytes, step): irreversible HT of ``img`` at the base step whose
    file lies within ``within`` of ``target`` bytes (bisection on the
    step's logarithm)."""
    lo, hi = np.log2(0.5), np.log2(256.0)
    best = None
    for _ in range(12):
        step = float(2.0 ** ((lo + hi) / 2))
        data = htj2k_encode(img, reversible=False, step=step, **kw)
        if best is None or abs(len(data) - target) < abs(len(best[0])
                                                         - target):
            best = (data, step)
        if abs(len(data) - target) <= within * target:
            break
        if len(data) > target:
            lo = np.log2(step)
        else:
            hi = np.log2(step)
    return best


def write_htj2k_flight(out: str, src: str) -> dict:
    """chip_smoke.py's path-17 HTJ2K flight in ``out``: the JPEG 2000
    flight at ``src`` as cv2 decodes it, its map and frames re-coded as
    irreversible HT near their JPEG 2000 files' sizes and its DEM as
    reversible 16-bit HT (bit-equal under cv2), its other files copied, and
    a manifest of cv2's digests."""
    import shutil

    spec = HTJ2K_FLIGHT
    with open(os.path.join(src, "flight.json")) as f:
        part1 = json.load(f)
    os.makedirs(os.path.join(out, "frames"), exist_ok=True)
    manifest = {**spec, "world": part1["world"], "frames": part1["frames"],
                "hw": part1["hw"], "coverage": part1["coverage"],
                "dem_scale": part1["dem_scale"], "steps": {}, "bytes": {},
                "part1_bytes": {}, "ht_cv2": {}}
    for name in sorted(part1["jp2_cv2"]):
        with open(os.path.join(src, name), "rb") as f:
            jp2 = f.read()
        img = cv2.imdecode(np.frombuffer(jp2, np.uint8), cv2.IMREAD_GRAYSCALE)
        data, step = _ht_near(img, len(jp2), spec["size_within"],
                              levels=spec["levels"])
        with open(os.path.join(out, name), "wb") as f:
            f.write(data)
        manifest["steps"][name] = round(step, 4)
        manifest["bytes"][name] = len(data)
        manifest["part1_bytes"][name] = len(jp2)
        manifest["ht_cv2"][name] = pixel_digest(cv2.imdecode(
            np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE))
    dem = cv2.imread(os.path.join(src, part1["dem"]), cv2.IMREAD_UNCHANGED)
    data = htj2k_encode(dem, levels=spec["levels"], jp2=True)
    back = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    if back is None or not np.array_equal(back, dem):
        raise SystemExit("htj2k: the DEM does not decode bit-equal")
    with open(os.path.join(out, spec["dem"]), "wb") as f:
        f.write(data)
    manifest["dem_cv2"] = pixel_digest(back)
    if manifest["dem_cv2"] != part1["dem_cv2"]:
        raise SystemExit("htj2k: the DEM is not the JPEG 2000 flight's")
    for name in ("camera.json", "poses.csv", "map.json"):
        shutil.copy(os.path.join(src, name), os.path.join(out, name))
    with open(os.path.join(out, "flight.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    return manifest


def jpegx_files() -> dict:
    """The lossless and arithmetic-coded JPEG fixtures (48x64, world
    content)."""
    world = World.make(seed=21, size_px=256, gsd_m=1.0)
    grey = np.ascontiguousarray(world.raster[40:88, 30:94])
    rgb = np.ascontiguousarray(np.stack(
        [grey, np.roll(grey, 7, 1), np.roll(grey, 13, 0)], -1))
    cmyk = np.concatenate([rgb, 255 - grey[..., None]], -1)
    files = {}
    for psv in range(1, 8):
        files[f"lossless_grey_psv{psv}.jpg"] = libjpeg_encode(
            grey, lossless=psv)
    for psv in (1, 4, 7):
        files[f"lossless_rgb_psv{psv}.jpg"] = libjpeg_encode(
            rgb, lossless=psv, in_space=JCS_RGB, jpeg_space=JCS_RGB)
    files["lossless_grey_pt2_rst2.jpg"] = libjpeg_encode(
        grey, lossless=6, pt=2, restart_rows=2)
    files["lossless_rgb_rst3.jpg"] = libjpeg_encode(
        rgb, lossless=4, restart_rows=3, in_space=JCS_RGB,
        jpeg_space=JCS_RGB)
    files["lossless_cmyk_psv5.jpg"] = libjpeg_encode(
        cmyk, lossless=5, in_space=JCS_CMYK, jpeg_space=JCS_CMYK)
    for precision in range(2, 8):
        files[f"lossless_grey_{precision}bit.jpg"] = libjpeg_encode(
            (grey >> (8 - precision)).astype(np.uint8), lossless=2,
            precision=precision)
    files["lossless_rgb420_scans_rst.jpg"] = lossless_jpeg(
        [grey, rgb[::2, ::2, 1], rgb[::2, ::2, 2]],
        [(2, 2), (1, 1), (1, 1)], size=grey.shape, psv=7, restart_rows=4,
        scans=[[0], [1, 2]], adobe=0)
    for kind, img in (("grey", grey), ("bgr420", rgb)):
        src = _cv2(".jpg", img, cv2.IMWRITE_JPEG_QUALITY, 90)
        files[f"arith_{kind}.jpg"] = libjpeg_transcode(src)
        files[f"arith_{kind}_prog_rst2.jpg"] = libjpeg_transcode(
            src, progressive=True, restart=2)
    files["arith_bgr420_dac.jpg"] = libjpeg_transcode(
        _cv2(".jpg", rgb, cv2.IMWRITE_JPEG_QUALITY, 75),
        conditioning=((2, 6, 12), (1, 3, 40)))
    files["arith_cmyk.jpg"] = libjpeg_transcode(_pil_cmyk(cmyk))
    return files


def write_jpegx_flight(out: str) -> dict:
    """chip_smoke.py's path-18 flight in ``out``: the PNG dataset of
    ``JPEGX_FLIGHT`` written by cv2 at quality 90 and transcoded to
    arithmetic coding (the map progressive), the lossless frame's bytes
    and cv2's digests, and the manifest."""
    import shutil
    import tempfile

    from gisnav_tpu_torch.utils.world_wms import write_replay_dataset

    spec = JPEGX_FLIGHT
    world = World.make(**spec["world"])
    manifest = {**spec, "png_sha256": {}, "jpegx_cv2": {}}
    with tempfile.TemporaryDirectory() as png:
        write_replay_dataset(world, png, frames=spec["frames"],
                             hw=tuple(spec["hw"]),
                             coverage=spec["coverage"])
        os.makedirs(os.path.join(out, "frames"), exist_ok=True)
        names = ["map.png"] + [os.path.join("frames", n) for n in sorted(
            os.listdir(os.path.join(png, "frames")))]
        for name in names:
            img = cv2.imread(os.path.join(png, name), cv2.IMREAD_UNCHANGED)
            huffman = _cv2(".jpg", img, cv2.IMWRITE_JPEG_QUALITY,
                           spec["quality"])
            files = {name: libjpeg_transcode(huffman,
                                             progressive=name == "map.png")}
            if name == "map.png":  # the map's coefficients, sequential
                files[spec["map_sequential"]] = libjpeg_transcode(huffman)
            for file, data in files.items():
                with open(os.path.join(out, file), "wb") as f:
                    f.write(data)
                manifest["jpegx_cv2"][file] = pixel_digest(cv2.imdecode(
                    np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE))
            manifest["png_sha256"][name] = pixel_digest(img)
        for name in ("map.json", "camera.json", "poses.csv"):
            shutil.copy(os.path.join(png, name), os.path.join(out, name))
    with open(os.path.join(out, spec["lossless_from"]), "rb") as f:
        pixels = cv2.imdecode(np.frombuffer(f.read(), np.uint8),
                              cv2.IMREAD_GRAYSCALE)
    data = lossless_jpeg([pixels], [(1, 1)], psv=spec["lossless_psv"])
    buf = np.frombuffer(data, np.uint8)
    manifest["lossless_frame"] = {
        "file_sha256": hashlib.sha256(data).hexdigest(),
        "bytes": len(data),
        **{k: pixel_digest(cv2.imdecode(buf, f)) for k, f in FLAGS.items()}}
    with open(os.path.join(out, "flight.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    return manifest


def path16_map() -> np.ndarray:
    """The 2208-px grey map of path 16's flight (``FLIGHT``)."""
    import tempfile

    from gisnav_tpu_torch.utils.world_wms import write_replay_dataset

    with tempfile.TemporaryDirectory() as png:
        write_replay_dataset(World.make(**FLIGHT["world"]), png, frames=1,
                             hw=tuple(FLIGHT["hw"]),
                             coverage=FLIGHT["coverage"])
        return cv2.imread(os.path.join(png, "map.png"), cv2.IMREAD_UNCHANGED)


def _damaged(data: bytes, seed: int, flips: int, cut: bool = False
             ) -> bytes:
    """A one-strip TIFF with ``flips`` bits of its strip flipped (and its
    byte count cut to two thirds), from ``seed``."""
    from gisnav_tpu_torch.gis.tiff import _DirReader, _Ifd

    r = _DirReader(_Ifd(data), data)
    off, count = (int(r.strip_array((tag,), 1)[0]) for tag in (273, 279))
    r = np.random.default_rng(seed)
    out = bytearray(data)
    for _ in range(flips):
        out[off + int(r.integers(0, count))] ^= 1 << int(r.integers(0, 8))
    if cut:
        at = struct.unpack_from("<I", data, 4)[0]
        for i in range(struct.unpack_from("<H", data, at)[0]):
            e = at + 2 + 12 * i
            if struct.unpack_from("<H", data, e)[0] == 279:
                struct.pack_into("<I", out, e + 8, count * 2 // 3)
    return bytes(out)


def tiffx_files() -> dict:
    """The TIFF variant fixtures (37x53 unless named, world content) and
    path 19's DEM and bilevel maps."""
    world = World.make(seed=22, size_px=256, gsd_m=1.0)
    grey = np.ascontiguousarray(world.raster[40:77, 30:83])
    rgb = np.ascontiguousarray(np.stack(
        [grey, np.roll(grey, 7, 1), np.roll(grey, 13, 0)], -1))
    bilevel = (grey > grey.mean()).astype(np.uint8)
    files = {}
    for name, kw in (("rle", dict(compression="tiff_ccitt")),
                     ("rlew", dict(compression="tiff_raw_16")),
                     ("g3", dict(compression="group3")),
                     ("g3_2d", dict(compression="group3",
                                    tiffinfo={292: 1, 278: 8})),
                     ("g3_2d_fill", dict(compression="group3",
                                         tiffinfo={292: 5})),
                     ("g4", dict(compression="group4")),
                     ("g4_fill_order2", dict(compression="group4",
                                             tiffinfo={266: 2})),
                     ("g4_miniswhite", dict(compression="group4",
                                            tiffinfo={262: 0}))):
        files[f"ccitt_{name}.tif"] = pillow_tiff(bilevel, "1", **kw)
    files["ccitt_g4_damaged.tif"] = _damaged(files["ccitt_g4.tif"], 4, 3)
    files["ccitt_g3_cut.tif"] = _damaged(files["ccitt_g3.tif"], 3, 0,
                                         cut=True)
    files["ccitt_g3_no_eol.tif"] = write_tiff(
        bilevel, bits=1, compression=3, ccitt={"eol": False},
        rows_per_strip=9)
    files["ccitt_rle_tiles.tif"] = write_tiff(
        bilevel, bits=1, compression=2, photometric=0, tile=(32, 16))
    files["ccitt_8bit.tif"] = write_tiff(grey, extra_tags=[(259, 3, [4])])
    wide = (grey.astype(np.uint16) * 16 + 7)
    files["u12_grey.tif"] = write_tiff(wide, bits=12, rows_per_strip=8)
    files["u10_rgb_lzw_tiles_mm.tif"] = write_tiff(
        (rgb.astype(np.uint16) * 4), bits=10, order=b"MM", compression=5,
        tile=(32, 16))
    files["u14_rgba_deflate.tif"] = write_tiff(
        np.concatenate([rgb, grey[..., None]], -1).astype(np.uint16) * 64,
        bits=14, compression=8, extra_samples=[2])
    files["i12_grey_signed.tif"] = write_tiff(wide, bits=12, sample_format=2)
    files["dem_u16_lzma.tif"] = pillow_tiff(
        grey.astype(np.uint16) * 9, "I;16", compression="lzma")
    files["rgb_zstd.tif"] = pillow_tiff(rgb, "RGB", compression="zstd")
    files["ojpeg_tag.tif"] = write_tiff(grey, extra_tags=[(259, 3, [6])])
    files["no_codec_32908_rgb.tif"] = write_tiff(
        rgb, extra_tags=[(259, 3, [32908])])
    files["pred2_uncompressed.tif"] = write_tiff(
        grey, extra_tags=[(317, 3, [2])])
    files["ycbcr44_strips_w53.tif"] = write_tiff(
        rgb, photometric=6, subsampling=(4, 4), rows_per_strip=8)
    planes = [_cv2(".jpg", np.ascontiguousarray(rgb[:, :, p]))
              for p in range(3)]
    files["jpeg_planar2.tif"] = write_tiff(
        rgb, planar=2, strips=planes, extra_tags=[(259, 3, [7])])
    words = np.random.default_rng(22).integers(
        0, 2 ** 32, (13, 17), dtype=np.uint64).astype(np.uint32)
    files["bmp_v5_10_10_10_2.bmp"] = write_bmp(
        words.view(np.uint8).reshape(13, 17, 4), 32, header=124,
        compression=3, masks=(0x3FF00000, 0xFFC00, 0x3FF, 0xC0000000))
    # ThunderScan 4-bit palettes (runs, 2- and 3-bit deltas, raw pixels;
    # the raw form one code a pixel), strips of 7 rows
    r = np.random.default_rng(24)
    idx = np.cumsum(r.integers(-1, 2, (37, 53)), axis=1) % 16
    idx[:, :20] = idx[:, :1]
    idx[30:] = r.integers(0, 16, (7, 53))
    cmap = list(np.asarray(r.integers(0, 65536, (16, 3)), np.uint16).T.ravel())
    for name, raw in (("thunderscan_palette4.tif", False),
                      ("thunderscan_raw.tif", True)):
        files[name] = write_tiff(
            np.zeros((37, 53), np.uint8), photometric=3,
            strips=[thunder_encode(idx[y:y + 7], raw_only=raw)
                    for y in range(0, 37, 7)],
            extra_tags=[(258, 3, [4]), (259, 3, [32809]), (278, 4, [7]),
                        (320, 3, cmap)])
    # path 19: the DEM layer, and the map as bilevel fax for timing
    n = 2208
    geo = {33550: (1e-5, 1e-5, 0.0), 33922: (0.0, 0.0, 0.0, 24.0, 60.0,
                                              0.0),
           34735: (1, 1, 0, 3, 1024, 0, 1, 2, 1025, 0, 1, 1, 2048, 0, 1,
                   4326)}
    files["dem_u16_zstd_2208.tif"] = pillow_tiff(
        np.zeros((n, n), np.uint16), "I;16", compression="zstd",
        tiffinfo={317: 2, **geo})
    files["dem_f32_zstd_2208.tif"] = pillow_tiff(
        np.zeros((n, n), np.float32), "F", compression="zstd",
        tiffinfo={317: 3, **geo})
    m = path16_map()
    fax = (m > m.mean()).astype(np.uint8)
    files["map_2208_g4.tif"] = pillow_tiff(fax, "1", compression="group4")
    files["map_2208_g3_2d.tif"] = pillow_tiff(fax, "1", compression="group3",
                                              tiffinfo={292: 1})
    return files


def _cv2(ext: str, img, *params) -> bytes:
    ok, buf = cv2.imencode(ext, img, list(params))
    assert ok
    return buf.tobytes()


def _xmp_first(jpeg: bytes, xmp: bytes) -> bytes:
    """An XMP APP1 before the Exif APP1 (orientation 6)."""
    tagged = with_exif_app1(jpeg, exif_tiff(6))
    app1 = b"\xff\xe1" + struct.pack(">H", len(xmp) + 2) + xmp
    at = 4 + struct.unpack(">H", tagged[4:6])[0]  # after JFIF APP0
    return tagged[:at] + app1 + tagged[at:]


def pixel_digest(img) -> dict:
    if img is None:
        return None
    return {"shape": list(img.shape), "dtype": str(img.dtype),
            "sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes())
            .hexdigest()}


def digests(files: dict) -> dict:
    """name -> the file's sha256 and cv2.imdecode's pixel digests."""
    out = {}
    for name, data in sorted(files.items()):
        buf = np.frombuffer(data, np.uint8)
        out[name] = {"file_sha256": hashlib.sha256(data).hexdigest(),
                     **{k: pixel_digest(cv2.imdecode(buf, f))
                        for k, f in FLAGS.items()}}
    return out


def write_set(out: str, files: dict) -> int:
    """Replace ``out``'s files with ``files`` and their ``digests.json``;
    returns the files' bytes."""
    import shutil

    os.makedirs(out, exist_ok=True)
    for name in os.listdir(out):
        path = os.path.join(out, name)
        shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
    for name, data in files.items():
        with open(os.path.join(out, name), "wb") as f:
            f.write(data)
    with open(os.path.join(out, "digests.json"), "w") as f:
        f.write("{\n" + ",\n".join(  # an entry a line, compact
            f"{json.dumps(name)}:"
            f"{json.dumps(d, sort_keys=True, separators=(',', ':'))}"
            for name, d in sorted(digests(files).items())) + "\n}\n")
    return sum(len(d) for d in files.values())


def _cv2_outcome(data: bytes, flag: int):
    """cv2.imdecode's array, None, or "raises" (its size limits)."""
    try:
        return cv2.imdecode(np.frombuffer(data, np.uint8), flag)
    except cv2.error:
        return "raises"


def write_damaged(out: str, data_dir: str) -> int:
    """``out``/digests.json: cv2's outcome of every seeded damage of every
    committed fixture (``tests/torch_image_writers.py`` ``damage_ops``,
    ``damage_fixtures``) under IMREAD_UNCHANGED and IMREAD_GRAYSCALE, a
    fixture a line; returns the entries."""
    os.makedirs(out, exist_ok=True)
    lines, n = [], 0
    for name, data in damage_fixtures(data_dir).items():
        ops = {op: [damage_digest(_cv2_outcome(b, f))
                    for f in (cv2.IMREAD_UNCHANGED, cv2.IMREAD_GRAYSCALE)]
               for op, b in damage_ops(name, data)}
        n += 2 * len(ops)
        lines.append(f"{json.dumps(name)}:"
                     f"{json.dumps(ops, separators=(',', ':'))}")
    with open(os.path.join(out, "digests.json"), "w") as f:
        f.write("{\n" + f'"seed":{DAMAGE_SEED},\n"flags":[-1,0],\n'
                + '"files":{\n' + ",\n".join(lines) + "\n}\n}\n")
    return n


def write_htj2k(out: str, jp2_out: str) -> None:
    """The HTJ2K set in ``out`` and its flight from ``jp2_out``'s."""
    ht = htj2k_files()
    write_set(out, ht)
    write_htj2k_flight(os.path.join(out, "flight"),
                       os.path.join(jp2_out, "flight"))
    total = _tree_bytes(out)
    if total > HTJ2K_SIZE_LIMIT:
        raise SystemExit(f"the HTJ2K set takes {total} bytes, over "
                         f"{HTJ2K_SIZE_LIMIT}")
    print(f"{len(ht)} HTJ2K fixtures and the flight, {total} bytes, in {out}")


def _tree_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(d, n))
               for d, _, names in os.walk(root) for n in names)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--webp-out", default=WEBP_OUT)
    ap.add_argument("--jp2-out", default=JP2_OUT)
    ap.add_argument("--jpegx-out", default=JPEGX_OUT)
    ap.add_argument("--tiffx-out", default=TIFFX_OUT)
    ap.add_argument("--htj2k-out", default=HTJ2K_OUT)
    ap.add_argument("--htj2k-only", action="store_true",
                    help="write only the HTJ2K set and its flight (from "
                    "the committed JPEG 2000 flight), then the damaged "
                    "digests")
    ap.add_argument("--damaged-out", default=DAMAGED_OUT,
                    help="where cv2's digests of the seeded damaged "
                    "fixtures go (written after the sets)")
    ap.add_argument("--damaged-only", action="store_true",
                    help="write only the damaged digests, from the "
                    "committed fixtures")
    args = ap.parse_args()
    data_dir = os.path.dirname(os.path.abspath(args.damaged_out))
    if args.damaged_only:
        n = write_damaged(args.damaged_out, data_dir)
        print(f"{n} damaged decodes' digests in {args.damaged_out}")
        return 0
    if args.htj2k_only:
        write_htj2k(args.htj2k_out, args.jp2_out)
        n = write_damaged(args.damaged_out, data_dir)
        print(f"{n} damaged decodes' digests in {args.damaged_out}")
        return 0
    files = build()
    total = sum(len(d) for d in files.values())
    if total > SIZE_LIMIT:
        raise SystemExit(f"fixtures take {total} bytes, over {SIZE_LIMIT}")
    write_set(args.out, files)
    print(f"{len(files)} fixtures, {total} bytes, in {args.out}")
    webp = webp_files()
    write_set(args.webp_out, webp)
    write_flight(os.path.join(args.webp_out, "flight"))
    total = _tree_bytes(args.webp_out)
    if total > WEBP_SIZE_LIMIT:
        raise SystemExit(f"the WebP set takes {total} bytes, over "
                         f"{WEBP_SIZE_LIMIT}")
    print(f"{len(webp)} WebP fixtures and the flight, {total} bytes, in "
          f"{args.webp_out}")
    jp2 = jp2_files()
    write_set(args.jp2_out, jp2)
    write_jp2_flight(os.path.join(args.jp2_out, "flight"))
    total = _tree_bytes(args.jp2_out)
    if total > JP2_SIZE_LIMIT:
        raise SystemExit(f"the JPEG 2000 set takes {total} bytes, over "
                         f"{JP2_SIZE_LIMIT}")
    print(f"{len(jp2)} JPEG 2000 fixtures and the flight, {total} bytes, in "
          f"{args.jp2_out}")
    jpegx = jpegx_files()
    write_set(args.jpegx_out, jpegx)
    write_jpegx_flight(os.path.join(args.jpegx_out, "flight"))
    total = _tree_bytes(args.jpegx_out)
    if total > JPEGX_SIZE_LIMIT:
        raise SystemExit(f"the lossless / arithmetic JPEG set takes {total} "
                         f"bytes, over {JPEGX_SIZE_LIMIT}")
    print(f"{len(jpegx)} lossless and arithmetic-coded JPEG fixtures and the "
          f"flight, {total} bytes, in {args.jpegx_out}")
    write_htj2k(args.htj2k_out, args.jp2_out)
    tiffx = tiffx_files()
    total = write_set(args.tiffx_out, tiffx)
    if total > TIFFX_SIZE_LIMIT:
        raise SystemExit(f"the TIFF variant set takes {total} bytes, over "
                         f"{TIFFX_SIZE_LIMIT}")
    print(f"{len(tiffx)} TIFF variant fixtures, {total} bytes, in "
          f"{args.tiffx_out}")
    n = write_damaged(args.damaged_out, data_dir)
    print(f"{n} damaged decodes' digests in {args.damaged_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
