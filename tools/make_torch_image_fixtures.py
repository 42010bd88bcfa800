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
  flag); eXIf orientations.
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
from tests.torch_image_writers import (chunk, exif_tiff,  # noqa: E402
                                       with_exif_app1, write_png)

OUT = os.path.join(os.path.dirname(__file__), os.pardir, "tests", "data",
                   "torch_images")
FLAGS = {"unchanged": cv2.IMREAD_UNCHANGED, "grayscale": cv2.IMREAD_GRAYSCALE}
SIZE_LIMIT = 512 * 1024


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
    return files


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    files = build()
    total = sum(len(d) for d in files.values())
    if total > SIZE_LIMIT:
        raise SystemExit(f"fixtures take {total} bytes, over {SIZE_LIMIT}")
    os.makedirs(args.out, exist_ok=True)
    for name in os.listdir(args.out):
        os.remove(os.path.join(args.out, name))
    for name, data in files.items():
        with open(os.path.join(args.out, name), "wb") as f:
            f.write(data)
    with open(os.path.join(args.out, "digests.json"), "w") as f:
        json.dump(digests(files), f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"{len(files)} fixtures, {total} bytes, in {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
