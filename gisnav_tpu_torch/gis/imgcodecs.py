"""``cv2.imdecode`` and ``cv2.imread`` without OpenCV: each image format
OpenCV 5 reads by content, chosen as its ``loadsave.cpp`` chooses.

The JAX package decodes WMS replies and replay files through OpenCV; the
card machine has none, so the port carries a decoder for each format and
this module dispatches to them by signature, in OpenCV's registration
order, each with OpenCV's own signature rule:

- ``BM``: BMP (OS/2, Windows, V4, V5), ``gis/bmp.py``;
- ``#?RADIANCE`` or ``#?RGBE``: Radiance HDR, ``gis/hdr.py``;
- ``FF D8 FF``: JPEG, Huffman- or arithmetic-coded, sequential, progressive
  or lossless (EXIF turns it under the grey flag), ``gis/jpeg.py``;
- 32 bytes that libwebp's ``WebPGetFeatures`` accepts (``RIFF`` ...
  ``WEBP``, or a raw VP8 / VP8L bitstream): WebP (its EXIF chunk turns it
  under the grey flag), ``gis/webp.py``;
- ``59 A6 6A 95``: Sun raster, ``gis/sunras.py``;
- ``P1``-``P6``, ``P7``, ``Pf`` / ``PF`` and a white-space byte: PBM,
  PGM, PPM, PAM, PFM, ``gis/pxm.py``;
- ``II*\\0``, ``MM\\0*`` and BigTIFF's ``II+\\0``, ``MM\\0+``: TIFF,
  ``gis/tiff.py``;
- PNG's 8 bytes: PNG (eXIf turns it under the grey flag), ``gis/png.py``;
- ``FF 4F FF 51`` (a raw J2K codestream) or the JP2 signature box
  ``00 00 00 0C 6A 50 20 20 0D 0A 87 0A``: JPEG 2000, ``gis/jpeg2000.py``;
- ``GIF87a`` or ``GIF89a``: GIF, ``gis/gif.py``.

A matching signature decides: bytes that then fail their header give
None, as in OpenCV (no other decoder is tried); damaged or cut bytes give
cv2's outcome (each decoder's module says how: libpng's errors and
warnings, libtiff's partial strips, OpenCV's GIF and libjpeg's checks);
a header the decoder accepts with no rows or columns, over 2^20 of either
or over 2^30 pixels raises ``ValueError`` naming cv2's limit, where
``loadsave.cpp``'s ``validateInputImageSize`` raises ``cv2.error``
(``gis/coders.py`` ``check_image_size``); and so do the variants
cv2 5.0 does not read either: JPEG lossless arithmetic-coded,
hierarchical, 12-bit and 9- to 16-bit lossless, and the TIFFs its libtiff
gives up on (a ZSTD, LZMA, WebP, LERC, PixarLog, JBIG or old-style JPEG
codec, CCITT of 8-bit samples; ``gis/tiff.py`` lists them). AVIF bytes,
which OpenCV reads where it is built with libavif, raise ``ValueError``
naming the format, as do the TIFF variants the port does not read yet
(``gis/tiff.py``);
anything else gives None. Under
``IMREAD_GRAYSCALE`` the JPEG, WebP and PNG decoders' images are turned
upright by their EXIF orientation
(``gis/exif.py``) as ``loadsave.cpp`` turns them; TIFF applies its own
``Orientation`` tag under both flags. ``read_image`` differs from
``decode_image`` where ``cv2.imread`` differs from ``cv2.imdecode``: a JPEG
file cut short reads through libjpeg's stdio source, a TIFF whose
orientation transposes a non-square image and a colour PFM under the grey
flag give None (the decoder replaced imread's buffer), and an uncompressed
TIFF tile that is not whole KiB reads.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from gisnav_tpu_torch.gis import jpeg
from gisnav_tpu_torch.gis.bmp import BMP_SIGNATURE, decode_bmp
from gisnav_tpu_torch.gis.coders import IMREAD_GRAYSCALE, IMREAD_UNCHANGED
from gisnav_tpu_torch.gis.exif import apply_orientation, orientation
from gisnav_tpu_torch.gis.gif import GIF_SIGNATURES, decode_gif
from gisnav_tpu_torch.gis.hdr import HDR_SIGNATURES, decode_hdr
from gisnav_tpu_torch.gis.jpeg2000 import decode_jpeg2000, is_jpeg2000
from gisnav_tpu_torch.gis.png import PNG_SIGNATURE, png_as_opencv
from gisnav_tpu_torch.gis.pxm import (decode_pam, decode_pfm, decode_pxm,
                                      is_pam, is_pfm, is_pxm)
from gisnav_tpu_torch.gis.sunras import SUNRAS_SIGNATURE, decode_sunras
from gisnav_tpu_torch.gis.tiff import TIFF_SIGNATURES, decode_tiff
from gisnav_tpu_torch.gis.webp import decode_webp, is_webp

__all__ = ["decode_image", "read_image", "image_format", "IMREAD_UNCHANGED",
           "IMREAD_GRAYSCALE"]


def _jpeg(data: bytes, gray: bool, file: bool) -> Optional[np.ndarray]:
    img, exif = jpeg._decode(data, gray, file)
    if img is None or not gray or not exif:
        return img
    return apply_orientation(img, orientation(exif))


# (name, signature test, decoder(data, gray, file)) in OpenCV's order
_DECODERS = (
    ("BMP", lambda s: s.startswith(BMP_SIGNATURE),
     lambda d, g, f: decode_bmp(d, g)),
    ("HDR", lambda s: len(s) >= 6 and s.startswith(HDR_SIGNATURES),
     lambda d, g, f: decode_hdr(d, g)),
    ("JPEG", lambda s: s.startswith(jpeg.JPEG_SOI + b"\xff"), _jpeg),
    ("WebP", is_webp, lambda d, g, f: decode_webp(d, g)),
    ("Sun raster", lambda s: s.startswith(SUNRAS_SIGNATURE),
     lambda d, g, f: decode_sunras(d, g)),
    ("PxM", is_pxm, lambda d, g, f: decode_pxm(d, g)),
    ("PAM", is_pam, lambda d, g, f: decode_pam(d, g)),
    ("PFM", is_pfm, decode_pfm),
    ("TIFF", lambda s: s.startswith(TIFF_SIGNATURES), decode_tiff),
    ("PNG", lambda s: s.startswith(PNG_SIGNATURE),
     lambda d, g, f: png_as_opencv(d, g)),
    ("JPEG 2000", is_jpeg2000, lambda d, g, f: decode_jpeg2000(d, g)),
    ("GIF", lambda s: s.startswith(GIF_SIGNATURES),
     lambda d, g, f: decode_gif(d, g)),
)


def _unread(s: bytes) -> Optional[str]:
    """The name of a format cv2 reads that the port does not, or None."""
    if s[4:8] == b"ftyp" and s[8:12] in (b"avif", b"avis"):
        return "AVIF"
    return None


def image_format(data: bytes) -> Optional[str]:
    """The format whose decoder ``decode_image`` picks for ``data`` (by its
    first bytes, as OpenCV picks), or None."""
    head = bytes(data[:32])
    for name, test, _ in _DECODERS:
        if test(head):
            return name
    return None


def _decode_image(data: bytes, flag: int,
                  file: bool) -> Optional[np.ndarray]:
    if flag not in (IMREAD_UNCHANGED, IMREAD_GRAYSCALE):
        raise ValueError(f"decode_image flag {flag}: IMREAD_UNCHANGED (-1) "
                         "or IMREAD_GRAYSCALE (0)")
    head = data[:32]
    for _, test, decode in _DECODERS:
        if test(head):
            return decode(data, flag == IMREAD_GRAYSCALE, file)
    name = _unread(head)
    if name is not None:
        raise ValueError(f"{name} images are not read by the port (cv2 "
                         "reads them)")
    return None


def decode_image(data: bytes,
                 flag: int = IMREAD_UNCHANGED) -> Optional[np.ndarray]:
    """Image bytes, their format chosen by content as ``cv2.imdecode``
    chooses -> ``cv2.imdecode(data, flag)``'s array (grey (H, W), colour
    BGR(A), the depth cv2 gives); None where cv2 gives None."""
    return _decode_image(bytes(data), flag, file=False)


def read_image(path: str, flag: int = IMREAD_UNCHANGED
               ) -> Optional[np.ndarray]:
    """``cv2.imread(path, flag)``, the format chosen by content: as
    ``decode_image``, with ``cv2.imread``'s own ways (module docstring)."""
    with open(path, "rb") as f:
        return _decode_image(f.read(), flag, file=True)
