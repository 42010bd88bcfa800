"""Minimal WMS GetMap/GetCapabilities client over ``urllib`` (no OWSLib,
no ``requests``, no OpenCV).

Counterpart of ``gisnav_tpu/gis/wms.py`` (what the reference uses OWSLib
for, ``core/gis_node.py:248-313,638-699`` in hmakelin/gisnav): GetMap for
imagery and DEM layers over a WGS84 bbox, a GetCapabilities probe, and
decoding of the rasters. Standard WMS 1.1.1, so the reference's MapServer
stack serves it unchanged.

Replies are decoded by their content, as ``cv2.imdecode`` decodes them
(``gis/imgcodecs.py`` ``decode_image``, with the port's own decoders; the
card machine has no OpenCV): JPEG (Huffman- or arithmetic-coded,
sequential, progressive or lossless), PNG (MapServer's ``image/png;
mode=8bit`` palette PNG included), TIFF (MapServer's GTiff output, CCITT
bilevel, 10- to 14-bit samples), WebP (``image/webp``, which MapServer and
GeoServer serve), JPEG 2000, GIF, BMP, Netpbm, Sun raster and Radiance
HDR, in cv2's layout and, under the grey flag, turned upright by an EXIF
orientation. The default format is the JAX client's ``image/jpeg``. A
network error, an XML ServiceException or a reply that is no image cv2
would decode gives None, as in JAX (the GIS node keeps its previous map);
so does a reply cv2 5.0 does not read either: a float DEM under the grey
flag, a TIFF of a codec its libtiff lacks (a ZSTD or LZMA GeoTIFF, GDAL's
COG defaults), JPEG lossless arithmetic-coded (SOF11), hierarchical or
12-bit; a DEM that gives None comes back as zeros, as in JAX. A damaged
reply is read as cv2 reads it (``gis/imgcodecs.py``): None where cv2 gives
None (a PNG whose IDAT fails its CRC keeps the node's previous map, a cut
DEM gives zeros), cv2's partial image where it gives one (a corrupt LZW
strip's rows up to the damage). A header over cv2's size limits raises
``ValueError`` naming the limit, as ``cv2.error`` leaves the JAX client,
and so does a variant the port does not read yet (AVIF).
"""
from __future__ import annotations

import http.client
import math
import urllib.error
import urllib.parse
import urllib.request
from typing import Optional, Sequence, Tuple

import numpy as np

from gisnav_tpu_torch.gis.imgcodecs import (IMREAD_GRAYSCALE,
                                            IMREAD_UNCHANGED, decode_image)
from gisnav_tpu_torch.gis.png import to_gray

__all__ = ["WMSClient", "request_orthoimage", "orthoimage_size_for_camera",
           "DEFAULT_FORMAT"]

DEFAULT_FORMAT = "image/jpeg"
_NETWORK_ERRORS = (urllib.error.URLError, http.client.HTTPException,
                   OSError)


class WMSClient:
    """Thin WMS client.

    :param url: endpoint, e.g. ``http://localhost:80/wms``
    :param version: "1.1.1" (``srs``) or "1.3.0" (``crs``)
    :param timeout_s: per-request timeout (reference default 10 s)
    """

    def __init__(self, url: str, version: str = "1.1.1",
                 timeout_s: float = 10.0):
        self.url = url
        self.version = version
        self.timeout_s = timeout_s

    def _get(self, params: dict) -> Tuple[str, bytes]:
        """(content type, body) of a GET; raises a network error, and
        ``urllib.error.HTTPError`` on a non-2xx status."""
        sep = "&" if "?" in self.url else "?"
        url = self.url + sep + urllib.parse.urlencode(params)
        with urllib.request.urlopen(url, timeout=self.timeout_s) as resp:
            return resp.headers.get("content-type", ""), resp.read()

    def is_available(self) -> bool:
        """GetCapabilities connectivity probe."""
        try:
            self._get({"service": "WMS", "request": "GetCapabilities",
                       "version": self.version})
            return True
        except _NETWORK_ERRORS:
            return False

    def get_map(self, layers: Sequence[str],
                bbox: Tuple[float, float, float, float],
                size: Tuple[int, int], srs: str = "EPSG:4326",
                format_: str = DEFAULT_FORMAT,
                styles: Optional[Sequence[str]] = None,
                transparent: bool = False,
                grayscale: bool = False) -> Optional[np.ndarray]:
        """GetMap and decode the raster.

        :param bbox: (left, bottom, right, top) in ``srs`` coordinates
        :param size: (height, width) of the requested raster
        :param grayscale: as ``cv2.IMREAD_GRAYSCALE``: each format's grey
            as OpenCV makes it (a JPEG's Y plane, libpng's grey, libtiff's
            RGBA then OpenCV's fixed-point grey, 16 bits to 8), turned
            upright by EXIF or a TIFF's orientation
        :return: the raster as ``cv2.imdecode`` gives it (grey (H, W),
            BGR(A) (H, W, C), of cv2's depth), or None on a network error,
            an error status, an empty body or a reply that is no image
        """
        axis_key = "srs" if self.version.startswith("1.1") else "crs"
        params = {
            "service": "WMS", "request": "GetMap", "version": self.version,
            "layers": ",".join(layers),
            "styles": ",".join(styles) if styles else "",
            axis_key: srs, "bbox": ",".join(str(v) for v in bbox),
            "width": str(size[1]), "height": str(size[0]),
            "format": format_, "transparent": str(transparent).upper(),
        }
        try:
            ctype, body = self._get(params)
        except _NETWORK_ERRORS:
            return None
        if not body or "image" not in ctype:
            return None  # e.g. an XML ServiceException
        return decode_image(body, IMREAD_GRAYSCALE if grayscale
                            else IMREAD_UNCHANGED)


def orthoimage_size_for_camera(width: int, height: int) -> Tuple[int, int]:
    """Square (height, width) equal to the camera-frame diagonal, rounded up
    to a multiple of 8 (the reference sizes maps to the diagonal so a
    rotation never clips; SuperPoint needs sides divisible by 8)."""
    diagonal = int(math.ceil(math.hypot(width, height)))
    diagonal = (diagonal + 7) // 8 * 8
    return diagonal, diagonal


def request_orthoimage(
    client: WMSClient,
    bbox: Tuple[float, float, float, float],
    size: Tuple[int, int],
    layers: Sequence[str],
    dem_layers: Sequence[str] = (),
    styles: Optional[Sequence[str]] = None,
    dem_styles: Optional[Sequence[str]] = None,
    srs: str = "EPSG:4326",
    format_: str = DEFAULT_FORMAT,
    transparent: bool = False,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Imagery + DEM rasters for a bbox (a zero DEM without a DEM layer):
    (grey (H, W) uint8, DEM (H, W) float32 metres), or None when the
    imagery request failed."""
    img = client.get_map(layers, bbox, size, srs, format_, styles,
                         transparent)
    if img is None:
        return None
    if img.ndim == 3:  # cv2.cvtColor(img, COLOR_BGR(A)2GRAY)
        img = to_gray(img[..., 2::-1])
    dem: Optional[np.ndarray] = None
    if dem_layers and dem_layers[0]:
        dem = client.get_map(dem_layers, bbox, size, srs, format_,
                             dem_styles, transparent, grayscale=True)
    if dem is None:
        dem = np.zeros_like(img)
    return img.astype(np.uint8), dem.astype(np.float32)
