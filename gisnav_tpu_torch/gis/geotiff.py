"""Minimal pure-Python GeoTIFF codec (single-band, uncompressed).

The port's copy of ``gisnav_tpu/gis/geotiff.py``, in numpy and ``struct``
(no GDAL): the writer's bytes equal the JAX writer's, and each package
reads the other's files.

The reference's GIS stack carries georeferenced rasters as GeoTIFFs end to
end — NAIP orthoimagery and USGS DEMs are dropped into MapServer's VRT
directories (``docker/apache/mapserver/entrypoint.sh`` in hmakelin/gisnav)
and GDAL does the decoding. This module gives the package the same wire
format without a GDAL dependency: enough TIFF 6.0 + GeoTIFF 1.1 to

- WRITE single-band uint8 (imagery) and float32 (DEM meters) rasters with
  an EPSG:4326 geographic transform (``ModelPixelScale`` + ``ModelTiepoint``
  + ``GeoKeyDirectory``), readable by GDAL/QGIS/rasterio and by MapServer's
  VRT assembly on the deployment host, and
- READ the same subset back (round-trip tests, the self-contained demo GIS
  server ``gis/server.py``).

Scope is deliberate: no compression, no tiles (strips only), no palettes,
little-endian only on write (both byte orders on read). Anything outside
the subset raises ``ValueError`` rather than guessing.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["GeoRef", "write_geotiff", "read_geotiff"]

# TIFF tag ids
_IMAGE_WIDTH = 256
_IMAGE_LENGTH = 257
_BITS_PER_SAMPLE = 258
_COMPRESSION = 259
_PHOTOMETRIC = 262
_STRIP_OFFSETS = 273
_SAMPLES_PER_PIXEL = 277
_ROWS_PER_STRIP = 278
_STRIP_BYTE_COUNTS = 279
_SAMPLE_FORMAT = 339
_MODEL_PIXEL_SCALE = 33550
_MODEL_TIEPOINT = 33922
_GEO_KEY_DIRECTORY = 34735

# TIFF field types
_SHORT = 3
_LONG = 4
_DOUBLE = 12
_TYPE_SIZE = {_SHORT: 2, _LONG: 4, _DOUBLE: 8}

# GeoTIFF keys (GeoTIFF 1.1 spec section 6)
_GT_MODEL_TYPE = 1024  # 2 = geographic lat/lon
_GT_RASTER_TYPE = 1025  # 1 = PixelIsArea
_GEOGRAPHIC_TYPE = 2048  # 4326 = WGS84


@dataclass(frozen=True)
class GeoRef:
    """North-up geographic georeference (EPSG:4326 only).

    ``lon = left + x * gsd_lon``; ``lat = top - y * gsd_lat`` for pixel
    (x, y) at the pixel's top-left corner (PixelIsArea).
    """

    left: float
    top: float
    gsd_lon: float  # degrees per pixel, positive east
    gsd_lat: float  # degrees per pixel, positive (applied southward)

    def bbox(self, shape: Tuple[int, int]
             ) -> Tuple[float, float, float, float]:
        """(left, bottom, right, top) of an (H, W) raster in degrees."""
        h, w = shape[:2]
        return (
            self.left,
            self.top - h * self.gsd_lat,
            self.left + w * self.gsd_lon,
            self.top,
        )


def write_geotiff(path: str, raster: np.ndarray, georef: GeoRef) -> None:
    """Write a single-band GeoTIFF (uint8 or float32, EPSG:4326 north-up)."""
    if raster.ndim != 2:
        raise ValueError(f"single-band only, got shape {raster.shape}")
    if raster.dtype == np.uint8:
        bits, sample_format = 8, 1
    elif raster.dtype == np.float32:
        bits, sample_format = 32, 3
    else:
        raise ValueError(f"uint8 or float32 only, got {raster.dtype}")
    h, w = raster.shape
    pixel_data = np.ascontiguousarray(raster).tobytes()

    # layout: header(8) | IFD | overflow values | pixel strip
    # (tag, type, count, payload)
    entries: List[Tuple[int, int, int, bytes]] = []

    def entry(tag: int, ftype: int, values) -> None:
        if np.isscalar(values):
            values = [values]
        fmt = {_SHORT: "<H", _LONG: "<I", _DOUBLE: "<d"}[ftype]
        payload = b"".join(struct.pack(fmt, v) for v in values)
        entries.append((tag, ftype, len(values), payload))

    entry(_IMAGE_WIDTH, _LONG, w)
    entry(_IMAGE_LENGTH, _LONG, h)
    entry(_BITS_PER_SAMPLE, _SHORT, bits)
    entry(_COMPRESSION, _SHORT, 1)  # none
    entry(_PHOTOMETRIC, _SHORT, 1)  # BlackIsZero
    entry(_STRIP_OFFSETS, _LONG, 0)  # patched after layout below
    entry(_SAMPLES_PER_PIXEL, _SHORT, 1)
    entry(_ROWS_PER_STRIP, _LONG, h)  # single strip
    entry(_STRIP_BYTE_COUNTS, _LONG, len(pixel_data))
    entry(_SAMPLE_FORMAT, _SHORT, sample_format)
    entry(_MODEL_PIXEL_SCALE, _DOUBLE, [georef.gsd_lon, georef.gsd_lat, 0.0])
    # tiepoint: raster (0, 0, 0) -> model (left, top, 0)
    entry(_MODEL_TIEPOINT, _DOUBLE,
          [0.0, 0.0, 0.0, georef.left, georef.top, 0.0])
    entry(_GEO_KEY_DIRECTORY, _SHORT, [
        1, 1, 0, 3,  # version, revision 1.0, number of keys
        _GT_MODEL_TYPE, 0, 1, 2,      # geographic
        _GT_RASTER_TYPE, 0, 1, 1,     # PixelIsArea
        _GEOGRAPHIC_TYPE, 0, 1, 4326,  # WGS84
    ])

    entries.sort(key=lambda e: e[0])  # TIFF requires ascending tag order
    ifd_offset = 8
    ifd_size = 2 + 12 * len(entries) + 4
    overflow_offset = ifd_offset + ifd_size
    overflow = bytearray()
    packed_entries = bytearray()
    for tag, ftype, count, payload in entries:
        if len(payload) <= 4:
            value_field = payload.ljust(4, b"\0")
        else:
            value_field = struct.pack("<I", overflow_offset + len(overflow))
            overflow.extend(payload)
        packed_entries.extend(struct.pack("<HHI", tag, ftype, count))
        packed_entries.extend(value_field)

    data_offset = overflow_offset + len(overflow)
    # patch StripOffsets (inline LONG value) now that the layout is known
    for i, (tag, ftype, count, _payload) in enumerate(entries):
        if tag == _STRIP_OFFSETS:
            pos = i * 12 + 8
            packed_entries[pos:pos + 4] = struct.pack("<I", data_offset)

    with open(path, "wb") as f:
        f.write(struct.pack("<2sHI", b"II", 42, ifd_offset))
        f.write(struct.pack("<H", len(entries)))
        f.write(bytes(packed_entries))
        f.write(struct.pack("<I", 0))  # no next IFD
        f.write(bytes(overflow))
        f.write(pixel_data)


def read_geotiff(path: str) -> Tuple[np.ndarray, GeoRef]:
    """Read a GeoTIFF within the module's subset -> (raster, GeoRef)."""
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < 8:
        raise ValueError("not a TIFF: truncated header")
    order = blob[:2]
    if order == b"II":
        e = "<"
    elif order == b"MM":
        e = ">"
    else:
        raise ValueError(f"not a TIFF: bad byte order {order!r}")
    magic, ifd_offset = struct.unpack(e + "HI", blob[2:8])
    if magic != 42:
        raise ValueError(f"not a TIFF: magic={magic}")

    n = struct.unpack_from(e + "H", blob, ifd_offset)[0]
    tags: Dict[int, list] = {}
    for i in range(n):
        base = ifd_offset + 2 + i * 12
        tag, ftype, count = struct.unpack_from(e + "HHI", blob, base)
        if ftype not in _TYPE_SIZE:
            continue  # skip unsupported field types (e.g. ASCII params)
        size = _TYPE_SIZE[ftype] * count
        if size <= 4:
            off = base + 8
        else:
            off = struct.unpack_from(e + "I", blob, base + 8)[0]
        fmt = {_SHORT: "H", _LONG: "I", _DOUBLE: "d"}[ftype]
        tags[tag] = list(struct.unpack_from(e + str(count) + fmt, blob, off))

    def one(tag: int, default=None):
        if tag not in tags:
            if default is not None:
                return default
            raise ValueError(f"missing required TIFF tag {tag}")
        return tags[tag][0]

    if one(_COMPRESSION, 1) != 1:
        raise ValueError("compressed TIFFs are outside this codec's subset")
    if one(_SAMPLES_PER_PIXEL, 1) != 1:
        raise ValueError("multi-band TIFFs are outside this codec's subset")
    w, h = one(_IMAGE_WIDTH), one(_IMAGE_LENGTH)
    bits = one(_BITS_PER_SAMPLE, 8)
    sample_format = one(_SAMPLE_FORMAT, 1)
    if (bits, sample_format) == (8, 1):
        dtype = np.dtype(np.uint8)
    elif (bits, sample_format) == (32, 3):
        dtype = np.dtype(np.float32)
    else:
        raise ValueError(f"unsupported sample layout: {bits} bits fmt "
                         f"{sample_format}")
    dtype = dtype.newbyteorder(e)

    offsets = tags.get(_STRIP_OFFSETS)
    counts = tags.get(_STRIP_BYTE_COUNTS)
    if not offsets or not counts:
        raise ValueError("missing strip layout tags")
    data = b"".join(blob[o:o + c] for o, c in zip(offsets, counts))
    raster = np.frombuffer(data, dtype, count=h * w).reshape(h, w)
    raster = raster.astype(dtype.newbyteorder("="))

    scale = tags.get(_MODEL_PIXEL_SCALE)
    tie = tags.get(_MODEL_TIEPOINT)
    if not scale or not tie or len(tie) < 6:
        raise ValueError("not a GeoTIFF: no ModelPixelScale/ModelTiepoint")
    geokeys = tags.get(_GEO_KEY_DIRECTORY, [])
    for i in range(4, len(geokeys) - 3, 4):
        if geokeys[i] == _GT_MODEL_TYPE and geokeys[i + 3] != 2:
            raise ValueError("projected GeoTIFFs are outside this codec's "
                             "subset (EPSG:4326 geographic only)")
    # tiepoint maps raster (i, j) -> model (x, y); we require the (0, 0) form
    i0, j0 = tie[0], tie[1]
    left = tie[3] - i0 * scale[0]
    top = tie[4] + j0 * scale[1]
    georef = GeoRef(left=left, top=top, gsd_lon=scale[0], gsd_lat=scale[1])
    return raster, georef
