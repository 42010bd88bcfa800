"""GISNode: fetch orthoimagery + DEM from WMS for the FOV bbox.

The port's counterpart of ``gisnav_tpu/nodes/gis_node.py``, capability
parity with the reference GISNode (``core/gis_node.py`` in
hmakelin/gisnav): camera-diagonal map sizing, 0.85-overlap refresh gating,
atomic OrthoImage publication with an embedded CRS, fail-soft WMS errors.
The timer lives at the app layer; this node exposes ``tick()``.
``wms_format`` defaults to the JAX node's ``image/jpeg`` (``gis.wms``
decodes PNG and JPEG by content).
"""
from __future__ import annotations

import os
from typing import Optional

from gisnav_tpu_torch.constants import (
    GIS_NODE_NAME,
    ROS_NAMESPACE,
    ROS_TOPIC_CAMERA_INFO,
    ROS_TOPIC_RELATIVE_ORTHOIMAGE,
)
from gisnav_tpu_torch.gis.cache import OrthoImageCache
from gisnav_tpu_torch.gis.wms import (
    DEFAULT_FORMAT,
    WMSClient,
    orthoimage_size_for_camera,
    request_orthoimage,
)
from gisnav_tpu_torch.nodes.base import Node
from gisnav_tpu_torch.nodes.bbox_node import TOPIC_FOV_BOUNDING_BOX

__all__ = ["GISNode", "TOPIC_ORTHOIMAGE"]

TOPIC_ORTHOIMAGE = (
    f"/{ROS_NAMESPACE}/{GIS_NODE_NAME}/"
    + ROS_TOPIC_RELATIVE_ORTHOIMAGE.replace("~/", "")
)


class GISNode(Node):
    """Publishes the orthoimage + DEM + CRS for the current FOV bbox."""

    def __init__(self, bus, params=None, tf=None, wms_client=None):
        super().__init__(GIS_NODE_NAME, bus, params, tf)
        self.wms = wms_client or WMSClient(
            self.param("wms_url", os.environ.get(
                "GISNAV_WMS_URL", "http://127.0.0.1:80/wms")),
            self.param("wms_version", "1.1.1"),
            self.param("wms_timeout", 10.0),
        )
        self.cache = OrthoImageCache(
            min_overlap=self.param("min_map_overlap_update_threshold", 0.85)
        )
        self._camera_info = None
        self._latest_bbox = None
        self.subscribe(ROS_TOPIC_CAMERA_INFO, self._camera_info_cb)
        self.subscribe(TOPIC_FOV_BOUNDING_BOX, self._bbox_cb)

    def _camera_info_cb(self, msg) -> None:
        self._camera_info = msg

    def _bbox_cb(self, msg) -> None:
        self._latest_bbox = msg

    def tick(self) -> Optional[dict]:
        """Publish the current orthoimage, refreshing from WMS when the bbox
        overlap gate demands it. Called from the app's publish timer
        (reference default 1 Hz, ``gis_node.py:69``)."""
        if self._latest_bbox is None or self._camera_info is None:
            return None
        bbox = self._latest_bbox["bbox"]
        stamp = self._latest_bbox["stamp_us"]
        if self.cache.needs_update(bbox):
            size = orthoimage_size_for_camera(
                self._camera_info["width"], self._camera_info["height"]
            )
            out = request_orthoimage(
                self.wms,
                (bbox.left, bbox.bottom, bbox.right, bbox.top),
                size,
                layers=self.param("wms_layers", ["imagery"]),
                dem_layers=self.param("wms_dem_layers", []),
                styles=self.param("wms_styles", None),
                dem_styles=self.param("wms_dem_styles", None),
                srs=self.param("wms_srs", "EPSG:4326"),
                format_=self.param("wms_format", DEFAULT_FORMAT),
                transparent=self.param("wms_transparency", False),
            )
            if out is None:
                self.log.warning("WMS request failed, keeping previous map")
            else:
                self.cache.update(out[0], out[1], bbox, stamp)
        ortho = self.cache.current
        if ortho is None:
            return None
        msg = {
            "stamp_us": ortho.stamp_us,
            "image": ortho.image,
            "dem": ortho.dem,
            "bbox": ortho.bbox,
            "crs": ortho.crs_proj,
        }
        self.publish(TOPIC_ORTHOIMAGE, msg)
        return msg
