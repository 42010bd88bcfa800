"""WFSTNode: telemetry sink writing the mock-GPS track to a WFS-T endpoint.

The port's counterpart of ``gisnav_tpu/nodes/wfst_node.py`` (the reference
WFSTNode, ``extensions/wfst_node.py`` in hmakelin/gisnav): it subscribes to
the SensorGps output, inserts each position into the feature store through
hand-built WFS-T XML transactions over HTTP (the same bytes as the JAX
node's), and deletes all features on startup.

Written departure: it posts with ``urllib`` (the JAX node uses
``requests``, which the card machine need not have); a refused connection
or a non-200 reply is logged and the fix dropped, as there.
"""
from __future__ import annotations

import urllib.error
import urllib.request

from gisnav_tpu_torch.constants import WFST_NODE_NAME
from gisnav_tpu_torch.nodes.base import Node
from gisnav_tpu_torch.nodes.mock_gps import TOPIC_SENSOR_GPS

__all__ = ["WFSTNode", "wfst_insert_xml", "wfst_delete_all_xml"]


def wfst_insert_xml(lon: float, lat: float) -> str:
    """WFS-T 1.1.0 Insert transaction for one WGS84 position (same schema as
    the reference's TinyOWS setup, ``wfst_node.py:57-87``)."""
    return f"""
        <wfs:Transaction service="WFS" version="1.1.0"
            xmlns:wfs="http://www.opengis.net/wfs"
            xmlns:gml="http://www.opengis.net/gml"
            xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance"
            xmlns:gisnav="http://www.mapserver.org/tinyows/"
            xsi:schemaLocation="http://www.opengis.net/wfs
                                http://schemas.opengis.net/wfs/1.1.0/wfs.xsd">
            <wfs:Insert>
                <gisnav:position>
                    <gisnav:geom>
                        <gml:Point srsName="EPSG:4326">
                            <gml:coordinates>{lon},{lat}</gml:coordinates>
                        </gml:Point>
                    </gisnav:geom>
                </gisnav:position>
            </wfs:Insert>
        </wfs:Transaction>
    """


def wfst_delete_all_xml() -> str:
    """WFS-T Delete transaction clearing every stored position
    (``wfst_node.py:89-112``)."""
    return """
        <wfs:Transaction service="WFS" version="1.1.0"
            xmlns:wfs="http://www.opengis.net/wfs"
            xmlns:ogc="http://www.opengis.net/ogc"
            xmlns:gisnav="http://www.mapserver.org/tinyows/"
            xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance"
            xsi:schemaLocation="http://www.opengis.net/wfs
                                http://schemas.opengis.net/wfs/1.1.0/wfs.xsd">
            <wfs:Delete typeName="gisnav:position">
                <ogc:Filter>
                    <ogc:PropertyIsLike wildCard="%" singleChar="_" escapeChar="\\">
                        <ogc:PropertyName>gisnav:geom</ogc:PropertyName>
                        <ogc:Literal>%</ogc:Literal>
                    </ogc:PropertyIsLike>
                </ogc:Filter>
            </wfs:Delete>
        </wfs:Transaction>
    """


class WFSTNode(Node):
    """Streams SensorGps positions into the GIS feature store."""

    def __init__(self, bus, params=None, tf=None):
        super().__init__(WFST_NODE_NAME, bus, params, tf)
        self.url = self.param("wfst_url", "http://127.0.0.1:80/wfst")
        self._delete_all()
        self.subscribe(TOPIC_SENSOR_GPS, self._sensor_gps_cb)

    def _post(self, xml: str) -> bool:
        req = urllib.request.Request(
            self.url, data=xml.encode("utf-8"),
            headers={"Content-Type": "text/xml"}, method="POST")
        try:
            with urllib.request.urlopen(
                    req, timeout=float(self.param("timeout_s", 5.0))) as resp:
                body, status = resp.read(), resp.status
        except urllib.error.HTTPError as e:
            self.log.error("WFS-T request rejected: %s",
                           e.read()[:200].decode("utf-8", "replace"))
            return False
        except (urllib.error.URLError, OSError) as e:
            self.log.error("WFS-T request failed: %r", e)
            return False
        if status != 200:
            self.log.error("WFS-T request rejected: %s",
                           body[:200].decode("utf-8", "replace"))
            return False
        return True

    def _delete_all(self) -> None:
        self._post(wfst_delete_all_xml())

    def _sensor_gps_cb(self, msg) -> None:
        self._post(wfst_insert_xml(msg["lon"] / 1e7, msg["lat"] / 1e7))
