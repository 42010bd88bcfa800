"""Host-side GIS retrieval: the WMS client, the orthoimage cache, map
sizing, and the image codecs it decodes with (counterpart of
``gisnav_tpu/gis``)."""
from gisnav_tpu_torch.gis.cache import (  # noqa: F401
    OrthoImage,
    OrthoImageCache,
)
from gisnav_tpu_torch.gis.wms import (  # noqa: F401
    WMSClient,
    orthoimage_size_for_camera,
    request_orthoimage,
)
