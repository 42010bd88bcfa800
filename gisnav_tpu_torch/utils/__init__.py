"""Utilities: profiling, the rendered test worlds and the loopback stub
WMS (counterpart of ``gisnav_tpu/utils``)."""
from gisnav_tpu_torch.utils.profiling import (  # noqa: F401
    StageTimer,
    device_profile,
)
