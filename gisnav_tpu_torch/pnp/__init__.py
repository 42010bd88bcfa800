"""Pose estimation on the device: batched RANSAC-PnP and the DEM elevation
gather (counterpart of ``gisnav_tpu/pnp``)."""
from gisnav_tpu_torch.pnp.dem import (  # noqa: F401
    gather_elevation,
    keypoints_to_3d,
)
from gisnav_tpu_torch.pnp.ransac import (  # noqa: F401
    PnPResult,
    project_points,
    ransac_pnp,
)
