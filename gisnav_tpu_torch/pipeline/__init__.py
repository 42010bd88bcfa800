"""The frame -> geopose programs, their configuration and runners
(counterpart of ``gisnav_tpu/pipeline``)."""
from gisnav_tpu_torch.pipeline.geopose import (  # noqa: F401
    GeoPose,
    PipelineConfig,
    build_frame_to_geopose,
    build_frame_to_geopose_cached,
    build_reference_extractor,
    init_pipeline_params,
)
