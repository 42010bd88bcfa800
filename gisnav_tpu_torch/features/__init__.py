"""Keypoint extraction: SuperPoint with its NMS and top-K selection on the
card, the Harris detector, and the port's SIFT (counterpart of
``gisnav_tpu/features``)."""
from gisnav_tpu_torch.features.nms import (  # noqa: F401
    select_keypoints,
    simple_nms,
)
from gisnav_tpu_torch.features.superpoint import (  # noqa: F401
    SuperPoint,
    SuperPointFeatures,
    extract_features,
)
