"""Feature matching: LightGlue (module route; the fused route is
``matching.lightglue_fused``), the semi-dense LoFTR matcher, and the
classical mutual-nearest-neighbour / ratio matcher (counterpart of
``gisnav_tpu/matching``)."""
from gisnav_tpu_torch.matching.lightglue import (  # noqa: F401
    LightGlue,
    MatchResult,
    match_features,
)
from gisnav_tpu_torch.matching.loftr import LoFTR, LoFTRMatches  # noqa: F401
from gisnav_tpu_torch.matching.mnn import (  # noqa: F401
    mnn_ratio_match,
    root_sift,
)
