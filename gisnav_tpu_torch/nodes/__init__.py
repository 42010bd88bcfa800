"""The node graph: transports, the transform graph and every node of the
framework (counterpart of ``gisnav_tpu/nodes``). Importing it builds
nothing: ``ShmBus`` builds its C++ library at its first use."""
from gisnav_tpu_torch.nodes.app import GisNavApp  # noqa: F401
from gisnav_tpu_torch.nodes.base import Node  # noqa: F401
from gisnav_tpu_torch.nodes.bbox_node import BBoxNode  # noqa: F401
from gisnav_tpu_torch.nodes.bus import LocalBus, ShmBus  # noqa: F401
from gisnav_tpu_torch.nodes.fusion_node import FusionNode  # noqa: F401
from gisnav_tpu_torch.nodes.gis_node import GISNode  # noqa: F401
from gisnav_tpu_torch.nodes.mock_gps import (  # noqa: F401
    MockGPSNode,
    NMEANode,
    UBXNode,
    UORBNode,
)
from gisnav_tpu_torch.nodes.pose_node import PoseNode  # noqa: F401
from gisnav_tpu_torch.nodes.tf import (  # noqa: F401
    TransformGraph,
    TransformLookupError,
)
from gisnav_tpu_torch.nodes.twist_node import TwistNode  # noqa: F401
from gisnav_tpu_torch.nodes.wfst_node import WFSTNode  # noqa: F401
