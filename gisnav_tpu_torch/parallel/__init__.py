"""Device-mesh utilities: multi-stream batching + tensor-parallel shardings."""
from gisnav_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    shard_batch,
    shard_params_tp,
)
