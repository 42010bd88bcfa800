"""Self-supervised training of the extractor and matcher networks
(counterpart of ``gisnav_tpu/train``)."""
from gisnav_tpu_torch.train.checkpoint import (  # noqa: F401
    latest_step,
    load_params,
    save_params,
)
from gisnav_tpu_torch.train.data import make_homography_batch  # noqa: F401
from gisnav_tpu_torch.train.loop import train  # noqa: F401
from gisnav_tpu_torch.train.steps import (  # noqa: F401
    TrainConfig,
    TrainState,
    init_train_state,
    make_train_step,
    matcher_loss,
)
