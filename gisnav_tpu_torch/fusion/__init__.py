"""State fusion: the EKF and UKF in place of robot_localization
(counterpart of ``gisnav_tpu/fusion``)."""
from gisnav_tpu_torch.fusion.ekf import (  # noqa: F401
    EKFState,
    ekf_init,
    ekf_predict,
    ekf_update_pose,
    ekf_update_velocity,
)
from gisnav_tpu_torch.fusion.filter import PoseFusionFilter  # noqa: F401
from gisnav_tpu_torch.fusion.ukf import (  # noqa: F401
    ukf_predict,
    ukf_update_pose,
    ukf_update_velocity,
)
