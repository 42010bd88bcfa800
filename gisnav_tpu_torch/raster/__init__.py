"""Device raster preprocessing: fused rotate + centre crop."""
import torch

from gisnav_tpu_torch.raster.shear import (  # noqa: F401
    rotate_and_crop_center_shear,
    rotation_quadrant,
)
from gisnav_tpu_torch.raster.warp import (  # noqa: F401
    compose_crs_after_warp,
    rotate_and_crop_center,
    rotation_about_center,
    warp_affine,
)


def takes_shear(shape, device, zoom=None) -> bool:
    """Whether ``rotate_and_crop_auto`` takes the 3-shear rotation of an
    (H, W, ...) stack on ``device``: no ``zoom``, and a stack on the card
    that is square with a side the shear kernel serves (a multiple of 128,
    at least 384)."""
    from gisnav_tpu_torch.raster.shear_kernel import shear_supported

    h, w = int(shape[0]), int(shape[1])
    return (zoom is None and torch.device(device).type == "cuda" and h == w
            and shear_supported(h, w))


def rotate_and_crop_auto(stack, angle_deg, crop_shape, zoom=None,
                         quadrant=None):
    """Rotate + crop by the route the JAX package takes on an accelerator:
    ``zoom`` (GSD-matched resampling) takes the bilinear gather; a stack on
    the card that is square with a side the shear kernel serves takes the
    3-shear rotation (:func:`takes_shear`); everything else the gather.
    ``angle_deg`` and ``zoom`` are host numbers or () tensors on the
    stack's device; ``quadrant`` is the shear route's static right-angle
    steps (``rotation_quadrant``), read from the angle when not given."""
    if takes_shear(stack.shape, stack.device, zoom):
        return rotate_and_crop_center_shear(stack, angle_deg, crop_shape,
                                            quadrant)
    return rotate_and_crop_center(stack, angle_deg, crop_shape, zoom)
