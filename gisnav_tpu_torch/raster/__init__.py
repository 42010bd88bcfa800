"""Device raster preprocessing: fused rotate + centre crop."""
from gisnav_tpu_torch.raster.shear import (  # noqa: F401
    rotate_and_crop_center_shear,
)
from gisnav_tpu_torch.raster.warp import (  # noqa: F401
    compose_crs_after_warp,
    rotate_and_crop_center,
    warp_affine,
)


def rotate_and_crop_auto(stack, angle_deg, crop_shape, zoom=None):
    """Rotate + crop by the route the JAX package takes on an accelerator:
    ``zoom`` (GSD-matched resampling) takes the bilinear gather; a stack on
    the card that is square with a side the shear kernel serves (a multiple
    of 128, at least 384) takes the 3-shear rotation; everything else the
    gather."""
    from gisnav_tpu_torch.raster.shear_kernel import shear_supported

    if zoom is not None:
        return rotate_and_crop_center(stack, angle_deg, crop_shape, zoom)
    h, w = int(stack.shape[0]), int(stack.shape[1])
    if stack.is_cuda and h == w and shear_supported(h, w):
        return rotate_and_crop_center_shear(stack, angle_deg, crop_shape)
    return rotate_and_crop_center(stack, angle_deg, crop_shape)
