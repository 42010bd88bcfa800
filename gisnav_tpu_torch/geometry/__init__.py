"""Geometry and CRS math on the host (numpy), the counterpart of
``gisnav_tpu/geometry``: quaternions, SE(3), the pixel -> WGS84 affine CRS
codec, WGS84 <-> ECEF <-> ENU, UTM, haversine, twist differentiation and
the heading, roll and nadir-angle helpers. Code on the device uses
``geometry.ops`` (torch) instead.
"""
from gisnav_tpu_torch.geometry.bbox import (  # noqa: F401
    BBox,
    bbox_overlap_fraction,
    fov_bounding_box_enu,
    project_fov_to_ground,
    square_and_pad,
)
from gisnav_tpu_torch.geometry.crs import (  # noqa: F401
    WGS84_A,
    WGS84_B,
    WGS84_E2,
    WGS84_F,
    affine_to_proj,
    bbox_perimeter_meters,
    ecef_to_wgs84,
    enu_to_ecef_matrix,
    haversine_m,
    pixel_to_wgs84_affine,
    proj_to_affine,
    wgs84_to_ecef,
)
from gisnav_tpu_torch.geometry.quaternion import (  # noqa: F401
    angle_off_nadir,
    euler_to_quat,
    heading_deg_from_quat,
    matrix_to_quat,
    quat_conjugate,
    quat_inverse,
    quat_mul,
    quat_rotate,
    quat_slerp,
    quat_to_euler,
    quat_to_matrix,
    roll_deg_from_quat,
)
from gisnav_tpu_torch.geometry.se3 import (  # noqa: F401
    compose,
    interpolate_transform,
    invert,
    make_transform,
    poses_to_twist,
    split_transform,
)
from gisnav_tpu_torch.geometry.tm import (  # noqa: F401
    enu_offset_to_wgs84,
    utm_to_wgs84,
    utm_zone,
    wgs84_to_utm,
)
