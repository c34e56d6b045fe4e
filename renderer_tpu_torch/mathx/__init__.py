"""Camera and quaternion math in float32 torch (``renderer_tpu.mathx``).

Matrices are 4x4 with column vectors (``p' = M @ [p, 1]``), quaternions
``(w, x, y, z)``, camera forward -Z, clip depth in [0, 1], NDC y=+1 at
image row 0.
"""

from renderer_tpu_torch.mathx.camera import (  # noqa: F401
    Camera,
    camera_matrices,
    frustum_planes,
    look_at,
    orbit_camera,
    orthographic,
    perspective,
    view_matrix,
)
from renderer_tpu_torch.mathx.transforms import (  # noqa: F401
    quat_from_axis_angle,
    quat_mul,
    quat_to_mat3,
    transform_aabb,
    trs_matrix,
)
