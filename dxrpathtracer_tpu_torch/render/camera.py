"""First-person perspective camera, matching the reference's conventions.

Parity with SampleFramework12/v1.02/Graphics/Camera.{h,cpp}: left-handed
DirectXMath matrices in row-vector form, world = R(pitch,yaw) + T, view =
inverse(world), projection = XMMatrixPerspectiveFovLH(fov=Pi/4 vertical, aspect,
near=0.01, far=100), viewProjection = view @ proj. Ray generation in the
integrator un-projects NDC through inverse(viewProjection) exactly like
RaygenShader (DXRPathTracer/RayTrace.hlsl:100-112), so camera rays match the
reference bit-for-bit at f32.

Host-side (numpy), a copy of dxrpathtracer_tpu/render/camera.py: the matrices
are tiny per-frame constants that RenderSession.frame_constants moves to the
device (the reference's constant-buffer writes, DXRPathTracer.cpp:1512-1516).
"""

import dataclasses

import numpy as np

from ..core.constants import Pi_4
from ..core.quaternion import quat_from_roll_pitch_yaw, quat_to_mat3


def perspective_fov_lh(fov_y, aspect, near_z, far_z):
    """XMMatrixPerspectiveFovLH in row-vector form."""
    h = 1.0 / np.tan(fov_y * 0.5)
    w = h / aspect
    rng = far_z / (far_z - near_z)
    return np.array([
        [w, 0, 0, 0],
        [0, h, 0, 0],
        [0, 0, rng, 1],
        [0, 0, -rng * near_z, 0],
    ], np.float32)


@dataclasses.dataclass
class FirstPersonCamera:
    """FirstPersonCamera (Camera.h:123-133): pitch/yaw orientation + position."""

    aspect: float = 16.0 / 9.0
    fov: float = Pi_4
    near_clip: float = 0.01
    far_clip: float = 100.0
    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    x_rot: float = 0.0  # pitch, clamped to [-pi/2, pi/2]
    y_rot: float = 0.0  # yaw, wrapped

    def set_position(self, p):
        self.position = np.asarray(p, np.float32)

    def set_x_rotation(self, x):
        self.x_rot = float(np.clip(x, -np.pi / 2, np.pi / 2))

    def set_y_rotation(self, y):
        # XMScalarModAngle: wrap to (-pi, pi]
        self.y_rot = float((y + np.pi) % (2.0 * np.pi) - np.pi)

    @property
    def orientation(self):
        return quat_from_roll_pitch_yaw(self.x_rot, self.y_rot, 0.0)

    def world_matrix(self):
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = quat_to_mat3(self.orientation)
        m[3, :3] = self.position
        return m

    def view_matrix(self):
        return np.linalg.inv(self.world_matrix()).astype(np.float32)

    def projection_matrix(self):
        return perspective_fov_lh(self.fov, self.aspect, self.near_clip, self.far_clip)

    def view_projection(self):
        return (self.view_matrix() @ self.projection_matrix()).astype(np.float32)

    def inv_view_projection(self):
        return np.linalg.inv(self.view_projection().astype(np.float64)).astype(np.float32)

    def forward(self):
        return quat_to_mat3(self.orientation)[2]

    def state_tuple(self):
        """Hashable state for path-trace restart detection (DXRPathTracer.cpp:1416-1461)."""
        return (tuple(np.round(self.position, 7).tolist()),
                round(self.x_rot, 7), round(self.y_rot, 7),
                round(self.aspect, 7), round(self.fov, 7))
