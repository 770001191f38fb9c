# Frozen copy of dxrpathtracer_tpu_torch/core/quaternion.py for the benchmark's
# reference; it imports nothing of the program.
"""Quaternion utilities (DirectXMath conventions, row-vector matrices).

Mirrors the reference's use of XMQuaternionRotationRollPitchYaw /
XMMatrixRotationQuaternion (Graphics/Camera.cpp:221-233, SF12_Math.h) so camera and
scene transforms compose identically. Quaternions are (x, y, z, w) numpy arrays.
"""

import numpy as np


def quat_identity():
    return np.array([0.0, 0.0, 0.0, 1.0], np.float32)


def quat_from_roll_pitch_yaw(pitch, yaw, roll):
    """XMQuaternionRotationRollPitchYaw(pitch, yaw, roll): intrinsic z(roll) then
    x(pitch) then y(yaw) applied to row vectors."""
    hp, hy, hr = pitch * 0.5, yaw * 0.5, roll * 0.5
    sp, cp = np.sin(hp), np.cos(hp)
    sy, cy = np.sin(hy), np.cos(hy)
    sr, cr = np.sin(hr), np.cos(hr)
    # DirectXMath order: q = qroll * qpitch * qyaw with xyzw components:
    x = cr * sp * cy + sr * cp * sy
    y = cr * cp * sy - sr * sp * cy
    z = sr * cp * cy - cr * sp * sy
    w = cr * cp * cy + sr * sp * sy
    return np.array([x, y, z, w], np.float32)


def quat_to_mat3(q):
    """Rotation matrix for row-vector transforms (v' = v @ M), XMMatrixRotationQuaternion."""
    x, y, z, w = [float(v) for v in q]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return np.array([
        [1 - 2 * (yy + zz), 2 * (xy + wz), 2 * (xz - wy)],
        [2 * (xy - wz), 1 - 2 * (xx + zz), 2 * (yz + wx)],
        [2 * (xz + wy), 2 * (yz - wx), 1 - 2 * (xx + yy)],
    ], np.float32)


def quat_rotate(v, q):
    """Rotate row vector(s) v by quaternion q."""
    return np.asarray(v, np.float32) @ quat_to_mat3(q)


def quat_multiply(a, b):
    """XMQuaternionMultiply(a, b) = b * a composition (DirectXMath order)."""
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([
        bw * ax + bx * aw + by * az - bz * ay,
        bw * ay - bx * az + by * aw + bz * ax,
        bw * az + bx * ay - by * ax + bz * aw,
        bw * aw - bx * ax - by * ay - bz * az,
    ], np.float32)
