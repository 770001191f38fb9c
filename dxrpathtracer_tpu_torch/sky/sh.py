"""Spherical harmonics (order 3 / SH9) — Graphics/SH.{h,cpp} + Shaders/SH.hlsl.

A numpy copy of dxrpathtracer_tpu/sky/sh.py. SkyCache projects the sky
cubemap onto SH9 (Skybox.cpp:166-199); the raster path's ambient term
evaluates it per pixel (render/raster.py, on torch tensors).
"""

import numpy as np


def sh9_basis(d):
    """Real SH basis, order 3, for (..., 3) unit directions -> (..., 9)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return np.stack([
        np.full_like(x, 0.282095),
        0.488603 * y,
        0.488603 * z,
        0.488603 * x,
        1.092548 * x * y,
        1.092548 * y * z,
        0.315392 * (3.0 * z * z - 1.0),
        1.092548 * x * z,
        0.546274 * (x * x - y * y),
    ], axis=-1)


def project_cubemap_sh9(cube):
    """Project a (6, R, R, 3) cubemap onto SH9 with solid-angle texel weights
    (Skybox.cpp:166-199). Returns (9, 3)."""
    r = cube.shape[1]
    ts = (np.arange(r, dtype=np.float64) + 0.5) / r
    v, u = np.meshgrid(ts, ts, indexing="ij")
    uu = u * 2.0 - 1.0
    vv = v * 2.0 - 1.0
    temp = 1.0 + uu * uu + vv * vv
    weight = 4.0 / (np.sqrt(temp) * temp)  # (R, R)

    from .cubemap import face_uv_to_direction

    sh = np.zeros((9, 3), np.float64)
    weight_sum = 0.0
    for f in range(6):
        d = face_uv_to_direction(f, u, v)  # (R, R, 3)
        basis = sh9_basis(d)  # (R, R, 9)
        rad = np.asarray(cube[f], np.float64)  # (R, R, 3)
        sh += np.einsum("yxk,yxc,yx->kc", basis, rad, weight)
        weight_sum += weight.sum()
    sh *= (4.0 * 3.14159) / weight_sum
    return sh.astype(np.float32)


# Cosine-lobe convolution coefficients for SH9 irradiance (SH.hlsl:437-486).
_A = np.array([np.pi,
               2.0943951, 2.0943951, 2.0943951,
               0.785398, 0.785398, 0.785398, 0.785398, 0.785398], np.float32)


def sh9_irradiance(sh, normal):
    """Evaluate irradiance for (..., 3) normals from (9, 3) SH coefficients."""
    basis = sh9_basis(np.asarray(normal, np.float32))
    return np.einsum("...k,kc,k->...c", basis, sh, _A)
