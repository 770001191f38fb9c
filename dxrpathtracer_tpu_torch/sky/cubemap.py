"""Cubemap sampling with D3D TextureCube face conventions.

The reference's miss/terminal shaders sample a 128x128 sky radiance cubemap with
a linear sampler at mip 0 (RayTrace.hlsl:433-434,520-521; built by SkyCache,
Graphics/Skybox.cpp:156-212). The port of dxrpathtracer_tpu/sky/cubemap.py:
the build (`face_uv_to_direction`, `build_cubemap_from_fn`) stays numpy on the
host; the tap (`sample_cubemap`) is torch, op for op the JAX version.

Data layout: (6, R, R, 3) float32, faces ordered +X, -X, +Y, -Y, +Z, -Z.
"""

import numpy as np
import torch


def direction_to_face_uv(d):
    """(..., 3) directions -> (face, u, v) per the D3D cube-map spec."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()

    # Major axis selection
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)

    ma = torch.where(is_x, ax, torch.where(is_y, ay, az))
    ma = torch.clamp_min(ma, 1e-20)

    def pick(px, nx, py, ny, pz, nz):
        return torch.where(is_x, torch.where(x >= 0, px, nx),
                           torch.where(is_y, torch.where(y >= 0, py, ny),
                                       torch.where(z >= 0, pz, nz)))

    face = pick(0, 1, 2, 3, 4, 5)
    sc = pick(-z, z, x, x, x, -x)
    tc = pick(-y, -y, z, -z, -y, -y)

    u = (sc / ma + 1.0) * 0.5
    v = (tc / ma + 1.0) * 0.5
    return face, u, v


def face_uv_to_direction(face: int, u, v):
    """Inverse mapping (host/numpy), for building cubemaps: texel center uv in
    [0,1] -> unnormalized direction on face `face`."""
    sc = u * 2.0 - 1.0
    tc = v * 2.0 - 1.0
    one = np.ones_like(sc)
    if face == 0:
        d = np.stack([one, -tc, -sc], -1)
    elif face == 1:
        d = np.stack([-one, -tc, sc], -1)
    elif face == 2:
        d = np.stack([sc, one, tc], -1)
    elif face == 3:
        d = np.stack([sc, -one, -tc], -1)
    elif face == 4:
        d = np.stack([sc, -tc, one], -1)
    else:
        d = np.stack([-sc, -tc, -one], -1)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def sample_cubemap(cube, d):
    """Bilinear cubemap fetch: cube (6, R, R, C), d (..., 3) -> (..., C)."""
    r = cube.shape[1]
    c = cube.shape[-1]
    face, u, v = direction_to_face_uv(d)

    x = u * r - 0.5
    y = v * r - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def clampi(i):
        return torch.clamp(i.to(torch.int32), 0, r - 1)

    x0i, x1i = clampi(x0), clampi(x0 + 1)
    y0i, y1i = clampi(y0), clampi(y0 + 1)

    flat = cube.reshape(-1, c)
    base = face * (r * r)

    def fetch(yi, xi):
        return flat[base + yi * r + xi]

    t00 = fetch(y0i, x0i)
    t10 = fetch(y0i, x1i)
    t01 = fetch(y1i, x0i)
    t11 = fetch(y1i, x1i)
    top = t00 + (t10 - t00) * fx
    bot = t01 + (t11 - t01) * fx
    return top + (bot - top) * fy


def build_cubemap_from_fn(fn, resolution: int = 128) -> np.ndarray:
    """Evaluate fn(directions (M,3)) -> (M,3) radiance on all texel centers."""
    out = np.zeros((6, resolution, resolution, 3), np.float32)
    ts = (np.arange(resolution, dtype=np.float32) + 0.5) / resolution
    v, u = np.meshgrid(ts, ts, indexing="ij")
    for f in range(6):
        d = face_uv_to_direction(f, u, v).reshape(-1, 3)
        out[f] = np.asarray(fn(d), np.float32).reshape(resolution, resolution, 3)
    return out
