"""Spherical-Gaussian sky fitting — SolveSGs / SG.{h,cpp} equivalent.

A numpy copy of dxrpathtracer_tpu/sky/sg.py. The reference fits 9 spherical
Gaussians to the sky cubemap with a non-negative least squares solve
(SkyCache::Init, Skybox.cpp:216-231: SGSolveMode::NNLS,
SGDistribution::Spherical, 9 lobes). Here: lobe axes from a Fibonacci
sphere, shared sharpness chosen from the lobe density, amplitudes per RGB
channel via scipy NNLS over the cubemap samples (solid-angle weighted).
"""

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SGLobes:
    axes: np.ndarray        # (L, 3)
    sharpness: float
    amplitudes: np.ndarray  # (L, 3)

    def evaluate(self, dirs):
        """Reconstruct radiance at (..., 3) directions."""
        dots = np.asarray(dirs) @ self.axes.T  # (..., L)
        basis = np.exp(self.sharpness * (dots - 1.0))
        return basis @ self.amplitudes


def fibonacci_sphere(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + 5.0 ** 0.5) * i
    return np.stack([np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi),
                     np.cos(phi)], -1)


def solve_sg_lobes(sample_dirs, sample_values, num_lobes: int = 9,
                   weights=None) -> SGLobes:
    """NNLS fit of `num_lobes` spherical Gaussians to (N, 3) radiance samples."""
    from scipy.optimize import nnls

    axes = fibonacci_sphere(num_lobes)
    # Sharpness so adjacent lobes overlap at ~exp(-1) (standard choice for a
    # spherical distribution of L lobes).
    sharpness = float(num_lobes) / 2.0

    dots = np.asarray(sample_dirs, np.float64) @ axes.T
    basis = np.exp(sharpness * (dots - 1.0))  # (N, L)
    if weights is not None:
        w = np.sqrt(np.asarray(weights, np.float64))[:, None]
        basis = basis * w
        sample_values = np.asarray(sample_values, np.float64) * w
    amps = np.zeros((num_lobes, 3))
    for c in range(3):
        amps[:, c], _ = nnls(basis, np.asarray(sample_values, np.float64)[:, c])
    return SGLobes(axes=axes.astype(np.float32), sharpness=sharpness,
                   amplitudes=amps.astype(np.float32))


def solve_sg_from_cubemap(cube, num_lobes: int = 9, stride: int = 4) -> SGLobes:
    """Fit lobes to a (6, R, R, 3) cubemap with solid-angle texel weights."""
    from .cubemap import face_uv_to_direction

    r = cube.shape[1]
    ts = (np.arange(0, r, stride, dtype=np.float64) + 0.5) / r
    v, u = np.meshgrid(ts, ts, indexing="ij")
    uu = u * 2.0 - 1.0
    vv = v * 2.0 - 1.0
    temp = 1.0 + uu * uu + vv * vv
    w_tex = (4.0 / (np.sqrt(temp) * temp)).reshape(-1)

    dirs, vals, ws = [], [], []
    for f in range(6):
        d = face_uv_to_direction(f, u, v).reshape(-1, 3)
        dirs.append(d)
        vals.append(np.asarray(cube[f][::stride, ::stride]).reshape(-1, 3))
        ws.append(w_tex)
    return solve_sg_lobes(np.concatenate(dirs), np.concatenate(vals),
                          num_lobes, np.concatenate(ws))
