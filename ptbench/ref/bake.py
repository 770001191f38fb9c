"""The reference of a bake cell: chosen texels of the lightmap after the
steps a run baked.

Frozen copies of dxrpathtracer_tpu_torch/bake/lightmap_uv.py
(`build_lightmap_atlas`, `texel_to_triangle`, evaluated at the chosen
texels only), bake/surface_map.py (`build_surface_maps`' position and
normal) and bake/baker.py:56-124 (`bake_sample`: the up-vector frame, the
cosine hemisphere ray of CMJ set 0, the firefly clamp against ten times
the running mean's luminance and the validity rules).
"""

import math

import numpy as np
import torch

from .cmj import sample_cmj_2d
from .common import chunks, world
from .constants import FP32Max
from .integrator import trace_paths
from .math3 import cross, dot, sqrt
from .sampling import sample_cosine_hemisphere

FIREFLY_MULTIPLIER = 10.0
MIN_LUMINANCE = 1e-4
LANES = 1 << 19  # paths traced per call
_LUMA = (0.299, 0.587, 0.114)


def luminance(rgb):
    return rgb[..., 0] * _LUMA[0] + rgb[..., 1] * _LUMA[1] + rgb[..., 2] * _LUMA[2]


def pair_atlas_cells(num_tris: int) -> int:
    return max(int(math.ceil(math.sqrt((num_tris + 1) // 2))), 1)


def texel_map(num_tris: int, resolution: int, texels, gutter: float = 0.05):
    """(tri (N,) int32, -1 outside; bu, bv (N,) f32) of the pair atlas at
    the flat texel indices `texels` (row * resolution + col)."""
    texels = np.asarray(texels, np.int64)
    s = resolution
    row, col = texels // s, texels % s
    v = (row.astype(np.float64) + 0.5) / s
    u = (col.astype(np.float64) + 0.5) / s
    cells = pair_atlas_cells(num_tris)
    cs = 1.0 / cells
    cx = np.minimum((u / cs).astype(np.int64), cells - 1)
    cy = np.minimum((v / cs).astype(np.int64), cells - 1)
    cell = cy * cells + cx
    g = gutter * cs
    inner = cs - 2.0 * g
    lx = (u - (cx * cs + g)) / inner
    ly = (v - (cy * cs + g)) / inner
    in_cell = (lx >= 0.0) & (lx <= 1.0) & (ly >= 0.0) & (ly <= 1.0)
    lower = (lx + ly) <= 1.0
    tri = np.where(lower, cell * 2, cell * 2 + 1)
    bu = np.where(lower, lx, 1.0 - lx)
    bv = np.where(lower, ly, 1.0 - ly)
    valid = in_cell & (tri < num_tris)
    tri = np.where(valid, tri, -1).astype(np.int32)
    return tri, bu.astype(np.float32), bv.astype(np.float32)


def lightmap(desc, config, traffic, texels, first_sample: int,
             num_steps: int, device, storage=torch.float32):
    """(N, 4) f32 [colorSum | validCount] of the lightmap texels `texels`
    (flat indices) after steps first_sample .. first_sample + num_steps - 1
    from a zero accumulation."""
    scene, bvh, cube, s, frame = world(desc, config, traffic, device, storage)
    res = int(config["resolution"])
    num_tris = scene.tri_idx.shape[0]
    tri_np, bu_np, bv_np = texel_map(num_tris, res, texels)
    f32 = torch.float32
    tri = torch.from_numpy(tri_np).to(device).long()
    bu = torch.from_numpy(bu_np).to(device)
    bv = torch.from_numpy(bv_np).to(device)
    corners = scene.tri_idx[torch.clamp_min(tri, 0)]
    w = (1.0 - bu - bv)[..., None]

    def lerp3(arr):
        return (arr[corners[:, 0]] * w + arr[corners[:, 1]] * bu[..., None]
                + arr[corners[:, 2]] * bv[..., None])

    coverage = (tri >= 0).to(f32)
    pos = lerp3(scene.positions)
    nrm = lerp3(scene.normals)
    nrm = nrm / torch.clamp_min(sqrt(dot(nrm, nrm))[..., None], 1e-12)
    nrm = nrm * coverage[..., None]

    n = tri.shape[0]
    nrm_len2 = dot(nrm, nrm)
    covered = (coverage > 0.0) & (nrm_len2 >= 1e-4)
    normal = nrm / sqrt(torch.clamp_min(nrm_len2, 1e-20))[..., None]
    z_up = torch.tensor([0.0, 0.0, 1.0], dtype=f32, device=device).expand(n, 3)
    x_up = torch.tensor([1.0, 0.0, 0.0], dtype=f32, device=device).expand(n, 3)
    up = torch.where((normal[:, 2].abs() < 0.999)[..., None], z_up, x_up)
    tangent = cross(up, normal)
    tangent = tangent / torch.clamp_min(sqrt(dot(tangent, tangent)),
                                        1e-12)[..., None]
    bitangent = cross(normal, tangent)
    pixel_idx = torch.as_tensor(np.asarray(texels, np.int64),
                                device=device) & 0xFFFFFFFF
    sqrt_n = int(s.sqrt_num_samples)

    # every step's radiance at once (the steps are independent until the
    # accumulation), then the accumulation step by step
    lanes = n * num_steps
    rep = lambda a: a.repeat(num_steps, *([1] * (a.dim() - 1)))  # noqa: E731
    l_pix, l_pos = rep(pixel_idx), rep(pos)
    l_t, l_b, l_n, l_cov = rep(tangent), rep(bitangent), rep(normal), rep(covered)
    l_smp = (torch.arange(num_steps, dtype=torch.int64, device=device)
             .repeat_interleave(n) + int(first_sample))
    radiance = torch.empty((lanes, 3), dtype=f32, device=device)
    for lo, hi in chunks(lanes, LANES):
        u2 = sample_cmj_2d(l_smp[lo:hi], sqrt_n, sqrt_n, l_pix[lo:hi])
        dir_ts = sample_cosine_hemisphere(u2[..., 0], u2[..., 1])
        ray_dir = (dir_ts[:, 0:1] * l_t[lo:hi] + dir_ts[:, 1:2] * l_b[lo:hi]
                   + dir_ts[:, 2:3] * l_n[lo:hi])
        ray_o = l_pos[lo:hi] + ray_dir * 1e-5
        radiance[lo:hi] = trace_paths(
            scene, bvh, cube, s, frame, ray_o, ray_dir,
            torch.full((hi - lo,), FP32Max, dtype=f32, device=device),
            l_pix[lo:hi], res * res, l_smp[lo:hi], first_set_idx=1,
            initial_is_diffuse=True, t_min0=1e-4, active0=l_cov[lo:hi])
    radiance = radiance.reshape(num_steps, n, 3)
    color_sum = torch.zeros((n, 3), dtype=f32, device=device)
    valid_count = torch.zeros(n, dtype=f32, device=device)
    for k in range(num_steps):
        avg = color_sum / torch.clamp_min(valid_count, 1.0)[..., None]
        avg_lum = luminance(avg) + 0.001
        smp_lum = luminance(radiance[k])
        clamp_scale = torch.where(
            (valid_count >= 1.0) & (smp_lum > avg_lum * FIREFLY_MULTIPLIER),
            avg_lum * FIREFLY_MULTIPLIER / torch.clamp_min(smp_lum, 1e-20),
            1.0)
        new_sample = radiance[k] * clamp_scale[..., None]
        is_nan = new_sample.isnan().any(dim=-1)
        valid = covered & ~is_nan & (luminance(new_sample) >= MIN_LUMINANCE)
        color_sum = color_sum + torch.where(valid[..., None], new_sample, 0.0)
        valid_count = valid_count + valid.to(f32)
        if storage != torch.float32:
            color_sum = color_sum.to(storage).to(f32)
    return torch.cat([color_sum, valid_count[..., None]], -1)
