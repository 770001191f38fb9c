"""Surface-map generation (the bake G-buffer).

The port of dxrpathtracer_tpu/bake/surface_map.py. Parity with
RenderSurfaceMap/SurfaceMap.hlsl:35-94: for every lightmap texel, world
position (w = coverage), normalized world normal, and albedo sampled at the
surface's texture UV. The texel -> (triangle, barycentric) map is built on the
host (closed form for the pair atlas, rasterized for the charted one); the
rest is row gathers (accel/gather.py) and elementwise torch on the scene's
device.
"""

import numpy as np
import torch

from ..accel.gather import row_gather
from ..core.math3 import dot3, sqrt
from ..scene.textures import sample_bilinear_wrap
from .charts import ChartedAtlas, rasterize_texel_map
from .lightmap_uv import texel_to_triangle


def atlas_texel_map(atlas, resolution: int):
    """(tri_map, bu, bv) host arrays for either atlas flavor: closed form for
    the analytic pair atlas, rasterization + gutter dilation for
    ChartedAtlas."""
    if isinstance(atlas, ChartedAtlas):
        tri_map, bu, bv, _cov = rasterize_texel_map(atlas.tri_uv, resolution)
        return tri_map, bu, bv
    return texel_to_triangle(atlas, resolution)


def build_surface_maps(scene, texel_map):
    """Surface maps of `scene` (the port's Scene, on its device) at the
    texel map's resolution S, from atlas_texel_map's (tri_map, bu, bv), as a
    dict: position (S,S,4) [xyz | coverage], normal (S,S,3), albedo
    (S,S,3)."""
    dev = scene.tri_idx.device
    tri_map, bu, bv = texel_map
    s = tri_map.shape[0]
    tri_map = torch.from_numpy(np.ascontiguousarray(tri_map).reshape(-1)).to(dev)
    bu = torch.from_numpy(np.ascontiguousarray(bu).reshape(-1)).to(dev)
    bv = torch.from_numpy(np.ascontiguousarray(bv).reshape(-1)).to(dev)

    safe_tri = torch.clamp_min(tri_map, 0)
    tri = row_gather(scene.tri_idx, safe_tri)  # (N, 3) int32
    corners = [tri[:, k].contiguous() for k in range(3)]
    w = (1.0 - bu - bv)[..., None]
    uu = bu[..., None]
    vv = bv[..., None]

    def lerp3(arr):
        return (row_gather(arr, corners[0]) * w
                + row_gather(arr, corners[1]) * uu
                + row_gather(arr, corners[2]) * vv)

    pos = lerp3(scene.positions)
    nrm = lerp3(scene.normals)
    nrm = nrm / torch.clamp_min(sqrt(dot3(nrm, nrm, keepdims=True)), 1e-12)
    uv = lerp3(scene.uvs)

    mat = row_gather(scene.tri_material[:, None], safe_tri)[:, 0]
    albedo = sample_bilinear_wrap(scene.texels, scene.packed_meta, mat,
                                  uv)[..., :3]

    coverage = (tri_map >= 0).to(torch.float32)[..., None]
    return {
        "position": torch.cat([pos, coverage], -1).reshape(s, s, 4),
        "normal": (nrm * coverage).reshape(s, s, 3),
        "albedo": (albedo * coverage).reshape(s, s, 3),
    }
