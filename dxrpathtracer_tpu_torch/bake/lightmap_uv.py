"""Lightmap UV atlas generation — the analytic pair atlas (host numpy).

A copy of dxrpathtracer_tpu/bake/lightmap_uv.py, so that both packages bake
against the same atlas byte for byte.

The reference runs the xatlas library over the scene to unwrap charts and emits
a duplicated "lightmapped" vertex stream with a LightmapUV attribute
(Model.cpp:608-719). xatlas is CPU C++ chart segmentation; on TPU we instead use
an *analytic* pair-of-triangles packing: triangles are packed two per square
cell of a regular grid (diagonal split), so
  - every triangle has a guaranteed-nonoverlapping atlas region,
  - the texel -> (triangle, barycentric) mapping is CLOSED FORM, which turns the
    reference's surface-map rasterization pass (SurfaceMap.hlsl:35-94) into a
    pure elementwise computation — no rasterizer needed on TPU.

Cost vs xatlas: more seams and less texel-density uniformity; benefit: zero
host preprocessing time and a bijective inverse map.
"""

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class LightmapAtlas:
    """Analytic triangle-pair atlas for T triangles."""

    num_tris: int
    cells: int          # grid is cells x cells, 2 triangles per cell
    gutter: float       # fractional inset of each cell used as seam gutter

    @property
    def cell_size(self) -> float:
        return 1.0 / self.cells

    def triangle_uvs(self) -> np.ndarray:
        """(T, 3, 2) lightmap UVs of each triangle's corners (v0, v1, v2)."""
        t = self.num_tris
        k = np.arange(t) // 2
        second = (np.arange(t) % 2) == 1
        cx = (k % self.cells).astype(np.float64)
        cy = (k // self.cells).astype(np.float64)
        s = self.cell_size
        g = self.gutter * s
        lo_x = cx * s + g
        lo_y = cy * s + g
        hi_x = (cx + 1.0) * s - g
        hi_y = (cy + 1.0) * s - g
        uv = np.zeros((t, 3, 2), np.float64)
        # First triangle of the pair: lower-left right triangle (0,0),(1,0),(0,1)
        uv[~second, 0] = np.stack([lo_x, lo_y], -1)[~second]
        uv[~second, 1] = np.stack([hi_x, lo_y], -1)[~second]
        uv[~second, 2] = np.stack([lo_x, hi_y], -1)[~second]
        # Second: upper-right mirrored (1,1),(0,1),(1,0)
        uv[second, 0] = np.stack([hi_x, hi_y], -1)[second]
        uv[second, 1] = np.stack([lo_x, hi_y], -1)[second]
        uv[second, 2] = np.stack([hi_x, lo_y], -1)[second]
        return uv.astype(np.float32)


def build_lightmap_atlas(num_tris: int, gutter: float = 0.05) -> LightmapAtlas:
    cells = max(int(math.ceil(math.sqrt((num_tris + 1) // 2))), 1)
    return LightmapAtlas(num_tris=num_tris, cells=cells, gutter=gutter)


def texel_to_triangle(atlas: LightmapAtlas, resolution: int):
    """Closed-form inverse map for every lightmap texel (host numpy).

    Returns (tri_id (S,S) int32 with -1 outside coverage,
             bary_u (S,S) f32, bary_v (S,S) f32) where (u, v) weight the
    triangle's v1/v2 as in HitAttributes barycentrics.
    """
    s = resolution
    ts = (np.arange(s, dtype=np.float64) + 0.5) / s
    v, u = np.meshgrid(ts, ts, indexing="ij")  # v = row (y), u = col (x)

    cells = atlas.cells
    cs = atlas.cell_size
    cx = np.minimum((u / cs).astype(np.int64), cells - 1)
    cy = np.minimum((v / cs).astype(np.int64), cells - 1)
    cell = cy * cells + cx

    g = atlas.gutter * cs
    inner = cs - 2.0 * g
    # Local coordinates within the gutter-inset cell, in [0,1] when inside.
    lx = (u - (cx * cs + g)) / inner
    ly = (v - (cy * cs + g)) / inner
    in_cell = (lx >= 0.0) & (lx <= 1.0) & (ly >= 0.0) & (ly <= 1.0)

    lower = (lx + ly) <= 1.0
    tri = np.where(lower, cell * 2, cell * 2 + 1)
    # Barycentrics: lower tri (v0=(0,0) v1=(1,0) v2=(0,1)): u=lx, v=ly.
    # Upper tri (v0=(1,1) v1=(0,1) v2=(1,0)): u=1-lx, v=1-ly.
    bu = np.where(lower, lx, 1.0 - lx)
    bv = np.where(lower, ly, 1.0 - ly)

    valid = in_cell & (tri < atlas.num_tris)
    tri = np.where(valid, tri, -1).astype(np.int32)
    return tri, bu.astype(np.float32), bv.astype(np.float32)
