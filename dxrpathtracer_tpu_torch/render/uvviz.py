"""Lightmap UV layout visualization (UVVisualizer.hlsl equivalent).

A numpy copy of dxrpathtracer_tpu/render/uvviz.py. The reference renders the
lightmapped geometry's UVs as a wireframe into a texture (VisualizeUVs,
DXRPathTracer.cpp:540-573 + UVVisualizer.hlsl:18,31). Here the atlas's
texel -> triangle map (bake/surface_map.atlas_texel_map) marks coverage and
edge proximity directly.
"""

import numpy as np

from ..bake.surface_map import atlas_texel_map


def visualize_uvs(atlas, resolution: int = 1024,
                  edge_width: float = 0.02) -> np.ndarray:
    """(S, S, 3) float image in [0, 1]: charts tinted per triangle, edges
    drawn bright (the wireframe equivalent), uncovered texels black."""
    tri, bu, bv = atlas_texel_map(atlas, resolution)
    covered = tri >= 0

    # barycentric distance to the nearest edge
    bw = 1.0 - bu - bv
    edge_d = np.minimum(np.minimum(bu, bv), bw)
    is_edge = covered & (edge_d < edge_width)

    # deterministic per-triangle tint (hash -> pastel color)
    t = np.maximum(tri, 0).astype(np.uint32)
    h = (t * np.uint32(2654435761)) & np.uint32(0xFFFFFF)
    r = ((h >> 16) & 0xFF).astype(np.float32) / 255.0
    g = ((h >> 8) & 0xFF).astype(np.float32) / 255.0
    b = (h & 0xFF).astype(np.float32) / 255.0
    img = np.stack([0.25 + 0.5 * r, 0.25 + 0.5 * g, 0.25 + 0.5 * b], -1)
    img[~covered] = 0.0
    img[is_edge] = 1.0
    return img.astype(np.float32)
