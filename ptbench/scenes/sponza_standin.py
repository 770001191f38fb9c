"""The Sponza-class stand-in: the procedural atrium of 246,084 triangles
under Sponza's 25 textured materials.

The meshes are a frozen copy of dxrpathtracer_tpu_torch/scene/registry.py:
95-121 (`_sponza_standin_meshes`); the materials and their maps, at the
traffic's `texture_size`, come from _sponza_materials.py. Deterministic:
the sphere field and the maps are drawn from fixed seeds of their own, not
the run's.
"""

import numpy as np

from . import _sponza_materials
from ._materials import SceneDesc
from ._procedural import make_box, make_sphere


def meshes(target_tris: int = 260_000) -> list:
    rng = np.random.default_rng(1234)
    out = []
    # Floor + walls forming an atrium ~ (36 x 14 x 18) like scaled Sponza
    out.append(make_box((36.0, 0.5, 18.0), (0.0, -0.25, 0.0)))
    for sx, sz in [(-18.0, 0.0), (18.0, 0.0)]:
        out.append(make_box((0.5, 14.0, 18.0), (sx, 7.0, sz)))
    for sz in (-9.0, 9.0):
        out.append(make_box((36.0, 14.0, 0.5), (0.0, 7.0, sz)))
    # Two colonnade rows of pillars
    for x in np.linspace(-15, 15, 11):
        for z in (-5.0, 5.0):
            out.append(make_box((0.8, 9.0, 0.8), (float(x), 4.5, z)))
    # Dense sphere field to reach the target triangle count
    base = sum(m.indices.size // 3 for m in out)
    n_spheres = 60
    tris_per = max((target_tris - base) // n_spheres, 8)
    n_lat = max(int(np.sqrt(tris_per / 4)), 3)
    n_lon = 2 * n_lat
    for _ in range(n_spheres):
        pos = (float(rng.uniform(-16, 16)), float(rng.uniform(0.5, 12.0)),
               float(rng.uniform(-8, 8)))
        out.append(make_sphere(float(rng.uniform(0.3, 1.2)), pos,
                               n_lat=n_lat, n_lon=n_lon))
    return out


def build(traffic) -> SceneDesc:
    textures, materials = _sponza_materials.materials(
        int(traffic["texture_size"]))
    return SceneDesc(meshes=_sponza_materials.assign(meshes()),
                     textures=textures, materials=materials)
