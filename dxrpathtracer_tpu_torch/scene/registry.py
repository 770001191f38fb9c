"""Scene registry — per-scene presets and the scenes the port can load.

The port of the parts of dxrpathtracer_tpu/scene/registry.py that the
benchmark frame needs: the reference's camera/sun presets
(DXRPathTracer.cpp:83-105), BoxTest (GenerateBoxTestScene) and the procedural
Sponza-class stand-in that backs the benchmark when the Sponza asset is absent.
The FBX importer, the WhiteFurnace/SunTemple/Stronghold stand-ins and the
alpha-tested scenes are later slices of the port (ROADMAP.md, Queue 1).
"""

import dataclasses

import numpy as np

from ..app.settings import Scenes
from .build import build_scene
from .procedural import MeshData, box_test_meshes, make_box, make_sphere
from .types import Scene


@dataclasses.dataclass(frozen=True)
class ScenePreset:
    name: str
    scene_enum: Scenes
    camera_position: tuple
    camera_rotation: tuple  # (x_rot, y_rot)
    sun_direction: tuple


PRESETS = {
    Scenes.Sponza: ScenePreset(
        "Sponza", Scenes.Sponza, (-11.5, 1.85, -0.45), (0.0, 1.544),
        (0.26, 0.987, -0.16)),
    Scenes.SunTemple: ScenePreset(
        "SunTemple", Scenes.SunTemple, (-1.0, 5.5, 12.0), (0.2, 3.0),
        (-0.133022308, 0.642787635, 0.75440651)),
    Scenes.BoxTest: ScenePreset(
        "BoxTest", Scenes.BoxTest, (0.0, 2.5, -10.0), (0.0, 0.0),
        (0.26, 0.987, -0.16)),
    Scenes.WhiteFurnace: ScenePreset(
        "WhiteFurnace", Scenes.WhiteFurnace, (0.0, 0.0, -3.0), (0.0, 0.0),
        (0.0, 1.0, 0.0)),
    Scenes.Stronghold: ScenePreset(
        "Stronghold", Scenes.Stronghold, (0.0, 0.0, -30.0), (0.0, 0.0),
        (-0.218, 0.5, -0.839)),
}


def _sponza_standin_meshes(target_tris: int = 260_000) -> list[MeshData]:
    """Procedural atrium with Sponza-class triangle count + occlusion structure
    (246,084 triangles at the default target). Deterministic (seeded)."""
    rng = np.random.default_rng(1234)
    meshes = []
    # Floor + walls forming an atrium ~ (36 x 14 x 18) like scaled Sponza
    meshes.append(make_box((36.0, 0.5, 18.0), (0.0, -0.25, 0.0)))
    for sx, sz in [(-18.0, 0.0), (18.0, 0.0)]:
        meshes.append(make_box((0.5, 14.0, 18.0), (sx, 7.0, sz)))
    for sz in (-9.0, 9.0):
        meshes.append(make_box((36.0, 14.0, 0.5), (0.0, 7.0, sz)))
    # Two colonnade rows of pillars
    for x in np.linspace(-15, 15, 11):
        for z in (-5.0, 5.0):
            meshes.append(make_box((0.8, 9.0, 0.8), (float(x), 4.5, z)))
    # Dense sphere field to reach target triangle count (drapes/props stand-in)
    base = sum(m.indices.size // 3 for m in meshes)
    n_spheres = 60
    tris_per = max((target_tris - base) // n_spheres, 8)
    n_lat = max(int(np.sqrt(tris_per / 4)), 3)
    n_lon = 2 * n_lat
    for _ in range(n_spheres):
        pos = (float(rng.uniform(-16, 16)), float(rng.uniform(0.5, 12.0)),
               float(rng.uniform(-8, 8)))
        meshes.append(make_sphere(float(rng.uniform(0.3, 1.2)), pos,
                                  n_lat=n_lat, n_lon=n_lon))
    return meshes


def load_scene(scene_enum: Scenes) -> tuple[Scene, ScenePreset]:
    """Returns (scene of CPU tensors, preset)."""
    preset = PRESETS[scene_enum]
    if scene_enum == Scenes.BoxTest:
        return build_scene(box_test_meshes()), preset
    if scene_enum == Scenes.Sponza:
        return build_scene(_sponza_standin_meshes()), preset
    raise NotImplementedError(
        f"{preset.name}: the port loads only BoxTest and the Sponza-class "
        "stand-in; the FBX importer and the other stand-ins are ROADMAP.md "
        "Queue 1 item 16")
