"""Scene registry — per-scene presets and the scenes the port can load.

The port of the parts of dxrpathtracer_tpu/scene/registry.py that the frame
needs: the reference's camera/sun presets (DXRPathTracer.cpp:83-105), BoxTest
(GenerateBoxTestScene), the procedural Sponza-class stand-in that backs the
benchmark when the Sponza asset is absent, and the two alpha-tested scenes
(`sponza_alpha_standin`, `tiny_alpha_scene`). Those bind the opacity mask
their caller passes (for the reference's foliage mask, a BC4 DDS:
`scene.dds.load_dds(path).data`) and otherwise the JAX package's fallbacks:
an opaque white texel (`sponza_alpha_standin`) or a 64x64 checker
(`tiny_alpha_scene`). The port reads no asset from outside the repository,
so the WhiteFurnace scene is the JAX package's sphere stand-in and SunTemple
its procedural courtyard stand-in as the JAX package builds it when it finds
no foliage DDS: opaque, four default materials. The FBX importer (the real
Sponza, SunTemple, WhiteFurnace and Stronghold) is a later slice
(ROADMAP.md, Queue 1 item 16).
"""

import dataclasses
import numpy as np

from ..app.settings import Scenes
from ..core.quaternion import quat_from_roll_pitch_yaw
from .build import build_scene
from .procedural import (MeshData, box_test_meshes, make_box, make_plane,
                         make_sphere)
from .textures import AtlasBuilder, default_material_table
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


def _white_furnace_standin_meshes() -> list[MeshData]:
    return [make_sphere(1.0, (0.0, 0.0, 0.0), n_lat=32, n_lon=64)]


def _suntemple_standin_meshes(target_tris: int = 240_000) -> list[MeshData]:
    """Procedural temple courtyard for the SunTemple asset, laid out for the
    reference camera preset (-1, 5.5, 12) yaw 3.0 / pitch 0.2
    (DXRPathTracer.cpp:96-97): the camera stands at the courtyard entrance
    looking down the processional axis (-z) at a stepped temple.
    Deterministic (seeded)."""
    rng = np.random.default_rng(4321)
    meshes = []
    # courtyard floor + low perimeter walls
    meshes.append(make_box((44.0, 0.5, 50.0), (0.0, -0.25, -5.0)))
    for sx in (-22.0, 22.0):
        meshes.append(make_box((0.6, 6.0, 50.0), (sx, 3.0, -5.0)))
    meshes.append(make_box((44.0, 6.0, 0.6), (0.0, 3.0, -30.0)))
    # stepped temple platform at the end of the axis
    for i, (w, d) in enumerate([(20.0, 12.0), (17.0, 10.0), (14.0, 8.0)]):
        meshes.append(make_box((w, 1.0, d), (0.0, 0.5 + i, -20.0)))
    # cella + roof slab
    meshes.append(make_box((9.0, 6.0, 6.0), (0.0, 6.0, -20.5)))
    meshes.append(make_box((11.0, 0.8, 7.5), (0.0, 9.4, -20.5)))
    # portico columns across the temple front
    for x in np.linspace(-6.0, 6.0, 5):
        meshes.append(make_box((0.9, 6.0, 0.9), (float(x), 6.0, -16.8)))
    # flanking colonnades along the processional axis, with capitals
    for x in (-9.0, 9.0):
        for z in np.linspace(8.0, -12.0, 9):
            meshes.append(make_box((0.8, 5.0, 0.8), (x, 2.5, float(z))))
            meshes.append(make_box((1.2, 0.4, 1.2), (x, 5.2, float(z))))
    # obelisk pair framing the entrance
    for x in (-4.0, 4.0):
        meshes.append(make_box((0.9, 7.0, 0.9), (x, 3.5, 6.0)))
        meshes.append(make_box((0.5, 1.2, 0.5), (x, 7.6, 6.0)))
    # ornamental spheres (braziers/statuary) to reach the target tri count
    base = sum(m.indices.size // 3 for m in meshes)
    n_spheres = 56
    tris_per = max((target_tris - base) // n_spheres, 8)
    n_lat = max(int(np.sqrt(tris_per / 4)), 3)
    n_lon = 2 * n_lat
    for _ in range(n_spheres):
        pos = (float(rng.uniform(-18, 18)), float(rng.uniform(0.4, 8.0)),
               float(rng.uniform(-28, 8)))
        meshes.append(make_sphere(float(rng.uniform(0.3, 1.0)), pos,
                                  n_lat=n_lat, n_lon=n_lon))
    return meshes


def _suntemple_standin_scene() -> Scene:
    """The SunTemple stand-in: the courtyard plus crossed tree cards along
    the colonnades (materials 1-2) and the soul tree's two large cards over
    the courtyard centre (material 3). The JAX package binds the asset's BC4
    foliage opacity maps to materials 1-3 where it finds them; without them
    (as here: the port reads no asset) all four materials are the defaults
    and the scene is opaque."""
    meshes = _suntemple_standin_meshes()
    rng = np.random.RandomState(11)
    for _ in range(96):
        side = rng.choice([-1.0, 1.0])
        pos = (float(side * rng.uniform(12.0, 19.0)),
               float(rng.uniform(1.0, 5.0)),
               float(rng.uniform(-26.0, 7.0)))
        size = float(rng.uniform(1.5, 3.5))
        yaw = float(rng.uniform(0.0, np.pi))
        mat = int(rng.randint(1, 3))
        for dy in (0.0, np.pi / 2.0):
            q = quat_from_roll_pitch_yaw(np.pi / 2.0, yaw + dy, 0.0)
            meshes.append(make_plane((size, size), pos, orientation=q,
                                     material_idx=mat))
    for yaw in (0.3, 0.3 + np.pi / 2.0):
        q = quat_from_roll_pitch_yaw(np.pi / 2.0, yaw, 0.0)
        meshes.append(make_plane((7.0, 7.0), (0.0, 7.0, -4.0),
                                 orientation=q, material_idx=3))
    builder = AtlasBuilder()
    materials = default_material_table(4, builder)
    return build_scene(meshes, materials=materials, atlas_builder=builder)


def alpha_materials(builder: AtlasBuilder, name: str, mask):
    """Two default materials, material 1 opacity-mapped by `mask` ((H, W, 1)
    f32, added to the atlas as `name`) or, for None, by the default white
    texel."""
    materials = default_material_table(2, builder)
    op_idx = builder.add(name, mask) if mask is not None else \
        builder.default_white
    opacity = np.asarray(materials.opacity).copy()
    opacity[1] = op_idx
    has_op = np.asarray(materials.has_opacity).copy()
    has_op[1] = True
    return dataclasses.replace(materials, opacity=opacity,
                               has_opacity=has_op)


def sponza_alpha_standin(num_cards: int = 384, seed: int = 7,
                         opacity_mask: np.ndarray | None = None):
    """The Sponza-class stand-in plus instanced alpha-tested foliage cards
    (material 1, opacity-mapped: alpha-test hit records,
    DXRPathTracer.cpp:1176-1199) bound to `opacity_mask` ((H, W, 1) f32;
    the JAX package binds SunTemple's BC4 foliage map), or to an opaque
    white texel when it is None. Returns (scene, preset) like load_scene.

    The JAX package can split the cards into an opaque and an alpha part
    (`alphasplit.maybe_split_alpha`, off unless DXRPT_ALPHA_SPLIT is set);
    that belongs to the split-alpha engine (ROADMAP.md Queue 1 item 12) and
    is not ported, so the scene is the JAX package's default one."""
    meshes = _sponza_standin_meshes()
    rng = np.random.RandomState(seed)
    for _ in range(num_cards):
        pos = (rng.uniform(-10.0, 10.0), rng.uniform(0.3, 7.0),
               rng.uniform(-4.5, 4.5))
        size = rng.uniform(0.6, 1.6)
        # stand the xz-plane card upright with a random yaw
        q = quat_from_roll_pitch_yaw(np.pi / 2.0,
                                     rng.uniform(0.0, np.pi), 0.0)
        meshes.append(make_plane((size, size), pos, orientation=q,
                                 material_idx=1))
    builder = AtlasBuilder()
    materials = alpha_materials(builder, "tree_branches_opacity",
                                opacity_mask)
    scene = build_scene(meshes, materials=materials, atlas_builder=builder)
    return scene, PRESETS[Scenes.Sponza]


def checker_mask(size: int = 64, cell: int = 8) -> np.ndarray:
    """(size, size, 1) f32 checkerboard of 0 and 1 in cell x cell squares:
    tiny_alpha_scene's default opacity."""
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    return (((yy // cell + xx // cell) % 2).astype(np.float32))[..., None]


def tiny_alpha_scene(opacity_mask: np.ndarray | None = None):
    """A ground plane and three upright opacity-mapped cards (~10
    triangles): the alpha test without a 246k-triangle build. Binds
    `opacity_mask` ((H, W, 1) f32), else a 64x64 checker mask."""
    meshes = [make_plane((10.0, 10.0), (0.0, 0.0, 0.0), material_idx=0)]
    for k, x in enumerate((-1.5, 0.0, 1.5)):
        q = quat_from_roll_pitch_yaw(np.pi / 2.0, 0.35 * k, 0.0)
        meshes.append(make_plane((1.5, 1.5), (x, 0.8, 0.5 * k),
                                 orientation=q, material_idx=1))
    builder = AtlasBuilder()
    mask = checker_mask() if opacity_mask is None else opacity_mask
    materials = alpha_materials(builder, "alpha_card_opacity", mask)
    scene = build_scene(meshes, materials=materials, atlas_builder=builder)
    return scene, PRESETS[Scenes.Sponza]


def load_scene(scene_enum: Scenes) -> tuple[Scene, ScenePreset]:
    """Returns (scene of CPU tensors, preset)."""
    preset = PRESETS[scene_enum]
    if scene_enum == Scenes.BoxTest:
        return build_scene(box_test_meshes()), preset
    if scene_enum == Scenes.Sponza:
        return build_scene(_sponza_standin_meshes()), preset
    if scene_enum == Scenes.WhiteFurnace:
        return build_scene(_white_furnace_standin_meshes()), preset
    if scene_enum == Scenes.SunTemple:
        return _suntemple_standin_scene(), preset
    raise NotImplementedError(
        f"{preset.name}: the port has no stand-in for it; its FBX asset "
        "needs the FBX importer, ROADMAP.md Queue 1 item 16")
