"""Scene registry — per-scene presets and the scenes the port can load.

The port of dxrpathtracer_tpu/scene/registry.py: the reference's camera/sun
presets with their FBX paths and scales (DXRPathTracer.cpp:83-105), BoxTest
(GenerateBoxTestScene), the FBX route (meshes, materials' textures, spot
lights; CreateWithAssimp parity) with its binary cache, the procedural
stand-ins, and the two alpha-tested scenes (`sponza_alpha_standin`,
`tiny_alpha_scene`). Those bind the opacity mask their caller passes (for
the reference's foliage mask, a BC4 DDS: `scene.dds.load_dds(path).data`)
and otherwise the JAX package's fallbacks: an opaque white texel
(`sponza_alpha_standin`) or a 64x64 checker (`tiny_alpha_scene`).

The asset root is a parameter (`load_scene(..., asset_root=DIR)`, the CLI's
`--asset-root`); with none the port reads nothing outside the repository and
every FBX scene is its stand-in, as the JAX package builds it on a host
without the assets: Sponza and Stronghold the Sponza-class atrium,
WhiteFurnace a sphere, SunTemple the procedural courtyard (opaque: the
foliage DDS it binds lives under the asset root too).
"""

import dataclasses
import logging
import os
from pathlib import Path

import numpy as np

from ..app.settings import Scenes
from ..core.quaternion import quat_from_roll_pitch_yaw
from .alphasplit import maybe_split_alpha
from .build import build_scene
from .procedural import (MeshData, box_test_meshes, make_box, make_plane,
                         make_sphere)
from .textures import AtlasBuilder, default_material_table
from .types import MaterialTable, Scene, make_spot_lights

log = logging.getLogger(__name__)


class _WarningCounter(logging.Handler):
    """Counts WARNING+ records during a scene load (cache-write gate)."""

    def __init__(self):
        super().__init__(level=logging.WARNING)
        self.count = 0

    def emit(self, record):
        self.count += 1


def _strict_default() -> bool:
    return bool(os.environ.get("DXRPT_STRICT_SCENE_LOAD"))


@dataclasses.dataclass(frozen=True)
class ScenePreset:
    name: str
    scene_enum: Scenes
    camera_position: tuple
    camera_rotation: tuple  # (x_rot, y_rot)
    sun_direction: tuple
    scene_scale: float
    fbx_path: str | None = None  # relative to the asset root
    texture_dir: str | None = None  # relative to the FBX's directory
    force_white_furnace: bool = False


PRESETS = {
    Scenes.Sponza: ScenePreset(
        "Sponza", Scenes.Sponza, (-11.5, 1.85, -0.45), (0.0, 1.544),
        (0.26, 0.987, -0.16), 0.01,
        fbx_path="Content/Models/Sponza/Sponza_NoSpotLight.fbx",
        texture_dir="Textures"),
    Scenes.SunTemple: ScenePreset(
        "SunTemple", Scenes.SunTemple, (-1.0, 5.5, 12.0), (0.2, 3.0),
        (-0.133022308, 0.642787635, 0.75440651), 0.005,
        fbx_path="Content/Models/SunTemple/SunTemple.fbx",
        texture_dir="Textures"),
    Scenes.BoxTest: ScenePreset(
        "BoxTest", Scenes.BoxTest, (0.0, 2.5, -10.0), (0.0, 0.0),
        (0.26, 0.987, -0.16), 1.0),
    Scenes.WhiteFurnace: ScenePreset(
        "WhiteFurnace", Scenes.WhiteFurnace, (0.0, 0.0, -3.0), (0.0, 0.0),
        (0.0, 1.0, 0.0), 1.0,
        fbx_path="Content/Models/WhiteFurnace/WhiteFurnace.fbx",
        force_white_furnace=True),
    Scenes.Stronghold: ScenePreset(
        "Stronghold", Scenes.Stronghold, (0.0, 0.0, -30.0), (0.0, 0.0),
        (-0.218, 0.5, -0.839), 0.1,
        fbx_path="Content/Models/theInn/source/theInn.fbx",
        texture_dir="../textures"),
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


# every real texture the reference carries for SunTemple, in material order
# (materials 1..3 of the stand-in), relative to the asset root
SUNTEMPLE_FOLIAGE_DDS = (
    "Content/Models/SunTemple/Textures/T_M_Tree_Branches_0_A.dds",
    "Content/Models/SunTemple/Textures/T_M_Tree_Branches_Inst_0_A.dds",
    "Content/Models/SunTemple/Textures/T_Soul_Tree011M_Inst_0_A.dds",
)


def _suntemple_standin_scene(asset_root=None) -> Scene:
    """The SunTemple stand-in: the courtyard plus crossed tree cards along
    the colonnades (materials 1-2) and the soul tree's two large cards over
    the courtyard centre (material 3), bound to the asset's BC4 foliage
    opacity maps (SUNTEMPLE_FOLIAGE_DDS under `asset_root`) where they
    exist; without them all four materials are the defaults and the scene
    is opaque."""
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
    opacity = np.asarray(materials.opacity).copy()
    has_op = np.asarray(materials.has_opacity).copy()
    for mat_idx, rel in enumerate(SUNTEMPLE_FOLIAGE_DDS, start=1):
        if asset_root is not None and (Path(asset_root) / rel).exists():
            from .dds import load_dds
            mask = load_dds(Path(asset_root) / rel).data  # (H, W, 1) BC4U
            opacity[mat_idx] = builder.add(f"suntemple_opacity_{mat_idx}",
                                           mask)
            has_op[mat_idx] = True
    materials = dataclasses.replace(materials, opacity=opacity,
                                    has_opacity=has_op)
    if has_op.any():
        meshes, materials, _ = maybe_split_alpha(meshes, materials, builder)
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


def sponza_card_meshes(num_cards: int = 384, seed: int = 7) -> list[MeshData]:
    """`sponza_alpha_standin`'s foliage cards (material 1): upright squares
    at seeded positions, sizes and yaws in the atrium."""
    rng = np.random.RandomState(seed)
    meshes = []
    for _ in range(num_cards):
        pos = (rng.uniform(-10.0, 10.0), rng.uniform(0.3, 7.0),
               rng.uniform(-4.5, 4.5))
        size = rng.uniform(0.6, 1.6)
        # stand the xz-plane card upright with a random yaw
        q = quat_from_roll_pitch_yaw(np.pi / 2.0,
                                     rng.uniform(0.0, np.pi), 0.0)
        meshes.append(make_plane((size, size), pos, orientation=q,
                                 material_idx=1))
    return meshes


def sponza_alpha_standin(num_cards: int = 384, seed: int = 7,
                         opacity_mask: np.ndarray | None = None):
    """The Sponza-class stand-in plus instanced alpha-tested foliage cards
    (material 1, opacity-mapped: alpha-test hit records,
    DXRPathTracer.cpp:1176-1199) bound to `opacity_mask` ((H, W, 1) f32;
    the JAX package binds SunTemple's BC4 foliage map), or to an opaque
    white texel when it is None. Returns (scene, preset) like load_scene.
    Where DXRPT_ALPHA_SPLIT is "1" the cards are subdivided against the
    mask at load time (scene/alphasplit.py), as in the JAX package."""
    meshes = _sponza_standin_meshes() + sponza_card_meshes(num_cards, seed)
    builder = AtlasBuilder()
    materials = alpha_materials(builder, "tree_branches_opacity",
                                opacity_mask)
    meshes, materials, _ = maybe_split_alpha(meshes, materials, builder)
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


def _load_image_linear(path, srgb: bool) -> np.ndarray:
    """Decode an image file to (H, W, C) float32, optionally sRGB->linear.

    .dds goes through the port's BC decoder (Textures.cpp:44-67 loads DDS via
    DirectXTex); everything else through PIL. `srgb` mirrors the reference's
    ForceSRGB forcing for albedo maps."""
    from .textures import srgb_to_linear
    if str(path).lower().endswith(".dds"):
        from .dds import load_dds
        im = load_dds(path)
        arr = im.data
        srgb = srgb or im.is_srgb  # _SRGB formats store sRGB-encoded texels
    else:
        from PIL import Image
        img = Image.open(path)
        if img.mode not in ("RGB", "RGBA", "L"):
            img = img.convert("RGBA")
        arr = np.asarray(img).astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    if srgb and arr.shape[-1] >= 3:
        arr = np.concatenate([srgb_to_linear(arr[..., :3]), arr[..., 3:]], -1)
    elif srgb:
        arr = srgb_to_linear(arr)
    return arr


# Some exporters (3dsMax) leave Texture filenames empty; the loader then
# keyword-matches files in the scene's texture directory.
_SLOT_KEYWORDS = {"albedo": ("diffuse", "albedo", "basecolor", "color"),
                  "normal": ("normal", "bump"),
                  "roughness": ("rough", "specular"),
                  "metallic": ("metal",),
                  "opacity": ("opacity", "alpha"),
                  "emissive": ("emissive", "emission")}
_IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg", ".tga", ".bmp", ".dds")


def _load_fbx_scene_full(preset: ScenePreset, asset_root,
                         strict: bool = False) -> Scene:
    """FBX load with materials/textures/lights (CreateWithAssimp parity):
    the FBX at asset_root / preset.fbx_path, its textures in
    preset.texture_dir beside it."""
    import json

    from .fbx import load_fbx_scene

    path = Path(asset_root) / preset.fbx_path
    fbx = load_fbx_scene(path, scene_scale=preset.scene_scale)

    tex_dir = path.parent
    if preset.texture_dir:
        tex_dir = (path.parent / preset.texture_dir).resolve()

    builder = AtlasBuilder()
    n_mats = len(fbx.material_textures)
    table = {k: np.zeros(n_mats, np.int32) for k in _SLOT_KEYWORDS}
    defaults = {"albedo": builder.default_albedo_srgb,  # ForceSRGB=true scenes
                "normal": builder.default_normal,
                "roughness": builder.default_roughness,
                "metallic": builder.default_black,
                "opacity": builder.default_white,
                "emissive": builder.default_black}
    dir_files = sorted(p.name for p in tex_dir.glob("*")) \
        if tex_dir.exists() else []

    def dir_fallback(slot):
        for kw in _SLOT_KEYWORDS[slot]:
            for f in dir_files:
                if kw in f.lower() and f.lower().endswith(_IMAGE_SUFFIXES):
                    return f
        return None

    # Per-color-map roughness bindings of the content-fixup tool
    # (tools/fix_roughness_maps.py of the JAX package, the
    # Fix*RoughnessMaps.py analog): consulted when a material has no
    # explicit roughness slot.
    rough_bindings = {}
    bindings_path = tex_dir / "roughness_bindings.json"
    if bindings_path.exists():
        try:
            rough_bindings = json.loads(bindings_path.read_text())
        except (OSError, ValueError) as e:
            if strict:
                raise
            log.warning("unreadable %s: %s", bindings_path, e)

    has_opacity = np.zeros(n_mats, bool)
    for mi, slots in enumerate(fbx.material_textures):
        for slot in table:
            name = slots.get(slot)
            if not name and slot == "roughness" and slots.get("albedo"):
                name = rough_bindings.get(slots["albedo"])
            if not name:
                name = dir_fallback(slot)
            tex_idx = defaults[slot]
            if name:
                cand = tex_dir / name
                if cand.exists():
                    try:
                        img = _load_image_linear(cand, srgb=(slot == "albedo"))
                        tex_idx = builder.add(name, img)
                        if slot == "opacity":
                            has_opacity[mi] = True
                    except Exception as e:  # any decoder's failure
                        if strict:
                            raise
                        log.warning("texture decode failed for %s (%s slot "
                                    "of material %d): %s — using default "
                                    "texel", cand, slot, mi, e)
            table[slot][mi] = tex_idx

    materials = MaterialTable(has_opacity=has_opacity, **table)
    lights = make_spot_lights(
        positions=[l.position for l in fbx.spot_lights],
        directions=[-l.direction for l in fbx.spot_lights],  # :976 negation
        intensities=[l.color * l.intensity * 2500.0 for l in fbx.spot_lights],
        angular_attenuation=[[l.inner_angle, l.outer_angle]
                             for l in fbx.spot_lights],
    ) if fbx.spot_lights else make_spot_lights()
    # alpha-tested meshes are subdivided where DXRPT_ALPHA_SPLIT is "1"
    # (scene/alphasplit.py; the scene cache's key holds the switch)
    meshes = fbx.meshes
    if has_opacity.any():
        meshes, materials, _ = maybe_split_alpha(meshes, materials, builder)
    return build_scene(meshes, materials=materials, atlas_builder=builder,
                       lights=lights)


def _fbx_file(preset: ScenePreset, asset_root) -> Path | None:
    """The preset's FBX under `asset_root`, or None: no asset root, no FBX
    for the scene, or (with a warning) no such file."""
    if asset_root is None or preset.fbx_path is None:
        return None
    path = Path(asset_root) / preset.fbx_path
    if not path.exists():
        log.warning("%s: no %s under the asset root — using the procedural "
                    "stand-in", preset.name, preset.fbx_path)
        return None
    return path


def load_scene_meshes(preset: ScenePreset, strict: bool | None = None,
                      asset_root=None) -> list[MeshData]:
    """The preset's meshes only: the FBX's under `asset_root` when it
    parses, else the stand-in's."""
    strict = _strict_default() if strict is None else strict
    if preset.scene_enum == Scenes.BoxTest:
        return box_test_meshes()
    path = _fbx_file(preset, asset_root)
    if path is not None:
        try:
            from .fbx import load_fbx_meshes
            return load_fbx_meshes(path, scene_scale=preset.scene_scale)
        except Exception as e:  # any parse failure of the asset
            if strict:
                raise
            log.warning("FBX mesh parse failed for %s: %s — falling back "
                        "to the procedural stand-in", path, e)
    if preset.scene_enum == Scenes.WhiteFurnace:
        return _white_furnace_standin_meshes()
    if preset.scene_enum == Scenes.SunTemple:
        return _suntemple_standin_meshes()
    return _sponza_standin_meshes()


def load_scene(scene_enum: Scenes, strict: bool | None = None,
               asset_root=None) -> tuple[Scene, ScenePreset]:
    """Returns (scene of CPU tensors, preset).

    With `asset_root` (a directory laid out as the reference's, e.g.
    Content/Models/Sponza/...), the preset's FBX there is imported with its
    textures and spot lights, through the binary scene cache (scene/cache.py,
    DXRPT_SCENE_CACHE). Without one, or when the FBX is absent or fails to
    parse (with a warning), the scene is the procedural stand-in.
    strict=True (or DXRPT_STRICT_SCENE_LOAD=1) raises on FBX/texture parse
    failures instead of substituting the stand-in / default texels."""
    strict = _strict_default() if strict is None else strict
    preset = PRESETS[scene_enum]
    if scene_enum == Scenes.BoxTest:
        return build_scene(box_test_meshes()), preset
    fbx_abs = _fbx_file(preset, asset_root)
    if fbx_abs is not None:
        # Binary model cache (Model::CreateFromMeshData/Serialization.h
        # analog): content-hash keyed, best-effort, loader-versioned.
        from .cache import load_cached_scene, store_cached_scene
        cached = load_cached_scene(str(fbx_abs), preset)
        if cached is not None:
            return cached, preset
        try:
            # A DEGRADED scene (load warnings: texture decode fallbacks,
            # ...) is never cached: a later load would serve default texels
            # even after the content is fixed or strict mode is turned on.
            counter = _WarningCounter()
            log.addHandler(counter)
            try:
                scene = _load_fbx_scene_full(preset, asset_root, strict=strict)
            finally:
                log.removeHandler(counter)
            if counter.count == 0:
                store_cached_scene(str(fbx_abs), preset, scene)
            else:
                log.info("scene cache write skipped: %d load warnings",
                         counter.count)
            return scene, preset
        except Exception as e:  # any parse failure of the asset
            if strict:
                raise
            log.warning("FBX scene load failed for %s: %s — falling back "
                        "to the procedural stand-in", fbx_abs, e)
    if scene_enum == Scenes.WhiteFurnace:
        return build_scene(_white_furnace_standin_meshes()), preset
    if scene_enum == Scenes.SunTemple:
        return _suntemple_standin_scene(asset_root), preset
    # Sponza and Stronghold: the Sponza-class atrium
    return build_scene(_sponza_standin_meshes()), preset
