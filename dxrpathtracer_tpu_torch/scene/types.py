"""Scene containers and the packed per-triangle shading rows.

The port of dxrpathtracer_tpu/scene/types.py. The reference holds the scene in
D3D12 structured buffers addressed through a bindless descriptor heap
(Model.cpp:851-881, SharedTypes.h:30-64). Here the host build (numpy) fills a
`MaterialTable` of per-slot texture indices, packs it with the atlas meta into
one int row per material (`pack_material_meta`) and packs every triangle's
shading inputs into one 256 B row (`pack_tri_shade`); `Scene` is the frozen
set of tensors the integrator reads, moved to a device with `.to(device)`.

Vertex layout parity: MeshVertex {Position, Normal, UV, Tangent, Bitangent}
(Graphics/Model.h:25-67). Triangles carry a material index.
"""

import dataclasses

import numpy as np
import torch

MAX_SPOT_LIGHTS = 32  # AppSettings.cs:92 MaxSpotLights
SPOT_LIGHT_RANGE = 7.5  # AppSettings.cs:94


@dataclasses.dataclass(frozen=True)
class MaterialTable:
    """Per-material texture slots (SharedTypes.h:30-38 Material), host numpy."""

    albedo: np.ndarray     # (M,) int32 texture indices
    normal: np.ndarray
    roughness: np.ndarray
    metallic: np.ndarray
    opacity: np.ndarray
    emissive: np.ndarray
    has_opacity: np.ndarray  # (M,) bool — alpha-test hit group


PACKED_SLOTS = ("albedo", "normal", "roughness", "metallic", "opacity",
                "emissive")


def pack_material_meta(materials: MaterialTable, atlas_meta) -> np.ndarray:
    """(M, 20) int32 fused material+atlas meta rows: (base, w, h) of each
    slot's texture in PACKED_SLOTS order at columns [3k, 3k+3), has_opacity at
    column 18."""
    atlas_meta = np.asarray(atlas_meta)
    m = np.asarray(materials.albedo).shape[0]
    packed = np.zeros((m, 20), np.int32)
    for k, slot in enumerate(PACKED_SLOTS):
        idx = np.asarray(getattr(materials, slot), np.int64)
        packed[:, 3 * k:3 * k + 3] = atlas_meta[idx]
    packed[:, 18] = np.asarray(materials.has_opacity).astype(np.int32)
    return packed


# Per-triangle packed shading row (see pack_tri_shade): 3 x 14-float vertex
# blocks [pos(3) nrm(3) uv(2) tan(3) bit(3)], material id, pad, 20-int meta.
TRI_SHADE_WIDTH = 64          # f32 slots (256 B row)
TRI_SHADE_VTX = 14            # slots per vertex block
TRI_SHADE_MAT = 42            # bitcast(int32 material idx)
TRI_SHADE_META = 44           # bitcast(int32 packed_meta[20])


def pack_tri_shade(positions, normals, uvs, tangents, bitangents,
                   tri_idx, tri_material, packed_meta) -> np.ndarray:
    """(T, 64) f32 packed shading rows — everything the shading step needs
    about a hit triangle in one row gather (GetHitSurface,
    RayTrace.hlsl:444-464, reads 3 vertices and the material rows).

    Layout per row:
      [0:14)  vertex0 block: pos.xyz nrm.xyz uv.xy tan.xyz bit.xyz
      [14:28) vertex1 block, [28:42) vertex2 block (same order)
      [42]    bitcast(int32 material index)      [43] pad
      [44:64) bitcast(int32 packed_meta row)  (pack_material_meta)
    """
    tri_idx = np.asarray(tri_idx, np.int64)
    t = tri_idx.shape[0]
    out = np.zeros((t, TRI_SHADE_WIDTH), np.float32)
    attrs = (np.asarray(positions, np.float32),
             np.asarray(normals, np.float32),
             np.asarray(uvs, np.float32),
             np.asarray(tangents, np.float32),
             np.asarray(bitangents, np.float32))
    for vslot in range(3):
        sel = tri_idx[:, vslot]
        base = vslot * TRI_SHADE_VTX
        off = 0
        for arr in attrs:
            k = arr.shape[1]
            out[:, base + off:base + off + k] = arr[sel]
            off += k
    out[:, TRI_SHADE_MAT] = np.asarray(tri_material, np.int32).view(np.float32)
    pm = np.asarray(packed_meta, np.int32)
    out[:, TRI_SHADE_META:TRI_SHADE_META + pm.shape[1]] = \
        pm[np.asarray(tri_material, np.int64)].view(np.float32)
    return out


LIGHT_ARRAYS = ("position", "direction", "intensity", "angular_attenuation_x",
                "angular_attenuation_y", "range")


@dataclasses.dataclass(frozen=True)
class SpotLights:
    """Spot lights, padded to MAX_SPOT_LIGHTS (SharedTypes.h:40-48); the
    first `num_lights` rows are lights."""

    position: torch.Tensor   # (L, 3) f32
    direction: torch.Tensor  # (L, 3) stored negated: surface -> light axis
    intensity: torch.Tensor  # (L, 3)
    angular_attenuation_x: torch.Tensor  # (L,) cos(inner/2)
    angular_attenuation_y: torch.Tensor  # (L,) cos(outer/2)
    range: torch.Tensor      # (L,)
    num_lights: int = 0

    @classmethod
    def from_numpy(cls, arrays: dict, num_lights: int) -> "SpotLights":
        return cls(**{k: torch.from_numpy(np.array(arrays[k], np.float32))
                      for k in LIGHT_ARRAYS}, num_lights=int(num_lights))

    def to(self, device) -> "SpotLights":
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(device) for k in LIGHT_ARRAYS})


def make_spot_lights(positions=None, directions=None, intensities=None,
                     angular_attenuation=None,
                     light_range=SPOT_LIGHT_RANGE) -> SpotLights:
    """Padded SpotLights (CPU tensors), as the JAX package's make_spot_lights
    (DXRPathTracer::InitializeScene, DXRPathTracer.cpp:965-980): the stored
    direction is the negated model light direction and the angular
    attenuation values are cos(angle/2) of the (inner, outer) angles."""
    if positions is None or len(positions) == 0:
        z3 = np.zeros((MAX_SPOT_LIGHTS, 3), np.float32)
        z1 = np.zeros((MAX_SPOT_LIGHTS,), np.float32)
        return SpotLights.from_numpy(dict(
            position=z3, direction=z3, intensity=z3, angular_attenuation_x=z1,
            angular_attenuation_y=z1, range=z1 + light_range), 0)
    n = min(len(positions), MAX_SPOT_LIGHTS)

    def pad(a, cols):
        out = np.zeros((MAX_SPOT_LIGHTS,) + cols, np.float32)
        out[:n] = np.asarray(a, np.float32)[:n]
        return out

    ang = np.asarray(angular_attenuation, np.float32)[:n]  # (n, 2) angles
    return SpotLights.from_numpy(dict(
        position=pad(positions, (3,)),
        direction=pad(directions, (3,)),
        intensity=pad(intensities, (3,)),
        angular_attenuation_x=pad(np.cos(ang[:, 0] * 0.5), ()),
        angular_attenuation_y=pad(np.cos(ang[:, 1] * 0.5), ()),
        range=pad(np.full(n, light_range, np.float32), ())), n)


SCENE_ARRAYS = ("positions", "normals", "uvs", "tangents", "bitangents",
                "tri_idx", "tri_material", "tri_shade", "texels",
                "texture_meta", "packed_meta", "has_opacity")


@dataclasses.dataclass(frozen=True)
class Scene:
    """The scene as tensors (one device each)."""

    positions: torch.Tensor     # (V, 3) f32
    normals: torch.Tensor       # (V, 3) f32
    uvs: torch.Tensor           # (V, 2) f32
    tangents: torch.Tensor      # (V, 3) f32
    bitangents: torch.Tensor    # (V, 3) f32
    tri_idx: torch.Tensor       # (T, 3) int32 global vertex indices
    tri_material: torch.Tensor  # (T,) int32
    tri_shade: torch.Tensor     # (T, 64) f32 packed shading rows
    texels: torch.Tensor        # (total_texels, 4) f32 atlas pool
    texture_meta: torch.Tensor  # (num_textures, 3) int32: base, width, height
    packed_meta: torch.Tensor   # (M, 20) int32 (pack_material_meta)
    has_opacity: torch.Tensor   # (M,) bool
    lights: SpotLights
    any_opacity: bool = False

    @classmethod
    def from_numpy(cls, arrays: dict,
                   lights: SpotLights | None = None) -> "Scene":
        """CPU tensors sharing memory with the given host arrays; no lights
        unless given."""
        tensors = {k: torch.from_numpy(np.ascontiguousarray(arrays[k]))
                   for k in SCENE_ARRAYS}
        return cls(**tensors,
                   lights=make_spot_lights() if lights is None else lights,
                   any_opacity=bool(np.asarray(arrays["has_opacity"]).any()))

    def to(self, device) -> "Scene":
        return dataclasses.replace(
            self, lights=self.lights.to(device),
            **{k: getattr(self, k).to(device) for k in SCENE_ARRAYS})

    @property
    def num_lights(self) -> int:
        return self.lights.num_lights

    @property
    def num_triangles(self) -> int:
        return self.tri_idx.shape[0]
