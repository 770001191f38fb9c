"""Assemble a Scene from host MeshData lists.

The port of dxrpathtracer_tpu/scene/build.py. The flattening mirrors
Model::CreateBuffers (Model.cpp:851-881): one global vertex pool and one global
index pool with per-mesh offsets applied eagerly, so triangles address the
global pool directly and carry their material id.
"""

import numpy as np

from .procedural import MeshData
from .textures import AtlasBuilder, default_material_table
from .types import (MaterialTable, Scene, SpotLights, pack_material_meta,
                    pack_tri_shade)


def flatten_meshes(meshes: list[MeshData]):
    """Concatenate meshes into global SoA pools with offset-applied indices."""
    positions, normals, uvs, tangents, bitangents = [], [], [], [], []
    tri_idx, tri_material = [], []
    v_off = 0
    for mesh in meshes:
        positions.append(mesh.positions)
        normals.append(mesh.normals)
        uvs.append(mesh.uvs)
        tangents.append(mesh.tangents)
        bitangents.append(mesh.bitangents)
        tri = mesh.indices.reshape(-1, 3).astype(np.int64) + v_off
        tri_idx.append(tri)
        tri_material.append(np.full(tri.shape[0], mesh.material_idx, np.int32))
        v_off += mesh.positions.shape[0]
    return (
        np.concatenate(positions).astype(np.float32),
        np.concatenate(normals).astype(np.float32),
        np.concatenate(uvs).astype(np.float32),
        np.concatenate(tangents).astype(np.float32),
        np.concatenate(bitangents).astype(np.float32),
        np.concatenate(tri_idx).astype(np.int32),
        np.concatenate(tri_material).astype(np.int32),
    )


def build_scene(meshes: list[MeshData], materials: MaterialTable | None = None,
                atlas_builder: AtlasBuilder | None = None,
                lights: SpotLights | None = None) -> Scene:
    """Build a Scene of CPU tensors (no spot lights unless given); move it
    with `scene.to(device)`."""
    pos, nrm, uv, tan, bit, tri, tri_mat = flatten_meshes(meshes)
    if atlas_builder is None:
        atlas_builder = AtlasBuilder()
    if materials is None:
        num_materials = int(tri_mat.max()) + 1 if tri_mat.size else 1
        materials = default_material_table(num_materials, atlas_builder)
    texels, texture_meta = atlas_builder.build()
    packed_meta = pack_material_meta(materials, texture_meta)
    return Scene.from_numpy(dict(
        positions=pos,
        normals=nrm,
        uvs=uv,
        tangents=tan,
        bitangents=bit,
        tri_idx=tri,
        tri_material=tri_mat,
        tri_shade=pack_tri_shade(pos, nrm, uv, tan, bit, tri, tri_mat,
                                 packed_meta),
        texels=texels,
        texture_meta=texture_meta,
        packed_meta=packed_meta,
        has_opacity=np.asarray(materials.has_opacity, bool),
    ), lights=lights)
