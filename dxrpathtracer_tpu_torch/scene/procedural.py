"""Procedural mesh generators (host-side numpy).

Parity with Mesh::InitBox / Mesh::InitPlane / Model::GenerateBoxTestScene
(SampleFramework12/v1.02/Graphics/Model.cpp:235-399,761-780): identical vertex
positions, normals, UVs, tangent frames, and winding, so BVHs and renders are
directly comparable with the reference scenes.
"""

import dataclasses

import numpy as np

from ..core.quaternion import quat_identity, quat_to_mat3


@dataclasses.dataclass
class MeshData:
    positions: np.ndarray   # (V, 3)
    normals: np.ndarray     # (V, 3)
    uvs: np.ndarray         # (V, 2)
    tangents: np.ndarray    # (V, 3)
    bitangents: np.ndarray  # (V, 3)
    indices: np.ndarray     # (I,) int32
    material_idx: int = 0


def _transform(mesh: MeshData, position, scale, orientation) -> MeshData:
    """MeshVertex::Transform: scale, rotate, translate positions; rotate frame."""
    rot = quat_to_mat3(orientation)
    p = (mesh.positions * np.asarray(scale, np.float32)) @ rot + np.asarray(position, np.float32)
    n = mesh.normals @ rot
    t = mesh.tangents @ rot
    b = mesh.bitangents @ rot
    return dataclasses.replace(mesh, positions=p.astype(np.float32), normals=n.astype(np.float32),
                               tangents=t.astype(np.float32), bitangents=b.astype(np.float32))


def make_box(dimensions=(1.0, 1.0, 1.0), position=(0.0, 0.0, 0.0),
             orientation=None, material_idx=0) -> MeshData:
    """24-vertex box, 12 tris (Model.cpp:235-347). dimensions are full extents."""
    if orientation is None:
        orientation = quat_identity()
    # (position, normal, uv, tangent, bitangent) per face, 4 verts per face:
    # top, bottom, front, back, left, right — exact ordering of InitBox.
    P, N, UV, T, B = [], [], [], [], []

    def face(positions, normal, tangent, bitangent):
        uvs = [(0, 0), (1, 0), (1, 1), (0, 1)]
        for pos, uv in zip(positions, uvs):
            P.append(pos); N.append(normal); UV.append(uv); T.append(tangent); B.append(bitangent)

    face([(-1, 1, 1), (1, 1, 1), (1, 1, -1), (-1, 1, -1)], (0, 1, 0), (1, 0, 0), (0, 0, -1))       # top
    face([(-1, -1, -1), (1, -1, -1), (1, -1, 1), (-1, -1, 1)], (0, -1, 0), (1, 0, 0), (0, 0, 1))   # bottom
    face([(-1, 1, -1), (1, 1, -1), (1, -1, -1), (-1, -1, -1)], (0, 0, -1), (1, 0, 0), (0, -1, 0))  # front
    face([(1, 1, 1), (-1, 1, 1), (-1, -1, 1), (1, -1, 1)], (0, 0, 1), (-1, 0, 0), (0, -1, 0))      # back
    face([(-1, 1, 1), (-1, 1, -1), (-1, -1, -1), (-1, -1, 1)], (-1, 0, 0), (0, 0, -1), (0, -1, 0))  # left
    face([(1, 1, -1), (1, 1, 1), (1, -1, 1), (1, -1, -1)], (1, 0, 0), (0, 0, 1), (0, -1, 0))       # right

    idx = []
    for f in range(6):
        base = f * 4
        idx += [base + 0, base + 1, base + 2, base + 2, base + 3, base + 0]

    mesh = MeshData(
        positions=np.asarray(P, np.float32),
        normals=np.asarray(N, np.float32),
        uvs=np.asarray(UV, np.float32),
        tangents=np.asarray(T, np.float32),
        bitangents=np.asarray(B, np.float32),
        indices=np.asarray(idx, np.int32),
        material_idx=material_idx,
    )
    half = np.asarray(dimensions, np.float32) * 0.5
    return _transform(mesh, position, half, orientation)


def make_plane(dimensions=(1.0, 1.0), position=(0.0, 0.0, 0.0),
               orientation=None, material_idx=0) -> MeshData:
    """4-vertex plane in the xz plane facing +y (Model.cpp:349-399)."""
    if orientation is None:
        orientation = quat_identity()
    mesh = MeshData(
        positions=np.asarray([(-1, 0, 1), (1, 0, 1), (1, 0, -1), (-1, 0, -1)], np.float32),
        normals=np.asarray([(0, 1, 0)] * 4, np.float32),
        uvs=np.asarray([(0, 0), (1, 0), (1, 1), (0, 1)], np.float32),
        tangents=np.asarray([(1, 0, 0)] * 4, np.float32),
        bitangents=np.asarray([(0, 0, -1)] * 4, np.float32),
        indices=np.asarray([0, 1, 2, 2, 3, 0], np.int32),
        material_idx=material_idx,
    )
    half = np.asarray([dimensions[0] * 0.5, 1.0, dimensions[1] * 0.5], np.float32)
    return _transform(mesh, position, half, orientation)


def make_sphere(radius=1.0, position=(0.0, 0.0, 0.0), n_lat=32, n_lon=64,
                material_idx=0) -> MeshData:
    """UV sphere (no reference analog on the main path; used by test scenes)."""
    lat = np.linspace(0.0, np.pi, n_lat + 1)
    lon = np.linspace(0.0, 2.0 * np.pi, n_lon + 1)
    th, ph = np.meshgrid(lat, lon, indexing="ij")
    x = np.sin(th) * np.cos(ph)
    y = np.cos(th)
    z = np.sin(th) * np.sin(ph)
    n = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    p = n * radius + np.asarray(position, np.float32)
    uv = np.stack([ph / (2 * np.pi), th / np.pi], -1).reshape(-1, 2).astype(np.float32)
    t = np.stack([-np.sin(ph), np.zeros_like(ph), np.cos(ph)], -1).reshape(-1, 3).astype(np.float32)
    b = np.cross(n, t).astype(np.float32)
    idx = []
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * (n_lon + 1) + j
            c = a + n_lon + 1
            idx += [a, a + 1, c, c, a + 1, c + 1]
    return MeshData(p, n, uv, t, b, np.asarray(idx, np.int32), material_idx)


def box_test_meshes() -> list[MeshData]:
    """GenerateBoxTestScene (Model.cpp:761-780): a 2m box floating on a slab."""
    return [
        make_box((2.0, 2.0, 2.0), (0.0, 1.5, 0.0), material_idx=0),
        make_box((10.0, 0.25, 10.0), (0.0, 0.0, 0.0), material_idx=0),
    ]
