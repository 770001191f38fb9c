"""Minimal binary-FBX scene importer (host-side, numpy).

The port of dxrpathtracer_tpu/scene/fbx.py, a numpy copy: the same bytes give
byte-equal meshes, spot lights and texture-name tables.

The reference imports scenes through Assimp (Model::CreateWithAssimp,
Graphics/Model.cpp:435-560) with aiProcess_MakeLeftHanded | FlipUVs |
FlipWindingOrder | Triangulate | CalcTangentSpace (Model.cpp:509-520), scales
positions by SceneScale, pulls 6 texture slots per material, and extracts
spot/point lights (Model.cpp:462-506). Assimp is unavailable here, so this
module parses the FBX 7.x binary container directly: node records, property
lists, zlib-compressed arrays, Connections, Model TRS transforms,
material/texture bindings, and light node attributes.

Handedness/UV parity with the reference's Assimp flags: positions/normals/
light transforms get Z negated, triangle winding is flipped, and the UV V
coordinate is flipped.
"""

import dataclasses
import struct
import zlib
from pathlib import Path

import numpy as np

from .procedural import MeshData

_MAGIC = b"Kaydara FBX Binary  \x00"


class FBXNode:
    __slots__ = ("name", "props", "children")

    def __init__(self, name, props, children):
        self.name = name
        self.props = props
        self.children = children

    def find(self, name):
        return [c for c in self.children if c.name == name]

    def first(self, name):
        for c in self.children:
            if c.name == name:
                return c
        return None


def _read_prop(buf, off):
    t = buf[off:off + 1]
    off += 1
    if t == b"Y":
        return struct.unpack_from("<h", buf, off)[0], off + 2
    if t == b"C":
        return bool(buf[off]), off + 1
    if t == b"I":
        return struct.unpack_from("<i", buf, off)[0], off + 4
    if t == b"F":
        return struct.unpack_from("<f", buf, off)[0], off + 4
    if t == b"D":
        return struct.unpack_from("<d", buf, off)[0], off + 8
    if t == b"L":
        return struct.unpack_from("<q", buf, off)[0], off + 8
    if t in (b"f", b"d", b"l", b"i", b"b"):
        n, enc, clen = struct.unpack_from("<III", buf, off)
        off += 12
        dt = {b"f": "<f4", b"d": "<f8", b"l": "<i8", b"i": "<i4", b"b": "<i1"}[t]
        if enc:
            data = np.frombuffer(zlib.decompress(buf[off:off + clen]), dt, count=n)
            off += clen
        else:
            size = n * np.dtype(dt).itemsize
            data = np.frombuffer(buf[off:off + size], dt, count=n)
            off += size
        return data, off
    if t == b"S":
        n = struct.unpack_from("<I", buf, off)[0]
        off += 4
        return buf[off:off + n].decode("utf-8", errors="replace"), off + n
    if t == b"R":
        n = struct.unpack_from("<I", buf, off)[0]
        off += 4
        return buf[off:off + n], off + n
    raise ValueError(f"unknown FBX property type {t!r}")


def _read_node(buf, off, version):
    if version >= 7500:
        end, nprops, _plen = struct.unpack_from("<QQQ", buf, off)
        off += 24
    else:
        end, nprops, _plen = struct.unpack_from("<III", buf, off)
        off += 12
    name_len = buf[off]
    off += 1
    name = buf[off:off + name_len].decode("utf-8", errors="replace")
    off += name_len
    if end == 0:
        return None, off
    props = []
    for _ in range(nprops):
        p, off = _read_prop(buf, off)
        props.append(p)
    children = []
    while off < end:
        child, off = _read_node(buf, off, version)
        if child is None:
            break
        children.append(child)
    return FBXNode(name, props, children), end


def parse_fbx(path):
    buf = Path(path).read_bytes()
    if not buf.startswith(_MAGIC):
        raise ValueError("not a binary FBX file")
    version = struct.unpack_from("<I", buf, 23)[0]
    off = 27
    roots = []
    while off < len(buf):
        node, off = _read_node(buf, off, version)
        if node is None:
            break
        roots.append(node)
    return FBXNode("", [], roots), version


# ---------------------------------------------------------------------------
# Object graph
# ---------------------------------------------------------------------------

def _props70(node):
    """Properties70 dictionary: name -> list of values."""
    out = {}
    p70 = node.first("Properties70")
    if p70 is None:
        return out
    for p in p70.find("P"):
        out[p.props[0]] = p.props[4:]
    return out


def _euler_xyz_deg_to_mat(rx, ry, rz):
    """FBX default rotation order (XYZ, degrees) -> row-vector 3x3."""
    rx, ry, rz = np.deg2rad([rx, ry, rz])

    def rot(axis, a):
        c, s = np.cos(a), np.sin(a)
        if axis == 0:
            return np.array([[1, 0, 0], [0, c, s], [0, -s, c]])
        if axis == 1:
            return np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
        return np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])

    # row-vector composition: v' = v @ Rx @ Ry @ Rz
    return rot(0, rx) @ rot(1, ry) @ rot(2, rz)


@dataclasses.dataclass
class FBXSpotLight:
    position: np.ndarray
    direction: np.ndarray  # direction the light points (world)
    color: np.ndarray
    intensity: float
    inner_angle: float     # radians, full cone
    outer_angle: float


@dataclasses.dataclass
class FBXScene:
    meshes: list
    spot_lights: list
    material_textures: list  # per mesh-material dict slot->texture filename


def _model_transform(model_node):
    p = _props70(model_node)

    def get3(name, default):
        return np.array([float(v) for v in p.get(name, default)], np.float64)

    t = get3("Lcl Translation", (0, 0, 0))
    r = get3("Lcl Rotation", (0, 0, 0))
    s = get3("Lcl Scaling", (1, 1, 1))
    pre_r = get3("PreRotation", (0, 0, 0))
    m = np.eye(4)
    rot = _euler_xyz_deg_to_mat(*r) @ _euler_xyz_deg_to_mat(*pre_r)
    m[:3, :3] = np.diag(s) @ rot
    m[3, :3] = t
    return m


def load_fbx_scene(path, scene_scale: float = 1.0) -> FBXScene:
    root, _version = parse_fbx(path)
    objects = root.first("Objects")
    conns = root.first("Connections")
    if objects is None:
        raise ValueError("no Objects node")

    by_id = {}
    for child in objects.children:
        if child.props and isinstance(child.props[0], int):
            by_id[child.props[0]] = child

    # parent -> children and child -> parents from OO connections
    children_of = {}
    parents_of = {}
    prop_conns = []
    if conns is not None:
        for c in conns.find("C"):
            kind = c.props[0]
            if kind == "OO":
                child_id, parent_id = c.props[1], c.props[2]
                children_of.setdefault(parent_id, []).append(child_id)
                parents_of.setdefault(child_id, []).append(parent_id)
            elif kind == "OP":
                prop_conns.append((c.props[1], c.props[2], c.props[3]))

    def node_kind(n):
        return n.name

    # world transforms of Model nodes (walk up the model hierarchy)
    model_world = {}

    def world_of(mid, depth=0):
        if mid in model_world or depth > 64:
            return model_world.get(mid, np.eye(4))
        node = by_id.get(mid)
        local = _model_transform(node) if node is not None else np.eye(4)
        parent = np.eye(4)
        for pid in parents_of.get(mid, []):
            pn = by_id.get(pid)
            if pn is not None and pn.name == "Model":
                parent = world_of(pid, depth + 1)
                break
        m = local @ parent
        model_world[mid] = m
        return m

    # Texture filename per texture id
    tex_file = {}
    for tid, node in by_id.items():
        if node.name == "Texture":
            fn = node.first("RelativeFilename") or node.first("FileName")
            if fn is not None and fn.props:
                tex_file[tid] = str(fn.props[0]).replace("\\", "/").split("/")[-1]

    # Material id -> {slot: filename}
    mat_tex = {}
    slot_map = {"DiffuseColor": "albedo", "NormalMap": "normal", "Bump": "normal",
                "ShininessExponent": "roughness", "SpecularColor": "roughness",
                "AmbientColor": "metallic", "TransparencyFactor": "opacity",
                "TransparentColor": "opacity", "EmissiveColor": "emissive"}
    for child_id, parent_id, prop in prop_conns:
        parent = by_id.get(parent_id)
        child = by_id.get(child_id)
        if parent is not None and child is not None \
                and parent.name == "Material" and child.name == "Texture":
            slot = slot_map.get(prop)
            if slot and child_id in tex_file:
                mat_tex.setdefault(parent_id, {})[slot] = tex_file[child_id]

    meshes = []
    material_textures = []
    spot_lights = []

    for gid, node in by_id.items():
        if node.name == "Geometry" and node.first("Vertices") is not None:
            # find owning Model for the materials. Parity note: the reference
            # reads raw per-mesh Assimp vertex data and never applies node
            # transforms (Mesh::InitFromAssimpMesh, Model.cpp:151-230, with
            # MergeMeshes=false), so geometry stays in its authored space.
            model_id = next((pid for pid in parents_of.get(gid, [])
                             if by_id.get(pid) is not None
                             and by_id[pid].name == "Model"), None)
            mat_ids = [cid for cid in children_of.get(model_id, [])
                       if by_id.get(cid) is not None and by_id[cid].name == "Material"]

            mesh = _geometry_to_mesh(node, np.eye(4), scene_scale)
            if mesh is None:
                continue
            mesh = dataclasses.replace(mesh, material_idx=len(material_textures))
            material_textures.append(mat_tex.get(mat_ids[0], {}) if mat_ids else {})
            meshes.append(mesh)
        elif node.name == "NodeAttribute" and node.props and \
                (len(node.props) > 2 and node.props[2] == "Light"):
            p = _props70(node)
            if int(p.get("LightType", [0])[0]) != 2:  # 2 = spot
                continue
            model_id = next((pid for pid in parents_of.get(gid, [])
                             if by_id.get(pid) is not None
                             and by_id[pid].name == "Model"), None)
            world = world_of(model_id) if model_id is not None else np.eye(4)
            posw = world[3, :3] * scene_scale
            # FBX lights aim along the node's -Y axis
            dirw = -world[1, :3]
            dirw = dirw / max(np.linalg.norm(dirw), 1e-9)
            color = np.array([float(v) for v in p.get("Color", (1, 1, 1))])
            intensity = float(p.get("Intensity", [100.0])[0]) / 100.0
            inner = np.deg2rad(float(p.get("InnerAngle", [30.0])[0]))
            outer = np.deg2rad(float(p.get("OuterAngle", [45.0])[0]))
            # LH conversion
            posw[2] *= -1.0
            dirw[2] *= -1.0
            spot_lights.append(FBXSpotLight(
                position=posw.astype(np.float32),
                direction=dirw.astype(np.float32),
                color=color.astype(np.float32), intensity=intensity,
                inner_angle=inner, outer_angle=outer))

    if not meshes:
        raise ValueError("no meshes found in FBX")
    return FBXScene(meshes=meshes, spot_lights=spot_lights,
                    material_textures=material_textures)


def _layer_values(layer, value_name, index_name, poly_idx, n_comp):
    mapping = layer.first("MappingInformationType").props[0]
    ref = layer.first("ReferenceInformationType").props[0]
    data = np.asarray(layer.first(value_name).props[0], np.float64).reshape(-1, n_comp)
    idx_node = layer.first(index_name)
    cp_idx = np.where(poly_idx < 0, -poly_idx - 1, poly_idx)
    if ref == "IndexToDirect" and idx_node is not None:
        idx = np.asarray(idx_node.props[0], np.int64)
        if mapping == "ByPolygonVertex":
            return data[idx]
        if mapping == "ByControlPoint":
            return data[idx][cp_idx]
    if mapping == "ByPolygonVertex":
        return data
    if mapping == "ByControlPoint":
        return data[cp_idx]
    raise ValueError(f"unsupported FBX mapping {mapping}/{ref}")


def _triangulate(poly_idx):
    """Polygon-vertex stream -> fan triangles (indices into the stream)."""
    ends = np.where(poly_idx < 0)[0]
    tris = []
    start = 0
    for e in ends:
        count = e - start + 1
        for k in range(1, count - 1):
            tris.append((start, start + k, start + k + 1))
        start = e + 1
    return np.asarray(tris, np.int64)


def _geometry_to_mesh(geo, world, scene_scale):
    v_node = geo.first("Vertices")
    i_node = geo.first("PolygonVertexIndex")
    if v_node is None or i_node is None:
        return None
    verts = np.asarray(v_node.props[0], np.float64).reshape(-1, 3)
    poly_idx = np.asarray(i_node.props[0], np.int64)
    tris_pv = _triangulate(poly_idx)
    cp = np.where(poly_idx < 0, -poly_idx - 1, poly_idx)

    normals = None
    ln = geo.first("LayerElementNormal")
    if ln is not None:
        normals = _layer_values(ln, "Normals", "NormalsIndex", poly_idx, 3)
    uvs = None
    lu = geo.first("LayerElementUV")
    if lu is not None:
        uvs = _layer_values(lu, "UV", "UVIndex", poly_idx, 2)

    pv_count = len(poly_idx)
    rot = world[:3, :3]
    pos_pv = (verts[cp] @ rot + world[3, :3]) * scene_scale
    nrm_pv = (normals @ rot) if normals is not None else np.zeros((pv_count, 3))
    uv_pv = uvs if uvs is not None else np.zeros((pv_count, 2))
    # FlipUVs parity (Model.cpp:514)
    uv_pv = np.stack([uv_pv[:, 0], 1.0 - uv_pv[:, 1]], -1)

    # MakeLeftHanded parity: negate Z; FlipWindingOrder: swap tri order
    pos_pv = pos_pv * np.array([1.0, 1.0, -1.0])
    nrm_pv = nrm_pv * np.array([1.0, 1.0, -1.0])
    tris_pv = tris_pv[:, ::-1]

    used = tris_pv.reshape(-1)
    pos = pos_pv[used].reshape(-1, 3)
    nrm = nrm_pv[used].reshape(-1, 3)
    uv = uv_pv[used].reshape(-1, 2)
    nv = pos.shape[0]

    ln_norm = np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = np.where(ln_norm > 1e-9, nrm / np.maximum(ln_norm, 1e-9), [[0.0, 1.0, 0.0]])

    # Tangent frame from UV derivatives (CalcTangentSpace parity, per-triangle)
    p = pos.reshape(-1, 3, 3)
    t_uv = uv.reshape(-1, 3, 2)
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    du1 = t_uv[:, 1] - t_uv[:, 0]
    du2 = t_uv[:, 2] - t_uv[:, 0]
    det = du1[:, 0] * du2[:, 1] - du1[:, 1] * du2[:, 0]
    inv = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det), 0.0)
    tangent_tri = (e1 * du2[:, 1:2] - e2 * du1[:, 1:2]) * inv[:, None]
    tl = np.linalg.norm(tangent_tri, axis=-1, keepdims=True)
    tangent_tri = np.where(tl > 1e-9, tangent_tri / np.maximum(tl, 1e-9), [[1.0, 0.0, 0.0]])
    tangents = np.repeat(tangent_tri, 3, axis=0)
    # Gram-Schmidt against the vertex normal
    tangents = tangents - nrm * np.sum(tangents * nrm, -1, keepdims=True)
    tl = np.linalg.norm(tangents, axis=-1, keepdims=True)
    tangents = np.where(tl > 1e-9, tangents / np.maximum(tl, 1e-9), [[1.0, 0.0, 0.0]])
    bit = np.cross(nrm, tangents)

    return MeshData(
        positions=pos.astype(np.float32),
        normals=nrm.astype(np.float32),
        uvs=uv.astype(np.float32),
        tangents=tangents.astype(np.float32),
        bitangents=bit.astype(np.float32),
        indices=np.arange(nv, dtype=np.int32),
        material_idx=0,
    )


def load_fbx_meshes(path, scene_scale: float = 1.0) -> list:
    """Backward-compatible mesh-only loader."""
    return load_fbx_scene(path, scene_scale).meshes
