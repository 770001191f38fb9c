"""Binary FBX 7.4 and DDS writers: scene assets made from a seed.

The repository holds no FBX or DDS file, so the scene importer
(scene/fbx.py, the registry's FBX route, scene/cache.py) is driven by files
this module writes: the records and properties the importer reads (FBX's
binary container: node records, typed properties, arrays raw or
zlib-compressed), `Geometry` with `Vertices`, `PolygonVertexIndex` (polygons
of any size), `LayerElementNormal` (ByPolygonVertex, Direct) and
`LayerElementUV` (ByPolygonVertex, IndexToDirect); mesh `Model`s with their
`Material`s and those materials' `Texture`s (by file name, or left empty);
spot-light `NodeAttribute`s on light `Model`s with `Lcl Translation`,
`Lcl Rotation` and `Lcl Scaling`, optionally under a parent `Model`; `OO`
(object) and `OP` (object to property) connections. Textures are DX10 DDS
files of R8G8B8A8_UNORM or R8G8B8A8_UNORM_SRGB texels, which scene/dds.py
decodes without PIL.

`add_scene_meshes` writes a scene's meshes so that the importer's
left-handed conversion (z negated, winding and V flipped, positions scaled)
gives them back; `sponza_alpha_fbx` writes SponzaAlpha-checker that way
(tools/alpha_cases.py: the Sponza-class stand-in, 384 cards bound to the
checker opacity map, four spot lights) under an asset root, for
`load_scene(Scenes.Sponza, asset_root=...)`.
"""

import struct
import zlib
from pathlib import Path

import numpy as np

FBX_VERSION = 7400
_MAGIC = b"Kaydara FBX Binary  \x00\x1a\x00"
_NULL_RECORD = b"\x00" * 13
_ARRAY_CODES = {np.dtype("<f4"): b"f", np.dtype("<f8"): b"d",
                np.dtype("<i4"): b"i", np.dtype("<i8"): b"l",
                np.dtype("<i1"): b"b"}


class I32(int):
    """An FBX 'I' (int32) property; a plain int is written as 'L'."""


def _prop(value, compress: bool) -> bytes:
    if isinstance(value, bool):
        return b"C" + bytes([value])
    if isinstance(value, I32):
        return b"I" + struct.pack("<i", value)
    if isinstance(value, int):
        return b"L" + struct.pack("<q", value)
    if isinstance(value, float):
        return b"D" + struct.pack("<d", value)
    if isinstance(value, str):
        raw = value.encode()
        return b"S" + struct.pack("<I", len(raw)) + raw
    arr = np.ascontiguousarray(value)
    code = _ARRAY_CODES[arr.dtype.newbyteorder("<")]
    raw = arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
    if compress:
        raw = zlib.compress(raw, 1)
    return code + struct.pack("<III", arr.size, int(compress), len(raw)) + raw


def _node(name: str, props=(), children=(), compress=True):
    return (name, [_prop(p, compress) for p in props], list(children))


def _record(node, offset: int) -> bytes:
    """One node record (FBX < 7.5: 32-bit offsets) starting at `offset`."""
    name, props, children = node
    body = b"".join(props)
    head_len = 13 + len(name.encode())
    out = [body]
    pos = offset + head_len + len(body)
    for child in children:
        rec = _record(child, pos)
        out.append(rec)
        pos += len(rec)
    if children:
        out.append(_NULL_RECORD)
        pos += len(_NULL_RECORD)
    head = struct.pack("<III", pos, len(props), len(body)) + \
        bytes([len(name.encode())]) + name.encode()
    return head + b"".join(out)


def write_fbx(path, roots) -> None:
    """The binary FBX 7.4 file of top-level nodes `roots`."""
    out = [_MAGIC, struct.pack("<I", FBX_VERSION)]
    pos = len(_MAGIC) + 4
    for node in roots:
        rec = _record(node, pos)
        out.append(rec)
        pos += len(rec)
    out.append(_NULL_RECORD)
    Path(path).write_bytes(b"".join(out))


def _p70(*entries):
    """Properties70 of (name, type, value or values)."""
    ps = []
    for name, kind, values in entries:
        values = values if isinstance(values, (tuple, list)) else (values,)
        ps.append(_node("P", (name, kind, "", "A", *values)))
    return _node("Properties70", (), ps)


def _vec3(v):
    return tuple(float(x) for x in v)


def write_dds(path, texels: np.ndarray, srgb: bool = False) -> None:
    """(H, W, 4) uint8 texels as a DX10 DDS of R8G8B8A8_UNORM(_SRGB)."""
    texels = np.ascontiguousarray(texels, np.uint8)
    h, w, c = texels.shape
    assert c == 4
    header = struct.pack("<7I", 124, 0x1 | 0x2 | 0x4 | 0x1000, h, w, w * 4,
                         0, 1) + b"\x00" * 44
    header += struct.pack("<2I4s5I", 32, 0x4, b"DX10", 0, 0, 0, 0, 0)
    header += struct.pack("<5I", 0x1000, 0, 0, 0, 0)
    dx10 = struct.pack("<5I", 29 if srgb else 28, 3, 0, 1, 0)
    Path(path).write_bytes(b"DDS " + header + dx10 + texels.tobytes())


class SceneWriter:
    """Builds an FBX scene: meshes with materials, spot lights, parents."""

    def __init__(self, compress: bool = True):
        self.compress = compress
        self.objects, self.connections = [], []
        self._next_id = 1000
        self._textures = {}

    def _id(self) -> int:
        self._next_id += 1
        return self._next_id

    def _n(self, name, props=(), children=()):
        return _node(name, props, children, self.compress)

    def _connect(self, kind, child, parent, prop=None):
        props = (kind, child, parent) + ((prop,) if prop else ())
        self.connections.append(self._n("C", props))

    def model(self, kind: str = "Null", translation=(0, 0, 0),
              rotation=(0, 0, 0), scaling=(1, 1, 1), parent: int = 0) -> int:
        """A Model node (Lcl TRS, rotation in degrees, XYZ) under `parent`
        (0: the scene root); returns its id."""
        mid = self._id()
        self.objects.append(self._n("Model", (mid, f"Model::{mid}", kind), [
            _p70(("Lcl Translation", "Lcl Translation", _vec3(translation)),
                 ("Lcl Rotation", "Lcl Rotation", _vec3(rotation)),
                 ("Lcl Scaling", "Lcl Scaling", _vec3(scaling)))]))
        self._connect("OO", mid, parent)
        return mid

    def texture(self, filename: str) -> int:
        """A Texture node naming `filename` ('' leaves it empty)."""
        if filename not in self._textures:
            tid = self._id()
            self.objects.append(self._n("Texture", (tid, f"Texture::{tid}", ""), [
                self._n("FileName", (filename,)),
                self._n("RelativeFilename", (filename,))]))
            self._textures[filename] = tid
        return self._textures[filename]

    def mesh(self, positions, polygons, normals=None, uvs=None,
             uv_index=None, textures=None, parent: int = 0) -> int:
        """A mesh: control points (V, 3), polygons (a list of index
        sequences, any size >= 3), per-polygon-vertex normals (PV, 3), UV
        values (K, 2) with their per-polygon-vertex indices (PV,) (by
        default one value per polygon vertex), and `textures` {FBX material
        property (DiffuseColor, TransparentColor, ...): file name}. Returns
        the mesh model's id."""
        gid = self._id()
        pvi = []
        for poly in polygons:
            poly = [int(i) for i in poly]
            pvi += poly[:-1] + [~poly[-1]]
        children = [
            self._n("Vertices", (np.asarray(positions, np.float64).ravel(),)),
            self._n("PolygonVertexIndex", (np.asarray(pvi, np.int32),))]
        if normals is not None:
            children.append(self._n("LayerElementNormal", (I32(0),), [
                self._n("MappingInformationType", ("ByPolygonVertex",)),
                self._n("ReferenceInformationType", ("Direct",)),
                self._n("Normals", (np.asarray(normals, np.float64).ravel(),))]))
        if uvs is not None:
            uvs = np.asarray(uvs, np.float64)
            if uv_index is None:
                uv_index = np.arange(len(uvs), dtype=np.int32)
            children.append(self._n("LayerElementUV", (I32(0),), [
                self._n("MappingInformationType", ("ByPolygonVertex",)),
                self._n("ReferenceInformationType", ("IndexToDirect",)),
                self._n("UV", (uvs.ravel(),)),
                self._n("UVIndex", (np.asarray(uv_index, np.int32),))]))
        self.objects.append(self._n("Geometry", (gid, f"Geometry::{gid}",
                                                 "Mesh"), children))
        mid = self.model("Mesh", parent=parent)
        self._connect("OO", gid, mid)
        mat = self._id()
        self.objects.append(self._n("Material", (mat, f"Material::{mat}", "")))
        self._connect("OO", mat, mid)
        for prop, filename in (textures or {}).items():
            self._connect("OP", self.texture(filename), mat, prop)
        return mid

    def spot_light(self, translation, rotation=(0, 0, 0), color=(1, 1, 1),
                   intensity=100.0, inner_deg=30.0, outer_deg=45.0,
                   scaling=(1, 1, 1), parent: int = 0,
                   light_type: int = 2) -> int:
        """A spot light (FBX LightType 2; another type, e.g. 0 for a point
        light, to write a light the importer skips) on its own Model (it
        points along the model's -Y); returns the light model's id."""
        mid = self.model("Light", translation, rotation, scaling, parent)
        aid = self._id()
        self.objects.append(self._n(
            "NodeAttribute", (aid, f"NodeAttribute::{aid}", "Light"), [
                _p70(("LightType", "enum", I32(light_type)),
                     ("Color", "Color", _vec3(color)),
                     ("Intensity", "Number", float(intensity)),
                     ("InnerAngle", "Number", float(inner_deg)),
                     ("OuterAngle", "Number", float(outer_deg)))]))
        self._connect("OO", aid, mid)
        return mid

    def write(self, path) -> None:
        write_fbx(path, [
            self._n("FBXHeaderExtension", (), [
                self._n("FBXVersion", (I32(FBX_VERSION),))]),
            self._n("Objects", (), self.objects),
            self._n("Connections", (), self.connections)])


def add_scene_meshes(writer: SceneWriter, meshes, scale: float,
                     textures_of) -> None:
    """Each MeshData as one FBX mesh of triangles, written so that the
    importer's conversion (z negated, winding reversed, V flipped,
    positions times `scale`) gives its positions, normals and UVs back (to
    float rounding); `textures_of(mesh)` gives its material's textures."""
    flip = np.array([1.0, 1.0, -1.0])
    for m in meshes:
        tri = np.asarray(m.indices, np.int64).reshape(-1, 3)[:, ::-1]
        pv = tri.reshape(-1)
        uv = np.asarray(m.uvs, np.float64)[pv]
        writer.mesh(np.asarray(m.positions, np.float64) * flip / scale, tri,
                    normals=np.asarray(m.normals, np.float64)[pv] * flip,
                    uvs=np.stack([uv[:, 0], 1.0 - uv[:, 1]], -1),
                    textures=textures_of(m))


# SponzaAlpha-checker as an asset: its files, relative to the asset root
SPONZA_FBX = "Content/Models/Sponza/Sponza_NoSpotLight.fbx"
SPONZA_TEXTURES = "Content/Models/Sponza/Textures"
ATRIUM_ALBEDO = "atrium_albedo.dds"
CARD_ALBEDO = "leaf_albedo.dds"
CARD_OPACITY = "leaf_mask.dds"  # no slot keyword: only the cards bind it


def atrium_light_rows(count: int = 4):
    """(translation, FBX color, FBX intensity, inner, outer degrees) of
    `count` spot lights over the atrium's centre aisle, pointing down, with
    tools/alpha_cases.atrium_spot_lights' intensities (color * intensity /
    100 * 2500). They hang at 6 m, not 9: the importer gives every spot
    light the reference's 7.5 m range."""
    xs = (-12.0, -4.0, 4.0, 12.0, -12.0, -4.0, 4.0, 12.0)
    zs = (0.0,) * 4 + (-3.0,) * 4
    return [((xs[i], 6.0, zs[i]), (1.0, 0.95, 0.875), 160.0,
             float(np.rad2deg(0.8)), float(np.rad2deg(1.4)))
            for i in range(count)]


def sponza_alpha_fbx(asset_root, num_cards: int = 384, lights: int = 4,
                     compress: bool = True) -> Path:
    """Writes SponzaAlpha-checker under `asset_root` as the Sponza preset's
    FBX (scene scale 0.01) with its DDS textures: the stand-in's meshes
    with an sRGB albedo map, `num_cards` cards with their own albedo map
    and tiny_alpha_scene's 64x64 checker as opacity (R channel), and
    `lights` spot lights. Returns the FBX's path."""
    from ..scene.registry import _sponza_standin_meshes, checker_mask
    from ..scene.registry import sponza_card_meshes
    root = Path(asset_root)
    fbx_path = root / SPONZA_FBX
    tex_dir = root / SPONZA_TEXTURES
    tex_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(5)
    write_dds(tex_dir / ATRIUM_ALBEDO,
              rng.integers(96, 224, (16, 16, 4), dtype=np.uint8), srgb=True)
    leaf = rng.integers(32, 160, (8, 8, 4), dtype=np.uint8)
    leaf[..., 1] = 200
    write_dds(tex_dir / CARD_ALBEDO, leaf, srgb=True)
    mask = (checker_mask()[..., 0] * 255).astype(np.uint8)
    write_dds(tex_dir / CARD_OPACITY,
              np.stack([mask, mask, mask, np.full_like(mask, 255)], -1))

    writer = SceneWriter(compress=compress)
    atrium = {"DiffuseColor": ATRIUM_ALBEDO}
    card = {"DiffuseColor": CARD_ALBEDO, "TransparentColor": CARD_OPACITY}
    meshes = _sponza_standin_meshes() + sponza_card_meshes(num_cards)
    add_scene_meshes(writer, meshes, 0.01,
                     lambda m: card if m.material_idx == 1 else atrium)
    for pos, color, intensity, inner, outer in atrium_light_rows(lights):
        writer.spot_light(np.asarray(pos) * np.array([1.0, 1.0, -1.0]) / 0.01,
                          color=color, intensity=intensity, inner_deg=inner,
                          outer_deg=outer)
    fbx_path.parent.mkdir(parents=True, exist_ok=True)
    writer.write(fbx_path)
    return fbx_path
