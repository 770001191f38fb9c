"""The reference's scene: a SceneDesc (ptbench/scenes/) packed by itself.

Vertex pools as flat arrays, a texel pool of every texture at its native
size, and per material the (base, width, height) of each slot's texture.
The bilinear wrap tap and the alpha test are frozen copies of
dxrpathtracer_tpu_torch/scene/textures.py:141-166 (`bilinear_from_meta`)
and dxrpathtracer_tpu_torch/accel/traverse.py:81-109 (`AlphaTest`), which
read the same values from the program's packed rows.

`storage` is the dtype the tables are held in: float32 for the reference,
bfloat16 for its control (ptbench/calibrate.py), whose every table is rounded
to it and read back as float32.
"""

import dataclasses

import numpy as np
import torch

from ..scenes._materials import SLOTS

ALPHA_CUTOFF = 0.35


@dataclasses.dataclass
class RefScene:
    positions: torch.Tensor   # (V, 3) f32
    normals: torch.Tensor
    uvs: torch.Tensor         # (V, 2)
    tangents: torch.Tensor
    bitangents: torch.Tensor
    tri_idx: torch.Tensor     # (T, 3) int64
    tri_material: torch.Tensor  # (T,) int64
    texels: torch.Tensor      # (N, 4) f32
    slot_meta: torch.Tensor   # (M, 6, 3) int32: base, width, height
    has_opacity: torch.Tensor  # (M,) bool
    lights: dict              # spot-light tensors and num_lights
    any_opacity: bool

    def to(self, device):
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        lights = {k: (v.to(device) if isinstance(v, torch.Tensor) else v)
                  for k, v in self.lights.items()}
        return dataclasses.replace(self, lights=lights, **moved)

    @property
    def num_lights(self) -> int:
        return int(self.lights["num_lights"])


def flatten(meshes):
    """Global vertex pools with offset indices and per-triangle materials."""
    pools = {k: [] for k in ("positions", "normals", "uvs", "tangents",
                             "bitangents")}
    tris, mats, off = [], [], 0
    for m in meshes:
        for k in pools:
            pools[k].append(np.asarray(getattr(m, k), np.float32))
        t = np.asarray(m.indices, np.int64).reshape(-1, 3) + off
        tris.append(t)
        mats.append(np.full(t.shape[0], m.material_idx, np.int64))
        off += m.positions.shape[0]
    out = {k: np.concatenate(v) for k, v in pools.items()}
    out["tri_idx"] = np.concatenate(tris)
    out["tri_material"] = np.concatenate(mats)
    return out


def _stored(x, storage):
    return x.to(storage).to(torch.float32) if storage != torch.float32 else x


def build_scene(desc, storage=torch.float32) -> RefScene:
    flat = flatten(desc.meshes)
    rows, metas, base = [], {}, 0
    for name, data in desc.textures:
        h, w = data.shape[:2]
        metas[name] = (base, w, h)
        rows.append(np.asarray(data, np.float32).reshape(h * w, 4))
        base += h * w
    slot_meta = np.asarray([[metas[m[s]] for s in SLOTS]
                            for m in desc.materials], np.int32)
    has_op = np.asarray([bool(m["has_opacity"]) for m in desc.materials])
    lights = {"num_lights": 0}
    if desc.lights is not None:
        lights = {k: (torch.from_numpy(np.asarray(v, np.float32))
                      if k != "num_lights" else int(v))
                  for k, v in desc.lights.items()}
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    f = lambda a: _stored(t(a), storage)  # noqa: E731
    return RefScene(
        positions=t(flat["positions"]), normals=f(flat["normals"]),
        uvs=f(flat["uvs"]), tangents=f(flat["tangents"]),
        bitangents=f(flat["bitangents"]), tri_idx=t(flat["tri_idx"]),
        tri_material=t(flat["tri_material"]),
        texels=f(np.concatenate(rows)), slot_meta=t(slot_meta),
        has_opacity=t(has_op), lights=lights,
        any_opacity=bool(has_op.any()))


def bilinear_from_meta(texels, base, w, h, uv):
    """Bilinear wrap tap at mip 0: texels (N, 4); base/w/h (...,) int32;
    uv (..., 2) f32 -> (..., 4) f32 (sample coord = uv * size - 0.5)."""
    wf = w.to(torch.float32)
    hf = h.to(torch.float32)
    x = uv[..., 0] * wf - 0.5
    y = uv[..., 1] * hf - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int32), w)
    x1i = torch.remainder(x0i + 1, w)
    y0i = torch.remainder(y0.to(torch.int32), h)
    y1i = torch.remainder(y0i + 1, h)

    def fetch(yi, xi):
        return texels[(base + yi * w + xi).long()]

    t00 = fetch(y0i, x0i)
    t10 = fetch(y0i, x1i)
    t01 = fetch(y1i, x0i)
    t11 = fetch(y1i, x1i)
    top = t00 + (t10 - t00) * fx
    bot = t01 + (t11 - t01) * fx
    return top + (bot - top) * fy


def interpolate(scene: RefScene, name: str, tri_id, u, v):
    """Barycentric lerp of a vertex attribute at hits (v0 * w + v1 * u +
    v2 * v, w = 1 - u - v, in the program's order)."""
    arr = getattr(scene, name)
    tri = scene.tri_idx[torch.clamp_min(tri_id, 0)]
    w = (1.0 - u - v)[..., None]
    return (arr[tri[..., 0]] * w + arr[tri[..., 1]] * u[..., None]
            + arr[tri[..., 2]] * v[..., None])


def tap(scene: RefScene, mat, slot: str, uv):
    """The material slot's texture at `uv`, (..., 4)."""
    m = scene.slot_meta[mat, SLOTS.index(slot)]
    return bilinear_from_meta(scene.texels, m[..., 0], m[..., 1], m[..., 2],
                              uv)


def alpha_test(scene: RefScene):
    """accept(tri_id, u, v): the material has no opacity map, or its tap's
    channel 0 at the hit's UV is >= 0.35; None on a scene with none."""
    if not scene.any_opacity:
        return None

    def accept(tid, u, v):
        mat = scene.tri_material[torch.clamp_min(tid, 0)]
        uv = interpolate(scene, "uvs", tid, u, v)
        opacity = tap(scene, mat, "opacity", uv)[..., 0]
        return torch.where(scene.has_opacity[mat], opacity >= ALPHA_CUTOFF,
                           True)
    return accept
