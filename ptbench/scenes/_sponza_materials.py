"""Sponza's material set, made procedurally: 25 materials, each with its own
albedo, normal, roughness and metallic map at the traffic's `texture_size`
(1024^2 in the cells), spread over the stand-in's meshes.

The Crytek Sponza that MJP's DXRPathTracer renders binds 25 materials
(its sponza.mtl), most with 1024^2 maps; the asset is absent, so the count,
the names and the resolution are taken as assumed (configs/*.json
`assumed`). What a tap costs follows from the sizes of the maps and the
addresses read, which are a deployment's: 25 x 4 maps of 1024^2 texels
hold 1.68 GB in the program's float32 pool. The values are smooth seeded
waves (a fixed seed of their own, not the run's), whole periods across a
map so that the wrap is seamless, in plausible ranges: albedo 0.1-0.84,
sqrt-roughness 0.35-1, metallic 0 but on the metal materials, normals
tilted by up to ~20 degrees. Sponza has no emissive maps: that slot keeps
the default black texel.
"""

import dataclasses

import numpy as np
import torch

from ._materials import default_material, default_textures

NAMES = ("floor", "bricks", "arch", "column_a", "column_b", "column_c",
         "ceiling", "roof", "details", "flagpole", "chain", "lion",
         "background", "vase", "vase_round", "vase_hanging", "vase_plant",
         "leaf", "material_47", "fabric_a", "fabric_c", "fabric_d",
         "fabric_e", "fabric_f", "fabric_g")
METALS = ("flagpole", "chain", "vase_hanging")
SEED = 25


def _map(rng, size: int, mid, amp) -> np.ndarray:
    """(size, size, 4) f32 = mid + amp * wy(y) * wx(x) per channel, wx and
    wy seeded sine waves of whole periods (one pass, in torch)."""
    t = np.arange(size, dtype=np.float64) * (2.0 * np.pi / size)
    fx, fy = rng.integers(1, 9, 2)
    px, py = rng.random(2) * 2.0 * np.pi
    wx = torch.from_numpy(np.sin(fx * t + px).astype(np.float32))
    wy = torch.from_numpy(np.sin(fy * t + py).astype(np.float32))
    mid = torch.tensor(mid, dtype=torch.float32)
    amp = torch.tensor(amp, dtype=torch.float32)
    return torch.addcmul(mid.view(1, 1, 4), (wy[:, None] * amp)[:, None],
                         wx.view(1, size, 1)).numpy()


def material_maps(rng, size: int, metal: bool) -> dict:
    """{slot: (size, size, 4) f32} of one material's four maps."""
    base = list(rng.uniform(0.12, 0.7, 3))
    return dict(
        albedo=_map(rng, size, base + [1.0], [0.2 * b for b in base] + [0.0]),
        normal=_map(rng, size, (0.5, 0.5, 1.0, 1.0), (0.15, -0.1, 0.0, 0.0)),
        roughness=_map(rng, size, (0.675,) * 3 + (1.0,),
                       (0.325,) * 3 + (0.0,)),
        metallic=(_map(rng, size, (0.95,) * 3 + (1.0,), (0.05,) * 3 + (0.0,))
                  if metal else _map(rng, size, (0.0,) * 3 + (1.0,),
                                     (0.0,) * 4)))


def materials(size: int, names=NAMES, seed: int = SEED):
    """(textures, materials): the default textures and each named
    material's four maps, in the SceneDesc's form; material i is names[i]."""
    rng = np.random.default_rng(seed)
    textures = default_textures()
    rows = []
    for name in names:
        maps = material_maps(rng, size, name in METALS)
        row = default_material()
        for slot, data in maps.items():
            textures.append((f"{name}_{slot}", data))
            row[slot] = f"{name}_{slot}"
        rows.append(row)
    return textures, rows


def assign(meshes) -> list:
    """The stand-in's meshes (sponza_standin.meshes' order: floor, two side
    walls, two long walls, 22 pillars, the spheres) with Sponza's materials
    spread over them: floor, bricks, arch, the three column materials by
    pillar, and the other 19 over the spheres in turn."""
    index = {n: i for i, n in enumerate(NAMES)}
    rest = [i for i, n in enumerate(NAMES)
            if n not in ("floor", "bricks", "arch", "column_a", "column_b",
                         "column_c")]
    mats = [index["floor"]] + [index["bricks"]] * 2 + [index["arch"]] * 2
    pillars = [index[f"column_{c}"] for c in "abc"]
    mats += [pillars[k % 3] for k in range(22)]
    mats += [rest[k % len(rest)] for k in range(len(meshes) - len(mats))]
    return [dataclasses.replace(m, material_idx=i)
            for m, i in zip(meshes, mats)]
