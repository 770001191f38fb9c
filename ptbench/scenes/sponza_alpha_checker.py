"""SponzaAlpha-checker: the textured stand-in, 384 alpha-tested cards and
four spot lights.

A frozen copy of dxrpathtracer_tpu_torch/tools/alpha_cases.py
(`sponza_alpha_checker`, `atrium_spot_lights`) and of what it calls in
dxrpathtracer_tpu_torch/scene/registry.py: `sponza_card_meshes`
(:240-254, card seed 7), `alpha_materials` (:225-237) and `checker_mask`
(:275-279, 8 x 8 cells). The atrium takes Sponza's 25 materials
(sponza_standin.py); the cards take a 26th, `card`, with its own four maps
and, as Sponza's foliage does, an opacity map at the traffic's
`texture_size`: the checker of 8 x 8 cells drawn at that size (the port's
64^2 with cells of 8, at 1024^2 with cells of 128), so about half of a
card's texels reject a hit.
"""

import numpy as np

from ..ref.quaternion import quat_from_roll_pitch_yaw
from . import _sponza_materials, sponza_standin
from ._materials import SceneDesc, expand_channels, spot_lights
from ._procedural import make_plane

NUM_CARDS = 384
CARD_SEED = 7
CHECKER_CELLS = 8


def card_meshes(material_idx: int, num_cards: int = NUM_CARDS,
                seed: int = CARD_SEED) -> list:
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(num_cards):
        pos = (rng.uniform(-10.0, 10.0), rng.uniform(0.3, 7.0),
               rng.uniform(-4.5, 4.5))
        size = rng.uniform(0.6, 1.6)
        # stand the xz-plane card upright with a random yaw
        q = quat_from_roll_pitch_yaw(np.pi / 2.0,
                                     rng.uniform(0.0, np.pi), 0.0)
        out.append(make_plane((size, size), pos, orientation=q,
                              material_idx=material_idx))
    return out


def checker_mask(size: int = 64, cell: int = 8) -> np.ndarray:
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    return (((yy // cell + xx // cell) % 2).astype(np.float32))[..., None]


def atrium_spot_lights(count: int = 4) -> dict:
    pos = [(x, 9.0, z) for z in (0.0, -3.0) for x in (-12.0, -4.0, 4.0, 12.0)]
    pos = pos[:count]
    return spot_lights(
        positions=pos,
        directions=[(0.0, 1.0, 0.0)] * len(pos),  # stored negated: down
        intensities=[(4000.0, 3800.0, 3500.0)] * len(pos),
        angular_attenuation=[(0.8, 1.4)] * len(pos),  # inner, outer (rad)
        light_range=14.0)


def build(traffic) -> SceneDesc:
    size = int(traffic["texture_size"])
    names = _sponza_materials.NAMES + ("card",)
    textures, materials = _sponza_materials.materials(size, names)
    textures.append(("card_opacity", expand_channels(
        checker_mask(size, size // CHECKER_CELLS))))
    materials[-1].update(opacity="card_opacity", has_opacity=True)
    meshes = (_sponza_materials.assign(sponza_standin.meshes())
              + card_meshes(len(names) - 1))
    return SceneDesc(meshes=meshes, textures=textures, materials=materials,
                     lights=atrium_spot_lights(4))
