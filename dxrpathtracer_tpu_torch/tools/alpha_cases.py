"""SponzaAlpha-checker: the alpha-tested, spot-lit Sponza-class scene.

The geometry of `scene.registry.sponza_alpha_standin` (the 246,084-triangle
stand-in plus 384 foliage cards of 2 triangles, material 1 alpha-tested)
with `tiny_alpha_scene`'s 64x64 checker bound as the cards' opacity, so that
about half of the card texels reject; the reference's foliage mask (a BC4
DDS, not in this repository) would make the same scene with real foliage,
and without a mask `sponza_alpha_standin` binds an opaque white texel that
rejects nothing. Four synthetic spot lights from `make_spot_lights` hang
at 9 m in a row over the atrium's centre aisle, pointing down, with
intensities of the order of the JAX package's raster spot test
(tests/test_raster.py:169-172) and a 14 m range (the atrium's height).
Used by chip_smoke.py.
"""

import dataclasses

from ..scene.registry import checker_mask, sponza_alpha_standin
from ..scene.types import make_spot_lights

NUM_CARDS = 384


def atrium_spot_lights(count: int = 4):
    """`count` (<= 8) spot lights over the atrium, pointing down: a row of
    four over the centre aisle, then a second row."""
    pos = [(x, 9.0, z) for z in (0.0, -3.0) for x in (-12.0, -4.0, 4.0, 12.0)]
    pos = pos[:count]
    return make_spot_lights(
        positions=pos,
        directions=[(0.0, 1.0, 0.0)] * len(pos),  # stored negated: down
        intensities=[(4000.0, 3800.0, 3500.0)] * len(pos),
        angular_attenuation=[(0.8, 1.4)] * len(pos),  # inner, outer (rad)
        light_range=14.0)


def sponza_alpha_checker(num_cards: int = NUM_CARDS, lights: int = 4):
    """(scene of CPU tensors, preset) of SponzaAlpha-checker."""
    scene, preset = sponza_alpha_standin(num_cards=num_cards,
                                         opacity_mask=checker_mask())
    if lights:
        scene = dataclasses.replace(scene, lights=atrium_spot_lights(lights))
    return scene, preset
