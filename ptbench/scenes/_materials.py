"""Materials and textures of the benchmark's scenes, as plain host data.

A scene generator returns a `SceneDesc`: meshes (scenes/_procedural.py),
textures by name, one row of texture names per material, and spot lights.
The harness hands it to the program's scene constructor (ptbench/port.py)
and the reference packs it itself (ptbench/ref/scene.py), so neither side
takes the other's tables.

The default texel values and the channel expansion are frozen copies of
dxrpathtracer_tpu_torch/scene/textures.py:27-30 and :45-86
(`AtlasBuilder.__init__` / `add`), the default material row of its
`default_material_table` (:166-184) and the spot-light arrays of
dxrpathtracer_tpu_torch/scene/types.py:124-155 (`make_spot_lights`).
"""

import dataclasses

import numpy as np

SLOTS = ("albedo", "normal", "roughness", "metallic", "opacity", "emissive")
MAX_SPOT_LIGHTS = 32

DEFAULT_BASECOLOR_UNORM = 192.0 / 255.0
DEFAULT_NORMAL = (127.0 / 255.0, 127.0 / 255.0, 1.0)
DEFAULT_ROUGHNESS_UNORM = 64.0 / 255.0


def _srgb_to_linear(c):
    c = np.asarray(c, np.float32)
    return np.where(c <= 0.04045, c / 12.92,
                    ((c + 0.055) / 1.055) ** 2.4).astype(np.float32)


def constant_texture(rgb, alpha: float = 1.0) -> np.ndarray:
    data = np.zeros((1, 1, 4), np.float32)
    data[..., :3] = np.asarray(rgb, np.float32)
    data[..., 3] = alpha
    return data


def expand_channels(data) -> np.ndarray:
    """(H, W, C) -> (H, W, 4) f32 as the texture pool stores it."""
    data = np.asarray(data, np.float32)
    if data.ndim == 2:
        data = data[..., None]
    if data.shape[-1] == 1:
        data = np.concatenate([np.repeat(data, 3, axis=-1),
                               np.ones_like(data)], axis=-1)
    elif data.shape[-1] == 2:
        one = np.ones_like(data[..., :1])
        data = np.concatenate([data, 0.0 * one, one], axis=-1)
    elif data.shape[-1] == 3:
        data = np.concatenate([data, np.ones_like(data[..., :1])], axis=-1)
    return data


def default_textures() -> list:
    """[(name, (1, 1, 4) f32)] in the program's reserved order."""
    return [
        ("__default_albedo", constant_texture((DEFAULT_BASECOLOR_UNORM,) * 3)),
        ("__default_albedo_srgb", constant_texture(
            tuple(_srgb_to_linear(DEFAULT_BASECOLOR_UNORM) for _ in range(3)))),
        ("__default_normal", constant_texture(DEFAULT_NORMAL)),
        ("__default_roughness",
         constant_texture((DEFAULT_ROUGHNESS_UNORM,) * 3)),
        ("__default_black", constant_texture((0.0, 0.0, 0.0))),
        ("__default_white", constant_texture((1.0, 1.0, 1.0))),
    ]


def default_material() -> dict:
    """One all-default material: a texture name per slot, no alpha test."""
    return dict(albedo="__default_albedo", normal="__default_normal",
                roughness="__default_roughness", metallic="__default_black",
                opacity="__default_white", emissive="__default_black",
                has_opacity=False)


def spot_lights(positions, directions, intensities, angular_attenuation,
                light_range: float) -> dict:
    """Padded spot-light arrays: the stored direction is the negated light
    axis and the attenuation values cos(angle / 2) of (inner, outer)."""
    n = min(len(positions), MAX_SPOT_LIGHTS)

    def pad(a, cols):
        out = np.zeros((MAX_SPOT_LIGHTS,) + cols, np.float32)
        out[:n] = np.asarray(a, np.float32)[:n]
        return out

    ang = np.asarray(angular_attenuation, np.float32)[:n]
    return dict(
        position=pad(positions, (3,)),
        direction=pad(directions, (3,)),
        intensity=pad(intensities, (3,)),
        angular_attenuation_x=pad(np.cos(ang[:, 0] * 0.5), ()),
        angular_attenuation_y=pad(np.cos(ang[:, 1] * 0.5), ()),
        range=pad(np.full(n, light_range, np.float32), ()),
        num_lights=n)


@dataclasses.dataclass
class SceneDesc:
    meshes: list            # [_procedural.MeshData]
    textures: list          # [(name, (H, W, 4) f32)], defaults first
    materials: list         # [dict: slot -> texture name, has_opacity]
    lights: dict | None = None  # spot_lights(...) or None
