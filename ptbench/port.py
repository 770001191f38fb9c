"""The program's side of a run: a scene description handed to the port.

Everything here calls `dxrpathtracer_tpu_torch`, the PyTorch and CUDA port
under test, through its public constructors. The reference (ptbench/ref/)
never imports this module.
"""

import numpy as np


def port_scene(desc):
    """The port's Scene (CPU tensors) of a scenes/ SceneDesc, through its
    own AtlasBuilder, MaterialTable and build_scene."""
    from dxrpathtracer_tpu_torch.scene.build import build_scene
    from dxrpathtracer_tpu_torch.scene.procedural import MeshData
    from dxrpathtracer_tpu_torch.scene.textures import AtlasBuilder
    from dxrpathtracer_tpu_torch.scene.types import (MaterialTable,
                                                     SpotLights)

    from .scenes._materials import SLOTS

    builder = AtlasBuilder()
    index = {name: builder.add(name, data) for name, data in desc.textures}
    materials = MaterialTable(
        **{s: np.asarray([index[m[s]] for m in desc.materials], np.int32)
           for s in SLOTS},
        has_opacity=np.asarray([bool(m["has_opacity"])
                                for m in desc.materials], bool))
    meshes = [MeshData(m.positions, m.normals, m.uvs, m.tangents,
                       m.bitangents, m.indices, m.material_idx)
              for m in desc.meshes]
    lights = None
    if desc.lights is not None:
        arrays = {k: v for k, v in desc.lights.items() if k != "num_lights"}
        lights = SpotLights.from_numpy(arrays, desc.lights["num_lights"])
    return build_scene(meshes, materials=materials, atlas_builder=builder,
                       lights=lights)


def port_preset(traffic):
    """A ScenePreset of the port with the traffic's camera and sun (the
    Sponza preset's scene enum: its scale and FBX are not read)."""
    import dataclasses

    from dxrpathtracer_tpu_torch.app.settings import Scenes
    from dxrpathtracer_tpu_torch.scene.registry import PRESETS

    cam = traffic["camera"]
    return dataclasses.replace(
        PRESETS[Scenes.Sponza],
        camera_position=tuple(cam["position"]),
        camera_rotation=tuple(cam["rotation"]),
        sun_direction=tuple(traffic["sun_direction"]))


def port_settings(config):
    """The port's AppSettings of a configuration's `settings`."""
    from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes
    return AppSettings(current_scene=Scenes.Sponza, **config["settings"])
