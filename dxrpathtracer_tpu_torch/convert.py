"""Turn the JAX package's host arrays into the port's objects.

The parity tests build one scene, its BVH tables, the sky cube and the frame
constants with dxrpathtracer_tpu, read them back as numpy arrays, and feed the
very same values to both packages through these functions. This module
imports no JAX: callers pass plain numpy arrays and Python numbers.
"""

import numpy as np
import torch

from .accel.bvh import FlatBVH
from .render.integrator import FrameConstants
from .scene.types import SCENE_ARRAYS, Scene


def scene_from_numpy(arrays: dict[str, np.ndarray],
                     num_lights: int = 0) -> Scene:
    """Scene (CPU tensors, copies) from a dict holding every name in
    scene.types.SCENE_ARRAYS."""
    return Scene.from_numpy({k: np.array(arrays[k]) for k in SCENE_ARRAYS},
                            num_lights=num_lights)


def bvh_from_numpy(table, num_rows: int, max_depth: int, root_code: int,
                   width: int, has_alpha_flags: bool = False) -> FlatBVH:
    """FlatBVH (CPU tensor) from a (rows, 128) f32 table and its constants."""
    table = np.array(table, np.float32)  # a writable copy
    if table.shape != (num_rows, 128):
        raise ValueError(f"table shape {table.shape} != ({num_rows}, 128)")
    return FlatBVH(table=torch.from_numpy(table), num_rows=int(num_rows),
                   max_depth=int(max_depth), root_code=int(root_code),
                   width=int(width), has_alpha_flags=bool(has_alpha_flags))


def frame_from_numpy(inv_view_projection, camera_pos_ws, sun_direction_ws,
                     sun_irradiance, sun_render_color, cos_sun_angular_radius,
                     sin_sun_angular_radius,
                     curr_sample_idx: int) -> FrameConstants:
    """FrameConstants (CPU tensors) from host values."""
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32))
    return FrameConstants(
        inv_view_projection=f32(inv_view_projection).reshape(4, 4),
        camera_pos_ws=f32(camera_pos_ws).reshape(3),
        sun_direction_ws=f32(sun_direction_ws).reshape(3),
        sun_irradiance=f32(sun_irradiance).reshape(3),
        sun_render_color=f32(sun_render_color).reshape(3),
        cos_sun_angular_radius=f32(cos_sun_angular_radius).reshape(()),
        sin_sun_angular_radius=f32(sin_sun_angular_radius).reshape(()),
        curr_sample_idx=int(curr_sample_idx))
