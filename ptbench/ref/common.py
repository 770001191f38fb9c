"""What the reference's frame and bake share: the scene, tree, sky and
per-frame constants of a configuration and a traffic mix, built from the
scene description alone."""

import numpy as np
import torch

from .bvh import build as build_bvh
from .camera import FirstPersonCamera
from .integrator import Frame
from .scene import build_scene
from .settings import settings as make_settings
from .sky import build_sky


def world(desc, config, traffic, device, storage=torch.float32):
    """(scene, bvh, sky_cube, settings, frame) on `device`; the tables
    held in `storage` (ref/scene.py)."""
    s = make_settings(config.get("settings", {}),
                      sun_direction=tuple(traffic["sun_direction"]))
    scene = build_scene(desc, storage).to(device)
    bvh = build_bvh(scene.positions.cpu().numpy(),
                    scene.tri_idx.cpu().numpy()).to(device)
    sky = build_sky(np.asarray(s.sun_direction, np.float32), s.sun_size,
                    np.asarray(s.ground_albedo, np.float32), s.turbidity)
    cube = torch.from_numpy(sky["cubemap"])
    if storage != torch.float32:
        cube = cube.to(storage).to(torch.float32)
    width = int(config.get("width", 1920))
    height = int(config.get("height", 1080))
    cam = FirstPersonCamera(aspect=width / height)
    cam.set_position(traffic["camera"]["position"])
    cam.set_x_rotation(traffic["camera"]["rotation"][0])
    cam.set_y_rotation(traffic["camera"]["rotation"][1])
    sun_dir = np.asarray(s.sun_direction, np.float32)
    sun_dir = sun_dir / np.linalg.norm(sun_dir)
    ang = np.deg2rad(s.sun_size)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32),  # noqa: E731
                                 device=device)
    frame = Frame(inv_view_projection=f32(cam.inv_view_projection()),
                  sun_direction_ws=f32(sun_dir),
                  sun_irradiance=f32(sky["sun_irradiance"]),
                  sun_render_color=f32(sky["sun_render_color"]),
                  cos_sun_angular_radius=f32(np.cos(ang)),
                  sin_sun_angular_radius=f32(np.sin(ang)))
    return scene, bvh, cube.to(device), s, frame


def chunks(total: int, size: int):
    for lo in range(0, total, size):
        yield lo, min(total, lo + size)
