"""The reference's sky: the sun's irradiance and disc colour and the sky
cubemap of the Hosek-Wilkie model, computed from the settings.

A frozen copy of dxrpathtracer_tpu_torch/sky/skycache.py:41-126
(`_perpendicular`, `SkyCache.update`) without the SH9 and SG fits, which
only the raster view reads.
"""

import numpy as np

from . import hosek
from .constants import FP16Max, FP16Scale, Pi
from .cubemap import build_cubemap_from_fn

PHYSICAL_SUN_ANGULAR_RADIUS = np.deg2rad(0.27)
COS_PHYSICAL_SUN_SIZE = float(np.cos(PHYSICAL_SUN_ANGULAR_RADIUS))


def _perpendicular(v):
    a = np.abs(v)
    if a[0] <= a[1] and a[0] <= a[2]:
        o = np.array([1.0, 0.0, 0.0], np.float32)
    elif a[1] <= a[2]:
        o = np.array([0.0, 1.0, 0.0], np.float32)
    else:
        o = np.array([0.0, 0.0, 1.0], np.float32)
    p = np.cross(v, o)
    return p / np.linalg.norm(p)


def build_sky(sun_direction, sun_size_deg, ground_albedo, turbidity,
              resolution: int = 128) -> dict:
    """{sun_irradiance (3,), sun_render_color (3,), cubemap (6, R, R, 3)}."""
    sun_direction = np.asarray(sun_direction, np.float32).copy()
    sun_direction[1] = np.clip(sun_direction[1], 0.0, 1.0)
    sun_direction /= np.linalg.norm(sun_direction)
    turbidity = float(np.clip(turbidity, 1.0, 32.0))
    ground_albedo = np.clip(np.asarray(ground_albedo, np.float32), 0.0, 1.0)
    sun_size_deg = max(float(sun_size_deg), 0.01)

    model = hosek.make_sky_model(sun_direction, turbidity, ground_albedo)
    sun_x = _perpendicular(sun_direction)
    sun_y = np.cross(sun_direction, sun_x)
    num = 8
    xs, ys = np.meshgrid((np.arange(num) + 0.5) / num,
                         (np.arange(num) + 0.5) / num, indexing="ij")
    u1 = xs.reshape(-1)
    u2 = ys.reshape(-1)
    cos_t = (1.0 - u1) + u1 * COS_PHYSICAL_SUN_SIZE
    sin_t = np.sqrt(np.maximum(1.0 - cos_t * cos_t, 0.0))
    phi = u2 * 2.0 * Pi
    local = np.stack([np.cos(phi) * sin_t, np.sin(phi) * sin_t, cos_t], -1)
    dirs = local @ np.stack([sun_x, sun_y, sun_direction])
    radiance = model.solar_radiance(dirs) * FP16Scale
    cos_w = np.clip(dirs @ sun_direction, 0.0, 1.0)
    irr = (radiance * cos_w[:, None]).sum(axis=0)
    pdf = 1.0 / (2.0 * Pi * (1.0 - COS_PHYSICAL_SUN_SIZE))
    irr *= (1.0 / (num * num)) / pdf
    irr *= 683.0 * 100.0
    sun_irradiance = irr.astype(np.float32)

    theta = np.deg2rad(sun_size_deg)
    irr_integral = Pi * np.sin(theta) ** 2
    sun_radiance = sun_irradiance / max(irr_integral, 1e-12)
    max_c = float(sun_radiance.max())
    if max_c > FP16Max:
        sun_radiance = sun_radiance * (FP16Max / max_c)
    sun_render_color = np.clip(sun_radiance, 0.0, FP16Max).astype(np.float32)

    def radiance_fn(d):
        return model.sky_radiance(d) * (683.0 * FP16Scale)

    return dict(sun_irradiance=sun_irradiance,
                sun_render_color=sun_render_color,
                cubemap=build_cubemap_from_fn(radiance_fn, resolution))
