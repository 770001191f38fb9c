"""SkyCache — procedural sun/sky state (Graphics/Skybox.cpp:48-270 equivalent).

A numpy copy of dxrpathtracer_tpu/sky/skycache.py. Recomputed on host only
when (sunDirection, sunSize, groundAlbedo, turbidity) change — the
reference's dirty check (Skybox.cpp:59-61). Products:
  - sun_irradiance: RGB irradiance of the solar disc for a perpendicular surface,
    from a 64-sample Monte-Carlo integral over the physical disc, x FP16Scale
    x 683 lm/W x 100 (Skybox.cpp:81-141)
  - sun_render_color: uniform disc radiance = irradiance / (pi sin^2 theta),
    clamped to FP16Max (Skybox.cpp:144-154)
  - cubemap: (6, 128, 128, 3) sky radiance (sun excluded), x 683 x FP16Scale
    (Skybox.cpp:156-212, Sample at :252-270)
  - sh9: SH9 RGB projection of the cubemap with solid-angle weights (the
    raster path's ambient term)
  - sg_lobes: the 9-lobe spherical-Gaussian NNLS fit (Skybox.cpp:216-231)
"""

import dataclasses

import numpy as np

from ..core.constants import FP16Max, FP16Scale, Pi
from . import hosek
from .cubemap import build_cubemap_from_fn
from .sg import solve_sg_from_cubemap
from .sh import project_cubemap_sh9

# Physical sun angular radius used for the irradiance integral regardless of the
# artistic SunSize (Skybox.h: PhysicalSunSize = DegToRad(0.27deg)).
PHYSICAL_SUN_ANGULAR_RADIUS = np.deg2rad(0.27)
COS_PHYSICAL_SUN_SIZE = float(np.cos(PHYSICAL_SUN_ANGULAR_RADIUS))


def _perpendicular(v):
    """Float3::Perpendicular equivalent: any unit vector orthogonal to v."""
    a = np.abs(v)
    if a[0] <= a[1] and a[0] <= a[2]:
        o = np.array([1.0, 0.0, 0.0], np.float32)
    elif a[1] <= a[2]:
        o = np.array([0.0, 1.0, 0.0], np.float32)
    else:
        o = np.array([0.0, 0.0, 1.0], np.float32)
    p = np.cross(v, o)
    return p / np.linalg.norm(p)


@dataclasses.dataclass
class SkyCache:
    resolution: int = 128

    sun_direction: np.ndarray | None = None
    sun_size_deg: float = 0.0
    ground_albedo: np.ndarray | None = None
    turbidity: float = 0.0

    sun_irradiance: np.ndarray | None = None
    sun_render_color: np.ndarray | None = None
    cubemap: np.ndarray | None = None
    sh9: np.ndarray | None = None
    sg_lobes: object | None = None
    model_name: str = ""

    def initialized(self) -> bool:
        return self.cubemap is not None

    def update(self, sun_direction, sun_size_deg, ground_albedo,
               turbidity) -> bool:
        """Returns True when the cache was rebuilt (parameters changed)."""
        sun_direction = np.asarray(sun_direction, np.float32).copy()
        sun_direction[1] = np.clip(sun_direction[1], 0.0, 1.0)
        sun_direction /= np.linalg.norm(sun_direction)
        turbidity = float(np.clip(turbidity, 1.0, 32.0))
        ground_albedo = np.clip(np.asarray(ground_albedo, np.float32), 0.0, 1.0)
        sun_size_deg = max(float(sun_size_deg), 0.01)

        if (self.initialized()
                and np.array_equal(sun_direction, self.sun_direction)
                and np.array_equal(ground_albedo, self.ground_albedo)
                and turbidity == self.turbidity
                and sun_size_deg == self.sun_size_deg):
            return False

        self.sun_direction = sun_direction
        self.sun_size_deg = sun_size_deg
        self.ground_albedo = ground_albedo
        self.turbidity = turbidity

        model = hosek.make_sky_model(sun_direction, turbidity, ground_albedo)
        self.model_name = model.name

        # --- Solar-disc irradiance Monte-Carlo integral (Skybox.cpp:95-141) ---
        sun_x = _perpendicular(sun_direction)
        sun_y = np.cross(sun_direction, sun_x)
        num = 8
        xs, ys = np.meshgrid((np.arange(num) + 0.5) / num, (np.arange(num) + 0.5) / num,
                             indexing="ij")
        u1 = xs.reshape(-1)
        u2 = ys.reshape(-1)
        cos_t = (1.0 - u1) + u1 * COS_PHYSICAL_SUN_SIZE
        sin_t = np.sqrt(np.maximum(1.0 - cos_t * cos_t, 0.0))
        phi = u2 * 2.0 * Pi
        local = np.stack([np.cos(phi) * sin_t, np.sin(phi) * sin_t, cos_t], -1)
        dirs = local @ np.stack([sun_x, sun_y, sun_direction])

        radiance = model.solar_radiance(dirs) * FP16Scale  # (64, 3)
        cos_w = np.clip(dirs @ sun_direction, 0.0, 1.0)
        irr = (radiance * cos_w[:, None]).sum(axis=0)
        pdf = 1.0 / (2.0 * Pi * (1.0 - COS_PHYSICAL_SUN_SIZE))
        irr *= (1.0 / (num * num)) / pdf
        irr *= 683.0 * 100.0
        self.sun_irradiance = irr.astype(np.float32)

        # --- Uniform disc render color (Skybox.cpp:144-154) ---
        theta = np.deg2rad(sun_size_deg)
        irr_integral = Pi * np.sin(theta) ** 2
        sun_radiance = self.sun_irradiance / max(irr_integral, 1e-12)
        max_c = float(sun_radiance.max())
        if max_c > FP16Max:
            sun_radiance = sun_radiance * (FP16Max / max_c)
        self.sun_render_color = np.clip(sun_radiance, 0.0, FP16Max).astype(np.float32)

        def radiance_fn(d):
            return model.sky_radiance(d) * (683.0 * FP16Scale)

        self.cubemap = build_cubemap_from_fn(radiance_fn, self.resolution)
        self.sh9 = project_cubemap_sh9(self.cubemap)
        self.sg_lobes = solve_sg_from_cubemap(self.cubemap)
        return True
