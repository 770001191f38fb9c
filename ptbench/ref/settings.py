"""The settings the reference reads, with the program's defaults.

A frozen copy of the defaults of the fields of
dxrpathtracer_tpu_torch/app/settings.py:57-124 (`AppSettings`) that path
tracing and baking read; a configuration's `settings` override them.
"""

import types

DEFAULTS = dict(
    enable_sun=True,
    enable_sky=True,
    sun_area_light_approximation=True,
    sun_size=1.0,
    sun_direction=(0.26, 0.987, -0.16),
    turbidity=2.0,
    ground_albedo=(0.25, 0.25, 0.25),
    render_lights=True,
    max_light_clamp=32,
    benchmark_mode=False,
    sqrt_num_samples=4,
    max_path_length=3,
    max_any_hit_path_length=1,
    enable_albedo_maps=True,
    enable_normal_maps=True,
    enable_diffuse=True,
    enable_specular=True,
    enable_direct=True,
    enable_indirect=True,
    enable_indirect_specular=False,
    apply_multiscattering_energy_compensation=True,
    roughness_scale=1.0,
    metallic_scale=1.0,
    enable_white_furnace_mode=False,
    clamp_roughness=False,
    avoid_caustic_paths=False,
)

SPOT_SHADOW_NEAR_CLIP = 0.1


def settings(overrides: dict, **more) -> types.SimpleNamespace:
    """The defaults with `overrides` and `more`; keys the reference does not
    read (the program's engine switches) are kept and ignored."""
    return types.SimpleNamespace(**{**DEFAULTS, **overrides, **more})
