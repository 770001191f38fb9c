"""Application settings — single-source-of-truth registry.

Replaces the reference's three-stage settings machine (AppSettings.cs C# DSL ->
SettingsCompiler.exe -> generated AppSettings.{h,cpp,hlsl}, see
DXRPathTracer/AppSettings.cs:36-237 and SettingsCompiler/SettingsCompiler.cs:18-51)
with one Python dataclass: fields/defaults/ranges mirror AppSettings.cs exactly.

A copy of dxrpathtracer_tpu/app/settings.py, field for field, so that one
settings object means the same render in both packages. Any change that the
reference watches to restart the path trace (DXRPathTracer.cpp:1416-1461)
changes `restart_key()`, and RenderSession resets its accumulation.

The engine-select fields (enable_packet_traversal, enable_mxu_traversal,
packet_shadows_all_depths, enable_sunspace_shadows, enable_sw_raster,
enable_dense_proxy, enable_clear_cut) choose among exact alternates of the
per-ray walk in the JAX package. The port has only the per-ray walk and
reads none of them; they stay so that settings compare equal across packages.
"""

import dataclasses
import enum


class MSAAModes(enum.IntEnum):
    MSAANone = 0
    MSAA2x = 1
    MSAA4x = 2


class Scenes(enum.IntEnum):
    Sponza = 0
    SunTemple = 1
    BoxTest = 2
    WhiteFurnace = 3
    Stronghold = 4


# Compile-time constants (AppSettings.cs:89-117)
CLUSTER_TILE_SIZE = 16
NUM_Z_TILES = 16
MAX_SPOT_LIGHTS = 32
SPOT_LIGHT_RANGE = 7.5
SPOT_SHADOW_NEAR_CLIP = 0.1
NUM_SAMPLE_SETS = 8
SAMPLE_TILE_SIZE = 32
NUM_PIXELS_PER_TILE = 1024
MAX_PATH_LENGTH_SETTING = 8


@dataclasses.dataclass(frozen=True)
class AppSettings:
    # --- Sun and sky (AppSettings.cs:39-69) ---
    enable_sun: bool = True
    enable_sky: bool = True
    sun_area_light_approximation: bool = True
    sun_size: float = 1.0                     # angular radius, degrees
    sun_direction: tuple = (0.26, 0.987, -0.16)
    turbidity: float = 2.0
    ground_albedo: tuple = (0.25, 0.25, 0.25)

    # --- Anti aliasing ---
    msaa_mode: MSAAModes = MSAAModes.MSAA4x

    # --- Scene ---
    current_scene: Scenes = Scenes.BoxTest
    render_lights: bool = True

    # --- Rendering ---
    max_light_clamp: int = MAX_SPOT_LIGHTS
    # ClusterRasterizationMode accuracy ladder (raster path): 0 = froxel
    # center point, 1/2 = fractional bounding radius, 3 = conservative full
    # bounding sphere (render/clusters.py _CLUSTER_MODE_RADIUS_SCALE)
    cluster_rasterization_mode: int = 3

    # --- Path tracing (AppSettings.cs:119-147) ---
    enable_ray_tracing: bool = True
    # Engine selection in the JAX package (see the module docstring): the
    # port routes every ray per-ray whatever these say.
    enable_packet_traversal: bool = True
    enable_mxu_traversal: bool = False
    packet_shadows_all_depths: bool = False
    enable_sunspace_shadows: bool = True
    enable_sw_raster: bool = True
    enable_dense_proxy: bool = True
    enable_clear_cut: bool = True
    clamp_roughness: bool = False
    avoid_caustic_paths: bool = False
    # Benchmark mode (the reference's `static const bool Benchmark`,
    # DXRPathTracer.cpp:109,247-253: pinned settings + no convergence stop
    # so frame times are measured on the steady-state progressive loop).
    # Here: disables the SqrtNumSamples^2 early-out; the CMJ pattern keeps
    # its production size, so a benchmark frame is a normal frame.
    benchmark_mode: bool = False
    sqrt_num_samples: int = 4
    max_path_length: int = 3
    max_any_hit_path_length: int = 1

    # --- Post processing (AppSettings.cs:149-178) ---
    exposure: float = -14.0
    bloom_exposure: float = -4.0
    bloom_magnitude: float = 1.0
    bloom_blur_sigma: float = 2.5

    # --- Debug (AppSettings.cs:180-237) ---
    enable_vsync: bool = True
    stable_power_state: bool = False
    enable_albedo_maps: bool = True
    enable_normal_maps: bool = True
    enable_diffuse: bool = True
    enable_specular: bool = True
    enable_direct: bool = True
    enable_indirect: bool = True
    enable_indirect_specular: bool = False
    apply_multiscattering_energy_compensation: bool = True
    roughness_scale: float = 1.0
    metallic_scale: float = 1.0
    enable_white_furnace_mode: bool = False
    always_reset_path_trace: bool = False
    show_progress_bar: bool = True
    enable_light_map_render: bool = False

    def replace(self, **kw) -> "AppSettings":
        return dataclasses.replace(self, **kw)

    # --- Path-trace restart tracking -------------------------------------
    # The reference restarts progressive accumulation when any of these change
    # (DXRPathTracer.cpp:1416-1461 settings watch list).
    _RESTART_FIELDS = (
        "enable_sun", "enable_sky", "sun_area_light_approximation", "sun_size",
        "sun_direction", "turbidity", "ground_albedo", "current_scene",
        "render_lights", "max_light_clamp", "enable_ray_tracing",
        "clamp_roughness", "avoid_caustic_paths", "sqrt_num_samples",
        "max_path_length", "max_any_hit_path_length", "enable_albedo_maps",
        "enable_normal_maps", "enable_diffuse", "enable_specular",
        "enable_direct", "enable_indirect", "enable_indirect_specular",
        "apply_multiscattering_energy_compensation", "roughness_scale",
        "metallic_scale", "enable_white_furnace_mode",
    )

    def restart_key(self):
        return tuple(getattr(self, f) for f in self._RESTART_FIELDS)

    @property
    def total_samples(self) -> int:
        """Progressive render target sample count (stop at SqrtNumSamples^2,
        DXRPathTracer.cpp:2026-2028)."""
        return self.sqrt_num_samples * self.sqrt_num_samples
