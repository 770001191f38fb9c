"""RenderSession — the progressive render loop.

The port of dxrpathtracer_tpu/app/session.py's path-tracing loop
(DXRPathTracer::Update/Render, DXRPathTracer.cpp:1338-1563): it owns the
scene, the two BVH tables, the camera, the sky cache and the accumulation, and
renders one progressive sample per `render_frame`. Any restart-relevant
settings change or camera move resets the accumulation to sample 0 (the
reference's watch list, :1416-1461); rendering stops at SqrtNumSamples^2
samples unless benchmark mode is on (:2026-2028).
"""

import numpy as np
import torch

from ..accel.bvh import build_bvh_for_scene
from ..app.settings import AppSettings, Scenes
from ..render.camera import FirstPersonCamera
from ..render.integrator import FrameConstants, render_sample
from ..scene.registry import load_scene
from ..sky.skycache import SkyCache


class RenderSession:
    """Progressive path tracer over one scene on one device.

    Every ray goes through the per-ray BVH traversal (accel/traverse.py): the
    CUDA kernel on a GPU, its plain torch version on the CPU. The JAX
    package's engine-select settings (enable_packet_traversal,
    enable_sunspace_shadows, enable_sw_raster, enable_dense_proxy,
    enable_clear_cut, enable_mxu_traversal) choose among exact alternates of
    that walk; the port routes per-ray whatever their values. The frame
    renders in one pass, with no row slabs.

    It runs on the card unless the caller passes device="cpu"; with no card
    it raises rather than carry on on the CPU.
    """

    def __init__(self, settings: AppSettings | None = None,
                 width: int = 1920, height: int = 1080, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("RenderSession: no CUDA device (pass "
                               "device='cpu' to run the plain versions)")
        self.width = width
        self.height = height
        settings = settings or AppSettings()
        scene, preset = load_scene(settings.current_scene)
        # Scene switch forces white-furnace mode (DXRPathTracer.cpp:934-935)
        self.settings = settings.replace(
            enable_white_furnace_mode=preset.scene_enum == Scenes.WhiteFurnace,
            sun_direction=tuple(preset.sun_direction),
            current_scene=preset.scene_enum)
        self.preset = preset

        # W8 for depth-1 rays, W32 (bf16 boxes) for every deeper ray.
        self.bvh = build_bvh_for_scene(scene, width=8).to(self.device)
        self.bvh_ray = build_bvh_for_scene(scene, width=32).to(self.device)
        # The scene on the host (CPU tensors; np.asarray views them) that
        # the lightmap atlas builders read, as the JAX package's scene_host.
        self.scene_host = scene
        self.scene = scene.to(self.device)

        self.camera = FirstPersonCamera(aspect=width / height)
        self.camera.set_position(preset.camera_position)
        self.camera.set_x_rotation(preset.camera_rotation[0])
        self.camera.set_y_rotation(preset.camera_rotation[1])

        self.sky = SkyCache()
        self.sky_cube = None
        self._update_sky()

        self.sample_idx = 0
        self._last_restart_key = None
        self.reset_accumulation()

    def _update_sky(self):
        s = self.settings
        changed = self.sky.update(np.asarray(s.sun_direction, np.float32),
                                  s.sun_size,
                                  np.asarray(s.ground_albedo, np.float32),
                                  s.turbidity)
        if changed or self.sky_cube is None:
            self.sky_cube = torch.from_numpy(self.sky.cubemap).to(self.device)
        return changed

    def frame_constants(self, sample_idx: int) -> FrameConstants:
        """Per-frame constants on the session's device (the reference's
        constant-buffer upload)."""
        s = self.settings
        sun_dir = np.asarray(s.sun_direction, np.float32)
        sun_dir = sun_dir / np.linalg.norm(sun_dir)
        ang = np.deg2rad(s.sun_size)
        f32 = lambda a: torch.tensor(np.asarray(a, np.float32))
        return FrameConstants(
            inv_view_projection=f32(self.camera.inv_view_projection()),
            camera_pos_ws=f32(self.camera.position),
            sun_direction_ws=f32(sun_dir),
            sun_irradiance=f32(self.sky.sun_irradiance),
            sun_render_color=f32(self.sky.sun_render_color),
            cos_sun_angular_radius=f32(np.cos(ang)),
            sin_sun_angular_radius=f32(np.sin(ang)),
            curr_sample_idx=int(sample_idx),
        ).to(self.device)

    def update(self):
        """Per-frame update: sky rebuild + restart detection
        (DXRPathTracer::Update, :1338-1461)."""
        self._update_sky()
        key = (self.settings.restart_key(), self.camera.state_tuple(),
               self.width, self.height)
        if key != self._last_restart_key or self.settings.always_reset_path_trace:
            self._last_restart_key = key
            self.reset_accumulation()

    def reset_accumulation(self):
        self._accum = torch.zeros((self.height, self.width, 3),
                                  dtype=torch.float32, device=self.device)
        self.sample_idx = 0

    @property
    def accum(self) -> torch.Tensor:
        """The running-mean image (height, width, 3) f32."""
        return self._accum

    @property
    def done(self) -> bool:
        if self.settings.benchmark_mode:
            return False  # DXRPathTracer.cpp:109 Benchmark: never converge
        return self.sample_idx >= self.settings.total_samples

    def _step(self):
        frame = self.frame_constants(self.sample_idx)
        self._accum = render_sample(self.scene, self.bvh, self.bvh_ray,
                                    self.sky_cube, self.settings, frame,
                                    self.width, self.height, self._accum)
        self.sample_idx += 1

    def render_frame(self, force: bool = False) -> bool:
        """Render one progressive sample; returns False if converged
        (early-out at SqrtNumSamples^2, DXRPathTracer.cpp:2026-2028)."""
        self.update()
        if self.done and not force:
            return False
        self._step()
        return True

    def render_to_completion(self, max_samples: int | None = None):
        """Render samples until `max_samples` (default SqrtNumSamples^2) are
        accumulated; returns the accumulation."""
        n = max_samples or self.settings.total_samples
        while self.sample_idx < n:
            self._step()
        return self.accum
