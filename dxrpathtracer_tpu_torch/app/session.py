"""RenderSession — the progressive render loop.

The port of dxrpathtracer_tpu/app/session.py's path-tracing loop
(DXRPathTracer::Update/Render, DXRPathTracer.cpp:1338-1563): it owns the
scene, the two BVH tables, the camera, the sky cache and the accumulation, and
renders one progressive sample per `render_frame`. Any restart-relevant
settings change or camera move resets the accumulation to sample 0 (the
reference's watch list, :1416-1461); rendering stops at SqrtNumSamples^2
samples unless benchmark mode is on (:2026-2028). `render_raster_frame`
renders one forward-shaded frame instead (EnableRayTracing=false). Each pass
runs in a scope of the session's `profiler`, which is also a span of the
program's tracer (app/profiler.py): under `tracing()` a path-traced frame
is the span `frame` around `frame.update`, the pass `RenderRayTracing`,
`frame.constants` and the integrator's spans.

The traversal engines' structures are the session's, as in the JAX package:
the dense proxy and the AABB cut are built with the tables (the cut kept
only where its host probe clears at least CUT_MIN_CLEAR of
surface-hemisphere rays), and the sun-space grid is built on the host when
the first path-traced sample for a sun direction needs it (raster frames
never do) and again whenever the sun or the engine fields change.

The alpha-only table of the split alpha route (`bvh_alpha`, the
alpha-tested triangles two to a leaf) is built with the tables where the
scene has alpha-tested triangles; the integrator uses it under
DXRPT_SPLIT_ALPHA.

Two more, off by default, read the JAX package's switches where it reads
them: DXRPT_HISTORY at construction builds the triangle table and keeps a
temporal history (two (H*W,) int32 tensors of triangle ids in the frame's
lane order, -1 at first, reset with the accumulation); the software raster's
bins are built on the host for the camera where enable_sw_raster and
enable_packet_traversal are on, a 128-pixel tile divides the frame and the
frame has at least RASTER_MIN_PIXELS (DXRPT_RASTER_MIN_PIXELS) pixels, and
again whenever the camera or the frame size changes. The port renders the
frame in one pass, so the bins cover the frame (the JAX session's row slab).

The frame state is {accum, sample_idx}: `checkpoint_state` reads it back to
the host and `restore_state` resumes from it (a progressive render resumes
where it stopped). `display_thumbnail` is the interactive viewer's small
tone-mapped preview, made on the session's device. `rebuild_step` is the hot
reload hook (app/hotreload.py).
"""

import os
import time

import numpy as np
import torch

from ..accel.bvh import build_alpha_bvh_for_scene, build_bvh_for_scene
from ..accel.history import build_tri_table
from ..accel.proxy import (CUT_C, CUT_MIN_CLEAR, PROXY_K, build_aabb_cut,
                           build_dense_proxy, probe_clear_fraction)
from ..accel.sunspace import build_sun_grid_for_scene
from ..app.settings import SPOT_SHADOW_NEAR_CLIP, AppSettings, Scenes
from ..core.constants import FP16Scale
from ..core.math3 import div
from ..render.camera import FirstPersonCamera
from ..render.clusters import build_cluster_masks, froxel_bounding_spheres
from ..render.integrator import (FrameConstants, _make_alpha_test,
                                 _packet_tile_dims)
from ..render.postfx import post_process, tone_map_filmic_alu
from ..render.raster import forward_render
from ..render.shadows import (convert_depth_maps, filter_moment_maps,
                              prepare_cascades, prepare_spot_shadows,
                              render_cascade_depth_maps,
                              render_spot_depth_maps)
from ..render.swraster import build_raster_bins
from ..scene.registry import load_scene
from ..sky.skycache import SkyCache
from .profiler import Profiler, span


class RenderSession:
    """Progressive path tracer over one scene on one device.

    Rays route by the settings' engine fields as in the JAX package
    (render/integrator.py): packets, the sun-space grid, the dense proxy and
    the AABB cut in front of the per-ray walk, and the software raster
    (enable_sw_raster, gated by RASTER_MIN_PIXELS), each the CUDA kernel on
    a GPU and its plain torch version on the CPU; enable_mxu_traversal
    selects an engine the port does not have and is not read. The frame
    renders in one pass, with no row slabs.

    It runs on the card unless the caller passes device="cpu"; with no card
    it raises rather than carry on on the CPU. `scene` (CPU tensors, e.g.
    registry.sponza_alpha_standin's) replaces the settings' scene; its
    `preset`, when given, sets the camera and sun and forces white-furnace
    mode on the WhiteFurnace scene, as a scene switch does (without one,
    the camera keeps its default pose and the settings stay as given).
    `asset_root` is the directory the settings' scene is imported from
    (registry.load_scene); without one the scene is its stand-in.
    """

    def __init__(self, settings: AppSettings | None = None,
                 width: int = 1920, height: int = 1080, device="cuda",
                 scene=None, preset=None, asset_root=None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("RenderSession: no CUDA device (pass "
                               "device='cpu' to run the plain versions)")
        self.width = width
        self.height = height
        self.profiler = Profiler(self.device)
        self.settings = settings or AppSettings()
        if scene is None:
            scene, preset = load_scene(self.settings.current_scene,
                                       asset_root=asset_root)
        if preset is not None:
            # Scene switch forces white-furnace mode (DXRPathTracer.cpp:
            # 934-935)
            self.settings = self.settings.replace(
                enable_white_furnace_mode=(
                    preset.scene_enum == Scenes.WhiteFurnace),
                sun_direction=tuple(preset.sun_direction),
                current_scene=preset.scene_enum)
        self.preset = preset

        # W8 for depth-1 rays, with alpha-tested triangles flagged in its
        # leaf ids (no-op on opaque scenes); W32 (bf16 boxes) for every
        # deeper ray.
        with self.profiler.cpu_scope("BuildAccelStructure"):
            self.bvh = build_bvh_for_scene(scene, width=8,
                                           flag_alpha=True).to(self.device)
            self.bvh_ray = build_bvh_for_scene(scene,
                                               width=32).to(self.device)
            # the split alpha route's alpha-only table (two triangles a
            # leaf), where the scene has alpha-tested triangles
            self.bvh_alpha = build_alpha_bvh_for_scene(scene)
            if self.bvh_alpha is not None:
                self.bvh_alpha = self.bvh_alpha.to(self.device)
            self.proxy, self.cut, self.cut_clear_fraction = \
                screens_for_scene(scene)
            if self.proxy is not None:
                self.proxy = self.proxy.to(self.device)
            if self.cut is not None:
                self.cut = self.cut.to(self.device)
        # The scene on the host (CPU tensors; np.asarray views them) that
        # the lightmap atlas builders read, as the JAX package's scene_host.
        self.scene_host = scene
        # the temporal history, under the JAX package's switch; its
        # triangle table (accel/history.py) is built now, or by the raster
        # on first use
        self.tri_table = None
        self._history_on = bool(os.environ.get("DXRPT_HISTORY"))
        if self._history_on:
            self._triangle_table()
        self.scene = scene.to(self.device)

        self.camera = FirstPersonCamera(aspect=width / height)
        if preset is not None:
            self.camera.set_position(preset.camera_position)
            self.camera.set_x_rotation(preset.camera_rotation[0])
            self.camera.set_y_rotation(preset.camera_rotation[1])

        self.sky = SkyCache()
        self.sky_cube = None
        self._update_sky()

        self.sun_grid = None
        self._sun_grid_key = None
        self._geometry_moved = False
        self.sun_grid_build_s = None  # host seconds of the last grid build
        self.raster_bins = None
        self._raster_key = None
        self.raster_build_s = None    # host seconds of the last binning

        self.sample_idx = 0
        self._last_restart_key = None
        self._thumb_index = None
        self.reset_accumulation()
        self._render_sample = _resolve_render_sample()

        # the crash guard of the CLI (app/crashdump.py) reports the session
        # it finds in this registry
        from .crashdump import register_session
        register_session(self)

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
        with span("frame.constants"):
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

    def _restart_key(self):
        return (self.settings.restart_key(), self.camera.state_tuple(),
                self.width, self.height)

    def update(self):
        """Per-frame update: sky rebuild + restart detection
        (DXRPathTracer::Update, :1338-1461)."""
        self._update_sky()
        key = self._restart_key()
        if key != self._last_restart_key or self.settings.always_reset_path_trace:
            self._last_restart_key = key
            self.reset_accumulation()

    def rebuild_step(self):
        """Hot-reload hook: take the per-sample render from the modules as
        they are now, then restart the progressive accumulation (the
        reference re-creates its PSOs after a shader reload, App.cpp:231-237,
        and the path trace restarts)."""
        self._render_sample = _resolve_render_sample()
        self.reset_accumulation()

    def reset_accumulation(self):
        self._accum = torch.zeros((self.height, self.width, 3),
                                  dtype=torch.float32, device=self.device)
        # the temporal history restarts with it (-1: no prediction; a stale
        # id would still be exact, only slower)
        self._history = None
        if self._history_on:
            n = self.height * self.width
            self._history = {
                k: torch.full((n,), -1, dtype=torch.int32, device=self.device)
                for k in ("prim_tri", "sun_tri")}
        self.sample_idx = 0

    @property
    def history(self):
        """The temporal history {"prim_tri", "sun_tri": (H*W,) int32 in the
        frame's lane order}, or None without DXRPT_HISTORY."""
        return self._history

    def _triangle_table(self):
        """The (T, 9) triangle table of the session's geometry on its
        device, which the history and the raster's bins share; built on
        first use."""
        if self.tri_table is None:
            self.tri_table = torch.from_numpy(build_tri_table(
                self.scene_host.positions.numpy(),
                self.scene_host.tri_idx.numpy())).to(self.device)
        return self.tri_table

    # The software raster is off by default, as in the JAX package (where it
    # was measured a loss on the TPU); DXRPT_RASTER_MIN_PIXELS lowers the
    # gate.
    RASTER_MIN_PIXELS = 1 << 62

    def update_raster(self):
        """The software raster's bins for the current camera and frame, or
        None where they are not wanted (enable_sw_raster,
        enable_packet_traversal, a 128-pixel tile dividing the frame, at
        least RASTER_MIN_PIXELS pixels) or the geometry has moved. Built on
        the host under the BuildRasterBins scope when the camera, the frame
        size or the split alpha route's switch changed since the last
        build; `raster_build_s` keeps its seconds. Under DXRPT_SPLIT_ALPHA
        on a scene with an alpha-only table the bins are masked to its
        opaque triangles (opaque_only)."""
        s = self.settings
        min_px = int(os.environ.get("DXRPT_RASTER_MIN_PIXELS",
                                    self.RASTER_MIN_PIXELS))
        px = self.width * self.height
        dims = _packet_tile_dims(self.height, self.width)
        want = (s.enable_sw_raster and s.enable_packet_traversal
                and px >= min_px and dims is not None
                and not self._geometry_moved)
        # under the split alpha route the bins of an alpha scene hold only
        # its opaque triangles (the route's opaque-only step)
        opaque_only = (bool(os.environ.get("DXRPT_SPLIT_ALPHA"))
                       and self.bvh_alpha is not None)
        key = ((self.camera.state_tuple(), self.width, self.height,
                opaque_only) if want else None)
        if key != self._raster_key:
            self._raster_key = key
            self.raster_bins = None
            if want:
                t0 = time.perf_counter()
                host = self.scene_host
                opaque = None
                if opaque_only:
                    opaque = ~host.has_opacity.numpy().astype(bool)[
                        host.tri_material.numpy()]
                with self.profiler.cpu_scope("BuildRasterBins"):
                    self.raster_bins = build_raster_bins(
                        host.positions.numpy(), host.tri_idx.numpy(),
                        np.asarray(self.camera.view_projection(),
                                   np.float64),
                        float(self.camera.near_clip), self.width,
                        self.height, *dims, self._triangle_table(),
                        opaque_tris=opaque).to(self.device)
                self.raster_build_s = time.perf_counter() - t0
        return self.raster_bins

    def update_sun_grid(self):
        """The sun-space grid for the current settings, or None where they
        send no sun ray to it (enable_sunspace_shadows, enable_sun or
        white-furnace mode) or the geometry has moved. Built on the host
        under the BuildSunGrid scope when the sun direction or those fields
        changed since the last build; `sun_grid_build_s` keeps its
        seconds."""
        s = self.settings
        want = (s.enable_sunspace_shadows and s.enable_sun
                and not s.enable_white_furnace_mode
                and not self._geometry_moved)
        key = tuple(np.asarray(s.sun_direction, np.float32)) if want else None
        if key != self._sun_grid_key:
            self._sun_grid_key = key
            self.sun_grid = None
            if want:
                t0 = time.perf_counter()
                with self.profiler.cpu_scope("BuildSunGrid"):
                    sun_dir = np.asarray(s.sun_direction, np.float32)
                    self.sun_grid = build_sun_grid_for_scene(
                        self.scene_host, sun_dir / np.linalg.norm(sun_dir)
                    ).to(self.device)
                self.sun_grid_build_s = time.perf_counter() - t0
        return self.sun_grid

    def use_geometry(self, scene, bvh):
        """Render from now on `scene` (on the session's device) with every
        traversal class on `bvh`, a W8 table of that geometry built on the
        device (the `animate` command's moving geometry, as the JAX package
        routes it); resets the accumulation. The sun-space grid, the dense
        proxy, the AABB cut, the history's triangle table (and so the
        history), the raster bins and the alpha-only table describe the
        geometry as it was, so they are dropped, the history goes off
        (packets walk `bvh`) and so does the split alpha route."""
        self.scene, self.bvh, self.bvh_ray = scene, bvh, bvh
        self.proxy = self.cut = self.sun_grid = self.bvh_alpha = None
        self.tri_table = self.raster_bins = None
        self._history_on = False
        self._sun_grid_key = self._raster_key = None
        self._geometry_moved = True
        self.reset_accumulation()

    @property
    def accum(self) -> torch.Tensor:
        """The running-mean image (height, width, 3) f32."""
        return self._accum

    @accum.setter
    def accum(self, img: torch.Tensor):
        """Replace the running mean (the viewer shows a raster frame through
        it): a (height, width, 3) f32 tensor on the session's device."""
        want = (self.height, self.width, 3)
        if (not isinstance(img, torch.Tensor) or tuple(img.shape) != want
                or img.dtype != torch.float32):
            raise ValueError(f"accum: want a {want} float32 tensor, got "
                             f"{getattr(img, 'dtype', type(img).__name__)} "
                             f"{tuple(getattr(img, 'shape', ()))}")
        dev = self.device
        if img.device.type != dev.type or (dev.index is not None
                                           and img.device.index != dev.index):
            raise ValueError(f"accum: the tensor is on {img.device}, the "
                             f"session on {dev}")
        self._accum = img

    @property
    def done(self) -> bool:
        if self.settings.benchmark_mode:
            return False  # DXRPathTracer.cpp:109 Benchmark: never converge
        return self.sample_idx >= self.settings.total_samples

    def _step(self):
        frame = self.frame_constants(self.sample_idx)
        history = None
        if self._history is not None:
            history = {**self._history, "tri_table": self.tri_table}
        out = self._render_sample(
            self.scene, self.bvh, self.bvh_ray, self.sky_cube, self.settings,
            frame, self.width, self.height, self._accum,
            sun_grid=self.update_sun_grid(), proxy=self.proxy, cut=self.cut,
            history=history, raster=self.update_raster(),
            alpha_bvh=self.bvh_alpha)
        if history is None:
            self._accum = out
        else:
            self._accum, hist = out
            self._history = {k: hist[k] for k in ("prim_tri", "sun_tri")}
        self.sample_idx += 1

    def render_frame(self, force: bool = False) -> bool:
        """Render one progressive sample; returns False if converged
        (early-out at SqrtNumSamples^2, DXRPathTracer.cpp:2026-2028).
        Traced (app/profiler.py), it is the span `frame`, the update its
        `frame.update`."""
        with span("frame"):
            with span("frame.update"):
                self.update()
            if self.done and not force:
                return False
            with self.profiler.gpu_scope("RenderRayTracing"):
                self._step()
            return True

    def display_image(self) -> torch.Tensor:
        """The tone-mapped display image (PostProcessor::Render): bloom and
        the filmic curve over the accumulation, (height, width, 3) sRGB in
        [0, 1] on the session's device."""
        s = self.settings
        return post_process(self.accum, s.exposure, s.bloom_exposure,
                            s.bloom_magnitude, s.bloom_blur_sigma)

    def display_thumbnail(self, cols: int, rows: int) -> torch.Tensor:
        """The interactive viewer's preview, (rows, cols, 3) uint8 on the
        session's device: a strided subsample of the accumulation, exposed
        and tone-mapped (no bloom, which needs the full frame), so the
        present reads back ~40 KB, not the HDR frame."""
        if self._thumb_index is None or self._thumb_index[0] != (cols, rows):
            ys = np.linspace(0, self.height - 1, rows).astype(np.int32)
            xs = np.linspace(0, self.width - 1, cols).astype(np.int32)
            self._thumb_index = ((cols, rows),
                                 torch.from_numpy(ys).long().to(self.device),
                                 torch.from_numpy(xs).long().to(self.device))
        _, ys, xs = self._thumb_index
        small = self._accum[ys][:, xs]
        disp = tone_map_filmic_alu(
            div(small * (2.0 ** self.settings.exposure), FP16Scale))
        return torch.clamp(disp * 255.0, 0.0, 255.0).to(torch.uint8)

    def checkpoint_state(self) -> dict:
        """The progressive render's state, on the host: {accum (H, W, 3)
        f32 numpy, sample_idx}."""
        return {"accum": self._accum.cpu().numpy().copy(),
                "sample_idx": self.sample_idx}

    def restore_state(self, state: dict):
        """Resume from `checkpoint_state()`'s dict (this package's or the
        JAX package's): the next `update()` keeps the accumulation."""
        self.accum = torch.from_numpy(
            np.array(state["accum"], np.float32)).to(self.device)
        self.sample_idx = int(state["sample_idx"])
        self._last_restart_key = self._restart_key()

    def render_to_completion(self, max_samples: int | None = None):
        """Render samples until `max_samples` (default SqrtNumSamples^2) are
        accumulated; returns the accumulation."""
        n = max_samples or self.settings.total_samples
        while self.sample_idx < n:
            self._step()
        return self.accum

    def render_raster_frame(self, lightmap=None, lightmap_uvs=None,
                            shadow_mode: str = "rays",
                            shadow_map_size: int = 512):
        """One forward-rendered frame (EnableRayTracing=false path,
        DXRPathTracer::Render :1538-1559): cluster binning + ray-cast forward
        shading + skybox + weighted resolve. Returns (H, W, 3) radiance on
        the session's device. Raster rays walk the W32 table, alpha-tested
        on alpha scenes.

        shadow_mode: "rays" (exact BVH shadow rays), "pcf" (per-frame
        cascade depth maps + 7x7 PCF — the reference's shipped sun-shadow
        path, MeshRenderer.cpp:534-565 + Shadows.hlsl:318-360), or
        "evsm"/"msm" (moment shadow maps: the same cascade depth maps
        converted per SMConvert.hlsl, box-filtered, and sampled with the
        Chebyshev / 4-moment Hamburger bound; spot lights use their depth
        maps and PCF in all three). `lightmap` (S, S, 3) and `lightmap_uvs`
        (T, 3, 2) (numpy or tensors) light the frame from a bake when
        settings.enable_light_map_render is on."""
        if shadow_mode not in ("rays", "pcf", "evsm", "msm"):
            raise ValueError(f"unknown shadow mode {shadow_mode!r}")
        self._update_sky()
        dev = self.device
        sun_shadow_pcf = spot_shadow_pcf = None
        if shadow_mode != "rays":
            alpha = _make_alpha_test(self.scene, self.settings)
            sun_dir = np.asarray(self.settings.sun_direction, np.float32)
            cascades = prepare_cascades(self.camera,
                                        sun_dir / np.linalg.norm(sun_dir),
                                        map_size=shadow_map_size)
            with self.profiler.gpu_scope("RenderSunShadowMap"):
                depth_maps = render_cascade_depth_maps(
                    self.bvh_ray, cascades, shadow_map_size, alpha=alpha)
            if shadow_mode in ("evsm", "msm"):
                with self.profiler.gpu_scope("ConvertShadowMap"):
                    moments = filter_moment_maps(
                        convert_depth_maps(depth_maps, shadow_mode))
                sun_shadow_pcf = (moments, cascades, shadow_mode)
            else:
                sun_shadow_pcf = (depth_maps, cascades)
            if self.scene.num_lights > 0:
                # per-spot perspective depth + the same PCF kernel
                # (MeshRenderer.cpp:568-608)
                spots = prepare_spot_shadows(self.scene_host.lights,
                                             SPOT_SHADOW_NEAR_CLIP)
                with self.profiler.gpu_scope("RenderSpotShadowMap"):
                    spot_maps = render_spot_depth_maps(
                        self.bvh_ray, spots, min(shadow_map_size * 2, 1024),
                        alpha=alpha)
                spot_shadow_pcf = (spot_maps, spots)
        with self.profiler.cpu_scope("ClusterBounds"):
            spheres, dims = froxel_bounding_spheres(self.width, self.height,
                                                    self.camera)
        with self.profiler.gpu_scope("RenderClusters"):
            masks = build_cluster_masks(
                self.scene.lights, spheres,
                mode=self.settings.cluster_rasterization_mode)
        frame = self.frame_constants(self.sample_idx)
        sky_sh = (None if self.sky.sh9 is None
                  else torch.from_numpy(self.sky.sh9).to(dev))
        if lightmap is not None:
            lightmap = torch.as_tensor(lightmap, dtype=torch.float32,
                                       device=dev)
            lightmap_uvs = torch.as_tensor(lightmap_uvs, dtype=torch.float32,
                                           device=dev)
        with self.profiler.gpu_scope("RenderForward"):
            img = forward_render(
                self.scene, self.bvh_ray, self.sky_cube, sky_sh,
                self.settings, frame, self.width, self.height, masks, dims,
                self.camera.forward(), self.camera.near_clip,
                self.camera.far_clip, lightmap=lightmap,
                lightmap_uvs=lightmap_uvs, sun_shadow_pcf=sun_shadow_pcf,
                spot_shadow_pcf=spot_shadow_pcf)
        return img


def screens_for_scene(scene):
    """(dense proxy or None, AABB cut or None, the cut's probe fraction) of
    a scene (CPU tensors): the proxy of its PROXY_K largest opaque
    triangles, and the cut of CUT_C boxes where the probe clears at least
    CUT_MIN_CLEAR."""
    pos = scene.positions.cpu().numpy()
    tri = scene.tri_idx.cpu().numpy()
    tri_alpha = None
    if scene.any_opacity:
        tri_alpha = scene.has_opacity.cpu().numpy()[
            scene.tri_material.cpu().numpy()]
    proxy = build_dense_proxy(pos, tri, tri_alpha=tri_alpha, k=PROXY_K)
    cut = build_aabb_cut(pos, tri, c=CUT_C)
    frac = 0.0 if cut is None else probe_clear_fraction(cut, pos, tri)
    return proxy, cut if frac >= CUT_MIN_CLEAR else None, frac


def _resolve_render_sample():
    """The integrator's `render_sample` as the module holds it now (after a
    hot reload, the reloaded one)."""
    from ..render.integrator import render_sample
    return render_sample
