"""GI lightmap baker on torch tensors.

The port of dxrpathtracer_tpu/bake/baker.py. Parity with
RenderBakingPass/RenderBakingPass_Progressive + BakeRayGen
(DXRPathTracer.cpp:1845-2022, Baking.hlsl:336-466):
  1. surface maps at bake resolution (bake/surface_map.py),
  2. one cosine-hemisphere sample per covered texel per step (CMJ set 0,
     permutation = the GLOBAL texel index; BakingCB.SampleIndex is the
     progressive counter),
  3. the sample is traced through the same integrator the frame uses
     (render/integrator.trace_paths), starting with PathLength 1,
     IsDiffuse = true, TMin = 1e-4, origin nudged 1e-5 along the ray; the
     per-ray walks take the W32 table, opaque sun rays the session's
     sun-space grid and opaque shadow rays the dense-proxy screen, as in the
     JAX package (no packets: hemisphere rays are not coherent; no cut),
  4. firefly clamp against 10x the running-mean luminance
     (Baking.hlsl:431-447),
  5. NaN + too-dark (luminance < 1e-4) sample rejection: the accumulation
     holds (colorSum, validCount) and the lightmap is colorSum / validCount
     (Baking.hlsl:449-466),
  6. denoise: median 3x3, a-trous, guided bilateral or the learned CNN
     (render/denoise.py, render/learned_denoise.py).

The accumulation {accum (S,S,4), sample_index} checkpoints to an .npz in the
JAX package's format, so a bake resumes in either package.
"""

import time

import numpy as np
import torch

from ..app.profiler import span, spanned
from ..app.settings import AppSettings
from ..core import cmj
from ..core.constants import FP32Max
from ..core.math3 import cross, dot, sqrt
from ..core.sampling import sample_cosine_hemisphere
from ..render.denoise import (atrous_denoise, guided_bilateral_denoise,
                              luminance, median_filter_3x3)
from ..render.integrator import FrameConstants, trace_paths
from ..render.learned_denoise import learned_denoise
from .charts import build_charted_atlas
from .lightmap_uv import build_lightmap_atlas
from .surface_map import atlas_texel_map, build_surface_maps

LIGHTMAP_RESOLUTION = 4096  # reference default (DXRPathTracer.cpp:111)
FIREFLY_MULTIPLIER = 10.0   # Baking.hlsl:438
MIN_LUMINANCE = 1e-4        # Baking.hlsl:427

# Texels per traced slab. A slab is sized only to bound device memory: the
# wavefront of 2^21 lanes is about the 1080p frame's 2,073,600, which the
# frame path showed fits on the card with room to spare.
MAX_SLAB_TEXELS = 1 << 21


@spanned("bake.slab")
def bake_sample(scene, bvh, sky_cube, settings: AppSettings,
                frame: FrameConstants, surface_pos, surface_nrm, accum,
                sample_index: int, row_offset: int = 0, total_texels=None,
                sun_grid=None, proxy=None):
    """One progressive bake step over a row slab of texels.

    surface_pos: (R, S, 4) [xyz | coverage]; surface_nrm: (R, S, 3);
    accum: (R, S, 4) [colorSum | validCount]. Returns the new accum.
    row_offset/total_texels keep the CMJ texel indices GLOBAL when the
    lightmap is baked in row slabs. sun_grid and proxy go to trace_paths.
    """
    s_rows, s_res = surface_pos.shape[0], surface_pos.shape[1]
    n = s_rows * s_res
    n_total = int(total_texels) if total_texels is not None else n
    dev = surface_pos.device
    f32 = torch.float32

    with span("bake.rays"):
        pos = surface_pos[..., :3].reshape(n, 3)
        coverage = surface_pos[..., 3].reshape(n) > 0.0
        nrm = surface_nrm.reshape(n, 3)
        nrm_len2 = dot(nrm, nrm)
        covered = coverage & (nrm_len2 >= 1e-4)  # Baking.hlsl:363-369
        normal = nrm / sqrt(torch.clamp_min(nrm_len2, 1e-20))[..., None]

        # TBN from the up-vector method (Baking.hlsl:376-379)
        z_up = torch.tensor([0.0, 0.0, 1.0], dtype=f32,
                            device=dev).expand(n, 3)
        x_up = torch.tensor([1.0, 0.0, 0.0], dtype=f32,
                            device=dev).expand(n, 3)
        up = torch.where((normal[:, 2].abs() < 0.999)[..., None], z_up, x_up)
        tangent = cross(up, normal)
        tangent = tangent / torch.clamp_min(
            sqrt(dot(tangent, tangent)), 1e-12)[..., None]
        bitangent = cross(normal, tangent)

        pixel_idx = (torch.arange(n, dtype=torch.int64, device=dev)
                     + int(row_offset) * s_res) & 0xFFFFFFFF
        sqrt_n = int(settings.sqrt_num_samples)
        u2 = cmj.sample_cmj_2d(int(sample_index), sqrt_n, sqrt_n, pixel_idx)
        dir_ts = sample_cosine_hemisphere(u2[..., 0], u2[..., 1])
        ray_dir = (dir_ts[:, 0:1] * tangent + dir_ts[:, 1:2] * bitangent
                   + dir_ts[:, 2:3] * normal)
        ray_o = pos + ray_dir * 1e-5

    with span("paths"):
        radiance = trace_paths(
            scene, bvh, bvh, sky_cube, settings, frame, ray_o, ray_dir,
            torch.full((n,), FP32Max, dtype=f32, device=dev), pixel_idx,
            n_total, first_set_idx=1, initial_is_diffuse=True, t_min0=1e-4,
            active0=covered, sample_idx=int(sample_index), sun_grid=sun_grid,
            proxy=proxy)

    # --- firefly clamp + validity accumulation (Baking.hlsl:426-465) ---
    with span("bake.clamp"):
        color_sum = accum[..., :3].reshape(n, 3)
        valid_count = accum[..., 3].reshape(n)
        avg = color_sum / torch.clamp_min(valid_count, 1.0)[..., None]
        avg_lum = luminance(avg) + 0.001
        smp_lum = luminance(radiance)
        clamp_scale = torch.where(
            (valid_count >= 1.0) & (smp_lum > avg_lum * FIREFLY_MULTIPLIER),
            avg_lum * FIREFLY_MULTIPLIER / torch.clamp_min(smp_lum, 1e-20),
            1.0)
        new_sample = radiance * clamp_scale[..., None]

        is_nan = new_sample.isnan().any(dim=-1)
        valid = covered & ~is_nan & (luminance(new_sample) >= MIN_LUMINANCE)

        color_sum = color_sum + torch.where(valid[..., None], new_sample,
                                            0.0)
        valid_count = valid_count + valid.to(f32)
        return torch.cat([color_sum, valid_count[..., None]], -1).reshape(
            s_rows, s_res, 4)


def lightmap_from_accum(accum):
    """colorSum / validCount (zero where no valid samples)."""
    count = accum[..., 3:4]
    return torch.where(count > 0.0,
                       accum[..., :3] / torch.clamp_min(count, 1.0), 0.0)


class Baker:
    """Progressive bake session on its RenderSession's device (the HUD
    'Start Baking' flow, DXRPathTracer.cpp:2225-2240 + per-frame
    RenderBakingPass :1993-2022)."""

    def __init__(self, session, resolution: int = 512,
                 atlas_mode: str = "charts", atlas_opts: dict | None = None):
        self.session = session
        self.device = session.device
        self.resolution = resolution
        host = session.scene_host
        t0 = time.perf_counter()
        if atlas_mode == "charts":
            # xatlas-equivalent charted atlas (bake/charts.py;
            # Model.cpp:608-719); atlas_opts forwards packer knobs.
            self.atlas = build_charted_atlas(
                np.asarray(host.positions), np.asarray(host.tri_idx),
                ref_resolution=resolution, **(atlas_opts or {}))
        elif atlas_mode == "pair":
            self.atlas = build_lightmap_atlas(int(host.num_triangles))
        else:
            raise ValueError(f"unknown atlas mode {atlas_mode!r}")
        t1 = time.perf_counter()
        self.texel_map = atlas_texel_map(self.atlas, resolution)
        t2 = time.perf_counter()
        self.surface_maps = build_surface_maps(session.scene, self.texel_map)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t3 = time.perf_counter()
        # Host seconds of each set-up stage; the surface maps' include a
        # synchronise on the card.
        self.setup_s = {"atlas": t1 - t0, "texel_map": t2 - t1,
                        "surface_maps": t3 - t2}
        rows = max(1, min(resolution, MAX_SLAB_TEXELS // resolution))
        while resolution % rows != 0:
            rows -= 1
        self._slab_rows = rows
        self._row0 = list(range(0, resolution, rows))
        self.accum = torch.zeros((resolution, resolution, 4),
                                 dtype=torch.float32, device=self.device)
        self.sample_index = 0

    @spanned("bake")
    def bake_step(self):
        """One sample for every covered texel, slab by slab; each slab's
        rows of `accum` are replaced in place. Traced (app/profiler.py), it
        is the span `bake`, each slab a `bake.slab` of its rays
        (`bake.rays`), their paths and its clamp (`bake.clamp`)."""
        sess = self.session
        frame = sess.frame_constants(sess.sample_idx)
        pos = self.surface_maps["position"]
        nrm = self.surface_maps["normal"]
        rows = self._slab_rows
        sun_grid = sess.update_sun_grid()
        for r in self._row0:
            # Bake hemisphere rays are incoherent: the per-ray walks take
            # the W32 table, as in the JAX package.
            self.accum[r:r + rows] = bake_sample(
                sess.scene, sess.bvh_ray, sess.sky_cube, sess.settings, frame,
                pos[r:r + rows], nrm[r:r + rows], self.accum[r:r + rows],
                self.sample_index, row_offset=r,
                total_texels=self.resolution * self.resolution,
                sun_grid=sun_grid, proxy=sess.proxy)
        self.sample_index += 1

    def checkpoint_state(self):
        """{accum (S,S,4) host f32 sum+count, sample_index}."""
        return {"accum": self.accum.cpu().numpy(),
                "sample_index": self.sample_index}

    def restore_state(self, state):
        accum = np.asarray(state["accum"], np.float32)
        if accum.shape != tuple(self.accum.shape):
            raise ValueError(f"checkpoint accum {accum.shape} does not fit a "
                             f"{self.resolution}^2 bake")
        self.accum = torch.from_numpy(accum.copy()).to(self.device)
        self.sample_index = int(state["sample_index"])

    def save_checkpoint(self, path):
        st = self.checkpoint_state()
        np.savez_compressed(path, accum=st["accum"],
                            sample_index=st["sample_index"])

    def load_checkpoint(self, path):
        with np.load(path) as z:
            self.restore_state({"accum": z["accum"],
                                "sample_index": int(z["sample_index"])})

    def lightmap(self):
        return lightmap_from_accum(self.accum)

    def denoised_lightmap(self, mode: str = "median"):
        """median: DenoiseMedian.hlsl parity; atrous: unguided wavelet;
        guided: surface-map-guided joint bilateral; learned: the trained
        residual CNN (render/learned_denoise.py)."""
        lm = self.lightmap()
        if mode == "median":
            return median_filter_3x3(lm)
        valid = self.accum[..., 3] > 0.0
        if mode == "guided":
            return guided_bilateral_denoise(
                lm, self.surface_maps["albedo"],
                self.surface_maps["normal"], valid=valid)
        if mode == "learned":
            return learned_denoise(lm, self.surface_maps["albedo"],
                                   self.surface_maps["normal"], valid=valid)
        if mode == "atrous":
            return atrous_denoise(lm, valid=valid)
        raise ValueError(f"unknown denoise mode {mode!r}")
