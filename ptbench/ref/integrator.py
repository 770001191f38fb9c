"""The reference path tracer: plain torch, one walk per ray, no engines.

A frozen copy of the semantics of dxrpathtracer_tpu_torch/render/
integrator.py (`_depth_schedule` :175-199, `_shade_vertex` :378-607,
`_apply_vertex` :610-664, `trace_paths` :667-802, `raygen` :805-848) with
every traversal answered by the reference's own tree (ref/bvh.py) and every
surface input read from the reference's own scene (ref/scene.py): the
per-ray route of the program's module docstring, which its packets, grid,
proxy and cut must equal. Each lane carries its own CMJ sample index, so
one call traces many progressive samples of a few pixels at once.
"""

import dataclasses

import torch

from . import brdf as brdf_lib
from . import cmj
from .bvh import trace
from .constants import FP16Max, FP32Max
from .cubemap import sample_cubemap
from .math3 import div, dot, normalize, reflect, saturate, smoothstep, sqrt
from .sampling import sample_cosine_hemisphere, sample_ggx_visible_normal
from .scene import alpha_test, interpolate, tap
from .settings import SPOT_SHADOW_NEAR_CLIP


@dataclasses.dataclass
class Frame:
    """The per-frame constants (RayTraceConstants) on the device."""
    inv_view_projection: torch.Tensor
    sun_direction_ws: torch.Tensor
    sun_irradiance: torch.Tensor
    sun_render_color: torch.Tensor
    cos_sun_angular_radius: torch.Tensor
    sin_sun_angular_radius: torch.Tensor


def depth_schedule(s):
    furnace = bool(s.enable_white_furnace_mode)
    last_depth = max(int(s.max_path_length) - 1, 1)
    out = []
    for depth in range(1, last_depth + 1):
        is_last = depth == last_depth
        early_stop = ((not s.enable_diffuse and not s.enable_specular)
                      or (not s.enable_direct and not s.enable_indirect)
                      or (depth > 1 and not s.enable_indirect))
        continue_paths = bool(s.enable_indirect) and not is_last and not furnace
        out.append((depth, dict(
            is_last=is_last, furnace=furnace, early_stop=early_stop,
            continue_paths=continue_paths,
            use_any_hit=depth <= s.max_any_hit_path_length,
            terminal_any_hit=(depth + 1) <= s.max_any_hit_path_length)))
        if early_stop or not continue_paths:
            break
    return out


def _to_tangent(v_ws, tan, bit, nrm):
    return torch.stack([dot(v_ws, tan), dot(v_ws, bit), dot(v_ws, nrm)], -1)


def _from_tangent(v_ts, tan, bit, nrm):
    return v_ts[..., 0:1] * tan + v_ts[..., 1:2] * bit + v_ts[..., 2:3] * nrm


def _sky(sky_cube, s, dirs):
    n = dirs.shape[0]
    if s.enable_white_furnace_mode:
        return torch.ones((n, 3), dtype=torch.float32, device=dirs.device)
    if not s.enable_sky or sky_cube is None:
        return torch.zeros((n, 3), dtype=torch.float32, device=dirs.device)
    return sample_cubemap(sky_cube, dirs)


def _num_lights(scene, s) -> int:
    if not s.render_lights:
        return 0
    return min(scene.num_lights, int(s.max_light_clamp))


def _visibility(bvh, accept, o, d, t_min, t_max, mask):
    _, tri, _, _ = trace(bvh, o, d, t_min, t_max, mask, any_hit=True,
                         accept=accept)
    return torch.where(tri >= 0, 0.0, 1.0)


def trace_paths(scene, bvh, sky_cube, s, frame: Frame, ray_o, ray_d, t_max,
                pixel_idx, total_num_pixels: int, sample_idx,
                first_set_idx: int = 1, initial_is_diffuse: bool = False,
                t_min0=0.0, active0=None):
    """(N, 3) radiance clamped to [0, FP16Max] of each lane's path;
    `sample_idx` is each lane's CMJ sample index ((N,) int64)."""
    n, dev = ray_o.shape[0], ray_o.device
    f32 = torch.float32
    alpha = alpha_test(scene)
    t_min = (t_min0.to(f32) if isinstance(t_min0, torch.Tensor)
             else torch.full((n,), float(t_min0), dtype=f32, device=dev))
    total = torch.zeros((n, 3), dtype=f32, device=dev)
    beta = torch.ones((n, 3), dtype=f32, device=dev)
    active = (torch.ones(n, dtype=torch.bool, device=dev) if active0 is None
              else active0)
    prev_is_diffuse = torch.full((n,), bool(initial_is_diffuse),
                                 dtype=torch.bool, device=dev)
    prev_roughness = torch.zeros(n, dtype=f32, device=dev)
    t_max = t_max.to(f32)
    sun_d = frame.sun_direction_ws[None, :]
    for depth, flags in depth_schedule(s):
        furnace = flags["furnace"]
        a = alpha if flags["use_any_hit"] else None
        t_hit, tri_id, hu, hv = trace(bvh, ray_o, ray_d, t_min, t_max,
                                      active, accept=a)
        del t_hit
        hit = (tri_id >= 0) & active
        missed = active & ~hit

        # ---- miss ----
        if furnace:
            miss_rad = torch.ones((n, 3), dtype=f32, device=dev)
        else:
            miss_rad = _sky(sky_cube, s, ray_d)
            if depth == 1:
                cos_sun = dot(ray_d, sun_d)
                in_disc = cos_sun >= frame.cos_sun_angular_radius
                miss_rad = torch.where(in_disc[..., None],
                                       frame.sun_render_color[None, :],
                                       miss_rad)
        total = total + torch.where(missed[..., None], beta * miss_rad, 0.0)
        if flags["early_stop"]:
            break

        # ---- hit surface ----
        pos = interpolate(scene, "positions", tri_id, hu, hv)
        geo_n = normalize(interpolate(scene, "normals", tri_id, hu, hv),
                          eps=1e-37)
        uv = interpolate(scene, "uvs", tri_id, hu, hv)
        tan = normalize(interpolate(scene, "tangents", tri_id, hu, hv),
                        eps=1e-37)
        bit = normalize(interpolate(scene, "bitangents", tri_id, hu, hv),
                        eps=1e-37)
        mat = scene.tri_material[torch.clamp_min(tri_id, 0)]
        incoming_dir = ray_d
        incoming_origin = ray_o

        normal_ws = geo_n
        if s.enable_normal_maps:
            nm = tap(scene, mat, "normal", uv)
            nx = nm[..., 0] * 2.0 - 1.0
            ny = nm[..., 1] * 2.0 - 1.0
            nz = sqrt(torch.clamp_min(1.0 - saturate(nx * nx + ny * ny), 0.0))
            normal_ws = normalize(nx[..., None] * tan + ny[..., None] * bit
                                  + nz[..., None] * geo_n, eps=1e-37)
        frame_n = normal_ws

        if s.enable_albedo_maps and not furnace:
            base_color = tap(scene, mat, "albedo", uv)[..., :3]
        else:
            base_color = torch.ones((n, 3), dtype=f32, device=dev)
        if furnace:
            metallic_raw = torch.ones(n, dtype=f32, device=dev)
            sqrt_rough_raw = torch.ones(n, dtype=f32, device=dev)
        else:
            metallic_raw = tap(scene, mat, "metallic", uv)[..., 0]
            sqrt_rough_raw = tap(scene, mat, "roughness", uv)[..., 0]
        metallic = saturate(metallic_raw * s.metallic_scale)
        sqrt_roughness = saturate(sqrt_rough_raw * s.roughness_scale)

        en_diff = ((metallic < 1.0) & bool(s.enable_diffuse)) | furnace
        if s.enable_specular:
            if s.enable_indirect_specular:
                en_spec = (~prev_is_diffuse if s.avoid_caustic_paths
                           else torch.ones(n, dtype=torch.bool, device=dev))
            else:
                en_spec = torch.full((n,), depth == 1, dtype=torch.bool,
                                     device=dev)
        else:
            en_spec = torch.zeros(n, dtype=torch.bool, device=dev)
        lane_dead = ~(en_diff | en_spec)

        diffuse_albedo = ((1.0 - metallic)[..., None] * base_color
                          * en_diff[..., None].to(f32))
        specular_albedo = ((0.03 + (base_color - 0.03) * metallic[..., None])
                           * en_spec[..., None].to(f32))
        roughness = sqrt_roughness * sqrt_roughness
        if s.clamp_roughness:
            roughness = torch.maximum(roughness, prev_roughness)

        ms_comp = torch.ones((n, 3), dtype=f32, device=dev)
        if s.apply_multiscattering_energy_compensation:
            n_dot_v = saturate(dot(normal_ws, -incoming_dir))
            ess, _ = brdf_lib.ggx_environment_brdf_scale_bias(
                n_dot_v, sqrt_roughness)
            ms_comp = 1.0 + specular_albedo * (1.0 / ess[..., None] - 1.0)

        if furnace:
            local = torch.zeros((n, 3), dtype=f32, device=dev)
        else:
            local = tap(scene, mat, "emissive", uv)[..., :3]

        shadow_alpha = alpha if flags["use_any_hit"] else None

        # ---- sun NEE ----
        if s.enable_sun and not furnace:
            if s.sun_area_light_approximation:
                r_vec = reflect(incoming_dir, normal_ws)
                d_dot_r = dot(sun_d, r_vec)
                s_vec = r_vec - d_dot_r[..., None] * sun_d
                closest = (frame.cos_sun_angular_radius * sun_d
                           + normalize(s_vec, eps=1e-37)
                           * frame.sin_sun_angular_radius)
                shade_sun_dir = torch.where(
                    (d_dot_r < frame.cos_sun_angular_radius)[..., None],
                    normalize(closest, eps=1e-37), r_vec)
            else:
                shade_sun_dir = sun_d.expand(n, 3)
            sun_relevant = hit & (dot(normal_ws, shade_sun_dir) > 0.0)
            vis = _visibility(bvh, shadow_alpha, pos,
                              sun_d.expand(n, 3).contiguous(),
                              torch.full((n,), 1e-5, dtype=f32, device=dev),
                              torch.full((n,), FP32Max, dtype=f32,
                                         device=dev), sun_relevant)
            sun_light = brdf_lib.calc_lighting(
                normal_ws, shade_sun_dir, frame.sun_irradiance[None, :],
                diffuse_albedo, specular_albedo, roughness, pos,
                incoming_origin, ms_comp)
            local = local + sun_light * vis[..., None]

        # ---- spot NEE ----
        lights = scene.lights
        for li in range(_num_lights(scene, s)):
            to_light = lights["position"][li][None, :] - pos
            dist = sqrt(torch.clamp_min(dot(to_light, to_light), 1e-20))
            to_light = to_light / dist[..., None]
            angle_f = saturate(dot(to_light, lights["direction"][li][None, :]))
            ang_att = smoothstep(lights["angular_attenuation_y"][li],
                                 lights["angular_attenuation_x"][li], angle_f)
            dd = dist / lights["range"][li]
            dd2 = dd * dd
            falloff = saturate(1.0 - dd2 * dd2)
            falloff = (falloff * falloff) / (dist * dist + 1.0)
            ang_att = ang_att * falloff
            relevant = hit & (ang_att > 0.0) & (dot(normal_ws, to_light) > 0.0)
            vis = _visibility(
                bvh, shadow_alpha, pos + normal_ws * 0.01, to_light,
                torch.full((n,), SPOT_SHADOW_NEAR_CLIP, dtype=f32, device=dev),
                torch.clamp_min(dist - SPOT_SHADOW_NEAR_CLIP,
                                SPOT_SHADOW_NEAR_CLIP), relevant)
            light = brdf_lib.calc_lighting(
                normal_ws, to_light,
                lights["intensity"][li][None, :] * ang_att[..., None],
                diffuse_albedo, specular_albedo, roughness, pos,
                incoming_origin, ms_comp)
            local = local + torch.where(relevant[..., None],
                                        light * vis[..., None], 0.0)

        # ---- BRDF sampling ----
        set_idx = first_set_idx + (depth - 1)
        permutation = (set_idx * total_num_pixels + pixel_idx) & 0xFFFFFFFF
        sqrt_n = int(s.sqrt_num_samples)
        uv2 = cmj.sample_cmj_2d(sample_idx, sqrt_n, sqrt_n, permutation)
        bx = uv2[..., 0]
        by = uv2[..., 1]
        selector = torch.where(en_spec, bx, 0.0)
        selector = torch.where(en_diff, selector, 1.0)
        pick_diffuse = selector < 0.5
        bx_d = torch.where(en_spec, bx * 2.0, bx)
        dir_ts_diff = sample_cosine_hemisphere(bx_d, by)
        thr_diff = diffuse_albedo
        bx_s = torch.where(en_diff, (bx - 0.5) * 2.0, bx)
        incoming_ts = normalize(_to_tangent(incoming_dir, tan, bit, frame_n),
                                eps=1e-37)
        m_ts = sample_ggx_visible_normal(-incoming_ts, roughness, roughness,
                                         bx_s, by)
        dir_ts_spec = reflect(incoming_ts, m_ts)
        n_ts = torch.zeros((n, 3), dtype=f32, device=dev)
        n_ts[:, 2] = 1.0
        if furnace:
            fres = torch.ones((n, 3), dtype=f32, device=dev)
        else:
            fres = brdf_lib.fresnel(specular_albedo, m_ts, dir_ts_spec)
        a2 = roughness * roughness
        g1 = brdf_lib.smith_ggx_masking(n_ts, dir_ts_spec, -incoming_ts, a2)
        g2 = brdf_lib.smith_ggx_masking_shadowing(n_ts, dir_ts_spec,
                                                  -incoming_ts, a2)
        thr_spec = fres * (g2 / torch.where(g1 == 0.0, 1.0, g1))[..., None]
        if s.apply_multiscattering_energy_compensation:
            ndv_q = saturate(-incoming_dir[..., 2])
            ess_q, _ = brdf_lib.ggx_environment_brdf_scale_bias(
                ndv_q, sqrt_roughness)
            thr_spec = thr_spec * (1.0 + specular_albedo
                                   * (1.0 / ess_q[..., None] - 1.0))
        ray_dir_ts = torch.where(pick_diffuse[..., None], dir_ts_diff,
                                 dir_ts_spec)
        throughput = torch.where(pick_diffuse[..., None], thr_diff, thr_spec)
        ray_dir_ws = normalize(_from_tangent(ray_dir_ts, tan, bit, frame_n),
                               eps=1e-37)
        throughput = torch.where((en_diff & en_spec)[..., None],
                                 throughput * 2.0, throughput)

        if depth == 1 and not s.enable_direct:
            local = torch.zeros_like(local)
        live = hit[..., None] & ~lane_dead[..., None]
        if flags["continue_paths"]:
            total = total + torch.where(live, beta * local, 0.0)
            beta_next = beta * throughput
            active = hit & ~lane_dead & (beta_next != 0.0).any(dim=-1)
            beta = beta_next
            prev_is_diffuse = pick_diffuse
            prev_roughness = roughness
            ray_o = pos
            ray_d = ray_dir_ws
            t_min = torch.full((n,), 1e-5, dtype=f32, device=dev)
            t_max = torch.full((n,), FP32Max, dtype=f32, device=dev)
            continue
        # ---- terminal vertex ----
        if furnace:
            local = throughput
        else:
            term_alpha = alpha if flags["terminal_any_hit"] else None
            term_weight = beta * throughput
            vis = _visibility(
                bvh, term_alpha, pos, ray_dir_ws,
                torch.full((n,), 1e-5, dtype=f32, device=dev),
                torch.full((n,), FP32Max, dtype=f32, device=dev),
                hit & ~lane_dead & (term_weight != 0.0).any(dim=-1))
            sky_r = (_sky(sky_cube, s, ray_dir_ws) if s.enable_sky
                     else torch.zeros((n, 3), dtype=f32, device=dev))
            local = local + vis[..., None] * sky_r * throughput
        total = total + torch.where(live, beta * local, 0.0)
        break
    return torch.clamp(total, 0.0, FP16Max)


def raygen(s, frame: Frame, width: int, height: int, pixel_idx, sample_idx):
    """Camera rays of the frame's pixels `pixel_idx` ((N,) int64, row
    major) at CMJ sample indices `sample_idx` ((N,) int64):
    (ray_start, ray_dir, ray_len)."""
    f32 = torch.float32
    xx = (pixel_idx % width).to(f32)
    yy = (pixel_idx // width).to(f32)
    jitter = cmj.sample_cmj_2d(sample_idx, int(s.sqrt_num_samples),
                               int(s.sqrt_num_samples), pixel_idx)
    px = xx + jitter[..., 0]
    py = yy + jitter[..., 1]
    ncd_x = div(px, width * 0.5) - 1.0
    ncd_y = -(div(py, height * 0.5) - 1.0)
    ivp = frame.inv_view_projection

    def unproject(z):
        out = (ncd_x[..., None] * ivp[0] + ncd_y[..., None] * ivp[1]
               + z * ivp[2] + ivp[3])
        return out[..., :3] / out[..., 3:4]

    ray_start = unproject(0.0)
    ray_end = unproject(1.0)
    seg = ray_end - ray_start
    ray_len = sqrt(torch.clamp_min(dot(seg, seg), 1e-30))
    return ray_start, seg / ray_len[..., None], ray_len
