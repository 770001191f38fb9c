"""Forward "raster" renderer — the EnableRayTracing=false path.

The port of dxrpathtracer_tpu/render/raster.py (MeshRenderer::RenderMainPass
+ Shading.hlsl's ShadePixel + the skybox pass + weighted MSAA resolve,
DXRPathTracer.cpp:1538-1843, Shading.hlsl:79-240, Mesh.hlsl:107-170,
Resolve.hlsl:33-65). Primary visibility is a ray cast through the BVH (a
rasterizer and a camera-ray cast give the same visibility), alpha-tested on
every ray. Per MSAA subsample:
  - closest_hit -> surface attributes, from one packed shading row per hit
    (integrator._fetch_shade_inputs, the row-gather kernel) and the material
    taps through the packed meta row (integrator._sample_packed): the same
    values as the JAX package's _fetch_vertex_attrs + _sample_material
  - ShadePixel: normal mapping, diffuse/specular albedo, Turquin
    compensation, the sun with the representative-point area-light
    direction and exact-ray or shadow-map visibility, clustered spot lights
    through the froxel mask (render/clusters.py), SH9 sky ambient * InvPi *
    0.1, emissive, clamp to FP16Max
  - EnableLightMapRender: albedo * baked-lightmap fetch (Mesh.hlsl:155-162)
  - misses render the sky cubemap (the skybox pass)
Subsamples combine with the firefly-resistant inverse-luminance weighted
resolve (Resolve.hlsl:33-65).

Each pixel's result depends on its own rays alone, so the subsamples of a
frame go through the traversal in one launch, and the spot lights' shadow
rays of all subsamples in another; lanes whose light term is exactly zero
(facing away from the light) walk no shadow ray.
"""

import numpy as np
import torch

from ..accel.traverse import any_hit, closest_hit
from ..app.settings import (CLUSTER_TILE_SIZE, SPOT_SHADOW_NEAR_CLIP,
                            AppSettings, MSAAModes)
from ..core import brdf as brdf_lib
from ..core.constants import FP16Max, FP32Max, InvPi
from ..core.math3 import (div, dot, normalize, reflect, saturate, smoothstep,
                          sqrt)
from ..sky.cubemap import sample_cubemap
from .integrator import (FrameConstants, _fetch_shade_inputs,
                         _make_alpha_test, _sample_packed)
from .postfx import resolve_weighted
from .shadows import (spot_visibility_pcf, sun_visibility_moments,
                      sun_visibility_pcf)

# Standard D3D MSAA sample offsets (in 1/16-pixel units)
MSAA_OFFSETS = {
    MSAAModes.MSAANone: [(0.0, 0.0)],
    MSAAModes.MSAA2x: [(4 / 16, 4 / 16), (-4 / 16, -4 / 16)],
    MSAAModes.MSAA4x: [(-2 / 16, -6 / 16), (6 / 16, -2 / 16),
                       (-6 / 16, 2 / 16), (2 / 16, 6 / 16)],
}


def shade_pixels(scene, bvh, rec, ray_d, settings: AppSettings,
                 frame: FrameConstants, sky_sh, cluster_masks, cluster_dims,
                 pixel_xy, camera_forward, near_clip, far_clip,
                 lightmap=None, lightmap_uvs=None, sun_shadow_pcf=None,
                 spot_shadow_pcf=None):
    """ShadePixel (Shading.hlsl:79-240) over a flat batch of primary hits;
    misses are black.

    sun_shadow_pcf: optional (maps, cascades[, mode]) switching sun
    visibility from exact rays to the shadow maps: mode 'pcf' (raw depth and
    the 7x7 PCF, SunShadowVisibility, Shadows.hlsl:318-360; the default) or
    'evsm' / 'msm' moment maps. spot_shadow_pcf: optional (maps, spots) for
    the spots' depth maps and PCF."""
    s = settings
    n = ray_d.shape[0]
    dev = ray_d.device
    f32 = torch.float32
    hit = rec.hit

    pos, vtx_normal, uv, tan, bit, _mat, packed = _fetch_shade_inputs(
        scene, rec.tri_id, rec.u, rec.v)
    cam = frame.camera_pos_ws[None, :]
    view = normalize(cam - pos, eps=1e-37)

    normal = vtx_normal
    if s.enable_normal_maps:
        nm = _sample_packed(scene, packed, uv, "normal")
        nx = nm[..., 0] * 2.0 - 1.0
        ny = nm[..., 1] * 2.0 - 1.0
        nz = sqrt(torch.clamp_min(1.0 - saturate(nx * nx + ny * ny), 0.0))
        normal = normalize(nx[..., None] * tan + ny[..., None] * bit
                           + nz[..., None] * vtx_normal, eps=1e-37)

    albedo4 = _sample_packed(scene, packed, uv, "albedo")
    albedo = (albedo4[..., :3] if s.enable_albedo_maps
              else torch.ones((n, 3), dtype=f32, device=dev))

    # Lightmap-lit mode replaces shading entirely (Mesh.hlsl:155-162)
    if (s.enable_light_map_render and lightmap is not None
            and lightmap_uvs is not None):
        baked = _sample_lightmap(lightmap,
                                 _interp_lightmap_uv(lightmap_uvs, rec))
        return torch.where(hit[..., None], albedo * baked, 0.0)

    metallic = saturate(_sample_packed(scene, packed, uv, "metallic")[..., 0])
    diffuse_albedo = ((1.0 - metallic)[..., None] * albedo
                      * (1.0 if s.enable_diffuse else 0.0))
    specular_albedo = ((0.03 + (albedo - 0.03) * metallic[..., None])
                       * (1.0 if s.enable_specular else 0.0))
    sqrt_roughness = _sample_packed(scene, packed, uv, "roughness")[..., 0]
    roughness = sqrt_roughness * sqrt_roughness

    ms_comp = torch.ones((n, 3), dtype=f32, device=dev)
    if s.apply_multiscattering_energy_compensation:
        ndv = saturate(dot(normal, view))
        ess, _ = brdf_lib.ggx_environment_brdf_scale_bias(ndv, sqrt_roughness)
        ms_comp = 1.0 + specular_albedo * (1.0 / ess[..., None] - 1.0)

    alpha = _make_alpha_test(scene, s)
    output = torch.zeros((n, 3), dtype=f32, device=dev)
    fwd = torch.from_numpy(np.asarray(camera_forward, np.float32)).to(dev)
    depth_vs = dot(pos - cam, fwd[None, :])
    norm_depth = saturate(div(depth_vs - near_clip, far_clip - near_clip))

    def lighting(light_dir, irradiance):
        return brdf_lib.calc_lighting(normal, light_dir, irradiance,
                                      diffuse_albedo, specular_albedo,
                                      roughness, pos, cam, ms_comp)

    # --- Sun (Shading.hlsl:143-175) ---
    if s.enable_sun and s.enable_direct:
        sun_d = frame.sun_direction_ws[None, :]
        if s.sun_area_light_approximation:
            r_vec = reflect(-view, normal)
            d_dot_r = dot(sun_d, r_vec)
            s_vec = r_vec - d_dot_r[..., None] * sun_d
            closest = (frame.cos_sun_angular_radius * sun_d
                       + normalize(s_vec, eps=1e-37)
                       * frame.sin_sun_angular_radius)
            shade_dir = torch.where(
                (d_dot_r < frame.cos_sun_angular_radius)[..., None],
                normalize(closest, eps=1e-37), r_vec)
        else:
            shade_dir = sun_d.expand(n, 3)
        if sun_shadow_pcf is not None:
            maps, cascades = sun_shadow_pcf[:2]
            mode = sun_shadow_pcf[2] if len(sun_shadow_pcf) > 2 else "pcf"
            n_dot_sun = dot(normal, sun_d)
            if mode == "pcf":
                vis = sun_visibility_pcf(maps, cascades, pos, normal,
                                         n_dot_sun, norm_depth)
            else:
                vis = sun_visibility_moments(maps, cascades, pos, normal,
                                             n_dot_sun, norm_depth, mode)
            vis = torch.where(hit, vis, 0.0)
        else:
            # a lane facing away from the light adds exactly 0
            # (calc_lighting's saturate(NdotL)): it walks no shadow ray
            vis = any_hit(bvh, pos, sun_d.expand(n, 3).contiguous(), 1e-3,
                          FP32Max, hit & (dot(normal, shade_dir) > 0.0),
                          alpha=alpha)
        sun_l = lighting(shade_dir, frame.sun_irradiance[None, :])
        output = output + sun_l * vis[..., None]

    # --- Clustered spot lights (Shading.hlsl:177-229) ---
    lights = scene.lights
    num_lights = min(lights.num_lights, int(s.max_light_clamp))
    if s.render_lights and s.enable_direct and num_lights > 0:
        nx_c, ny_c, nz_c = cluster_dims
        z_tile = torch.clamp_max((norm_depth * nz_c).to(torch.int64),
                                 nz_c - 1)
        tx = torch.clamp_max(pixel_xy[:, 0] // CLUSTER_TILE_SIZE, nx_c - 1)
        ty = torch.clamp_max(pixel_xy[:, 1] // CLUSTER_TILE_SIZE, ny_c - 1)
        # cluster index layout matches froxel_bounding_spheres (x-major grid)
        mask = cluster_masks[tx * (ny_c * nz_c) + ty * nz_c + z_tile]

        terms, rays = [], []
        for li in range(num_lights):
            in_cluster = ((mask >> li) & 1) != 0
            to_light = lights.position[li][None, :] - pos
            dist = sqrt(torch.clamp_min(dot(to_light, to_light), 1e-20))
            to_light = to_light / dist[..., None]
            angle_f = saturate(dot(to_light, lights.direction[li][None, :]))
            ang = smoothstep(lights.angular_attenuation_y[li],
                             lights.angular_attenuation_x[li], angle_f)
            dd = dist / lights.range[li]
            dd2 = dd * dd  # dd ** 4 as XLA's integer_pow: (dd*dd)*(dd*dd)
            falloff = saturate(1.0 - dd2 * dd2)
            falloff = (falloff * falloff) / (dist * dist + 1.0)
            relevant = hit & in_cluster & (ang > 0.0)
            light = lighting(to_light,
                             lights.intensity[li][None, :]
                             * (ang * falloff)[..., None])
            if spot_shadow_pcf is not None:
                spot_maps, spots = spot_shadow_pcf
                vis = spot_visibility_pcf(spot_maps, spots, li, pos, normal,
                                          dot(normal, to_light))
                output = output + torch.where(relevant[..., None],
                                              light * vis[..., None], 0.0)
            else:
                rays.append((pos + normal * 0.01, to_light,
                             torch.clamp_min(dist - SPOT_SHADOW_NEAR_CLIP,
                                             SPOT_SHADOW_NEAR_CLIP),
                             relevant & (dot(normal, to_light) > 0.0)))
                terms.append((light, relevant))
        if rays:
            o, d, t_max, active = (torch.cat([r[k] for r in rays])
                                   for k in range(4))
            vis = any_hit(bvh, o, d, SPOT_SHADOW_NEAR_CLIP, t_max, active,
                          alpha=alpha)
            for j, (light, relevant) in enumerate(terms):
                output = output + torch.where(
                    relevant[..., None],
                    light * vis[j * n:(j + 1) * n, None], 0.0)

    # --- SH sky ambient (Shading.hlsl:231-236) ---
    if s.enable_indirect and sky_sh is not None:
        ambient = _eval_sh9_irradiance(sky_sh, normal) * InvPi * 0.1
        output = output + ambient * diffuse_albedo

    output = output + _sample_packed(scene, packed, uv, "emissive")[..., :3]
    output = torch.clamp(output, 0.0, FP16Max)
    return torch.where(hit[..., None], output, 0.0)


_SH_A = np.array([np.pi, 2.0943951, 2.0943951, 2.0943951,
                  0.785398, 0.785398, 0.785398, 0.785398, 0.785398], np.float32)


def _eval_sh9_irradiance(sh, normal):
    """EvalSH9Irradiance (Shaders/SH.hlsl:437-486) on (N, 3) normals: the
    nine basis terms times the (9, 3) coefficients scaled by the cosine-lobe
    factors, summed in order (the JAX package's einsum leaves the order to
    XLA)."""
    x, y, z = normal[..., 0], normal[..., 1], normal[..., 2]
    basis = (torch.full_like(x, 0.282095),
             0.488603 * y, 0.488603 * z, 0.488603 * x,
             1.092548 * x * y, 1.092548 * y * z,
             0.315392 * (3.0 * z * z - 1.0),
             1.092548 * x * z, 0.546274 * (x * x - y * y))
    coef = sh * torch.from_numpy(_SH_A).to(sh.device)[:, None]  # (9, 3)
    out = basis[0][..., None] * coef[0]
    for k in range(1, 9):
        out = out + basis[k][..., None] * coef[k]
    return out


def _interp_lightmap_uv(lightmap_uvs, rec):
    """Per-corner lightmap UVs (T, 3, 2) -> interpolated (N, 2)."""
    tri_uv = lightmap_uvs[torch.clamp_min(rec.tri_id, 0).long()]
    w = (1.0 - rec.u - rec.v)[..., None]
    return (tri_uv[:, 0] * w + tri_uv[:, 1] * rec.u[..., None]
            + tri_uv[:, 2] * rec.v[..., None])


def _sample_lightmap(lightmap, uv):
    """Bilinear clamp fetch from an (S, S, 3) lightmap."""
    s = lightmap.shape[0]
    x = uv[..., 0] * s - 0.5
    y = uv[..., 1] * s - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def cl(i):
        return torch.clamp(i.to(torch.int64), 0, s - 1)

    flat = lightmap.reshape(-1, 3)

    def fetch(yi, xi):
        return flat[yi * s + xi]

    t00 = fetch(cl(y0), cl(x0))
    t10 = fetch(cl(y0), cl(x0 + 1))
    t01 = fetch(cl(y0 + 1), cl(x0))
    t11 = fetch(cl(y0 + 1), cl(x0 + 1))
    top = t00 + (t10 - t00) * fx
    bot = t01 + (t11 - t01) * fx
    return top + (bot - top) * fy


def primary_rays(settings: AppSettings, frame: FrameConstants, width: int,
                 height: int, device):
    """The MSAA subsamples' camera rays, subsample-major: (ray_start,
    ray_dir, ray_len) over S*H*W lanes and the (H*W, 2) int64 pixel xy."""
    f32 = torch.float32
    yy, xx = torch.meshgrid(torch.arange(height, dtype=f32, device=device),
                            torch.arange(width, dtype=f32, device=device),
                            indexing="ij")
    xx, yy = xx.reshape(-1), yy.reshape(-1)
    pixel_xy = torch.stack([xx, yy], -1).to(torch.int64)
    ivp = frame.inv_view_projection
    starts, dirs, lens = [], [], []
    for ox, oy in MSAA_OFFSETS[settings.msaa_mode]:
        px = xx + 0.5 + ox
        py = yy + 0.5 + oy
        ncd_x = div(px, width * 0.5) - 1.0
        ncd_y = -(div(py, height * 0.5) - 1.0)

        def unproject(z):
            out = (ncd_x[..., None] * ivp[0] + ncd_y[..., None] * ivp[1]
                   + z * ivp[2] + ivp[3])
            return out[..., :3] / out[..., 3:4]

        ray_start = unproject(0.0)
        seg = unproject(1.0) - ray_start
        ray_len = sqrt(torch.clamp_min(dot(seg, seg), 1e-30))
        starts.append(ray_start)
        dirs.append(seg / ray_len[..., None])
        lens.append(ray_len)
    return torch.cat(starts), torch.cat(dirs), torch.cat(lens), pixel_xy


def forward_render(scene, bvh, sky_cube, sky_sh, settings: AppSettings,
                   frame: FrameConstants, width: int, height: int,
                   cluster_masks, cluster_dims, camera_forward,
                   near_clip: float, far_clip: float,
                   lightmap=None, lightmap_uvs=None, sun_shadow_pcf=None,
                   spot_shadow_pcf=None):
    """Full raster-mode frame: MSAA subsample shading + weighted resolve.

    Returns (H, W, 3) radiance (pre-tonemap, FP16Scale units).
    """
    s = settings
    ray_start, ray_dir, ray_len, pixel_xy = primary_rays(
        s, frame, width, height, bvh.table.device)
    n_sub = ray_start.shape[0] // pixel_xy.shape[0]
    rec = closest_hit(bvh, ray_start, ray_dir, 0.0, ray_len,
                      alpha=_make_alpha_test(scene, s))
    shaded = shade_pixels(scene, bvh, rec, ray_dir, s, frame, sky_sh,
                          cluster_masks, cluster_dims,
                          pixel_xy.repeat(n_sub, 1), camera_forward,
                          near_clip, far_clip, lightmap=lightmap,
                          lightmap_uvs=lightmap_uvs,
                          sun_shadow_pcf=sun_shadow_pcf,
                          spot_shadow_pcf=spot_shadow_pcf)
    # Sky for misses (skybox.RenderSky, DXRPathTracer.cpp:1791)
    if s.enable_sky and sky_cube is not None:
        shaded = torch.where(rec.hit[..., None], shaded,
                             sample_cubemap(sky_cube, ray_dir))
    resolved = resolve_weighted(shaded.reshape(n_sub, -1, 3),
                                float(s.exposure))
    return resolved.reshape(height, width, 3)
