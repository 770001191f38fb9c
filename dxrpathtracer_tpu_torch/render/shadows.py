"""Cascaded sun shadow maps, spot shadow maps and their filters.

The port of dxrpathtracer_tpu/render/shadows.py (ShadowHelper::
PrepareCascades, Graphics/ShadowHelper.h:25-108; the DepthOnly pass,
MeshRenderer.cpp:534-608; Shadows.hlsl, EVSM.hlsl, MSM.hlsl, SMConvert.hlsl).
Four stabilised cascades over the camera frustum, each an orthographic
light-space projection whose bounding sphere is texel-snapped, and one
perspective depth map per spot light. Sun visibility is sampled with the
7x7 disc-weighted PCF of SampleShadowMapGatherPCF, or through EVSM / MSM
moment maps; spot visibility with the same PCF.

The cascade and spot set-ups and the depth-map rays are host numpy, as in
the JAX package (float64 set-up, cast once), so the rays are the same bits.
The depth maps are ray casts through the port's `closest_hit` with the
scene's alpha test: every cascade's rays in one launch, every spot's in
another (each ray's walk is its own, so the maps equal one launch per map).
Filtering and sampling are torch ops on the maps' device. The EVSM warp's
exp and the MSM solve's sqrt round once from float64 (core/math3), so CPU and
card give the same bits; the moment products are written as sums of
products (a matmul's order differs between devices).
"""

import dataclasses

import numpy as np
import torch

from ..accel.traverse import closest_hit
from ..core.math3 import div, dot, exp, sqrt
from .camera import perspective_fov_lh

NUM_CASCADES = 4
SHADOW_MAP_SIZE = 2048  # sun CSM resolution (MeshRenderer.cpp sun shadow map)
SPOT_SHADOW_MAP_SIZE = 1024


@dataclasses.dataclass(frozen=True)
class Cascade:
    split_depth: float       # far split, view-space [0..1] of (near..far)
    view_proj: np.ndarray    # (4, 4) row-vector light-space ortho transform
    center: np.ndarray       # (3,) world-space bounding-sphere center
    radius: float


def cascade_splits(num=NUM_CASCADES, lambda_log=0.75):
    """Practical split scheme: log/uniform blend (standard CSM practice)."""
    splits = []
    for i in range(1, num + 1):
        p = i / num
        log_s = 0.01 * (1.0 / 0.01) ** p
        uni_s = p
        splits.append(lambda_log * log_s + (1 - lambda_log) * uni_s)
    return np.asarray(splits, np.float32)


def _look_at_lh(eye, target, up):
    f = target - eye
    f = f / np.linalg.norm(f)
    r = np.cross(up, f)
    r = r / np.linalg.norm(r)
    u = np.cross(f, r)
    m = np.eye(4, dtype=np.float64)
    m[0, :3] = r
    m[1, :3] = u
    m[2, :3] = f
    view = np.eye(4, dtype=np.float64)
    view[:3, :3] = m[:3, :3].T
    view[3, :3] = -(eye @ m[:3, :3].T)
    return view


def prepare_cascades(camera, sun_direction, num=NUM_CASCADES,
                     map_size=SHADOW_MAP_SIZE):
    """Stabilized cascades for the current camera (PrepareCascades parity).

    Returns list[Cascade]. Frustum-slice corners -> bounding sphere ->
    texel-snapped light-space ortho box.
    """
    sun_direction = np.asarray(sun_direction, np.float64)
    sun_direction = sun_direction / np.linalg.norm(sun_direction)
    near, far = camera.near_clip, camera.far_clip
    splits = cascade_splits(num)

    inv_vp = np.linalg.inv(camera.view_projection().astype(np.float64))

    def frustum_corners(z0n, z1n):
        """8 world-space corners of the [z0n, z1n] normalized depth slice."""
        pts = []
        for zn in (z0n, z1n):
            # Convert normalized view depth to NDC z through the projection:
            zv = near + (far - near) * zn
            h = np.array([[x, y, 0.0, 1.0] for x in (-1, 1) for y in (-1, 1)])
            # project a view-space depth to NDC z: z_ndc = (zv*rng - rng*nz)/zv
            rng = far / (far - near)
            z_ndc = (zv * rng - rng * near) / zv
            h[:, 2] = z_ndc
            w = h @ inv_vp
            pts.append(w[:, :3] / w[:, 3:4])
        return np.concatenate(pts)

    cascades = []
    prev = 0.0
    for i in range(num):
        corners = frustum_corners(prev, float(splits[i]))
        center = corners.mean(axis=0)
        radius = float(np.linalg.norm(corners - center, axis=1).max())
        # Stabilization: snap the sphere center to shadow-texel increments in
        # light space (ShadowHelper's stabilized mode).
        up = np.array([0.0, 1.0, 0.0]) if abs(sun_direction[1]) < 0.99 else np.array([0.0, 0.0, 1.0])
        # Light eye on the SUN side of the slice, looking down-sun (the
        # shadow-caster view DepthOnly.hlsl renders from).
        light_view = _look_at_lh(center + sun_direction * radius * 2.0, center, up)
        texel = (2.0 * radius) / map_size
        c_ls = np.append(center, 1.0) @ light_view
        c_ls[:2] = np.floor(c_ls[:2] / texel) * texel
        center_snapped = (np.append(c_ls[:3], 1.0) @ np.linalg.inv(light_view))[:3]
        light_view = _look_at_lh(center_snapped + sun_direction * radius * 2.0,
                                 center_snapped, up)
        # Ortho projection over the sphere extents
        ortho = np.zeros((4, 4))
        ortho[0, 0] = 1.0 / radius
        ortho[1, 1] = 1.0 / radius
        ortho[2, 2] = 1.0 / (4.0 * radius)
        ortho[3, 2] = 0.0
        ortho[3, 3] = 1.0
        cascades.append(Cascade(
            split_depth=float(splits[i]),
            view_proj=(light_view @ ortho).astype(np.float32),
            center=center_snapped.astype(np.float32),
            radius=radius))
        prev = float(splits[i])
    return cascades


def select_cascade(depth_vs_normalized, splits):
    """Cascade index per pixel from normalized view depth."""
    idx = torch.zeros_like(depth_vs_normalized, dtype=torch.int64)
    for i in range(len(splits) - 1):
        idx = torch.where(depth_vs_normalized > float(splits[i]), i + 1, idx)
    return idx


# ---------------------------------------------------------------------------
# Depth-map + PCF backend (reference's shipped ShadowMapMode::DepthMap)

# 7x7 disc kernel of SampleShadowMapGatherPCF (Shadows.hlsl:165-173).
PCF_W = np.array([
    [0.0, 0.0, 0.5, 1.0, 0.5, 0.0, 0.0],
    [0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0],
    [0.5, 1.0, 1.0, 1.0, 1.0, 1.0, 0.5],
    [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
    [0.5, 1.0, 1.0, 1.0, 1.0, 1.0, 0.5],
    [0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0],
    [0.0, 0.0, 0.5, 1.0, 0.5, 0.0, 0.0]], np.float32)
PCF_BIAS = 0.001  # lightDepth = shadowPos.z - 0.001 (Shadows.hlsl:185)


def _map_rays(view_proj, s: int, ortho: bool):
    """One depth map's texel-centre points in float64 on the host (texel
    (i, j) covers light-clip x = (j+0.5)/S*2-1, y = (i+0.5)/S*2-1): for an
    ortho map (near-plane points, far-plane points), for a perspective one
    the far-plane points (its rays start at the light)."""
    inv_vp = np.linalg.inv(view_proj.astype(np.float64))
    jj, ii = np.meshgrid(np.arange(s), np.arange(s), indexing="xy")
    x = (jj.reshape(-1) + 0.5) / s * 2.0 - 1.0
    y = (ii.reshape(-1) + 0.5) / s * 2.0 - 1.0
    h1 = np.stack([x, y, np.ones_like(x), np.ones_like(x)], -1) @ inv_vp
    if not ortho:
        return h1[:, :3] / h1[:, 3:4]
    h0 = np.stack([x, y, np.zeros_like(x), np.ones_like(x)], -1) @ inv_vp
    return h0[:, :3] / h0[:, 3:4], h1[:, :3] / h1[:, 3:4]


def render_cascade_depth_maps(bvh, cascades, map_size: int = 512,
                              alpha=None):
    """Ortho ray-cast depth from the light per cascade — the DepthOnly pass
    (MeshRenderer::RenderSunShadowMap, MeshRenderer.cpp:534-565), every
    cascade's rays in one closest_hit launch on the table's device.

    `alpha` is the scene's alpha test (integrator._make_alpha_test): the
    reference's DepthOnly pass uses the alpha-tested PSO variant for
    opacity-mapped meshes.

    Returns (num_cascades, S, S) float32 light-space depth in [0, 1]
    (1 where nothing was hit)."""
    s = map_size
    dev = bvh.table.device
    os_, ds, lens = [], [], []
    for c in cascades:
        h0, h1 = _map_rays(c.view_proj, s, ortho=True)
        o = h0.astype(np.float32)
        e = h1.astype(np.float32)
        seg = e - o
        ray_len = np.linalg.norm(seg, axis=-1)
        os_.append(o)
        ds.append((seg / ray_len[:, None]).astype(np.float32))
        lens.append(ray_len.astype(np.float32))
    to = lambda a: torch.from_numpy(np.concatenate(a)).to(dev)
    ray_len = to(lens)
    rec = closest_hit(bvh, to(os_), to(ds), 0.0, ray_len, alpha=alpha)
    return (rec.t / ray_len).reshape(len(cascades), s, s)


def sun_visibility_pcf(depth_maps, cascades, pos_ws, normal_ws, n_dot_l,
                       depth_vs_normalized):
    """SunShadowVisibility with the 7x7 weighted PCF (Shadows.hlsl:318-360).

    depth_maps: (C, S, S) from render_cascade_depth_maps; cascades: the
    matching list[Cascade]; pos_ws/normal_ws: (N, 3); n_dot_l: (N,);
    depth_vs_normalized: (N,) view depth in [0, 1] for cascade selection.
    Returns (N,) visibility in [0, 1].
    """
    s = depth_maps.shape[1]
    cidx, hx, hy, hz = _cascade_project(cascades, s, pos_ws, normal_ws,
                                        n_dot_l, depth_vs_normalized)
    light_depth = hz - PCF_BIAS
    return _pcf_filter(depth_maps.reshape(-1), cidx * (s * s), s,
                       hx, hy, light_depth)


def _cascade_project(cascades, s, pos_ws, normal_ws, n_dot_l,
                     depth_vs_normalized):
    """Cascade selection, GetShadowPosOffset's normal offset and the
    light-space projection shared by the PCF and moment samplers:
    (cascade index, hx, hy, hz)."""
    dev = pos_ws.device
    splits = np.array([c.split_depth for c in cascades], np.float32)
    vps = torch.from_numpy(np.stack([c.view_proj for c in cascades])).to(dev)
    radii = torch.from_numpy(np.array([c.radius for c in cascades],
                                      np.float32)).to(dev)
    cidx = select_cascade(depth_vs_normalized, splits)         # (N,)
    vp = vps[cidx]                                             # (N, 4, 4)
    radius = radii[cidx]                                       # (N,)

    # GetShadowPosOffset (Shadows.hlsl:307-314): 4 shadow texels along the
    # normal, faded in as nDotL falls off; texel world size = 2r/S.
    offset = (normal_ws * ((1.0 - torch.clamp(n_dot_l, 0.0, 1.0))
                           * 4.0 * div(2.0 * radius, s))[..., None])
    p = pos_ws + offset
    # Row-vector projection as explicit products and sums.
    hx = (p[:, 0] * vp[:, 0, 0] + p[:, 1] * vp[:, 1, 0]
          + p[:, 2] * vp[:, 2, 0] + vp[:, 3, 0])
    hy = (p[:, 0] * vp[:, 0, 1] + p[:, 1] * vp[:, 1, 1]
          + p[:, 2] * vp[:, 2, 1] + vp[:, 3, 1])
    hz = (p[:, 0] * vp[:, 0, 2] + p[:, 1] * vp[:, 1, 2]
          + p[:, 2] * vp[:, 2, 2] + vp[:, 3, 2])
    return cidx, hx, hy, hz


def _pcf_filter(flat, base, s, hx, hy, light_depth):
    """The 7x7 disc-weighted PCF comparison filter shared by the sun CSM and
    spot shadow paths (SampleShadowMapGatherPCF, Shadows.hlsl:165-286: the
    GatherCmp code is an optimized evaluation of exactly this bilinear-
    weighted comparison). flat: flattened depth maps; base: per-lane flat
    offset of the selected map; hx/hy: NDC in [-1, 1]. The 49 weighted taps
    are summed in the JAX package's order."""
    # Fractional texel position (stc/tcs/fc of SampleShadowMapGatherPCF).
    stc_x = (hx * 0.5 + 0.5) * s  # texel-edge coords; texel j covers [j, j+1)
    stc_y = (hy * 0.5 + 0.5) * s
    base_x = torch.floor(stc_x - 0.5)
    base_y = torch.floor(stc_y - 0.5)
    fx = stc_x - 0.5 - base_x
    fy = stc_y - 0.5 - base_y
    bx = base_x.to(torch.int64)
    by = base_y.to(torch.int64)

    # 8x8 comparison grid around the footprint; weights = the 7x7 disc kernel
    # convolved with the per-lane bilinear foot.
    vis = torch.zeros_like(fx)
    for gy in range(8):
        ty = torch.clamp(by + (gy - 3), 0, s - 1)
        for gx in range(8):
            # Grid texel (gy, gx) collects the bilinear feet of the (up to 4)
            # kernel taps that cover it: tap k spans texels k and k+1 with
            # weights (1-f) and f.
            w = None
            for ky, wyf in ((gy - 1, fy), (gy, 1.0 - fy)):
                if not 0 <= ky <= 6:
                    continue
                for kx, wxf in ((gx - 1, fx), (gx, 1.0 - fx)):
                    if not 0 <= kx <= 6 or PCF_W[ky, kx] == 0.0:
                        continue
                    term = float(PCF_W[ky, kx]) * wyf * wxf
                    w = term if w is None else w + term
            if w is None:
                continue  # corner texels outside every tap's foot
            tx = torch.clamp(bx + (gx - 3), 0, s - 1)
            d = flat[base + ty * s + tx]
            vis = vis + w * (light_depth <= d).to(torch.float32)
    return div(vis, float(PCF_W.sum()))


# ---------------------------------------------------------------------------
# Spot-light shadow maps (RenderSpotLightShadowMap, MeshRenderer.cpp:568-608:
# one 1024^2 perspective depth map per spot, DepthOnly pass + the same PCF).

@dataclasses.dataclass(frozen=True)
class SpotShadow:
    view_proj: np.ndarray   # (4, 4) row-vector LH perspective transform
    position: np.ndarray    # (3,) light position
    forward: np.ndarray     # (3,) light direction (normalized)
    near: float
    far: float


def prepare_spot_shadows(lights, near_clip: float, light_range=None):
    """One perspective shadow camera per spot light (MeshRenderer.cpp:
    568-585: PerspectiveCamera with fov = the cone's outer angle, near =
    SpotShadowNearClip, far = SpotLightRange). `lights`: SpotLights (read
    on the host)."""
    out = []
    n = int(lights.num_lights)
    host = lambda t: np.asarray(t.cpu())
    position, direction = host(lights.position), host(lights.direction)
    cos_outer_all, ranges = (host(lights.angular_attenuation_y),
                             host(lights.range))
    for li in range(n):
        lp = np.asarray(position[li], np.float64)
        ld = np.asarray(direction[li], np.float64)
        ld = ld / max(np.linalg.norm(ld), 1e-20)
        cos_outer = float(cos_outer_all[li])
        far = float(ranges[li]) if light_range is None else float(light_range)
        fov = 2.0 * float(np.arccos(np.clip(cos_outer, -1.0, 1.0)))
        fov = min(max(fov * 1.02, 0.05), np.pi * 0.98)  # filter margin
        up = (np.array([0.0, 0.0, 1.0]) if abs(ld[1]) > 0.9
              else np.array([0.0, 1.0, 0.0]))
        view = _look_at_lh(lp, lp + ld, up)
        proj = perspective_fov_lh(fov, 1.0, near_clip, far).astype(np.float64)
        out.append(SpotShadow(
            view_proj=(view @ proj).astype(np.float32),
            position=lp.astype(np.float32), forward=ld.astype(np.float32),
            near=near_clip, far=far))
    return out


def render_spot_depth_maps(bvh, spots, map_size: int = SPOT_SHADOW_MAP_SIZE,
                           alpha=None):
    """Per-spot perspective ray-cast depth (the DepthOnly pass from the
    light's point of view), every spot's rays in one closest_hit launch.
    Returns (L, S, S) f32 LINEAR depth fraction (zview - near) / (far - near)
    in [0, 1], 1 where nothing was hit."""
    s = map_size
    dev = bvh.table.device
    if not spots:
        return torch.zeros((0, s, s), dtype=torch.float32, device=dev)
    os_, ds, lens, cos_fs = [], [], [], []
    for sp in spots:
        far_pt = _map_rays(sp.view_proj, s, ortho=False)
        o = np.broadcast_to(sp.position.astype(np.float64), far_pt.shape)
        seg = far_pt - o
        ray_len = np.linalg.norm(seg, axis=-1)
        d = (seg / ray_len[:, None]).astype(np.float32)
        os_.append(o.astype(np.float32))
        ds.append(d)
        lens.append(ray_len.astype(np.float32))
        cos_fs.append((d @ sp.forward).astype(np.float32))
    to = lambda a: torch.from_numpy(np.concatenate(a)).to(dev)
    rec = closest_hit(bvh, to(os_), to(ds), 0.0, to(lens), alpha=alpha)
    zview = (rec.t * to(cos_fs)).reshape(len(spots), s * s)
    hit = rec.tri_id.reshape(len(spots), s * s) >= 0
    maps = []
    for k, sp in enumerate(spots):
        frac = div(zview[k] - sp.near, sp.far - sp.near)
        frac = torch.where(hit[k], torch.clamp(frac, 0.0, 1.0), 1.0)
        maps.append(frac.reshape(s, s))
    return torch.stack(maps)


def spot_visibility_pcf(depth_maps, spots, light_idx: int, pos_ws, normal_ws,
                        n_dot_l):
    """Spot-light shadow visibility with the shared 7x7 PCF
    (Shadows.hlsl spot path + MeshRenderer.cpp:568-608 intent)."""
    dev = pos_ws.device
    sp = spots[light_idx]
    s = depth_maps.shape[1]
    vp = torch.from_numpy(sp.view_proj).to(dev)
    position = torch.from_numpy(sp.position).to(dev)
    forward = torch.from_numpy(sp.forward).to(dev)

    # normal-offset bias scaled by the local texel footprint (perspective:
    # texel world size grows linearly with view depth)
    zview = dot(pos_ws - position[None, :], forward[None, :])
    texel_ws = div(2.0 * zview, s)  # ~frustum width at depth / map size
    offset = (normal_ws * ((1.0 - torch.clamp(n_dot_l, 0.0, 1.0))
                           * 4.0 * texel_ws)[..., None])
    p = pos_ws + offset
    hx = (p[:, 0] * vp[0, 0] + p[:, 1] * vp[1, 0]
          + p[:, 2] * vp[2, 0] + vp[3, 0])
    hy = (p[:, 0] * vp[0, 1] + p[:, 1] * vp[1, 1]
          + p[:, 2] * vp[2, 1] + vp[3, 1])
    hw = (p[:, 0] * vp[0, 3] + p[:, 1] * vp[1, 3]
          + p[:, 2] * vp[2, 3] + vp[3, 3])
    safe_w = torch.where(hw.abs() < 1e-8, 1e-8, hw)
    ndc_x = hx / safe_w
    ndc_y = hy / safe_w
    zo = dot(p - position[None, :], forward[None, :])
    light_depth = div(zo - sp.near, sp.far - sp.near) - PCF_BIAS

    base = torch.full(pos_ws.shape[:1], light_idx * (s * s),
                      dtype=torch.int64, device=dev)
    vis = _pcf_filter(depth_maps.reshape(-1), base, s, ndc_x, ndc_y,
                      light_depth)
    # outside the shadow frustum -> lit (matches the cone attenuation
    # already zeroing contributions outside the outer angle)
    inside = ((ndc_x.abs() <= 1.0) & (ndc_y.abs() <= 1.0)
              & (hw > 0.0) & (light_depth <= 1.0))
    return torch.where(inside, vis, 1.0)


# ---------------------------------------------------------------------------
# EVSM / MSM moment shadow maps (ShadowMapMode::EVSM / ::MSM).
#
# The reference framework ships three shadow-map representations selected by
# ShadowHelper::Initialize (Graphics/ShadowHelper.h:25-108): plain depth+PCF
# (what the app uses, DXRPathTracer.cpp:267), EVSM (exponential variance,
# Shaders/EVSM.hlsl) and MSM (4-moment, Shaders/MSM.hlsl). SMConvert.hlsl
# turns a rendered depth map into the moment representation and FilterSM
# box-blurs it separably; sampling is then a single filtered texture fetch +
# a closed-form upper bound (Chebyshev for EVSM, Hamburger 4-moment for MSM).

# ShadowHelper defaults: LightBleedingReduction 0.25 (ShadowHelper.h:40,48),
# MomentBias 0.0003 (ShadowHelper.h:47); 40/8 EVSM exponents clamped to 42
# like GetEVSMExponents (EVSM.hlsl).
EVSM_POSITIVE_EXPONENT = 40.0
EVSM_NEGATIVE_EXPONENT = 8.0
EVSM_MAX_EXPONENT = 42.0
LIGHT_BLEEDING_REDUCTION = 0.25
MSM_DEPTH_BIAS = 0.0
MSM_MOMENT_BIAS = 0.0003

# GetOptimizedMoments / ConvertOptimizedMoments quantization transform
# (MSM.hlsl — the published Peters & Klein optimized-moment basis).
_MSM_ENCODE = np.array(
    [[-2.07224649,    13.7948857237,  0.105877704,   9.7924062118],
     [32.23703778,   -59.4683975703, -1.9077466311, -33.7652110555],
     [-68.571074599,  82.0359750338,  9.3496555107,  47.9456096605],
     [39.3703274134, -35.364903257,  -6.6543490743, -23.9728048165]],
    np.float32)
_MSM_DECODE = np.array(
    [[0.2227744146, 0.1549679261, 0.1451988946, 0.163127443],
     [0.0771972861, 0.1394629426, 0.2120202157, 0.2591432266],
     [0.7926986636, 0.7963415838, 0.7258694464, 0.6539092497],
     [0.0319417555, -0.1722823173, -0.2758014811, -0.3376131734]],
    np.float32)
_MSM_BIAS0 = 0.035955884801


def _times4x4(x, m):
    """(..., 4) row vectors times a (4, 4) host matrix, each output the sum
    of four products in order."""
    cols = [x[..., 0] * float(m[0, j]) + x[..., 1] * float(m[1, j])
            + x[..., 2] * float(m[2, j]) + x[..., 3] * float(m[3, j])
            for j in range(4)]
    return torch.stack(cols, dim=-1)


def evsm_exponents(cascade_scale_z=1.0):
    """GetEVSMExponents (EVSM.hlsl): light-space exponents kept consistent
    across partitions, clamped so exp() stays inside fp32."""
    pos = min(EVSM_POSITIVE_EXPONENT / cascade_scale_z, EVSM_MAX_EXPONENT)
    neg = min(EVSM_NEGATIVE_EXPONENT / cascade_scale_z, EVSM_MAX_EXPONENT)
    return pos, neg


def warp_depth(depth, exponents):
    """WarpDepth (EVSM.hlsl): [0,1] depth -> (exp(+px*d'), -exp(-nx*d'))
    with d' rescaled to [-1,1]."""
    d = 2.0 * depth - 1.0
    return exp(exponents[0] * d), -exp(-exponents[1] * d)


def convert_depth_maps(depth_maps, mode: str):
    """SMConvert.hlsl: (C, S, S) [0,1] depth -> (C, S, S, 4) moments.

    mode 'evsm': [pos, neg, pos^2, neg^2] warped-depth moments.
    mode 'msm':  optimized 4-moment encoding (GetOptimizedMoments)."""
    d = depth_maps
    if mode == "evsm":
        pos, neg = warp_depth(d, evsm_exponents())
        return torch.stack([pos, neg, pos * pos, neg * neg], dim=-1)
    if mode == "msm":
        sq = d * d
        opt = _times4x4(torch.stack([d, sq, sq * d, sq * sq], dim=-1),
                        _MSM_ENCODE)
        opt[..., 0] += _MSM_BIAS0
        return opt
    raise ValueError(f"unknown moment mode {mode!r}")


def filter_moment_maps(maps, filter_size: float = 3.0):
    """FilterSM (SMConvert.hlsl): separable box blur of the moment maps,
    fractional end-texel weights, clamped edges. filter_size is in texels
    (MaxShadowFilterSize = 9, ShadowHelper.h:26)."""
    radius = filter_size * 0.5
    ntap = int(np.ceil(radius - 0.5))

    def blur(m, axis):
        s = m.shape[axis]
        idx = torch.arange(s, device=m.device)
        total = m * 1.0
        weight = 1.0
        for k in range(1, ntap + 1):
            # overlap of texel [k-0.5, k+0.5] with the filter [-R, R]
            w = float(np.clip(radius - (k - 0.5), 0.0, 1.0))
            if w <= 0.0:
                continue
            total = total + w * (
                m.index_select(axis, torch.clamp(idx + k, 0, s - 1))
                + m.index_select(axis, torch.clamp(idx - k, 0, s - 1)))
            weight += 2.0 * w
        return div(total, weight)

    return blur(blur(maps, 1), 2)


def _bilinear_fetch4(maps, cidx, hx, hy):
    """Bilinearly sample (C, S, S, 4) moment maps at NDC (hx, hy) of the
    per-lane selected map cidx — the SampleShadowMapEVSM/MSM linear fetch."""
    s = maps.shape[1]
    flat = maps.reshape(-1, 4)
    base = cidx * (s * s)
    stx = (hx * 0.5 + 0.5) * s - 0.5
    sty = (hy * 0.5 + 0.5) * s - 0.5
    x0 = torch.clamp(torch.floor(stx), 0, s - 1)
    y0 = torch.clamp(torch.floor(sty), 0, s - 1)
    fx = torch.clamp(stx - x0, 0.0, 1.0)[..., None]
    fy = torch.clamp(sty - y0, 0.0, 1.0)[..., None]
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)
    x1 = torch.clamp_max(x0 + 1, s - 1)
    y1 = torch.clamp_max(y0 + 1, s - 1)

    def tap(yy, xx):
        return flat[base + yy * s + xx]

    top = tap(y0, x0) * (1.0 - fx) + tap(y0, x1) * fx
    bot = tap(y1, x0) * (1.0 - fx) + tap(y1, x1) * fx
    return top * (1.0 - fy) + bot * fy


def reduce_light_bleeding(amt, clip_amt):
    """ReduceLightBleeding (EVSM.hlsl): clip the [0, clipAmt] tail and
    linearly rescale."""
    return torch.clamp(div(amt - clip_amt, 1.0 - clip_amt), 0.0, 1.0)


def chebyshev_upper_bound(m1, m2, mean, min_variance, bleed):
    """ChebyshevUpperBound (EVSM.hlsl): one-tailed variance bound."""
    variance = torch.maximum(m2 - m1 * m1, min_variance)
    d = mean - m1
    p_max = reduce_light_bleeding(variance / (variance + d * d), bleed)
    return torch.where(mean <= m1, 1.0, p_max)


def _msm_hamburger(moments, fragment_depth, depth_bias, moment_bias):
    """ComputeMSMHamburger (MSM.hlsl): Cholesky-factorized Hankel solve of
    the 4-moment shadow bound, per lane."""
    b = moments * (1.0 - moment_bias) + 0.5 * moment_bias
    b0, b1, b2, b3 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    z0 = fragment_depth - depth_bias

    l32_d22 = b2 - b0 * b1
    d22 = b1 - b0 * b0
    sq_depth_var = b3 - b1 * b1
    d33_d22 = sq_depth_var * d22 - l32_d22 * l32_d22
    inv_d22 = 1.0 / d22
    l32 = l32_d22 * inv_d22

    c1 = z0 - b0
    c2 = z0 * z0 - b1 - l32 * c1
    c1 = c1 * inv_d22
    c2 = c2 * d22 / d33_d22
    c1 = c1 - l32 * c2
    c0 = 1.0 - c1 * b0 - c2 * b1

    p = c1 / c2
    q = c0 / c2
    r = sqrt(torch.clamp_min(p * p * 0.25 - q, 0.0))
    z1 = -p * 0.5 - r
    z2 = -p * 0.5 + r

    # switch weights for the three-delta solution
    case2 = z2 < z0          # -> (z1, z0, 1, 1)
    case1 = (~case2) & (z1 < z0)  # -> (z0, z1, 0, 1)
    sw0 = torch.where(case2, z1, torch.where(case1, z0, 0.0))
    sw1 = torch.where(case2, z0, torch.where(case1, z1, 0.0))
    sw2 = torch.where(case2, 1.0, 0.0)
    sw3 = torch.where(case2 | case1, 1.0, 0.0)
    denom = (z2 - sw1) * (z0 - z1)
    safe = torch.where(denom.abs() < 1e-12, 1e-12, denom)
    quotient = (sw0 * z2 - b0 * (sw0 + z2) + b1) / safe
    intensity = sw2 + sw3 * quotient
    # saturate() as HLSL has it: a NaN (a degenerate Hankel matrix, e.g.
    # moments of one flat depth) goes to 0, where torch.clamp (and the JAX
    # package's jnp.clip) would keep it
    intensity = torch.where(torch.isnan(intensity), 0.0, intensity)
    return 1.0 - torch.clamp(intensity, 0.0, 1.0)


def sun_visibility_moments(moment_maps, cascades, pos_ws, normal_ws, n_dot_l,
                           depth_vs_normalized, mode: str):
    """SunShadowVisibility through the EVSM/MSM samplers
    (Shadows.hlsl:88-160): the same cascade selection + normal-offset
    projection as the PCF path, but one bilinear moment fetch + closed-form
    bound instead of the 7x7 comparison kernel."""
    s = moment_maps.shape[1]
    cidx, hx, hy, hz = _cascade_project(cascades, s, pos_ws, normal_ws,
                                        n_dot_l, depth_vs_normalized)
    occ = _bilinear_fetch4(moment_maps, cidx, hx, hy)
    if mode == "evsm":
        exps = evsm_exponents()
        wpos, wneg = warp_depth(hz, exps)
        # derivative of the warp at depth -> minimum variance floor
        # (x ** 2 as XLA's integer power: one product)
        dp = 1e-4 * exps[0] * wpos
        dn = 1e-4 * exps[1] * wneg
        pos_c = chebyshev_upper_bound(occ[..., 0], occ[..., 2], wpos,
                                      dp * dp, LIGHT_BLEEDING_REDUCTION)
        neg_c = chebyshev_upper_bound(occ[..., 1], occ[..., 3], wneg,
                                      dn * dn, LIGHT_BLEEDING_REDUCTION)
        return torch.minimum(pos_c, neg_c)
    if mode == "msm":
        occ = occ.clone()
        occ[..., 0] -= _MSM_BIAS0
        raw = _times4x4(occ, _MSM_DECODE)
        vis = _msm_hamburger(raw, hz, MSM_DEPTH_BIAS, MSM_MOMENT_BIAS)
        return reduce_light_bleeding(vis, LIGHT_BLEEDING_REDUCTION)
    raise ValueError(f"unknown moment mode {mode!r}")
