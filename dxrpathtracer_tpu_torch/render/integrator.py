"""Wavefront path-tracing integrator on torch tensors.

The port of dxrpathtracer_tpu/render/integrator.py. The reference's
recursive megakernel (RayGen -> ClosestHit -> PathTrace -> recursive
TraceRay, DXRPathTracer/RayTrace.hlsl:92-441) becomes a loop over path depth
with the whole pixel wavefront carried as SoA tensors;
`radiance += throughput * child` unrolls into a carried throughput `beta`.

Traversal routes as the JAX package's `trace_paths` does, by the settings'
engine fields; every engine is exact, so the route changes times, not
results (closest hits up to the triangle of an equal-t tie):
  - depth-1 opaque closest hits and depth-1 opaque sun visibility take the
    packet walk on the W8 table `bvh` (accel/packet.py) when
    enable_packet_traversal is on and the lanes are packet-tiled
    (`render_sample` tiles them 128 pixels a packet where a tile divides
    the image); packet_shadows_all_depths adds the terminal rays;
  - opaque sun visibility takes the sun-space grid (accel/sunspace.py,
    enable_sunspace_shadows) at depth >= 2, and at depth 1 without packets
    (the bake);
  - every other request walks per ray (accel/traverse.py): depth-1 on `bvh`,
    deeper on the W32 table `ray_bvh`. With a cut bound (enable_clear_cut,
    gated per scene by the session) a per-ray opaque closest hit and every
    per-ray shadow request first drop the lanes the AABB cut clears; an
    opaque per-ray shadow request then drops the lanes the dense proxy
    blocks (enable_dense_proxy; accel/proxy.py).
Three more exact alternates of an opaque closest hit, off by default as in
the JAX package, route in its order:
  - the software raster (render/swraster.py): given bins (the session
    builds them where DXRPT_RASTER_MIN_PIXELS lets it), depth-1 closest
    hits on packet lanes with no alpha test and no history;
  - temporal hit reuse (accel/history.py): given a history (the session
    keeps one under DXRPT_HISTORY) and no alpha test in the frame, depth-1
    closest hits are seeded by last sample's triangle (over the packet
    walk, or the per-ray W8 walk without packets), and depth-1 sun rays on
    the packet route retest last sample's occluder first;
  - proxy seeding (accel/proxy.py, where the proxy is bound and
    DXRPT_PROXY_SEED is set and not "0"): per-ray opaque closest hits are
    bounded by the nearest proxy hit; it comes before the cut's screen.
The split alpha route, off by default as in the JAX package, routes where
DXRPT_SPLIT_ALPHA is set, the session has an alpha-only table (`alpha_bvh`:
the alpha-tested triangles, two to a leaf) and the W8 table flags them:
  - depth-1 alpha-tested closest hits on packet lanes: the opaque-only
    packet walk of `bvh` (or, where the bins are masked to opaque
    triangles, the software raster) gives the nearest opaque hit; the
    K-candidate packet walk of the alpha-only table, bounded by it, gives
    each lane's K nearest alpha-tested hits (K = DXRPT_KCAND, 8 by
    default, at most 8), which are tapped outside the walk, nearest first
    (`_split_alpha_closest`);
  - alpha-tested packet shadow rays (sun, and terminal under
    packet_shadows_all_depths): the opaque-only packet any-hit walk, then
    the same candidates on the lanes it leaves unblocked
    (`_split_alpha_visibility`).
  The route keeps the JAX punch-through's truncation: a lane whose K
  nearest candidates are all rejected takes the K-th as opaque (the
  in-walk test would go on). The JAX package's punch-through itself, with
  its raster rounds, is not ported: without the switch alpha-tested rays
  keep the in-walk alpha test below.

Alpha testing runs inside the per-ray walk (the kernel's alpha
instantiations, or the plain walk's accept_fn): the JAX package's in-loop
accept_fn route, so no engine but the cut sees an alpha-tested ray. The
JAX package's default route, punch-through (`_punch_through_closest`:
opaque walks re-started past each rejected hit, at most 8 rounds, the last
one taking what it finds as opaque), gives the same hits except past chains
of more than 8 rejections and where its t*(1+4e-6)+1e-6 restart skips a
surface.

Shading is torch ops on the lanes but for two hand kernels, each routed by
device with a plain torch twin for the CPU: the packed shading row of each
hit (accel/gather.py -> csrc/gather.cu) and the material-map taps
(`_sample_packed` -> scene/textures.py::bilinear_from_meta -> csrc/taps.cu,
one launch a tap; the twin is `bilinear_from_meta_plain`).

Semantics parity (each implemented below, as in the JAX package):
  - CMJ sample points: primary = set 0, bounce k = set k; permutation =
    set * TotalNumPixels + pixelIdx (RayTrace.hlsl:85-90)
  - primary ray un-projection through InvViewProjection with y-flip (:100-112)
  - miss: sky cubemap sample, sun-disc *replace* at depth 1 (:509-530)
  - normal mapping, metallic/roughness scaling, Turquin multiscatter energy
    compensation including the reference's -rayDir.z quirk in the
    specular-sample DFG lookup (:361)
  - sun NEE with the representative-point area-light approximation (:224-262)
  - spot-light NEE with smoothstep angular attenuation and 4th-power
    distance falloff (:264-313); shadow ray offset by 0.01 * normal, t in
    [SpotShadowNearClip, dist - SpotShadowNearClip]
  - 50/50 lobe selection, cosine-hemisphere diffuse / GGX-VNDF specular
    (:315-376); terminal sky-visibility ray (:411-438)
  - any-hit alpha test (opacity < 0.35 ignores the hit) only while depth <=
    MaxAnyHitPathLength, else FORCE_OPAQUE (:129-133, :485-507)
  - final clamp to [0, FP16Max] and running-mean accumulation (:140-148)
"""

import dataclasses
import os

import numpy as np
import torch

from ..accel import history as history_lib
from ..accel import proxy as proxy_lib
from ..accel.gather import row_gather
from ..accel.packet import (LEAF_EXTRACT, PACKET, packet_any_hit,
                            packet_any_hit_rec, packet_closest_hit,
                            packet_closest_hit_alpha)
from ..accel.proxy import cut_clear, screened_any
from ..accel.sunspace import sun_any_hit
from ..accel.traverse import AlphaTest, HitRecord, any_hit, closest_hit
from ..app.profiler import span, spanned
from ..app.settings import SPOT_SHADOW_NEAR_CLIP, AppSettings
from ..core import brdf as brdf_lib
from ..core import cmj
from ..core.constants import FP16Max, FP32Max
from ..core.math3 import (div, dot, normalize, reflect, saturate, smoothstep,
                          sqrt)
from ..core.sampling import sample_cosine_hemisphere, sample_ggx_visible_normal
from ..scene.textures import bilinear_from_meta
from ..scene.types import (PACKED_SLOTS, TRI_SHADE_MAT, TRI_SHADE_META,
                           TRI_SHADE_VTX)
from ..sky.cubemap import sample_cubemap
from .swraster import raster_closest_hit


@dataclasses.dataclass(frozen=True)
class FrameConstants:
    """Per-frame scalars — the RayTraceConstants cbuffer (RayTrace.hlsl:24-44)."""

    inv_view_projection: torch.Tensor    # (4, 4) f32, row-vector convention
    camera_pos_ws: torch.Tensor          # (3,)
    sun_direction_ws: torch.Tensor       # (3,)
    sun_irradiance: torch.Tensor         # (3,)
    sun_render_color: torch.Tensor       # (3,)
    cos_sun_angular_radius: torch.Tensor  # () f32
    sin_sun_angular_radius: torch.Tensor  # () f32
    curr_sample_idx: int                 # progressive sample index

    def to(self, device) -> "FrameConstants":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def _fetch_shade_inputs(scene, tri_id, u, v):
    """Surface + material inputs from ONE packed row per hit (pack_tri_shade):
    barycentric lerp over the three 14-wide vertex blocks, material index and
    packed material meta from the same row (GetHitSurface,
    RayTrace.hlsl:444-464)."""
    rec = row_gather(scene.tri_shade,
                     torch.clamp_min(tri_id, 0).to(torch.int32))  # (n, 64)
    w = (1.0 - u - v)[..., None]
    K = TRI_SHADE_VTX
    blk = (rec[:, 0:K] * w + rec[:, K:2 * K] * u[..., None]
           + rec[:, 2 * K:3 * K] * v[..., None])
    pos = blk[:, 0:3]
    geo_n = normalize(blk[:, 3:6], eps=1e-37)
    uv_l = blk[:, 6:8]
    tan = normalize(blk[:, 8:11], eps=1e-37)
    bit = normalize(blk[:, 11:14], eps=1e-37)
    rec_i = rec.view(torch.int32)
    mat = rec_i[:, TRI_SHADE_MAT]
    packed_mm = rec_i[:, TRI_SHADE_META:TRI_SHADE_META + 20]
    return pos, geo_n, uv_l, tan, bit, mat, packed_mm


def _sample_packed(scene, packed, uv, slot):
    """Texture tap of material slot `slot` via the packed meta row: on the
    card one launch of csrc/taps.cu, which reads the row's (base, w, h)
    columns and the vertex block's uv in place; on the CPU its plain twin
    (scene/textures.py::bilinear_from_meta)."""
    k = 3 * PACKED_SLOTS.index(slot)
    with span("shade.taps"):
        return bilinear_from_meta(scene.texels, packed[..., k],
                                  packed[..., k + 1], packed[..., k + 2], uv)


def _to_tangent(v_ws, tan, bit, nrm):
    """Row-vector mul by transpose(tangentToWorld): project onto T/B/N."""
    return torch.stack([dot(v_ws, tan), dot(v_ws, bit), dot(v_ws, nrm)], dim=-1)


def _from_tangent(v_ts, tan, bit, nrm):
    """Row-vector mul by tangentToWorld = rows (T, B, N)."""
    return (v_ts[..., 0:1] * tan + v_ts[..., 1:2] * bit + v_ts[..., 2:3] * nrm)


def _depth_schedule(settings: AppSettings):
    """Per-depth control flags (the reference's compile-time AppSettings
    branches, RayTrace.hlsl:153-158, 388), for depths 1..MaxPathLength-1;
    stops after an `early_stop` or non-`continue_paths` depth."""
    s = settings
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
            is_last=is_last,
            furnace=furnace,
            early_stop=early_stop,
            continue_paths=continue_paths,
            use_any_hit=depth <= s.max_any_hit_path_length,
            terminal_any_hit=(depth + 1) <= s.max_any_hit_path_length,
        )))
        if early_stop or not continue_paths:
            break
    return out


def _path_state0(ray_o, ray_d, t_max, t_min0=0.0, active0=None,
                 initial_is_diffuse: bool = False):
    """The depth-1 carry. t_min0 is a scalar or (n,); active0 (n,) bool or
    None (all lanes); initial_is_diffuse seeds prev_is_diffuse (the bake's
    IsDiffuse = true, Baking.hlsl:395-409)."""
    n = ray_o.shape[0]
    dev = ray_o.device
    f32 = torch.float32
    if isinstance(t_min0, torch.Tensor):
        t_min = t_min0.to(f32)
    else:
        t_min = torch.full((n,), float(t_min0), dtype=f32, device=dev)
    return dict(
        total=torch.zeros((n, 3), dtype=f32, device=dev),
        beta=torch.ones((n, 3), dtype=f32, device=dev),
        active=(torch.ones(n, dtype=torch.bool, device=dev)
                if active0 is None else active0),
        prev_is_diffuse=torch.full((n,), bool(initial_is_diffuse),
                                   dtype=torch.bool, device=dev),
        prev_roughness=torch.zeros(n, dtype=f32, device=dev),
        ray_o=ray_o,
        ray_d=ray_d,
        t_min=t_min,
        t_max=t_max.to(f32),
    )


def _sky_radiance(sky_cube, settings: AppSettings, dirs):
    n = dirs.shape[0]
    if settings.enable_white_furnace_mode:
        return torch.ones((n, 3), dtype=torch.float32, device=dirs.device)
    if not settings.enable_sky or sky_cube is None:
        return torch.zeros((n, 3), dtype=torch.float32, device=dirs.device)
    return sample_cubemap(sky_cube, dirs)


def _make_alpha_test(scene, settings: AppSettings) -> AlphaTest | None:
    """The alpha test for traversal, or None when the scene has no
    opacity-mapped materials (then every hit-group record is opaque,
    DXRPathTracer.cpp:1176-1199). Called as accept_fn(tid, u, v) it is the
    plain version of the kernel's test (JAX `_make_alpha_test`)."""
    if not scene.any_opacity:
        return None
    return AlphaTest(scene.tri_shade, scene.texels)


def _resolve_candidates(rec, cands, accept):
    """The K-candidate resolution (JAX `_resolve_candidates`): each lane's
    first candidate (nearest first) below rec.t that `accept` passes wins
    over `rec`; returns the winners as a HitRecord. Only the candidates
    below rec.t are tapped. (The JAX function also returns the lanes its
    punch-through fallback takes, which the port does not have.)"""
    valid = (cands["tri"] >= 0) & (cands["t"] < rec.t[:, None])
    acc = torch.zeros_like(valid)
    sel = valid.nonzero(as_tuple=True)
    if sel[0].numel():
        acc[sel] = accept(cands["tri"][sel], cands["u"][sel],
                          cands["v"][sel])
    ok = valid & acc
    resolved = ok.any(dim=1)
    first = ok.to(torch.int8).argmax(dim=1, keepdim=True)  # first True
    pick = lambda k, base: torch.where(  # noqa: E731
        resolved, cands[k].gather(1, first)[:, 0], base)
    return HitRecord(t=pick("t", rec.t), tri_id=pick("tri", rec.tri_id),
                     u=pick("u", rec.u), v=pick("v", rec.v))


def _alpha_resolve_all(kcand_fn, accept, o, d, t_min, bound, active,
                       rec_default):
    """The alpha candidates' resolution against the alpha-only table (JAX
    `_alpha_resolve_all` with no_overflow): one K-candidate walk bounded
    by `bound`, the taps on its candidates, and the JAX punch-through's
    truncation: a lane whose full buffer has every candidate rejected
    takes its K-th candidate as opaque. The alpha table's leaves hold at
    most LEAF_EXTRACT triangles, so no lane overflows."""
    n, dev = o.shape[0], o.device
    f32 = torch.float32
    t_min = torch.as_tensor(t_min, dtype=f32, device=dev).expand(n)
    bound = torch.as_tensor(bound, dtype=f32, device=dev).expand(n)
    _, cands = kcand_fn(o, d, t_min, bound, active)
    win = _resolve_candidates(rec_default, cands, accept)
    resolved = win.t < rec_default.t
    last_t, last_tri = cands["t"][:, -1], cands["tri"][:, -1]
    full = (last_tri >= 0) & (last_t < rec_default.t)
    take = active & full & ~resolved & ~cands["overflow"]
    return HitRecord(t=torch.where(take, last_t, win.t),
                     tri_id=torch.where(take, last_tri, win.tri_id),
                     u=torch.where(take, cands["u"][:, -1], win.u),
                     v=torch.where(take, cands["v"][:, -1], win.v))


@spanned("traverse.split_alpha")
def _split_alpha_closest(opq_fn, kcand_fn, accept, o, d, t_min, t_max,
                         active):
    """The split alpha route's closest hit (JAX `_split_alpha_closest`):
    the opaque-only walk of the scene table (or the masked raster bins)
    gives the nearest opaque hit, which bounds the K-candidate walk of the
    alpha-only table; its candidates are tapped outside the walk."""
    rec = opq_fn(o, d, t_min, t_max, active)
    return _alpha_resolve_all(kcand_fn, accept, o, d, t_min, rec.t, active,
                              rec)


@spanned("traverse.split_alpha")
def _split_alpha_visibility(opq_any_fn, kcand_fn, accept, o, d, t_min,
                            t_max, active):
    """The split alpha route's shadow visibility (JAX
    `_split_alpha_visibility`): the opaque-only any-hit walk, then the
    candidates' resolution on the lanes it leaves unblocked. (N,) f32,
    1 = unoccluded."""
    n, dev = o.shape[0], o.device
    vis_opq, _ = opq_any_fn(o, d, t_min, t_max, active)
    blocked_opq = active & (vis_opq == 0.0)
    need_alpha = active & ~blocked_opq
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(n)
    rec_default = HitRecord(
        t=t_max, tri_id=torch.full((n,), -1, dtype=torch.int32, device=dev),
        u=torch.zeros(n, device=dev), v=torch.zeros(n, device=dev))
    win = _alpha_resolve_all(kcand_fn, accept, o, d, t_min, t_max,
                             need_alpha, rec_default)
    blocked = blocked_opq | (need_alpha & (win.tri_id >= 0))
    return torch.where(blocked, 0.0, 1.0)


def _split_alpha_tables(bvh, alpha_bvh):
    """(the alpha-only table, K) when the split alpha route is on
    (DXRPT_SPLIT_ALPHA set, an alpha-only table given, the W8 table with
    alpha flags), else None. K is DXRPT_KCAND (8 by default)."""
    if not (os.environ.get("DXRPT_SPLIT_ALPHA") and alpha_bvh is not None
            and bvh.has_alpha_flags):
        return None
    if alpha_bvh.leaf_size > LEAF_EXTRACT:
        raise ValueError(f"split alpha: the alpha-only table's leaves hold "
                         f"{alpha_bvh.leaf_size} triangles; the route needs "
                         f"at most LEAF_EXTRACT = {LEAF_EXTRACT}")
    return alpha_bvh, int(os.environ.get("DXRPT_KCAND", "8"))


def _num_lights(scene, settings: AppSettings) -> int:
    if not settings.render_lights:
        return 0
    return min(scene.num_lights, int(settings.max_light_clamp))


def _shadow_plan(scene, settings: AppSettings, has_alpha: bool, flags):
    """(kind, use_alpha) of each shadow request, in _shade_vertex's order."""
    s = settings
    plan = []
    if s.enable_sun and not flags["furnace"]:
        plan.append(("sun", flags["use_any_hit"] and has_alpha))
    plan += [("spot", flags["use_any_hit"] and has_alpha)] * _num_lights(
        scene, s)
    if not flags["continue_paths"] and not flags["furnace"]:
        plan.append(("terminal", flags["terminal_any_hit"] and has_alpha))
    return plan


def _shadow_calls(bvh, ray_bvh, alpha, depth: int, plan, reqs):
    """The any-hit launches that answer one vertex's shadow requests:
    [(kind, table, (origin, dir, tmin, tmax, mask), alpha or None,
    request positions)]. Depth-1 sun and spot rays walk the W8 table, the
    rest W32. The spot rays of all lights go in ONE launch, their requests
    concatenated (the JAX package makes one any_hit call per light, each a
    lockstep loop on the TPU; here each ray's walk is its own, so the
    results are the same and the launches fewer)."""
    calls = []
    for kind in ("sun", "spot", "terminal"):
        pos = [i for i, (k, _) in enumerate(plan) if k == kind]
        if not pos:
            continue
        use_alpha = plan[pos[0]][1]
        table = bvh if (depth == 1 and kind != "terminal") else ray_bvh
        r = reqs[pos[0]] if len(pos) == 1 else tuple(
            torch.cat([reqs[i][k] for i in pos]) for k in range(5))
        calls.append((kind, table, r, alpha if use_alpha else None, pos))
    return calls


def _shade_vertex(scene, sky_cube, settings: AppSettings, frame: FrameConstants,
                  depth: int, flags, state, rec, pixel_idx,
                  total_num_pixels: int, first_set_idx: int, cmj_sample_idx):
    """Miss shader, surface fetch, material sampling, sun light and BRDF
    sampling (RayTrace.hlsl:153-386).

    Returns (state', shadow_reqs, mid): shadow_reqs is a tuple of
    (origin, dir, tmin, tmax, mask) ordered per _shadow_plan; mid holds the
    per-vertex tensors _apply_vertex needs."""
    s = settings
    n = state["ray_o"].shape[0]
    dev = state["ray_o"].device
    f32 = torch.float32
    furnace = flags["furnace"]

    ray_o = state["ray_o"]
    ray_d = state["ray_d"]
    active = state["active"]
    total = state["total"]
    beta = state["beta"]

    hit = rec.hit & active
    missed = active & ~hit

    # ---- Miss shader (RayTrace.hlsl:509-530) ----
    with span("shade.miss"):
        if furnace:
            miss_rad = torch.ones((n, 3), dtype=f32, device=dev)
        else:
            miss_rad = _sky_radiance(sky_cube, s, ray_d)
            if depth == 1:
                cos_sun = dot(ray_d, frame.sun_direction_ws[None, :])
                in_disc = cos_sun >= frame.cos_sun_angular_radius
                miss_rad = torch.where(in_disc[..., None],
                                       frame.sun_render_color[None, :], miss_rad)
        total = total + torch.where(missed[..., None], beta * miss_rad, 0.0)
    state = dict(state, total=total)

    # ---- PathTrace early-outs (RayTrace.hlsl:153-158) ----
    if flags["early_stop"]:
        state = dict(state, active=torch.zeros_like(active))
        return state, (), {}

    # ---- Hit surface ----
    with span("shade.fetch"):
        pos, geo_n, uv, tan, bit, mat, packed_mm = _fetch_shade_inputs(
            scene, rec.tri_id, rec.u, rec.v)
    incoming_dir = ray_d
    incoming_origin = ray_o

    normal_ws = geo_n
    if s.enable_normal_maps:
        nm = _sample_packed(scene, packed_mm, uv, "normal")
        nx = nm[..., 0] * 2.0 - 1.0
        ny = nm[..., 1] * 2.0 - 1.0
        nz = sqrt(torch.clamp_min(1.0 - saturate(nx * nx + ny * ny), 0.0))
        normal_ws = normalize(
            nx[..., None] * tan + ny[..., None] * bit + nz[..., None] * geo_n,
            eps=1e-37)
    # tangentToWorld._31_32_33 = normalWS (RayTrace.hlsl:178)
    frame_n = normal_ws

    if s.enable_albedo_maps and not furnace:
        base_color = _sample_packed(scene, packed_mm, uv, "albedo")[..., :3]
    else:
        base_color = torch.ones((n, 3), dtype=f32, device=dev)

    if furnace:
        metallic_raw = torch.ones(n, dtype=f32, device=dev)
        sqrt_rough_raw = torch.ones(n, dtype=f32, device=dev)
    else:
        metallic_raw = _sample_packed(scene, packed_mm, uv, "metallic")[..., 0]
        sqrt_rough_raw = _sample_packed(scene, packed_mm, uv, "roughness")[..., 0]
    metallic = saturate(metallic_raw * s.metallic_scale)
    sqrt_roughness = saturate(sqrt_rough_raw * s.roughness_scale)

    enable_diffuse_l = (metallic < 1.0) & bool(s.enable_diffuse)
    enable_diffuse_l = enable_diffuse_l | furnace
    if s.enable_specular:
        if s.enable_indirect_specular:
            if s.avoid_caustic_paths:
                enable_specular_l = ~state["prev_is_diffuse"]
            else:
                enable_specular_l = torch.ones(n, dtype=torch.bool, device=dev)
        else:
            enable_specular_l = torch.full((n,), depth == 1, dtype=torch.bool,
                                           device=dev)
    else:
        enable_specular_l = torch.zeros(n, dtype=torch.bool, device=dev)

    lane_dead = ~(enable_diffuse_l | enable_specular_l)  # return 0 (hlsl:194-195)

    diffuse_albedo = ((1.0 - metallic)[..., None] * base_color
                      * enable_diffuse_l[..., None].to(f32))
    specular_albedo = ((0.03 + (base_color - 0.03) * metallic[..., None])
                       * enable_specular_l[..., None].to(f32))
    roughness = sqrt_roughness * sqrt_roughness
    if s.clamp_roughness:
        roughness = torch.maximum(roughness, state["prev_roughness"])

    ms_comp = torch.ones((n, 3), dtype=f32, device=dev)
    if s.apply_multiscattering_energy_compensation:
        n_dot_v = saturate(dot(normal_ws, -incoming_dir))
        ess, _ = brdf_lib.ggx_environment_brdf_scale_bias(n_dot_v, sqrt_roughness)
        ms_comp = 1.0 + specular_albedo * (1.0 / ess[..., None] - 1.0)

    if furnace:
        local = torch.zeros((n, 3), dtype=f32, device=dev)
    else:
        local = _sample_packed(scene, packed_mm, uv, "emissive")[..., :3]

    shadow_reqs = []  # (origin, dir, tmin, tmax, mask); order = _shadow_plan

    # ---- Sun NEE (RayTrace.hlsl:224-262) ----
    with span("shade.sun"):
        if s.enable_sun and not furnace:
            sun_d = frame.sun_direction_ws[None, :]
            if s.sun_area_light_approximation:
                r_vec = reflect(incoming_dir, normal_ws)
                d_dot_r = dot(sun_d, r_vec)
                s_vec = r_vec - d_dot_r[..., None] * sun_d
                closest = (frame.cos_sun_angular_radius * sun_d
                           + normalize(s_vec, eps=1e-37) * frame.sin_sun_angular_radius)
                shade_sun_dir = torch.where(
                    (d_dot_r < frame.cos_sun_angular_radius)[..., None],
                    normalize(closest, eps=1e-37), r_vec)
            else:
                shade_sun_dir = sun_d.expand(n, 3)
            # Lanes facing away from the sun contribute exactly 0 (calc_lighting
            # multiplies by saturate(NdotL)): skip their occlusion walk.
            sun_relevant = hit & (dot(normal_ws, shade_sun_dir) > 0.0)
            shadow_reqs.append((pos, sun_d.expand(n, 3).contiguous(),
                                torch.full((n,), 1e-5, dtype=f32, device=dev),
                                torch.full((n,), FP32Max, dtype=f32, device=dev),
                                sun_relevant))
            sun_light = brdf_lib.calc_lighting(
                normal_ws, shade_sun_dir, frame.sun_irradiance[None, :],
                diffuse_albedo, specular_albedo, roughness, pos,
                incoming_origin, ms_comp)
        else:
            sun_light = None

    # ---- Spot-light NEE (RayTrace.hlsl:264-313) ----
    with span("shade.spot"):
        spot_contribs = []  # (light, relevant), aligned with shadow_reqs order
        lights = scene.lights
        for li in range(_num_lights(scene, s)):
            to_light = lights.position[li][None, :] - pos
            dist = sqrt(torch.clamp_min(dot(to_light, to_light), 1e-20))
            to_light = to_light / dist[..., None]
            angle_f = saturate(dot(to_light, lights.direction[li][None, :]))
            ang_att = smoothstep(lights.angular_attenuation_y[li],
                                 lights.angular_attenuation_x[li], angle_f)
            dd = dist / lights.range[li]
            dd2 = dd * dd  # dd ** 4 as XLA's integer_pow: (dd*dd)*(dd*dd)
            falloff = saturate(1.0 - dd2 * dd2)
            falloff = (falloff * falloff) / (dist * dist + 1.0)
            ang_att = ang_att * falloff
            # NdotL <= 0 zeroes calc_lighting exactly: cull those lanes' shadow
            # walk too, as the lanes outside the cone or range
            relevant = hit & (ang_att > 0.0) & (dot(normal_ws, to_light) > 0.0)
            shadow_reqs.append((
                pos + normal_ws * 0.01, to_light,
                torch.full((n,), SPOT_SHADOW_NEAR_CLIP, dtype=f32, device=dev),
                torch.clamp_min(dist - SPOT_SHADOW_NEAR_CLIP,
                                SPOT_SHADOW_NEAR_CLIP),
                relevant))
            light = brdf_lib.calc_lighting(
                normal_ws, to_light,
                lights.intensity[li][None, :] * ang_att[..., None],
                diffuse_albedo, specular_albedo, roughness, pos,
                incoming_origin, ms_comp)
            spot_contribs.append((light, relevant))

    # ---- BRDF sampling (RayTrace.hlsl:315-376) ----
    with span("shade.sample"):
        set_idx = first_set_idx + (depth - 1)
        permutation = (set_idx * total_num_pixels + pixel_idx) & 0xFFFFFFFF
        sqrt_n = int(s.sqrt_num_samples)
        uv2 = cmj.sample_cmj_2d(cmj_sample_idx, sqrt_n, sqrt_n, permutation)
        bx = uv2[..., 0]
        by = uv2[..., 1]

        selector = torch.where(enable_specular_l, bx, 0.0)
        selector = torch.where(enable_diffuse_l, selector, 1.0)
        pick_diffuse = selector < 0.5

        # Diffuse branch
        bx_d = torch.where(enable_specular_l, bx * 2.0, bx)
        dir_ts_diff = sample_cosine_hemisphere(bx_d, by)
        thr_diff = diffuse_albedo

        # Specular branch (GGX VNDF)
        bx_s = torch.where(enable_diffuse_l, (bx - 0.5) * 2.0, bx)
        incoming_ts = normalize(_to_tangent(incoming_dir, tan, bit, frame_n), eps=1e-37)
        m_ts = sample_ggx_visible_normal(-incoming_ts, roughness, roughness, bx_s, by)
        dir_ts_spec = reflect(incoming_ts, m_ts)
        n_ts = torch.zeros((n, 3), dtype=f32, device=dev)
        n_ts[:, 2] = 1.0
        if furnace:
            fres = torch.ones((n, 3), dtype=f32, device=dev)
        else:
            fres = brdf_lib.fresnel(specular_albedo, m_ts, dir_ts_spec)
        a2 = roughness * roughness
        g1 = brdf_lib.smith_ggx_masking(n_ts, dir_ts_spec, -incoming_ts, a2)
        g2 = brdf_lib.smith_ggx_masking_shadowing(n_ts, dir_ts_spec, -incoming_ts, a2)
        thr_spec = fres * (g2 / torch.where(g1 == 0.0, 1.0, g1))[..., None]
        if s.apply_multiscattering_energy_compensation:
            # Reference quirk (RayTrace.hlsl:361): dot(normalTS=(0,0,1),
            # -incomingRayDirWS) mixes spaces; equals -rayDir.z in world space.
            ndv_q = saturate(-incoming_dir[..., 2])
            ess_q, _ = brdf_lib.ggx_environment_brdf_scale_bias(ndv_q, sqrt_roughness)
            thr_spec = thr_spec * (1.0 + specular_albedo * (1.0 / ess_q[..., None] - 1.0))

        ray_dir_ts = torch.where(pick_diffuse[..., None], dir_ts_diff, dir_ts_spec)
        throughput = torch.where(pick_diffuse[..., None], thr_diff, thr_spec)
        ray_dir_ws = normalize(_from_tangent(ray_dir_ts, tan, bit, frame_n), eps=1e-37)
        throughput = torch.where((enable_diffuse_l & enable_specular_l)[..., None],
                                 throughput * 2.0, throughput)

        # Terminal sky-visibility ray (RayTrace.hlsl:411-438); lanes whose path
        # weight is exactly zero in every channel need no visibility.
        if not flags["continue_paths"] and not furnace:
            term_weight = state["beta"] * throughput
            shadow_reqs.append((pos, ray_dir_ws,
                                torch.full((n,), 1e-5, dtype=f32, device=dev),
                                torch.full((n,), FP32Max, dtype=f32, device=dev),
                                hit & ~lane_dead
                                & (term_weight != 0.0).any(dim=-1)))

    mid = dict(hit=hit, lane_dead=lane_dead, local=local,
               throughput=throughput, ray_dir_ws=ray_dir_ws,
               pick_diffuse=pick_diffuse, roughness=roughness, pos=pos,
               sun_light=sun_light, spot_contribs=tuple(spot_contribs))
    return state, tuple(shadow_reqs), mid


def _apply_vertex(settings: AppSettings, sky_cube, depth: int, flags, state,
                  mid, vis_list):
    """Fold the visibility results into the radiance sums and advance (or
    terminate) the path state (RayTrace.hlsl:379-438)."""
    s = settings
    furnace = flags["furnace"]
    f32 = torch.float32
    n = state["ray_o"].shape[0]
    dev = state["ray_o"].device
    local = mid["local"]
    hit = mid["hit"]
    lane_dead = mid["lane_dead"]
    total = state["total"]
    beta = state["beta"]

    ri = 0
    if mid["sun_light"] is not None:
        local = local + mid["sun_light"] * vis_list[ri][..., None]
        ri += 1
    for light, relevant in mid["spot_contribs"]:
        local = local + torch.where(relevant[..., None],
                                    light * vis_list[ri][..., None], 0.0)
        ri += 1

    if depth == 1 and not s.enable_direct:
        local = torch.zeros_like(local)

    if flags["continue_paths"]:
        total = total + torch.where(hit[..., None] & ~lane_dead[..., None],
                                    beta * local, 0.0)
        # Once the path weight is zero in every channel all later vertices
        # add exactly 0: the lane stops.
        beta_next = beta * mid["throughput"]
        return dict(
            total=total,
            beta=beta_next,
            active=hit & ~lane_dead & (beta_next != 0.0).any(dim=-1),
            prev_is_diffuse=mid["pick_diffuse"],
            prev_roughness=mid["roughness"],
            ray_o=mid["pos"],
            ray_d=mid["ray_dir_ws"],
            t_min=torch.full((n,), 1e-5, dtype=f32, device=dev),
            t_max=torch.full((n,), FP32Max, dtype=f32, device=dev),
        )
    # Terminal vertex (RayTrace.hlsl:411-438)
    if furnace:
        local = mid["throughput"]
    else:
        vis = vis_list[ri]
        sky_r = (_sky_radiance(sky_cube, s, mid["ray_dir_ws"])
                 if s.enable_sky else torch.zeros((n, 3), dtype=f32, device=dev))
        local = local + vis[..., None] * sky_r * mid["throughput"]
    total = total + torch.where(hit[..., None] & ~lane_dead[..., None],
                                beta * local, 0.0)
    return dict(state, total=total, active=torch.zeros_like(state["active"]))


def trace_paths(scene, bvh, ray_bvh, sky_cube, settings: AppSettings,
                frame: FrameConstants, ray_o, ray_d, t_max, pixel_idx,
                total_num_pixels: int, first_set_idx: int = 1,
                initial_is_diffuse: bool = False, t_min0=0.0, active0=None,
                sample_idx=None, sun_grid=None, proxy=None, cut=None,
                packet_coherent: bool = False, history=None, raster=None,
                alpha_bvh=None):
    """Trace a wavefront of depth-1 rays to completion; returns (N, 3)
    radiance clamped to [0, FP16Max], and with a `history` (radiance, the
    new history).

    `bvh` (W8) answers depth-1 per-ray closest hits and depth-1 per-ray sun
    and spot visibility, and every packet walk; `ray_bvh` (W32) every other
    per-ray traversal. Rays at depths <= max_any_hit_path_length are
    alpha-tested on alpha-tested scenes (the terminal ray one depth later).
    `sun_grid` (SunGrid for the frame's sun), `proxy` (DenseProxy) and
    `cut` (AABBCut) are the engines' structures, each used where its
    settings field is on; packet_coherent=True says that consecutive
    128-lane groups are coherent (render_sample's tile order). The routes
    are the module docstring's. `first_set_idx` is the CMJ sample set of
    the first PathTrace vertex (raygen consumed set 0). The baker passes
    initial_is_diffuse=True, t_min0=1e-4, its coverage as `active0` and its
    own sample counter as `sample_idx` (BakeRayGen, Baking.hlsl:395-409);
    otherwise the CMJ index is the frame's.

    `raster` (swraster.RasterBins of these lanes in packet-tile order)
    answers the depth-1 closest hits; `history` ({"prim_tri", "sun_tri":
    (N,) i32 in these lanes' order, "tri_table": (T, 9)}) seeds the
    depth-1 closest hits and packet sun rays. Both are ignored where the
    module docstring's conditions do not hold; a history passed in comes
    back updated (only where it was used) all the same. `alpha_bvh` (the
    alpha-only table, bvh.build_alpha_bvh_for_scene) serves the split
    alpha route under DXRPT_SPLIT_ALPHA."""
    s = settings
    n = ray_o.shape[0]
    cmj_sample_idx = frame.curr_sample_idx if sample_idx is None else sample_idx
    alpha = _make_alpha_test(scene, s)
    sun_grid = sun_grid if s.enable_sunspace_shadows else None
    proxy = proxy if s.enable_dense_proxy else None
    cut = cut if s.enable_clear_cut else None
    use_packet = (packet_coherent and bool(s.enable_packet_traversal)
                  and n % PACKET == 0)
    use_history = history is not None and alpha is None
    new_history = None if history is None else dict(history)
    proxy_seed = (proxy is not None
                  and os.environ.get("DXRPT_PROXY_SEED", "0") != "0")
    split = _split_alpha_tables(bvh, alpha_bvh)
    if split is not None:
        kcand_fn = (lambda *r, t=split[0], k=split[1]:
                    packet_closest_hit_alpha(t, *r, k_cands=k))
    state = _path_state0(ray_o, ray_d, t_max, t_min0, active0,
                         initial_is_diffuse)
    for depth, flags in _depth_schedule(s):
        a = alpha if flags["use_any_hit"] else None
        table = bvh if depth == 1 else ray_bvh
        args = (state["ray_o"], state["ray_d"], state["t_min"],
                state["t_max"])
        with span("trace"):
            if (raster is not None and depth == 1 and use_packet and a is None
                    and not use_history and not raster.opaque_only):
                rec = raster_closest_hit(raster, *args, state["active"])
            elif (a is not None and split is not None and use_packet
                  and depth == 1):
                # masked bins hold only opaque triangles: they are the
                # opaque-only step (as JAX's, only without the history, which
                # an alpha scene turns off)
                if (raster is not None and raster.opaque_only
                        and not use_history):
                    opq = lambda *r: raster_closest_hit(raster, *r)  # noqa: E731
                else:
                    opq = lambda *r: packet_closest_hit(  # noqa: E731
                        bvh, *r, exclude_alpha=True)
                rec = _split_alpha_closest(opq, kcand_fn, a, *args,
                                           state["active"])
            elif a is None and use_history and depth == 1:
                base = (
                    (lambda *r: packet_closest_hit(bvh, *r)) if use_packet
                    else (lambda *r: closest_hit(bvh, *r)))
                rec, new_history["prim_tri"] = history_lib.seeded_closest(
                    base, history["tri_table"], history["prim_tri"], *args,
                    state["active"])
            elif a is None and use_packet and depth == 1:
                rec = packet_closest_hit(bvh, *args, state["active"])
            elif a is None and proxy_seed:
                rec = proxy_lib.seeded_closest(
                    lambda *r, table=table: closest_hit(table, *r), proxy,
                    *args, state["active"])
            else:
                act = state["active"]
                if cut is not None and a is None:
                    # a lane the cut clears is a miss: inactive, it keeps the
                    # miss record (t = t_max, tri_id = -1)
                    act = act & ~cut_clear(cut, *args, act)
                rec = closest_hit(table, *args, act, alpha=a)
        with span("shade"):
            state, reqs, mid = _shade_vertex(
                scene, sky_cube, s, frame, depth, flags, state, rec,
                pixel_idx, total_num_pixels, first_set_idx, cmj_sample_idx)
        if flags["early_stop"]:
            break
        plan = _shadow_plan(scene, s, alpha is not None, flags)
        packet_depth = use_packet and (depth == 1
                                       or s.packet_shadows_all_depths)
        vis_list = [None] * len(reqs)
        with span("visibility"):
            for kind, table, r, a, positions in _shadow_calls(
                    bvh, ray_bvh, alpha, depth, plan, reqs):
                packet_kind = packet_depth and (
                    kind == "sun"
                    or (kind == "terminal" and s.packet_shadows_all_depths))
                if (a is None and kind == "sun" and sun_grid is not None
                        and not (depth == 1 and use_packet)):
                    vis = sun_any_hit(sun_grid, *r)
                elif (packet_kind and a is None and use_history and depth == 1
                      and kind == "sun"):
                    vis, new_history["sun_tri"] = history_lib.seeded_any(
                        lambda *q: packet_any_hit_rec(bvh, *q),
                        history["tri_table"], history["sun_tri"], *r)
                elif packet_kind and a is None:
                    vis = packet_any_hit(bvh, *r)
                elif packet_kind and split is not None:
                    vis = _split_alpha_visibility(
                        lambda *q: packet_any_hit_rec(bvh, *q,
                                                      exclude_alpha=True),
                        kcand_fn, a, *r)
                elif packet_kind:
                    # the JAX package's packet punch-through: here the per-ray
                    # walk with the alpha test, unscreened
                    vis = any_hit(table, *r, alpha=a)
                else:
                    vis = screened_any(
                        lambda o, d, tn, tx, m, table=table, a=a: any_hit(
                            table, o, d, tn, tx, m, alpha=a),
                        *r, proxy=proxy if a is None else None, cut=cut)
                for j, i in enumerate(positions):
                    vis_list[i] = vis[j * n:(j + 1) * n]
        with span("vertex_update"):
            state = _apply_vertex(s, sky_cube, depth, flags, state, mid,
                                  vis_list)
    radiance = torch.clamp(state["total"], 0.0, FP16Max)
    return radiance if history is None else (radiance, new_history)


def raygen(settings: AppSettings, frame: FrameConstants, width: int,
           height: int, device, row_offset: int = 0, total_height=None):
    """RaygenShader's primary-ray setup (RayTrace.hlsl:92-127): CMJ pixel
    jitter (set 0) + InvViewProjection un-projection with y-flip. Returns
    (ray_start, ray_dir, ray_len, pixel_idx) flat over height*width rays in
    row-major order; pixel_idx = (y + row_offset) * width + x as int64
    (uint32 values). For a row shard (parallel/mesh.py) `height` is its row
    count, `row_offset` its first row and `total_height` the frame's: the
    pixel indices and the NDC stay the frame's."""
    s = settings
    f32 = torch.float32
    th = height if total_height is None else int(total_height)
    row_offset = int(row_offset)
    yy, xx = torch.meshgrid(
        torch.arange(row_offset, row_offset + height, dtype=f32,
                     device=device),
        torch.arange(width, dtype=f32, device=device), indexing="ij")
    pixel_idx = torch.arange(row_offset * width, (row_offset + height) * width,
                             dtype=torch.int64, device=device)

    # set 0: pixel jitter
    jitter = cmj.sample_cmj_2d(frame.curr_sample_idx, int(s.sqrt_num_samples),
                               int(s.sqrt_num_samples), pixel_idx)
    px = xx.reshape(-1) + jitter[..., 0]
    py = yy.reshape(-1) + jitter[..., 1]

    ncd_x = div(px, width * 0.5) - 1.0
    ncd_y = -(div(py, th * 0.5) - 1.0)

    ivp = frame.inv_view_projection

    def unproject(z):
        # Written as multiply-adds, not a matmul: a reduced-precision product
        # cancels the tiny far-plane w (~0.01 from differences of ~100) to 0.
        out = (ncd_x[..., None] * ivp[0] + ncd_y[..., None] * ivp[1]
               + z * ivp[2] + ivp[3])
        return out[..., :3] / out[..., 3:4]

    ray_start = unproject(0.0)
    ray_end = unproject(1.0)
    seg = ray_end - ray_start
    ray_len = sqrt(torch.clamp_min(dot(seg, seg), 1e-30))
    ray_dir = seg / ray_len[..., None]
    return ray_start, ray_dir, ray_len, pixel_idx


def _packet_tile_dims(height: int, width: int):
    """A 128-pixel tile (ty, tx) that divides the image, square-ish first
    (the best packet coherence), or None."""
    for ty in (8, 16, 4, 32, 2, 64, 1, 128):
        tx = PACKET // ty
        if height % ty == 0 and width % tx == 0:
            return ty, tx
    return None


def _tile_order(x, height: int, width: int, ty: int, tx: int):
    """Row-major (H*W, ...) lanes -> packet-tiled order: each 128
    consecutive lanes are one ty x tx pixel tile."""
    trail = x.shape[1:]
    x = x.reshape(height // ty, ty, width // tx, tx, *trail)
    return x.transpose(1, 2).reshape(height * width, *trail)


def _untile_order(x, height: int, width: int, ty: int, tx: int):
    """The inverse of _tile_order."""
    trail = x.shape[1:]
    x = x.reshape(height // ty, width // tx, ty, tx, *trail)
    return x.transpose(1, 2).reshape(height * width, *trail)


def render_sample(scene, bvh, ray_bvh, sky_cube, settings: AppSettings,
                  frame: FrameConstants, width: int, height: int, accum,
                  sun_grid=None, proxy=None, cut=None, history=None,
                  raster=None, alpha_bvh=None, row_offset: int = 0,
                  total_height=None, accum_sample_idx=None):
    """One progressive sample over the whole frame: raygen + trace + running
    mean (RaygenShader, RayTrace.hlsl:92-149). Returns the new accumulation
    (height, width, 3) f32, and with a `history` (accumulation, the new
    history). With enable_packet_traversal on and a 128-pixel tile dividing
    the image, the lanes are traced in tile order (each ray with its pixel
    index, so the CMJ samples are the row-major frame's) and the radiance
    is put back in row-major order; `sun_grid`, `proxy`, `cut` and
    `history` (in the lanes' order) and `alpha_bvh` go to trace_paths, and
    `raster` where its tiles are the lanes' tiles.

    Row sharding (parallel/mesh.py): `height` is the shard's row count,
    `row_offset` its first row and `total_height` the frame's, so pixel
    indices and NDC stay the frame's. Sample sharding: the caller gives
    the shard's global sample index in `frame.curr_sample_idx` (the CMJ
    index) and the samples its running mean holds so far in
    `accum_sample_idx` (the lerp's)."""
    th = height if total_height is None else int(total_height)
    dims = (_packet_tile_dims(height, width)
            if settings.enable_packet_traversal else None)
    with span("raygen"):
        rays = raygen(settings, frame, width, height, accum.device,
                      row_offset, th)
        if dims is not None:
            rays = tuple(_tile_order(x, height, width, *dims) for x in rays)
    if raster is not None and (raster.ty, raster.tx) != dims:
        raster = None
    with span("paths"):
        radiance = trace_paths(scene, bvh, ray_bvh, sky_cube, settings,
                               frame, *rays, width * th, first_set_idx=1,
                               sun_grid=sun_grid, proxy=proxy, cut=cut,
                               packet_coherent=dims is not None,
                               history=history, raster=raster,
                               alpha_bvh=alpha_bvh)
    if history is not None:
        radiance, history = radiance
    with span("accumulate"):
        if dims is not None:
            radiance = _untile_order(radiance, height, width, *dims)
        radiance = radiance.reshape(height, width, 3)
        idx = np.float32(frame.curr_sample_idx if accum_sample_idx is None
                         else accum_sample_idx)
        # f32, as the reference
        lerp_factor = float(idx / (idx + np.float32(1.0)))
        accum = radiance + (accum - radiance) * lerp_factor
    return accum if history is None else (accum, history)
