"""Port parity: raster mode of dxrpathtracer_tpu_torch against dxrpathtracer_tpu.

The JAX package builds each case's scene, W32 table, sky and camera and
renders its raster frame in a subprocess whose XLA:CPU emits no FMA (ISA
capped at AVX, as in tests/test_torch_render.py); the same arrays go into the
port's RenderSession (device="cpu"). Held to:

  - sh9 and the SG lobes of one cubemap: byte-equal (both numpy copies);
    SkyCache's within rtol 1e-6 (its cubemap is, tests/test_torch_host.py);
  - froxel spheres, cascades and spot shadow set-ups: byte-equal (host
    numpy in both packages); cluster masks equal as integers (the port's
    int64 against JAX's uint32), 32 lights included;
  - the hit fetches (one packed row through the row gather) against JAX's
    _fetch_vertex_attrs + _sample_material: rtol 1e-6, atol 1e-6;
  - cascade and spot depth maps: bit-equal (the same rays, made on the host
    in float64, and the plain walk with the alpha test);
  - PCF visibility equal; EVSM within atol 1e-5 and MSM within atol 1e-3 on
    seeded inputs, against JAX in this process (float64-rounded exp and sqrt
    against XLA's; the MSM solve divides by the Hankel determinants, ~1e-6
    on near-planar depth, which magnify a last-bit difference of the decoded
    moments: 4e-4 at most here);
  - forward_render within rel-RMSE 1e-5 (scaled by max|ref|) of JAX's at
    32x32: BoxTest with MSAANone and MSAA4x, the spot-lit BoxTest of
    tests/test_raster.py in the four shadow modes, the tiny alpha scene
    with two spots (rays, pcf) and the lightmap-lit frame;
  - uvviz byte-equal for both atlases; the `render --raster --device cpu`
    PNG within one 8-bit step of the JAX command's (each package computes
    its own sky, equal within rtol 1e-6);
  - the WhiteFurnace and SunTemple stand-ins and their tables byte-equal
    when the JAX package loaded its stand-in (skipped otherwise);
  - the profiler's statistics on the CPU.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from dxrpathtracer_tpu.render import clusters as jclusters  # noqa: E402
from dxrpathtracer_tpu.render import shadows as jshadows  # noqa: E402
from dxrpathtracer_tpu.render.camera import FirstPersonCamera as JCamera  # noqa: E402
from dxrpathtracer_tpu.scene.types import make_spot_lights as jmake_lights  # noqa: E402
from dxrpathtracer_tpu_torch.app import cli  # noqa: E402
from dxrpathtracer_tpu_torch.app.profiler import Profiler  # noqa: E402
from dxrpathtracer_tpu_torch.app.session import RenderSession  # noqa: E402
from dxrpathtracer_tpu_torch.app.settings import (SPOT_SHADOW_NEAR_CLIP,  # noqa: E402
                                                  AppSettings, MSAAModes,
                                                  Scenes)
from dxrpathtracer_tpu_torch.convert import (  # noqa: E402
    bvh_from_numpy, reference_scene_arrays, scene_from_reference_arrays)
from dxrpathtracer_tpu_torch.render import clusters, shadows  # noqa: E402
from dxrpathtracer_tpu_torch.render.camera import FirstPersonCamera  # noqa: E402
from dxrpathtracer_tpu_torch.render.integrator import (  # noqa: E402
    _fetch_shade_inputs, _make_alpha_test, _sample_packed)
from dxrpathtracer_tpu_torch.scene.registry import PRESETS  # noqa: E402
from dxrpathtracer_tpu_torch.scene.types import make_spot_lights  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SM = 64  # cascade map size (the spot maps are twice it)
W = H = 32

# the spot light of tests/test_raster.py::test_spot_pcf_matches_exact_rays
SPOT = dict(positions=[(1.5, 6.0, -1.5)], directions=[(0.0, -1.0, 0.0)],
            intensities=[(4000.0, 3800.0, 3500.0)],
            angular_attenuation=[(float(np.cos(np.deg2rad(20.0))),
                                  float(np.cos(np.deg2rad(32.0))))],
            light_range=12.0)
# two lights over the tiny alpha scene's cards (tests/test_torch_lights.py)
TINY = dict(positions=[[-1.0, 3.0, 0.5], [1.5, 2.5, -0.5]],
            directions=[[0.0, 1.0, 0.0], [0.3, 0.95, 0.0]],
            intensities=[[40.0, 35.0, 30.0], [10.0, 20.0, 30.0]],
            angular_attenuation=[[0.5, 1.1], [0.8, 1.4]])
LIGHTS = {"spot": SPOT, "tiny": TINY}

CASES = {  # key: (scene, lights, settings, shadow modes)
    "box1": ("box", None, dict(msaa_mode=int(MSAAModes.MSAANone)), ["rays"]),
    "box4": ("box", None, dict(msaa_mode=int(MSAAModes.MSAA4x)), ["rays"]),
    "spot": ("box", "spot", dict(msaa_mode=int(MSAAModes.MSAANone)),
             ["rays", "pcf", "evsm", "msm"]),
    "tiny": ("tiny", "tiny", dict(msaa_mode=int(MSAAModes.MSAA4x)),
             ["rays", "pcf"]),
    "lightmap": ("box", None, dict(msaa_mode=int(MSAAModes.MSAA4x),
                                   enable_light_map_render=True), ["rays"]),
}
_FRAMES = [(k, m) for k, c in CASES.items() for m in c[3]]
_SHADOWED = [k for k, c in CASES.items() if "pcf" in c[3]]

_SCRIPT = r"""
import dataclasses
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from dxrpathtracer_tpu.app import cli as jcli
from dxrpathtracer_tpu.app.session import RenderSession
from dxrpathtracer_tpu.app.settings import (SPOT_SHADOW_NEAR_CLIP,
                                            AppSettings, MSAAModes, Scenes)
from dxrpathtracer_tpu.render import clusters, shadows
from dxrpathtracer_tpu.render.integrator import (_fetch_vertex_attrs,
                                                 _make_alpha_test,
                                                 _sample_material)
from dxrpathtracer_tpu.scene import registry as jreg
from dxrpathtracer_tpu.scene.build import build_scene
from dxrpathtracer_tpu.scene.procedural import box_test_meshes
from dxrpathtracer_tpu.scene.types import make_spot_lights
from dxrpathtracer_tpu_torch.convert import reference_scene_arrays

cases, lights, sm, w, h = %r, %r, %r, %r, %r
inp = dict(np.load(sys.argv[1]))
out = {}
for key, (scene_kind, light_key, kw, modes) in cases.items():
    lt = make_spot_lights(**lights[light_key]) if light_key else None
    if scene_kind == "box":
        scene = build_scene(box_test_meshes(), lights=lt)
        preset = jreg.PRESETS[Scenes.BoxTest]
    else:
        scene, preset = jreg.tiny_alpha_scene()
        scene = dataclasses.replace(scene, lights=lt)
    kw = dict(kw, msaa_mode=MSAAModes(kw["msaa_mode"]))
    settings = AppSettings(current_scene=preset.scene_enum,
                           enable_sunspace_shadows=False,
                           enable_dense_proxy=False, enable_clear_cut=False,
                           enable_sw_raster=False, **kw)
    sess = RenderSession(settings=settings, width=w, height=h, scene=scene,
                         preset=preset)
    for k, v in reference_scene_arrays(scene).items():
        out[key + "__scene__" + k] = v
    b = sess.bvh_ray
    out[key + "__w32__table"] = np.asarray(b.table)
    out[key + "__w32__const"] = np.asarray(
        [b.num_rows, b.max_depth, b.root_code, b.width, b.has_alpha_flags])
    sky = sess.sky
    for k in ("cubemap", "sh9", "sun_irradiance", "sun_render_color"):
        out[key + "__sky__" + k] = np.asarray(getattr(sky, k))
    cam = sess.camera
    out[key + "__vp"] = cam.view_projection()
    spheres, dims = clusters.froxel_bounding_spheres(w, h, cam)
    out[key + "__spheres"] = spheres
    out[key + "__dims"] = np.asarray(dims)
    out[key + "__masks"] = np.asarray(clusters.build_cluster_masks(
        jax.device_put(sess.scene.lights), spheres,
        mode=sess.settings.cluster_rasterization_mode))
    accept = _make_alpha_test(sess.scene, sess.settings)
    if "pcf" in modes:
        sun = np.asarray(sess.settings.sun_direction, np.float32)
        casc = shadows.prepare_cascades(cam, sun / np.linalg.norm(sun),
                                        map_size=sm)
        for f in ("split_depth", "view_proj", "center", "radius"):
            out[key + "__casc__" + f] = np.stack(
                [np.asarray(getattr(c, f)) for c in casc])
        out[key + "__depth"] = np.asarray(shadows.render_cascade_depth_maps(
            sess.bvh_ray, casc, sm, accept_fn=accept))
        spots = shadows.prepare_spot_shadows(sess.scene_host.lights,
                                             SPOT_SHADOW_NEAR_CLIP)
        for f in ("view_proj", "position", "forward", "near", "far"):
            out[key + "__spots__" + f] = np.stack(
                [np.asarray(getattr(sp, f)) for sp in spots])
        out[key + "__spotmaps"] = np.asarray(shadows.render_spot_depth_maps(
            sess.bvh_ray, spots, min(sm * 2, 1024), accept_fn=accept))
    lm = lm_uv = None
    if sess.settings.enable_light_map_render:
        lm, lm_uv = inp["lightmap"], inp["lightmap_uvs"]
    for mode in modes:
        out[key + "__img__" + mode] = np.asarray(sess.render_raster_frame(
            shadow_mode=mode, shadow_map_size=sm, lightmap=lm,
            lightmap_uvs=lm_uv))
    # the hit fetches of seeded (tri, u, v)
    tri, u, v = inp[key + "__tri"], inp[key + "__u"], inp[key + "__v"]
    pos, nrm, uv, tan, bit = _fetch_vertex_attrs(
        sess.scene, jnp.asarray(tri), jnp.asarray(u), jnp.asarray(v))
    mat = jnp.take(sess.scene.tri_material, jnp.maximum(jnp.asarray(tri), 0))
    for name, a in (("pos", pos), ("nrm", nrm), ("uv", uv), ("tan", tan),
                    ("bit", bit)):
        out[key + "__fetch__" + name] = np.asarray(a)
    for slot in ("albedo", "normal", "roughness", "metallic", "emissive"):
        out[key + "__fetch__" + slot] = np.asarray(
            _sample_material(sess.scene, mat, uv, slot))
jcli.main(["render", "--raster", "--current-scene", "BoxTest", "--width",
           str(w), "--height", str(h), "--output", sys.argv[2] + ".png"])
with open(sys.argv[2] + ".png", "rb") as f:
    out["cli_png"] = np.frombuffer(f.read(), np.uint8)
np.savez(sys.argv[2], **out)
""" % (CASES, LIGHTS, SM, W, H)


def _inputs():
    """Seeded hits for the fetch test and the lightmap case's inputs."""
    rng = np.random.default_rng(5)
    inputs = {"lightmap": rng.uniform(0.0, 4.0, (16, 16, 3)).astype(np.float32),
              "lightmap_uvs": rng.uniform(0.0, 1.0, (64, 3, 2)).astype(
                  np.float32)}
    for key in CASES:
        u = rng.uniform(0.0, 1.0, 512).astype(np.float32)
        v = (rng.uniform(0.0, 1.0, 512) * (1.0 - u)).astype(np.float32)
        inputs[key + "__u"], inputs[key + "__v"] = u, v
        inputs[key + "__tri"] = rng.integers(-1, 6, 512).astype(np.int32)
    return inputs


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("raster")
    src, dst = tmp / "in.npz", tmp / "out.npz"
    inputs = _inputs()
    np.savez(src, **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    env.pop("DXRPT_PALLAS_BODY", None)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, str(src), str(dst)],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(dst), **inputs)


def _camera(key):
    """The port's camera at the case's preset, as RenderSession poses it."""
    preset = PRESETS[Scenes.BoxTest if CASES[key][0] == "box"
                     else Scenes.Sponza]
    cam = FirstPersonCamera(aspect=W / H)
    cam.set_position(preset.camera_position)
    cam.set_x_rotation(preset.camera_rotation[0])
    cam.set_y_rotation(preset.camera_rotation[1])
    return cam, preset


def _port_case(ref, key):
    """The port's session on the case's reference arrays: the scene, the
    W32 table and the sky are JAX's."""
    scene_kind, _, kw, _ = CASES[key]
    pre = key + "__scene__"
    scene = scene_from_reference_arrays(
        {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)})
    _, preset = _camera(key)
    settings = AppSettings(current_scene=preset.scene_enum,
                           **dict(kw, msaa_mode=MSAAModes(kw["msaa_mode"])))
    sess = RenderSession(settings=settings, width=W, height=H, device="cpu",
                         scene=scene, preset=preset)
    rows, depth, root, width, flags = (int(v)
                                       for v in ref[key + "__w32__const"])
    sess.bvh_ray = bvh_from_numpy(ref[key + "__w32__table"], rows, depth,
                                  root, width, bool(flags))
    for k in ("cubemap", "sh9", "sun_irradiance", "sun_render_color"):
        setattr(sess.sky, k, ref[f"{key}__sky__{k}"])
    sess.sky_cube = torch.from_numpy(ref[key + "__sky__cubemap"])
    return sess


@pytest.fixture(scope="module")
def sessions(reference):
    return {}


def _session(sessions, reference, key):
    if key not in sessions:
        sessions[key] = _port_case(reference, key)
    return sessions[key]


def test_sh9_and_sg_lobes_match_jax():
    from dxrpathtracer_tpu.sky.sg import solve_sg_from_cubemap as jsg
    from dxrpathtracer_tpu.sky.sh import project_cubemap_sh9 as jsh9
    from dxrpathtracer_tpu.sky.skycache import SkyCache as JSkyCache
    from dxrpathtracer_tpu_torch.sky.sg import solve_sg_from_cubemap
    from dxrpathtracer_tpu_torch.sky.sh import project_cubemap_sh9
    from dxrpathtracer_tpu_torch.sky.skycache import SkyCache
    args = (np.float32([0.26, 0.987, -0.16]), 0.27,
            np.float32([0.25, 0.25, 0.25]), 2.0)
    jsky, sky = JSkyCache(), SkyCache()
    jsky.update(*args)
    sky.update(*args)
    cube = jsky.cubemap
    assert project_cubemap_sh9(cube).tobytes() == jsh9(cube).tobytes()
    got, want = solve_sg_from_cubemap(cube), jsg(cube)
    for f in ("axes", "sharpness", "amplitudes"):
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    np.testing.assert_allclose(sky.sh9, jsky.sh9, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(sky.sg_lobes.amplitudes),
                               np.asarray(jsky.sg_lobes.amplitudes),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("key", ["box1", "spot", "tiny"])
def test_froxels_cascades_and_spots_byte_equal(reference, key):
    cam, _ = _camera(key)
    assert cam.view_projection().tobytes() == reference[key + "__vp"].tobytes()
    spheres, dims = clusters.froxel_bounding_spheres(W, H, cam)
    assert spheres.tobytes() == reference[key + "__spheres"].tobytes()
    assert list(dims) == reference[key + "__dims"].tolist()
    if key not in _SHADOWED:
        return
    sun = np.asarray(_port_case(reference, key).settings.sun_direction,
                     np.float32)
    casc = shadows.prepare_cascades(cam, sun / np.linalg.norm(sun),
                                    map_size=SM)
    for f in ("split_depth", "view_proj", "center", "radius"):
        got = np.stack([np.asarray(getattr(c, f)) for c in casc])
        assert got.tobytes() == reference[key + "__casc__" + f].tobytes(), f
    lights = make_spot_lights(**LIGHTS[CASES[key][1]])
    spots = shadows.prepare_spot_shadows(lights, SPOT_SHADOW_NEAR_CLIP)
    for f in ("view_proj", "position", "forward", "near", "far"):
        got = np.stack([np.asarray(getattr(sp, f)) for sp in spots])
        assert got.tobytes() == reference[key + "__spots__" + f].tobytes(), f


@pytest.mark.parametrize("key", ["box1", "spot", "tiny"])
def test_cluster_masks_equal(reference, key):
    sess = _port_case(reference, key)
    masks = clusters.build_cluster_masks(
        sess.scene.lights, reference[key + "__spheres"],
        mode=sess.settings.cluster_rasterization_mode)
    want = reference[key + "__masks"]
    assert masks.dtype == torch.int64 and want.dtype == np.uint32
    np.testing.assert_array_equal(masks.numpy(), want.astype(np.int64))
    if sess.scene.num_lights:
        assert (want != 0).any()


@pytest.mark.parametrize("mode", [0, 1, 3])
def test_cluster_masks_32_lights_equal(mode):
    """32 seeded spots around the BoxTest camera's frustum: bit 31 in use."""
    rng = np.random.default_rng(32 + mode)
    kw = dict(positions=rng.uniform((-8, 0, -8), (8, 8, 8), (32, 3)),
              directions=rng.standard_normal((32, 3)),
              intensities=rng.uniform(1, 50, (32, 3)),
              angular_attenuation=np.stack(
                  [rng.uniform(0.7, 0.95, 32), rng.uniform(0.2, 0.6, 32)], 1),
              light_range=rng.uniform(4.0, 20.0))
    kw["directions"] /= np.linalg.norm(kw["directions"], axis=1,
                                       keepdims=True)
    cam = JCamera(aspect=96 / 64)
    preset = PRESETS[Scenes.BoxTest]
    cam.set_position(preset.camera_position)
    cam.set_x_rotation(preset.camera_rotation[0])
    cam.set_y_rotation(preset.camera_rotation[1])
    spheres, _ = jclusters.froxel_bounding_spheres(96, 64, cam)
    want = np.asarray(jclusters.build_cluster_masks(
        jax.device_put(jmake_lights(**kw)), spheres, mode=mode))
    got = clusters.build_cluster_masks(make_spot_lights(**kw), spheres,
                                       mode=mode).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert (want >> 31).any() and len(np.unique(want)) > 8


@pytest.mark.parametrize("key", ["box1", "tiny"])
def test_hit_fetch_matches_jax(reference, key):
    """One packed row through the row gather + the packed-meta taps equal
    JAX's vertex gathers + per-slot material taps."""
    sess = _port_case(reference, key)
    tri, u, v = (torch.from_numpy(reference[f"{key}__{k}"])
                 for k in ("tri", "u", "v"))
    pos, nrm, uv, tan, bit, _mat, packed = _fetch_shade_inputs(
        sess.scene, tri, u, v)
    got = dict(pos=pos, nrm=nrm, uv=uv, tan=tan, bit=bit)
    for slot in ("albedo", "normal", "roughness", "metallic", "emissive"):
        got[slot] = _sample_packed(sess.scene, packed, uv, slot)
    for name, g in got.items():
        want = reference[f"{key}__fetch__{name}"]
        g = g.numpy()[..., :want.shape[-1]]
        np.testing.assert_allclose(g, want, rtol=1e-6, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("key", _SHADOWED)
def test_depth_maps_bit_equal(reference, key):
    sess = _port_case(reference, key)
    alpha = _make_alpha_test(sess.scene, sess.settings)
    assert (alpha is not None) == (key == "tiny")
    cam, _ = _camera(key)
    sun = np.asarray(sess.settings.sun_direction, np.float32)
    casc = shadows.prepare_cascades(cam, sun / np.linalg.norm(sun),
                                    map_size=SM)
    depth = shadows.render_cascade_depth_maps(sess.bvh_ray, casc, SM,
                                              alpha=alpha).numpy()
    want = reference[key + "__depth"]
    assert depth.shape == want.shape == (4, SM, SM)
    np.testing.assert_array_equal(depth.view(np.int32), want.view(np.int32))
    assert (want < 1.0).any() and (want == 1.0).any()
    spots = shadows.prepare_spot_shadows(sess.scene.lights,
                                         SPOT_SHADOW_NEAR_CLIP)
    maps = shadows.render_spot_depth_maps(sess.bvh_ray, spots, 2 * SM,
                                          alpha=alpha).numpy()
    want = reference[key + "__spotmaps"]
    assert maps.shape == want.shape == (len(spots), 2 * SM, 2 * SM)
    np.testing.assert_array_equal(maps.view(np.int32), want.view(np.int32))
    # the spot of tests/test_raster.py looks down at the box (the tiny
    # scene's two look up, as their shadow cameras take the stored direction)
    assert (want < 1.0).any() == (key == "spot")


def _filter_inputs(n=4096, seed=9):
    """BoxTest cascades and spots, smooth seeded depth maps, and seeded
    surface points inside the cascades' reach."""
    rng = np.random.default_rng(seed)
    cam = JCamera(aspect=1.0)
    preset = PRESETS[Scenes.BoxTest]
    cam.set_position(preset.camera_position)
    cam.set_x_rotation(preset.camera_rotation[0])
    cam.set_y_rotation(preset.camera_rotation[1])
    sun = np.float32([0.26, 0.987, -0.16])
    casc = jshadows.prepare_cascades(cam, sun / np.linalg.norm(sun),
                                     map_size=SM)
    yy, xx = np.meshgrid(np.linspace(0, 6, SM), np.linspace(0, 6, SM),
                         indexing="ij")
    maps = np.stack([0.45 + 0.2 * np.sin(xx * (c + 1)) * np.cos(yy)
                     + 0.02 * rng.standard_normal((SM, SM))
                     for c in range(4)]).astype(np.float32)
    maps[:, :4] = 1.0  # a band with nothing hit
    centers = np.stack([c.center for c in casc])
    pick = rng.integers(0, 4, n)
    radius = np.float32([c.radius for c in casc])[pick, None]
    pos = (centers[pick] + rng.uniform(-0.6, 0.6, (n, 3)) * radius).astype(
        np.float32)
    nrm = rng.standard_normal((n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    ndl = rng.uniform(-0.2, 1.0, n).astype(np.float32)
    dvs = rng.uniform(0.0, 1.0, n).astype(np.float32)
    return casc, maps, pos, nrm, ndl, dvs


@pytest.mark.parametrize("mode", ["pcf", "evsm", "msm", "spot"])
def test_shadow_filters_match_jax(mode):
    casc, maps, pos, nrm, ndl, dvs = _filter_inputs()
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    j = jnp.asarray
    if mode == "pcf":
        want = jshadows.sun_visibility_pcf(j(maps), casc, j(pos), j(nrm),
                                           j(ndl), j(dvs))
        got = shadows.sun_visibility_pcf(t(maps), casc, t(pos), t(nrm),
                                         t(ndl), t(dvs))
        atol = 0.0
    elif mode == "spot":
        lights = dict(SPOT, positions=[(1.5, 6.0, -1.5), (-2.0, 5.0, 1.0)],
                      directions=[(0.0, -1.0, 0.0), (0.3, -0.9, 0.1)],
                      intensities=[(1.0, 1.0, 1.0)] * 2,
                      angular_attenuation=[SPOT["angular_attenuation"][0]] * 2)
        jspots = jshadows.prepare_spot_shadows(jmake_lights(**lights),
                                               SPOT_SHADOW_NEAR_CLIP)
        spots = shadows.prepare_spot_shadows(make_spot_lights(**lights),
                                             SPOT_SHADOW_NEAR_CLIP)
        smaps = maps[:2]
        want = np.concatenate([np.asarray(jshadows.spot_visibility_pcf(
            j(smaps), jspots, li, j(pos), j(nrm), j(ndl))) for li in (0, 1)])
        got = torch.cat([shadows.spot_visibility_pcf(
            t(smaps), spots, li, t(pos), t(nrm), t(ndl)) for li in (0, 1)])
        atol = 0.0
    else:
        jm = jshadows.filter_moment_maps(jshadows.convert_depth_maps(
            j(maps), mode))
        m = shadows.filter_moment_maps(shadows.convert_depth_maps(
            t(maps), mode))
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-5,
                                   atol=1e-5)
        want = jshadows.sun_visibility_moments(jm, casc, j(pos), j(nrm),
                                               j(ndl), j(dvs), mode)
        got = shadows.sun_visibility_moments(t(np.array(jm)), casc, t(pos),
                                             t(nrm), t(ndl), t(dvs), mode)
        atol = 1e-5 if mode == "evsm" else 1e-3
    want = np.asarray(want)
    assert ((want > 0.01) & (want < 0.99)).any() and (want < 0.01).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=0.0, atol=atol)


@pytest.mark.parametrize("key,mode", _FRAMES)
def test_forward_render_matches_jax(reference, sessions, key, mode):
    sess = _session(sessions, reference, key)
    lm = lm_uv = None
    if sess.settings.enable_light_map_render:
        lm, lm_uv = reference["lightmap"], reference["lightmap_uvs"]
    img = sess.render_raster_frame(shadow_mode=mode, shadow_map_size=SM,
                                   lightmap=lm, lightmap_uvs=lm_uv).numpy()
    ref = reference[f"{key}__img__{mode}"]
    assert img.shape == ref.shape == (H, W, 3) and np.isfinite(img).all()
    assert img.max() > 0.0
    err = float(np.sqrt(np.mean((img - ref) ** 2)) / (np.abs(ref).max() + 1e-9))
    print(f"{key}/{mode}: raster frame rel RMSE vs JAX {err:.3e}, "
          f"{np.mean(img == ref):.4f} of values bit-equal")
    assert err <= 1e-5
    names = set(sess.profiler.stats())
    assert {"RenderClusters", "RenderForward"} <= names
    if mode != "rays":
        assert "RenderSunShadowMap" in names


def test_shadow_modes_differ_and_lightmap_lights(reference):
    """The four modes render distinct frames; the lightmap-lit frame is
    albedo times the lightmap, so it differs from the shaded one."""
    imgs = [reference["spot__img__" + m] for m in CASES["spot"][3]]
    for a in range(4):
        for b in range(a + 1, 4):
            assert not np.array_equal(imgs[a], imgs[b])
    assert not np.allclose(reference["lightmap__img__rays"],
                           reference["box4__img__rays"])


@pytest.mark.parametrize("atlas", ["charts", "pairs"])
def test_uvviz_byte_equal(atlas, tmp_path):
    from dxrpathtracer_tpu.app import cli as jcli
    png = tmp_path / "port.png"
    cli.main(["uvviz", "--current-scene", "BoxTest", "--resolution", "96",
              "--atlas", atlas, "--output", str(png)])
    jpng = tmp_path / "jax.png"
    jcli.main(["uvviz", "--current-scene", "BoxTest", "--resolution", "96",
               "--atlas", atlas, "--output", str(jpng)])
    got, want = _read_png(png), _read_png(jpng)
    assert got.shape == (96, 96, 3) and got.tobytes() == want.tobytes()
    assert (got > 0).any() and (got == 0).any()


def _read_png(path):
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"))


def test_render_raster_command_png_matches_jax(reference, tmp_path):
    import io

    from PIL import Image
    png = tmp_path / "raster.png"
    cli.main(["render", "--raster", "--current-scene", "BoxTest", "--width",
              str(W), "--height", str(H), "--output", str(png), "--device",
              "cpu"])
    got = _read_png(png)
    want = np.asarray(Image.open(io.BytesIO(
        reference["cli_png"].tobytes())).convert("RGB"))
    assert got.shape == want.shape == (H, W, 3)
    diff = np.abs(got.astype(int) - want.astype(int))
    print(f"render --raster --device cpu vs JAX: max |diff| {diff.max()}, "
          f"{np.mean(diff == 0):.4f} of values equal")
    assert diff.max() <= 1 and np.mean(diff == 0) > 0.99


def test_raster_lightmap_and_trace_commands(tmp_path):
    """bake -> .npz bundle -> render --raster --lightmap, and a pcf render
    with --profile-trace, on the CPU: the PNGs and the HDR frames have the
    frame's size and are finite, the lightmap-lit frame is not the shaded
    one, and the trace holds the frame's ops."""
    import json
    bundle = tmp_path / "lm.npz"
    cli.main(["bake", "--current-scene", "BoxTest", "--resolution", "16",
              "--atlas", "pair", "--samples", "1", "--output", str(bundle),
              "--device", "cpu"])
    with np.load(bundle) as b:
        assert b["lightmap"].shape == (16, 16, 3)
        assert b["tri_uv"].shape == (24, 3, 2)
    size = ["--current-scene", "BoxTest", "--width", "24", "--height", "16",
            "--device", "cpu"]
    cli.main(["render", "--raster", "--lightmap", str(bundle), *size,
              "--output", str(tmp_path / "lm.png"), "--save-hdr",
              str(tmp_path / "lm.npy")])
    trace = tmp_path / "trace"
    cli.main(["render", "--raster", "--shadow-mode", "pcf",
              "--profile-trace", str(trace), *size, "--output",
              str(tmp_path / "pcf.png"), "--save-hdr",
              str(tmp_path / "pcf.npy")])
    lit, pcf = np.load(tmp_path / "lm.npy"), np.load(tmp_path / "pcf.npy")
    for name, img in (("lm", lit), ("pcf", pcf)):
        assert img.shape == (16, 24, 3) and np.isfinite(img).all()
        assert _read_png(tmp_path / f"{name}.png").shape == (16, 24, 3)
    assert not np.allclose(lit, pcf)
    with open(trace / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert any(str(n).startswith("aten::") for n in names)


@pytest.mark.parametrize("name", ["WhiteFurnace", "SunTemple"])
def test_standin_scenes_and_tables_byte_equal(name):
    from dxrpathtracer_tpu.accel.lbvh import build_bvh_for_scene as jbuild
    from dxrpathtracer_tpu.app.settings import Scenes as JScenes
    from dxrpathtracer_tpu.scene import registry as jreg
    from dxrpathtracer_tpu_torch.accel.bvh import build_bvh_for_scene
    from dxrpathtracer_tpu_torch.scene.registry import load_scene
    from dxrpathtracer_tpu_torch.scene.types import SCENE_ARRAYS
    jscene, jpreset = jreg.load_scene(JScenes[name])
    if name == "WhiteFurnace":
        standin = jreg.build_scene(jreg._white_furnace_standin_meshes())
        if jscene.num_triangles != standin.num_triangles:
            pytest.skip("the JAX package loaded the WhiteFurnace asset")
    elif bool(jscene.materials.any_opacity):
        pytest.skip("the JAX package bound the SunTemple foliage masks")
    scene, preset = load_scene(Scenes[name])
    assert preset.name == jpreset.name
    want = reference_scene_arrays(jscene)
    for k in SCENE_ARRAYS:
        got = getattr(scene, k).numpy()
        assert got.dtype == want[k].dtype and \
            got.tobytes() == np.asarray(want[k]).tobytes(), k
    assert not scene.any_opacity
    for width in (8, 32):
        got = build_bvh_for_scene(scene, width=width)
        ref = jbuild(jscene, width=width)
        assert got.table.numpy().tobytes() == np.asarray(ref.table).tobytes()
        assert (got.num_rows, got.max_depth, got.root_code) == \
            (ref.num_rows, ref.max_depth, ref.root_code)


def test_profiler_statistics_on_cpu():
    prof = Profiler("cpu")
    assert prof.timing("Missing") == 0.0 and prof.stats() == {}
    for i in range(Profiler.WINDOW + 6):
        with prof.gpu_scope("Pass"):
            x = torch.ones(256, 256)
            for _ in range(3):
                x = x @ x / 256.0
        with prof.cpu_scope("Host"):
            pass
    st = prof.stats()
    assert set(st) == {"Pass", "Host"}
    assert st["Pass"]["count"] == Profiler.WINDOW
    assert 0.0 < st["Pass"]["min"] <= prof.timing("Pass") <= st["Pass"]["max"]
    assert abs(st["Pass"]["avg"] - prof.timing("Pass")) < 1e-12
    rep = prof.report().splitlines()
    assert len(rep) == 2 and rep[0].startswith("Host") and " ms" in rep[1]
    with pytest.raises(ValueError):
        with prof.cpu_scope("Raises"):
            raise ValueError
    assert prof.stats()["Raises"]["count"] == 1
