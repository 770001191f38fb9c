"""Port parity: alpha testing in dxrpathtracer_tpu_torch against dxrpathtracer_tpu.

  - Scenes: `tiny_alpha_scene` (bound to the mask the JAX package's
    `tiny_alpha_scene` decoded, if its DDS loader ran, else to the port's
    default, the 64x64 checker that is the JAX package's fallback) and
    `sponza_alpha_standin(num_cards=32)` with that checker bound as material
    1's opacity ("checker Sponza"; the JAX package builds it with its DDS
    loader handed the checker), and the W8 table built with alpha flags and
    the W32 table: byte-equal to the JAX package's.
  - Traversal with the alpha test inside the walk: the port's plain walk
    with `_make_alpha_test` as accept_fn against JAX
    `closest_hit/any_hit(accept_fn=_make_alpha_test(...))`, on W8 and W32,
    on 1024 seeded rays and 1024 camera-like rays per scene and on the
    adversarial alpha cases of tools/traverse_cases.py: tri ids and
    visibility equal, t/u/v bit for bit.
  - The port's copy of the DDS/BC decoder against the JAX package's on
    seeded blocks of each block format: texels bit for bit.
  - Frames: the port's render_sample (alpha inside the walk) against the
    JAX package's default render_sample, whose alpha route is punch-through
    (`_punch_through_closest`), on the tiny scene at 32x32 and the checker
    Sponza at 48x27, 2 samples, max_any_hit_path_length 2 (so W32 rays are
    alpha-tested too). The routes differ only past chains of more than 8
    rejections and where punch-through's restart nudge skips a surface, so
    the frames are held to rel-RMSE <= 1e-4 (as the opaque frame of
    tests/test_torch_render.py).
The JAX side runs in a subprocess whose XLA:CPU emits no FMA (ISA capped at
AVX): the tap's products then round as the port's do.
"""

import os
import struct
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dxrpathtracer_tpu_torch.accel import traverse as ttrav  # noqa: E402
from dxrpathtracer_tpu_torch.accel.bvh import build_bvh_for_scene  # noqa: E402
from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes  # noqa: E402
from dxrpathtracer_tpu_torch.convert import (bvh_from_numpy, frame_from_numpy,  # noqa: E402
                                             scene_from_reference_arrays)
from dxrpathtracer_tpu_torch.render.integrator import (_make_alpha_test,  # noqa: E402
                                                       render_sample)
from dxrpathtracer_tpu_torch.scene import registry as treg  # noqa: E402
from dxrpathtracer_tpu_torch.scene.types import SCENE_ARRAYS  # noqa: E402
from dxrpathtracer_tpu_torch.tools import traverse_cases  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RAYS = 1024

# Builds the JAX package's scenes, tables and traversal results. The
# checker Sponza: sponza_alpha_standin binds the DDS it finds; its loader
# is handed the checker instead. The tiny scene: the mask that its DDS
# loader decoded, if it ran, is kept for the port's scene.
_PRELUDE = r"""
import sys
from pathlib import Path
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from dxrpathtracer_tpu.accel import traverse
from dxrpathtracer_tpu.accel.lbvh import build_bvh_for_scene
from dxrpathtracer_tpu.app.settings import AppSettings
from dxrpathtracer_tpu.render.integrator import _make_alpha_test
from dxrpathtracer_tpu.scene import dds as jdds
from dxrpathtracer_tpu.scene import registry as jreg
from dxrpathtracer_tpu_torch.convert import reference_scene_arrays
from dxrpathtracer_tpu_torch.scene.registry import checker_mask


def checker_sponza(num_cards):
    exists = Path.exists
    load = jdds.load_dds

    class Image:
        data = checker_mask()

    Path.exists = lambda p: str(p).endswith(jreg.FOLIAGE_DDS) or exists(p)
    jdds.load_dds = lambda path: Image
    try:
        return jreg.sponza_alpha_standin(num_cards=num_cards)
    finally:
        Path.exists = exists
        jdds.load_dds = load


def tiny_alpha_scene(out):
    load, seen = jdds.load_dds, []

    def recording(path):
        image = load(path)
        seen.append(image.data)
        return image

    jdds.load_dds = recording
    try:
        scene = jreg.tiny_alpha_scene()[0]
    finally:
        jdds.load_dds = load
    if seen:
        out["tiny__mask"] = seen[0]
    return scene


def tables(scene, out, key):
    pos, tri = np.asarray(scene.positions), np.asarray(scene.tri_idx)
    bvhs = {8: build_bvh_for_scene(scene, positions=pos, tri_idx=tri,
                                   flag_alpha=True),
            32: build_bvh_for_scene(scene, positions=pos, tri_idx=tri,
                                    width=32)}
    for w, b in bvhs.items():
        out["%s__w%d__table" % (key, w)] = np.asarray(b.table)
        out["%s__w%d__const" % (key, w)] = np.asarray(
            [b.num_rows, b.max_depth, b.root_code, b.width,
             b.has_alpha_flags])
    return bvhs
"""

_TRAVERSE_SCRIPT = _PRELUDE + r"""
inp = dict(np.load(sys.argv[1]))
out = {}
scenes = {"tiny": tiny_alpha_scene(out), "sponza": checker_sponza(32)[0]}
for key, scene in scenes.items():
    for k, v in reference_scene_arrays(scene).items():
        out[key + "__scene__" + k] = v
    bvhs = tables(scene, out, key)
    accept = _make_alpha_test(jax.device_put(scene), AppSettings())
    for w, b in bvhs.items():
        for rays in ("seeded", "camera"):
            args = [jnp.asarray(inp["%s__%s__%s" % (key, rays, f)])
                    for f in ("o", "d", "tmin", "tmax", "active")]
            rec = jax.jit(lambda *a: traverse.closest_hit(
                b, *a, accept_fn=accept))(*args)
            pre = "%s__%s__w%d__" % (key, rays, w)
            for f in ("t", "tri_id", "u", "v"):
                out[pre + f] = np.asarray(getattr(rec, f))
            out[pre + "vis"] = np.asarray(jax.jit(lambda *a: traverse.any_hit(
                b, *a, accept_fn=accept))(*args))
np.savez(sys.argv[2], **out)
"""

_CASE_SCRIPT = _PRELUDE + r"""
import dataclasses
from dxrpathtracer_tpu.scene.build import build_scene
from dxrpathtracer_tpu.scene.procedural import MeshData
from dxrpathtracer_tpu.scene.textures import (AtlasBuilder,
                                              default_material_table)
from dxrpathtracer_tpu_torch.tools.traverse_cases import alpha_cases

out = {}
for name, (meshes, mask, rays) in alpha_cases().items():
    builder = AtlasBuilder()
    mats = default_material_table(2, builder)
    opacity = np.asarray(mats.opacity).copy()
    opacity[1] = builder.add("alpha_case_opacity", mask)
    has_op = np.asarray(mats.has_opacity).copy()
    has_op[1] = True
    mats = dataclasses.replace(mats, opacity=opacity, has_opacity=has_op,
                               any_opacity=True)
    scene = build_scene([MeshData(**vars(m)) for m in meshes],
                        materials=mats, atlas_builder=builder)
    for k, v in reference_scene_arrays(scene).items():
        out[name + "__scene__" + k] = v
    bvhs = tables(scene, out, name)
    accept = _make_alpha_test(jax.device_put(scene), AppSettings())
    args = [jnp.asarray(rays[f]) for f in ("o", "d", "tmin", "tmax",
                                           "active")]
    for w, b in bvhs.items():
        rec = jax.jit(lambda *a: traverse.closest_hit(
            b, *a, accept_fn=accept))(*args)
        for f in ("t", "tri_id", "u", "v"):
            out["%s__w%d__%s" % (name, w, f)] = np.asarray(getattr(rec, f))
        out["%s__w%d__vis" % (name, w)] = np.asarray(jax.jit(
            lambda *a: traverse.any_hit(b, *a, accept_fn=accept))(*args))
np.savez(sys.argv[2], **out)
"""


def run_reference(script: str, inputs: dict, tmp) -> dict:
    """Run `script` (reads argv[1] .npz, writes argv[2] .npz) in a fresh
    Python whose XLA:CPU emits no FMA; returns its outputs."""
    src, dst = tmp / "in.npz", tmp / "out.npz"
    np.savez(src, **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    for k in ("DXRPT_PALLAS_BODY", "DXRPT_ALPHA_SPLIT", "DXRPT_SPLIT_ALPHA",
              "DXRPT_PUNCH_HYBRID"):
        env.pop(k, None)
    proc = subprocess.run([sys.executable, "-c", script, str(src), str(dst)],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(dst))


def _unit(rng, n):
    d = rng.standard_normal((n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def _rays(key, kind):
    """1024 rays: seeded random ones in the scene's volume, or camera-like
    ones from the scene's viewpoint through a 32 x 32 grid."""
    rng = np.random.default_rng({"tiny": 1, "sponza": 2}[key]
                                + (10 if kind == "camera" else 0))
    if kind == "seeded":
        lo, hi = ((-3, 0.1, -2), (3, 2.5, 3)) if key == "tiny" else \
            ((-10, 0.5, -4), (10, 7, 4))
        o = rng.uniform(lo, hi, (N_RAYS, 3)).astype(np.float32)
        d = _unit(rng, N_RAYS)
    else:
        g = np.linspace(-1.0, 1.0, 32, dtype=np.float32)
        gy, gx = np.meshgrid(g, g, indexing="ij")
        if key == "tiny":   # from in front of the cards, looking at them
            o = np.tile(np.float32([0.0, 2.0, -5.0]), (N_RAYS, 1))
            d = np.stack([gx.ravel() * 0.45, -0.25 + gy.ravel() * 0.3,
                          np.ones(N_RAYS)], 1)
        else:               # the Sponza preset's camera, looking down +x
            o = np.tile(np.float32([-11.5, 1.85, -0.45]), (N_RAYS, 1))
            d = np.stack([np.ones(N_RAYS), gy.ravel() * 0.45,
                          gx.ravel() * 0.8], 1)
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmin = rng.choice(np.float32([0.0, 1e-4]), N_RAYS)
    tmax = np.where(rng.random(N_RAYS) < 0.2, 4.0, 1e30).astype(np.float32)
    return dict(o=o.astype(np.float32), d=d, tmin=tmin, tmax=tmax,
                active=rng.random(N_RAYS) > 0.1)


def _port_tables(ref, key):
    out = {}
    for w in (8, 32):
        rows, depth, root, width, flags = (
            int(v) for v in ref[f"{key}__w{w}__const"])
        out[w] = bvh_from_numpy(ref[f"{key}__w{w}__table"], rows, depth, root,
                                width, bool(flags))
    return out


def _scene_arrays(ref, key):
    pre = key + "__scene__"
    return {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    inputs = {}
    for key in ("tiny", "sponza"):
        for kind in ("seeded", "camera"):
            for f, a in _rays(key, kind).items():
                inputs[f"{key}__{kind}__{f}"] = a
    return run_reference(_TRAVERSE_SCRIPT, inputs,
                         tmp_path_factory.mktemp("alpha"))


@pytest.fixture(scope="module")
def port_scenes(reference):
    return {"tiny": treg.tiny_alpha_scene(reference.get("tiny__mask"))[0],
            "sponza": treg.sponza_alpha_standin(
                num_cards=32, opacity_mask=treg.checker_mask())[0]}


@pytest.mark.parametrize("key", ["tiny", "sponza"])
def test_alpha_scene_and_tables_byte_equal(reference, port_scenes, key):
    scene = port_scenes[key]
    want = _scene_arrays(reference, key)
    for name in SCENE_ARRAYS:
        got = getattr(scene, name).numpy()
        assert got.dtype == want[name].dtype and \
            got.tobytes() == want[name].tobytes(), name
    assert scene.any_opacity and bool(scene.has_opacity[1])
    assert int(want["num_lights"]) == scene.num_lights == 0
    for w, flag in ((8, True), (32, False)):
        got = build_bvh_for_scene(scene, width=w, flag_alpha=flag)
        ref = reference[f"{key}__w{w}__table"]
        assert got.table.numpy().tobytes() == ref.tobytes(), f"W{w}"
        assert [got.num_rows, got.max_depth, got.root_code, got.width,
                got.has_alpha_flags] == \
            [int(v) for v in reference[f"{key}__w{w}__const"]]
    assert build_bvh_for_scene(scene, width=8, flag_alpha=True).has_alpha_flags


def _assert_walks_equal(bvh, alpha, rays, ref, pre, min_rejected=1):
    r = {f: torch.from_numpy(a) for f, a in rays.items()}
    args = (bvh, r["o"], r["d"], r["tmin"], r["tmax"], r["active"])
    got = ttrav.closest_hit(*args, alpha=alpha)
    np.testing.assert_array_equal(got.tri_id.numpy(), ref[pre + "tri_id"])
    for f in ("t", "u", "v"):
        np.testing.assert_array_equal(
            getattr(got, f).numpy().view(np.int32),
            ref[pre + f].view(np.int32), err_msg=f)
    vis = ttrav.any_hit(*args, alpha=alpha).numpy()
    np.testing.assert_array_equal(vis, ref[pre + "vis"])
    # the test really rejected something: FORCE_OPAQUE gives other hits
    opaque = ttrav.closest_hit(*args)
    assert int((opaque.tri_id != got.tri_id).sum()) >= min_rejected
    return got


@pytest.mark.parametrize("kind", ["seeded", "camera"])
@pytest.mark.parametrize("width", [8, 32])
@pytest.mark.parametrize("key", ["tiny", "sponza"])
def test_plain_alpha_walk_matches_jax(reference, key, width, kind):
    scene = scene_from_reference_arrays(_scene_arrays(reference, key))
    alpha = _make_alpha_test(scene, AppSettings())
    bvh = _port_tables(reference, key)[width]
    assert bvh.has_alpha_flags == (width == 8)
    got = _assert_walks_equal(bvh, alpha, _rays(key, kind), reference,
                              f"{key}__{kind}__w{width}__")
    assert int(got.hit.sum()) > N_RAYS // 4


@pytest.fixture(scope="module")
def case_reference(tmp_path_factory):
    return run_reference(_CASE_SCRIPT, {},
                         tmp_path_factory.mktemp("alpha_cases"))


@pytest.mark.parametrize("width", [8, 32])
@pytest.mark.parametrize("case", ["alpha_cutoff", "alpha_stack",
                                  "alpha_coplanar", "alpha_edge_on"])
def test_adversarial_alpha_cases_match_jax(case_reference, case, width):
    meshes, mask, rays = traverse_cases.alpha_cases()[case]
    scene = traverse_cases.alpha_case_scene(meshes, mask)
    want = _scene_arrays(case_reference, case)
    for name in SCENE_ARRAYS:
        assert getattr(scene, name).numpy().tobytes() == \
            want[name].tobytes(), name
    bvh = _port_tables(case_reference, case)[width]
    got = _assert_walks_equal(bvh, _make_alpha_test(scene, AppSettings()),
                              rays, case_reference, f"{case}__w{width}__",
                              min_rejected=0 if case == "alpha_edge_on"
                              else 1)
    if case == "alpha_stack":
        # chains of more than 8 rejections: hits on the ninth card or past
        tri = got.tri_id.numpy()
        card = (tri - 2) // 2  # the floor is triangles 0-1, then 2 per card
        assert ((card >= 8) & (tri >= 2)).sum() > 100


# ---------------------------------------------------------------------------
# Frames against the JAX package's default render (punch-through)
# ---------------------------------------------------------------------------

_FRAME = ("inv_view_projection", "camera_pos_ws", "sun_direction_ws",
          "sun_irradiance", "sun_render_color", "cos_sun_angular_radius",
          "sin_sun_angular_radius", "curr_sample_idx")

_FRAME_SCRIPT = _PRELUDE + (r"""
from dxrpathtracer_tpu.app.session import RenderSession
from dxrpathtracer_tpu.app.settings import AppSettings, Scenes
frame_fields = %r
out = {}
for key, (w, h) in (("tiny", (32, 32)), ("sponza", (48, 27))):
    scene, preset = (jreg.tiny_alpha_scene() if key == "tiny"
                     else checker_sponza(32))
    s = AppSettings(current_scene=Scenes.Sponza, sqrt_num_samples=2,
                    max_path_length=3, max_any_hit_path_length=2,
                    enable_sunspace_shadows=False, enable_dense_proxy=False,
                    enable_clear_cut=False, enable_sw_raster=False)
    sess = RenderSession(settings=s, width=w, height=h, scene=scene,
                         preset=preset)
    for k, v in reference_scene_arrays(scene).items():
        out[key + "__scene__" + k] = v
    for name, b in (("w8", sess.bvh), ("w32", sess.bvh_ray)):
        out["%%s__%%s__table" %% (key, name)] = np.asarray(b.table)
        out["%%s__%%s__const" %% (key, name)] = np.asarray(
            [b.num_rows, b.max_depth, b.root_code, b.width,
             b.has_alpha_flags])
    out[key + "__sky"] = sess.sky.cubemap
    for i in range(2):
        f = sess.frame_constants(i)
        for k in frame_fields:
            out["%%s__frame%%d__%%s" %% (key, i, k)] = np.asarray(getattr(f, k))
    out[key + "__image"] = np.asarray(sess.render_to_completion(max_samples=2))
np.savez(sys.argv[2], **out)
""" % (_FRAME,))


@pytest.fixture(scope="module")
def frame_reference(tmp_path_factory):
    return run_reference(_FRAME_SCRIPT, {},
                         tmp_path_factory.mktemp("alpha_frames"))


def _rel_rmse(img, ref):
    return float(np.sqrt(np.mean((img - ref) ** 2)) / (np.abs(ref).max() + 1e-9))


@pytest.mark.parametrize("key,size", [("tiny", (32, 32)),
                                      ("sponza", (48, 27))])
def test_alpha_frame_matches_jax_punch_through(frame_reference, key, size):
    ref = frame_reference
    w, h = size
    scene = scene_from_reference_arrays(_scene_arrays(ref, key))
    t = {}
    for name in ("w8", "w32"):
        rows, depth, root, width, flags = (
            int(v) for v in ref[f"{key}__{name}__const"])
        t[name] = bvh_from_numpy(ref[f"{key}__{name}__table"], rows, depth,
                                 root, width, bool(flags))
    assert t["w8"].has_alpha_flags and not t["w32"].has_alpha_flags
    settings = AppSettings(current_scene=Scenes.Sponza, sqrt_num_samples=2,
                           max_path_length=3, max_any_hit_path_length=2)
    sky = torch.from_numpy(ref[key + "__sky"])
    accum = torch.zeros((h, w, 3))
    for i in range(2):
        frame = frame_from_numpy(*(ref[f"{key}__frame{i}__{k}"]
                                   for k in _FRAME))
        accum = render_sample(scene, t["w8"], t["w32"], sky, settings, frame,
                              w, h, accum)
    img = accum.numpy()
    assert np.isfinite(img).all() and img.shape == (h, w, 3)
    err = _rel_rmse(img, ref[key + "__image"])
    print(f"{key} {w}x{h}x2 alpha frame: rel RMSE vs JAX punch-through "
          f"{err:.3e}, {np.mean(img == ref[key + '__image']):.4f} of values "
          f"bit-equal")
    assert err <= 1e-4


def _dds_bytes(width, height, fourcc, payload):
    """A legacy-header DDS file: fourCC pixel format, one surface."""
    pf = struct.pack("<2I4s5I", 32, 0x4, fourcc, 0, 0, 0, 0, 0)
    header = struct.pack("<4s7I", b"DDS ", 124, 0x1007, height, width, 0, 0,
                         1)
    return header + b"\0" * 44 + pf + struct.pack("<5I", 0x1000, 0, 0, 0,
                                                  0) + payload


@pytest.mark.parametrize("fourcc,block_bytes", [
    (b"DXT1", 8), (b"DXT3", 16), (b"DXT5", 16), (b"BC4U", 8), (b"BC4S", 8),
    (b"BC5U", 16), (b"ATI2", 16)])
def test_dds_decoder_matches_jax(tmp_path, fourcc, block_bytes):
    """The port's copy of the DDS/BC decoder (which decodes the
    reference's foliage mask for the alpha scenes) decodes seeded blocks
    to the JAX package's texels, bit for bit."""
    from dxrpathtracer_tpu.scene.dds import load_dds as jload
    from dxrpathtracer_tpu_torch.scene.dds import load_dds
    w, h = 20, 12  # 5 x 3 blocks
    rng = np.random.default_rng(block_bytes + fourcc[3])
    path = tmp_path / "t.dds"
    path.write_bytes(_dds_bytes(w, h, fourcc, rng.integers(
        0, 256, 15 * block_bytes, dtype=np.uint8).tobytes()))
    got, want = load_dds(path), jload(path)
    assert got.data.shape == want.data.shape and got.data.shape[:2] == (h, w)
    assert got.data.tobytes() == want.data.tobytes()
    assert (got.is_srgb, got.format_name) == (want.is_srgb, want.format_name)
