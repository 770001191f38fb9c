"""Port parity: dynamic geometry (accel/device_build.py, the morton build of
accel/bvh.py, scene/animate.py, the `animate` command) against
dxrpathtracer_tpu, and the rule that device paths divide by tensors.

  - Morton codes of 4,096 centroids with +-0.0 and repeated values: the
    port's numpy and torch versions equal JAX's `morton_codes_30` and
    `morton_codes_30_jnp`.
  - `lbvh_plan` equals JAX's; `build_table_device` is bit-identical (int32
    view) to JAX's `build_table_numpy`, to the port's numpy copy of it and
    to the port's native morton build, at 5 to 2,000 triangles, and to
    numpy's with +-0.0 in the soup (the native builder's std::min keeps the
    first of two equal zeros where numpy keeps the second, so it alone
    differs there).
  - Closest hits on the device-built table: the plain walk equals its walk
    on the native table and a brute-force test.
  - `rotate_scene_y` is bit-equal to JAX's (no FMA) at theta 0, pi/2, 1.3,
    the tri_shade int32 tail unchanged; one animated frame (BoxTest 32x32,
    and tiny_alpha_scene, whose device table has no alpha flags) is within
    1e-4 rel-RMSE of JAX's `frame_geometry` plus render step, its table bit
    for bit.
  - The `animate` command writes two distinct, finite PNGs and a GIF.
  - Raygen, the raster rays, the shadow maps, the CMJ sampler and the
    device build divide no tensor by a Python number (ATen's CUDA divide
    would multiply by its reciprocal instead; core/math3.div).
The JAX side of the frames runs in one subprocess whose XLA:CPU emits no FMA
(ISA capped at AVX).
"""

import numbers
import os
import subprocess
import sys
import traceback

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from torch.overrides import TorchFunctionMode  # noqa: E402

from dxrpathtracer_tpu.accel import device_build as jdb  # noqa: E402
from dxrpathtracer_tpu.accel.brute import brute_force_closest_hit  # noqa: E402
from dxrpathtracer_tpu.accel.lbvh import build_table_numpy as jbuild  # noqa: E402
from dxrpathtracer_tpu.accel.lbvh import morton_codes_30 as jmorton  # noqa: E402
from dxrpathtracer_tpu_torch.accel import bvh as tbvh  # noqa: E402
from dxrpathtracer_tpu_torch.accel import device_build as tdb  # noqa: E402
from dxrpathtracer_tpu_torch.accel.traverse import closest_hit  # noqa: E402
from dxrpathtracer_tpu_torch.app.session import RenderSession  # noqa: E402
from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes  # noqa: E402
from dxrpathtracer_tpu_torch.scene import animate  # noqa: E402
from dxrpathtracer_tpu_torch.scene import registry as treg  # noqa: E402
from dxrpathtracer_tpu_torch.scene.types import TRI_SHADE_VTX  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 32
THETAS = (0.0, np.pi / 2, 1.3)
# the JAX `animate` command's second of 3 frames
FRAME_THETA = np.float32(2.0 * np.pi / 3)
# exact alternates of the per-ray walk are off on both sides
ENGINES_OFF = dict(enable_packet_traversal=False,
                   enable_sunspace_shadows=False, enable_dense_proxy=False,
                   enable_clear_cut=False, enable_sw_raster=False)
SETTINGS = dict(sqrt_num_samples=1, max_path_length=3,
                max_any_hit_path_length=2, **ENGINES_OFF)

_SCRIPT = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from dxrpathtracer_tpu.accel.device_build import build_table_device, lbvh_plan
from dxrpathtracer_tpu.accel.lbvh import WIDTH, FlatBVH
from dxrpathtracer_tpu.app.session import RenderSession
from dxrpathtracer_tpu.app.settings import AppSettings, Scenes
from dxrpathtracer_tpu.scene.animate import rotate_scene_y
from dxrpathtracer_tpu.scene.registry import tiny_alpha_scene

res, thetas, frame_theta, settings = %d, %r, %r, %r
out = {}
for name in ("box", "alpha"):
    s = AppSettings(current_scene=Scenes.BoxTest, **settings)
    scene = preset = None
    if name == "alpha":
        scene, preset = tiny_alpha_scene()
    sess = RenderSession(settings=s, width=res, height=res, scene=scene,
                         preset=preset)
    # the animate command's set-up and frame (cli.cmd_animate)
    sess.bvh2 = None
    sess.bvh_ray = None
    sess.sun_grid = None
    sess._tri_table = None
    sess._step = sess._build_step()
    plan = lbvh_plan(sess.scene_host.num_triangles)
    pos = np.asarray(sess.scene_host.positions)
    lo, hi = pos.min(axis=0), pos.max(axis=0)
    center = np.array([(lo[0] + hi[0]) / 2, 0.0, (lo[2] + hi[2]) / 2],
                      np.float32)

    @jax.jit
    def frame_geometry(scene, theta):
        sc = rotate_scene_y(scene, theta, center)
        v0 = sc.positions[sc.tri_idx[:, 0]]
        v1 = sc.positions[sc.tri_idx[:, 1]]
        v2 = sc.positions[sc.tri_idx[:, 2]]
        return sc, build_table_device(v0, v1, v2, plan)

    if name == "box":
        for i, th in enumerate(thetas):
            sc, _ = frame_geometry(sess.scene, jnp.float32(th))
            for k in ("positions", "normals", "tangents", "bitangents",
                      "tri_shade"):
                out["rot%%d_%%s" %% (i, k)] = np.asarray(getattr(sc, k))
            out["rot%%d_lights_position" %% i] = np.asarray(sc.lights.position)
    sc, table = frame_geometry(sess.scene, jnp.float32(frame_theta))
    bvh = FlatBVH(table=table, num_rows=plan.num_rows,
                  num_tris=plan.num_tris, num_leaves=plan.num_leaves,
                  leaf_size=plan.leaf_size, max_depth=plan.depth + 2,
                  root_code=plan.root_code, width=WIDTH)
    sess.reset_accumulation()
    sess._accum_slabs = sess._step(sc, bvh, sess._accum_slabs,
                                   sess._sky_cube_dev,
                                   sess.frame_constants(0), sess.settings)
    out[name + "_center"] = center
    out[name + "_table"] = np.asarray(table)
    out[name + "_image"] = np.asarray(sess.accum)
np.savez(sys.argv[1], **out)
""" % (RES, tuple(float(np.float32(t)) for t in THETAS), float(FRAME_THETA),
       SETTINGS)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_animate") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, str(out)], env=env,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


def _soup(rng, t, spread=1.0, size=0.3):
    v0 = rng.uniform(-spread, spread, (t, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-size, size, (t, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-size, size, (t, 3)).astype(np.float32)
    return v0, v1, v2


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32)


def test_morton_codes_equal():
    rng = np.random.default_rng(7)
    c = rng.uniform(-5, 5, (4096, 3)).astype(np.float32)
    c[::7, 0] = 0.0
    c[::11, 1] = -0.0
    c[::13] = c[5]
    c[-64:] = c[:64]
    want = jmorton(c)
    np.testing.assert_array_equal(
        np.asarray(jdb.morton_codes_30_jnp(jnp.asarray(c))).astype(np.uint32),
        want)
    np.testing.assert_array_equal(tbvh.morton_codes_30(c), want)
    np.testing.assert_array_equal(
        tdb.morton_codes_30(torch.from_numpy(c)).numpy(),
        want.astype(np.int64))


def test_plan_equals_jax():
    for t in (1, 12, 13, 97, 2000, 4097):
        got, want = tdb.lbvh_plan(t), jdb.lbvh_plan(t)
        for f in ("num_tris", "leaf_size", "num_rows", "num_leaves", "depth",
                  "root_code", "leaf_ids", "int_ids", "leaf_src",
                  "leaf_valid", "int_child", "int_codes"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f"{t}: {f}")
        # the port sweeps the levels deepest first
        assert len(got.level_int) == want.depth - 1
        for g, w in zip(got.level_int, reversed(want.level_int[:-1])):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("t_count", [5, 12, 13, 97, 300, 2000])
def test_device_table_bit_identical(t_count):
    v = _soup(np.random.default_rng(t_count), t_count)
    want, n_rows, n_leaves, depth, root = jbuild(*v)
    plan = tdb.lbvh_plan(t_count)
    assert (plan.num_rows, plan.num_leaves, plan.depth, plan.root_code) == \
        (n_rows, n_leaves, depth, root)
    dev = tdb.build_bvh_device(*(torch.from_numpy(x) for x in v), plan)
    np.testing.assert_array_equal(_bits(dev.table), _bits(want))
    host = tbvh.build_table_numpy(*v)
    np.testing.assert_array_equal(_bits(host[0]), _bits(want))
    assert host[1:] == (n_rows, n_leaves, depth, root)
    native = tbvh.build_bvh(*v, mode="morton")
    np.testing.assert_array_equal(_bits(native.table), _bits(want))
    assert (native.num_rows, native.max_depth, native.root_code) == \
        (dev.num_rows, dev.max_depth, dev.root_code) == \
        (n_rows, depth + 2, root)


def test_device_table_signed_zeros():
    rng = np.random.default_rng(3)
    v = _soup(rng, 2000)
    for x in v:
        x[rng.random(x.shape) < 0.2] = 0.0
        x[rng.random(x.shape) < 0.2] = -0.0
    want = jbuild(*v)[0]
    dev = tdb.build_table_device(*(torch.from_numpy(x) for x in v),
                                 tdb.lbvh_plan(2000))
    np.testing.assert_array_equal(_bits(dev), _bits(want))
    np.testing.assert_array_equal(_bits(tbvh.build_table_numpy(*v)[0]),
                                  _bits(want))
    native = _bits(tbvh.build_bvh(*v, mode="morton").table)
    off = native != _bits(want)
    assert off.any()
    # the native table differs only in the signs of zeros
    assert ((native[off] & 0x7FFFFFFF) == 0).all()
    assert ((_bits(want)[off] & 0x7FFFFFFF) == 0).all()


def test_device_table_closest_hits():
    rng = np.random.default_rng(1)
    v = _soup(rng, 500)
    o = rng.uniform(-3, 3, (500, 3)).astype(np.float32)
    d = rng.uniform(-0.5, 0.5, (500, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dev = tdb.build_bvh_device(*(torch.from_numpy(x) for x in v))
    native = tbvh.build_bvh(*v, mode="morton")
    args = (torch.from_numpy(o), torch.from_numpy(d), 0.0, 1e30)
    got, ref = closest_hit(dev, *args), closest_hit(native, *args)
    for f in ("t", "tri_id", "u", "v"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    bt, btri, _, _ = brute_force_closest_hit(*v, o, d, 0.0, 1e30)
    tri = got.tri_id.numpy()
    assert ((tri >= 0) == (btri >= 0)).all() and (tri >= 0).mean() > 0.5
    m = tri >= 0
    np.testing.assert_allclose(got.t.numpy()[m], bt[m], rtol=1e-5, atol=1e-5)
    assert (tri[m] == btri[m]).mean() > 0.999


def _session(name, device="cpu"):
    scene = preset = None
    if name == "alpha":
        scene, preset = treg.tiny_alpha_scene()
    return RenderSession(AppSettings(current_scene=Scenes.BoxTest,
                                     **SETTINGS), RES, RES, device=device,
                         scene=scene, preset=preset)


def test_rotate_scene_y_bit_equal(jax_ref):
    scene, _ = treg.load_scene(Scenes.BoxTest)
    center = jax_ref["box_center"]
    np.testing.assert_array_equal(
        animate.turntable_center(scene.positions.numpy()), center)
    for i, th in enumerate(THETAS):
        sc = animate.rotate_scene_y(scene, np.float32(th), center)
        for k in ("positions", "normals", "tangents", "bitangents",
                  "tri_shade"):
            np.testing.assert_array_equal(_bits(getattr(sc, k)),
                                          _bits(jax_ref[f"rot{i}_{k}"]),
                                          err_msg=f"theta {th}: {k}")
        np.testing.assert_array_equal(
            _bits(sc.lights.position), _bits(jax_ref[f"rot{i}_lights_position"]))
        tail = slice(3 * TRI_SHADE_VTX, None)
        assert torch.equal(sc.tri_shade.view(torch.int32)[:, tail],
                           scene.tri_shade.view(torch.int32)[:, tail])


@pytest.mark.parametrize("name", ["box", "alpha"])
def test_animated_frame_matches_jax(jax_ref, name):
    sess = _session(name)
    center = animate.turntable_center(sess.scene_host.positions.numpy())
    np.testing.assert_array_equal(center, jax_ref[name + "_center"])
    plan = tdb.lbvh_plan(sess.scene.num_triangles)
    scene, bvh = animate.turntable_geometry(sess.scene, FRAME_THETA, center,
                                            plan)
    np.testing.assert_array_equal(_bits(bvh.table),
                                  _bits(jax_ref[name + "_table"]))
    assert not bvh.has_alpha_flags
    assert scene.any_opacity == (name == "alpha")
    sess.use_geometry(scene, bvh)
    img = sess.render_to_completion(1).numpy()
    ref = jax_ref[name + "_image"]
    err = float(np.sqrt(np.mean((img - ref) ** 2)) / (np.abs(ref).max()
                                                       + 1e-9))
    print(f"{name} animated frame: rel RMSE vs JAX {err:.3e}, "
          f"{np.mean(img == ref):.4f} of values bit-equal")
    assert np.isfinite(img).all() and ref.max() > 0 and err <= 1e-4


def test_animate_cli_renders_distinct_finite_frames(tmp_path, monkeypatch):
    from PIL import Image

    from dxrpathtracer_tpu_torch.app.cli import main
    out, gif = tmp_path / "anim", tmp_path / "turn.gif"
    main(["animate", "--current-scene", "BoxTest", "--width", "48",
          "--height", "24", "--frames", "2", "--spp", "1", "--output",
          str(out), "--gif", str(gif), "--device", "cpu"])
    f0 = np.asarray(Image.open(out / "frame_000.png")).astype(np.float32)
    f1 = np.asarray(Image.open(out / "frame_001.png")).astype(np.float32)
    assert f0.shape == (24, 48, 3)
    assert np.isfinite(f0).all() and np.isfinite(f1).all()
    assert not np.allclose(f0, f1)   # the scene visibly turned
    assert gif.exists()
    if not torch.cuda.is_available():   # without --device cpu it raises
        monkeypatch.setenv("DXRPT_CRASH_DUMP", str(tmp_path / "crash.json"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["animate", "--current-scene", "BoxTest", "--width", "8",
                  "--height", "8", "--frames", "1", "--output",
                  str(tmp_path / "x")])


_DIVISIONS = {torch.Tensor.__truediv__, torch.Tensor.__itruediv__,
              torch.Tensor.div, torch.Tensor.div_, torch.div,
              torch.true_divide, torch.Tensor.true_divide}


class _ScalarDivisions(TorchFunctionMode):
    """Records the port's source lines that divide a tensor by a number."""

    def __init__(self):
        super().__init__()
        self.sites = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in _DIVISIONS and len(args) > 1 and \
                isinstance(args[1], (numbers.Number, np.generic)):
            frames = [f for f in traceback.extract_stack()[:-1]
                      if "dxrpathtracer_tpu_torch" in f.filename]
            if frames:
                self.sites.add(f"{frames[-1].filename}:{frames[-1].lineno}")
        return func(*args, **(kwargs or {}))


def test_device_paths_divide_by_device_tensors():
    """Raygen, the raster primary rays (MSAA), the sun's and the spots' depth
    maps with PCF and EVSM, the CMJ sampler at a non-power-of-two sample
    count and the device build, on the tiny alpha scene with two spot
    lights: no tensor is divided by a Python number."""
    import dataclasses

    from dxrpathtracer_tpu_torch.scene.types import make_spot_lights
    scene, preset = treg.tiny_alpha_scene()
    scene = dataclasses.replace(scene, lights=make_spot_lights(
        [[0.0, 2.0, 0.0], [1.0, 2.0, 1.0]], [[0, 1, 0], [0, 1, 0.1]],
        [[5, 5, 5], [3, 3, 3]], [[0.5, 1.0], [0.4, 0.9]]))
    audit = _ScalarDivisions()
    with audit:
        sess = RenderSession(AppSettings(current_scene=Scenes.BoxTest,
                                         sqrt_num_samples=3), 12, 10,
                             device="cpu", scene=scene, preset=preset)
        sess.render_frame()
        for mode in ("rays", "pcf", "evsm"):
            sess.render_raster_frame(shadow_mode=mode, shadow_map_size=16)
        animate.turntable_geometry(sess.scene, np.float32(0.5),
                                   np.zeros(3, np.float32),
                                   tdb.lbvh_plan(scene.num_triangles))
    assert not audit.sites, sorted(audit.sites)
