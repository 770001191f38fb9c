"""Port parity: parallel/mesh.py of dxrpathtracer_tpu_torch (rows, samples
and both over a list of devices, and the texel-row-sharded bake) against
dxrpathtracer_tpu/parallel/mesh.py and against the port's own unsharded
render and bake.

  - Against the JAX package: one subprocess (XLA:CPU without FMA, four
    virtual devices) builds BoxTest with the packets on and the grid,
    proxy, cut and raster off, and runs make_sharded_step at 128x32 (four
    shards of 8 rows), make_sharded_bake_step at 32x32,
    make_sample_parallel_step (four devices x two steps) and a 2x2
    make_grid_step (two steps) at 32x32; the port converts its scene,
    tables, frames and surface maps (convert.py) and runs its counterparts
    on ["cpu"] * 4. Each image within rel-RMSE 1e-4 (test_torch_render.py's
    bound), the bit-equal share printed.
  - Against itself, the engines on (packets, grid, proxy, cut; BoxTest, and
    tiny_alpha_scene on its default alpha route): row shards of 8 rows ==
    the unsharded frame bit for bit; 4-row shards (2x64 packet tiles, other
    packets) within rel-RMSE 1e-4, the differing pixels counted; per-shard
    raster bins == the full-frame bins' frame bit for bit; the sample and
    grid steps == the sequential samples within allclose(1e-4, 1e-4); the
    sharded bake == Baker.bake_step bit for bit; make_render_mesh() without
    a CUDA device and a height that does not divide raise.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

torch = pytest.importorskip("torch")

from dxrpathtracer_tpu_torch.app.session import RenderSession  # noqa: E402
from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes  # noqa: E402
from dxrpathtracer_tpu_torch.bake.baker import Baker  # noqa: E402
from dxrpathtracer_tpu_torch.convert import (bvh_from_numpy,  # noqa: E402
                                             frame_from_numpy,
                                             scene_from_numpy)
from dxrpathtracer_tpu_torch.parallel import mesh as M  # noqa: E402
from dxrpathtracer_tpu_torch.render import swraster  # noqa: E402
from dxrpathtracer_tpu_torch.render.integrator import render_sample  # noqa: E402
from dxrpathtracer_tpu_torch.scene.registry import tiny_alpha_scene  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 128, 32          # the row-sharded frame: 4 shards of 8 rows
SQ = 32                 # the sample-parallel, grid and bake size
CPU4 = ["cpu"] * 4

_FRAME = ("inv_view_projection", "camera_pos_ws", "sun_direction_ws",
          "sun_irradiance", "sun_render_color", "cos_sun_angular_radius",
          "sin_sun_angular_radius", "curr_sample_idx")

_SCRIPT = r"""
import sys
import dataclasses
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from dxrpathtracer_tpu.app.session import RenderSession
from dxrpathtracer_tpu.app.settings import AppSettings, Scenes
from dxrpathtracer_tpu.bake.baker import Baker
from dxrpathtracer_tpu.parallel.mesh import (
    make_grid_step, make_render_mesh, make_sample_parallel_step,
    make_sharded_bake_step, make_sharded_step, shard_accum)

W, H, SQ = %d, %d, %d
frame_fields = %r
assert len(jax.devices()) == 4
s = AppSettings(current_scene=Scenes.BoxTest, sqrt_num_samples=2,
                max_path_length=3, enable_sunspace_shadows=False,
                enable_dense_proxy=False, enable_clear_cut=False,
                enable_sw_raster=False)
sq = s.replace(sqrt_num_samples=4)
out = {}


def export(prefix, sess):
    sc = sess.scene_host
    for k, v in dict(
            positions=sc.positions, normals=sc.normals, uvs=sc.uvs,
            tangents=sc.tangents, bitangents=sc.bitangents,
            tri_idx=sc.tri_idx, tri_material=sc.tri_material,
            tri_shade=sc.tri_shade, texels=sc.textures.texels,
            texture_meta=sc.textures.meta,
            packed_meta=sc.materials.packed_meta,
            has_opacity=sc.materials.has_opacity,
            sky_cube=sess.sky.cubemap).items():
        out[prefix + k] = np.asarray(v)
    for name, b in (("bvh", sess.bvh), ("ray_bvh", sess.bvh_ray)):
        out[prefix + name + "__table"] = np.asarray(b.table)
        out[prefix + name + "__const"] = np.asarray(
            [b.num_rows, b.max_depth, b.root_code, b.width,
             b.has_alpha_flags])
    for i in range(2):
        f = sess.frame_constants(i)
        for k in frame_fields:
            out[prefix + "frame%%d__%%s" %% (i, k)] = np.asarray(getattr(f, k))


devs = jax.devices()[:4]
wide = RenderSession(settings=s, width=W, height=H)
export("wide__", wide)
accum = np.random.default_rng(3).random((H, W, 3)).astype(np.float32)
out["wide__accum"] = accum
mesh = make_render_mesh(devs)
step = make_sharded_step(mesh, s, W, H)
out["rows"] = np.asarray(step(
    wide.scene, wide.bvh, shard_accum(mesh, jnp.asarray(accum)),
    wide._sky_cube_dev, wide.frame_constants(1), ray_bvh=wide.bvh_ray))

square = RenderSession(settings=sq, width=SQ, height=SQ)
export("square__", square)
baker = Baker(square, resolution=SQ)
assert len(baker._pos_slabs) == 1
out["bake__pos"] = np.asarray(baker._pos_slabs[0])
out["bake__nrm"] = np.asarray(baker._nrm_slabs[0])
bstep = make_sharded_bake_step(mesh, sq, SQ)
out["bake"] = np.asarray(bstep(
    square.scene, square.bvh_ray,
    shard_accum(mesh, jnp.zeros((SQ, SQ, 4), jnp.float32)),
    square._sky_cube_dev, square.frame_constants(0),
    shard_accum(mesh, baker._pos_slabs[0]),
    shard_accum(mesh, baker._nrm_slabs[0]), jnp.uint32(3)))

smesh = make_render_mesh(devs, axis_name="samples")
sstep = make_sample_parallel_step(smesh, sq, SQ, SQ)
acc = shard_accum(smesh, jnp.zeros((4, SQ, SQ, 3), jnp.float32),
                  axis_name="samples")
gmesh = Mesh(np.asarray(devs).reshape(2, 2), axis_names=("samples", "rows"))
gstep = make_grid_step(gmesh, sq, SQ, SQ)
gacc = jax.device_put(jnp.zeros((2, SQ, SQ, 3), jnp.float32),
                      NamedSharding(gmesh, P("samples", "rows")))
for i in range(2):
    f = dataclasses.replace(square.frame_constants(0),
                            curr_sample_idx=jnp.uint32(i))
    acc = sstep(square.scene, square.bvh, acc, square._sky_cube_dev, f,
                ray_bvh=square.bvh_ray)
    gacc = gstep(square.scene, square.bvh, gacc, square._sky_cube_dev, f,
                 ray_bvh=square.bvh_ray)
out["samples"] = np.asarray(acc)
out["grid"] = np.asarray(gacc)
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
""" % (W, H, SQ, _FRAME)


def _rel_rmse(img, ref):
    img, ref = np.asarray(img), np.asarray(ref)
    return float(np.sqrt(np.mean((img - ref) ** 2))
                 / (np.abs(ref).max() + 1e-9))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_cpu_max_isa=AVX "
                         "--xla_force_host_platform_device_count=4")
    env.pop("DXRPT_PALLAS_BODY", None)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, "-", str(out)],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


def _port(ref, prefix):
    """(scene, W8 table, W32 table, sky cube, [frame 0, frame 1]) of a JAX
    session's arrays."""
    arrays = {k[len(prefix):]: v for k, v in ref.items()
              if k.startswith(prefix)}
    tables = []
    for name in ("bvh", "ray_bvh"):
        rows, depth, root, width, alpha = (
            int(v) for v in arrays[name + "__const"])
        tables.append(bvh_from_numpy(arrays[name + "__table"], rows, depth,
                                     root, width, bool(alpha)))
    frames = [frame_from_numpy(*(arrays[f"frame{i}__{k}"] for k in _FRAME))
              for i in range(2)]
    return (scene_from_numpy(arrays), *tables,
            torch.from_numpy(arrays["sky_cube"]), frames)


def _report(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = _rel_rmse(got, want)
    print(f"{name}: rel RMSE vs JAX {err:.3e}, "
          f"{np.mean(got == want):.4f} of values bit-equal")
    assert err <= 1e-4, name


def test_row_step_matches_jax(reference):
    scene, bvh, ray_bvh, sky, frames = _port(reference, "wide__")
    settings = AppSettings(current_scene=Scenes.BoxTest, sqrt_num_samples=2,
                           max_path_length=3)
    mesh = M.make_render_mesh(CPU4)
    step = M.make_sharded_step(mesh, settings, W, H)
    out = step(scene, bvh, M.shard_accum(
        mesh, torch.from_numpy(reference["wide__accum"])), sky, frames[1],
        ray_bvh=ray_bvh)
    assert [tuple(b.shape) for b in out] == [(H // 4, W, 3)] * 4
    _report("rows 4 x 8 of 128x32", M.gather_shards(mesh, out),
            reference["rows"])


def test_bake_step_matches_jax(reference):
    scene, _, ray_bvh, sky, frames = _port(reference, "square__")
    settings = AppSettings(current_scene=Scenes.BoxTest, sqrt_num_samples=4,
                           max_path_length=3)
    mesh = M.make_render_mesh(CPU4)
    step = M.make_sharded_bake_step(mesh, settings, SQ)
    pos, nrm = (torch.from_numpy(reference["bake__" + k])
                for k in ("pos", "nrm"))
    out = step(scene, ray_bvh, M.shard_accum(mesh, torch.zeros((SQ, SQ, 4))),
               sky, frames[0], M.shard_accum(mesh, pos),
               M.shard_accum(mesh, nrm), 3)
    got = M.gather_shards(mesh, out)
    assert float(got[..., 3].sum()) > 0
    _report("bake 32x32 over 4", got, reference["bake"])


def test_sample_and_grid_steps_match_jax(reference):
    scene, bvh, ray_bvh, sky, frames = _port(reference, "square__")
    settings = AppSettings(current_scene=Scenes.BoxTest, sqrt_num_samples=4,
                           max_path_length=3)
    smesh = M.make_render_mesh(CPU4, axis_name="samples")
    gmesh = M.RenderMesh([CPU4[:2], CPU4[2:]], ("samples", "rows"))
    assert gmesh.shape == {"samples": 2, "rows": 2} and gmesh.size == 4
    sstep = M.make_sample_parallel_step(smesh, settings, SQ, SQ)
    gstep = M.make_grid_step(gmesh, settings, SQ, SQ)
    acc = M.shard_accum(smesh, torch.zeros((4, SQ, SQ, 3)),
                        axis_name="samples")
    gacc = M.shard_accum(gmesh, torch.zeros((2, SQ, SQ, 3)),
                         axis_name="samples")
    for i in range(2):
        f = dataclasses.replace(frames[0], curr_sample_idx=i)
        acc = sstep(scene, bvh, acc, sky, f, ray_bvh=ray_bvh)
        gacc = gstep(scene, bvh, gacc, sky, f, ray_bvh=ray_bvh)
    _report("samples 4 x 2 steps", M.gather_shards(smesh, acc),
            reference["samples"])
    _report("grid 2x2, 2 steps", M.gather_shards(gmesh, gacc),
            reference["grid"])
    _report("samples image", M.sample_parallel_image(
        M.gather_shards(smesh, acc)), reference["samples"].mean(axis=0))


# ---------------------------------------------------------------------------
# The port against itself, the engines on
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def box():
    sess = RenderSession(AppSettings(current_scene=Scenes.BoxTest,
                                     sqrt_num_samples=2), W, H, device="cpu")
    assert sess.proxy is not None and sess.cut is not None
    return sess


def _engines(sess):
    return dict(ray_bvh=sess.bvh_ray, sun_grid=sess.update_sun_grid(),
                proxy=sess.proxy, cut=sess.cut, alpha_bvh=sess.bvh_alpha)


def _unsharded(sess, frame, accum, raster=None):
    e = _engines(sess)
    return render_sample(sess.scene, sess.bvh, e["ray_bvh"], sess.sky_cube,
                         sess.settings, frame, sess.width, sess.height,
                         accum, sun_grid=e["sun_grid"], proxy=e["proxy"],
                         cut=e["cut"], raster=raster,
                         alpha_bvh=e["alpha_bvh"])


def _sharded(sess, n, frame, accum, raster=None):
    mesh = M.make_render_mesh(["cpu"] * n)
    step = M.make_sharded_step(mesh, sess.settings, sess.width, sess.height)
    return M.gather_shards(mesh, step(
        sess.scene, sess.bvh, M.shard_accum(mesh, accum), sess.sky_cube,
        frame, raster=raster, **_engines(sess)))


@pytest.mark.parametrize("scene", ["boxtest", "tiny_alpha"])
def test_row_shards_equal_the_unsharded_frame(box, scene):
    if scene == "boxtest":
        sess = box
    else:
        sc, preset = tiny_alpha_scene()
        sess = RenderSession(AppSettings(sqrt_num_samples=2), W, H,
                             device="cpu", scene=sc, preset=preset)
        assert sess.scene.any_opacity
    frame = sess.frame_constants(1)
    accum = torch.from_numpy(np.random.default_rng(5).random(
        (H, W, 3)).astype(np.float32))
    ref = _unsharded(sess, frame, accum)
    assert bool(ref.isfinite().all()) and float(ref.max()) > 0
    # 8-row shards keep the frame's 8x16 packet tiles: bit for bit
    assert torch.equal(_sharded(sess, 4, frame, accum), ref)
    # 4-row shards take 4x32 tiles: other packets, the same hits but
    # perhaps a grazing lane
    got = _sharded(sess, 8, frame, accum)
    differ = int((got != ref).any(dim=-1).sum())
    err = _rel_rmse(got, ref)
    print(f"{scene}: 8 shards of 4 rows, rel RMSE {err:.3e}, {differ} "
          f"pixels differ")
    assert err <= 1e-4


def test_per_shard_raster_bins_equal_the_full_frame_bins(box, monkeypatch):
    sess = box
    frame = sess.frame_constants(0)
    accum = torch.zeros((H, W, 3))
    host = sess.scene_host
    args = (host.positions.numpy(), host.tri_idx.numpy(),
            np.asarray(sess.camera.view_projection(), np.float64),
            float(sess.camera.near_clip), W, H)
    full = swraster.build_raster_bins(*args, 8, 16, sess._triangle_table())
    mesh = M.make_render_mesh(CPU4)
    shards = M.raster_shards(mesh, *args, sess._triangle_table())
    assert [(b.ty, b.tx, b.n_tiles) for b in shards] == [(8, 16, 8)] * 4
    # the shards' lists are the full frame's, tile by tile
    starts = full.tile_start.numpy()
    for i, b in enumerate(shards):
        for t in range(b.n_tiles):
            g = i * b.n_tiles + t
            np.testing.assert_array_equal(
                b.tri_id[b.tile_start[t]:b.tile_start[t + 1]].numpy(),
                full.tri_id[starts[g]:starts[g + 1]].numpy())
    calls = []
    plain = swraster.raster_closest_hit_plain
    monkeypatch.setattr(swraster, "raster_closest_hit_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    ref = _unsharded(sess, frame, accum, raster=full)
    assert len(calls) == 1
    step = M.make_sharded_step(mesh, sess.settings, W, H)
    got = M.gather_shards(mesh, step(
        sess.scene, sess.bvh, M.shard_accum(mesh, accum), sess.sky_cube,
        frame, raster=shards, **_engines(sess)))
    assert len(calls) == 5  # every shard took its bins
    assert torch.equal(got, ref)
    assert torch.equal(ref, _unsharded(sess, frame, accum))


def test_sample_and_grid_steps_equal_sequential_samples(box):
    sess = box
    s, e = sess.settings, _engines(sess)
    seq = torch.zeros((H, W, 3))
    for i in range(8):
        seq = _unsharded(sess, sess.frame_constants(i), seq)
    smesh = M.make_render_mesh(CPU4, axis_name="samples")
    sstep = M.make_sample_parallel_step(smesh, s, W, H)
    acc = M.shard_accum(smesh, torch.zeros((4, H, W, 3)),
                        axis_name="samples")
    for i in range(2):
        acc = sstep(sess.scene, sess.bvh, acc, sess.sky_cube,
                    sess.frame_constants(i), ray_bvh=e["ray_bvh"],
                    sun_grid=e["sun_grid"])
    img = M.sample_parallel_image(M.gather_shards(smesh, acc))
    np.testing.assert_allclose(img.numpy(), seq.numpy(), rtol=1e-4,
                               atol=1e-4)
    seq4 = torch.zeros((H, W, 3))
    for i in range(4):
        seq4 = _unsharded(sess, sess.frame_constants(i), seq4)
    gmesh = M.RenderMesh([CPU4[:2], CPU4[2:]], ("samples", "rows"))
    gstep = M.make_grid_step(gmesh, s, W, H)
    gacc = M.shard_accum(gmesh, torch.zeros((2, H, W, 3)),
                         axis_name="samples")
    for i in range(2):
        gacc = gstep(sess.scene, sess.bvh, gacc, sess.sky_cube,
                     sess.frame_constants(i), ray_bvh=e["ray_bvh"],
                     sun_grid=e["sun_grid"])
    gimg = M.sample_parallel_image(M.gather_shards(gmesh, gacc))
    np.testing.assert_allclose(gimg.numpy(), seq4.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_sharded_bake_equals_the_baker(box):
    baker = Baker(box, resolution=SQ, atlas_mode="pair")
    maps = baker.surface_maps
    frame = box.frame_constants(box.sample_idx)
    grid = box.update_sun_grid()
    baker.bake_step()
    baker.bake_step()
    mesh = M.make_render_mesh(CPU4)
    step = M.make_sharded_bake_step(mesh, box.settings, SQ)
    acc = M.shard_accum(mesh, torch.zeros((SQ, SQ, 4)))
    pos, nrm = (M.shard_accum(mesh, maps[k]) for k in ("position", "normal"))
    for i in range(2):
        acc = step(box.scene, box.bvh_ray, acc, box.sky_cube, frame, pos,
                   nrm, i, sun_grid=grid, proxy=box.proxy)
    got = M.gather_shards(mesh, acc)
    assert float(got[..., 3].sum()) > 0
    assert torch.equal(got, baker.accum)


def test_mesh_rules():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            M.make_render_mesh()
    mesh = M.make_render_mesh(["cpu"] * 3)
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert mesh.shape == {"rows": 3} and mesh.flat() == list(mesh.devices)
    s = AppSettings()
    with pytest.raises(ValueError, match="does not divide"):
        M.make_sharded_step(mesh, s, 128, 32)
    with pytest.raises(ValueError, match="does not divide"):
        M.make_sharded_bake_step(mesh, s, 32)
    with pytest.raises(ValueError, match="does not divide"):
        M.make_grid_step(M.RenderMesh([["cpu"] * 3] * 2,
                                      ("samples", "rows")), s, 32, 32)
    with pytest.raises(ValueError):
        M.make_grid_step(mesh, s, 32, 33)  # a 1-D mesh
    with pytest.raises(ValueError):
        M.RenderMesh(["cpu", "cpu"], ("rows", "rows"))
    img = torch.arange(6 * 4 * 3, dtype=torch.float32).reshape(6, 4, 3)
    parts = M.shard_accum(mesh, img)
    assert [tuple(p.shape) for p in parts] == [(2, 4, 3)] * 3
    assert torch.equal(M.gather_shards(mesh, parts), img)
