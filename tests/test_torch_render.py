"""Port parity: the whole path-traced frame of dxrpathtracer_tpu_torch.

  - BoxTest at 32x32, path length 3, sqrt_num_samples=2, 2 samples: the JAX
    package builds the scene, both BVH tables, the sky cube and the frame
    constants and renders its frame; the very same arrays go through
    convert.py into the port's render_sample. Relative RMSE (scaled by
    max|ref|) <= 1e-4.
  - The port's own RenderSession on the Sponza-class stand-in at 64x64,
    sqrt_num_samples=2, 4 samples, against the independent oracle image
    tests/oracle/sponza_64_4.npy within the oracle test's 1e-2 budget
    (tests/test_oracle.py); the value reached is printed.
  - The JAX package's goldens, with the bounds of tests/test_golden.py, at
    sqrt_num_samples=2: BoxTest 32x32 `render_to_completion` against
    golden_boxtest_32.npy (RMSE < 1e-4), and the Sponza stand-in 48x27
    against golden_sponza_48x27.npy (RMSE < 1e-3). That golden was recorded
    by XLA:CPU with FMA contraction, which bends a few paths onto other
    surfaces: the JAX package itself, run without FMA, misses it by an RMSE
    of 4.95e-2 in 8 of 1296 pixels. So the port is held to the JAX package
    without FMA on the same frame (RMSE < 1e-4), and to the golden at its
    bound on every pixel where the JAX package without FMA meets the golden
    within 1e-3 (all but at most 1 % of them).

The JAX side runs in a subprocess whose XLA:CPU emits no FMA (ISA capped at
AVX), so it rounds every product as the port's plain version does; its
sun-space grid, dense proxy, AABB cut and software raster are off, its
packets on (they return the per-ray hits).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dxrpathtracer_tpu_torch.app.session import RenderSession  # noqa: E402
from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes  # noqa: E402
from dxrpathtracer_tpu_torch.convert import (bvh_from_numpy, frame_from_numpy,  # noqa: E402
                                             scene_from_numpy)
from dxrpathtracer_tpu_torch.render.integrator import raygen, render_sample  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, SAMPLES = 32, 2

_FRAME = ("inv_view_projection", "camera_pos_ws", "sun_direction_ws",
          "sun_irradiance", "sun_render_color", "cos_sun_angular_radius",
          "sin_sun_angular_radius", "curr_sample_idx")

_SCRIPT = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from dxrpathtracer_tpu.app.session import RenderSession
from dxrpathtracer_tpu.app.settings import AppSettings, Scenes

res, samples = %d, %d
frame_fields = %r
s = AppSettings(current_scene=Scenes.BoxTest, sqrt_num_samples=2,
                max_path_length=3, enable_sunspace_shadows=False,
                enable_dense_proxy=False, enable_clear_cut=False,
                enable_sw_raster=False)
sess = RenderSession(settings=s, width=res, height=res)
sc = sess.scene_host
out = dict(
    positions=sc.positions, normals=sc.normals, uvs=sc.uvs,
    tangents=sc.tangents, bitangents=sc.bitangents, tri_idx=sc.tri_idx,
    tri_material=sc.tri_material, tri_shade=sc.tri_shade,
    texels=sc.textures.texels, texture_meta=sc.textures.meta,
    packed_meta=sc.materials.packed_meta,
    has_opacity=sc.materials.has_opacity,
    sky_cube=sess.sky.cubemap)
for name, b in (("bvh", sess.bvh), ("ray_bvh", sess.bvh_ray)):
    out[name + "__table"] = np.asarray(b.table)
    out[name + "__const"] = np.asarray(
        [b.num_rows, b.max_depth, b.root_code, b.width, b.has_alpha_flags])
for i in range(samples):
    f = sess.frame_constants(i)
    for k in frame_fields:
        out["frame%%d__%%s" %% (i, k)] = np.asarray(getattr(f, k))
from dxrpathtracer_tpu.render.integrator import raygen
rays = raygen(sess.settings, sess.frame_constants(1), res, res)
for k, a in zip(("ray_start", "ray_dir", "ray_len", "pixel_idx"), rays):
    out["raygen__" + k] = np.asarray(a)
out["image"] = np.asarray(sess.render_to_completion(max_samples=samples))
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
""" % (RES, SAMPLES, _FRAME)


def _rel_rmse(img, ref):
    return float(np.sqrt(np.mean((img - ref) ** 2)) / (np.abs(ref).max() + 1e-9))


def test_boxtest_frame_matches_jax(tmp_path):
    out = tmp_path / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    env.pop("DXRPT_PALLAS_BODY", None)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, "-", str(out)],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = dict(np.load(out))

    scene = scene_from_numpy(ref)
    tables = {}
    for name in ("bvh", "ray_bvh"):
        rows, depth, root, width, alpha = (int(v) for v in ref[name + "__const"])
        tables[name] = bvh_from_numpy(ref[name + "__table"], rows, depth, root,
                                      width, bool(alpha))
    assert (tables["bvh"].width, tables["ray_bvh"].width) == (8, 32)
    settings = AppSettings(current_scene=Scenes.BoxTest, sqrt_num_samples=2,
                           max_path_length=3)
    sky = torch.from_numpy(ref["sky_cube"])
    frame1 = frame_from_numpy(*(ref[f"frame1__{k}"] for k in _FRAME))
    for k, got in zip(("ray_start", "ray_dir", "ray_len", "pixel_idx"),
                      raygen(settings, frame1, RES, RES, "cpu")):
        np.testing.assert_array_equal(got.numpy(), ref["raygen__" + k],
                                      err_msg=k)  # bit-equal primaries
    accum = torch.zeros((RES, RES, 3))
    for i in range(SAMPLES):
        frame = frame_from_numpy(*(ref[f"frame{i}__{k}"] for k in _FRAME))
        assert frame.curr_sample_idx == i
        accum = render_sample(scene, tables["bvh"], tables["ray_bvh"], sky,
                              settings, frame, RES, RES, accum)
    img = accum.numpy()
    assert np.isfinite(img).all() and img.shape == (RES, RES, 3)
    err = _rel_rmse(img, ref["image"])
    print(f"BoxTest {RES}x{RES}x{SAMPLES}: rel RMSE vs JAX {err:.3e}, "
          f"{np.mean(img == ref['image']):.4f} of values bit-equal")
    assert err <= 1e-4


def test_sponza_standin_matches_oracle():
    ref = np.load(os.path.join(REPO, "tests", "oracle", "sponza_64_4.npy"))
    sess = RenderSession(AppSettings(current_scene=Scenes.Sponza,
                                     sqrt_num_samples=2), 64, 64,
                         device="cpu")
    img = sess.render_to_completion(max_samples=4).numpy()
    assert np.isfinite(img).all()
    err = _rel_rmse(img, ref)
    print(f"Sponza stand-in 64x64x4: rel RMSE vs oracle {err:.3e}")
    assert err < 1e-2


def test_session_restarts_on_settings_and_camera_change():
    sess = RenderSession(AppSettings(current_scene=Scenes.BoxTest,
                                     sqrt_num_samples=1), 8, 8, device="cpu")
    assert sess.render_frame() and sess.render_frame() is False  # 1 sample
    assert sess.render_frame(force=True) and sess.sample_idx == 2
    sess.settings = sess.settings.replace(sun_size=2.0)
    assert sess.render_frame() and sess.sample_idx == 1
    sess.camera.set_position((0.0, 3.0, -9.0))
    assert sess.render_frame() and sess.sample_idx == 1
    assert bool(sess.accum.isfinite().all())


def _golden_render(scene, size):
    sess = RenderSession(AppSettings(current_scene=scene, sqrt_num_samples=2),
                         *size, device="cpu")
    return sess.render_to_completion().numpy()


def _rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)))


def test_boxtest_golden_image():
    img = _golden_render(Scenes.BoxTest, (32, 32))
    golden = np.load(os.path.join(REPO, "tests", "golden_boxtest_32.npy"))
    assert img.shape == golden.shape
    print(f"BoxTest golden: RMSE {_rmse(img, golden):.3e}")
    assert _rmse(img, golden) < 1e-4


_GOLDEN_SCRIPT = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from dxrpathtracer_tpu.app.session import RenderSession
from dxrpathtracer_tpu.app.settings import AppSettings, Scenes
sess = RenderSession(
    settings=AppSettings(current_scene=Scenes.Sponza, sqrt_num_samples=2),
    width=48, height=27)
np.save(sys.argv[2], np.asarray(sess.render_to_completion()))
"""


def test_sponza_golden_image(tmp_path):
    out = tmp_path / "nofma.npy"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    env.pop("DXRPT_PALLAS_BODY", None)
    proc = subprocess.run([sys.executable, "-c", _GOLDEN_SCRIPT, "-",
                           str(out)], env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    nofma = np.load(out)
    img = _golden_render(Scenes.Sponza, (48, 27))
    golden = np.load(os.path.join(REPO, "tests", "golden_sponza_48x27.npy"))
    assert img.shape == nofma.shape == golden.shape
    assert _rmse(img, nofma) < 1e-4
    kept = np.abs(nofma - golden).max(-1) <= 1e-3
    print(f"Sponza golden: RMSE {_rmse(img, golden):.3e} over all pixels "
          f"(JAX without FMA {_rmse(nofma, golden):.3e}), "
          f"{_rmse(img[kept], golden[kept]):.3e} over the {kept.sum()} of "
          f"{kept.size} where JAX without FMA meets it; port vs JAX without "
          f"FMA {_rmse(img, nofma):.3e}")
    assert kept.mean() >= 0.99
    assert _rmse(img[kept], golden[kept]) < 1e-3
