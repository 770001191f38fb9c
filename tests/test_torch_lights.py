"""Port parity: spot-light NEE of dxrpathtracer_tpu_torch against dxrpathtracer_tpu.

  - `make_spot_lights` arrays equal the JAX package's; `smoothstep` equals
    JAX's on seeded inputs.
  - BoxTest lit by the spot light of tests/test_session.py (sun and sky off,
    path length 2, sqrt_num_samples 2, 4 samples at 24x24), and the tiny
    alpha scene lit by the sun and two spot lights (path length 3, 2 samples
    at 32x32): the JAX package builds the scene, its tables, the sky cube and
    the frame constants and renders; the same arrays go through convert.py
    into the port's render_sample. Relative RMSE (scaled by max|ref|)
    <= 1e-4, as the opaque frame of tests/test_torch_render.py. With
    render_lights off, the spot-only BoxTest frame is black.
The JAX side runs in a subprocess whose XLA:CPU emits no FMA (ISA capped at
AVX), as in tests/test_torch_render.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from dxrpathtracer_tpu.core.math3 import smoothstep as jsmoothstep  # noqa: E402
from dxrpathtracer_tpu.scene.types import make_spot_lights as jmake_lights  # noqa: E402
from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes  # noqa: E402
from dxrpathtracer_tpu_torch.convert import (bvh_from_numpy, frame_from_numpy,  # noqa: E402
                                             scene_from_reference_arrays)
from dxrpathtracer_tpu_torch.core.math3 import smoothstep  # noqa: E402
from dxrpathtracer_tpu_torch.render.integrator import render_sample  # noqa: E402
from dxrpathtracer_tpu_torch.scene.types import (LIGHT_ARRAYS,  # noqa: E402
                                                 MAX_SPOT_LIGHTS,
                                                 make_spot_lights)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the spot light of tests/test_session.py::test_spot_light_nee
BOX_LIGHT = dict(positions=[[3.0, 4.0, 0.0]], directions=[[0.0, 1.0, 0.0]],
                 intensities=[[50.0, 25.0, 10.0]],
                 angular_attenuation=[[0.6, 1.2]])
# two lights over the tiny alpha scene's cards, pointing down
TINY_LIGHTS = dict(positions=[[-1.0, 3.0, 0.5], [1.5, 2.5, -0.5]],
                   directions=[[0.0, 1.0, 0.0], [0.3, 0.95, 0.0]],
                   intensities=[[40.0, 35.0, 30.0], [10.0, 20.0, 30.0]],
                   angular_attenuation=[[0.5, 1.1], [0.8, 1.4]])

_FRAME = ("inv_view_projection", "camera_pos_ws", "sun_direction_ws",
          "sun_irradiance", "sun_render_color", "cos_sun_angular_radius",
          "sin_sun_angular_radius", "curr_sample_idx")

CASES = {  # key: (width, height, samples, settings)
    "box": (24, 24, 4, dict(current_scene=Scenes.BoxTest, sqrt_num_samples=2,
                            enable_sun=False, enable_sky=False,
                            max_path_length=2)),
    "tiny": (32, 32, 2, dict(current_scene=Scenes.Sponza, sqrt_num_samples=2,
                             max_path_length=3)),
}

_SCRIPT = r"""
import dataclasses
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from dxrpathtracer_tpu.app.session import RenderSession
from dxrpathtracer_tpu.app.settings import AppSettings, Scenes
from dxrpathtracer_tpu.scene import registry as jreg
from dxrpathtracer_tpu.scene.types import make_spot_lights
from dxrpathtracer_tpu_torch.convert import reference_scene_arrays

frame_fields, cases, lights = %r, %r, %r
out = {}
for key, (w, h, samples, kw) in cases.items():
    if key == "box":
        scene, preset = jreg.load_scene(Scenes.BoxTest)
    else:
        scene, preset = jreg.tiny_alpha_scene()
    scene = dataclasses.replace(scene, lights=make_spot_lights(**lights[key]))
    kw = dict(kw, current_scene=Scenes(kw["current_scene"]))
    settings = AppSettings(enable_sunspace_shadows=False,
                           enable_dense_proxy=False, enable_clear_cut=False,
                           enable_sw_raster=False, **kw)
    sess = RenderSession(settings=settings, width=w, height=h, scene=scene,
                         preset=preset)
    sess.settings = settings  # the preset resets the sun direction only
    for k, v in reference_scene_arrays(scene).items():
        out[key + "__scene__" + k] = v
    for name, b in (("w8", sess.bvh), ("w32", sess.bvh_ray)):
        out["%%s__%%s__table" %% (key, name)] = np.asarray(b.table)
        out["%%s__%%s__const" %% (key, name)] = np.asarray(
            [b.num_rows, b.max_depth, b.root_code, b.width,
             b.has_alpha_flags])
    out[key + "__sky"] = sess.sky.cubemap
    for i in range(samples):
        f = sess.frame_constants(i)
        for k in frame_fields:
            out["%%s__frame%%d__%%s" %% (key, i, k)] = np.asarray(getattr(f, k))
    out[key + "__image"] = np.asarray(
        sess.render_to_completion(max_samples=samples))
np.savez(sys.argv[2], **out)
""" % (_FRAME, {k: (w, h, n, dict(kw, current_scene=int(kw["current_scene"])))
                for k, (w, h, n, kw) in CASES.items()},
       {"box": BOX_LIGHT, "tiny": TINY_LIGHTS})


def test_make_spot_lights_matches_jax():
    for kw in ({}, BOX_LIGHT, TINY_LIGHTS):
        got, want = make_spot_lights(**kw), jmake_lights(**kw)
        assert got.num_lights == want.num_lights
        for k in LIGHT_ARRAYS:
            g, w = getattr(got, k).numpy(), np.asarray(getattr(want, k))
            assert g.shape[0] == MAX_SPOT_LIGHTS
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), k


def test_smoothstep_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.2, 1.2, 4096).astype(np.float32)
    e0, e1 = np.float32(0.3623577), np.float32(0.9553365)
    got = smoothstep(torch.tensor(e0), torch.tensor(e1), torch.from_numpy(x))
    want = np.asarray(jsmoothstep(jnp.float32(e0), jnp.float32(e1),
                                  jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0).any() and (want == 1).any()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lights")
    out = tmp / "out.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    env.pop("DXRPT_PALLAS_BODY", None)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, "-", str(out)],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


def _render(ref, key, **overrides):
    w, h, samples, kw = CASES[key]
    pre = key + "__scene__"
    scene = scene_from_reference_arrays(
        {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)})
    tables = {}
    for name in ("w8", "w32"):
        rows, depth, root, width, flags = (
            int(v) for v in ref[f"{key}__{name}__const"])
        tables[name] = bvh_from_numpy(ref[f"{key}__{name}__table"], rows,
                                      depth, root, width, bool(flags))
    settings = AppSettings(**dict(kw, **overrides))
    sky = torch.from_numpy(ref[key + "__sky"])
    accum = torch.zeros((h, w, 3))
    for i in range(samples):
        frame = frame_from_numpy(*(ref[f"{key}__frame{i}__{k}"]
                                   for k in _FRAME))
        accum = render_sample(scene, tables["w8"], tables["w32"], sky,
                              settings, frame, w, h, accum)
    return scene, accum.numpy()


@pytest.mark.parametrize("key", ["box", "tiny"])
def test_spot_lit_frame_matches_jax(reference, key):
    scene, img = _render(reference, key)
    assert scene.num_lights == len(
        (BOX_LIGHT if key == "box" else TINY_LIGHTS)["positions"])
    ref = reference[key + "__image"]
    assert np.isfinite(img).all() and img.shape == ref.shape
    assert img.max() > 0.0
    err = float(np.sqrt(np.mean((img - ref) ** 2)) / (np.abs(ref).max() + 1e-9))
    print(f"{key}: spot-lit frame rel RMSE vs JAX {err:.3e}, "
          f"{np.mean(img == ref):.4f} of values bit-equal")
    assert err <= 1e-4


def test_spot_only_frame_is_black_without_lights(reference):
    """Sun and sky off: all the light is the spot's (RenderLights=off)."""
    _, img = _render(reference, "box", render_lights=False)
    assert np.isfinite(img).all() and float(np.abs(img).max()) == 0.0
