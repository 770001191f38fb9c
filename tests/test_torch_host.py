"""Port parity: the host layer of dxrpathtracer_tpu_torch (numpy scene build,
native BVH build, sky cache) against dxrpathtracer_tpu, and the port's
independence from JAX.

The host layer is a numpy copy of the JAX package's, so its outputs must be
byte-equal: scene arrays, W8 and W32 BVH tables with their constants. The
sky cache must agree within rtol 1e-6.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dxrpathtracer_tpu.accel.lbvh import build_bvh_for_scene as jbuild_bvh  # noqa: E402
from dxrpathtracer_tpu.scene import procedural as jproc  # noqa: E402
from dxrpathtracer_tpu.scene import registry as jreg  # noqa: E402
from dxrpathtracer_tpu.scene.build import build_scene as jbuild_scene  # noqa: E402
from dxrpathtracer_tpu.sky.skycache import SkyCache as JSkyCache  # noqa: E402
from dxrpathtracer_tpu_torch.accel.bvh import build_bvh_for_scene  # noqa: E402
from dxrpathtracer_tpu_torch.convert import scene_from_numpy  # noqa: E402
from dxrpathtracer_tpu_torch.scene import procedural as tproc  # noqa: E402
from dxrpathtracer_tpu_torch.scene import registry as treg  # noqa: E402
from dxrpathtracer_tpu_torch.scene.build import build_scene  # noqa: E402
from dxrpathtracer_tpu_torch.scene.types import SCENE_ARRAYS  # noqa: E402
from dxrpathtracer_tpu_torch.sky.skycache import SkyCache  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_scene_arrays(scene) -> dict:
    """The JAX package's Scene (host leaves) as the port's named arrays."""
    return dict(
        positions=scene.positions, normals=scene.normals, uvs=scene.uvs,
        tangents=scene.tangents, bitangents=scene.bitangents,
        tri_idx=scene.tri_idx, tri_material=scene.tri_material,
        tri_shade=scene.tri_shade, texels=scene.textures.texels,
        texture_meta=scene.textures.meta,
        packed_meta=scene.materials.packed_meta,
        has_opacity=scene.materials.has_opacity)


_SCENES = {
    "BoxTest": (lambda: jproc.box_test_meshes(),
                lambda: tproc.box_test_meshes()),
    "Sponza20k": (lambda: jreg._sponza_standin_meshes(target_tris=20_000),
                  lambda: treg._sponza_standin_meshes(target_tris=20_000)),
}


@pytest.fixture(scope="module", params=sorted(_SCENES))
def scenes(request):
    jmeshes, tmeshes = _SCENES[request.param]
    return jbuild_scene(jmeshes()), build_scene(tmeshes())


def _assert_bytes_equal(got, want, name):
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, name
    assert got.tobytes() == want.tobytes(), name


def test_scene_arrays_byte_equal(scenes):
    jscene, scene = scenes
    want = jax_scene_arrays(jscene)
    for name in SCENE_ARRAYS:
        _assert_bytes_equal(getattr(scene, name).numpy(), want[name], name)
    # the same arrays, carried across by convert.py
    carried = scene_from_numpy({k: np.asarray(v) for k, v in want.items()})
    for name in SCENE_ARRAYS:
        _assert_bytes_equal(getattr(carried, name).numpy(), want[name], name)


@pytest.mark.parametrize("width", [8, 32])
def test_bvh_tables_byte_equal(scenes, width):
    jscene, scene = scenes
    want = jbuild_bvh(jscene, width=width)
    got = build_bvh_for_scene(scene, width=width)
    _assert_bytes_equal(got.table.numpy(), want.table, f"W{width} table")
    assert (got.num_rows, got.max_depth, got.root_code, got.width) == \
        (want.num_rows, want.max_depth, want.root_code, want.width)


@pytest.mark.parametrize("sun,albedo,turbidity", [
    ((0.26, 0.987, -0.16), (0.25, 0.25, 0.25), 2.0),
    ((-0.133022308, 0.642787635, 0.75440651), (0.1, 0.3, 0.5), 4.5),
])
def test_sky_cache_matches(sun, albedo, turbidity):
    args = (np.asarray(sun, np.float32), 1.0, np.asarray(albedo, np.float32),
            turbidity)
    want, got = JSkyCache(), SkyCache()
    want.update(*args)
    got.update(*args)
    for name in ("cubemap", "sun_irradiance", "sun_render_color"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-6, atol=0, err_msg=name)
    assert got.model_name == want.model_name == "hosek"


def test_renders_with_jax_blocked():
    """`import dxrpathtracer_tpu_torch` and a BoxTest frame with every
    import of jax made to fail."""
    script = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import dxrpathtracer_tpu_torch\n"
        "from dxrpathtracer_tpu_torch.app.session import RenderSession\n"
        "from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes\n"
        "s = RenderSession(AppSettings(current_scene=Scenes.BoxTest), 16, 16,"
        " device='cpu')\n"
        "assert s.render_frame()\n"
        "assert s.accum.shape == (16, 16, 3) and bool(s.accum.isfinite().all())\n"
        "assert float(s.accum.mean()) > 0\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None and"
        " m.split('.')[0] in"
        " ('jax', 'jaxlib', 'dxrpathtracer_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("ok")
