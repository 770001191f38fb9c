"""Port parity: scene import (scene/fbx.py, the registry's FBX route,
scene/cache.py) against dxrpathtracer_tpu, on files written by
dxrpathtracer_tpu_torch/tools/fbx_cases.py (the repository has no FBX or DDS
file).

  - The same FBX bytes parse to byte-equal meshes, spot lights and
    texture-name tables in both packages: triangles and quads, normals by
    polygon vertex, UVs by index, a light under a parent model with its own
    translation, rotation and scaling, a light that is not a spot, arrays
    raw and zlib-compressed.
  - The full route (materials' DDS and PNG textures, an empty texture name
    and the directory-keyword fallback, roughness_bindings.json,
    has_opacity, the spot lights' -direction and x2500 intensity) gives the
    JAX package's scene arrays and lights byte for byte.
  - A corrupt FBX warns and falls back to the stand-in; strict raises. A
    texture that fails to decode warns and its load is not cached.
  - The cache round trip is bit-identical, a hit equals a fresh parse, a
    corrupt entry warns and is parsed again, a loader-version bump misses,
    and the port never reads an entry the JAX package wrote (in a process
    where every import of jax fails).
  - The Stronghold scene without its asset is the JAX package's Sponza-class
    stand-in, byte for byte, and `render --current-scene Stronghold` runs.

Every test's scene cache (DXRPT_SCENE_CACHE) is a temporary directory.
"""

import dataclasses
import json
import logging
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

torch = pytest.importorskip("torch")

from dxrpathtracer_tpu.scene import cache as jcache  # noqa: E402
from dxrpathtracer_tpu.scene import fbx as jfbx  # noqa: E402
from dxrpathtracer_tpu.scene import registry as jreg  # noqa: E402
from dxrpathtracer_tpu_torch.app.settings import Scenes  # noqa: E402
from dxrpathtracer_tpu_torch.scene import cache as tcache  # noqa: E402
from dxrpathtracer_tpu_torch.scene import fbx as tfbx  # noqa: E402
from dxrpathtracer_tpu_torch.scene import registry as treg  # noqa: E402
from dxrpathtracer_tpu_torch.scene.types import (LIGHT_ARRAYS,  # noqa: E402
                                                 SCENE_ARRAYS)
from dxrpathtracer_tpu_torch.tools import fbx_cases  # noqa: E402
from test_torch_host import jax_scene_arrays  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESET = treg.PRESETS[Scenes.Sponza]   # its FBX path and texture directory


@pytest.fixture(autouse=True)
def scene_cache(tmp_path, monkeypatch):
    """Each test's own cache directory (nothing goes under ~/.cache)."""
    d = tmp_path / "scene_cache"
    monkeypatch.setenv("DXRPT_SCENE_CACHE", str(d))
    return d


def _quad_mesh(rng):
    """A box of 4 quads and 4 triangles; UVs by index into 6 values."""
    pts = np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1],
                    [-1, 2, -1], [1, 2, -1], [1, 2, 1], [-1, 2, 1],
                    [0, 3, 0]], np.float64) * 50.0
    polys = [(0, 1, 2, 3), (0, 4, 5, 1), (1, 5, 6, 2), (2, 6, 7, 3),
             (4, 8, 5), (5, 8, 6), (6, 8, 7), (7, 8, 4)]
    pv = sum(len(p) for p in polys)
    normals = rng.normal(size=(pv, 3))
    uvs = rng.uniform(0, 1, (6, 2))
    return dict(positions=pts, polygons=polys, normals=normals, uvs=uvs,
                uv_index=rng.integers(0, 6, pv))


def _tri_mesh(rng, n=20):
    pts = rng.uniform(-100, 100, (3 * n, 3))
    polys = [(3 * i, 3 * i + 1, 3 * i + 2) for i in range(n)]
    return dict(positions=pts, polygons=polys,
                normals=rng.normal(size=(3 * n, 3)),
                uvs=rng.uniform(-1, 2, (3 * n, 2)))


def _write_asset(root, compress=True, bad_texture=False):
    """A small scene at the Sponza preset's FBX path under `root`: a box of
    quads and triangles (explicit albedo, roughness from the bindings), a
    triangle soup (empty albedo name: the keyword fallback), cards with an
    opacity map, two spot lights (one under a transformed parent) and a
    point light. Returns the FBX's path."""
    rng = np.random.default_rng(11)
    fbx = root / PRESET.fbx_path
    tex = fbx.parent / PRESET.texture_dir
    tex.mkdir(parents=True, exist_ok=True)
    fbx_cases.write_dds(tex / "wall_albedo.dds",
                        rng.integers(0, 256, (8, 4, 4), dtype=np.uint8),
                        srgb=True)
    fbx_cases.write_dds(tex / "wall_rough.dds",
                        rng.integers(0, 256, (4, 4, 4), dtype=np.uint8))
    mask = (treg.checker_mask(16, 4)[..., 0] * 255).astype(np.uint8)
    fbx_cases.write_dds(tex / "card_opacity.dds",
                        np.stack([mask] * 3 + [mask * 0 + 255], -1))
    from PIL import Image
    Image.fromarray(rng.integers(0, 256, (4, 8, 3), dtype=np.uint8)).save(
        tex / "wall_normal.png")
    if bad_texture:
        (tex / "wall_normal.png").write_bytes(b"\x89PNG\r\n\x1a\n broken")
    (tex / "roughness_bindings.json").write_text(
        json.dumps({"wall_albedo.dds": "wall_rough.dds"}))

    w = fbx_cases.SceneWriter(compress=compress)
    w.mesh(**_quad_mesh(rng), textures={"DiffuseColor": "wall_albedo.dds",
                                        "NormalMap": "wall_normal.png"})
    w.mesh(**_tri_mesh(rng), textures={"DiffuseColor": ""})
    parent = w.model(translation=(100.0, 50.0, -20.0),
                     rotation=(10.0, 30.0, -5.0), scaling=(2.0, 1.0, 0.5))
    w.mesh(**_tri_mesh(rng, 4), textures={"DiffuseColor": "wall_albedo.dds",
                                          "TransparentColor":
                                              "card_opacity.dds"},
           parent=parent)
    w.spot_light((10.0, 300.0, 40.0), rotation=(20.0, 0.0, 15.0),
                 color=(1.0, 0.5, 0.25), intensity=80.0, inner_deg=20.0,
                 outer_deg=50.0, scaling=(1.0, 2.0, 1.0), parent=parent)
    w.spot_light((-50.0, 250.0, 0.0), rotation=(-30.0, 45.0, 0.0))
    w.spot_light((0.0, 100.0, 0.0), light_type=0)  # a point light: skipped
    w.write(fbx)
    return fbx


def _jax_preset(fbx):
    return dataclasses.replace(jreg.PRESETS[jreg.Scenes.Sponza],
                               fbx_path=str(fbx))


def _same(got, want, name):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, name
    assert got.tobytes() == want.tobytes(), name


def _assert_scene_equals_jax(scene, jscene):
    want = jax_scene_arrays(jscene)
    for name in SCENE_ARRAYS:
        _same(getattr(scene, name), want[name], name)
    assert scene.num_lights == jscene.lights.num_lights
    for name in LIGHT_ARRAYS:
        _same(getattr(scene.lights, name), getattr(jscene.lights, name),
              f"lights.{name}")
    assert scene.any_opacity == bool(jscene.materials.any_opacity)


def _assert_scenes_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "lights":
            _assert_scenes_equal(x, y)
        elif isinstance(x, torch.Tensor):
            _same(x, y.numpy(), f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("compress", [False, True], ids=["raw", "zlib"])
def test_fbx_parse_byte_equal(tmp_path, compress):
    fbx = _write_asset(tmp_path, compress=compress)
    got = tfbx.load_fbx_scene(fbx, scene_scale=0.01)
    want = jfbx.load_fbx_scene(fbx, scene_scale=0.01)
    assert len(got.meshes) == len(want.meshes) == 3
    assert got.material_textures == want.material_textures
    assert got.material_textures[1] == {"albedo": ""}
    for gm, wm in zip(got.meshes, want.meshes):
        assert gm.material_idx == wm.material_idx
        for f in ("positions", "normals", "uvs", "tangents", "bitangents",
                  "indices"):
            _same(getattr(gm, f), getattr(wm, f), f)
    assert got.meshes[0].indices.size == 3 * (4 * 2 + 4)  # quads: 2 tris
    assert len(got.spot_lights) == len(want.spot_lights) == 2
    for gl, wl in zip(got.spot_lights, want.spot_lights):
        for f in dataclasses.fields(wl):
            _same(getattr(gl, f.name), getattr(wl, f.name), f.name)
    for gm, wm in zip(tfbx.load_fbx_meshes(fbx), jfbx.load_fbx_meshes(fbx)):
        _same(gm.positions, wm.positions, "load_fbx_meshes")


def test_fbx_route_byte_equal(tmp_path):
    fbx = _write_asset(tmp_path)
    scene = treg._load_fbx_scene_full(PRESET, tmp_path, strict=True)
    jscene = jreg._load_fbx_scene_full(_jax_preset(fbx), strict=True)
    _assert_scene_equals_jax(scene, jscene)
    assert scene.num_lights == 2 and scene.any_opacity
    # the keyword fallback bound an opacity map to every material, the
    # cards' own name too
    assert scene.has_opacity.tolist() == [True, True, True]
    # load_scene with the asset root: the same scene
    loaded, preset = treg.load_scene(Scenes.Sponza, strict=True,
                                     asset_root=tmp_path)
    assert preset is PRESET
    _assert_scenes_equal(loaded, scene)
    meshes = treg.load_scene_meshes(PRESET, strict=True, asset_root=tmp_path)
    jmeshes = jreg.load_scene_meshes(_jax_preset(fbx), strict=True)
    for gm, wm in zip(meshes, jmeshes, strict=True):
        _same(gm.positions, wm.positions, "load_scene_meshes")


def test_corrupt_fbx_warns_and_strict_raises(tmp_path, caplog, monkeypatch,
                                             scene_cache):
    preset = treg.PRESETS[Scenes.WhiteFurnace]
    bad = tmp_path / preset.fbx_path
    bad.parent.mkdir(parents=True)
    bad.write_bytes(b"Kaydara FBX Binary  \x00\x1a\x00" + b"\xde\xad" * 64)
    with caplog.at_level(logging.WARNING, logger=treg.log.name):
        scene, _ = treg.load_scene(Scenes.WhiteFurnace, strict=False,
                                   asset_root=tmp_path)
        meshes = treg.load_scene_meshes(preset, strict=False,
                                        asset_root=tmp_path)
    assert any("FBX" in r.message and "stand-in" in r.message
               for r in caplog.records)
    want = jreg.build_scene(jreg._white_furnace_standin_meshes())
    _assert_scene_equals_jax(scene, want)
    assert len(meshes) == 1
    assert not scene_cache.exists()
    with pytest.raises(Exception):
        treg.load_scene(Scenes.WhiteFurnace, strict=True, asset_root=tmp_path)
    with pytest.raises(Exception):
        treg.load_scene_meshes(preset, strict=True, asset_root=tmp_path)
    monkeypatch.setenv("DXRPT_STRICT_SCENE_LOAD", "1")
    with pytest.raises(Exception):
        treg.load_scene(Scenes.WhiteFurnace, asset_root=tmp_path)


def test_degraded_load_is_not_cached(tmp_path, caplog, scene_cache):
    _write_asset(tmp_path, bad_texture=True)
    with caplog.at_level(logging.WARNING, logger=treg.log.name):
        scene, _ = treg.load_scene(Scenes.Sponza, asset_root=tmp_path)
    assert any("texture decode failed" in r.message for r in caplog.records)
    assert scene.num_triangles == 12 + 20 + 4
    assert not list(scene_cache.glob("*.npz"))
    with pytest.raises(Exception):
        treg.load_scene(Scenes.Sponza, strict=True, asset_root=tmp_path)


def test_cache_roundtrip_hit_corrupt_and_version(tmp_path, caplog,
                                                 monkeypatch, scene_cache):
    # round trip of a scene with bool, int32 and float leaves, bit for bit
    box, _ = treg.load_scene(Scenes.BoxTest)
    tcache.save_pytree(str(tmp_path / "box.npz"), box)
    back = tcache.load_pytree(str(tmp_path / "box.npz"))
    assert type(back) is type(box) and back.has_opacity.dtype == torch.bool
    _assert_scenes_equal(back, box)

    _write_asset(tmp_path)
    fresh, _ = treg.load_scene(Scenes.Sponza, asset_root=tmp_path)
    (entry,) = scene_cache.glob("*.npz")
    hit, _ = treg.load_scene(Scenes.Sponza, asset_root=tmp_path)
    assert hit is not fresh
    _assert_scenes_equal(hit, fresh)

    entry.write_bytes(b"not an npz at all")
    with caplog.at_level(logging.WARNING, logger=tcache.log.name):
        again, _ = treg.load_scene(Scenes.Sponza, asset_root=tmp_path)
    assert any("unreadable" in r.message for r in caplog.records)
    _assert_scenes_equal(again, fresh)

    monkeypatch.setattr(tcache, "LOADER_VERSION", tcache.LOADER_VERSION + 1)
    treg.load_scene(Scenes.Sponza, asset_root=tmp_path)
    assert len(list(scene_cache.glob("*.npz"))) == 2


_FOREIGN_ENTRY = r"""
import logging, sys
sys.modules["jax"] = None
sys.modules["dxrpathtracer_tpu"] = None
logging.basicConfig(level=logging.WARNING, stream=sys.stdout)
from dxrpathtracer_tpu_torch.app.settings import Scenes
from dxrpathtracer_tpu_torch.scene import cache, registry
root = sys.argv[1]
scene, _ = registry.load_scene(Scenes.Sponza, strict=True, asset_root=root)
fresh = registry._load_fbx_scene_full(registry.PRESETS[Scenes.Sponza], root)
for name in ("tri_shade", "texels", "packed_meta"):
    assert getattr(scene, name).equal(getattr(fresh, name)), name
hit, _ = registry.load_scene(Scenes.Sponza, strict=True, asset_root=root)
assert hit.tri_shade.equal(fresh.tri_shade)
bad = [m for m, mod in sys.modules.items() if mod is not None and
       m.split(".")[0] in ("jax", "jaxlib", "dxrpathtracer_tpu")]
assert not bad, bad
print("ok")
"""


def test_port_never_reads_jax_entry(tmp_path, scene_cache):
    """The JAX package's entry for the same FBX, in the same directory, is
    not the port's: it lies under another key, and copied to the port's key
    it is unreadable (it names the JAX package's classes) and parsed again,
    with every import of jax failing."""
    fbx = _write_asset(tmp_path)
    jpreset = _jax_preset(fbx)
    jcache.store_cached_scene(str(fbx), jpreset,
                              jreg._load_fbx_scene_full(jpreset))
    (jentry,) = scene_cache.glob("*.npz")
    port_entry = tcache.cache_path(str(fbx), PRESET)
    assert os.path.basename(port_entry) != jentry.name
    shutil.copy(jentry, port_entry)
    proc = subprocess.run([sys.executable, "-c", _FOREIGN_ENTRY,
                           str(tmp_path)], cwd=REPO, capture_output=True,
                          text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("ok")
    assert "scene cache entry unreadable" in proc.stdout
    assert "not one of the port's scene types" in proc.stdout


def test_stronghold_falls_back_to_the_jax_standin(tmp_path):
    scene, preset = treg.load_scene(Scenes.Stronghold)
    jscene, jpreset = jreg.load_scene(jreg.Scenes.Stronghold)
    _assert_scene_equals_jax(scene, jscene)
    assert preset.name == jpreset.name == "Stronghold"
    assert dataclasses.astuple(preset)[2:] == dataclasses.astuple(jpreset)[2:]
    from dxrpathtracer_tpu_torch.app.cli import main
    out = tmp_path / "stronghold.png"
    main(["render", "--current-scene", "Stronghold", "--width", "16",
          "--height", "16", "--sqrt-num-samples", "1", "--output", str(out),
          "--device", "cpu"])
    assert out.stat().st_size > 100
