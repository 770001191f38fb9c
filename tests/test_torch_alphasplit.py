"""Port parity: scene/alphasplit.py of dxrpathtracer_tpu_torch (the load-time
subdivision of alpha-tested triangles) against dxrpathtracer_tpu.

  - `split_alpha_meshes` and its classifier: the meshes (every attribute,
    bit for bit, and each material index), the materials and the stats
    equal to the JAX package's on one unit card bound to an all-opaque
    mask, an all-transparent one and a 256x256 checker of 128-texel cells
    at level 3 (which gives all three classes: pieces dropped, moved to
    the opaque clone and kept alpha-tested), and the classifier's verdicts
    on seeded boxes, wrapped ones included.
  - The split and unsplit card give the same accepted hits under the
    port's alpha walk (the in-walk test of the plain per-ray walk): the
    port's counterpart of tests/test_alphasplit.py's dense-grid test,
    whose 16-texel fallback checker drops nothing at level 3.
  - The switches: DXRPT_ALPHA_SPLIT and DXRPT_ALPHA_SPLIT_LEVEL in the
    scene cache's key; the registry's SunTemple stand-in (foliage maps
    written under an asset root) and alpha stand-in split where
    DXRPT_ALPHA_SPLIT is "1", as `split_alpha_meshes` does, and not
    otherwise.
The JAX functions here are host numpy; they run in this process.
"""

import dataclasses

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

torch = pytest.importorskip("torch")

from dxrpathtracer_tpu.scene import alphasplit as jsplit  # noqa: E402
from dxrpathtracer_tpu.scene import procedural as jproc  # noqa: E402
from dxrpathtracer_tpu.scene import textures as jtex  # noqa: E402
from dxrpathtracer_tpu_torch.accel.bvh import build_bvh_for_scene  # noqa: E402
from dxrpathtracer_tpu_torch.accel.traverse import traverse_plain, safe_inv  # noqa: E402
from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes  # noqa: E402
from dxrpathtracer_tpu_torch.render.integrator import _make_alpha_test  # noqa: E402
from dxrpathtracer_tpu_torch.scene import alphasplit, procedural, textures  # noqa: E402
from dxrpathtracer_tpu_torch.scene import registry as treg  # noqa: E402
from dxrpathtracer_tpu_torch.scene.build import build_scene  # noqa: E402
from dxrpathtracer_tpu_torch.scene.cache import scene_cache_key  # noqa: E402

ATTRS = ("positions", "normals", "uvs", "tangents", "bitangents", "indices")


def _checker(n, cell):
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    return (((yy // cell + xx // cell) % 2).astype(np.float32))[..., None]


MASKS = {"opaque": (np.ones((32, 32, 1), np.float32), 4),
         "transparent": (np.zeros((32, 32, 1), np.float32), 4),
         "checker": (_checker(256, 128), 3)}


def _card_inputs(pkg, mask):
    """One unit card at y = 1 (material 1, bound to `mask`), built with the
    JAX package's modules (pkg "jax") or the port's."""
    proc, tex = (jproc, jtex) if pkg == "jax" else (procedural, textures)
    meshes = [proc.make_plane((1.0, 1.0), (0.0, 1.0, 0.0), material_idx=1)]
    builder = tex.AtlasBuilder()
    materials = tex.default_material_table(2, builder)
    op = np.asarray(materials.opacity).copy()
    op[1] = builder.add("op", mask)
    ho = np.asarray(materials.has_opacity).copy()
    ho[1] = True
    extra = {"any_opacity": True} if pkg == "jax" else {}
    materials = dataclasses.replace(materials, opacity=op, has_opacity=ho,
                                    **extra)
    return meshes, materials, builder


@pytest.mark.parametrize("mask", list(MASKS))
def test_split_alpha_meshes_matches_jax(mask):
    img, level = MASKS[mask]
    want_m, want_mat, want_stats = jsplit.split_alpha_meshes(
        *_card_inputs("jax", img), max_level=level)
    got_m, got_mat, got_stats = alphasplit.split_alpha_meshes(
        *_card_inputs("port", img), max_level=level)
    assert got_stats == want_stats
    assert len(got_m) == len(want_m)
    for g, w in zip(got_m, want_m):
        assert g.material_idx == w.material_idx
        for a in ATTRS:
            x, y = getattr(g, a), getattr(w, a)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), a
    for slot in alphasplit.SLOTS + ("has_opacity",):
        np.testing.assert_array_equal(getattr(got_mat, slot),
                                      getattr(want_mat, slot), err_msg=slot)
    print(f"{mask}: {got_stats}")
    if mask == "checker":
        assert min(got_stats[k] for k in ("dropped", "opaque", "mixed")) > 0
    else:
        assert got_stats[{"opaque": "opaque",
                          "transparent": "dropped"}[mask]] == 2


def test_classifier_matches_jax():
    rng = np.random.RandomState(3)
    # 16-texel blocks, each opaque or not at random, on a 48 x 80 map
    blocks = (rng.rand(3, 5) > 0.5).astype(np.float32)
    img = np.kron(blocks, np.ones((16, 16), np.float32))[..., None]
    got, want = (alphasplit._Classifier(img, 0.35),
                 jsplit._Classifier(img, 0.35))
    kinds = set()
    for _ in range(400):
        base = rng.uniform(-0.5, 1.5, size=2)
        ext = rng.uniform(1e-3, 0.3, size=2)
        uvs = np.stack([base, base + [ext[0], 0], base + [0, ext[1]]])
        uvs = uvs.astype(np.float32)
        kinds.add(got.classify(uvs))
        assert got.classify(uvs) == want.classify(uvs)
    assert kinds == {"opaque", "transparent", "mixed"}


def test_split_hits_identical_under_the_port_alpha_walk():
    """Split and unsplit card: the same rays hit, at the same t, under the
    in-walk alpha test, on the 128-texel checker where level 3 drops
    pieces."""
    img, level = MASKS["checker"]
    n = 128
    u = np.linspace(-0.999, 0.999, n)
    xx, zz = np.meshgrid(u, u)
    o = torch.from_numpy(np.stack([xx.ravel(), np.full(n * n, 5.0),
                                   zz.ravel()], -1).astype(np.float32))
    d = torch.from_numpy(np.tile(np.float32([[0, -1, 0]]), (n * n, 1)))
    results = []
    for split in (False, True):
        meshes, materials, builder = _card_inputs("port", img)
        if split:
            meshes, materials, stats = alphasplit.split_alpha_meshes(
                meshes, materials, builder, max_level=level)
            assert stats["dropped"] > 0 and stats["opaque"] > 0
        scene = build_scene(meshes, materials=materials,
                            atlas_builder=builder)
        bvh = build_bvh_for_scene(scene, width=8, flag_alpha=True)
        accept = _make_alpha_test(scene, AppSettings())
        hit = traverse_plain(bvh, o, d, safe_inv(d),
                             torch.full((n * n,), 0.001),
                             torch.full((n * n,), 100.0),
                             torch.ones(n * n, dtype=torch.bool), False,
                             accept_fn=accept)
        results.append((hit.t.numpy(), hit.tri_id.numpy() >= 0,
                        scene.num_triangles))
    (t0, h0, n0), (t1, h1, n1) = results
    print(f"unsplit {n0} triangles, {int(h0.sum())} hits; split {n1} "
          f"triangles, {int(h1.sum())} hits")
    assert 0 < h0.sum() < len(h0)
    np.testing.assert_array_equal(h0, h1)
    np.testing.assert_array_equal(t0[h0], t1[h1])


def test_cache_key_includes_split_switches(monkeypatch, tmp_path):
    f = tmp_path / "x.fbx"
    f.write_bytes(b"not an fbx")
    preset = treg.PRESETS[Scenes.Sponza]
    monkeypatch.delenv("DXRPT_ALPHA_SPLIT", raising=False)
    monkeypatch.delenv("DXRPT_ALPHA_SPLIT_LEVEL", raising=False)
    k0 = scene_cache_key(str(f), preset)
    monkeypatch.setenv("DXRPT_ALPHA_SPLIT", "1")
    k1 = scene_cache_key(str(f), preset)
    monkeypatch.setenv("DXRPT_ALPHA_SPLIT_LEVEL", "6")
    k2 = scene_cache_key(str(f), preset)
    assert len({k0, k1, k2}) == 3


def _suntemple(tmp_path, monkeypatch, split):
    from dxrpathtracer_tpu_torch.tools.fbx_cases import write_dds
    for rel in treg.SUNTEMPLE_FOLIAGE_DDS:
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        if not path.exists():
            write_dds(path, np.repeat(_checker(64, 32) * 255, 4, axis=-1))
    if split:
        monkeypatch.setenv("DXRPT_ALPHA_SPLIT", "1")
    else:
        monkeypatch.delenv("DXRPT_ALPHA_SPLIT", raising=False)
    return treg._suntemple_standin_scene(asset_root=tmp_path)


def test_registry_splits_where_switched(tmp_path, monkeypatch):
    calls = []
    split_fn = alphasplit.split_alpha_meshes

    def recording(*a, **kw):
        out = split_fn(*a, **kw)
        calls.append(out[2])
        return out

    monkeypatch.setattr(alphasplit, "split_alpha_meshes", recording)
    plain = _suntemple(tmp_path, monkeypatch, False)
    assert calls == [] and plain.any_opacity
    split = _suntemple(tmp_path, monkeypatch, True)
    (stats,) = calls
    print(f"SunTemple stand-in, foliage split at level 4: {stats}; "
          f"{plain.num_triangles} -> {split.num_triangles} triangles")
    assert stats["source"] > 0 and stats["dropped"] + stats["opaque"] > 0
    assert split.num_triangles == (plain.num_triangles - stats["source"]
                                   + stats["opaque"] + stats["mixed"])
    # the opaque clones follow the four materials
    assert split.has_opacity.shape[0] > plain.has_opacity.shape[0]
    assert not bool(split.has_opacity[4:].any())
    # the alpha stand-in: its cards against the default white texel are
    # all moved to the opaque clone
    monkeypatch.setattr(treg, "_sponza_standin_meshes", lambda: [])
    scene, _ = treg.sponza_alpha_standin(num_cards=4)
    assert calls[-1] == dict(dropped=0, opaque=8, mixed=0, source=8)
    # (material 1 keeps its opacity map, as in the JAX package, but no
    # triangle uses it: there is no alpha-only table)
    assert not bool(scene.has_opacity[scene.tri_material].any())
    from dxrpathtracer_tpu_torch.accel.bvh import build_alpha_bvh_for_scene
    assert build_alpha_bvh_for_scene(scene) is None
