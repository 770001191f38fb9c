"""Port parity: the lightmap bake of dxrpathtracer_tpu_torch (atlases, surface
maps, the progressive Baker, the `bake` command) against dxrpathtracer_tpu.

  - atlases: the charted atlas on BoxTest byte-equal to the JAX package's
    tri_uv; the pair atlas and its closed-form texel map byte-equal on
    BoxTest and on the Sponza-class stand-in; rasterize_texel_map equal on
    BoxTest at 64;
  - surface maps on BoxTest at 64, both atlases: coverage exactly equal,
    position / normal / albedo within atol 1e-6 (expected bit-equal);
  - the Baker on BoxTest at 32x32, path length 2, 2 bake steps: lightmap
    rel-RMSE (scaled by max|ref|) <= 1e-5 and validCount equal;
  - one slab equals several slabs bit for bit; a checkpointed bake resumed
    in a fresh Baker equals an uninterrupted one bit for bit; under a
    uniform sky the unoccluded slab top bakes to the sky value;
  - the `bake` command writes a PNG and an NPZ with the JAX command's keys
    and shapes; `RenderSession` with no device raises where there is no card.

The JAX side runs in one subprocess whose XLA:CPU emits no FMA (ISA capped
at AVX), so it rounds every product as the port's plain versions do; its
sun-space grid, dense proxy, AABB cut and software raster are off (exact
alternates of the per-ray walk that the port routes every ray through).
"""

import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

torch = pytest.importorskip("torch")

from dxrpathtracer_tpu.bake import lightmap_uv as jlmuv  # noqa: E402
from dxrpathtracer_tpu.bake.charts import \
    rasterize_texel_map as jrasterize  # noqa: E402
from dxrpathtracer_tpu.scene import registry as jreg  # noqa: E402
from dxrpathtracer_tpu_torch.app import cli  # noqa: E402
from dxrpathtracer_tpu_torch.app.session import RenderSession  # noqa: E402
from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes  # noqa: E402
from dxrpathtracer_tpu_torch.bake import lightmap_uv as tlmuv  # noqa: E402
from dxrpathtracer_tpu_torch.bake import baker as tbaker  # noqa: E402
from dxrpathtracer_tpu_torch.bake.baker import Baker  # noqa: E402
from dxrpathtracer_tpu_torch.bake.charts import (build_charted_atlas,  # noqa: E402
                                                 rasterize_texel_map)
from dxrpathtracer_tpu_torch.bake.surface_map import (atlas_texel_map,  # noqa: E402
                                                      build_surface_maps)
from dxrpathtracer_tpu_torch.render.film import to_uint8  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAP_RES, BAKE_RES, BAKE_STEPS = 64, 32, 2
CHART_OPTS = {"grid_cols": 512}  # the bake's charted atlas: a fast packer
SURFACE_ATOL = 1e-6
BAKE_REL_RMSE = 1e-5
SETTINGS = dict(current_scene=Scenes.BoxTest, max_path_length=2,
                enable_sunspace_shadows=False, enable_dense_proxy=False,
                enable_clear_cut=False, enable_sw_raster=False)

_SCRIPT = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from dxrpathtracer_tpu.app.session import RenderSession
from dxrpathtracer_tpu.app.settings import AppSettings, Scenes
from dxrpathtracer_tpu.bake.baker import Baker
from dxrpathtracer_tpu.bake.charts import build_charted_atlas
from dxrpathtracer_tpu.bake.lightmap_uv import build_lightmap_atlas
from dxrpathtracer_tpu.bake.surface_map import build_surface_maps

map_res, bake_res, steps, chart_opts = %d, %d, %d, %r
s = AppSettings(current_scene=Scenes.BoxTest, max_path_length=2,
                enable_sunspace_shadows=False, enable_dense_proxy=False,
                enable_clear_cut=False, enable_sw_raster=False)
sess = RenderSession(settings=s, width=8, height=8)
host = sess.scene_host
pos, tri = np.asarray(host.positions), np.asarray(host.tri_idx)
out = {}
atlases = {"charts": build_charted_atlas(pos, tri, ref_resolution=map_res),
           "pair": build_lightmap_atlas(int(host.num_triangles))}
out["charts__tri_uv"] = atlases["charts"].tri_uv
for name, atlas in atlases.items():
    for k, v in build_surface_maps(host, atlas, map_res).items():
        out["maps__%%s__%%s" %% (name, k)] = np.asarray(v)
baker = Baker(sess, resolution=bake_res, atlas_mode="charts",
              atlas_opts=chart_opts)
for _ in range(steps):
    baker.bake_step()
out["bake__tri_uv"] = baker.atlas.tri_uv
out["bake__accum"] = np.asarray(baker.accum)
out["bake__lightmap"] = np.asarray(baker.lightmap())
out["sky__cubemap"] = sess.sky.cubemap
out["sky__sun_irradiance"] = sess.sky.sun_irradiance
out["sky__sun_render_color"] = sess.sky.sun_render_color
np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in out.items()})
""" % (MAP_RES, BAKE_RES, BAKE_STEPS, CHART_OPTS)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("bake_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    env.pop("DXRPT_PALLAS_BODY", None)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, str(out)], env=env,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


@pytest.fixture(scope="module")
def session():
    return RenderSession(AppSettings(**SETTINGS), 8, 8, device="cpu")


@pytest.fixture(scope="module")
def ref_session(ref):
    """A CPU session lit by the JAX package's own sky values."""
    sess = RenderSession(AppSettings(**SETTINGS), 8, 8, device="cpu")
    sess.sky_cube = torch.from_numpy(ref["sky__cubemap"])
    sess.sky.sun_irradiance = ref["sky__sun_irradiance"]
    sess.sky.sun_render_color = ref["sky__sun_render_color"]
    return sess


def _bytes_equal(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, name
    assert got.tobytes() == want.tobytes(), name


def _rel_rmse(img, ref):
    return float(np.sqrt(np.mean((img - ref) ** 2)) / (np.abs(ref).max() + 1e-9))


# ---------------------------------------------------------------------------
# Atlases
# ---------------------------------------------------------------------------

def test_charted_atlas_byte_equal(ref, session):
    host = session.scene_host
    atlas = build_charted_atlas(host.positions.numpy(), host.tri_idx.numpy(),
                                ref_resolution=MAP_RES)
    _bytes_equal(atlas.tri_uv, ref["charts__tri_uv"], "tri_uv")


@pytest.mark.parametrize("scene,res", [("BoxTest", 64), ("Sponza", 1024)])
def test_pair_atlas_and_texel_map_byte_equal(scene, res):
    if scene == "BoxTest":
        num_tris = jreg.load_scene(jreg.Scenes.BoxTest)[0].num_triangles
    else:
        meshes = jreg._sponza_standin_meshes()
        num_tris = sum(m.indices.size // 3 for m in meshes)
        assert num_tris == 246_084
    want, got = jlmuv.build_lightmap_atlas(num_tris), \
        tlmuv.build_lightmap_atlas(num_tris)
    assert (got.num_tris, got.cells, got.gutter) == \
        (want.num_tris, want.cells, want.gutter)
    _bytes_equal(got.triangle_uvs(), want.triangle_uvs(), "triangle_uvs")
    for name, g, w in zip(("tri", "bu", "bv"),
                          tlmuv.texel_to_triangle(got, res),
                          jlmuv.texel_to_triangle(want, res)):
        _bytes_equal(g, w, name)


def test_rasterize_texel_map_equal(ref):
    tri_uv = ref["charts__tri_uv"]
    got = rasterize_texel_map(tri_uv, MAP_RES)
    want = jrasterize(tri_uv, MAP_RES)
    for name, g, w in zip(("tri", "bu", "bv"), got[:3], want[:3]):
        _bytes_equal(g, w, name)
    assert got[3] == want[3]


# ---------------------------------------------------------------------------
# Surface maps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("atlas_name", ["charts", "pair"])
def test_surface_maps_match_jax(ref, session, atlas_name):
    host = session.scene_host
    if atlas_name == "charts":
        atlas = build_charted_atlas(host.positions.numpy(),
                                    host.tri_idx.numpy(),
                                    ref_resolution=MAP_RES)
    else:
        atlas = tlmuv.build_lightmap_atlas(int(host.num_triangles))
    maps = build_surface_maps(session.scene, atlas_texel_map(atlas, MAP_RES))
    want = {k: ref[f"maps__{atlas_name}__{k}"]
            for k in ("position", "normal", "albedo")}
    got = {k: v.numpy() for k, v in maps.items()}
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32, k
    np.testing.assert_array_equal(got["position"][..., 3],
                                  want["position"][..., 3])  # coverage
    assert 0.2 < want["position"][..., 3].mean() <= 1.0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=SURFACE_ATOL,
                                   err_msg=k)
        print(f"{atlas_name} {k}: "
              + ("bit-equal" if got[k].tobytes() == want[k].tobytes() else
                 f"{np.sum(got[k] != want[k])} values not bit-equal"))


# ---------------------------------------------------------------------------
# Bake
# ---------------------------------------------------------------------------

def test_bake_matches_jax(ref, ref_session):
    baker = Baker(ref_session, resolution=BAKE_RES, atlas_mode="charts",
                  atlas_opts=CHART_OPTS)
    _bytes_equal(baker.atlas.tri_uv, ref["bake__tri_uv"], "bake tri_uv")
    for _ in range(BAKE_STEPS):
        baker.bake_step()
    accum = baker.accum.numpy()
    want = ref["bake__accum"]
    np.testing.assert_array_equal(accum[..., 3], want[..., 3])  # validCount
    lm = baker.lightmap().numpy()
    assert np.isfinite(lm).all() and lm.shape == (BAKE_RES, BAKE_RES, 3)
    err = _rel_rmse(lm, ref["bake__lightmap"])
    print(f"BoxTest bake {BAKE_RES}^2 x {BAKE_STEPS}: rel RMSE vs JAX "
          f"{err:.3e}, {np.mean(lm == ref['bake__lightmap']):.4f} of values "
          f"bit-equal")
    assert err <= BAKE_REL_RMSE


def test_one_slab_equals_several(session, monkeypatch):
    whole = Baker(session, resolution=BAKE_RES, atlas_mode="pair")
    monkeypatch.setattr(tbaker, "MAX_SLAB_TEXELS", BAKE_RES * 5)
    slabs = Baker(session, resolution=BAKE_RES, atlas_mode="pair")  # 4 rows
    assert len(whole._row0) == 1 and len(slabs._row0) == 8
    for _ in range(BAKE_STEPS):
        whole.bake_step()
        slabs.bake_step()
    assert float(whole.accum[..., 3].sum()) > 0
    _bytes_equal(slabs.accum.numpy(), whole.accum.numpy(), "accum")


def test_bake_checkpoint_resume_bit_identical(session, tmp_path):
    """A bake checkpointed at sample 2 and resumed in a fresh Baker equals an
    uninterrupted 4-sample bake: the CMJ sampler is indexed by the global
    sample_index."""
    straight = Baker(session, resolution=BAKE_RES, atlas_mode="pair")
    for _ in range(4):
        straight.bake_step()

    first = Baker(session, resolution=BAKE_RES, atlas_mode="pair")
    first.bake_step()
    first.bake_step()
    path = str(tmp_path / "bake_ckpt.npz")
    first.save_checkpoint(path)
    with np.load(path) as z:
        assert sorted(z.files) == ["accum", "sample_index"]
        assert int(z["sample_index"]) == 2

    resumed = Baker(session, resolution=BAKE_RES, atlas_mode="pair")
    resumed.load_checkpoint(path)
    assert resumed.sample_index == 2
    resumed.bake_step()
    resumed.bake_step()
    _bytes_equal(resumed.accum.numpy(), straight.accum.numpy(), "accum")


def test_bake_energy_boxtest():
    """Under a uniform sky the unoccluded, up-facing slab top bakes to the
    sky value (the cosine-weighted hemisphere estimate of a constant is
    that constant); within 12 %, as the JAX package's test holds it."""
    settings = AppSettings(current_scene=Scenes.BoxTest, sqrt_num_samples=4,
                           enable_sun=False, max_path_length=2)
    sess = RenderSession(settings, 8, 8, device="cpu")
    sky_val = 3.0
    sess.sky_cube = torch.full((6, 8, 8, 3), sky_val)
    baker = Baker(sess, resolution=64, atlas_mode="pair")
    for _ in range(12):
        baker.bake_step()
    lm = baker.lightmap().numpy()
    cov = baker.accum[..., 3].numpy() > 0
    assert cov.any() and np.isfinite(lm).all()
    pos = baker.surface_maps["position"].numpy()
    nrm = baker.surface_maps["normal"].numpy()
    top = cov & (np.abs(pos[..., 1] - 0.125) < 1e-3) & (nrm[..., 1] > 0.99) \
        & (np.abs(pos[..., 0]) > 2.0)
    assert top.sum() > 10
    mean = lm[top].mean()
    assert abs(mean - sky_val) / sky_val < 0.12, (mean, sky_val)
    assert np.isfinite(baker.denoised_lightmap("median").numpy()).all()


# ---------------------------------------------------------------------------
# The `bake` command and the device default
# ---------------------------------------------------------------------------

def _read_png(path):
    """(H, W, C) uint8 of an 8-bit, non-interlaced, filter-0 PNG."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF, kind
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + length
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB",
                                                        chunks[b"IHDR"])
    assert depth == 8 and interlace == 0
    c = {0: 1, 2: 3, 6: 4}[ctype]
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = rows.reshape(h, 1 + w * c)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, c)


def test_bake_command_writes_png_and_npz(tmp_path):
    """`bake --current-scene BoxTest --resolution 32 --samples 2 --device
    cpu`: the PNG is the tone-mapped lightmap as 8-bit RGB (the JAX command
    writes (32, 32, 3) uint8 through PIL) and the NPZ holds the JAX
    command's keys: lightmap (32, 32, 3) f32 and tri_uv (T, 3, 2) f32."""
    from dxrpathtracer_tpu_torch.core.constants import FP16Scale
    from dxrpathtracer_tpu_torch.render.postfx import tone_map_filmic_alu
    args = ["bake", "--current-scene", "BoxTest", "--resolution", "32",
            "--samples", "2", "--device", "cpu", "--max-path-length", "2",
            "--checkpoint", str(tmp_path / "ckpt.npz")]
    npz = tmp_path / "lm.npz"
    png = tmp_path / "lm.png"
    cli.main(args + ["--output", str(npz)])
    # the second run resumes from the checkpoint: the same 2 samples
    cli.main(args + ["--output", str(png)])
    with np.load(npz) as z:
        assert sorted(z.files) == ["lightmap", "tri_uv"]
        lm, tri_uv = z["lightmap"], z["tri_uv"]
    num_tris = jreg.load_scene(jreg.Scenes.BoxTest)[0].num_triangles
    assert lm.shape == (32, 32, 3) and lm.dtype == np.float32
    assert tri_uv.shape == (num_tris, 3, 2) and tri_uv.dtype == np.float32
    assert np.isfinite(lm).all() and lm.max() > 0
    px = _read_png(png)
    exposure = AppSettings().exposure
    want = to_uint8(tone_map_filmic_alu(
        torch.from_numpy(lm) * (2.0 ** exposure) / FP16Scale).numpy())
    np.testing.assert_array_equal(px, want)


def test_session_and_command_default_to_the_card(tmp_path, monkeypatch):
    """No `device`: the card. Where there is none, RenderSession and the
    command raise instead of running on the CPU (and the command's crash
    guard writes its dump)."""
    dump = tmp_path / "crash.json"
    monkeypatch.setenv("DXRPT_CRASH_DUMP", str(dump))
    settings = AppSettings(current_scene=Scenes.BoxTest)
    if torch.cuda.is_available():
        sess = RenderSession(settings, 8, 8)
        assert sess.device.type == "cuda"
        assert Baker(sess, resolution=8, atlas_mode="pair").accum.is_cuda
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RenderSession(settings, 8, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["bake", "--current-scene", "BoxTest", "--resolution", "8",
                  "--samples", "1", "--atlas", "pair"])
    assert dump.exists()
