"""Port parity: accel/sunspace.py of dxrpathtracer_tpu_torch (the sun-space
grid, csrc/sungrid.cu's module) against dxrpathtracer_tpu.

  - The builder: the grid's table, index, params and basis byte-equal to
    the JAX package's build_sun_grid on seeded soups (a power-of-8 grid and
    a 96-cell one, whose ranges do not split evenly), on a sun within 25
    degrees of +z (the basis' other up vector) and on BoxTest.
  - The plain walk (the kernel's plain version, which the port runs on the
    CPU): visibility equal on every lane to the JAX package's sun_any_hit
    (in a subprocess whose XLA:CPU emits no FMA, as
    tests/test_torch_traverse.py runs it) and to the port's per-ray any_hit;
    on the grid edge cases of tools/traverse_cases.py (cell borders, origins
    outside the box or NaN, empty cells, thr on a record's suffix- and
    own-zmax, the longest chain, t_max <= t_min, inactive lanes, ragged n)
    equal to the JAX package's and never less occluded than the per-ray
    walk, each case reaching what it is for.
  - The grid walk with an alpha test (the JAX package's
    sun_any_hit(accept_fn=...)): the plain walk with tests/test_sunspace.py's
    hash accept (written in torch) on the soup, and with the alpha test of
    tiny_alpha_scene (JAX `_make_alpha_test`, the port's AlphaTest), equal
    to JAX's on every lane; with the AlphaTest, equal to the port's per-ray
    alpha any_hit on every lane.
  - csrc/sungrid.cu includes csrc/alpha.cuh: a build is keyed on the
    header's bytes too (buildlib.source_key), with no nvcc.
  - The session builds its grid when the first path-traced sample needs it
    (not at init, not for a raster frame), again when the sun moves, and
    drops it when enable_sunspace_shadows is off; the bake routes its sun
    rays to the grid and its opaque shadow rays to the dense proxy, with no
    packets and no cut, and gives the lightmap of the bake without them.
The kernel itself is held against the plain walk on the card by
chip_smoke.py.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

torch = pytest.importorskip("torch")

from dxrpathtracer_tpu_torch.accel import (packet, proxy, sunspace,  # noqa: E402
                                           traverse)
from dxrpathtracer_tpu_torch import buildlib  # noqa: E402
from dxrpathtracer_tpu_torch.accel.bvh import build_bvh  # noqa: E402
from dxrpathtracer_tpu_torch.app.session import RenderSession  # noqa: E402
from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes  # noqa: E402
from dxrpathtracer_tpu_torch.bake.baker import Baker  # noqa: E402
from dxrpathtracer_tpu_torch.convert import (  # noqa: E402
    scene_from_reference_arrays, sun_grid_from_reference)
from dxrpathtracer_tpu_torch.render.integrator import _make_alpha_test  # noqa: E402
from dxrpathtracer_tpu_torch.scene.registry import (load_scene,  # noqa: E402
                                                    tiny_alpha_scene)
from dxrpathtracer_tpu_torch.tools import traverse_cases as tc  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUN = (0.3, 0.9, -0.2)
# name: (scene seed or "boxtest", triangles, sun, grid size)
CASES = {"soup512": (1, 500, SUN, 512), "soup96": (4, 1500, SUN, 96),
         "steep_sun": (2, 800, (0.1, -0.2, 0.95), 512),
         "boxtest": ("boxtest", 0, None, 512)}
N_RAYS = 2048


def _case(name):
    """(v0, v1, v2, unit sun, grid size, ray origins, t_min, t_max, active)
    of a case, numpy, from its seed."""
    seed, t, sun, size = CASES[name]
    if seed == "boxtest":
        scene, preset = load_scene(Scenes.BoxTest)
        pos, tri = scene.positions.numpy(), scene.tri_idx.numpy()
        v0, v1, v2 = pos[tri[:, 0]], pos[tri[:, 1]], pos[tri[:, 2]]
        sun, seed = preset.sun_direction, 7
        lo, hi = pos.min(0) - 1.0, pos.max(0) + 1.0
    else:
        rng = np.random.default_rng(seed)
        base = rng.uniform(-10, 10, (t, 1, 3)).astype(np.float32)
        tris = base + rng.normal(0, 0.8, (t, 3, 3)).astype(np.float32)
        v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
        lo, hi = np.full(3, -12.0), np.full(3, 12.0)
    sun = np.asarray(sun, np.float32)
    sun = sun / np.linalg.norm(sun)
    rng = np.random.default_rng(100 + seed)
    o = rng.uniform(lo, hi, (N_RAYS, 3)).astype(np.float32)
    tmin = rng.choice(np.float32([1e-5, 0.5]), N_RAYS)
    tmax = rng.choice(np.float32([3e37, 4.0]), N_RAYS, p=[0.8, 0.2])
    active = rng.random(N_RAYS) < 0.9
    return (v0.astype(np.float32), v1.astype(np.float32),
            v2.astype(np.float32), sun, size, o, tmin, tmax, active)


_FIELDS = ("v0", "v1", "v2", "sun", "size", "o", "tmin", "tmax", "active")


def _edge_case(name):
    """(the grid's (v0, v1, v2, unit sun, size), the port's grid, its edge
    rays concatenated (numpy), {edge set: slice}) of a case's grid."""
    scene = tc.grid_scene(name)
    grid = sunspace.build_sun_grid(*scene[:4], grid_size=scene[4])
    rays, slices = tc.concat_rays(tc.grid_edge_cases(
        grid.table.numpy(), grid.index.numpy(), grid.params.numpy(),
        grid.basis.numpy(), grid.grid_size, sun=scene[3]))
    return scene, grid, rays, slices

# the alpha cases: (triangles, accept) of the soup with the hash accept and
# of tiny_alpha_scene with its alpha test
ALPHA_CASES = ("hash", "tiny")
TINY_SUN = (0.35, 0.8, -0.45)


def _hash_accept(tid, u, v):
    """tests/test_sunspace.py's pseudo-opacity (accepts ~60 % of (tri, uv)
    lookups) in torch: uint32 arithmetic as int64 masked to 32 bits."""
    m = 0xFFFFFFFF
    h = ((tid.long() & m) * 2654435761 & m) + (
        (u * 255).long() & m) * 40503 + ((v * 255).long() & m)
    return (h & m) % 5 < 3


def _tiny_rays():
    """Sun rays of tiny_alpha_scene: origins on the ground plane under the
    cards and above it, numpy from a seed."""
    rng = np.random.default_rng(21)
    o = np.stack([rng.uniform(-4, 4, N_RAYS), rng.uniform(0, 1.5, N_RAYS),
                  rng.uniform(-4, 4, N_RAYS)], 1).astype(np.float32)
    o[: N_RAYS // 2, 1] = 1e-3
    tmin = np.full(N_RAYS, 1e-4, np.float32)
    tmax = np.full(N_RAYS, 3e37, np.float32)
    active = rng.random(N_RAYS) < 0.95
    sun = np.asarray(TINY_SUN, np.float32)
    return sun / np.linalg.norm(sun), o, tmin, tmax, active


_SCRIPT = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from dxrpathtracer_tpu.accel.sunspace import build_sun_grid, sun_any_hit
from dxrpathtracer_tpu.app.settings import AppSettings
from dxrpathtracer_tpu.render.integrator import _make_alpha_test
from dxrpathtracer_tpu.scene import dds as jdds
from dxrpathtracer_tpu.scene import registry as jreg
from dxrpathtracer_tpu_torch.convert import reference_scene_arrays


def hash_accept(tri_id, u, v):
    h = (tri_id.astype(jnp.uint32) * jnp.uint32(2654435761)
         + (u * 255).astype(jnp.uint32) * jnp.uint32(40503)
         + (v * 255).astype(jnp.uint32))
    return (h % jnp.uint32(5)) < jnp.uint32(3)


inp = dict(np.load(sys.argv[1]))
out = {}
# tiny_alpha_scene as the JAX package loads it (the mask its DDS loader
# decoded, if it ran, goes out for the port's scene)
load, seen = jdds.load_dds, []
jdds.load_dds = lambda path: seen.append(load(path)) or seen[-1]
try:
    tiny = jreg.tiny_alpha_scene()[0]
finally:
    jdds.load_dds = load
if seen:
    out["tiny__mask"] = seen[0].data
for k, v in reference_scene_arrays(tiny).items():
    out["tiny__scene__" + k] = v
pos, tri = np.asarray(tiny.positions), np.asarray(tiny.tri_idx)
accepts = {"hash": hash_accept,
           "tiny": _make_alpha_test(jax.device_put(tiny), AppSettings())}
for case in ("hash", "tiny"):
    g = lambda f: inp["alpha_" + case + "__" + f]
    if case == "hash":
        v0, v1, v2 = g("v0"), g("v1"), g("v2")
    else:
        v0, v1, v2 = pos[tri[:, 0]], pos[tri[:, 1]], pos[tri[:, 2]]
    grid = build_sun_grid(v0, v1, v2, g("sun"), grid_size=int(g("size")))
    n = g("o").shape[0]
    d = jnp.broadcast_to(jnp.asarray(g("sun")), (n, 3))
    args = (grid, jnp.asarray(g("o")), d, jnp.asarray(g("tmin")),
            jnp.asarray(g("tmax")), jnp.asarray(g("active")))
    out["alpha_" + case + "__vis"] = np.asarray(sun_any_hit(
        *args, accept_fn=accepts[case]))
    out["alpha_" + case + "__opaque"] = np.asarray(sun_any_hit(*args))
for case in sorted({k.split("__")[0] for k in inp
                    if not k.startswith("alpha_")}):
    g = lambda f: inp[case + "__" + f]
    grid = build_sun_grid(g("v0"), g("v1"), g("v2"), g("sun"),
                          grid_size=int(g("size")))
    for f in ("table", "index", "params", "basis"):
        out[case + "__" + f] = np.asarray(getattr(grid, f))
    out[case + "__const"] = np.asarray([grid.num_rows, grid.grid_size])
    n = g("o").shape[0]
    d = jnp.broadcast_to(jnp.asarray(g("sun")), (n, 3))
    out[case + "__vis"] = np.asarray(sun_any_hit(
        grid, jnp.asarray(g("o")), d, jnp.asarray(g("tmin")),
        jnp.asarray(g("tmax")), jnp.asarray(g("active"))))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's grids and sun_any_hit visibility of every case, its
    XLA:CPU without FMA."""
    tmp = tmp_path_factory.mktemp("sunspace_ref")
    inputs = {}
    for name in CASES:
        for f, a in zip(_FIELDS, _case(name)):
            inputs[name + "__" + f] = np.asarray(a)
        scene, _, rays, _ = _edge_case(name)
        for f, a in zip(_FIELDS, (*scene, rays["o"], rays["tmin"],
                                  rays["tmax"], rays["active"])):
            inputs["edge_" + name + "__" + f] = np.asarray(a)
    for f, a in zip(_FIELDS, _case("soup512")):
        inputs["alpha_hash__" + f] = np.asarray(a)
    sun, *rays = _tiny_rays()
    for f, a in zip(_FIELDS[3:], (sun, 512, *rays)):
        inputs["alpha_tiny__" + f] = np.asarray(a)
    src, dst = tmp / "in.npz", tmp / "out.npz"
    np.savez(src, **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, str(src), str(dst)],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(dst))


@pytest.mark.parametrize("name", list(CASES))
def test_builder_matches_jax_byte_for_byte(reference, name):
    v0, v1, v2, sun, size, *_ = _case(name)
    got = sunspace.build_sun_grid(v0, v1, v2, sun, grid_size=size)
    want = sun_grid_from_reference(type("G", (), {
        **{f: reference[name + "__" + f]
           for f in ("table", "index", "params", "basis")},
        "num_rows": int(reference[name + "__const"][0]),
        "grid_size": int(reference[name + "__const"][1])}))
    assert (got.num_rows, got.grid_size) == (want.num_rows, want.grid_size)
    for f in ("table", "params", "basis"):
        np.testing.assert_array_equal(getattr(got, f).numpy().view(np.int32),
                                      getattr(want, f).numpy().view(np.int32),
                                      err_msg=f)
    np.testing.assert_array_equal(got.index.numpy(), want.index.numpy())


@pytest.mark.parametrize("name", list(CASES))
def test_plain_walk_matches_jax_and_the_walk(reference, name):
    v0, v1, v2, sun, size, o, tmin, tmax, active = _case(name)
    grid = sunspace.build_sun_grid(v0, v1, v2, sun, grid_size=size)
    rays = (torch.from_numpy(o),
            torch.from_numpy(np.broadcast_to(sun, o.shape).copy()),
            torch.from_numpy(tmin), torch.from_numpy(tmax),
            torch.from_numpy(active))
    stats = {}
    vis = sunspace.sun_any_hit_plain(grid, *rays, stats=stats)
    assert torch.equal(sunspace.sun_any_hit(grid, *rays), vis)
    np.testing.assert_array_equal(vis.numpy(), reference[name + "__vis"])
    walk = traverse.any_hit(build_bvh(v0, v1, v2, width=8), *rays)
    assert torch.equal(vis, walk)
    blocked = int((vis == 0).sum())
    print(f"{name}: {grid.num_rows} records, {blocked} of {N_RAYS} blocked, "
          f"{stats['visits']} record visits, {stats['tested']} tested")
    assert 0 < blocked < int(active.sum()) and stats["visits"] > 0
    # the filled triangles up to the first blocking one of each tested record
    assert stats["tested"] <= stats["tri_tests"] <= stats["tested"] * 12


@pytest.mark.parametrize("name", list(CASES))
def test_plain_walk_matches_jax_on_grid_edge_cases(reference, name):
    (v0, v1, v2, sun, size), grid, r, sl = _edge_case(name)
    if name != "boxtest":  # the grid is the one of the cases above
        for got, want in zip((v0, v1, v2, sun), _case(name)):
            np.testing.assert_array_equal(got, want)
    rays = tuple(torch.from_numpy(r[f]) for f in tc.RAY_FIELDS)
    o, d, tmin, tmax, active = rays
    stats = {}
    vis = sunspace.sun_any_hit_plain(grid, *rays, stats=stats)
    assert torch.equal(sunspace.sun_any_hit(grid, *rays), vis)
    np.testing.assert_array_equal(vis.numpy(),
                                  reference["edge_" + name + "__vis"])
    walk = traverse.any_hit(build_bvh(v0, v1, v2, width=8), *rays)
    assert not bool((vis > walk).any())  # never less occluded than the walk
    steps = stats["lane_steps"].numpy()
    vis, act = vis.numpy(), r["active"]
    print(f"{name}: " + ", ".join(
        f"{k} {s.stop - s.start} ({int((vis[s] == 0).sum())} blocked)"
        for k, s in sl.items()))
    assert (vis[~act] == 1).all() and (steps[~act] == 0).all()
    assert (vis[act & (r["tmax"] <= r["tmin"])] == 1).all()
    assert sl["ragged"].stop - sl["ragged"].start == 37  # not 32k, not 4k
    table = grid.table.numpy()
    p = grid.params.numpy()
    b = grid.basis.numpy()
    px, py, depth = tc.grid_project(r["o"], b)
    cx, cy = tc.grid_cells(r["o"], p, b, size)
    # cell borders: (p - g0) * inv an exact integer on an axis
    s = sl["borders"]
    fx, fy = (px[s] - p[0]) * p[2], (py[s] - p[1]) * p[3]
    assert s.stop - s.start >= 30
    assert ((fx == np.floor(fx)) | (fy == np.floor(fy))).all()
    assert ((fx == np.floor(fx)) & (fy == np.floor(fy))).any()
    # outside the grid's box: clipped to an edge cell
    s = sl["outside"]
    f = np.stack([(px[s] - p[0]) * p[2], (py[s] - p[1]) * p[3]])
    assert ((f < 0) | (f >= size)).any(axis=0).all()
    assert ((cx[s] == 0) | (cx[s] == size - 1) | (cy[s] == 0)
            | (cy[s] == size - 1)).all()
    # a NaN component: cell 0, NaN thr, nothing tested, unoccluded
    s = sl["nan"]
    assert np.isnan(r["o"][s]).any(axis=1).all()
    assert (cx[s] == 0).all() and (cy[s] == 0).all() and (vis[s] == 1).all()
    # an empty cell: no step
    if "empty_cell" in sl:
        s = sl["empty_cell"]
        assert (grid.index.numpy()[cy[s] * size + cx[s]] == tc.GRID_DONE).all()
        assert (steps[s] == 0).all() and (vis[s] == 1).all()
    # thr on a record of the ray's chain: its suffix- / own-zmax
    thr = depth + r["tmin"]
    for key, slot in (("thr_suffix", tc.GRID_SUFZ), ("thr_own", tc.GRID_OWNZ)):
        s = sl[key]
        assert s.stop - s.start >= 30
        for i in range(s.start, s.stop):
            chain = tc.grid_chain(table, int(grid.index[cy[i] * size
                                                       + cx[i]]))
            assert thr[i] in table[chain, slot], (key, i)
    # the longest chain, walked to its end where nothing blocks
    s = sl["longest_chain"]
    longest = max(len(tc.grid_chain(table, int(c)))
                  for c in np.unique(grid.index.numpy()) if c != tc.GRID_DONE)
    free = np.zeros(len(o), bool)
    free[s] = vis[s] == 1
    assert free.any() and (steps[free] == longest).all()
    assert stats["warp_records"] <= stats["visits"] == int(steps.sum())


def test_session_builds_the_grid_when_a_sample_needs_it():
    sess = RenderSession(AppSettings(current_scene=Scenes.BoxTest), 16, 16,
                         device="cpu")
    sess.render_raster_frame()
    assert sess.sun_grid is None  # raster frames never need it
    sess.render_frame()
    first = sess.sun_grid
    assert first is not None and sess.sun_grid_build_s >= 0.0
    sess.render_frame()
    assert sess.sun_grid is first  # same sun: no rebuild
    sess.settings = sess.settings.replace(sun_direction=(0.4, 0.8, 0.2))
    sess.render_frame()
    assert sess.sun_grid is not first
    w = np.float32([0.4, 0.8, 0.2]) / np.linalg.norm(np.float32([0.4, 0.8,
                                                                  0.2]))
    np.testing.assert_allclose(sess.sun_grid.basis[2].numpy(), w, rtol=1e-6)
    sess.settings = sess.settings.replace(enable_sunspace_shadows=False)
    sess.render_frame()
    assert sess.sun_grid is None


def _counting(monkeypatch):
    """Counts of the engines' plain versions (the CPU route) as
    trace_paths reaches them."""
    calls = {}

    def wrap(mod, name, key):
        fn = getattr(mod, name)

        def counted(*a, **k):
            calls[key] = calls.get(key, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)

    wrap(packet, "packet_traverse_plain", "packet")
    wrap(sunspace, "sun_any_hit_plain", "grid")
    wrap(proxy, "proxy_blocked_plain", "proxy")
    wrap(proxy, "cut_clear_plain", "cut")
    return calls


def test_bake_routes_the_grid_and_the_proxy(monkeypatch):
    calls = _counting(monkeypatch)
    lightmaps = []
    for on in (True, False):
        s = AppSettings(current_scene=Scenes.BoxTest,
                        enable_sunspace_shadows=on, enable_dense_proxy=on)
        baker = Baker(RenderSession(s, 16, 16, device="cpu"), resolution=32,
                      atlas_mode="pair")
        calls.clear()
        baker.bake_step()
        baker.bake_step()
        if on:
            # a cut is bound on BoxTest, but the bake passes none
            assert calls.get("grid", 0) > 0 and calls.get("proxy", 0) > 0
            assert "packet" not in calls and "cut" not in calls, calls
        else:
            assert not calls, calls
        lightmaps.append(baker.accum)
    assert torch.equal(lightmaps[0], lightmaps[1])
    assert float(lightmaps[0][..., 3].sum()) > 0


def _alpha_case(reference, case):
    """(the port's grid, its BVH, the rays as tensors, the accept) of an
    alpha case: the soup with the hash accept, or tiny_alpha_scene (bound to
    the mask JAX decoded, if any) with its AlphaTest."""
    if case == "hash":
        v0, v1, v2, sun, size, o, tmin, tmax, active = _case("soup512")
        accept = _hash_accept
    else:
        arrays = {k.split("__", 2)[2]: v for k, v in reference.items()
                  if k.startswith("tiny__scene__")}
        scene = scene_from_reference_arrays(arrays)
        port = tiny_alpha_scene(reference.get("tiny__mask"))[0]
        for k in ("positions", "tri_idx", "tri_shade", "texels"):
            assert torch.equal(getattr(port, k), getattr(scene, k)), k
        pos, tri = scene.positions.numpy(), scene.tri_idx.numpy()
        v0, v1, v2 = pos[tri[:, 0]], pos[tri[:, 1]], pos[tri[:, 2]]
        sun, o, tmin, tmax, active = _tiny_rays()
        size = 512
        accept = _make_alpha_test(scene, AppSettings())
    grid = sunspace.build_sun_grid(v0, v1, v2, sun, grid_size=size)
    rays = (torch.from_numpy(o),
            torch.from_numpy(np.broadcast_to(sun, o.shape).copy()),
            torch.from_numpy(tmin), torch.from_numpy(tmax),
            torch.from_numpy(active))
    return grid, build_bvh(v0, v1, v2, width=8), rays, accept


@pytest.mark.parametrize("case", ALPHA_CASES)
def test_plain_alpha_walk_matches_jax_and_the_alpha_walk(reference, case):
    grid, bvh, rays, accept = _alpha_case(reference, case)
    if case == "tiny":
        assert isinstance(accept, traverse.AlphaTest)
    vis = sunspace.sun_any_hit_plain(grid, *rays, accept_fn=accept)
    np.testing.assert_array_equal(vis.numpy(),
                                  reference[f"alpha_{case}__vis"])
    assert torch.equal(sunspace.sun_any_hit(grid, *rays, alpha=accept), vis)
    opaque = sunspace.sun_any_hit(grid, *rays)
    np.testing.assert_array_equal(opaque.numpy(),
                                  reference[f"alpha_{case}__opaque"])
    # the per-ray walk with the same test, on every lane
    walk = traverse.any_hit(bvh, *rays, alpha=accept)
    assert torch.equal(vis, walk)
    rejected = int(((opaque == 0) & (vis == 1)).sum())
    print(f"alpha {case}: {int((vis == 0).sum())} blocked, {rejected} "
          f"blocked only by rejected triangles, of {int(rays[4].sum())} "
          f"active")
    assert rejected > 0 and int((vis == 0).sum()) > 0
    assert not bool((vis < opaque).any())  # a test only takes blockers away


def test_kernel_build_is_keyed_on_its_headers(tmp_path):
    src = tmp_path / "k.cu"
    hdr = tmp_path / "inc" / "h.cuh"
    hdr.parent.mkdir()
    hdr.write_text("// v1\n")
    src.write_text('#include <cstdint>\n#include "h.cuh"\n')
    cmd = ["nvcc", "-O3", "-I", str(hdr.parent)]
    key = buildlib.source_key(src, cmd)
    assert buildlib.source_key(src, cmd) == key
    assert buildlib.source_key(src, [*cmd, "-g"]) != key
    hdr.write_text("// v2\n")
    assert buildlib.source_key(src, cmd) != key
    with pytest.raises(FileNotFoundError):
        buildlib.source_key(src, cmd[:2])  # the header is nowhere
    # the port's own: sungrid.cu and traverse.cu include alpha.cuh
    csrc = Path(sunspace.KERNEL_SOURCE).parent
    for name in ("sungrid.cu", "traverse.cu"):
        assert '#include "alpha.cuh"' in (csrc / name).read_text()
    copy = tmp_path / "csrc"
    copy.mkdir()
    for name in ("sungrid.cu", "alpha.cuh"):
        (copy / name).write_bytes((csrc / name).read_bytes())
    flags = ["nvcc", *traverse.NVCC_FLAGS]
    assert buildlib.source_key(copy / "sungrid.cu", flags) == \
        buildlib.source_key(csrc / "sungrid.cu", flags)
    (copy / "alpha.cuh").write_text((csrc / "alpha.cuh").read_text() + "\n")
    assert buildlib.source_key(copy / "sungrid.cu", flags) != \
        buildlib.source_key(csrc / "sungrid.cu", flags)
