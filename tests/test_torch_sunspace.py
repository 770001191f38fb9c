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

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

torch = pytest.importorskip("torch")

from dxrpathtracer_tpu_torch.accel import (packet, proxy, sunspace,  # noqa: E402
                                           traverse)
from dxrpathtracer_tpu_torch.accel.bvh import build_bvh  # noqa: E402
from dxrpathtracer_tpu_torch.app.session import RenderSession  # noqa: E402
from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes  # noqa: E402
from dxrpathtracer_tpu_torch.bake.baker import Baker  # noqa: E402
from dxrpathtracer_tpu_torch.convert import sun_grid_from_reference  # noqa: E402
from dxrpathtracer_tpu_torch.scene.registry import load_scene  # noqa: E402
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

_SCRIPT = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from dxrpathtracer_tpu.accel.sunspace import build_sun_grid, sun_any_hit

inp = dict(np.load(sys.argv[1]))
out = {}
for case in sorted({k.split("__")[0] for k in inp}):
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
