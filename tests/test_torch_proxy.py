"""Port parity: accel/proxy.py of dxrpathtracer_tpu_torch (the dense-proxy and
AABB-cut screens, csrc/screen.cu's module) against dxrpathtracer_tpu.

On the CPU the port runs the kernels' plain versions. They are held
  - to the JAX package's proxy_blocked and cut_clear, bit for bit on every
    lane, on a seeded triangle soup and the adversarial ties scene of
    dxrpathtracer_tpu_torch/tools/traverse_cases.py, and on the proxy's
    edge cases (traverse_cases.proxy_edge_rays: K = 8 and K = 1,365 on the
    soup, K = 24 on BoxTest; n not a multiple of 32, inactive lanes,
    t_max <= t_min, zero and -0 direction components; the JAX side in a
    subprocess whose XLA:CPU emits no FMA, as tests/test_torch_traverse.py
    runs it, so both round every product);
    The proxy's nearest hit (proxy_closest_plain) is held to JAX's
    proxy_closest the same way (t, tri id, u, v), and seeded_closest's
    walk bound, t * (1 + 1e-5), to JAX's rounding of it;
  - to the per-ray walk: screened visibility equal to the unscreened walk,
    cut-screened closest hits equal to the walk's, and proxy-seeded closest
    hits equal to the walk's; a BoxTest session with DXRPT_PROXY_SEED=1
    renders the image it renders without.
The builders are held byte for byte to the JAX package's (proxy columns
and ids, cut boxes), and the host probe to its value where no direction
component is tiny. The three faults of the JAX module that the port does not
carry over each have a test: a chunk count <= 0 (the port keeps one box),
the probe's reciprocal of a tiny negative component (the port keeps its
sign), and screened_any's cut (the port applies it). Last, a session drops
the grid, proxy and cut when its geometry moves (`use_geometry`; the JAX
`animate` command keeps them). The kernels themselves are held against
the plain versions on the card by chip_smoke.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

torch = pytest.importorskip("torch")

from dxrpathtracer_tpu.accel import proxy as jproxy  # noqa: E402
from dxrpathtracer_tpu_torch.accel import proxy, traverse  # noqa: E402
from dxrpathtracer_tpu_torch.accel.bvh import build_bvh  # noqa: E402
from dxrpathtracer_tpu_torch.app.session import RenderSession  # noqa: E402
from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes  # noqa: E402
from dxrpathtracer_tpu_torch.convert import (cut_from_reference,  # noqa: E402
                                             proxy_from_reference)
from dxrpathtracer_tpu_torch.scene.registry import load_scene  # noqa: E402
from dxrpathtracer_tpu_torch.tools import traverse_cases  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAY_FIELDS = ("o", "d", "tmin", "tmax", "active")


def _indexed(v0, v1, v2):
    """(positions, tri_idx) of a triangle soup."""
    t = v0.shape[0]
    pos = np.concatenate([v0, v1, v2]).astype(np.float32)
    tri = np.stack([np.arange(t), np.arange(t) + t,
                    np.arange(t) + 2 * t], 1).astype(np.int32)
    return pos, tri


SCENES = ("boxtest", "soup", "ties")
# the proxy's edge cases: (scene, K)
EDGE_CASES = {"k8": ("soup", 8), "box_k24": ("boxtest", 128),
              "k1365": ("soup", proxy.MAX_COLUMNS)}


def _scene(name):
    """(positions, tri_idx, tri_alpha or None) of BoxTest or of a case
    scene (the soup with a seeded alpha mask)."""
    if name == "boxtest":
        box, _ = load_scene(Scenes.BoxTest)
        return box.positions.numpy(), box.tri_idx.numpy(), None
    pos, tri = _indexed(*traverse_cases.cases(0)[name][0])
    alpha = (np.random.default_rng(3).random(tri.shape[0]) < 0.2
             if name == "soup" else None)
    return pos, tri, alpha


_SCRIPT = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from dxrpathtracer_tpu.accel import proxy

inp = dict(np.load(sys.argv[1]))
out = {}
for case in sorted({k.split("__")[0] for k in inp}):
    g = lambda f: inp[case + "__" + f]
    px = proxy.build_dense_proxy(g("pos"), g("tri"), k=int(g("k")))
    cut = proxy.build_aabb_cut(g("pos"), g("tri"), c=128)
    rays = [jnp.asarray(g(f)) for f in ("o", "d", "tmin", "tmax", "active")]
    out[case + "__blocked"] = np.asarray(jax.jit(proxy.proxy_blocked)(px, *rays))
    out[case + "__clear"] = np.asarray(jax.jit(proxy.cut_clear)(cut, *rays))
    res = jax.jit(proxy.proxy_closest)(px, *rays)
    for f, x in zip(("t", "tri_id", "u", "v"), res):
        out[case + "__closest__" + f] = np.asarray(x)
    # seeded_closest's walk bound, as JAX rounds it
    pt, ptri = res[0], res[1]
    out[case + "__bound"] = np.asarray(jax.jit(
        lambda pt, ptri: jnp.where(ptri >= 0, pt * (1.0 + 1e-5), pt))(
            pt, ptri))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's screens on each case's rays, its XLA:CPU without
    FMA."""
    tmp = tmp_path_factory.mktemp("proxy_ref")
    inputs = {}
    for case in (*traverse_cases.cases(0), *EDGE_CASES):
        pos, tri, k, rays = _case(case)
        inputs[case + "__pos"], inputs[case + "__tri"] = pos, tri
        inputs[case + "__k"] = np.asarray(k)
        for f in RAY_FIELDS:
            inputs[case + "__" + f] = rays[f]
    src, dst = tmp / "in.npz", tmp / "out.npz"
    np.savez(src, **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, str(src), str(dst)],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(dst))


def _case(case):
    """(positions, tri_idx, K, rays) of a case: the soup or ties scene with
    its rays and K = 128, or an edge case's scene, K and rays."""
    if case in EDGE_CASES:
        scene, k = EDGE_CASES[case]
        pos, tri, _ = _scene(scene)
        return pos, tri, k, traverse_cases.proxy_edge_rays()
    tris, rays = traverse_cases.cases(0)[case]
    return (*_indexed(*tris), proxy.PROXY_K, rays)


def _rays(case, n=None):
    """The case's rays (the first n)."""
    rays = traverse_cases.cases(0)[case][1]
    return tuple(torch.from_numpy(np.ascontiguousarray(rays[f][:n]))
                 for f in RAY_FIELDS)


@pytest.mark.parametrize("name", SCENES)
def test_builders_match_jax_byte_for_byte(name):
    pos, tri, alpha = _scene(name)
    got = proxy.build_dense_proxy(pos, tri, tri_alpha=alpha)
    ref = jproxy.build_dense_proxy(pos, tri, tri_alpha=alpha)
    want = proxy_from_reference(ref)
    assert got.k == ref.k == min(128, tri.shape[0])
    np.testing.assert_array_equal(got.tris.numpy().view(np.int32),
                                  want.tris.numpy().view(np.int32))
    np.testing.assert_array_equal(got.tri_id.numpy(), want.tri_id.numpy())
    if alpha is not None:
        assert not alpha[got.tri_id.numpy()].any()
    cut = proxy.build_aabb_cut(pos, tri)
    jcut = jproxy.build_aabb_cut(pos, tri)
    np.testing.assert_array_equal(
        cut.boxes.numpy().view(np.int32),
        cut_from_reference(jcut).boxes.numpy().view(np.int32))


@pytest.mark.parametrize("name", SCENES)
def test_probe_fraction_matches_jax(name):
    pos, tri, _ = _scene(name)
    cut = proxy.build_aabb_cut(pos, tri)
    got = proxy.probe_clear_fraction(cut, pos, tri)
    want = jproxy.probe_clear_fraction(jproxy.build_aabb_cut(pos, tri), pos,
                                       tri)
    print(f"{name}: clear fraction {got}")
    assert got == want


@pytest.mark.parametrize("case", ["soup", "ties", *EDGE_CASES])
def test_plain_screens_match_jax_bit_for_bit(reference, case):
    pos, tri, k, rays = _case(case)
    px = proxy.build_dense_proxy(pos, tri, k=k)
    cut = proxy.build_aabb_cut(pos, tri)
    rays = tuple(torch.from_numpy(np.ascontiguousarray(rays[f]))
                 for f in RAY_FIELDS)
    blocked = proxy.proxy_blocked(px, *rays)
    clear = proxy.cut_clear(cut, *rays)
    np.testing.assert_array_equal(blocked.numpy(),
                                  reference[case + "__blocked"])
    np.testing.assert_array_equal(clear.numpy(), reference[case + "__clear"])
    print(f"{case}: K {px.k}, {int(blocked.sum())} blocked, "
          f"{int(clear.sum())} clear of {rays[0].shape[0]}")
    assert 0 < int(blocked.sum()) and 0 < int(clear.sum())
    if case in EDGE_CASES:
        o, d, tmin, tmax, act = rays
        assert px.k == {"k8": 8, "box_k24": 24, "k1365": 1365}[case]
        assert rays[0].shape[0] % 32 != 0
        # inactive lanes and empty segments are never blocked; some lanes
        # are active with a segment but unblocked
        assert not bool(blocked[~act | (tmax <= tmin)].any())
        assert bool((act & (tmax <= tmin)).any())
        assert bool((act & ~blocked).any())
        assert bool(((d == 0) & torch.signbit(d)).any())


@pytest.mark.parametrize("case", ["soup", "ties", *EDGE_CASES])
def test_plain_proxy_closest_matches_jax_bit_for_bit(reference, case):
    """proxy_closest_plain against JAX proxy_closest (t, tri id, u, v on
    every lane), and seeded_closest's walk bound pt * (1 + 1e-5) as JAX
    rounds it."""
    pos, tri, k, rays = _case(case)
    px = proxy.build_dense_proxy(pos, tri, k=k)
    rays = tuple(torch.from_numpy(np.ascontiguousarray(rays[f]))
                 for f in RAY_FIELDS)
    got = proxy.proxy_closest(px, *rays)
    for f in ("t", "tri_id", "u", "v"):
        x, want = getattr(got, f).numpy(), reference[case + "__closest__" + f]
        if x.dtype == np.float32:
            x, want = x.view(np.int32), want.view(np.int32)
        np.testing.assert_array_equal(x, want, err_msg=f)
    slack = torch.tensor(proxy.SEED_SLACK)
    bound = torch.where(got.tri_id >= 0, got.t * slack, got.t)
    np.testing.assert_array_equal(bound.numpy().view(np.int32),
                                  reference[case + "__bound"].view(np.int32))
    hit = got.tri_id.numpy() >= 0
    print(f"{case}: K {px.k}, {int(hit.sum())} proxy hits of "
          f"{rays[0].shape[0]}")
    assert 0 < hit.sum() < rays[0].shape[0]
    # a lane without a hit keeps t = t_max, u = v = 0; hits are the proxy's
    np.testing.assert_array_equal(got.t.numpy()[~hit], rays[3].numpy()[~hit])
    assert not got.u.numpy()[~hit].any() and not got.v.numpy()[~hit].any()
    assert np.isin(got.tri_id.numpy()[hit], px.tri_id.numpy()).all()
    assert not hit[~rays[4].numpy()].any()


@pytest.mark.parametrize("case", ["soup", "ties"])
def test_seeded_closest_equals_the_walk(case):
    """The proxy-seeded per-ray walk gives the unseeded walk's hits (JAX
    tests/test_proxy.py::test_seeded_closest_equals_plain), and the seed
    bounds some lanes."""
    tris, _ = traverse_cases.cases(0)[case]
    pos, tri = _indexed(*tris)
    px = proxy.build_dense_proxy(pos, tri)
    bvh = build_bvh(*tris, width=32)
    rays = _rays(case)
    plain = traverse.closest_hit(bvh, *rays)
    seeded = proxy.seeded_closest(
        lambda *r: traverse.closest_hit(bvh, *r), px, *rays)
    for f in ("t", "u", "v"):
        assert torch.equal(getattr(plain, f).view(torch.int32),
                           getattr(seeded, f).view(torch.int32)), f
    assert torch.equal(plain.tri_id, seeded.tri_id)
    assert bool((proxy.proxy_closest(px, *rays).tri_id >= 0).any())


def test_session_proxy_seed_renders_the_same_image(monkeypatch):
    """BoxTest with DXRPT_PROXY_SEED=1 (per-ray closest hits proxy-seeded)
    renders the image it renders without, bit for bit."""
    calls = []
    seed = proxy.proxy_closest

    def counted(*a, **kw):
        calls.append(1)
        return seed(*a, **kw)

    monkeypatch.setattr(proxy, "proxy_closest", counted)
    imgs = {}
    for on in (False, True):
        if on:
            monkeypatch.setenv("DXRPT_PROXY_SEED", "1")
        else:
            monkeypatch.delenv("DXRPT_PROXY_SEED", raising=False)
        sess = RenderSession(AppSettings(current_scene=Scenes.BoxTest,
                                         max_path_length=3), 64, 32,
                             device="cpu")
        sess.render_frame()
        sess.render_frame()
        imgs[on] = sess.accum
        # one seeded closest hit a sample (depth 2; packets take depth 1)
        assert len(calls) == (2 if on else 0)
    assert torch.equal(imgs[False], imgs[True])


@pytest.mark.parametrize("case", ["soup", "ties"])
def test_screens_leave_the_walk_unchanged(case):
    tris, _ = traverse_cases.cases(0)[case]
    pos, tri = _indexed(*tris)
    px = proxy.build_dense_proxy(pos, tri)
    cut = proxy.build_aabb_cut(pos, tri)
    bvh = build_bvh(*tris, width=32)
    o, d, tmin, tmax, act = _rays(case, 1280)
    walk = lambda *r: traverse.any_hit(bvh, *r)  # noqa: E731
    got = proxy.screened_any(walk, o, d, tmin, tmax, act, proxy=px, cut=cut)
    assert torch.equal(got, walk(o, d, tmin, tmax, act))
    # a lane the cut clears is a miss of the closest-hit walk too
    clear = proxy.cut_clear(cut, o, d, tmin, tmax, act)
    rec = traverse.closest_hit(bvh, o, d, tmin, tmax, act)
    assert not bool(rec.hit[clear].any())
    masked = traverse.closest_hit(bvh, o, d, tmin, tmax, act & ~clear)
    for f in ("t", "tri_id", "u", "v"):
        assert torch.equal(getattr(masked, f), getattr(rec, f)), f


@pytest.mark.parametrize("c", [0, -3])
def test_cut_keeps_a_box_for_any_chunk_count(c):
    """The JAX build leaves no box for c = 0 (and fails for c < 0), so
    every lane is "clear" (a sky-only render); the port's keeps one, which
    covers the scene."""
    tris, rays = traverse_cases.cases(0)["soup"]
    pos, tri = _indexed(*tris)
    if c == 0:
        assert jproxy.build_aabb_cut(pos, tri, c=c).c == 0
    cut = proxy.build_aabb_cut(pos, tri, c=c)
    assert cut.c == 1
    bvh = build_bvh(*tris, width=8)
    o, d, tmin, tmax, act = _rays("soup")
    hit = traverse.closest_hit(bvh, o, d, tmin, tmax, act).hit
    clear = proxy.cut_clear(cut, o, d, tmin, tmax, act)
    assert bool(hit.any()) and not bool((clear & hit).any())


def test_probe_keeps_the_sign_of_tiny_components():
    """The JAX probe nudges a tiny component to +1e-12 whatever its sign;
    the port's, like cut_clear, keeps the sign (-0 counts as positive)."""
    d = np.array([[-1e-13, 1e-13, -0.0], [0.5, -2e-12, 0.0]])
    got = proxy.nudged_reciprocal(d)
    np.testing.assert_array_equal(np.sign(got), [[-1, 1, 1], [1, -1, 1]])
    # the same as cut_clear's (torch) reciprocal, in f32
    ref = traverse.safe_inv(torch.from_numpy(d.astype(np.float32)))
    np.testing.assert_array_equal(np.sign(got), np.sign(ref.numpy()))


def test_screened_any_applies_its_cut():
    """JAX screened_any's cut parameter is never passed (its caller applies
    the cut itself); the port's applies it: the walk sees neither cleared
    nor blocked lanes, and the result equals the walk's."""
    tris, _ = traverse_cases.cases(0)["soup"]
    pos, tri = _indexed(*tris)
    px = proxy.build_dense_proxy(pos, tri)
    cut = proxy.build_aabb_cut(pos, tri)
    bvh = build_bvh(*tris, width=8)
    o, d, tmin, tmax, act = _rays("soup")
    seen = []

    def walk(*r):
        seen.append(r[4].clone())
        return traverse.any_hit(bvh, *r)

    got = proxy.screened_any(walk, o, d, tmin, tmax, act, proxy=px, cut=cut)
    clear = proxy.cut_clear(cut, o, d, tmin, tmax, act)
    blocked = proxy.proxy_blocked(px, o, d, tmin, tmax, act & ~clear)
    assert len(seen) == 1 and bool(clear.any()) and bool(blocked.any())
    assert torch.equal(seen[0], act & ~clear & ~blocked)
    assert torch.equal(got, traverse.any_hit(bvh, o, d, tmin, tmax, act))


def test_use_geometry_drops_grid_proxy_and_cut():
    """Moved geometry (the animate command) makes the grid, the proxy and
    the cut stale: the session drops them and builds no grid after."""
    sess = RenderSession(AppSettings(current_scene=Scenes.BoxTest), 16, 16,
                         device="cpu")
    assert sess.proxy is not None and sess.cut is not None
    assert sess.cut_clear_fraction >= proxy.CUT_MIN_CLEAR
    assert sess.sun_grid is None  # built by the first path-traced sample
    sess.render_frame()
    assert sess.sun_grid is not None and sess.sun_grid_build_s is not None
    sess.use_geometry(sess.scene, sess.bvh)
    assert sess.proxy is None and sess.cut is None and sess.sun_grid is None
    sess.render_frame()
    assert sess.sun_grid is None and sess.update_sun_grid() is None
    assert bool(sess.accum.isfinite().all())
