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
  - to the per-ray walk: screened visibility equal to the unscreened walk,
    and cut-screened closest hits equal to the walk's.
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
