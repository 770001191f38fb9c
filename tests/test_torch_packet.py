"""Port parity: accel/packet.py of dxrpathtracer_tpu_torch (the packet walk,
csrc/packet.cu's module), the integrator's routing by the engine fields, and
the engines-on frame, against dxrpathtracer_tpu.

  - The plain packet walk (the kernel's plain version, which the port runs
    on the CPU) against the JAX package's packet_closest_hit and
    packet_any_hit on the same W8 tables: t, tri id, u and v bit-equal,
    visibility equal, on the adversarial ties case of
    dxrpathtracer_tpu_torch/tools/traverse_cases.py, on a seeded soup
    with both incoherent rays and camera-like packets, and on the packet
    edge cases of traverse_cases.packet_edge_cases on the soup's port-built
    W8 table (a packet with no active ray, packets with one, a packet whose
    rays all hit in the first leaf, a packet that reaches the table's
    deepest stack; the JAX side in a subprocess whose XLA:CPU emits no FMA,
    as tests/test_torch_traverse.py runs it).
  - Against the port's per-ray walk: t bit-equal on every lane of the soup
    (the lanes whose triangle differs, equal-t ties, are counted); on the
    ties case, rays along box faces may find a nearer hit than the per-ray
    walk's slab test lets it reach (the reference's packets do too).
  - The tile order and tile choice equal to the JAX package's.
  - A RenderSession frame with the default settings (packets, sun grid,
    dense proxy and, on BoxTest, the AABB cut all on) against the JAX
    package's session with its defaults: BoxTest 128x64, 2 samples,
    relative RMSE (scaled by max|ref|) <= 1e-4.
  - Routing: with the defaults every engine is reached; with one field off
    that engine is not, and the image stays within 1e-4 of the defaults'.
The kernel is held against the plain walk on the card by chip_smoke.py.
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
from dxrpathtracer_tpu_torch.app.session import RenderSession  # noqa: E402
from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes  # noqa: E402
from dxrpathtracer_tpu_torch.accel.bvh import build_bvh  # noqa: E402
from dxrpathtracer_tpu_torch.convert import bvh_from_numpy  # noqa: E402
from dxrpathtracer_tpu_torch.render import integrator  # noqa: E402
from dxrpathtracer_tpu_torch.tools import traverse_cases  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAY_FIELDS = ("o", "d", "tmin", "tmax", "active")
W, H, SAMPLES = 128, 64, 2
TILE_SIZES = ((64, 128), (27, 48), (36, 64), (1080, 1920), (135, 240),
              (16, 8), (5, 256))


def _coherent(n=2048, seed=9):
    """Camera-like rays at the soup, 8 x 16 pixel tiles in packet order."""
    rng = np.random.default_rng(seed)
    h, w = 32, n // 32
    yy, xx = np.meshgrid(np.linspace(-0.6, 0.6, h), np.linspace(-1, 1, w),
                         indexing="ij")
    d = np.stack([xx, yy, np.ones_like(xx)], -1).reshape(h, w, 3)
    d = d.reshape(h // 8, 8, w // 16, 16, 3).swapaxes(1, 2).reshape(-1, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = np.tile(np.float32([0.3, -0.2, -14.0]), (n, 1))
    tmin = rng.choice(np.float32([0.0, 1e-4]), n)
    tmax = rng.choice(np.float32([1e30, 14.0]), n, p=[0.8, 0.2])
    return dict(o=o, d=d, tmin=tmin, tmax=tmax, active=rng.random(n) > 0.1)


def _cases():
    """{name: ((v0, v1, v2), rays)}: the ties case, and the soup with four
    packets of its incoherent rays followed by the coherent packets."""
    cases = traverse_cases.cases(0)
    soup_tris, soup_rays = cases["soup"]
    coh = _coherent()
    return {"ties": cases["ties"],
            "soup": (soup_tris, {f: np.concatenate([soup_rays[f][:512],
                                                    coh[f]])
                                 for f in RAY_FIELDS})}


EDGE_CASES = ("no_active", "one_active", "first_leaf", "deep_stack")


def _edges():
    """The port's W8 table of the soup and its packet edge cases: (bvh,
    {name: rays}, {name: slice of the concatenated rays})."""
    tris = traverse_cases.cases(0)["soup"][0]
    bvh = build_bvh(*tris, width=8)
    cases = traverse_cases.packet_edge_cases(*tris, bvh.table.numpy(),
                                             bvh.root_code)
    slices, at = {}, 0
    for name in EDGE_CASES:
        n = len(cases[name]["o"])
        slices[name] = slice(at, at + n)
        at += n
    return bvh, cases, slices


_SCRIPT = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from dxrpathtracer_tpu.accel.lbvh import FlatBVH, build_bvh
from dxrpathtracer_tpu.accel.packet import packet_any_hit, packet_closest_hit
from dxrpathtracer_tpu.app.session import RenderSession
from dxrpathtracer_tpu.app.settings import AppSettings, Scenes
from dxrpathtracer_tpu.render import integrator

inp = dict(np.load(sys.argv[1]))
out = {}
for case in sorted({k.split("__")[0] for k in inp if "__" in k}):
    g = lambda f: inp[case + "__" + f]
    if case == "edges":  # the port's table, given
        c = g("const")
        bvh = FlatBVH(table=jnp.asarray(g("table")), num_rows=int(c[0]),
                      max_depth=int(c[1]), root_code=int(c[2]), width=8)
    else:
        bvh = build_bvh(g("v0"), g("v1"), g("v2"), width=8)
        out[case + "__table"] = np.asarray(bvh.table)
        out[case + "__const"] = np.asarray([bvh.num_rows, bvh.max_depth,
                                            bvh.root_code])
    rays = [jnp.asarray(g(f)) for f in ("o", "d", "tmin", "tmax", "active")]
    rec = jax.jit(packet_closest_hit)(bvh, *rays)
    for f in ("t", "tri_id", "u", "v"):
        out[case + "__" + f] = np.asarray(getattr(rec, f))
    out[case + "__vis"] = np.asarray(jax.jit(packet_any_hit)(bvh, *rays))
for h, w in inp["tile_sizes"]:
    dims = integrator._packet_tile_dims(int(h), int(w))
    out["dims_%d_%d" % (h, w)] = np.asarray(dims if dims else (0, 0))
    if dims:
        x = jnp.arange(h * w * 2, dtype=jnp.int32).reshape(h * w, 2)
        out["tiled_%d_%d" % (h, w)] = np.asarray(
            integrator._tile_order(x, int(h), int(w), *dims))
s = AppSettings(current_scene=Scenes.BoxTest, sqrt_num_samples=2,
                max_path_length=3)
sess = RenderSession(settings=s, width=int(inp["frame_size"][0]),
                     height=int(inp["frame_size"][1]))
out["engines"] = np.asarray([sess.proxy is not None, sess.cut is not None,
                             sess.sun_grid is not None])
out["image"] = np.asarray(sess.render_to_completion(
    max_samples=int(inp["frame_size"][2])))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's packet walks, tile order and engines-on BoxTest
    frame, its XLA:CPU without FMA."""
    tmp = tmp_path_factory.mktemp("packet_ref")
    inputs = {"tile_sizes": np.asarray(TILE_SIZES),
              "frame_size": np.asarray([W, H, SAMPLES])}
    for name, ((v0, v1, v2), rays) in _cases().items():
        for f, a in (("v0", v0), ("v1", v1), ("v2", v2), *rays.items()):
            inputs[name + "__" + f] = np.asarray(a)
    bvh, cases, _ = _edges()
    inputs["edges__table"] = bvh.table.numpy()
    inputs["edges__const"] = np.asarray([bvh.num_rows, bvh.max_depth,
                                         bvh.root_code])
    for f in RAY_FIELDS:
        inputs["edges__" + f] = np.concatenate([cases[c][f]
                                                for c in EDGE_CASES])
    src, dst = tmp / "in.npz", tmp / "out.npz"
    np.savez(src, **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, str(src), str(dst)],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(dst))


def _table_and_rays(reference, name):
    rows, depth, root = (int(v) for v in reference[name + "__const"])
    bvh = bvh_from_numpy(reference[name + "__table"], rows, depth, root, 8)
    rays = _cases()[name][1]
    return bvh, tuple(torch.from_numpy(np.ascontiguousarray(rays[f]))
                      for f in RAY_FIELDS)


def _edge_case(reference, name):
    """The edge case's table, rays and JAX results ({field: array})."""
    bvh, cases, slices = _edges()
    rays = tuple(torch.from_numpy(np.ascontiguousarray(cases[name][f]))
                 for f in RAY_FIELDS)
    ref = {f: reference["edges__" + f][slices[name]]
           for f in ("t", "tri_id", "u", "v", "vis")}
    return bvh, rays, ref


def _check_edge_case(bvh, rays, name):
    """What the edge case is made to reach, by the plain walk's counts."""
    o, d, tmin, tmax, act = rays
    inv = traverse.safe_inv(d)
    stats = {}
    rec = packet.packet_traverse_plain(bvh, o, d, inv, tmin, tmax, act,
                                       first_hit=True, stats=stats)
    packets = act.reshape(-1, packet.PACKET).sum(dim=1)
    if name == "no_active":
        assert packets.tolist() == [0, packet.PACKET]
        assert not bool(rec.hit[:packet.PACKET].any())
    elif name == "one_active":
        assert packets.tolist() == [1, 1, 1]
    elif name == "first_leaf":
        # any hit: every ray hits in the one leaf the packet visits
        assert stats["leaf"] == 1 and bool(rec.hit.all())
    else:
        depth, _ = traverse_cases.deepest_leaf(bvh.table.numpy(),
                                               bvh.root_code)
        height = traverse_cases.packet_stack_height(bvh, rays)
        assert height == depth <= bvh.stack_depth


@pytest.mark.parametrize("name", ["soup", "ties", *EDGE_CASES])
def test_plain_packet_walk_matches_jax_bit_for_bit(reference, name):
    if name in EDGE_CASES:
        bvh, rays, ref = _edge_case(reference, name)
        _check_edge_case(bvh, rays, name)
    else:
        bvh, rays = _table_and_rays(reference, name)
        ref = {f: reference[name + "__" + f]
               for f in ("t", "tri_id", "u", "v", "vis")}
    rec = packet.packet_closest_hit(bvh, *rays)
    for f in ("t", "tri_id", "u", "v"):
        np.testing.assert_array_equal(
            getattr(rec, f).numpy().view(np.int32), ref[f].view(np.int32),
            err_msg=f)
    vis = packet.packet_any_hit(bvh, *rays)
    np.testing.assert_array_equal(vis.numpy(), ref["vis"])
    if name in EDGE_CASES:
        assert int(rec.hit.sum()) <= int(rays[4].sum())
    else:
        assert 0 < int(rec.hit.sum()) < rays[0].shape[0]


@pytest.mark.parametrize("name", ["soup", "ties"])
def test_packet_walk_matches_the_per_ray_walk(reference, name):
    """t is the per-ray walk's on every lane of the soup. On the ties case
    some rays run exactly along box faces with signed-zero direction
    components: the per-ray slab test rejects a box whose triangle the
    triangle test accepts at its edge, while a packet enters the box for a
    neighbour and finds the hit. There the packet's t is nearer, never
    farther (the JAX package's packets do the same: their hits are the
    plain packet walk's, bit for bit)."""
    bvh, rays = _table_and_rays(reference, name)
    stats = {}
    rec = packet.packet_traverse_plain(
        bvh, *rays[:2], traverse.safe_inv(rays[1]), *rays[2:],
        first_hit=False, stats=stats)
    walk = traverse.closest_hit(bvh, *rays)
    t_differs = rec.t.view(torch.int32) != walk.t.view(torch.int32)
    ties = (rec.tri_id != walk.tri_id) & ~t_differs
    print(f"{name}: {int(t_differs.sum())} lanes with another t, "
          f"{int(ties.sum())} equal-t lanes with another triangle, of "
          f"{rays[0].shape[0]}; {stats['internal']} internal and "
          f"{stats['leaf']} leaf packet visits, "
          f"{int(stats['touched'].sum())} rows")
    # the tests the walk needs: live rays of filled, allowed slots and of
    # filled triangles, at most every slot of every visit
    assert 0 < stats["slot_tests"] <= stats["internal"] * 8 * 128
    assert 0 < stats["tri_tests"] <= stats["leaf"] * 12 * 128
    if name == "soup":
        assert not bool(t_differs.any())
        assert int(ties.sum()) <= rays[0].shape[0] // 100 + 1
    assert bool((rec.t[t_differs] < walk.t[t_differs]).all())
    assert bool(rec.hit[t_differs].all())
    assert int(t_differs.sum()) <= rays[0].shape[0] // 100
    # where the hit is the same, so are u and v
    same = ~t_differs & ~ties
    for f in ("u", "v"):
        assert torch.equal(getattr(rec, f)[same], getattr(walk, f)[same])
    if name == "soup":
        assert torch.equal(packet.packet_any_hit(bvh, *rays),
                           traverse.any_hit(bvh, *rays))


def test_tile_order_matches_jax(reference):
    for h, w in TILE_SIZES:
        dims = integrator._packet_tile_dims(h, w)
        assert tuple(reference[f"dims_{h}_{w}"]) == (dims or (0, 0)), (h, w)
        if dims:
            x = torch.arange(h * w * 2, dtype=torch.int32).reshape(h * w, 2)
            tiled = integrator._tile_order(x, h, w, *dims)
            np.testing.assert_array_equal(tiled.numpy(),
                                          reference[f"tiled_{h}_{w}"])
            assert torch.equal(integrator._untile_order(tiled, h, w, *dims),
                               x)


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


def _rel_rmse(img, ref):
    return float(np.sqrt(np.mean((img - ref) ** 2))
                 / (np.abs(ref).max() + 1e-9))


def test_engines_on_frame_matches_jax(reference, monkeypatch):
    calls = _counting(monkeypatch)
    sess = RenderSession(AppSettings(current_scene=Scenes.BoxTest,
                                     sqrt_num_samples=2, max_path_length=3),
                         W, H, device="cpu")
    assert tuple(reference["engines"]) == (True, True, True)
    img = sess.render_to_completion(max_samples=SAMPLES).numpy()
    assert set(calls) == {"packet", "grid", "proxy", "cut"}, calls
    err = _rel_rmse(img, reference["image"])
    print(f"BoxTest {W}x{H}x{SAMPLES}, engines on: rel RMSE vs JAX "
          f"{err:.3e}; engine calls {calls}")
    assert np.isfinite(img).all() and err <= 1e-4


@pytest.mark.parametrize("field", ["enable_packet_traversal",
                                   "enable_sunspace_shadows",
                                   "enable_dense_proxy", "enable_clear_cut",
                                   "packet_shadows_all_depths"])
def test_routing_follows_the_settings(monkeypatch, field):
    calls = _counting(monkeypatch)
    base = AppSettings(current_scene=Scenes.BoxTest, max_path_length=3)
    sess = RenderSession(base, W, H, device="cpu")
    sess.render_frame()
    default, on = dict(calls), sess.accum.clone()
    assert set(default) == {"packet", "grid", "proxy", "cut"}, default
    calls.clear()
    sess.settings = base.replace(**{field: not getattr(base, field)})
    sess.reset_accumulation()
    sess.render_frame()
    engine = {"enable_packet_traversal": "packet",
              "enable_sunspace_shadows": "grid",
              "enable_dense_proxy": "proxy",
              "enable_clear_cut": "cut"}.get(field)
    if engine is None:
        # terminal rays join the packets: one packet walk more per frame
        assert calls["packet"] == default["packet"] + 1, calls
    else:
        assert engine not in calls, calls
    err = _rel_rmse(sess.accum.numpy(), on.numpy())
    print(f"{field} flipped: calls {calls} (defaults {default}), rel RMSE "
          f"vs the defaults {err:.3e}")
    assert err <= 1e-4
