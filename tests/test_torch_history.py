"""Port parity: accel/history.py of dxrpathtracer_tpu_torch (temporal hit
reuse, csrc/history.cu's module) and the occluder ids of the any-hit walks,
against dxrpathtracer_tpu.

On the CPU the port runs the kernels' plain versions. They are held
  - byte for byte: build_tri_table against the JAX package's, on BoxTest,
    the soup and the ties scene of
    dxrpathtracer_tpu_torch/tools/traverse_cases.py;
  - bit for bit against the JAX package's functions (in a subprocess whose
    XLA:CPU emits no FMA, as tests/test_torch_traverse.py runs them):
    revalidate_plain against `_intersect_pred` (ok, t, u, v on every lane);
    seeded_closest and seeded_any over the port's packet and per-ray W8
    walks against the JAX ones over its own (t, tri id, u, v, visibility
    and the new history); any_hit_rec and packet_any_hit_rec (visibility
    and occluder id) against JAX's. Each on the soup and the ties scene
    (padded to whole packets) and on BoxTest's camera rays and the sun rays
    from their hits; the predictions mix true hits, -1, triangles the ray
    misses and hits beyond t_max (the lane's t_max cut below its hit), and
    a fifth of the lanes are inactive;
  - end to end: a 128x64 BoxTest session with DXRPT_HISTORY=1 renders 3
    samples bit-equal to the session without it, and within rel-RMSE 1e-4
    of the JAX session with DXRPT_HISTORY=1 (same subprocess), whose
    history, laid out by convert.history_from_reference, equals the
    port's; the history resets on a restart and is dropped by
    use_geometry.
The kernel is held against the plain version on the card by chip_smoke.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

torch = pytest.importorskip("torch")

from dxrpathtracer_tpu.accel.history import \
    build_tri_table as jax_tri_table  # noqa: E402
from dxrpathtracer_tpu.accel.lbvh import build_bvh  # noqa: E402
from dxrpathtracer_tpu_torch.accel import history, packet, traverse  # noqa: E402
from dxrpathtracer_tpu_torch.app.session import RenderSession  # noqa: E402
from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes  # noqa: E402
from dxrpathtracer_tpu_torch.convert import (bvh_from_numpy,  # noqa: E402
                                             history_from_reference)
from dxrpathtracer_tpu_torch.render import integrator  # noqa: E402
from dxrpathtracer_tpu_torch.scene.registry import load_scene  # noqa: E402
from dxrpathtracer_tpu_torch.tools import traverse_cases  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAY_FIELDS = ("o", "d", "tmin", "tmax", "active")
W, H, SAMPLES = 128, 64, 3
CASES = ("soup", "ties", "box_camera", "box_sun")
ROUTES = ("packet", "ray")
# (lanes whose t, lanes whose visibility) differ between the seeded and
# the unseeded walk
SEEDED_DIFFERS = {("ties", "packet"): (0, 4)}


def _tris(case):
    """(v0, v1, v2) of a case's scene."""
    if case.startswith("box"):
        box, _ = load_scene(Scenes.BoxTest)
        pos, tri = box.positions.numpy(), box.tri_idx.numpy()
        return pos[tri[:, 0]], pos[tri[:, 1]], pos[tri[:, 2]]
    return traverse_cases.cases(0)[case][0]


def _indexed(v0, v1, v2):
    t = v0.shape[0]
    pos = np.concatenate([v0, v1, v2]).astype(np.float32)
    tri = np.arange(3 * t, dtype=np.int32).reshape(3, t).T.copy()
    return pos, tri


def _port_bvh(tris):
    j = build_bvh(*tris, width=8)
    return bvh_from_numpy(np.asarray(j.table), j.num_rows, j.max_depth,
                          j.root_code, 8)


def _box_rays(bvh):
    """BoxTest's camera rays of one 64x32 sample in packet-tile order, and
    the sun rays from their hits (inactive where the camera ray missed)."""
    sess = RenderSession(AppSettings(current_scene=Scenes.BoxTest), 64, 32,
                         device="cpu")
    o, d, length, _ = integrator.raygen(sess.settings,
                                        sess.frame_constants(0), 64, 32,
                                        "cpu")
    dims = integrator._packet_tile_dims(32, 64)
    o, d, length = (integrator._tile_order(x, 32, 64, *dims)
                    for x in (o, d, length))
    n = o.shape[0]
    cam = dict(o=o.numpy(), d=d.numpy(), tmin=np.zeros(n, np.float32),
               tmax=length.numpy(), active=np.ones(n, bool))
    rec = traverse.closest_hit(bvh, o, d, 0.0, length)
    sun = np.asarray(sess.settings.sun_direction, np.float32)
    sun = np.tile(sun / np.linalg.norm(sun), (n, 1)).astype(np.float32)
    p = (o + d * rec.t[:, None]).numpy()
    sun_rays = dict(o=(p + 1e-3 * sun).astype(np.float32), d=sun,
                    tmin=np.full(n, 1e-4, np.float32),
                    tmax=np.full(n, 1e30, np.float32),
                    active=rec.hit.numpy().copy())
    return cam, sun_rays


def _predict(rays, bvh, ntri, seed):
    """traverse_cases.history_predictions for the rays, from the port's
    per-ray walk: (rays with their t_max and activity, closest and occluder
    predictions)."""
    r = tuple(torch.from_numpy(np.ascontiguousarray(rays[f]))
              for f in RAY_FIELDS)
    rec = traverse.closest_hit(bvh, *r)
    _, occ = traverse.any_hit_rec(bvh, *r)
    return traverse_cases.history_predictions(
        rays, rec.tri_id.numpy(), rec.t.numpy(), occ.numpy(), ntri, seed)


_SCRIPT = r"""
import os
import sys
from functools import partial
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from dxrpathtracer_tpu.accel import history, packet, traverse
from dxrpathtracer_tpu.accel.lbvh import FlatBVH

inp = dict(np.load(sys.argv[1]))
out = {}
walks = {"packet": (packet.packet_closest_hit, packet.packet_any_hit_rec),
         "ray": (traverse.closest_hit, traverse.any_hit_rec)}
for case in sorted({k.split("__")[0] for k in inp if "__" in k}):
    g = lambda f: jnp.asarray(inp[case + "__" + f])
    c = inp[case + "__const"]
    bvh = FlatBVH(table=g("table"), num_rows=int(c[0]), max_depth=int(c[1]),
                  root_code=int(c[2]), width=8)
    table = g("tri_table")
    rays = [g(f) for f in ("o", "d", "tmin", "tmax", "active")]
    res = jax.jit(history._intersect_pred)(table, g("pred_prim"), *rays[:4])
    for f, x in zip(("ok", "t", "u", "v"), res):
        out[case + "__reval__" + f] = np.asarray(x)
    for route, (closest, any_rec) in walks.items():
        key = case + "__" + route
        rec, newp = jax.jit(lambda *a: history.seeded_closest(
            partial(closest, bvh), table, *a))(g("pred_prim"), *rays)
        for f in ("t", "tri_id", "u", "v"):
            out[key + "__closest__" + f] = np.asarray(getattr(rec, f))
        out[key + "__closest__pred"] = np.asarray(newp)
        vis, news = jax.jit(lambda *a: history.seeded_any(
            partial(any_rec, bvh), table, *a))(g("pred_sun"), *rays)
        out[key + "__any__vis"] = np.asarray(vis)
        out[key + "__any__pred"] = np.asarray(news)
        vis, occ = jax.jit(partial(any_rec, bvh))(*rays)
        out[key + "__rec__vis"] = np.asarray(vis)
        out[key + "__rec__occ"] = np.asarray(occ)

os.environ["DXRPT_HISTORY"] = "1"
from dxrpathtracer_tpu.app.session import RenderSession
from dxrpathtracer_tpu.app.settings import AppSettings, Scenes
w, h, samples = (int(x) for x in inp["frame"])
sess = RenderSession(settings=AppSettings(current_scene=Scenes.BoxTest,
                                          sqrt_num_samples=2,
                                          max_path_length=3),
                     width=w, height=h)
assert sess._tri_table is not None
out["image"] = np.asarray(sess.render_to_completion(max_samples=samples))
for k in ("prim_tri", "sun_tri"):
    for i, slab in enumerate(sess._hist_slabs):
        out["hist__%s__%d" % (k, i)] = np.asarray(slab[k])
np.savez(sys.argv[2], **out)
"""


def _run_reference(inputs, tmp):
    src, dst = tmp / "in.npz", tmp / "out.npz"
    np.savez(src, **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    for k in ("DXRPT_HISTORY", "DXRPT_RASTER_MIN_PIXELS", "DXRPT_PROXY_SEED"):
        env.pop(k, None)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, str(src), str(dst)],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(dst))


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """{case: (port W8 table, tri table, rays, pred_prim, pred_sun)} and
    the JAX package's results on them."""
    out, inputs = {}, {}
    box_bvh = _port_bvh(_tris("box"))
    box_cam, box_sun = _box_rays(box_bvh)
    for i, case in enumerate(CASES):
        tris = _tris(case)
        bvh = box_bvh if case.startswith("box") else _port_bvh(tris)
        rays = {"box_camera": box_cam, "box_sun": box_sun}.get(case)
        if rays is None:
            rays = traverse_cases.pad_to_packets(
                traverse_cases.cases(0)[case][1])
        table = history.build_tri_table(*_indexed(*tris))
        rays, prim, sun = _predict(rays, bvh, table.shape[0], seed=10 + i)
        out[case] = (bvh, torch.from_numpy(table), rays, prim, sun)
        for f in RAY_FIELDS:
            inputs[f"{case}__{f}"] = rays[f]
        inputs[f"{case}__pred_prim"], inputs[f"{case}__pred_sun"] = prim, sun
        inputs[f"{case}__tri_table"] = table
        inputs[f"{case}__table"] = bvh.table.numpy()
        inputs[f"{case}__const"] = np.asarray([bvh.num_rows, bvh.max_depth,
                                               bvh.root_code])
    inputs["frame"] = np.asarray([W, H, SAMPLES])
    return out, _run_reference(inputs, tmp_path_factory.mktemp("history"))


def _t(case_rays):
    return tuple(torch.from_numpy(np.ascontiguousarray(case_rays[f]))
                 for f in RAY_FIELDS)


def _assert_bits(got, want, what):
    got = got.numpy()
    if got.dtype == np.float32:
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("scene", ["boxtest", "soup", "ties"])
def test_tri_table_byte_equal(scene):
    pos, tri = _indexed(*_tris("box" if scene == "boxtest" else scene))
    if scene == "boxtest":
        box, _ = load_scene(Scenes.BoxTest)
        pos, tri = box.positions.numpy(), box.tri_idx.numpy()
    got, want = history.build_tri_table(pos, tri), jax_tri_table(pos, tri)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == (tri.shape[0], 9)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("case", CASES)
def test_revalidate_matches_jax_bit_for_bit(cases, case):
    port, ref = cases
    bvh, table, rays, prim, _ = port[case]
    o, d, tmin, tmax, act = _t(rays)
    ok, t, u, v = history.revalidate(table, torch.from_numpy(prim), o, d,
                                     tmin, tmax, act)
    want_ok = ref[f"{case}__reval__ok"] & rays["active"]
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    for f, x in (("t", t), ("u", u), ("v", v)):
        _assert_bits(x, ref[f"{case}__reval__{f}"], f)
    # every kind of prediction reaches its case: held, -1, a miss, beyond
    # t_max, inactive
    held = ok.numpy()
    print(f"{case}: {held.sum()} of {len(held)} predictions hold")
    assert 0 < held.sum() < len(held)
    assert (prim < 0).any() and not held[prim < 0].any()
    assert not held[~rays["active"]].any()
    assert ((prim >= 0) & rays["active"] & ~held).any()


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", CASES)
def test_seeded_walks_match_jax(cases, case, route):
    """seeded_closest and seeded_any over the port's walks equal JAX's over
    its own: every output and the new history."""
    port, ref = cases
    bvh, table, rays, prim, sun = port[case]
    r = _t(rays)
    if route == "packet":
        closest = lambda *a: packet.packet_closest_hit(bvh, *a)  # noqa: E731
        any_rec = lambda *a: packet.packet_any_hit_rec(bvh, *a)  # noqa: E731
    else:
        closest = lambda *a: traverse.closest_hit(bvh, *a)  # noqa: E731
        any_rec = lambda *a: traverse.any_hit_rec(bvh, *a)  # noqa: E731
    key = f"{case}__{route}"
    rec, newp = history.seeded_closest(closest, table, torch.from_numpy(prim),
                                       *r)
    for f in ("t", "tri_id", "u", "v"):
        _assert_bits(getattr(rec, f), ref[f"{key}__closest__{f}"], f)
    _assert_bits(newp, ref[f"{key}__closest__pred"], "prim history")
    vis, news = history.seeded_any(any_rec, table, torch.from_numpy(sun), *r)
    _assert_bits(vis, ref[f"{key}__any__vis"], "visibility")
    _assert_bits(news, ref[f"{key}__any__pred"], "sun history")
    # against the unseeded walk: equal, but on the ties scene's face-aligned
    # rays through the packet walk, whose slab test of a flat box depends on
    # the bound (both packages alike, as held above): counted and pinned
    plain_vis = any_rec(*r)[0]
    plain = closest(*r)
    t_diff = plain.t.view(torch.int32) != rec.t.view(torch.int32)
    tie = (plain.tri_id != rec.tri_id) & ~t_diff
    diff = (int(t_diff.sum()), int((plain_vis != vis).sum()))
    print(f"{case} {route}: against the unseeded walk, t differs on "
          f"{diff[0]} lanes, visibility on {diff[1]}; another triangle at "
          f"equal t on {int(tie.sum())}")
    assert diff == SEEDED_DIFFERS.get((case, route), (0, 0))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", CASES)
def test_occluder_ids_match_jax(cases, case, route):
    """any_hit_rec / packet_any_hit_rec: visibility and occluder id equal
    to JAX's on every lane; -1 where the lane is inactive or
    unoccluded."""
    port, ref = cases
    bvh, _, rays, _, _ = port[case]
    fn = packet.packet_any_hit_rec if route == "packet" else \
        traverse.any_hit_rec
    vis, occ = fn(bvh, *_t(rays))
    key = f"{case}__{route}__rec"
    _assert_bits(vis, ref[key + "__vis"], "visibility")
    _assert_bits(occ, ref[key + "__occ"], "occluder")
    occ = occ.numpy()
    assert (occ[~rays["active"]] == -1).all()
    assert ((occ >= 0) == (vis.numpy() == 0)).all()
    assert 0 < (occ >= 0).sum() < rays["active"].sum()


def test_revalidate_routes_by_device():
    """The plain version on CPU tensors; no route for another device."""
    table = torch.zeros((4, 9))
    lanes = torch.zeros(3, dtype=torch.int32)
    ok, *_ = history.revalidate(table, lanes, torch.zeros((3, 3)),
                                torch.ones((3, 3)), 0.0, 1.0)
    assert ok.dtype == torch.bool and not bool(ok.any())
    with pytest.raises(ValueError, match="no history revalidation"):
        history.revalidate(table.to("meta"), lanes.to("meta"),
                           torch.zeros((3, 3), device="meta"),
                           torch.ones((3, 3), device="meta"), 0.0, 1.0)


def _session(monkeypatch, on):
    if on:
        monkeypatch.setenv("DXRPT_HISTORY", "1")
    else:
        monkeypatch.delenv("DXRPT_HISTORY", raising=False)
    return RenderSession(AppSettings(current_scene=Scenes.BoxTest,
                                     sqrt_num_samples=2, max_path_length=3),
                         W, H, device="cpu")


def test_session_history_matches_jax(cases, monkeypatch):
    _, ref = cases
    calls = []
    seeded = history.revalidate

    def counted(*a, **kw):
        calls.append(1)
        return seeded(*a, **kw)

    monkeypatch.setattr(history, "revalidate", counted)
    on = _session(monkeypatch, True)
    off = _session(monkeypatch, False)
    assert on.tri_table is not None and off.tri_table is None
    assert off.history is None
    for _ in range(SAMPLES):
        on.render_frame()
        off.render_frame()
    # two revalidations a sample (the camera and the sun rays)
    assert len(calls) == 2 * SAMPLES
    assert torch.equal(on.accum, off.accum)
    img = on.accum.numpy()
    want = ref["image"]
    rel = float(np.sqrt(np.mean((img - want) ** 2)) / np.abs(want).max())
    print(f"BoxTest {W}x{H}x{SAMPLES}, DXRPT_HISTORY=1: rel RMSE vs JAX "
          f"{rel:.3e}")
    assert rel <= 1e-4
    slabs = sorted({int(k.split("__")[2]) for k in ref if k.startswith(
        "hist__")})
    jhist = history_from_reference(
        [{k: ref[f"hist__{k}__{i}"] for k in ("prim_tri", "sun_tri")}
         for i in slabs], W, H)
    for k in ("prim_tri", "sun_tri"):
        got = on.history[k]
        assert got.dtype == torch.int32 and got.shape == (W * H,)
        assert bool((got >= 0).any())
        assert torch.equal(got, jhist[k]), k


def test_history_resets_on_restart_and_use_geometry(monkeypatch):
    sess = _session(monkeypatch, True)
    sess.render_frame()
    assert bool((sess.history["prim_tri"] >= 0).any())
    # a restart-relevant change empties it with the accumulation
    sess.settings = sess.settings.replace(roughness_scale=0.5)
    sess.update()
    assert sess.sample_idx == 0
    assert all(bool((x == -1).all()) for x in sess.history.values())
    sess.render_frame()
    assert bool((sess.history["sun_tri"] >= 0).any())
    # moved geometry drops the table and the history with it
    sess.use_geometry(sess.scene, sess.bvh)
    assert sess.tri_table is None and sess.history is None
    sess.render_frame()
    assert sess.history is None and bool(sess.accum.isfinite().all())


def test_history_from_reference_lays_out_slabs():
    """Two JAX row slabs (each in its own 2x64 tile order) become the
    port's whole-frame 4x32 tile order."""
    h, w = 4, 128
    ids = torch.arange(h * w, dtype=torch.int32)  # row-major pixel ids
    slab_h = h // 2
    jdims = integrator._packet_tile_dims(slab_h, w)
    slabs = [{k: integrator._tile_order(ids[i * slab_h * w:
                                            (i + 1) * slab_h * w],
                                        slab_h, w, *jdims).numpy()
              for k in ("prim_tri", "sun_tri")} for i in range(2)]
    got = history_from_reference(slabs, w, h)
    dims = integrator._packet_tile_dims(h, w)
    assert dims != jdims
    assert torch.equal(got["prim_tri"],
                       integrator._tile_order(ids, h, w, *dims))
    rows = history_from_reference(slabs, w, h, packet_tiles=False)
    assert not torch.equal(rows["sun_tri"], ids)  # slabs were tiled
    untiled = [{k: ids[i * slab_h * w:(i + 1) * slab_h * w].numpy()
                for k in ("prim_tri", "sun_tri")} for i in range(2)]
    assert torch.equal(history_from_reference(untiled, w, h,
                                              packet_tiles=False)["sun_tri"],
                       ids)
