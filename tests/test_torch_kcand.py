"""Port parity: the split alpha route of dxrpathtracer_tpu_torch (the packet
walk's opaque-only and K-candidate modes, csrc/packet.cu's plain twins, the
alpha-only table, the candidates' resolution, the masked raster bins and
the session under DXRPT_SPLIT_ALPHA) against dxrpathtracer_tpu.

  - The alpha-only table (`build_alpha_bvh_for_scene`, build_bvh with
    tri_ids) byte-equal to the JAX session's `build_bvh(tri_ids=...)`, at
    leaf 2 and 12, and the W8 table with alpha flags.
  - The plain opaque-only walks (closest and any hit) and the K-candidate
    walk against JAX `packet_closest_hit(exclude_alpha=True)`,
    `packet_any_hit_rec(exclude_alpha=True)` and
    `packet_closest_hit_alpha`: t, tri id, u and v, every candidate field
    and the overflow bit bit for bit, on `tiny_alpha_scene` (K = 4 and 8)
    and on the K-candidate cases of tools/traverse_cases.py (overflow on
    the leaf-12 table, a full buffer of rejected candidates, candidates at
    equal t, an inactive packet, K = 1).
  - `_split_alpha_closest` and `_split_alpha_visibility` against JAX's
    (no_overflow), bit for bit.
  - The masked raster bins against JAX's `opaque_only` bins.
  - A `RenderSession` frame of `tiny_alpha_scene` at 128x64 under
    DXRPT_SPLIT_ALPHA=1 (split closest hits at depth 1, split sun and
    terminal visibility), with the raster off and on (masked bins), and
    with the raster and DXRPT_HISTORY=1, within rel-RMSE 1e-4 of the JAX
    session's under the same switches (DXRPT_KCAND=2 on both sides:
    XLA:CPU takes minutes to compile the
    frame at K = 8; the walks above hold K = 8).
  - The port's `use_geometry` drops the alpha-only table, which the JAX
    `animate` command keeps for the turned geometry.
The JAX side runs in a subprocess whose XLA:CPU emits no FMA. The kernel
is held against the plain walks on the card by chip_smoke.py phase K.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

torch = pytest.importorskip("torch")

from dxrpathtracer_tpu_torch.accel import packet  # noqa: E402
from dxrpathtracer_tpu_torch.accel.bvh import (build_alpha_bvh_for_scene,  # noqa: E402
                                               build_bvh_for_scene, leaf_rows)
from dxrpathtracer_tpu_torch.app.session import RenderSession  # noqa: E402
from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes  # noqa: E402
from dxrpathtracer_tpu_torch.render import integrator  # noqa: E402
from dxrpathtracer_tpu_torch.render.swraster import build_raster_bins  # noqa: E402
from dxrpathtracer_tpu_torch.scene import registry as treg  # noqa: E402
from dxrpathtracer_tpu_torch.tools import traverse_cases as tc  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 128, 64
TINY_KS = (4, 8)
FRAME_K = 2  # DXRPT_KCAND of the frames
HIT = ("t", "tri_id", "u", "v")
CAND = ("t", "tri", "u", "v", "overflow")
FRAME_FIELDS = dict(sqrt_num_samples=1, max_path_length=3,
                    max_any_hit_path_length=3, packet_shadows_all_depths=True)


def _tiny_rays(n=1024, seed=3):
    """Camera-like rays at the tiny scene's cards, 8 x 16 tiles a packet,
    some inactive, some with a short t_max."""
    rng = np.random.default_rng(seed)
    h, w = 32, n // 32
    yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w),
                         indexing="ij")
    d = np.stack([xx * 0.45, -0.25 + yy * 0.3, np.ones_like(xx)], -1)
    d = d.reshape(h // 8, 8, w // 16, 16, 3).swapaxes(1, 2).reshape(-1, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = np.tile(np.float32([0.0, 2.0, -5.0]), (n, 1))
    tmin = rng.choice(np.float32([0.0, 1e-4]), n)
    tmax = np.where(rng.random(n) < 0.2, 5.5, 1e30).astype(np.float32)
    return dict(o=o, d=d, tmin=tmin, tmax=tmax, active=rng.random(n) > 0.1)


_SCRIPT = r"""
import dataclasses
import os
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from dxrpathtracer_tpu.accel.lbvh import build_bvh, build_bvh_for_scene
from dxrpathtracer_tpu.accel.packet import (packet_any_hit_rec,
                                            packet_closest_hit,
                                            packet_closest_hit_alpha)
from dxrpathtracer_tpu.app.session import RenderSession
from dxrpathtracer_tpu.app.settings import AppSettings, Scenes
from dxrpathtracer_tpu.render import swraster as jsw
from dxrpathtracer_tpu.render.integrator import (_make_alpha_test,
                                                 _split_alpha_closest,
                                                 _split_alpha_visibility)
from dxrpathtracer_tpu.scene import registry as jreg
from dxrpathtracer_tpu.scene.animate import rotate_scene_y
from dxrpathtracer_tpu.scene.build import build_scene
from dxrpathtracer_tpu.scene.procedural import MeshData
from dxrpathtracer_tpu.scene.textures import (AtlasBuilder,
                                              default_material_table)
from dxrpathtracer_tpu_torch.tools import traverse_cases as tc

inp = dict(np.load(sys.argv[1]))
frame_settings = %r
out = {}


def case_scene(meshes, mask):
    builder = AtlasBuilder()
    mats = default_material_table(2, builder)
    opacity = np.asarray(mats.opacity).copy()
    opacity[1] = builder.add("alpha_case_opacity", mask)
    has_op = np.asarray(mats.has_opacity).copy()
    has_op[1] = True
    mats = dataclasses.replace(mats, opacity=opacity, has_opacity=has_op,
                               any_opacity=True)
    return build_scene([MeshData(**vars(m)) for m in meshes],
                       materials=mats, atlas_builder=builder)


def alpha_table(pos, tri, has_op, tri_mat, leaf):
    # the JAX session's bvh_alpha (app/session.py)
    amask = has_op[tri_mat]
    aidx = np.where(amask)[0].astype(np.int32)
    atr = tri[aidx]
    return build_bvh(pos[atr[:, 0]], pos[atr[:, 1]], pos[atr[:, 2]],
                     leaf_size=leaf, tri_alpha=has_op[tri_mat], tri_ids=aidx)


def save_table(key, b):
    out[key + "__table"] = np.asarray(b.table)
    out[key + "__const"] = np.asarray([b.num_rows, b.max_depth, b.root_code,
                                       b.width, b.has_alpha_flags,
                                       b.leaf_size])


def save(key, rec=None, cands=None, **arrays):
    if rec is not None:
        for f in ("t", "tri_id", "u", "v"):
            out[key + "__" + f] = np.asarray(getattr(rec, f))
    for f, a in (cands or {}).items():
        out[key + "__c" + f] = np.asarray(a)
    for f, a in arrays.items():
        out[key + "__" + f] = np.asarray(a)


def walks(scene_key, scene, w8, alpha_tabs, jobs):
    accept = _make_alpha_test(jax.device_put(scene), AppSettings())
    for name, rays, leaf, ks in jobs:
        args = [jnp.asarray(rays[f]) for f in tc.RAY_FIELDS]
        key = scene_key + "__" + name
        save(key + "__opq", packet_closest_hit(w8, *args,
                                               exclude_alpha=True))
        vis, occ = packet_any_hit_rec(w8, *args, exclude_alpha=True)
        save(key + "__opqany", vis=vis, occ=occ)
        ab = alpha_tabs[leaf]
        for k in ks:
            rec, cands = packet_closest_hit_alpha(ab, *args, k_cands=k)
            save("%%s__k%%d" %% (key, k), rec, cands)
            if leaf > 2:
                continue
            kc = lambda *a, k=k: packet_closest_hit_alpha(ab, *a,
                                                          k_cands=k)
            win = _split_alpha_closest(
                lambda *a: packet_closest_hit(w8, *a, exclude_alpha=True),
                kc, None, accept, *args, no_overflow=True)
            save("%%s__k%%d__split" %% (key, k), win)
            vis = _split_alpha_visibility(
                lambda *a: packet_any_hit_rec(w8, *a, exclude_alpha=True),
                kc, None, accept, *args, no_overflow=True)
            save("%%s__k%%d__splitvis" %% (key, k), vis=vis)


def tables(scene_key, scene, leaves):
    pos, tri = np.asarray(scene.positions), np.asarray(scene.tri_idx)
    has_op = np.asarray(scene.materials.has_opacity, bool)
    tri_mat = np.asarray(scene.tri_material)
    w8 = build_bvh_for_scene(scene, positions=pos, tri_idx=tri,
                             flag_alpha=True)
    save_table(scene_key + "__w8", w8)
    tabs = {}
    for leaf in leaves:
        tabs[leaf] = alpha_table(pos, tri, has_op, tri_mat, leaf)
        save_table("%%s__alpha%%d" %% (scene_key, leaf), tabs[leaf])
    return w8, tabs


# the K-candidate cases' scene
meshes, mask = tc.kcand_case_meshes()
scene = case_scene(meshes, mask)
cases = tc.kcand_cases()
w8, tabs = tables("stack", scene, sorted({c[1] for c in cases.values()}))
walks("stack", scene, w8, tabs,
      [(n, r, leaf, (k,)) for n, (r, leaf, k) in cases.items()])

# the tiny scene (its DDS absent: the checker fallback, as the port's)
tiny, preset = jreg.tiny_alpha_scene()
w8, tabs = tables("tiny", tiny, (2,))
rays = {f: inp["tiny__" + f] for f in tc.RAY_FIELDS}
walks("tiny", tiny, w8, tabs, [("cam", rays, 2, (4, 8))])

# the masked bins of a camera on the tiny scene
pos, tri = np.asarray(tiny.positions), np.asarray(tiny.tri_idx)
opq = ~np.asarray(tiny.materials.has_opacity, bool)[
    np.asarray(tiny.tri_material)]
vp, near = inp["bins_vp"], float(inp["bins_near"])
ok, *rest = jsw.project_tri_bboxes(pos, tri, vp, near, %d, %d)
pairs = jsw.bin_pairs_host((ok & opq, *rest), %d, %d, 0, 8, 16)
out["bins__tri"], out["bins__tile"] = pairs[0], pairs[1]

# frames under DXRPT_SPLIT_ALPHA, raster off then on (masked bins), then
# with the raster and DXRPT_HISTORY, with K = FRAME_K (the route compiled
# at K = 8 takes XLA:CPU minutes)
os.environ["DXRPT_SPLIT_ALPHA"] = "1"
os.environ["DXRPT_KCAND"] = "%d"
s = AppSettings(current_scene=Scenes.Sponza, **frame_settings)
for raster, history in ((False, False), (True, False), (True, True)):
    if raster:
        os.environ["DXRPT_RASTER_MIN_PIXELS"] = "1"
    if history:
        os.environ["DXRPT_HISTORY"] = "1"
    sess = RenderSession(settings=s, width=%d, height=%d, scene=tiny,
                         preset=preset)
    key = "frame_raster%%d%%s" %% (raster, "_history" if history else "")
    if raster:
        out[key + "__opaque_only"] = np.asarray(
            [bool(sl.opaque_only) for sl in sess._raster_slabs])
    out[key + "__image"] = np.asarray(
        sess.render_to_completion(max_samples=1))
    save_table(key + "__alpha", sess.bvh_alpha)

# the `animate` command's session state (app/cli.py, cmd_animate): it
# clears the host-built tables of the moving geometry but not bvh_alpha
sess.bvh2 = None
sess.bvh_ray = None
sess.sun_grid = None
sess._tri_table = None
out["animate__keeps_alpha"] = np.asarray(sess.bvh_alpha is not None)
lo, hi = pos.min(axis=0), pos.max(axis=0)
center = np.array([(lo[0] + hi[0]) / 2, 0.0, (lo[2] + hi[2]) / 2],
                  np.float32)
turned = rotate_scene_y(sess.scene, jnp.float32(2.0 * np.pi / 3), center)
fresh = alpha_table(np.asarray(turned.positions), tri,
                    np.asarray(tiny.materials.has_opacity, bool),
                    np.asarray(tiny.tri_material), 2)
args = [jnp.asarray(rays[f]) for f in tc.RAY_FIELDS]
out["animate__stale_cands"] = np.asarray(packet_closest_hit_alpha(
    sess.bvh_alpha, *args, k_cands=4)[1]["tri"])
out["animate__turned_cands"] = np.asarray(packet_closest_hit_alpha(
    fresh, *args, k_cands=4)[1]["tri"])
np.savez(sys.argv[2], **out)
""" % (FRAME_FIELDS, W, H, W, H, FRAME_K, W, H)


def _tiny_camera():
    """The tiny scene's preset camera at W x H: (view-projection, near)."""
    from dxrpathtracer_tpu_torch.render.camera import FirstPersonCamera
    _, preset = treg.tiny_alpha_scene()
    cam = FirstPersonCamera(aspect=W / H)
    cam.set_position(preset.camera_position)
    cam.set_x_rotation(preset.camera_rotation[0])
    cam.set_y_rotation(preset.camera_rotation[1])
    return np.asarray(cam.view_projection(), np.float64), float(cam.near_clip)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("kcand_ref")
    vp, near = _tiny_camera()
    inputs = {"tiny__" + f: a for f, a in _tiny_rays().items()}
    inputs.update(bins_vp=vp, bins_near=np.asarray(near))
    src, dst = tmp / "in.npz", tmp / "out.npz"
    np.savez(src, **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    for k in ("DXRPT_ALPHA_SPLIT", "DXRPT_SPLIT_ALPHA", "DXRPT_KCAND",
              "DXRPT_LEAF_EXTRACT", "DXRPT_RASTER_MIN_PIXELS",
              "DXRPT_PUNCH_HYBRID", "DXRPT_HISTORY"):
        env.pop(k, None)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, str(src), str(dst)],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(dst))


def _scene(key):
    if key == "tiny":
        return treg.tiny_alpha_scene()[0]
    return tc.alpha_case_scene(*tc.kcand_case_meshes())


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_equal(got: dict, ref: dict, prefix: str, fields):
    for f in fields:
        np.testing.assert_array_equal(_bits(got[f]), _bits(ref[prefix + f]),
                                      err_msg=prefix + f)


def _jobs():
    """(scene key, job name, rays, alpha table leaf size, Ks)."""
    out = [("stack", name, rays, leaf, (k,))
           for name, (rays, leaf, k) in tc.kcand_cases().items()]
    return out + [("tiny", "cam", _tiny_rays(), 2, TINY_KS)]


JOB_IDS = [f"{s}-{n}" for s, n, *_ in _jobs()]


@pytest.mark.parametrize("key,leaf", [("stack", 2), ("stack", 12),
                                      ("tiny", 2)])
def test_alpha_table_byte_equal(reference, key, leaf):
    scene = _scene(key)
    got = build_alpha_bvh_for_scene(scene, leaf_size=leaf)
    want = reference[f"{key}__alpha{leaf}__table"]
    rows, depth, root, width, flags, leaf_size = (
        int(v) for v in reference[f"{key}__alpha{leaf}__const"])
    assert (got.num_rows, got.max_depth, got.root_code, got.width,
            got.has_alpha_flags, got.leaf_size) == (
        rows, depth, root, width, bool(flags), leaf_size)
    assert got.table.numpy().tobytes() == want.tobytes()
    # every leaf id is a scene triangle of an alpha-tested material, flagged
    rows = leaf_rows(got.table.numpy(), got.root_code, 8)
    ids = got.table.numpy()[rows, 9 * 12:10 * 12].view(np.int32)
    tid = ids[ids >= 0]
    assert (tid & packet.ALPHA_TID_BIT).all()
    assert ((ids >= 0).sum(1) <= leaf).all()
    has_op = scene.has_opacity.numpy()[scene.tri_material.numpy()]
    assert has_op[tid & ~packet.ALPHA_TID_BIT].all()
    w8 = build_bvh_for_scene(scene, width=8, flag_alpha=True)
    assert w8.table.numpy().tobytes() == \
        reference[f"{key}__w8__table"].tobytes()


@pytest.mark.parametrize("job", range(len(JOB_IDS)), ids=JOB_IDS)
def test_plain_alpha_modes_match_jax(reference, job):
    key, name, rays, leaf, ks = _jobs()[job]
    scene = _scene(key)
    w8 = build_bvh_for_scene(scene, width=8, flag_alpha=True)
    ab = build_alpha_bvh_for_scene(scene, leaf_size=leaf)
    args = [torch.from_numpy(np.ascontiguousarray(rays[f]))
            for f in tc.RAY_FIELDS]
    pre = f"{key}__{name}"
    rec = packet.packet_closest_hit(w8, *args, exclude_alpha=True)
    _assert_equal(vars(rec), reference, pre + "__opq__", HIT)
    vis, occ = packet.packet_any_hit_rec(w8, *args, exclude_alpha=True)
    _assert_equal({"vis": vis, "occ": occ}, reference, pre + "__opqany__",
                  ("vis", "occ"))
    # the opaque-only walk ignores every alpha-tested triangle
    has_op = scene.has_opacity.numpy()[scene.tri_material.numpy()]
    assert not has_op[rec.tri_id.numpy()[rec.tri_id.numpy() >= 0]].any()
    for k in ks:
        rec, cands = packet.packet_closest_hit_alpha(ab, *args, k_cands=k)
        _assert_equal(vars(rec), reference, f"{pre}__k{k}__", HIT)
        _assert_equal(cands, reference, f"{pre}__k{k}__c", CAND)
        assert cands["t"].shape == (len(rays["o"]), k)
        tri, t = cands["tri"].numpy(), cands["t"].numpy()
        act = rays["active"]
        assert (tri[~act] == -1).all()
        assert (np.diff(t, axis=1) >= 0).all()  # sorted, padding last
        assert (t[tri < 0] == np.float32(3e38)).all()
        ovf = int(cands["overflow"].sum())
        full = int((tri[:, -1] >= 0).sum())
        print(f"{pre} K={k}: {int((tri >= 0).sum())} candidates, {full} "
              f"full buffers, {ovf} overflow lanes")
        if name == "overflow":
            assert ovf > len(tri) // 4
        else:
            assert ovf == 0
        if name == "equal_t":
            assert ((t[:, 1:] == t[:, :-1]) & (tri[:, 1:] >= 0)).sum() > 50
        if name == "inactive":
            assert (tri[:packet.PACKET] == -1).all() and full > 0


def _split_jobs():
    return [j for j in range(len(JOB_IDS)) if _jobs()[j][3] <= 2]


@pytest.mark.parametrize("job", _split_jobs(),
                         ids=[JOB_IDS[j] for j in _split_jobs()])
def test_split_resolution_matches_jax(reference, job):
    key, name, rays, leaf, ks = _jobs()[job]
    scene = _scene(key)
    accept = integrator._make_alpha_test(scene, AppSettings())
    w8 = build_bvh_for_scene(scene, width=8, flag_alpha=True)
    ab = build_alpha_bvh_for_scene(scene, leaf_size=leaf)
    args = [torch.from_numpy(np.ascontiguousarray(rays[f]))
            for f in tc.RAY_FIELDS]
    opq = lambda *a: packet.packet_closest_hit(  # noqa: E731
        w8, *a, exclude_alpha=True)
    opq_any = lambda *a: packet.packet_any_hit_rec(  # noqa: E731
        w8, *a, exclude_alpha=True)
    for k in ks:
        kc = lambda *a, k=k: packet.packet_closest_hit_alpha(  # noqa: E731
            ab, *a, k_cands=k)
        pre = f"{key}__{name}__k{k}__split"
        win = integrator._split_alpha_closest(opq, kc, accept, *args)
        _assert_equal(vars(win), reference, pre + "__", HIT)
        vis = integrator._split_alpha_visibility(opq_any, kc, accept, *args)
        _assert_equal({"vis": vis}, reference, pre + "vis__", ("vis",))
        # the truncation: where the K nearest candidates all reject, the
        # K-th is taken as opaque
        _, cands = kc(*args[:3], win.t, args[4])
        print(f"{pre}: {int(win.hit.sum())} hits, "
              f"{int((vis == 0).sum())} occluded")
        if name == "all_rejected":
            _, c = kc(*args)
            last = c["tri"][:, -1]
            took = (win.tri_id == last) & (last >= 0)
            assert int(took.sum()) > len(last) // 2


def test_masked_bins_match_jax(reference):
    scene, _ = treg.tiny_alpha_scene()
    vp, near = _tiny_camera()
    opq = ~scene.has_opacity.numpy()[scene.tri_material.numpy()]
    tri_table = np.zeros((scene.num_triangles, 9), np.float32)
    bins = build_raster_bins(scene.positions.numpy(), scene.tri_idx.numpy(),
                             vp, near, W, H, 8, 16, tri_table,
                             opaque_tris=opq)
    assert bins.opaque_only
    np.testing.assert_array_equal(bins.tri_id.numpy(), reference["bins__tri"])
    start = bins.tile_start.numpy()
    np.testing.assert_array_equal(
        np.repeat(np.arange(bins.n_tiles), np.diff(start)),
        reference["bins__tile"])
    assert len(reference["bins__tri"]) > 0
    assert not (~opq[bins.tri_id.numpy()]).any()
    unmasked = build_raster_bins(scene.positions.numpy(),
                                 scene.tri_idx.numpy(), vp, near, W, H, 8,
                                 16, tri_table)
    assert not unmasked.opaque_only and unmasked.pairs > bins.pairs


def _rel_rmse(img, ref):
    return float(np.sqrt(np.mean((img - ref) ** 2))
                 / (np.abs(ref).max() + 1e-9))


@pytest.mark.parametrize("raster,history", [
    pytest.param(False, False, id="False"),
    pytest.param(True, False, id="True"),
    # DXRPT_HISTORY on an alpha scene: both routes turn the history off,
    # and the masked bins stay the opaque-only step
    pytest.param(True, True, id="True-history")])
def test_split_alpha_frame_matches_jax(reference, monkeypatch, raster,
                                       history):
    monkeypatch.setenv("DXRPT_SPLIT_ALPHA", "1")
    monkeypatch.setenv("DXRPT_KCAND", str(FRAME_K))
    if raster:
        monkeypatch.setenv("DXRPT_RASTER_MIN_PIXELS", "1")
    else:
        monkeypatch.delenv("DXRPT_RASTER_MIN_PIXELS", raising=False)
    if history:
        monkeypatch.setenv("DXRPT_HISTORY", "1")
    else:
        monkeypatch.delenv("DXRPT_HISTORY", raising=False)
    calls = {"kcand": 0, "opq_closest": 0, "opq_any": 0}
    kcand, closest, anyrec = (integrator.packet_closest_hit_alpha,
                              integrator.packet_closest_hit,
                              integrator.packet_any_hit_rec)

    def count_kcand(*a, **kw):
        calls["kcand"] += 1
        return kcand(*a, **kw)

    def count_closest(*a, **kw):
        calls["opq_closest"] += bool(kw.get("exclude_alpha"))
        return closest(*a, **kw)

    def count_any(*a, **kw):
        calls["opq_any"] += bool(kw.get("exclude_alpha"))
        return anyrec(*a, **kw)

    monkeypatch.setattr(integrator, "packet_closest_hit_alpha", count_kcand)
    monkeypatch.setattr(integrator, "packet_closest_hit", count_closest)
    monkeypatch.setattr(integrator, "packet_any_hit_rec", count_any)
    scene, preset = treg.tiny_alpha_scene()
    sess = RenderSession(AppSettings(current_scene=Scenes.Sponza, **FRAME_FIELDS), W, H, device="cpu",
                         scene=scene, preset=preset)
    key = f"frame_raster{int(raster)}" + ("_history" if history else "")
    want = reference[f"{key}__alpha__table"]
    assert sess.bvh_alpha.table.numpy().tobytes() == want.tobytes()
    img = sess.render_to_completion(max_samples=1).numpy()
    ref = reference[f"{key}__image"]
    err = _rel_rmse(img, ref)
    print(f"split alpha frame {W}x{H}, raster {raster}, history {history}: "
          f"rel RMSE vs JAX {err:.3e}, {np.mean(img == ref):.4f} of values "
          f"bit-equal; calls {calls}")
    assert np.isfinite(img).all() and err <= 1e-4
    # depth-1 closest: the masked bins (raster) or the opaque-only walk;
    # the K-candidate walk for it and for the sun rays of depths 1 and 2
    # and the terminal rays of depth 2 (the depth-2 closest hits keep the
    # in-walk alpha test)
    assert calls["opq_closest"] == (0 if raster else 1)
    assert calls["opq_any"] == 3 and calls["kcand"] == 4
    if raster:
        assert sess.raster_bins.opaque_only
        assert reference[f"{key}__opaque_only"].all()


def test_use_geometry_drops_the_alpha_table(reference, monkeypatch):
    """The port's repair of a reference-side fault: the JAX `animate`
    command keeps its session's bvh_alpha for the turned geometry, whose
    candidates then differ from the turned scene's; the port's
    use_geometry drops the table, and the split route with it."""
    assert bool(reference["animate__keeps_alpha"])
    stale = reference["animate__stale_cands"]
    turned = reference["animate__turned_cands"]
    print(f"JAX animate: the kept alpha table's candidates differ from the "
          f"turned geometry's on {int((stale != turned).any(1).sum())} of "
          f"{len(stale)} lanes")
    assert (stale != turned).any(1).sum() > 0
    monkeypatch.setenv("DXRPT_SPLIT_ALPHA", "1")
    scene, preset = treg.tiny_alpha_scene()
    sess = RenderSession(AppSettings(current_scene=Scenes.Sponza, **FRAME_FIELDS), 32, 32, device="cpu",
                         scene=scene, preset=preset)
    assert sess.bvh_alpha is not None
    sess.use_geometry(sess.scene, sess.bvh)
    assert sess.bvh_alpha is None
    calls = []
    monkeypatch.setattr(integrator, "packet_closest_hit_alpha",
                        lambda *a, **kw: calls.append(a))
    sess.render_frame()
    assert calls == [] and bool(sess.accum.isfinite().all())


def test_kcand_limits(monkeypatch):
    """K above 8, a table without alpha flags and (for the route) an alpha
    table whose leaves can overflow are refused."""
    scene = _scene("stack")
    ab = build_alpha_bvh_for_scene(scene)
    rays = tc.kcand_cases()["k1"][0]
    args = [torch.from_numpy(rays[f]) for f in tc.RAY_FIELDS]
    with pytest.raises(ValueError, match="k_cands"):
        packet.packet_closest_hit_alpha(ab, *args, k_cands=9)
    plain = build_bvh_for_scene(scene, width=8)
    with pytest.raises(ValueError, match="alpha flags"):
        packet.packet_closest_hit_alpha(plain, *args, k_cands=4)
    w8 = build_bvh_for_scene(scene, width=8, flag_alpha=True)
    leaf12 = build_alpha_bvh_for_scene(scene, leaf_size=12)
    monkeypatch.delenv("DXRPT_SPLIT_ALPHA", raising=False)
    assert integrator._split_alpha_tables(w8, ab) is None
    monkeypatch.setenv("DXRPT_SPLIT_ALPHA", "1")
    monkeypatch.setenv("DXRPT_KCAND", "5")
    assert integrator._split_alpha_tables(w8, ab) == (ab, 5)
    assert integrator._split_alpha_tables(plain, ab) is None
    with pytest.raises(ValueError, match="LEAF_EXTRACT"):
        integrator._split_alpha_tables(w8, leaf12)
