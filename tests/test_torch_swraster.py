"""Port parity: render/swraster.py of dxrpathtracer_tpu_torch (the software
raster of camera rays, csrc/swraster.cu's module) against
dxrpathtracer_tpu.

On the CPU the port runs the kernel's plain version. It is held
  - array for array: project_tri_bboxes and bin_pairs_host against the JAX
    package's (host numpy, copied as they are), on BoxTest at 96x64 and
    the Sponza-class stand-in at 128x72 with their presets' cameras;
  - bit for bit: raster_closest_hit_plain over the port's CSR bins against
    the JAX package's raster_closest_hit over its dense, deep and tail
    tables (tri id, t, u, v on every lane; the JAX side in a subprocess
    whose XLA:CPU emits no FMA, as tests/test_torch_traverse.py runs it),
    on the same two frames' camera rays in packet-tile order;
  - against the port's per-ray walk on those rays: the same hits but on
    lanes where two triangles are hit at an equal t (counted and pinned);
  - on edge cases: a triangle crossing the near plane (JAX
    tests/test_swraster.py), a tile with more than 320 triangles (400
    stacked quads in front of one tile; JAX's tables hold 64 + 256 levels
    before its tail), duplicated triangles (the lower id wins);
  - end to end: a 128x64 BoxTest session with DXRPT_RASTER_MIN_PIXELS=1
    renders the image of the session with enable_sw_raster off, bit for
    bit; its bins are rebuilt after a camera move and dropped by
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

from dxrpathtracer_tpu.render import swraster as jswraster  # noqa: E402
from dxrpathtracer_tpu_torch.accel import traverse  # noqa: E402
from dxrpathtracer_tpu_torch.accel.bvh import (build_bvh,  # noqa: E402
                                               build_bvh_for_scene)
from dxrpathtracer_tpu_torch.accel.history import build_tri_table  # noqa: E402
from dxrpathtracer_tpu_torch.app.session import RenderSession  # noqa: E402
from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes  # noqa: E402
from dxrpathtracer_tpu_torch.convert import frame_from_numpy  # noqa: E402
from dxrpathtracer_tpu_torch.render import integrator, swraster  # noqa: E402
from dxrpathtracer_tpu_torch.render.camera import FirstPersonCamera  # noqa: E402
from dxrpathtracer_tpu_torch.scene.registry import load_scene  # noqa: E402
from dxrpathtracer_tpu_torch.tools import traverse_cases  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = {"boxtest": (Scenes.BoxTest, 96, 64),
          "standin": (Scenes.Sponza, 128, 72)}
# lanes where the raster's triangle differs from the per-ray walk's (equal
# t: the raster takes the lower id, the walk the first it meets)
EQUAL_T_TIES = {"boxtest": 0, "standin": 0}


def _camera(preset, w, h):
    cam = FirstPersonCamera(aspect=w / h)
    if preset is not None:
        cam.set_position(preset.camera_position)
        cam.set_x_rotation(preset.camera_rotation[0])
        cam.set_y_rotation(preset.camera_rotation[1])
    return cam


def _camera_rays(cam, w, h):
    """One sample's camera rays (raygen, CMJ sample 0) in packet-tile
    order: o, d, t_min, t_max, active."""
    frame = frame_from_numpy(cam.inv_view_projection(), cam.position,
                             [0, 1, 0], [1, 1, 1], [1, 1, 1], 1.0, 0.0, 0)
    o, d, length, _ = integrator.raygen(AppSettings(sqrt_num_samples=2),
                                        frame, w, h, "cpu")
    dims = integrator._packet_tile_dims(h, w)
    o, d, length = (integrator._tile_order(x, h, w, *dims)
                    for x in (o, d, length))
    n = o.shape[0]
    return (o, d, torch.zeros(n), length,
            torch.ones(n, dtype=torch.bool)), dims


def _frame(name):
    """(positions, tri_idx, camera, rays, (ty, tx), w, h) of a frame."""
    scene_enum, w, h = FRAMES[name]
    scene, preset = load_scene(scene_enum)
    cam = _camera(preset, w, h)
    rays, dims = _camera_rays(cam, w, h)
    return (scene.positions.numpy(), scene.tri_idx.numpy(), cam, rays, dims,
            w, h, scene)


def _bins(pos, tri, cam, w, h, dims):
    return swraster.build_raster_bins(
        pos, tri, np.asarray(cam.view_projection(), np.float64),
        float(cam.near_clip), w, h, *dims, build_tri_table(pos, tri))


_SCRIPT = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from dxrpathtracer_tpu.accel.history import build_tri_table
from dxrpathtracer_tpu.render import swraster

inp = dict(np.load(sys.argv[1]))
out = {}
for case in sorted({k.split("__")[0] for k in inp}):
    g = lambda f: inp[case + "__" + f]
    w, h, ty, tx = (int(x) for x in g("size"))
    pos, tri = g("pos"), g("tri")
    bins, _ = swraster.build_raster_bins(
        pos, tri, g("vp"), float(g("near")), w, h, h, 0, ty, tx,
        jnp.asarray(build_tri_table(pos, tri)))
    rays = [jnp.asarray(g(f)) for f in ("o", "d", "tmin", "tmax", "active")]
    rec = jax.jit(swraster.raster_closest_hit)(bins, *rays)
    for f in ("t", "tri_id", "u", "v"):
        out[case + "__" + f] = np.asarray(getattr(rec, f))
    out[case + "__deep_tiles"] = np.asarray(
        int((np.asarray(bins.deep_tiles) >= 0).sum()))

# The `animate` command's state on its second of 3 frames (app/cli.py,
# cmd_animate): a BoxTest session with the raster on, its host-built
# structures dropped as the command drops them and its geometry turned and
# rebuilt on the device as the command does; the camera rays answered by the
# bins the session keeps and by the walk of the turned geometry.
import os
os.environ["DXRPT_RASTER_MIN_PIXELS"] = "1"
from dxrpathtracer_tpu.accel.device_build import build_table_device, lbvh_plan
from dxrpathtracer_tpu.accel.lbvh import WIDTH, FlatBVH
from dxrpathtracer_tpu.accel.traverse import closest_hit
from dxrpathtracer_tpu.app.session import RenderSession
from dxrpathtracer_tpu.app.settings import AppSettings, Scenes
from dxrpathtracer_tpu.render import integrator
from dxrpathtracer_tpu.scene.animate import rotate_scene_y

w, h = 128, 64
sess = RenderSession(settings=AppSettings(current_scene=Scenes.BoxTest),
                     width=w, height=h)
sess.bvh2 = sess.bvh_ray = sess.sun_grid = sess._tri_table = None
plan = lbvh_plan(sess.scene_host.num_triangles)
pos = np.asarray(sess.scene_host.positions)
lo, hi = pos.min(axis=0), pos.max(axis=0)
center = np.array([(lo[0] + hi[0]) / 2, 0.0, (lo[2] + hi[2]) / 2],
                  np.float32)
sc = rotate_scene_y(sess.scene, jnp.float32(2.0 * np.pi / 3), center)
table = build_table_device(*(sc.positions[sc.tri_idx[:, k]]
                             for k in range(3)), plan)
bvh = FlatBVH(table=table, num_rows=plan.num_rows, num_tris=plan.num_tris,
              num_leaves=plan.num_leaves, leaf_size=plan.leaf_size,
              max_depth=plan.depth + 2, root_code=plan.root_code, width=WIDTH)
o, d, length, _ = integrator.raygen(sess.settings, sess.frame_constants(0),
                                    w, h)
ty, tx = integrator._packet_tile_dims(h, w)
o, d, length = (integrator._tile_order(x, h, w, ty, tx)
                for x in (o, d, length))
rays = (o, d, jnp.zeros_like(length), length,
        jnp.ones(length.shape, bool))
out["animate__slabs"] = np.asarray(len(sess._raster_slabs or []))
out["animate__raster"] = np.asarray(jax.jit(swraster.raster_closest_hit)(
    sess._raster_slabs[0], *rays).tri_id)
out["animate__walk"] = np.asarray(closest_hit(bvh, *rays).tri_id)
out["animate__unturned_walk"] = np.asarray(
    closest_hit(sess.bvh, *rays).tri_id)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """{name: frame} and the JAX package's raster hits on each frame's
    rays."""
    out, inputs = {}, {}
    for name in FRAMES:
        pos, tri, cam, rays, dims, w, h, scene = out[name] = _frame(name)
        for f, x in zip(("o", "d", "tmin", "tmax", "active"), rays):
            inputs[f"{name}__{f}"] = x.numpy()
        inputs[f"{name}__pos"], inputs[f"{name}__tri"] = pos, tri
        inputs[f"{name}__vp"] = np.asarray(cam.view_projection(), np.float64)
        inputs[f"{name}__near"] = np.asarray(cam.near_clip)
        inputs[f"{name}__size"] = np.asarray([w, h, *dims])
    tmp = tmp_path_factory.mktemp("swraster")
    src, dst = tmp / "in.npz", tmp / "out.npz"
    np.savez(src, **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, str(src), str(dst)],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return out, dict(np.load(dst))


@pytest.mark.parametrize("name", list(FRAMES))
def test_binning_matches_jax(name):
    pos, tri, cam, _, (ty, tx), w, h, _ = _frame(name)
    vp = np.asarray(cam.view_projection(), np.float64)
    args = (pos, tri, vp, float(cam.near_clip), w, h)
    got = swraster.project_tri_bboxes(*args)
    want = jswraster.project_tri_bboxes(*args)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)
    got = swraster.bin_pairs_host(got, w, h, 0, ty, tx)
    want = jswraster.bin_pairs_host(want, w, h, 0, ty, tx)
    for g, x in zip(got, want):
        assert g.dtype == x.dtype
        np.testing.assert_array_equal(g, x)
    # the CSR bins hold the same pairs in the same order
    bins = _bins(pos, tri, cam, w, h, (ty, tx))
    np.testing.assert_array_equal(bins.tri_id.numpy(), got[0])
    start = bins.tile_start.numpy()
    assert start[0] == 0 and start[-1] == len(got[0])
    np.testing.assert_array_equal(np.repeat(np.arange(bins.n_tiles),
                                            np.diff(start)), got[1])
    print(f"{name} {w}x{h}: {bins.pairs} pairs, deepest tile "
          f"{np.diff(start).max()}")


@pytest.mark.parametrize("name", list(FRAMES))
def test_raster_matches_jax_bit_for_bit(frames, name):
    out, ref = frames
    pos, tri, cam, rays, dims, w, h, _ = out[name]
    got = swraster.raster_closest_hit(_bins(pos, tri, cam, w, h, dims),
                                      *rays)
    np.testing.assert_array_equal(got.tri_id.numpy(), ref[name + "__tri_id"])
    for f in ("t", "u", "v"):
        np.testing.assert_array_equal(
            getattr(got, f).numpy().view(np.int32),
            ref[name + "__" + f].view(np.int32), err_msg=f)
    hit = got.tri_id.numpy() >= 0
    print(f"{name}: {hit.sum()} of {len(hit)} rays hit")
    assert hit.sum() > len(hit) // 4


@pytest.mark.parametrize("name", list(FRAMES))
def test_raster_matches_the_walk(frames, name):
    out, _ = frames
    pos, tri, cam, rays, dims, w, h, scene = out[name]
    got = swraster.raster_closest_hit(_bins(pos, tri, cam, w, h, dims),
                                      *rays)
    walk = traverse.closest_hit(build_bvh_for_scene(scene, width=8), *rays)
    t_diff = got.t.view(torch.int32) != walk.t.view(torch.int32)
    ties = (got.tri_id != walk.tri_id) & ~t_diff
    print(f"{name}: t differs on {int(t_diff.sum())} lanes, another "
          f"triangle at equal t on {int(ties.sum())}")
    assert not bool(t_diff.any())
    assert int(ties.sum()) == EQUAL_T_TIES[name]
    same = ~ties
    for f in ("u", "v"):
        assert torch.equal(getattr(got, f)[same].view(torch.int32),
                           getattr(walk, f)[same].view(torch.int32)), f


def _one_tri_frame(pos, tri, w=32, h=32):
    cam = FirstPersonCamera(aspect=w / h)
    rays, dims = _camera_rays(cam, w, h)
    tris = tuple(pos[tri[:, k]] for k in range(3))
    return _bins(pos, tri, cam, w, h, dims), rays, build_bvh(*tris, width=8)


def test_near_plane_crossing_triangle():
    """A floor triangle through the near plane (JAX tests/test_swraster.py)
    is binned by the clip at w = near and hit as the walk hits it."""
    pos = np.array([[-5, -1, -5], [5, -1, -5], [0, -1, 20]], np.float32)
    tri = np.array([[0, 1, 2]], np.int32)
    bins, rays, bvh = _one_tri_frame(pos, tri)
    got = swraster.raster_closest_hit(bins, *rays)
    walk = traverse.closest_hit(bvh, *rays)
    assert int(walk.hit.sum()) > 0
    assert torch.equal(got.tri_id, walk.tri_id)
    assert torch.equal(got.t.view(torch.int32), walk.t.view(torch.int32))


def test_deep_tile_and_equal_t_pairs():
    """traverse_cases.raster_edge_scene: 400 quads stacked in front of one
    tile (800 triangles in its list, more than JAX's 64 + 256 levels), a
    repeated quad and a floor through the near plane. The nearest of the
    stack is found, of two triangles at an equal t the lower id, and the
    floor; the top rows' tiles are empty."""
    v0, v1, v2 = traverse_cases.raster_edge_scene()
    t = v0.shape[0]
    pos = np.concatenate([v0, v1, v2])
    tri = np.arange(3 * t, dtype=np.int32).reshape(3, t).T.copy()
    bins, rays, bvh = _one_tri_frame(pos, tri, 64, 32)
    depth = np.diff(bins.tile_start.numpy())
    assert depth.max() > 320 and (depth == 0).any()
    got = swraster.raster_closest_hit(bins, *rays)
    walk = traverse.closest_hit(bvh, *rays)
    assert torch.equal(got.t.view(torch.int32), walk.t.view(torch.int32))
    hit = got.tri_id.numpy()
    stack = (hit >= 0) & (hit < 800)
    dup = (hit >= 800) & (hit < 804)
    assert stack.any() and dup.any() and (hit == 804).any()
    assert (hit[stack] < 2).all()          # the front quad of the stack
    assert (hit[dup] < 802).all()          # the lower copy of each pair
    # the walk meets the copies in its own order: only equal-t ties differ
    differ = got.tri_id != walk.tri_id
    assert bool((torch.from_numpy(dup) | ~differ).all())
    print(f"deepest tile {depth.max()}, {(depth == 0).sum()} empty tiles; "
          f"duplicate lanes {dup.sum()}, the walk takes the other copy on "
          f"{int(differ.sum())}")


def test_raster_routes_by_device():
    pos = np.array([[-5, -1, -5], [5, -1, -5], [0, -1, 20]], np.float32)
    bins, rays, _ = _one_tri_frame(pos, np.array([[0, 1, 2]], np.int32))
    with pytest.raises(ValueError, match="no raster_closest_hit"):
        swraster.raster_closest_hit(bins.to("meta"),
                                    *(x.to("meta") for x in rays))
    with pytest.raises(ValueError, match="lanes"):
        swraster.raster_closest_hit(bins, *(x[:128] for x in rays))


def test_session_raster_image_and_bins(monkeypatch):
    calls = []
    raster = integrator.raster_closest_hit

    def counted(*a, **kw):
        calls.append(1)
        return raster(*a, **kw)

    monkeypatch.setattr(integrator, "raster_closest_hit", counted)
    monkeypatch.delenv("DXRPT_RASTER_MIN_PIXELS", raising=False)
    settings = AppSettings(current_scene=Scenes.BoxTest, sqrt_num_samples=2,
                           max_path_length=3)
    default = RenderSession(settings, 128, 64, device="cpu")
    assert default.update_raster() is None  # gated off by default
    monkeypatch.setenv("DXRPT_RASTER_MIN_PIXELS", "1")
    off = RenderSession(settings.replace(enable_sw_raster=False), 128, 64,
                        device="cpu")
    on = RenderSession(settings, 128, 64, device="cpu")
    for _ in range(2):
        off.render_frame()
        on.render_frame()
    assert off.raster_bins is None and len(calls) == 2
    assert torch.equal(on.accum, off.accum)
    bins = on.raster_bins
    assert bins is not None and bins.pairs > 0 and on.raster_build_s > 0
    # the same camera keeps its bins; a move rebuilds them
    on.render_frame()
    assert on.raster_bins is bins
    on.camera.set_position(np.asarray(on.camera.position) + 0.25)
    on.render_frame()
    assert on.raster_bins is not bins and on.sample_idx == 1
    assert not torch.equal(on.raster_bins.tri_id, bins.tri_id) or not \
        torch.equal(on.raster_bins.tile_start, bins.tile_start)
    # moved geometry drops them, for good
    on.use_geometry(on.scene, on.bvh)
    assert on.raster_bins is None
    on.render_frame()
    assert on.raster_bins is None and len(calls) == 4


def test_jax_animate_keeps_stale_raster_bins(frames):
    """A reference-side fault the port does not copy: the JAX `animate`
    command drops the session's history table for the moving geometry but
    keeps the raster bins its session built for the unturned scene
    (dxrpathtracer_tpu/app/cli.py, cmd_animate). With the raster on, its
    step answers the camera rays of a turned frame from those bins: they
    give the unturned scene's hits, not the turned geometry's. The port's
    use_geometry drops the bins (test_session_raster_image_and_bins)."""
    _, ref = frames
    raster, walk = ref["animate__raster"], ref["animate__walk"]
    unturned = ref["animate__unturned_walk"]
    stale = raster != walk
    print(f"JAX animate, frame 2 of 3: {int(ref['animate__slabs'])} raster "
          f"slabs kept; the stale bins' triangle differs from the turned "
          f"walk's on {int(stale.sum())} of {len(raster)} lanes, from the "
          f"unturned walk's on {int((raster != unturned).sum())}")
    assert int(ref["animate__slabs"]) > 0
    assert int(stale.sum()) > len(raster) // 10
    np.testing.assert_array_equal(raster, unturned)
