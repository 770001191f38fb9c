"""The turntable frame as one entry of the port (scene/animate.py,
`Turntable`), at a tiny size on the CPU.

  - `Turntable.frame` gives the accumulation and the display image of the
    loop it replaced (rotate, build on the device, `use_geometry`,
    `render_to_completion`, `display_image`) bit for bit, every frame
    building a table of its own.
  - The `animate` command renders each of its frames through it.
  - Traced, one call opens the span `turntable` and each of its stages
    once, counts one `lbvh_build` under `turntable.build`, and the
    integrator's spans lie below `turntable/turntable.samples`.
"""

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

torch = pytest.importorskip("torch")

from dxrpathtracer_tpu_torch.accel.device_build import (  # noqa: E402
    build_bvh_device, lbvh_plan)
from dxrpathtracer_tpu_torch.app.profiler import tracing  # noqa: E402
from dxrpathtracer_tpu_torch.app.session import RenderSession  # noqa: E402
from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes  # noqa: E402
from dxrpathtracer_tpu_torch.scene import animate  # noqa: E402
from dxrpathtracer_tpu_torch.scene import registry as treg  # noqa: E402

FRAMES, SPP = 3, 2
STAGES = ("rotate", "build", "geometry", "samples", "display")


def _session(name):
    scene = preset = None
    if name == "alpha":
        scene, preset = treg.tiny_alpha_scene()
    return RenderSession(AppSettings(current_scene=Scenes.BoxTest,
                                     sqrt_num_samples=2, max_path_length=3),
                         24, 16, device="cpu", scene=scene, preset=preset)


def _inline_frames(sess):
    """(accumulation, display image, table) of each frame of the turn by
    the loop the `animate` command ran before the entry."""
    plan = lbvh_plan(sess.scene.num_triangles)
    center = animate.turntable_center(sess.scene_host.positions.numpy())
    base = sess.scene
    out = []
    for f in range(FRAMES):
        scene = animate.rotate_scene_y(
            base, np.float32(2.0 * np.pi * f / FRAMES), center)
        bvh = build_bvh_device(*animate.triangle_vertices(scene), plan)
        sess.use_geometry(scene, bvh)
        sess.render_to_completion(SPP)
        out.append((sess.accum.clone(), sess.display_image(), bvh.table))
    return out


@pytest.mark.parametrize("name", ["box", "alpha"])
def test_frame_equals_the_inline_loop(name):
    want = _inline_frames(_session(name))
    sess = _session(name)
    turn = animate.Turntable(sess, FRAMES)
    for f, (accum, disp, table) in enumerate(want):
        got = turn.frame(f, SPP)
        assert sess.sample_idx == SPP
        assert torch.equal(sess.accum, accum), f
        assert torch.equal(got, disp), f
        assert torch.equal(sess.bvh.table.view(torch.int32),
                           table.view(torch.int32)), f
        assert sess.bvh is sess.bvh_ray and sess.sun_grid is None
    assert not torch.equal(want[0][2], want[1][2])  # a table each frame
    assert not torch.equal(want[0][0], want[1][0])  # the scene turned


def test_turntable_holds_the_unturned_scene():
    sess = _session("box")
    base = sess.scene
    turn = animate.Turntable(sess, 4)
    turn.frame(1, 1)
    assert turn.base is base and sess.scene is not base
    np.testing.assert_array_equal(
        turn.center, animate.turntable_center(sess.scene_host.positions
                                              .numpy()))
    assert turn.plan.num_tris == base.num_triangles
    assert turn.angle(1) == np.float32(np.pi / 2)
    assert turn.angle(0) == np.float32(0.0)


def test_animate_command_renders_through_the_entry(tmp_path, monkeypatch):
    calls = []
    frame = animate.Turntable.frame

    def spy(self, f, spp):
        calls.append((f, spp, self.frames_per_turn))
        return frame(self, f, spp)
    monkeypatch.setattr(animate.Turntable, "frame", spy)
    from dxrpathtracer_tpu_torch.app.cli import main
    out = tmp_path / "anim"
    main(["animate", "--current-scene", "BoxTest", "--width", "16",
          "--height", "8", "--frames", "2", "--spp", "1", "--output",
          str(out), "--device", "cpu"])
    assert calls == [(0, 1, 2), (1, 1, 2)]
    assert sorted(p.name for p in out.iterdir()) == ["frame_000.png",
                                                     "frame_001.png"]


def test_traced_frame_opens_each_span_once():
    sess = _session("box")
    turn = animate.Turntable(sess, FRAMES)
    with tracing() as records:
        turn.frame(1, SPP)
    assert records["turntable"]["calls"] == 1
    for stage in STAGES:
        assert records[f"turntable/turntable.{stage}"]["calls"] == 1, stage
    counted = {p: r["counts"].get("lbvh_build", 0)
               for p, r in records.items()}
    assert counted["turntable/turntable.build"] == 1
    assert sum(counted.values()) == 1
    below = [p for p in records if p.startswith("turntable/turntable.samples/")]
    assert "turntable/turntable.samples/raygen" in below
    assert any(p.endswith("/paths") for p in below)
    assert not any(p.startswith("frame") for p in records)
