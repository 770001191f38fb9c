"""Port parity: the interactive viewer of dxrpathtracer_tpu_torch
(app/interactive.py) against dxrpathtracer_tpu's.

  - One script drives both packages' `InteractiveApp(display=False)` on
    BoxTest at 32x32, sqrt_num_samples=2, through `run_scripted`, one
    (key, frames) step at a time: accumulating frames, every move and look
    key, exposure, MSAA, two settings-menu edits (enable_normal_maps off
    and on, which restarts the accumulation, and enable_vsync off and on,
    which does not), the raster toggle `m` there and back, a screenshot `p`, then
    the bake window: `b` (2 bake frames), `v`, `v`, `b`, and a scene
    switch. After every step: equal sample_idx, camera position and
    rotations, settings and mode, `hud_line()` equal with its two timing
    fields masked, and the accumulation within rel-RMSE 1e-4 (scaled by
    max|ref|) of the JAX one.
  - The bake window's seven previews (64x64 uint8 thumbnails) within 1 of
    JAX's, the bake's sample count equal; the screenshot PNG within 1 per
    channel (the JAX display path is jitted, so XLA may fuse products that
    the port rounds one by one); the live-bake-lit raster frame against
    JAX's within 1e-4, and unlike the frame lit live.
  - `to_rgb8`/`ansi_halfblock_frame` equal on seeded uint8 images;
    `SettingsMenu`'s field list and every `_adjust` result equal.
  - As tests/test_interactive.py holds the JAX app: the quit key, the
    pipelined present (one frame behind, drawing the thumbnail a
    synchronous `display_thumbnail` gives), `stable_power_state`,
    `show_progress_bar`, `check_hot_reload`; a missing card raises for
    `InteractiveApp()` and for `interactive` without `--device cpu`.

The JAX side runs in one subprocess whose XLA:CPU emits no FMA (ISA capped
at AVX), started before the port's app runs, so both run at once; its
sun-space grid, dense proxy, AABB cut and software raster are off (exact
alternates of the per-ray walk that the port does not have).
"""

import contextlib
import dataclasses
import io
import os
import subprocess
import sys

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

torch = pytest.importorskip("torch")

from dxrpathtracer_tpu.app import interactive as jinteractive  # noqa: E402
from dxrpathtracer_tpu.app import settings as jsettings  # noqa: E402
from dxrpathtracer_tpu_torch.app import cli, interactive  # noqa: E402
from dxrpathtracer_tpu_torch.app.interactive import InteractiveApp  # noqa: E402
from dxrpathtracer_tpu_torch.app.settings import AppSettings, Scenes  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 32
LIMIT = 1e-4
PREVIEW = 64
SETTINGS = dict(sqrt_num_samples=2, enable_sunspace_shadows=False,
                enable_dense_proxy=False, enable_clear_cut=False,
                enable_sw_raster=False)

_MENU = [f.name for f in dataclasses.fields(AppSettings)
         if not isinstance(f.default, tuple)]


def _menu_edit(name, keys):
    """Open the menu, move to `name`, press `keys` there, close the menu."""
    return ([("o", 0)] + [("j", 0)] * _MENU.index(name)
            + [(k, 0) for k in keys] + [("o", 0)])


# Every settings change recompiles the JAX frame (settings are a static jit
# argument), so exposure, MSAA and enable_vsync are changed and changed back
# before the next frame: the JAX side then compiles one path frame, one
# raster frame and one bake step.
MOVES = [(None, 2), ("w", 1), ("a", 1), ("q", 1), ("s", 0), ("d", 0),
         ("e", 1), ("l", 1), ("j", 1), ("i", 1), ("k", 1), ("]", 0),
         ("[", 1), ("t", 0), ("t", 0), ("t", 1)]
# enable_normal_maps off restarts, and on again restarts too
SCRIPT = MOVES + _menu_edit("enable_normal_maps", "ll")
AFTER_RESTARTING_EDIT = len(SCRIPT) - 3
SCRIPT += [(None, 1)] + _menu_edit("enable_vsync", "ll")   # does not
VSYNC_OFF = len(SCRIPT) - 3
SCRIPT += [(None, 1), ("m", 2), ("m", 1), ("p", 0), (None, 1),
           ("b", 2), ("v", 1), ("v", 0), ("b", 1)]

# Run by both packages (exec'd in the JAX subprocess): the script step by
# step with the state after each, then the bake window's previews and the
# raster frames lit live and from the bake, then a scene switch.
_SHARED = r'''
import re
import numpy as np


def hud_masked(app):
    return re.sub(r"^ *[-+.\w]+ ms +[-+.\w]+ MRays/s", "<t>", app.hud_line())


def state(app, to_np):
    s = app.session
    return {"sample_idx": s.sample_idx,
            "position": np.asarray(s.camera.position, np.float32),
            "rot": np.asarray([s.camera.x_rot, s.camera.y_rot]),
            "accum": to_np(s.accum), "hud": hud_masked(app),
            "settings": repr(s.settings), "raster": app.raster_mode,
            "bake": app.bake_mode, "menu": app.menu is not None,
            "preview_idx": app.preview_idx}


def drive(app, script, to_np, preview):
    steps = [state(app, to_np)]
    for key, n in script:
        app.run_scripted([(key, n)])
        steps.append(state(app, to_np))
    app.bake_mode = True
    previews = []
    for i in range(len(app.PREVIEWS)):
        app.preview_idx = i
        previews.append(app._bake_preview_thumb(preview, preview))
    app.bake_mode = False
    bake_samples = app.baker.sample_index
    s = app.session
    s.settings = s.settings.replace(enable_ray_tracing=False)
    app.run_scripted([(None, 1)])
    live = to_np(s.accum).copy()
    s.settings = s.settings.replace(enable_light_map_render=True)
    app.run_scripted([(None, 1)])
    lit = to_np(s.accum).copy()
    app.run_scripted([("1", 0)])
    steps.append(state(app, to_np))
    return {"steps": steps, "previews": previews, "live": live, "lit": lit,
            "bake_samples": bake_samples, "baker_dropped": app.baker is None}
'''

_JAX = r'''
import pickle
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from dxrpathtracer_tpu.app.interactive import InteractiveApp
from dxrpathtracer_tpu.app.settings import AppSettings, Scenes

out, res, settings, script, preview, shared = sys.argv[1:]
exec(shared)
app = InteractiveApp(settings=AppSettings(current_scene=Scenes.BoxTest,
                                          **eval(settings)),
                     width=int(res), height=int(res), display=False)
got = drive(app, eval(script), np.asarray, int(preview))
with open(out, "wb") as f:
    pickle.dump(got, f)
'''


def _rel_rmse(img, ref):
    return float(np.sqrt(np.mean((img - ref) ** 2))
                 / (np.abs(ref).max() + 1e-9))


def _read_png(path):
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port's record, JAX's record, port app, the two screenshot dirs)."""
    import pickle
    tmp = tmp_path_factory.mktemp("interactive")
    (tmp / "jax").mkdir()
    (tmp / "port").mkdir()
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    out = tmp / "jax.pkl"
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX, str(out), str(RES), repr(SETTINGS),
         repr(SCRIPT), str(PREVIEW), _SHARED], env=env, cwd=tmp / "jax",
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        scope = {}
        exec(_SHARED, scope)
        cwd = os.getcwd()
        os.chdir(tmp / "port")
        try:
            app = InteractiveApp(
                settings=AppSettings(current_scene=Scenes.BoxTest,
                                     **SETTINGS),
                width=RES, height=RES, display=False, device="cpu")
            port = scope["drive"](app, SCRIPT, lambda t: t.numpy(), PREVIEW)
        finally:
            os.chdir(cwd)
        _, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-4000:]
    with open(out, "rb") as f:
        ref = pickle.load(f)
    return port, ref, app, tmp


def test_script_matches_jax_step_by_step(runs):
    port, ref, _, _ = runs
    assert len(port["steps"]) == len(ref["steps"]) == len(SCRIPT) + 2
    keys = [None] + [k for k, _ in SCRIPT] + ["1"]
    for i, (got, want) in enumerate(zip(port["steps"], ref["steps"])):
        where = f"step {i} (key {keys[i]!r})"
        for k in ("sample_idx", "settings", "raster", "bake", "menu",
                  "preview_idx", "hud"):
            assert got[k] == want[k], (where, k, got[k], want[k])
        np.testing.assert_array_equal(got["position"], want["position"],
                                      err_msg=where)
        np.testing.assert_allclose(got["rot"], want["rot"], rtol=0,
                                   atol=1e-12, err_msg=where)
        assert got["accum"].shape == want["accum"].shape == (RES, RES, 3)
        assert np.isfinite(got["accum"]).all(), where
        err = _rel_rmse(got["accum"], want["accum"])
        assert err <= LIMIT, (where, err)


def test_restart_behaviour(runs):
    """Moves, looks and restart-relevant edits restart the accumulation;
    exposure, MSAA, an enable_vsync edit and the bake window do not; `m`
    resets it; the scene switch drops the baker."""
    port, _, _, _ = runs
    idx = [s["sample_idx"] for s in port["steps"]]   # idx[i + 1]: SCRIPT[i]
    for i, (key, n) in enumerate(MOVES):
        if key in ("]", "[", "t"):
            assert idx[i + 1] == idx[i] + n, (i, key)
        elif key is not None:
            assert idx[i + 1] == n, (i, key)   # restarted, then n samples
    steps = port["steps"]
    edit = AFTER_RESTARTING_EDIT   # the first `l` in the menu
    assert "enable_normal_maps=False" in steps[edit + 1]["settings"]
    assert idx[edit] > 0 and idx[edit + 1] == idx[edit + 2] == 0
    assert "enable_normal_maps=True" in steps[edit + 2]["settings"]
    assert idx[edit + 4] == 1   # the frame after the edit
    assert "enable_vsync=False" in steps[VSYNC_OFF + 1]["settings"]
    assert idx[VSYNC_OFF + 1] == idx[VSYNC_OFF] == 1
    assert idx[VSYNC_OFF + 4] == 2
    m = SCRIPT.index(("m", 2))
    assert idx[m + 1] == 0 and port["steps"][m + 1]["raster"]
    assert idx[m + 2] == 1 and not port["steps"][m + 2]["raster"]
    b = SCRIPT.index(("b", 2))
    assert [idx[i + 1] for i in range(b, b + 3)] == [idx[b]] * 3
    assert idx[b + 4] == idx[b] + 1   # `b` again: back to the path frames
    assert port["steps"][b + 1]["bake"] and not port["steps"][b + 4]["bake"]
    assert port["bake_samples"] == 3 and port["baker_dropped"]
    assert port["steps"][-1]["sample_idx"] == 0


def test_bake_previews_match_jax(runs):
    port, ref, app, _ = runs
    assert port["bake_samples"] == ref["bake_samples"]
    assert len(port["previews"]) == len(app.PREVIEWS) == 7
    for name, got, want in zip(app.PREVIEWS, port["previews"],
                               ref["previews"]):
        assert got.shape == want.shape == (PREVIEW, PREVIEW, 3), name
        assert got.dtype == want.dtype == np.uint8, name
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1, (name, diff.max(), int((diff > 0).sum()))


def test_raster_frames_and_live_bake_light_match_jax(runs):
    port, ref, _, _ = runs
    for k in ("live", "lit"):
        assert np.isfinite(port[k]).all()
        err = _rel_rmse(port[k], ref[k])
        assert err <= LIMIT, (k, err)
    assert not np.allclose(port["lit"], port["live"])


def test_screenshot_png_matches_jax(runs):
    _, _, _, tmp = runs
    got = _read_png(tmp / "port" / "screenshot_000.png")
    want = _read_png(tmp / "jax" / "screenshot_000.png")
    assert got.shape == want.shape == (RES, RES, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_present_helpers_match_jax():
    rng = np.random.default_rng(7)
    for h, w, cols, rows in ((16, 16, 16, 8), (37, 53, 120, 56),
                             (300, 200, 120, 56), (5, 3, 2, 1)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        assert (interactive.ansi_halfblock_frame(img, cols, rows)
                == jinteractive.ansi_halfblock_frame(img, cols, rows))
    x = rng.normal(0.5, 0.7, (9, 11, 3)).astype(np.float32)
    x[0, 0] = [-0.5, 0.5, 2.0]
    np.testing.assert_array_equal(interactive.to_rgb8(x),
                                  jinteractive.to_rgb8(x))
    assert interactive.to_rgb8(x)[0, 0].tolist() == [0, 127, 255]


def test_settings_menu_matches_jax():
    """Field list, and every field adjusted up and down from its default."""
    from types import SimpleNamespace as NS

    port = interactive.SettingsMenu(NS(session=NS(settings=AppSettings())))
    ref = jinteractive.SettingsMenu(
        NS(session=NS(settings=jsettings.AppSettings())))
    assert [f.name for f in port.fields] == [f.name for f in ref.fields]
    for pf, jf in zip(port.fields, ref.fields):
        for d in (+1, -1):
            port.app.session.settings = AppSettings()
            ref.app.session.settings = jsettings.AppSettings()
            port._adjust(pf, d)
            ref._adjust(jf, d)
            assert (repr(port.app.session.settings)
                    == repr(ref.app.session.settings)), (pf.name, d)
    lines = port.render_lines()
    assert lines == ref.render_lines() and lines[1].startswith(">")


def _app(**kw):
    return InteractiveApp(
        settings=AppSettings(current_scene=Scenes.BoxTest, sqrt_num_samples=2,
                             **kw), width=16, height=16, display=False,
        device="cpu")


def test_quit_key_and_progress_bar():
    app = _app()
    assert app.run_scripted([(None, 1), ("x", 5)]) == 1 and app.quit
    assert "sample 1/4" in app.hud_line()
    app.session.settings = app.session.settings.replace(
        show_progress_bar=False)
    assert "sample" not in app.hud_line()


def test_present_is_pipelined_one_frame_behind(monkeypatch):
    """The first present draws nothing; the next draws the first frame's
    thumbnail, byte-equal to a synchronous display_thumbnail of it."""
    drawn = []
    orig = interactive.ansi_halfblock_frame
    monkeypatch.setattr(interactive, "ansi_halfblock_frame",
                        lambda rgb8, *a: drawn.append(rgb8.copy())
                        or orig(rgb8, *a))
    app = _app()
    app.display = True
    app.render_one()
    want = app.session.display_thumbnail(16, 16).numpy().copy()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        app.present()
    assert buf.getvalue() == "" and not drawn
    host, done = app._pending_thumb
    assert host.dtype == torch.uint8 and tuple(host.shape) == (16, 16, 3)
    assert done is None   # the CPU has no copy in flight
    app.render_one()
    with contextlib.redirect_stdout(buf):
        app.present()
    assert "▀" in buf.getvalue() and "MRays/s" in buf.getvalue()
    assert len(drawn) == 1
    np.testing.assert_array_equal(drawn[0], want)


def test_stable_power_state_presents_synchronously(capsys):
    app = _app(stable_power_state=True)
    app.display = True
    app.session.update()
    app.render_one()
    app.present()   # the first present already draws (no warm-up frame)
    assert "\x1b[38;2;" in capsys.readouterr().out


def test_check_hot_reload_noop():
    import time
    app = _app()
    assert app.check_hot_reload(now=time.monotonic() + 2.0) == []
    assert app.reload_notice == ""


def test_missing_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("DXRPT_CRASH_DUMP", str(tmp_path / "crash.json"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InteractiveApp(display=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["interactive", "--current-scene", "BoxTest", "--width",
                  "8", "--height", "8", "--script", ":1"])
    assert (tmp_path / "crash.json").exists()
    assert cli.main(["interactive", "--current-scene", "BoxTest", "--width",
                     "8", "--height", "8", "--script", "w:1,:1",
                     "--device", "cpu"]) == 0
