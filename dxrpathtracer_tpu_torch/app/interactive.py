"""Interactive progressive viewer — the reference's windowed app loop, built
for a terminal.

The port of dxrpathtracer_tpu/app/interactive.py, key for key. The reference
is an interactive Win32 app: a message pump drives Update (camera WASD/QE +
mouse look, DXRPathTracer.cpp:1353-1381) and Render (progressive
accumulation that restarts when camera/settings change), with an ImGui HUD
showing frame time and Mrays/s (DXRPathTracer.cpp:2151-2190). Here the
render session runs the same update-restart-accumulate loop on the card
while the terminal provides both the display (24-bit ANSI half-block cells —
every cell shows two pixels via fg/bg color) and the input (raw-mode key
reads, no window system required).

Controls (mirroring App.cpp / DXRPathTracer.cpp:1353-1381):
  w/s a/d q/e  move forward/back, left/right, up/down
  i/k j/l      look up/down, left/right (the mouse-drag substitute)
  [ ]          exposure down/up
  1-5          scene presets (BoxTest, Sponza, SunTemple, WhiteFurnace, Stronghold)
  o            settings menu over every AppSettings field
  t            cycle MSAA mode (raster), m toggle raster/path-traced mode
  b            lightmap window: start/stop progressive baking (resumable)
  v            cycle the bake preview texture (7-texture combo,
               DXRPathTracer.cpp:2261-2302)
  p            save screenshot PNG   x  quit

Every frame synchronises the card, so the HUD's frame time is the frame's.
The present reads back a small thumbnail made on the card: it copies it into
pinned host memory without blocking, records a CUDA event after the copy,
and draws the previous frame's thumbnail once that frame's event has
completed (the reference's frame-latency-2 swap chain, DX12.cpp:263-305).

Headless operation: `script` is a list of (key, frames) tuples; the loop
replays them without a TTY so tests and CI can drive the full app loop.
"""

import os
import sys
import time

import numpy as np
import torch

from .cli import _settings_from_args, _sync
from .session import RenderSession
from .settings import AppSettings, MSAAModes, Scenes


def _supports_color():
    return sys.stdout.isatty() and os.environ.get("TERM", "") != "dumb"


def to_rgb8(display_img):
    """[0,1] display output (already tone-mapped by session.display_image,
    PostProcessor::Render) -> uint8 for the terminal present."""
    return np.clip(np.asarray(display_img) * 255.0, 0.0, 255.0).astype(np.uint8)


def ansi_halfblock_frame(rgb8, max_cols=120, max_rows=56):
    """Render an (H, W, 3) uint8 image as ANSI half-block text.

    Each text cell encodes TWO vertically-stacked pixels: upper pixel as the
    foreground color of '▀', lower pixel as the background — the terminal
    equivalent of the reference's swap-chain present."""
    h, w = rgb8.shape[:2]
    cols = min(max_cols, w)
    rows2 = min(max_rows * 2, h)
    ys = (np.linspace(0, h - 1, rows2)).astype(int)
    xs = (np.linspace(0, w - 1, cols)).astype(int)
    small = rgb8[ys][:, xs]
    if small.shape[0] % 2:
        small = small[:-1]
    top = small[0::2]
    bot = small[1::2]
    lines = []
    for r in range(top.shape[0]):
        cells = []
        for c in range(cols):
            tr, tg, tb = (int(v) for v in top[r, c])
            br, bg, bb = (int(v) for v in bot[r, c])
            cells.append(f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀")
        lines.append("".join(cells) + "\x1b[0m")
    return "\n".join(lines)


class _RawKeys:
    """Non-blocking single-key reads (the Win32 message pump substitute)."""

    def __enter__(self):
        import termios
        import tty
        self.fd = sys.stdin.fileno()
        self.saved = termios.tcgetattr(self.fd)
        tty.setcbreak(self.fd)
        os.set_blocking(self.fd, False)
        return self

    def __exit__(self, *exc):
        import termios
        termios.tcsetattr(self.fd, termios.TCSADRAIN, self.saved)
        os.set_blocking(self.fd, True)

    def poll(self):
        try:
            ch = sys.stdin.read(1)
        except (OSError, ValueError):
            return None
        return ch if ch else None


_SCENE_KEYS = {"1": Scenes.BoxTest, "2": Scenes.Sponza, "3": Scenes.SunTemple,
               "4": Scenes.WhiteFurnace, "5": Scenes.Stronghold}

MOVE_SPEED = 0.5   # per keypress (the reference uses 5.0 * dt held-key)
ROT_SPEED = 0.12
# The bake window's charted atlas: the packer's fast options.
BAKE_ATLAS_OPTS = {"grid_cols": 512, "pack_iters": 2}


def bake_window_resolution(num_triangles: int) -> int:
    """The bake window's lightmap side: 128, or 256 from 5,000 triangles."""
    return 128 if num_triangles < 5000 else 256


class SettingsMenu:
    """Runtime settings editor auto-generated from the AppSettings registry
    — the terminal ImGui equivalent (the reference reflects AppSettings.cs
    into an ImGui panel, Settings.cpp:176-332; here the same dataclass that
    generates CLI flags generates the menu). Changes go through
    settings.replace(), so restart_key() dirty-tracking resets the
    progressive accumulation exactly like a CLI/ImGui change would.

    Keys: j/k move, h/l adjust (floats step, ints +-1, bools/enums cycle),
    enter toggles, o or x closes."""

    _FLOAT_STEPS = {"exposure": 0.5, "bloom_exposure": 0.5, "sun_size": 0.1,
                    "turbidity": 0.25, "bloom_magnitude": 0.1,
                    "bloom_blur_sigma": 0.25, "roughness_scale": 0.05,
                    "metallic_scale": 0.05}

    def __init__(self, app):
        import dataclasses as _dc
        self.app = app
        self.fields = [f for f in _dc.fields(AppSettings)
                       if not isinstance(f.default, tuple)]
        self.cursor = 0
        self.closed = False

    def _adjust(self, field, direction):
        import enum as _enum
        s = self.app.session.settings
        cur = getattr(s, field.name)
        if isinstance(cur, bool):
            new = not cur
        elif isinstance(cur, _enum.IntEnum):
            members = list(type(cur))
            new = members[(members.index(cur) + direction) % len(members)]
        elif isinstance(cur, int):
            new = max(cur + direction, 0)
        elif isinstance(cur, float):
            new = cur + direction * self._FLOAT_STEPS.get(field.name, 0.1)
        else:
            return
        self.app.session.settings = s.replace(**{field.name: new})

    def handle_key(self, key):
        if key in ("o", "x", "\x1b"):
            self.closed = True
        elif key in ("j", "s"):
            self.cursor = (self.cursor + 1) % len(self.fields)
        elif key in ("k", "w"):
            self.cursor = (self.cursor - 1) % len(self.fields)
        elif key in ("l", "+", "=", "\r", "\n"):
            self._adjust(self.fields[self.cursor], +1)
        elif key in ("h", "-"):
            self._adjust(self.fields[self.cursor], -1)

    def render_lines(self, max_rows=18):
        s = self.app.session.settings
        half = max_rows // 2
        lo = max(0, min(self.cursor - half, len(self.fields) - max_rows))
        out = ["--- settings (j/k move, h/l adjust, o close) ---"]
        for i in range(lo, min(lo + max_rows, len(self.fields))):
            f = self.fields[i]
            v = getattr(s, f.name)
            v = v.name if hasattr(v, "name") else v
            mark = ">" if i == self.cursor else " "
            out.append(f"{mark} {f.name:<42} {v}")
        return out


class InteractiveApp:
    """Update/Render loop around RenderSession (App::Run, SampleFramework12
    App.cpp:55-87 + DXRPathTracer::Update/Render).

    Every session it makes (the first, and one per scene switch) and the
    baker run on `device`: the card unless the caller passes "cpu"; with no
    card the first session raises. `asset_root` is the directory scenes are
    imported from (registry.load_scene); without one each is its stand-in."""

    def __init__(self, settings: AppSettings | None = None, width=384,
                 height=216, display=None, device="cuda", asset_root=None):
        self.settings = settings or AppSettings(current_scene=Scenes.BoxTest,
                                                sqrt_num_samples=4)
        self.width, self.height = width, height
        self.device = device
        self.asset_root = asset_root
        self.session = self._new_session(self.settings)
        self.display = _supports_color() if display is None else display
        self.menu = None
        self.quit = False
        self.frame_times = []
        self.screenshots = 0
        # lightmap window state (the reference HUD's bake orchestration +
        # 7-texture preview combo, DXRPathTracer.cpp:2225-2302)
        self.bake_mode = False
        self.baker = None
        self.preview_idx = 0
        self._uvviz_cache = None
        # the previous frame's thumbnail: (host tensor, CUDA event or None)
        self._pending_thumb = None
        # shader hot reload (ShaderCompilation.cpp:416 file watch; polled
        # once per second from the run loop like UpdateShaders per frame)
        from .hotreload import ShaderWatcher
        self.shader_watcher = ShaderWatcher()
        self._last_watch_poll = 0.0
        self.reload_notice = ""

    def _new_session(self, settings):
        return RenderSession(settings=settings, width=self.width,
                             height=self.height, device=self.device,
                             asset_root=self.asset_root)

    def check_hot_reload(self, now=None):
        """Poll watched render-path sources (modules and CUDA sources); on
        change reload them and rebuild the session's per-sample step
        (App.cpp:231-237). Returns the list of reloaded module names."""
        now = time.monotonic() if now is None else now
        if now - self._last_watch_poll < 1.0:
            return []
        self._last_watch_poll = now
        reloaded = self.shader_watcher.poll_and_reload()
        if reloaded:
            self.session.rebuild_step()
            short = ", ".join(n.rsplit(".", 1)[-1] for n in reloaded)
            self.reload_notice = f"hot-reloaded: {short}"
        return reloaded

    # -- input handling (DXRPathTracer.cpp:1353-1381) --
    def handle_key(self, key):
        if self.menu is not None:
            self.menu.handle_key(key)
            if self.menu.closed:
                self.menu = None
            return
        if key == "o":
            # runtime settings editor over the FULL registry — the
            # terminal equivalent of the reference's auto-generated ImGui
            # editor (Settings.cpp:176-332)
            self.menu = SettingsMenu(self)
            return
        cam = self.session.camera
        s = self.session.settings
        fwd = cam.forward()
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= max(np.linalg.norm(right), 1e-8)
        up = np.cross(fwd, right)
        moves = {"w": fwd, "s": -fwd, "d": right, "a": -right,
                 "q": up, "e": -up}
        if key in moves:
            cam.set_position(cam.position + np.asarray(moves[key], np.float32)
                             * MOVE_SPEED)
        elif key == "i":
            cam.set_x_rotation(cam.x_rot - ROT_SPEED)
        elif key == "k":
            cam.set_x_rotation(cam.x_rot + ROT_SPEED)
        elif key == "j":
            cam.set_y_rotation(cam.y_rot - ROT_SPEED)
        elif key == "l":
            cam.set_y_rotation(cam.y_rot + ROT_SPEED)
        elif key == "[":
            self.session.settings = s.replace(exposure=s.exposure - 0.5)
        elif key == "]":
            self.session.settings = s.replace(exposure=s.exposure + 0.5)
        elif key in _SCENE_KEYS:
            self.session = self._new_session(
                s.replace(current_scene=_SCENE_KEYS[key]))
            # the baker holds scene-specific atlas/surface maps
            self.baker = None
            self.bake_mode = False
            self._uvviz_cache = None
        elif key == "m":
            # 'm' flips EnableRayTracing itself (the raster/path mode switch,
            # DXRPathTracer::Render :1538-1559) so restart-key dirty tracking
            # and the settings menu both see the same state.
            self.session.settings = s.replace(
                enable_ray_tracing=not s.enable_ray_tracing)
            # The raster frame overwrites the accumulation; without a reset,
            # returning to path mode would lerp fresh samples against the
            # raster image at weight s/(s+1).
            self.session.reset_accumulation()
        elif key == "t":
            order = [MSAAModes.MSAANone, MSAAModes.MSAA2x, MSAAModes.MSAA4x]
            cur = order.index(s.msaa_mode) if s.msaa_mode in order else 0
            self.session.settings = s.replace(
                msaa_mode=order[(cur + 1) % len(order)])
        elif key == "b":
            # lightmap window: toggle progressive baking (HUD "Start Baking",
            # DXRPathTracer.cpp:2234-2239); the Baker persists across
            # toggles, so baking resumes where it stopped
            self.bake_mode = not self.bake_mode
            if not s.enable_ray_tracing:  # leave raster mode while baking
                self.session.settings = s.replace(enable_ray_tracing=True)
            if self.bake_mode and self.baker is None:
                from ..bake.baker import Baker
                self.baker = Baker(
                    self.session, resolution=bake_window_resolution(
                        self.session.scene_host.num_triangles),
                    atlas_opts=BAKE_ATLAS_OPTS)
        elif key == "v" and self.bake_mode:
            # preview combo: cycle the 7 intermediate textures
            # (DXRPathTracer.cpp:2261-2302)
            self.preview_idx = (self.preview_idx + 1) % len(self.PREVIEWS)
        elif key == "p":
            self.save_screenshot()
        elif key == "x":
            self.quit = True

    def save_screenshot(self):
        from ..render.film import write_png
        path = f"screenshot_{self.screenshots:03d}.png"
        write_png(path, self.current_display_image())
        self.screenshots += 1
        return path

    @property
    def raster_mode(self):
        """Forward raster path active (EnableRayTracing=false,
        DXRPathTracer::Render :1538-1559) — derived from the setting so the
        'm' hotkey and the settings menu stay in sync."""
        return not self.session.settings.enable_ray_tracing

    # -- frame --
    def render_one(self):
        t0 = time.perf_counter()
        if self.bake_mode:
            # one texel-sample per frame, like the reference's per-frame
            # RenderBakingPass (DXRPathTracer.cpp:1993-2022)
            self.baker.bake_step()
        elif self.raster_mode:
            # EnableLightMapRender consumes the in-session bake live, like
            # the reference's Mesh.hlsl:155-162 branch
            lm = uvs = None
            if (self.session.settings.enable_light_map_render
                    and self.baker is not None):
                lm = self.baker.lightmap()
                uvs = (self.baker.atlas.tri_uv
                       if hasattr(self.baker.atlas, "tri_uv")
                       else self.baker.atlas.triangle_uvs())
            # the display path shares the accumulation
            self.session.accum = self.session.render_raster_frame(
                lightmap=lm, lightmap_uvs=uvs)
        else:
            self.session.render_frame(force=True)
        _sync(self.session.device)  # the HUD's frame time is the frame's
        self.frame_times.append(time.perf_counter() - t0)

    # the reference's 7-texture lightmap preview combo
    PREVIEWS = ("lightmap", "lightmap+guided", "lightmap+median",
                "albedo map", "normal map", "sample count", "uv layout")

    def _bake_preview_thumb(self, cols, rows):
        """(rows, cols, 3) uint8 thumbnail of the selected bake texture —
        built on the device, a small readback (as the path preview)."""
        from ..core.constants import FP16Scale
        from ..core.math3 import div
        from ..render.postfx import tone_map_filmic_alu
        b = self.baker
        name = self.PREVIEWS[self.preview_idx]
        if name == "uv layout":
            if self._uvviz_cache is None:
                from ..render.uvviz import visualize_uvs
                self._uvviz_cache = torch.from_numpy(
                    visualize_uvs(b.atlas, b.resolution)).to(b.device)
            img = self._uvviz_cache
        elif name == "albedo map":
            img = b.surface_maps["albedo"]
        elif name == "normal map":
            img = b.surface_maps["normal"] * 0.5 + 0.5
        elif name == "sample count":
            cnt = b.accum[..., 3:4]
            img = (cnt / torch.clamp_min(cnt.max(), 1.0)).expand(
                *cnt.shape[:-1], 3)
        else:
            if name == "lightmap":
                lm = b.lightmap()
            else:
                lm = b.denoised_lightmap(name.split("+", 1)[1])
            e = 2.0 ** self.session.settings.exposure
            img = tone_map_filmic_alu(div(lm * e, FP16Scale))
        ys = np.linspace(0, img.shape[0] - 1, rows).astype(np.int32)
        xs = np.linspace(0, img.shape[1] - 1, cols).astype(np.int32)
        ys = torch.from_numpy(ys).long().to(img.device)
        xs = torch.from_numpy(xs).long().to(img.device)
        thumb = torch.clamp(img[ys][:, xs] * 255.0 + 0.5, 0, 255)
        return thumb.to(torch.uint8).cpu().numpy()

    def current_display_image(self):
        """Full-resolution display image (screenshots), on the host."""
        return self.session.display_image().cpu().numpy()

    def hud_line(self):
        """HUD text (the reference's ImGui overlay, DXRPathTracer.cpp:2151-90):
        frame time, Mrays/s estimate formula (:2171-2174), sample progress."""
        s = self.session.settings
        dt = self.frame_times[-1] if self.frame_times else 0.0
        if self.bake_mode:
            b = self.baker
            rays = b.resolution * b.resolution * s.max_path_length
            return (f"{dt*1e3:7.1f} ms  "
                    f"{rays / max(dt, 1e-9) / 1e6:6.1f} MRays/s  "
                    f"baking {b.resolution}² sample {b.sample_index}  "
                    f"preview: {self.PREVIEWS[self.preview_idx]}  "
                    f"[v cycle view, b stop, x quit]")
        rays = (self.width * self.height *
                (1 + (s.max_path_length - 1) * 2))
        mrays = rays / max(dt, 1e-9) / 1e6
        cam = self.session.camera
        progress = (f"sample {min(self.session.sample_idx, s.total_samples)}"
                    f"/{s.total_samples}  " if s.show_progress_bar else "")
        notice = f"{self.reload_notice}  " if self.reload_notice else ""
        return (f"{dt*1e3:7.1f} ms  {mrays:6.1f} MRays/s  "
                f"{progress}{notice}"
                f"cam ({cam.position[0]:.1f} {cam.position[1]:.1f} "
                f"{cam.position[2]:.1f})  "
                f"{'raster' if self.raster_mode else 'path'}  "
                f"[wasdqe move, ijkl look, b bake, p shot, x quit]")

    # terminal cell budget (ansi_halfblock_frame: 2 pixels per text row)
    PRESENT_COLS = 120
    PRESENT_ROWS = 112

    def _copy_thumb_async(self, thumb):
        """Start the thumbnail's copy to the host: (host tensor, the CUDA
        event recorded after the copy, or None where nothing is pending)."""
        if thumb.device.type != "cuda":
            return thumb, None
        host = torch.empty(thumb.shape, dtype=thumb.dtype, pin_memory=True)
        with torch.cuda.device(thumb.device):
            host.copy_(thumb, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        return host, done

    def present(self):
        """Pipelined present: the session tone-maps + downsamples ON DEVICE
        to the terminal's ~120x112 pixels, the copy to the host starts
        without blocking, and the PREVIOUS frame's thumbnail is drawn once
        its copy has completed — so the copy overlaps the next frame (the
        reference's frame-latency-2 swap chain, DX12.cpp:263-305)."""
        if not self.display:
            return
        if self.bake_mode:
            # bake previews draw synchronously (the bake step dominates)
            side = min(self.PRESENT_ROWS, self.PRESENT_COLS,
                       self.baker.resolution)
            frame = self._bake_preview_thumb(side, side)
        else:
            cols = min(self.PRESENT_COLS, self.width)
            rows = min(self.PRESENT_ROWS, self.height)
            thumb = self.session.display_thumbnail(cols, rows)
            if self.session.settings.stable_power_state:
                # StablePowerState (DXRPathTracer.cpp:1391-1395) trades
                # throughput for repeatable timing; here that means a
                # synchronous present — no frame-latency pipelining, so the
                # HUD frame time covers exactly one dispatch+readback.
                frame = thumb.cpu().numpy()
            else:
                prev = self._pending_thumb
                self._pending_thumb = self._copy_thumb_async(thumb)
                if prev is None:
                    return
                host, done = prev
                if done is not None:
                    done.synchronize()  # its bytes are in the buffer now
                frame = host.numpy()
        sys.stdout.write("\x1b[H\x1b[2J")
        sys.stdout.write(ansi_halfblock_frame(frame))
        sys.stdout.write("\n" + self.hud_line() + "\n")
        if self.menu is not None:
            sys.stdout.write("\n".join(self.menu.render_lines()) + "\n")
        sys.stdout.flush()

    # -- loops --
    def run_scripted(self, script, max_frames=64):
        """Headless loop: replay (key, frames) tuples. Returns frame count."""
        frames = 0
        for key, n_frames in script:
            if key:
                self.handle_key(key)
            self.session.update()
            for _ in range(n_frames):
                if frames >= max_frames or self.quit:
                    return frames
                self.render_one()
                self.present()
                frames += 1
            if self.quit:
                break
        return frames

    VSYNC_INTERVAL = 1.0 / 60.0

    def run(self, max_frames=None):
        """Interactive TTY loop (the Win32 message pump)."""
        frames = 0
        with _RawKeys() as keys:
            while not self.quit:
                t0 = time.perf_counter()
                key = keys.poll()
                while key is not None:
                    self.handle_key(key)
                    key = keys.poll()
                self.check_hot_reload()
                self.session.update()
                self.render_one()
                self.present()
                if self.session.settings.enable_vsync:
                    # swap-chain sync interval 1: pace to the 60 Hz vblank
                    # (EnableVSync -> Present(1), DX12.cpp:263-305)
                    pad = self.VSYNC_INTERVAL - (time.perf_counter() - t0)
                    if pad > 0:
                        time.sleep(pad)
                frames += 1
                if max_frames is not None and frames >= max_frames:
                    break
        return frames


def cmd_interactive(args):
    settings = _settings_from_args(args)
    app = InteractiveApp(settings=settings, width=args.width,
                         height=args.height, device=args.device,
                         asset_root=args.asset_root)
    if args.script:
        script = []
        for tok in args.script.split(","):
            key, _, cnt = tok.partition(":")
            script.append((key or None, int(cnt or 1)))
        n = app.run_scripted(script, max_frames=args.max_frames or 64)
    else:
        n = app.run(max_frames=args.max_frames)
    print(f"\n{n} frames, mean "
          f"{1e3*np.mean(app.frame_times or [0]):.1f} ms/frame",
          file=sys.stderr)
    return 0
