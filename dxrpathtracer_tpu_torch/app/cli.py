"""Command-line shell: `python -m dxrpathtracer_tpu_torch render|animate|bake|interactive|uvviz ...`.

The port of dxrpathtracer_tpu/app/cli.py's commands: every AppSettings field
is a flag, as in the JAX package, plus each command's own. `render`
path-traces, or with `--raster` (or EnableRayTracing=false) renders one
forward-shaded frame, lit from a `bake --output FILE.npz` bundle with
`--lightmap`; `--profile-trace DIR` writes a torch.profiler trace of the
render with the program's spans (app/profiler.py) on the kernels' timeline,
and prints the host syncs counted under each span. `animate` renders a turntable of the scene with its W8 table
rebuilt on the device every frame. `interactive` is the terminal viewer
(app/interactive.py); `--script 'w:2,l:1,:4'` drives it without a
terminal. `--asset-root DIR` imports the scene's FBX from DIR (the
reference's Content/ layout) where render, animate, bake and interactive
load a scene; without it the scene is its procedural stand-in. They run on
the card (`--device cuda`, the default) and raise when there is none; pass
`--device cpu` for the plain versions. Every command runs inside the crash
guard (app/crashdump.py): an exception writes a JSON crash dump
($DXRPT_CRASH_DUMP, or dxrpathtracer_crash.json) and is re-raised.
"""

import argparse
import contextlib
import dataclasses
import enum
import os
import sys
import time

import numpy as np
import torch

from .settings import AppSettings


def _add_settings_flags(parser: argparse.ArgumentParser):
    for f in dataclasses.fields(AppSettings):
        name = "--" + f.name.replace("_", "-")
        default = f.default
        if isinstance(default, bool):
            parser.add_argument(name, type=lambda v: v.lower() in ("1", "true", "yes"),
                                default=None, metavar="BOOL")
        elif isinstance(default, enum.IntEnum):
            parser.add_argument(name, type=str, default=None,
                                help=f"one of {[e.name for e in type(default)]}")
        elif isinstance(default, (int, float)):
            parser.add_argument(name, type=type(default), default=None)
        elif isinstance(default, tuple):
            parser.add_argument(name, type=float, nargs=len(default), default=None)


def _add_asset_root(parser: argparse.ArgumentParser):
    parser.add_argument("--asset-root", type=str, default=None,
                        help="import the scene's FBX, textures and spot "
                             "lights from this directory (laid out as the "
                             "reference's Content/); default: the "
                             "procedural stand-in")


def _settings_from_args(args) -> AppSettings:
    kw = {}
    for f in dataclasses.fields(AppSettings):
        v = getattr(args, f.name, None)
        if v is None:
            continue
        if isinstance(f.default, enum.IntEnum):
            v = type(f.default)[v] if isinstance(v, str) else type(f.default)(v)
        elif isinstance(f.default, tuple):
            v = tuple(v)
        kw[f.name] = v
    return AppSettings(**kw)


def _progress(i, total, t0, width, height, max_path_length):
    dt = max(time.time() - t0, 1e-6)
    rays = width * height * (1 + (max_path_length - 1) * 2) * (i + 1)
    bar = int(30 * (i + 1) / total)
    sys.stderr.write(f"\r[{'#' * bar}{'.' * (30 - bar)}] {i + 1}/{total} samples "
                     f"{rays / dt / 1e6:7.1f} Mrays/s ")
    sys.stderr.flush()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cmd_render(args):
    from ..render.film import write_image
    from ..render.postfx import post_process
    from .session import RenderSession

    settings = _settings_from_args(args)
    # --lightmap: the reference's EnableLightMapRender flow (Mesh.hlsl:155-162)
    # from a `bake --output FILE.npz` bundle (lightmap + the atlas tri UVs it
    # was baked against).
    lightmap = lightmap_uvs = None
    if args.lightmap:
        with np.load(args.lightmap) as bundle:
            lightmap, lightmap_uvs = bundle["lightmap"], bundle["tri_uv"]
        settings = settings.replace(enable_light_map_render=True)
    t0 = time.time()
    sess = RenderSession(settings=settings, width=args.width,
                         height=args.height, device=args.device,
                         asset_root=args.asset_root)
    print(f"# scene={sess.preset.name} tris={sess.scene.num_triangles} "
          f"bvh_rows={sess.bvh.num_rows} init={time.time() - t0:.1f}s "
          f"device={sess.device}", file=sys.stderr)
    trace = contextlib.nullcontext()
    if args.profile_trace:
        from .profiler import device_trace
        trace = device_trace(args.profile_trace)
        print(f"# torch.profiler trace -> {args.profile_trace}/trace.json",
              file=sys.stderr)
    with trace:
        # EnableRayTracing=false selects the forward raster path
        # (DXRPathTracer::Render :1538-1559); --raster is shorthand for it.
        if args.raster or not settings.enable_ray_tracing:
            img = sess.render_raster_frame(shadow_mode=args.shadow_mode,
                                           lightmap=lightmap,
                                           lightmap_uvs=lightmap_uvs)
            s = sess.settings
            disp = post_process(img, s.exposure, s.bloom_exposure,
                                s.bloom_magnitude, s.bloom_blur_sigma)
            hdr = img
        else:
            show_progress = args.progress and settings.show_progress_bar
            total = settings.total_samples
            t0 = time.time()
            while sess.sample_idx < total:
                sess.render_frame(force=True)
                if show_progress:
                    _sync(sess.device)
                    _progress(sess.sample_idx - 1, total, t0, args.width,
                              args.height, settings.max_path_length)
            if show_progress:
                sys.stderr.write("\n")
            disp, hdr = sess.display_image(), sess.accum
        _sync(sess.device)
    write_image(args.output, disp.cpu().numpy())
    if args.save_hdr:
        # the raw HDR image (the accumulation, or the raster frame): .exr or
        # .npy by extension
        write_image(args.save_hdr, hdr.cpu().numpy())
    print(f"# wrote {args.output}", file=sys.stderr)


def cmd_animate(args):
    """Turntable animation with the W8 table rebuilt on the device every
    frame (the JAX package's `animate`): each frame is `Turntable.frame`
    (scene/animate.py), which rotates the whole scene on the device, builds
    its morton table there (accel/device_build.py, one plan for the
    triangle count) and renders `--spp` samples with every traversal class
    on that table; geometry never goes back to the host. Writes
    OUTPUT/frame_NNN.png, and with `--gif` a GIF of them (PIL)."""
    from ..render.film import write_image
    from ..scene.animate import Turntable
    from .session import RenderSession

    if args.gif:
        try:
            from PIL import Image
        except ImportError as e:
            raise SystemExit("animate --gif writes the GIF with PIL "
                             "(Pillow), which is not installed; the PNG "
                             "frames need no PIL") from e
    settings = _settings_from_args(args)
    t0 = time.time()
    sess = RenderSession(settings=settings, width=args.width,
                         height=args.height, device=args.device,
                         asset_root=args.asset_root)
    turn = Turntable(sess, args.frames)
    os.makedirs(args.output, exist_ok=True)
    print(f"# scene={sess.preset.name} tris={sess.scene.num_triangles} "
          f"rows={turn.plan.num_rows} frames={args.frames} spp={args.spp} "
          f"init={time.time() - t0:.1f}s device={sess.device}",
          file=sys.stderr)
    paths = []
    for f in range(args.frames):
        t1 = time.time()
        disp = turn.frame(f, args.spp).cpu().numpy()
        path = os.path.join(args.output, f"frame_{f:03d}.png")
        write_image(path, disp)
        paths.append(path)
        print(f"# frame {f + 1}/{args.frames} "
              f"{(time.time() - t1) * 1e3:.0f} ms -> {path}", file=sys.stderr)
    if args.gif:
        ims = [Image.open(p) for p in paths]
        ims[0].save(args.gif, save_all=True, append_images=ims[1:],
                    duration=max(20, int(1000 / args.fps)), loop=0)
        print(f"# wrote {args.gif}", file=sys.stderr)


def cmd_bake(args):
    from ..bake.baker import Baker
    from ..core.constants import FP16Scale
    from ..render.film import write_image, write_png
    from ..render.postfx import tone_map_filmic_alu
    from .session import RenderSession

    settings = _settings_from_args(args)
    sess = RenderSession(settings=settings, width=8, height=8,
                         device=args.device, asset_root=args.asset_root)
    baker = Baker(sess, resolution=args.resolution, atlas_mode=args.atlas)
    ckpt = args.checkpoint
    if ckpt and os.path.exists(ckpt):
        baker.load_checkpoint(ckpt)
        print(f"# resumed bake at sample {baker.sample_index} from {ckpt}",
              file=sys.stderr)
    show_progress = args.progress and settings.show_progress_bar
    t0 = time.time()
    for i in range(baker.sample_index, args.samples):
        baker.bake_step()
        if show_progress:
            _sync(sess.device)
            _progress(i, args.samples, t0, args.resolution, args.resolution,
                      settings.max_path_length)
        if ckpt and (i + 1) % max(args.checkpoint_every, 1) == 0:
            baker.save_checkpoint(ckpt)
    if ckpt:
        baker.save_checkpoint(ckpt)
    if show_progress:
        sys.stderr.write("\n")
    lm = baker.denoised_lightmap(args.denoise) if args.denoise else baker.lightmap()
    if args.output.endswith(".npz"):
        # lit-render bundle: HDR lightmap + the atlas UVs it was baked
        # against (the JAX package's `render --raster --lightmap FILE.npz`
        # reads it)
        uvs = (baker.atlas.tri_uv if hasattr(baker.atlas, "tri_uv")
               else baker.atlas.triangle_uvs())
        np.savez_compressed(args.output, lightmap=lm.cpu().numpy(),
                            tri_uv=np.asarray(uvs))
    elif args.output.endswith((".npy", ".exr")):
        write_image(args.output, lm.cpu().numpy())
    else:
        disp = tone_map_filmic_alu(lm * (2.0 ** settings.exposure) / FP16Scale)
        write_png(args.output, disp.cpu().numpy())
    print(f"# wrote {args.output}", file=sys.stderr)


def cmd_uvviz(args):
    from ..bake.charts import build_charted_atlas
    from ..bake.lightmap_uv import build_lightmap_atlas
    from ..render.film import write_png
    from ..render.uvviz import visualize_uvs
    from ..scene.registry import load_scene

    settings = _settings_from_args(args)
    scene, _ = load_scene(settings.current_scene)
    if args.atlas == "charts":
        atlas = build_charted_atlas(np.asarray(scene.positions),
                                    np.asarray(scene.tri_idx),
                                    ref_resolution=args.resolution)
    else:
        atlas = build_lightmap_atlas(int(scene.num_triangles))
    write_png(args.output, visualize_uvs(atlas, args.resolution))
    print(f"# wrote {args.output}", file=sys.stderr)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="dxrpathtracer_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p_render = sub.add_parser("render",
                              help="progressive path trace to an image")
    p_render.add_argument("--width", type=int, default=1920)
    p_render.add_argument("--height", type=int, default=1080)
    p_render.add_argument("--output", type=str, default="render.png")
    p_render.add_argument("--save-hdr", type=str, default=None,
                          help="also save the raw HDR image, the accumulation "
                               "or the raster frame (.exr or .npy)")
    p_render.add_argument("--raster", action="store_true",
                          help="forward raster-mode frame "
                               "(EnableRayTracing=false)")
    p_render.add_argument("--shadow-mode", type=str, default="rays",
                          choices=["rays", "pcf", "evsm", "msm"],
                          help="raster sun shadows: exact rays, CSM depth "
                               "maps + PCF, or EVSM/MSM moment maps "
                               "(ShadowMapMode, ShadowHelper.h:25-108)")
    p_render.add_argument("--lightmap", type=str, default=None,
                          help="raster mode: render lightmap-lit from a "
                               "`bake --output FILE.npz` bundle (the "
                               "reference's EnableLightMapRender, "
                               "Mesh.hlsl:155-162)")
    p_render.add_argument("--profile-trace", type=str, default=None,
                          help="write a torch.profiler trace of the render, "
                               "the program's dxrpt.* spans among its kernels, "
                               "to DIR/trace.json (Chrome trace format) and "
                               "print the host syncs counted by span")
    p_render.add_argument("--progress", action="store_true", default=True)
    p_render.add_argument("--device", type=str, default="cuda",
                          help="torch device; 'cpu' runs the plain versions")
    _add_asset_root(p_render)
    _add_settings_flags(p_render)
    p_render.set_defaults(fn=cmd_render)

    p_anim = sub.add_parser("animate",
                            help="turntable animation with the BVH rebuilt "
                                 "on the device every frame (dynamic "
                                 "geometry)")
    p_anim.add_argument("--width", type=int, default=640)
    p_anim.add_argument("--height", type=int, default=360)
    p_anim.add_argument("--frames", type=int, default=24)
    p_anim.add_argument("--spp", type=int, default=4,
                        help="samples per animation frame")
    p_anim.add_argument("--output", type=str, default="anim",
                        help="output directory for frame_NNN.png")
    p_anim.add_argument("--gif", type=str, default=None,
                        help="also assemble the frames into a GIF (PIL)")
    p_anim.add_argument("--fps", type=float, default=12.0)
    p_anim.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the plain versions")
    _add_asset_root(p_anim)
    _add_settings_flags(p_anim)
    p_anim.set_defaults(fn=cmd_animate)

    p_bake = sub.add_parser("bake", help="bake a GI lightmap")
    p_bake.add_argument("--resolution", type=int, default=1024)
    p_bake.add_argument("--samples", type=int, default=64)
    p_bake.add_argument("--atlas", type=str, default="charts",
                        choices=["charts", "pair"],
                        help="lightmap UV atlas: charted (xatlas-equivalent)"
                             " or the analytic per-triangle pair packer")
    p_bake.add_argument("--denoise", type=str, default=None,
                        choices=[None, "median", "atrous", "guided",
                                 "learned"])
    p_bake.add_argument("--output", type=str, default="lightmap.png")
    p_bake.add_argument("--checkpoint", type=str, default=None,
                        help="bake checkpoint .npz: resumed from if present, "
                             "written every --checkpoint-every samples")
    p_bake.add_argument("--checkpoint-every", type=int, default=4)
    p_bake.add_argument("--progress", action="store_true", default=True)
    p_bake.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the plain versions")
    _add_asset_root(p_bake)
    _add_settings_flags(p_bake)
    p_bake.set_defaults(fn=cmd_bake)

    p_int = sub.add_parser("interactive",
                           help="interactive terminal viewer (App.cpp loop: "
                                "WASD camera, live HUD, progressive restart)")
    p_int.add_argument("--width", type=int, default=384)
    p_int.add_argument("--height", type=int, default=216)
    p_int.add_argument("--script", type=str, default=None,
                       help="headless input script 'key:frames,...' "
                            "(e.g. 'w:2,l:1,:4'); empty key = just render")
    p_int.add_argument("--max-frames", type=int, default=None)
    p_int.add_argument("--device", type=str, default="cuda",
                       help="torch device; 'cpu' runs the plain versions")
    _add_asset_root(p_int)
    _add_settings_flags(p_int)

    def _cmd_interactive(args):
        from .interactive import cmd_interactive
        return cmd_interactive(args)

    p_int.set_defaults(fn=_cmd_interactive)

    p_uv = sub.add_parser("uvviz", help="visualize the lightmap UV layout")
    p_uv.add_argument("--resolution", type=int, default=1024)
    p_uv.add_argument("--atlas", type=str, default="charts",
                      choices=["charts", "pair", "pairs"],
                      help="charted atlas, or the per-pair atlas ('pairs' "
                           "as the JAX package spells it)")
    p_uv.add_argument("--output", type=str, default="uvs.png")
    _add_settings_flags(p_uv)
    p_uv.set_defaults(fn=cmd_uvviz)

    args = parser.parse_args(argv)
    # crash-dump capture around every command (the Aftermath analog,
    # app/crashdump.py): an unhandled failure persists a JSON report of the
    # session/settings/device state before exiting.
    from .crashdump import crash_guard
    with crash_guard():
        return args.fn(args)


if __name__ == "__main__":
    main()
