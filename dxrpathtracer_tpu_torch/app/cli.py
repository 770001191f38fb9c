"""Command-line shell: `python -m dxrpathtracer_tpu_torch bake ...`.

The port of dxrpathtracer_tpu/app/cli.py's `bake` command: every AppSettings
field is a flag, as in the JAX package, plus the bake's own. It runs on the
card (`--device cuda`, the default) and raises when there is none; pass
`--device cpu` for the plain versions. The `render`, `uvviz`, `animate` and
`interactive` commands are later slices of the port.
"""

import argparse
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


def cmd_bake(args):
    from ..bake.baker import Baker
    from ..core.constants import FP16Scale
    from ..render.film import write_image, write_png
    from ..render.postfx import tone_map_filmic_alu
    from .session import RenderSession

    settings = _settings_from_args(args)
    sess = RenderSession(settings=settings, width=8, height=8,
                         device=args.device)
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
            if sess.device.type == "cuda":
                torch.cuda.synchronize(sess.device)
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


def main(argv=None):
    parser = argparse.ArgumentParser(prog="dxrpathtracer_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

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
    _add_settings_flags(p_bake)
    p_bake.set_defaults(fn=cmd_bake)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
