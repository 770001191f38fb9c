"""Where a 1080p frame's time goes on the card: `python -m
dxrpathtracer_tpu_torch.tools.profile_frame [--raster]`.

Profiles one frame of each of chip_smoke.py's frame main paths, as
tools/profile_bake.py profiles a bake step. Path-traced (path length 3,
benchmark mode): the opaque Sponza-class stand-in, and SponzaAlpha-checker
(tools/alpha_cases.py: the stand-in, 384 alpha-tested cards with a checker
mask, four spot lights) at max_any_hit_path_length 1. With `--raster`, the
raster frames instead (MSAA4x, the reference's defaults): the opaque
stand-in with sun shadow rays, and SponzaAlpha-checker in the four shadow
modes. For each: wall ms (profiled and not), device time, idle share and
the kernels with the most device time. Needs a CUDA device.
"""

import sys

import torch

from .profile_bake import profile_step

SIZE = (1920, 1080)


def main(argv=None):
    from ..app.session import RenderSession
    from ..app.settings import AppSettings, Scenes
    from .alpha_cases import sponza_alpha_checker

    if not torch.cuda.is_available():
        raise SystemExit("profile_frame: no CUDA device")
    raster = "--raster" in (sys.argv[1:] if argv is None else argv)
    settings = AppSettings(current_scene=Scenes.Sponza, benchmark_mode=True,
                           max_path_length=3)
    opaque = RenderSession(settings, *SIZE)
    if raster:
        profile_step("opaque Sponza-class raster frame (rays)",
                     lambda: opaque.render_raster_frame(shadow_mode="rays"))
    else:
        profile_step("opaque Sponza-class frame", opaque.render_frame)
    del opaque
    scene, preset = sponza_alpha_checker()
    alpha = RenderSession(settings, *SIZE, scene=scene, preset=preset)
    if not raster:
        profile_step("SponzaAlpha-checker frame (4 spot lights)",
                     alpha.render_frame)
        return
    for mode in ("rays", "pcf", "evsm", "msm"):
        profile_step(f"SponzaAlpha-checker raster frame (4 spot lights, "
                     f"{mode})",
                     lambda: alpha.render_raster_frame(shadow_mode=mode))


if __name__ == "__main__":
    main()
