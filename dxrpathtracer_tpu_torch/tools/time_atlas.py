"""Host seconds of the charted atlas that the viewer's bake window builds:
`python -m dxrpathtracer_tpu_torch.tools.time_atlas [--scene Sponza]
[--output FILE.json]`.

Loads the scene (its stand-in without an asset root), then times
bake/charts.py::build_charted_atlas on its triangles with the window's
options (app/interactive.py: BAKE_ATLAS_OPTS, and the lightmap side of
bake_window_resolution), as pressing `b` in the viewer runs it. Prints one
JSON line: the scene, its triangles, the resolution and options, the
seconds and the atlas's charts, with the host's CPU count. Host numpy only;
it needs no card.
"""

import argparse
import json
import os
import platform
import time

import numpy as np


def main(argv=None):
    from ..app.interactive import BAKE_ATLAS_OPTS, bake_window_resolution
    from ..app.settings import Scenes
    from ..bake.charts import build_charted_atlas
    from ..scene.registry import load_scene

    parser = argparse.ArgumentParser(prog="time_atlas")
    parser.add_argument("--scene", default="Sponza",
                        choices=[s.name for s in Scenes])
    parser.add_argument("--output", default=None,
                        help="also write the JSON line to this file")
    args = parser.parse_args(argv)
    scene, _ = load_scene(Scenes[args.scene])
    pos, tri = np.asarray(scene.positions), np.asarray(scene.tri_idx)
    res = bake_window_resolution(int(scene.num_triangles))
    t0 = time.perf_counter()
    atlas = build_charted_atlas(pos, tri, ref_resolution=res,
                                **BAKE_ATLAS_OPTS)
    secs = time.perf_counter() - t0
    out = {"scene": args.scene, "triangles": int(scene.num_triangles),
           "resolution": res, "atlas_opts": BAKE_ATLAS_OPTS,
           "seconds": secs,
           "charts": atlas.num_charts,
           "host": platform.processor() or platform.machine(),
           "cpus": os.cpu_count()}
    line = json.dumps(out)
    print(line)
    if args.output:
        with open(args.output, "w") as f:
            f.write(line + "\n")
    return out


if __name__ == "__main__":
    main()
