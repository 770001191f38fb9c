"""frame_ms_p95: the 95th percentile of the window's frame times on the
host clock (linear interpolation between order statistics), in ms."""

import numpy as np


def read(ctx):
    if ctx["step"] != "frame" or not ctx["step_s"]:
        return None
    return float(np.percentile(np.asarray(ctx["step_s"]) * 1e3, 95))
