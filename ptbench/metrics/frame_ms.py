"""frame_ms: the window's seconds over the frames it completed, in ms."""


def read(ctx):
    if ctx["step"] != "frame" or not ctx["steps"]:
        return None
    return ctx["window_s"] / ctx["steps"] * 1e3
