"""bake_step_s: the window's seconds over the bake steps it completed."""


def read(ctx):
    if ctx["step"] != "bake" or not ctx["steps"]:
        return None
    return ctx["window_s"] / ctx["steps"]
